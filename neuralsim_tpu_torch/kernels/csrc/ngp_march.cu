// ngp_march.cu - Instant-NGP's NeRF field along rays, for Hopper (sm_90a).
//
// A kernel of the port alone (the JAX package has no hash-grid field). It
// computes what models/ngp.py's plain twin computes, in float32 on the
// CUDA cores: for rays o, d, unit viewdir [N,3] and depths z [N,S], every
// sample point x = o + d*z is mapped into the grid's box, encoded by the
// multiresolution hash grid (L levels of F = 2 features; 8 trilinear
// corners a level, dense or hashed), and run through the density MLP
// (L*F -> 64 -> 16, log-density first) and the colour MLP ([16 density
// outputs, 16 SH coefficients of degree 4] -> 64 -> 64 -> 3), no biases;
// sigma = exp(out_0) (0 outside the box) is written to sigma [N,S] and the
// rgb logits to three planes rgb [3,N,S], the layout of nerf_march.cu.
//
// Bound on this card: one point gathers 8 corners of 8 bytes at each of
// the 16 levels from a 48.8 MB table that stays in the 50 MB L2, beside
// 9,408 multiply-adds; the coarse levels' corners are shared by a warp's
// neighbouring samples (L1), the fine levels' are not.
//
// Design: each warp walks tiles of 32 consecutive points of the flattened
// N*S sample index (persistent blocks of 8 warps), so a tile need not align
// with rays. Encoding: a lane gathers its own point's corners, issuing the
// 32 loads of GROUP = 4 levels before it interpolates any of them, and
// writes its 32 channels into the warp's activation tile in shared memory
// ([64 channels][32 points]). MLPs: the MLP weights (37.9 KB) are copied
// once a block into shared memory, and each layer of the warp's 32 points
// runs as a register tile (Dense): a lane computes 8 columns x 8 points
// of a 64-wide layer from 16 shared loads a channel. A lane that ran one
// point through all 9,408 multiply-adds alone would read each weight from
// shared memory once per point, one 4-byte load a multiply-add: the shared
// memory's bandwidth, not the FP32 units, set that design's pace (measured:
// 18.2 ms for 65,536 rays x 192 samples, against 5.9 ms for the gathers
// alone). The 3 logits: a lane its own point. One block of 8 warps an SM
// (up to 255 registers a thread): its 112 KB of shared memory leaves the
// rest of the SM's 256 KB to the L1 that serves the coarse levels'
// corners. Two blocks an SM (128 registers) took 14.7 ms there against 8.9,
// and 12 warps 8.8 (H100 SXM, 700 W); the 48.8 MB table does not stay
// whole in the L2 (the gathers alone took 11.2 ms at T = 2^19, 5.2 ms at
// 2^17), and hinting the streaming inputs and outputs to leave the L2 first
// changed nothing.
// Point generation, the box map, the trilinear weights, the corner sums
// and the spherical harmonics round each step as the twin's separate
// PyTorch ops do (no contraction), so the encoding and the SH equal the
// twin's; the MLP sums in its own order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 16;
constexpr int GROUP = 4;             // levels whose corners are loaded together
constexpr int F = 2;                 // features a level
constexpr int ENC = MAX_LEVELS * F;  // the encoding's channels (zero past the levels)
constexpr int DW = 64, DO = 16;      // density MLP: hidden, out
constexpr int CW = 64, CD = 2;       // colour MLP: hidden width, hidden layers
constexpr int SH = 16;               // SH coefficients (degree 4)
constexpr int CIN = DO + SH;         // colour MLP's input
// a warp's activations: [64 channels][32 points], rows padded to 36 floats
// so that a warp's 128-bit stores of 8 rows fall in distinct banks
constexpr int AST = 36;
constexpr int ACT = 64 * AST;
// shared-memory floats of each kernel (the last padded to 4 columns), then
// the warps' activations
constexpr int W0_N = ENC * DW, W1_N = DW * DO, W2_N = CIN * CW, W3_N = CW * CW, W4_N = CW * 4;
constexpr int SMEM_FLOATS = W0_N + W1_N + W2_N + W3_N + W4_N + WARPS * ACT;

// The grid's levels, passed by value: resolution N, first row, dense side
// N + 1 or hash mask T - 1, and the storage of each.
struct Grid {
  int res[MAX_LEVELS];
  int offset[MAX_LEVELS];
  unsigned int side_or_mask[MAX_LEVELS];
  int dense[MAX_LEVELS];
  int levels;
  float lo, extent;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the 16 real SH coefficients of a unit direction, models/ngp.py SH_FORMULAS
__device__ __forceinline__ void sh_encode(float x, float y, float z, float* sh) {
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  sh[0] = 0.28209479177387814f;
  sh[1] = mul(-0.48860251190291987f, y);
  sh[2] = mul(0.48860251190291987f, z);
  sh[3] = mul(-0.48860251190291987f, x);
  sh[4] = mul(mul(1.0925484305920792f, x), y);
  sh[5] = mul(mul(-1.0925484305920792f, y), z);
  sh[6] = sub(mul(0.94617469575755997f, zz), 0.31539156525251999f);
  sh[7] = mul(mul(-1.0925484305920792f, x), z);
  sh[8] = mul(0.54627421529603959f, sub(xx, yy));
  sh[9] = mul(mul(0.59004358992664352f, y), sub(yy, mul(3.0f, xx)));
  sh[10] = mul(mul(mul(2.8906114426405538f, x), y), z);
  sh[11] = mul(mul(0.45704579946446572f, y), sub(1.0f, mul(5.0f, zz)));
  sh[12] = mul(mul(0.3731763325901154f, z), sub(mul(5.0f, zz), 3.0f));
  sh[13] = mul(mul(0.45704579946446572f, x), sub(1.0f, mul(5.0f, zz)));
  sh[14] = mul(mul(1.4453057213202769f, z), sub(xx, yy));
  sh[15] = mul(mul(0.59004358992664352f, x), sub(mul(3.0f, yy), xx));
}

// Level l's cell at unit coordinates u: the rows of its 8 corners within
// the table and the fractions f.
__device__ __forceinline__ void level_corners(const Grid& g, int l, float ux, float uy,
                                              float uz, unsigned int* rows, float* f) {
  const float n = static_cast<float>(g.res[l]);
  const float top = static_cast<float>(g.res[l] - 1);
  const float px = mul(ux, n), py = mul(uy, n), pz = mul(uz, n);
  const float cx = fminf(floorf(px), top), cy = fminf(floorf(py), top),
              cz = fminf(floorf(pz), top);
  f[0] = sub(px, cx);
  f[1] = sub(py, cy);
  f[2] = sub(pz, cz);
  const unsigned int ix = static_cast<unsigned int>(cx), iy = static_cast<unsigned int>(cy),
                     iz = static_cast<unsigned int>(cz);
  const unsigned int m = g.side_or_mask[l];
  const bool dense = g.dense[l] != 0;
  const unsigned int first = static_cast<unsigned int>(g.offset[l]);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned int x = ix + (k & 1), y = iy + ((k >> 1) & 1), z = iz + ((k >> 2) & 1);
    // dense: x + y * side + z * side^2 (side <= 81 there); hashed: the
    // uint32 products wrap, T is a power of two
    rows[k] = first + (dense ? x + y * m + z * (m * m)
                             : ((x * 1u) ^ (y * 2654435761u) ^ (z * 805459861u)) & m);
  }
}

// The trilinear sum of a level's 8 corner features v with fractions f,
// corner by corner as the twin sums them.
__device__ __forceinline__ float2 interpolate(const float2* v, const float* f) {
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wx = (k & 1) ? f[0] : sub(1.0f, f[0]);
    const float wy = ((k >> 1) & 1) ? f[1] : sub(1.0f, f[1]);
    const float wz = ((k >> 2) & 1) ? f[2] : sub(1.0f, f[2]);
    const float w = mul(mul(wx, wy), wz);
    if (k == 0) {
      acc = make_float2(mul(w, v[k].x), mul(w, v[k].y));
    } else {
      acc.x = add(acc.x, mul(w, v[k].x));
      acc.y = add(acc.y, mul(w, v[k].y));
    }
  }
  return acc;
}

// A dense layer of a warp's 32 points on the CUDA cores, as a register
// tile: the N columns split into NCG = N / CT groups of CT and the points
// into 32 / NCG groups of PT = NCG (CT * PT accumulators a lane). Lane (cg, pg) holds
// the columns cg + NCG * c (c < CT) of the points pg * PT + i (i < PT):
// each input channel k costs it PT + CT shared loads (act[k][its points],
// its columns of w) for CT * PT multiply-adds. w is the layer's kernel as
// permute_kernel stores it; act the warp's [channel][point] tile.
template <int K, int N, int CT>
struct Dense {
  static constexpr int NCG = N / CT;
  static constexpr int PT = NCG;         // 32 / NCG point groups of NCG points

  __device__ __forceinline__ static void run(const float* act, const float* w, int lane,
                                             float (&acc)[CT][PT]) {
    const int cg = lane % NCG, pg = lane / NCG;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[c][i] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float x[PT], wv[CT];
#pragma unroll
      for (int q = 0; q < PT / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(act + k * AST + pg * PT + 4 * q);
        x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < CT / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(w + k * N + q * NCG * 4 + cg * 4);
        wv[4 * q] = v.x, wv[4 * q + 1] = v.y, wv[4 * q + 2] = v.z, wv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
#pragma unroll
        for (int i = 0; i < PT; ++i) acc[c][i] = fmaf(x[i], wv[c], acc[c][i]);
      }
    }
  }

  // the tile's outputs (after a ReLU where asked) into act's rows 0..N-1,
  // once every lane has read its inputs
  __device__ __forceinline__ static void store(float* act, int lane, float (&acc)[CT][PT],
                                               bool relu) {
    const int cg = lane % NCG, pg = lane / NCG;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CT; ++c) {
#pragma unroll
      for (int q = 0; q < PT / 4; ++q) {
        float4 v;
        v.x = relu ? fmaxf(acc[c][4 * q], 0.f) : acc[c][4 * q];
        v.y = relu ? fmaxf(acc[c][4 * q + 1], 0.f) : acc[c][4 * q + 1];
        v.z = relu ? fmaxf(acc[c][4 * q + 2], 0.f) : acc[c][4 * q + 2];
        v.w = relu ? fmaxf(acc[c][4 * q + 3], 0.f) : acc[c][4 * q + 3];
        *reinterpret_cast<float4*>(act + (cg + NCG * c) * AST + pg * PT + 4 * q) = v;
      }
    }
  }
};

// A [K][N] kernel (row-major, its first `rows` rows given, the others zero)
// into shared memory in the order Dense<K, N, CT> reads it: in row k,
// position q * NCG * 4 + cg * 4 + e holds column cg + NCG * (4q + e), so a
// quarter-warp's 128-bit loads of one q are 128 contiguous bytes.
template <int K, int N, int CT>
__device__ __forceinline__ void permute_kernel(const float* __restrict__ src, int rows,
                                               float* dst) {
  constexpr int NCG = N / CT;
  for (int i = threadIdx.x; i < K * N; i += THREADS) {
    const int k = i / N, pos = i % N;
    const int q = pos / (NCG * 4), cg = (pos / 4) % NCG, e = pos % 4;
    dst[i] = k < rows ? src[k * N + cg + NCG * (4 * q + e)] : 0.f;
  }
}

using Layer0 = Dense<ENC, DW, 8>;   // encoding -> 64: 8 columns x 8 points a lane
using Layer1 = Dense<DW, DO, 4>;    // 64 -> 16: 4 columns x 4 points
using Layer2 = Dense<CIN, CW, 8>;   // [out, sh] -> 64
using Layer3 = Dense<CW, CW, 8>;    // 64 -> 64

__global__ void __launch_bounds__(THREADS, 1)
ngp_march_f32(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
              const float* __restrict__ viewdirs, const float* __restrict__ z_vals, int total,
              int n_samples, const float2* __restrict__ table, const float* __restrict__ w0,
              const float* __restrict__ w1, const float* __restrict__ w2,
              const float* __restrict__ w3, const float* __restrict__ w4, Grid g,
              float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  float* s0 = reinterpret_cast<float*>(smem4);
  float* s1 = s0 + W0_N;
  float* s2 = s1 + W1_N;
  float* s3 = s2 + W2_N;
  float* s4 = s3 + W3_N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* act = s4 + W4_N + warp * ACT;
  permute_kernel<ENC, DW, 8>(w0, g.levels * F, s0);
  permute_kernel<DW, DO, 4>(w1, DW, s1);
  permute_kernel<CIN, CW, 8>(w2, CIN, s2);
  permute_kernel<CW, CW, 8>(w3, CW, s3);
  for (int i = threadIdx.x; i < W4_N; i += THREADS) {
    s4[i] = (i % 4) < 3 ? w4[(i / 4) * 3 + i % 4] : 0.f;
  }
  __syncthreads();

  const int tiles = (total + 31) / 32;
  for (int tile = blockIdx.x * WARPS + warp; tile < tiles; tile += gridDim.x * WARPS) {
    const int mine = tile * 32 + lane;
    const bool valid = mine < total;
    const int p = valid ? mine : total - 1;   // a lane past the end repeats the last point
    const int ray = p / n_samples;
    const float z = z_vals[p];
    float u[3];
    bool inside = true;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = add(rays_o[ray * 3 + c], mul(rays_d[ray * 3 + c], z));
      const float uc = __fdiv_rn(sub(x, g.lo), g.extent);
      inside = inside && uc >= 0.f && uc <= 1.f;
      u[c] = fminf(fmaxf(uc, 0.f), 1.f);
    }
    // ---- the encoding, GROUP levels' corner loads in flight at once, into
    // the warp's tile as channels 0..31 ----
#pragma unroll
    for (int grp = 0; grp < MAX_LEVELS / GROUP; ++grp) {
      float2 v[GROUP][8];
      float f[GROUP][3];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const int l = grp * GROUP + i;
        unsigned int rows[8];
        if (l < g.levels) {
          level_corners(g, l, u[0], u[1], u[2], rows, f[i]);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[i][k] = __ldg(table + rows[k]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[i][k] = make_float2(0.f, 0.f);
          f[i][0] = f[i][1] = f[i][2] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const float2 e = interpolate(v[i], f[i]);
        act[(2 * (grp * GROUP + i)) * AST + lane] = e.x;
        act[(2 * (grp * GROUP + i) + 1) * AST + lane] = e.y;
      }
    }
    __syncwarp();
    // ---- density MLP ----
    {
      float acc[8][8];
      Layer0::run(act, s0, lane, acc);
      Layer0::store(act, lane, acc, true);
    }
    __syncwarp();
    {
      float acc[4][4];
      Layer1::run(act, s1, lane, acc);
      Layer1::store(act, lane, acc, false);
    }
    // the SH of the lane's point as channels 16..31, beside the density
    // MLP's 16 outputs
    float sh[SH];
    sh_encode(viewdirs[ray * 3], viewdirs[ray * 3 + 1], viewdirs[ray * 3 + 2], sh);
#pragma unroll
    for (int k = 0; k < SH; ++k) act[(DO + k) * AST + lane] = sh[k];
    __syncwarp();
    if (valid) sigma[mine] = inside ? expf(act[lane]) : 0.f;
    // ---- colour MLP ----
    {
      float acc[8][8];
      Layer2::run(act, s2, lane, acc);
      Layer2::store(act, lane, acc, true);
    }
    __syncwarp();
    {
      float acc[8][8];
      Layer3::run(act, s3, lane, acc);
      Layer3::store(act, lane, acc, true);
    }
    __syncwarp();
    // 64 -> 3 logits, a lane its own point
    float logit[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k = 0; k < CW; ++k) {
      const float x = act[k * AST + lane];
      const float4 w = reinterpret_cast<const float4*>(s4)[k];
      logit[0] = fmaf(x, w.x, logit[0]);
      logit[1] = fmaf(x, w.y, logit[1]);
      logit[2] = fmaf(x, w.z, logit[2]);
    }
    if (valid) {
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[static_cast<long long>(c) * total + mine] = logit[c];
    }
    __syncwarp();   // the tile is read before the next tile's encoding
  }
}

}  // namespace

extern "C" {

// table: [rows, 2] float32, the levels one after another; w0..w4: the
// kernels [levels*2][64], [64][16], [32][64], [64][64], [64][3], row-major;
// res, offset, side_or_mask, dense: each level's resolution, first row,
// dense side (N + 1) or hash mask (T - 1, T a power of two) and storage;
// lo, extent: the box's lower bound and hi - lo on every axis. Returns a
// cudaError_t value: 0 when the launch was accepted.
int ngp_march(const float* rays_o, const float* rays_d, const float* viewdirs,
              const float* z_vals, long long n_rays, int n_samples, const float* table,
              const float* w0, const float* w1, const float* w2, const float* w3,
              const float* w4, int levels, const int* res, const int* offset,
              const unsigned int* side_or_mask, const int* dense, float lo, float extent,
              float* sigma, float* rgb, void* stream) {
  const long long total = n_rays * n_samples;
  if (levels < 1 || levels > MAX_LEVELS || total > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(table) % 8 || reinterpret_cast<uintptr_t>(w0) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Grid g;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool on = l < levels;
    g.res[l] = on ? res[l] : 1;
    g.offset[l] = on ? offset[l] : 0;
    g.side_or_mask[l] = on ? side_or_mask[l] : 0u;
    g.dense[l] = on ? dense[l] : 1;
  }
  g.levels = levels;
  g.lo = lo;
  g.extent = extent;
  if (total == 0) return 0;
  const int smem = SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ngp_march_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ngp_march_f32, THREADS,
                                                           smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long tiles = (total + THREADS - 1) / THREADS;
  const long long want = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(tiles < want ? tiles : want);
  ngp_march_f32<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      rays_o, rays_d, viewdirs, z_vals, static_cast<int>(total), n_samples,
      reinterpret_cast<const float2*>(table), w0, w1, w2, w3, w4, g, sigma, rgb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
