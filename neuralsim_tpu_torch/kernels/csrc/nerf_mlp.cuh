// nerf_mlp.cuh - the NeRF MLP core shared by the port's Hopper kernels.
//
// Every TPU kernel of neuralsim_tpu/kernels/raymarch.py runs the same
// 13-layer NeRF MLP (8x256 trunk with a skip, alpha / feature / views /
// rgb heads) on a tile of points and differs only in what goes in and what
// comes out. This header holds that common part:
//
//   - the shape limits the kernels were written for (and, once per shared
//     library, the C functions that report them to the Python wrapper);
//   - the positional encoding of a [6][P] point tile (xyz, view xyz) into
//     shared memory, with cos as sin(y + pi/2) (the JAX projection form)
//     or as a true cosf (TRUE_COS, the form of fused_nerf_mlp_pe);
//   - mlp_core: the whole MLP on a 64-point tile whose encodings are in
//     shared memory, leaving the raw outputs in a shared [4][P] tile
//     (rows r, g, b logits, then the raw density sigma).
//
// Bound on the card: operations. One point costs 593,408 multiply-adds
// (1.19 MFLOP) and moves at most 360 bytes (pre-encoded input), so every
// kernel built on this core is bound by the FP32 rate (67 TFLOP/s on an
// H100 SXM). The products run on the FP32 CUDA cores: true float32 like
// the JAX package's Precision.HIGHEST, never TF32.
//
// Design, simple first:
//   - one block of 256 threads per tile of P=64 points; the encodings and
//     the activation tile stay in shared memory (feature-major
//     [channel][point]); no activation touches device memory;
//   - the weights stream from device memory layer by layer; one net's
//     ~2.2 MB stays resident in the 50 MB L2, and the 8 warps of a block
//     read the same rows, so they hit L1;
//   - each thread owns an 8-point x 8-output register tile of the
//     [64 x 256] layer product (8 x 4 for the 128-wide views layer) and
//     accumulates with fmaf;
//   - the skip concat [x_pe, h] and the views concat [feature, d_pe] are
//     two partial sums each into the same accumulators.
// Not yet done (later work): tensor cores (wgmma) for the bf16 mode, and
// larger tiles to cut the per-block weight traffic.
//
// bf16 mode rounds where the JAX package rounds: the encodings, the weight
// matrices (rounded by the caller) and each post-ReLU activation; the
// feature is rounded after its bias. Products of bf16 values are exact in
// float32, accumulation and biases are float32. fast_epilogue (the JAX
// kernels' option) rounds the product and the bias to bf16 before adding
// them in the ReLU layers; in float32 it changes nothing.
//
// The encoding uses the accurate sinf / cosf, never the fast intrinsics:
// arguments reach 2^9 * |x| (hundreds of radians), where the intrinsics
// lose all accuracy. For the same reason the build never turns on nvcc's
// fast-math flag (tests/test_torch_imports.py checks both).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nerf {

constexpr int P = 64;          // points per tile
constexpr int THREADS = 256;   // 8 warps; warp w owns points [8w, 8w+8)
constexpr int W = 256;         // trunk width
constexpr int PX = 64;         // rows of the position encoding (>= 63)
constexpr int PD = 32;         // rows of the view encoding (>= 27)
constexpr int MAX_LAYERS = 20; // trunk depth + 4 heads
constexpr float HALF_PI = 1.57079632679489661923f;

// shared floats of the core: encodings, activations, raw outputs
constexpr int CORE_FLOATS = (PX + PD + W + 4) * P;

struct Net {
  // pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb: kernel [in][out]
  // row-major, bias [out]
  const float* k[MAX_LAYERS];
  const float* b[MAX_LAYERS];
  int depth;
  unsigned skip_mask;  // bit i: layer i's output is concatenated with x_pe
  int in_ch;
  int in_ch_views;
  int fast_epilogue;
};

// The Net of a C call: weights is a host array of 2 * (depth + 4) device
// pointers, kernel then bias per layer. Returns a cudaError_t value.
inline int make_net(const void* const* weights, int depth, unsigned skip_mask,
                    int in_ch, int in_ch_views, int fast_epilogue, Net* net) {
  if (depth + 4 > MAX_LAYERS || depth < 1 || in_ch > PX || in_ch_views > PD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *net = Net{};
  for (int i = 0; i < depth + 4; ++i) {
    net->k[i] = static_cast<const float*>(weights[2 * i]);
    net->b[i] = static_cast<const float*>(weights[2 * i + 1]);
  }
  net->depth = depth;
  net->skip_mask = skip_mask;
  net->in_ch = in_ch;
  net->in_ch_views = in_ch_views;
  net->fast_epilogue = fast_epilogue;
  return 0;
}

// Sets the dynamic shared memory a kernel needs and launches it on
// `blocks` blocks of THREADS threads. Returns a cudaError_t value: 0 when
// the launch was accepted.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long blocks, size_t smem_bytes,
           cudaStream_t stream, Args... args) {
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem_bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
__device__ __forceinline__ float round_cd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// acc[i][j] += sum_k act[k][8*pg + i] * w[k][col(j)] for k < K, where the
// lane's columns are {v*128 + 4*lane + c}: act is a shared [K][P] tile,
// w a [K][NOUT] row-major matrix in device memory.
template <int NOUT>
__device__ __forceinline__ void accumulate(float (&acc)[8][NOUT / 32],
                                           const float* act, int K,
                                           const float* __restrict__ w,
                                           int pg, int lane) {
  constexpr int NV = NOUT / 128;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(act + k * P + pg * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(act + k * P + pg * 8 + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(
          w + static_cast<size_t>(k) * NOUT + v * 128 + lane * 4));
      const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][v * 4 + c] = fmaf(a[i], ww[c], acc[i][v * 4 + c]);
        }
      }
    }
  }
}

template <int NOUT>
__device__ __forceinline__ void zero(float (&acc)[8][NOUT / 32]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < NOUT / 32; ++j) acc[i][j] = 0.f;
  }
}

// out[col][8*pg + i] = round(act(acc + bias[col])): the layer epilogue.
// With `fast` the product and the bias are rounded before the add.
template <int NOUT, bool BF16, bool RELU>
__device__ __forceinline__ void store(const float (&acc)[8][NOUT / 32],
                                      const float* __restrict__ bias,
                                      float* out, int pg, int lane, bool fast) {
#pragma unroll
  for (int v = 0; v < NOUT / 128; ++v) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = v * 128 + lane * 4 + c;
      const float b = __ldg(bias + col);
      const float bf = round_cd<BF16>(b);
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = acc[i][v * 4 + c];
        float x = fast ? round_cd<BF16>(a) + bf : a + b;
        if (RELU) x = fmaxf(x, 0.f);
        r[i] = round_cd<BF16>(x);
      }
      float4* dst = reinterpret_cast<float4*>(out + col * P + pg * 8);
      dst[0] = make_float4(r[0], r[1], r[2], r[3]);
      dst[1] = make_float4(r[4], r[5], r[6], r[7]);
    }
  }
}

// Encoding channel c of a point (order of ops/encoding.py):
// [x0, x1, x2, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(...)].
// xyz points at the point's first coordinate in a [3][P] tile. cos(y) is
// sin(y + pi/2) like the JAX projection form, or cosf(y) with TRUE_COS;
// y = x * 2^k is exact either way.
template <bool TRUE_COS>
__device__ __forceinline__ float encode(const float* xyz, int c, int n_ch) {
  if (c < 3) return xyz[c * P];
  if (c >= n_ch) return 0.f;
  const int j = c - 3;
  const int k = j / 6;
  const int r = j - 6 * k;
  const int dim = r % 3;
  const float y = __fmul_rn(xyz[dim * P], static_cast<float>(1 << k));
  if constexpr (TRUE_COS) {
    return r < 3 ? sinf(y) : cosf(y);
  } else {
    return sinf(__fadd_rn(y, r < 3 ? 0.f : HALF_PI));
  }
}

// pts: shared [6][P] (x, y, z, vx, vy, vz) -> pex [PX][P], ped [PD][P],
// rounded to the compute type; rows past the encoding are zero.
template <bool BF16, bool TRUE_COS>
__device__ __forceinline__ void encode_tile(const float* pts, float* pex,
                                            float* ped, const Net& net) {
  for (int idx = threadIdx.x; idx < PX * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    pex[idx] = round_cd<BF16>(encode<TRUE_COS>(pts + p, c, net.in_ch));
  }
  for (int idx = threadIdx.x; idx < PD * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    ped[idx] = round_cd<BF16>(encode<TRUE_COS>(pts + 3 * P + p, c, net.in_ch_views));
  }
}

// The MLP on one tile: pex [PX][P] and ped [PD][P] in shared memory (ready
// and synchronised) -> raw [4][P] in shared memory (r, g, b logits, sigma),
// synchronised on return. h is the shared [W][P] activation tile.
template <bool BF16>
__device__ __forceinline__ void mlp_core(const float* pex, const float* ped,
                                         float* h, float* raw, const Net& net) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pg = tid >> 5;
  const bool fast = net.fast_epilogue != 0;
  const int depth = net.depth;

  // ---- trunk -------------------------------------------------------------
  float acc[8][8];
  for (int i = 0; i < depth; ++i) {
    zero<W>(acc);
    const float* k = net.k[i];
    if (i == 0) {
      accumulate<W>(acc, pex, net.in_ch, k, pg, lane);
    } else {
      if ((net.skip_mask >> (i - 1)) & 1u) {
        // layer input is [x_pe, h]: two partial sums
        accumulate<W>(acc, pex, net.in_ch, k, pg, lane);
        k += static_cast<size_t>(net.in_ch) * W;
      }
      accumulate<W>(acc, h, W, k, pg, lane);
    }
    __syncthreads();  // every warp has read h
    store<W, BF16, true>(acc, net.b[i], h, pg, lane, fast);
    __syncthreads();
  }

  // ---- density head (alpha [W][1]) on the trunk output ------------------
  if (tid < P) {
    const float* ak = net.k[depth + 1];
    float s = 0.f;
    for (int k = 0; k < W; ++k) s = fmaf(h[k * P + tid], __ldg(ak + k), s);
    raw[3 * P + tid] = s + __ldg(net.b[depth + 1]);
  }

  // ---- feature layer (no ReLU), written back over h ---------------------
  zero<W>(acc);
  accumulate<W>(acc, h, W, net.k[depth], pg, lane);
  __syncthreads();
  store<W, BF16, false>(acc, net.b[depth], h, pg, lane, false);
  __syncthreads();

  // ---- views layer: [feature, d_pe] -> W/2, ReLU ------------------------
  float accv[8][4];
  zero<W / 2>(accv);
  const float* vk = net.k[depth + 2];
  accumulate<W / 2>(accv, h, W, vk, pg, lane);
  accumulate<W / 2>(accv, ped, net.in_ch_views,
                    vk + static_cast<size_t>(W) * (W / 2), pg, lane);
  __syncthreads();
  store<W / 2, BF16, true>(accv, net.b[depth + 2], h, pg, lane, fast);
  __syncthreads();

  // ---- rgb head (rgb [W/2][3]): thread -> (channel, point) ---------------
  if (tid < 3 * P) {
    const int c = tid / P, p = tid % P;
    const float* rk = net.k[depth + 3];
    float s = 0.f;
    for (int k = 0; k < W / 2; ++k) s = fmaf(h[k * P + p], __ldg(rk + k * 3 + c), s);
    raw[c * P + p] = s + __ldg(net.b[depth + 3] + c);
  }
  __syncthreads();
}

}  // namespace nerf

// The shape limits the kernels were written for; the Python wrapper checks
// them before every launch and raises on anything else. Defined once in
// each shared library (each includes this header from one source).
extern "C" {
int nerf_width() { return nerf::W; }
int nerf_max_layers() { return nerf::MAX_LAYERS; }
int nerf_max_in_ch() { return nerf::PX; }
int nerf_max_in_ch_views() { return nerf::PD; }
}
