// nerf_march.cu - the NeRF ray march for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_march_channels_kernel`, launched by
// `_fused_march_channels` / `fused_nerf_march` in
// neuralsim_tpu/kernels/raymarch.py. Same function: for rays o, d, unit
// viewdir [N,3] and depths z [N,S], every sample point x = o + d*z is
// positionally encoded (L=10 -> 63 ch, view L=4 -> 27 ch) and run through
// the whole NeRF MLP; the raw density is written to sigma [N,S] and the rgb
// logits to three planes rgb [3,N,S].
//
// Bound on this card: operations. One point costs 593,408 multiply-adds
// (1.19 MFLOP); it reads 4 bytes of z (plus 36 bytes per ray) and writes
// 16 bytes, so the bytes bound is ~100x below the operations bound. In
// float32 mode the products run on the FP32 CUDA cores (67 TFLOP/s on an
// H100 SXM): true float32 like the JAX package's Precision.HIGHEST, never
// TF32.
//
// Design, simple first:
//   - one block of 256 threads per tile of P=64 consecutive points of the
//     flattened N*S sample index; each point finds its ray (idx / S), so a
//     tile need not align with rays and the ragged tail is masked;
//   - the encodings and the activation tile stay in shared memory
//     (feature-major [channel][point], 88 KB); no activation touches
//     device memory;
//   - the weights stream from device memory layer by layer; one net's
//     ~2.2 MB stays resident in the 50 MB L2, and the 8 warps of a block
//     read the same rows, so they hit L1;
//   - each thread owns an 8-point x 8-output register tile of the
//     [64 x 256] layer product (8 outputs x 4 per lane for the 128-wide
//     views layer) and accumulates with fmaf;
//   - the skip concat [x_pe, h] and the views concat [feature, d_pe] are
//     two partial sums each into the same accumulators.
// Not yet done (later work): tensor cores (wgmma) for the bf16 mode, and
// larger tiles to cut the per-block weight traffic.
//
// bf16 mode rounds where the JAX package rounds: the encodings, the weight
// matrices (rounded by the caller) and each post-ReLU activation; the
// feature is rounded after its bias. Products of bf16 values are exact in
// float32, accumulation and biases are float32.
//
// The encoding uses the accurate sinf, never the fast sine intrinsic:
// arguments reach 2^9 * |x| (hundreds of radians), where the intrinsic
// loses all accuracy. For the same reason the build never turns on
// nvcc's fast-math flag (tests/test_torch_imports.py checks both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int P = 64;          // points per block
constexpr int THREADS = 256;   // 8 warps; warp w owns points [8w, 8w+8)
constexpr int W = 256;         // trunk width
constexpr int PX = 64;         // rows of the position encoding (>= 63)
constexpr int PD = 32;         // rows of the view encoding (>= 27)
constexpr int MAX_LAYERS = 20; // trunk depth + 4 heads
constexpr float HALF_PI = 1.57079632679489661923f;

constexpr int SMEM_FLOATS = (PX + PD + W + 6) * P;

struct NetWeights {
  // pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb: kernel [in][out]
  // row-major, bias [out]
  const float* k[MAX_LAYERS];
  const float* b[MAX_LAYERS];
};

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
template <int NOUT, bool BF16, bool RELU>
__device__ __forceinline__ void store(const float (&acc)[8][NOUT / 32],
                                      const float* __restrict__ bias,
                                      float* out, int pg, int lane) {
#pragma unroll
  for (int v = 0; v < NOUT / 128; ++v) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = v * 128 + lane * 4 + c;
      const float b = __ldg(bias + col);
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = acc[i][v * 4 + c] + b;
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
// [x0, x1, x2, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(...)],
// cos(y) computed as sin(y + pi/2) like the JAX package.
__device__ __forceinline__ float encode(const float* xyz, int c, int n_ch) {
  if (c < 3) return xyz[c * P];
  if (c >= n_ch) return 0.f;
  const int j = c - 3;
  const int k = j / 6;
  const int r = j - 6 * k;
  const int dim = r % 3;
  const float phase = r < 3 ? 0.f : HALF_PI;
  const float arg = __fadd_rn(__fmul_rn(xyz[dim * P], static_cast<float>(1 << k)), phase);
  return sinf(arg);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
nerf_march_kernel(const float* __restrict__ rays_o,
                  const float* __restrict__ rays_d,
                  const float* __restrict__ viewdirs,
                  const float* __restrict__ z_vals,
                  long long total, int n_samples, NetWeights wts, int depth,
                  unsigned skip_mask, int in_ch, int in_ch_views,
                  float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* pex = smem;              // [PX][P] position encoding
  float* ped = pex + PX * P;      // [PD][P] view encoding
  float* h = ped + PD * P;        // [W][P]  activations
  float* pts = h + W * P;         // [6][P]  x, y, z, vx, vy, vz

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pg = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * P;

  // ---- point generation: x = o + d * z (no fma, like the JAX reference) --
  if (tid < P) {
    const long long g = base + tid;
    float x[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (g < total) {
      const long long ray = g / n_samples;
      const float zv = z_vals[g];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[c] = __fadd_rn(rays_o[ray * 3 + c], __fmul_rn(rays_d[ray * 3 + c], zv));
        x[3 + c] = viewdirs[ray * 3 + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) pts[c * P + tid] = x[c];
  }
  __syncthreads();

  // ---- positional encodings into shared memory --------------------------
  for (int idx = tid; idx < PX * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    pex[idx] = round_cd<BF16>(encode(pts + p, c, in_ch));
  }
  for (int idx = tid; idx < PD * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    ped[idx] = round_cd<BF16>(encode(pts + 3 * P + p, c, in_ch_views));
  }
  __syncthreads();

  // ---- trunk -------------------------------------------------------------
  float acc[8][8];
  for (int i = 0; i < depth; ++i) {
    zero<W>(acc);
    const float* k = wts.k[i];
    if (i == 0) {
      accumulate<W>(acc, pex, in_ch, k, pg, lane);
    } else {
      if ((skip_mask >> (i - 1)) & 1u) {
        // layer input is [x_pe, h]: two partial sums
        accumulate<W>(acc, pex, in_ch, k, pg, lane);
        k += static_cast<size_t>(in_ch) * W;
      }
      accumulate<W>(acc, h, W, k, pg, lane);
    }
    __syncthreads();  // every warp has read h
    store<W, BF16, true>(acc, wts.b[i], h, pg, lane);
    __syncthreads();
  }

  const long long g = base + (tid % P);
  const bool valid = g < total;

  // ---- density head (alpha [W][1]) on the trunk output ------------------
  if (tid < P) {
    const float* ak = wts.k[depth + 1];
    float s = 0.f;
    for (int k = 0; k < W; ++k) s = fmaf(h[k * P + tid], __ldg(ak + k), s);
    if (valid) sigma[g] = s + __ldg(wts.b[depth + 1]);
  }

  // ---- feature layer (no ReLU), written back over h ---------------------
  zero<W>(acc);
  accumulate<W>(acc, h, W, wts.k[depth], pg, lane);
  __syncthreads();
  store<W, BF16, false>(acc, wts.b[depth], h, pg, lane);
  __syncthreads();

  // ---- views layer: [feature, d_pe] -> W/2, ReLU ------------------------
  float accv[8][4];
  zero<W / 2>(accv);
  const float* vk = wts.k[depth + 2];
  accumulate<W / 2>(accv, h, W, vk, pg, lane);
  accumulate<W / 2>(accv, ped, in_ch_views, vk + static_cast<size_t>(W) * (W / 2),
                    pg, lane);
  __syncthreads();
  store<W / 2, BF16, true>(accv, wts.b[depth + 2], h, pg, lane);
  __syncthreads();

  // ---- rgb head (rgb [W/2][3]): thread -> (channel, point) ---------------
  if (tid < 3 * P) {
    const int c = tid / P, p = tid % P;
    const float* rk = wts.k[depth + 3];
    float s = 0.f;
    for (int k = 0; k < W / 2; ++k) s = fmaf(h[k * P + p], __ldg(rk + k * 3 + c), s);
    if (valid) rgb[c * total + g] = s + __ldg(wts.b[depth + 3] + c);
  }
}

template <bool BF16>
int launch(const float* rays_o, const float* rays_d, const float* viewdirs,
           const float* z_vals, long long n_rays, int n_samples,
           const NetWeights& wts, int depth, unsigned skip_mask, int in_ch,
           int in_ch_views, float* sigma, float* rgb, cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_march_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n_rays * n_samples;
  const long long blocks = (total + P - 1) / P;
  nerf_march_kernel<BF16><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      rays_o, rays_d, viewdirs, z_vals, total, n_samples, wts, depth, skip_mask,
      in_ch, in_ch_views, sigma, rgb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The shape limits the kernel was written for; the Python wrapper checks
// them before every launch and raises on anything else.
int nerf_march_width() { return W; }
int nerf_march_max_layers() { return MAX_LAYERS; }
int nerf_march_max_in_ch() { return PX; }
int nerf_march_max_in_ch_views() { return PD; }

// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb.
// Returns a cudaError_t value: 0 when the launch was accepted.
int nerf_march(const float* rays_o, const float* rays_d, const float* viewdirs,
               const float* z_vals, long long n_rays, int n_samples,
               const void* const* weights, int depth, unsigned skip_mask,
               int in_ch, int in_ch_views, int bf16, float* sigma, float* rgb,
               void* stream) {
  if (depth + 4 > MAX_LAYERS || depth < 1 || in_ch > PX || in_ch_views > PD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NetWeights wts{};
  for (int i = 0; i < depth + 4; ++i) {
    wts.k[i] = static_cast<const float*>(weights[2 * i]);
    wts.b[i] = static_cast<const float*>(weights[2 * i + 1]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<true>(rays_o, rays_d, viewdirs, z_vals, n_rays, n_samples, wts,
                        depth, skip_mask, in_ch, in_ch_views, sigma, rgb, s);
  }
  return launch<false>(rays_o, rays_d, viewdirs, z_vals, n_rays, n_samples, wts,
                       depth, skip_mask, in_ch, in_ch_views, sigma, rgb, s);
}

}  // extern "C"
