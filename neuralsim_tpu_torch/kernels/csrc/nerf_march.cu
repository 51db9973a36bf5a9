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
// Bound on this card: operations. One point reads 4 bytes of z (plus 36
// bytes per ray) and writes 16 bytes, so the bytes bound is ~100x below
// the operations bound: the FP32 rate in float32 (nerf_mlp.cuh), the bf16
// tensor-core rate in bf16 (nerf_mlp_wgmma.cuh; 1.887 ms at 8192 rays x
// 192 samples).
//
// Design: the flattened N*S sample index is cut into tiles; each point
// finds its ray (idx / S), so a tile need not align with rays and the
// ragged tail is masked. Point generation (no fma) and the channel-plane
// output are this file's.
//   - float32: one block of 256 threads per 64-point tile on the FP32 core
//     of nerf_mlp.cuh (weights read through L1/L2 as float32);
//   - bf16: persistent blocks of two warpgroups over 128-point tiles on
//     the wgmma core of nerf_mlp_wgmma.cuh, the packed bf16 weights
//     streamed chunk by chunk into a shared-memory ring (the header
//     reckons the weight traffic).

#include "nerf_mlp_wgmma.cuh"

using namespace nerf;

namespace {

constexpr int SMEM_FLOATS = CORE_FLOATS + 6 * P;

// x = o + d * z for the point at flattened index g (zero past the end),
// into column p of a [6][P] tile: x, y, z, vx, vy, vz. The wrapper keeps
// N*S below 2^31, so indices are 32-bit.
__device__ __forceinline__ void make_point(const float* __restrict__ rays_o,
                                           const float* __restrict__ rays_d,
                                           const float* __restrict__ viewdirs,
                                           const float* __restrict__ z_vals,
                                           int g, int total, int n_samples,
                                           float* pts, int p) {
  float x[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (g < total) {
    const int ray = g / n_samples;
    const float zv = z_vals[g];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = __fadd_rn(rays_o[ray * 3 + c], __fmul_rn(rays_d[ray * 3 + c], zv));
      x[3 + c] = viewdirs[ray * 3 + c];
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) pts[c * P + p] = x[c];
}

__global__ void __launch_bounds__(THREADS)
nerf_march_kernel(const float* __restrict__ rays_o,
                  const float* __restrict__ rays_d,
                  const float* __restrict__ viewdirs,
                  const float* __restrict__ z_vals,
                  long long total, int n_samples, Net net,
                  float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* pex = smem;              // [PX][P] position encoding
  float* ped = pex + PX * P;      // [PD][P] view encoding
  float* h = ped + PD * P;        // [W][P]  activations
  float* raw = h + W * P;         // [4][P]  r, g, b logits, sigma
  float* pts = raw + 4 * P;       // [6][P]  x, y, z, vx, vy, vz

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * P;

  // ---- point generation: x = o + d * z (no fma, like the JAX reference) --
  if (tid < P) {
    make_point(rays_o, rays_d, viewdirs, z_vals, static_cast<int>(base) + tid,
               static_cast<int>(total), n_samples, pts, tid);
  }
  __syncthreads();

  encode_tile<false, false>(pts, pex, ped, net);
  __syncthreads();
  mlp_core<false>(pex, ped, h, raw, net);

  // ---- channel planes: sigma [N,S], rgb [3,N,S] --------------------------
  const int c = tid / P, p = tid % P;  // THREADS == 4 * P
  const long long g = base + p;
  if (g < total) {
    if (c == 3) {
      sigma[g] = raw[3 * P + p];
    } else {
      rgb[c * total + g] = raw[c * P + p];
    }
  }
}

// bf16: warpgroup g of a block runs points [64g, 64g+64) of each of the
// block's 128-point tiles (tiles blockIdx.x, +gridDim.x, ...).
__global__ void __launch_bounds__(THREADS, 1)
nerf_march_wgmma(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                 const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
                 int total, int n_samples, Net net, wg::Plan plan,
                 float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + wg::TILE - 1) / wg::TILE;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  wg::Core core = wg::make_core(smem4, plan);
  core.ring.init(static_cast<long long>(mine) * plan.per_tile);
  const int t = threadIdx.x & 127;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * wg::TILE + core.group * P;
    wg::wg_barrier(core.group);  // the previous tile's points and raw are read
    if (t < P) make_point(rays_o, rays_d, viewdirs, z_vals, base + t, total, n_samples, core.pts, t);
    wg::wg_barrier(core.group);
    wg::run_tile<false>(core, net);  // the march has no fast epilogue
    for (int idx = t; idx < 4 * P; idx += 128) {
      const int c = idx / P, p = idx % P;
      const int gp = base + p;
      if (gp < total) {
        if (c == 3) {
          sigma[gp] = core.raw[3 * P + p];
        } else {
          rgb[static_cast<long long>(c) * total + gp] = core.raw[c * P + p];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb; packed:
// the bf16 weight chunks of raymarch.py pack_wgmma_weights (bf16 only,
// 16-byte aligned). Returns a cudaError_t value: 0 when the launch was
// accepted.
int nerf_march(const float* rays_o, const float* rays_d, const float* viewdirs,
               const float* z_vals, long long n_rays, int n_samples,
               const void* const* weights, int depth, unsigned skip_mask,
               int in_ch, int in_ch_views, int bf16, const void* packed, float* sigma,
               float* rgb, void* stream) {
  Net net;
  const int err = make_net(weights, depth, skip_mask, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  const long long total = n_rays * n_samples;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 ||
        total > 0x7fffffffLL - wg::TILE) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return wg::launch_persistent(nerf_march_wgmma, (total + wg::TILE - 1) / wg::TILE,
                                 wg::CORE_BYTES + wg::SMEM_ALIGN, s, rays_o, rays_d,
                                 viewdirs, z_vals, static_cast<int>(total), n_samples, net,
                                 wg::make_plan(packed, depth, skip_mask), sigma, rgb);
  }
  return launch(nerf_march_kernel, (total + P - 1) / P, SMEM_FLOATS * sizeof(float), s,
                rays_o, rays_d, viewdirs, z_vals, total, n_samples, net, sigma, rgb);
}

}  // extern "C"
