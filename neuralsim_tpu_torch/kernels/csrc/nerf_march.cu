// nerf_march.cu - the NeRF ray march for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_march_channels_kernel`, launched by
// `_fused_march_channels` / `fused_nerf_march` in
// neuralsim_tpu/kernels/raymarch.py. Same function: for rays o, d, unit
// viewdir [N,3] and depths z [N,S], every sample point x = o + d*z is
// positionally encoded (L=10 -> 63 ch, view L=4 -> 27 ch by default) and
// run through the whole NeRF MLP; the raw density is written to sigma
// [N,S] and the rgb logits to three planes rgb [3,N,S].
//
// Bound on this card: operations. One point reads 4 bytes of z (plus 36
// bytes per ray) and writes 16 bytes, so the bytes bound is ~100x below
// the operations bound: the FP32 rate in float32 (nerf_mlp.cuh; 27.86 ms at
// 8192 rays x 192 samples), the bf16 tensor-core rate in bf16
// (nerf_mlp_wgmma.cuh; 1.887 ms).
//
// Design: persistent blocks walk tiles of the flattened N*S sample index;
// each point finds its ray (idx / S), so a tile need not align with rays
// and the ragged tail is masked. Point generation (no fma) and the
// channel-plane output are this file's; the MLP is a core's:
//   - float32: tiles of 128 points (64 for nets with long encodings) on the
//     FP32 core of nerf_mlp.cuh, its packed float32 weights streamed through
//     the core's shared-memory ring;
//   - bf16: blocks of two warpgroups over 128-point tiles on the wgmma core
//     of nerf_mlp_wgmma.cuh, its packed bf16 weights streamed the same way.
// Each header reckons its core's weight traffic.

#include "nerf_mlp_wgmma.cuh"

using namespace nerf;

namespace {

// x = o + d * z for the point at flattened index g (zero past the end),
// into column p of a [6][stride] tile: x, y, z, vx, vy, vz. The wrapper
// keeps N*S below 2^31, so indices are 32-bit.
__device__ __forceinline__ void make_point(const float* __restrict__ rays_o,
                                           const float* __restrict__ rays_d,
                                           const float* __restrict__ viewdirs,
                                           const float* __restrict__ z_vals,
                                           int g, int total, int n_samples,
                                           float* pts, int stride, int p) {
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
  for (int c = 0; c < 6; ++c) pts[c * stride + p] = x[c];
}

// float32: the block runs tiles blockIdx.x, +gridDim.x, ... of TILE points.
template <int TILE>
__global__ void __launch_bounds__(THREADS, 1)
nerf_march_f32(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
               const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
               int total, int n_samples, Net net, Plan plan, int rx, int rd,
               float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + TILE - 1) / TILE;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  f32::Core<TILE> core = f32::make_core<TILE>(smem4, plan, rx, rd);
  core.ring.init(static_cast<long long>(mine) * plan.per_tile);
  const int tid = threadIdx.x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    __syncthreads();  // the previous tile's raw outputs are read
    if (tid < TILE) {
      make_point(rays_o, rays_d, viewdirs, z_vals, base + tid, total, n_samples, core.pts, TILE,
                 tid);
    }
    __syncthreads();
    f32::run_tile<TILE, false, false>(core, net);
    // ---- channel planes: sigma [N,S], rgb [3,N,S] ------------------------
    for (int idx = tid; idx < 4 * TILE; idx += THREADS) {
      const int c = idx / TILE, p = idx % TILE;
      const int g = base + p;
      if (g < total) {
        if (c == 3) {
          sigma[g] = core.raw[3 * TILE + p];
        } else {
          rgb[static_cast<long long>(c) * total + g] = core.raw[c * TILE + p];
        }
      }
    }
  }
}

// bf16: warpgroup g of a block runs points [64g, 64g+64) of each of the
// block's 128-point tiles (tiles blockIdx.x, +gridDim.x, ...).
__global__ void __launch_bounds__(THREADS, 1)
nerf_march_wgmma(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                 const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
                 int total, int n_samples, Net net, Plan plan, int nx,
                 float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + wg::TILE - 1) / wg::TILE;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  wg::Core core = wg::make_core(smem4, plan, nx);
  core.ring.init(static_cast<long long>(mine) * plan.per_tile);
  const int t = threadIdx.x & 127;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * wg::TILE + core.group * P;
    wg::wg_barrier(core.group);  // the previous tile's points and raw are read
    if (t < P) {
      make_point(rays_o, rays_d, viewdirs, z_vals, base + t, total, n_samples, core.pts, P, t);
    }
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
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb, padded
// to the cores' width; packed: the weight chunks of the core this dtype
// runs (raymarch.py pack_f32_weights in float32, pack_wgmma_weights in
// bf16; 16-byte aligned). Returns a cudaError_t value: 0 when the launch
// was accepted.
int nerf_march(const float* rays_o, const float* rays_d, const float* viewdirs,
               const float* z_vals, long long n_rays, int n_samples,
               const void* const* weights, int depth, unsigned skip_mask,
               int in_ch, int in_ch_views, int bf16, const void* packed, float* sigma,
               float* rgb, void* stream) {
  Net net;
  const int err = make_net(weights, depth, skip_mask, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  const long long total = n_rays * n_samples;
  if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 ||
      total > 0x7fffffffLL - wg::TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int nx = wg::x_chunks(in_ch);
    return launch_persistent(nerf_march_wgmma, (total + wg::TILE - 1) / wg::TILE,
                             wg::core_bytes(nx) + wg::SMEM_ALIGN, s, rays_o, rays_d, viewdirs,
                             z_vals, static_cast<int>(total), n_samples, net,
                             wg::make_plan(packed, depth, skip_mask, in_ch), nx, sigma, rgb);
  }
  const int rx = f32::rows(in_ch), rd = f32::rows(in_ch_views);
  int tile = 0;
  const int e = f32::pick_tile(rx, rd, 0, &tile);
  if (e != 0) return e;
  const Plan plan = f32::make_plan(packed, depth, skip_mask, in_ch, in_ch_views);
  const size_t smem = f32::core_bytes(tile, rx, rd);
  if (tile == 128) {
    return launch_persistent(nerf_march_f32<128>, (total + 127) / 128, smem, s, rays_o, rays_d,
                             viewdirs, z_vals, static_cast<int>(total), n_samples, net, plan, rx,
                             rd, sigma, rgb);
  }
  if (tile == 64) {
    return launch_persistent(nerf_march_f32<64>, (total + 63) / 64, smem, s, rays_o, rays_d,
                             viewdirs, z_vals, static_cast<int>(total), n_samples, net, plan, rx,
                             rd, sigma, rgb);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
