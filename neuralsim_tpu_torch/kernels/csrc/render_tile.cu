// render_tile.cu - the fused march + compositing of whole rays for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_render_tile_kernel`, launched by
// `fused_render_tile` in neuralsim_tpu/kernels/raymarch.py. Same function:
// for rays o, d, unit viewdir [N,3] and depths z [N,S], every sample point
// x = o + d*z is encoded and run through the NeRF MLP, and each ray is
// alpha-composited in the kernel with the semantics of raw2outputs
// (neuralsim_tpu/ops/volume.py:45-91):
//
//   dist_s  = (z_{s+1} - z_s) * |d|, and 1e10 * |d| for the last sample
//   alpha_s = 1 - exp(-relu(sigma_s) * dist_s)
//   T_s     = prod_{j<s} (1 - alpha_j + 1e-10)      (exclusive product)
//   w_s     = alpha_s * T_s
//   rgb = sum_s w_s sigmoid(logit_s), depth = sum_s w_s z_s, acc = sum_s w_s,
//   disp = 1 / max(1e-10, depth / max(acc, 1e-10)), rgb += 1 - acc (white).
//
// Outputs: rgb [N,3], disp [N], acc [N], weights [N,S], depth [N]. The raw
// field never leaves the chip. Forward only, as the TPU kernel.
//
// Bound on this card: operations, the FP32 rate in float32 (nerf_mlp.cuh)
// and the bf16 tensor-core rate in bf16 (nerf_mlp_wgmma.cuh; 1.888 ms at
// 8192 rays x 192 samples); per sample it reads 4 bytes of z and writes 4
// bytes of weight.
//
// Design: a block owns R whole rays (R*S points) and runs the MLP over
// them in sub-tiles, keeping each sub-tile's raw outputs and depths in
// shared [4][R*S] and [R*S] buffers:
//   - float32: R = 64 / gcd(S, 64) where that keeps R*S <= 1024 (R = 1 for
//     S = 64 and 192), 64-point sub-tiles on the FP32 core of nerf_mlp.cuh,
//     one block per R rays;
//   - bf16: R = 128 / gcd(S, 128) where that keeps R*S <= 1024 (R = 2 for
//     S = 64 and 192), 128-point sub-tiles on the wgmma core of
//     nerf_mlp_wgmma.cuh, persistent blocks that walk ray groups
//     blockIdx.x, +gridDim.x, ... while the packed bf16 weights stream
//     through the core's shared-memory ring (the header reckons the weight
//     traffic).
// When all of a block's points are in, the block turns every point's
// density into alpha and its logits into sigmoids in parallel; then thread
// r runs ray r's exclusive product and sums over shared memory in sample
// order (the order of torch.cumprod), in float32. The TPU kernel computed
// the product as exp(log(1 - alpha) @ U) with a triangular matrix only
// because Mosaic has no cumprod; here it is a plain loop of a few
// multiply-adds per sample.

#include "nerf_mlp_wgmma.cuh"

using namespace nerf;

namespace {

// R * S limit of the gcd rule: [5][R*S] floats of shared memory beside
// the FP32 core's 89 KB, or the wgmma core's 198 KB
constexpr int MAX_POINTS = 1024;

// Alpha-composites the block's n_here rays from shared ray_raw [4][stride]
// (r, g, b logits, sigma; sigma and the logits are overwritten) and ray_z
// [stride]; called by every thread of the block once all points are in.
__device__ __forceinline__ void composite(float* ray_raw, const float* ray_z, int stride,
                                          int n_here, int S, long long ray0,
                                          const float* __restrict__ rays_d, int white_bkgd,
                                          float* __restrict__ rgb_map,
                                          float* __restrict__ disp_map,
                                          float* __restrict__ acc_map,
                                          float* __restrict__ weights,
                                          float* __restrict__ depth_map) {
  const int tid = threadIdx.x;
  const int T = n_here * S;
  __syncthreads();

  // ---- per point, in parallel: alpha over the raw density, sigmoid rgb --
  for (int l = tid; l < T; l += THREADS) {
    const int s = l % S;
    const float* d = rays_d + (ray0 + l / S) * 3;
    const float dn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const float dist = (s + 1 < S ? ray_z[l + 1] - ray_z[l] : 1e10f) * dn;
    float* sigma = ray_raw + 3 * stride + l;
    *sigma = 1.f - expf(-fmaxf(*sigma, 0.f) * dist);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ray_raw[c * stride + l] = 1.f / (1.f + expf(-ray_raw[c * stride + l]));
    }
  }
  __syncthreads();

  // ---- compositing: thread r owns ray ray0 + r, product and sums in order
  if (tid < n_here) {
    const long long ray = ray0 + tid;
    const int l0 = tid * S;
    float trans = 1.f, r = 0.f, g = 0.f, b = 0.f, dep = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const int l = l0 + s;
      const float alpha = ray_raw[3 * stride + l];
      const float w = alpha * trans;
      trans = trans * (1.f - alpha + 1e-10f);
      weights[ray * S + s] = w;
      r += w * ray_raw[l];
      g += w * ray_raw[stride + l];
      b += w * ray_raw[2 * stride + l];
      dep += w * ray_z[l];
      acc += w;
    }
    if (white_bkgd) {
      r += 1.f - acc;
      g += 1.f - acc;
      b += 1.f - acc;
    }
    rgb_map[ray * 3] = r;
    rgb_map[ray * 3 + 1] = g;
    rgb_map[ray * 3 + 2] = b;
    acc_map[ray] = acc;
    depth_map[ray] = dep;
    disp_map[ray] = 1.f / fmaxf(dep / fmaxf(acc, 1e-10f), 1e-10f);
  }
  __syncthreads();  // ray_raw and ray_z are free again
}

// Point l of the block's T = n_here * S points (rays from ray0): its
// depth into ray_z[l] and x = o + d * z (no fma, like the reference) into
// column p of a [6][P] tile; zero past T.
__device__ __forceinline__ void ray_point(const float* __restrict__ rays_o,
                                          const float* __restrict__ rays_d,
                                          const float* __restrict__ viewdirs,
                                          const float* __restrict__ z_vals, long long ray0,
                                          int S, int l, int T, float* ray_z, float* pts, int p) {
  float x[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (l < T) {
    const long long ray = ray0 + l / S;
    const float zv = z_vals[ray0 * S + l];
    ray_z[l] = zv;
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
render_tile_kernel(const float* __restrict__ rays_o,
                   const float* __restrict__ rays_d,
                   const float* __restrict__ viewdirs,
                   const float* __restrict__ z_vals, long long n_rays,
                   int n_samples, int rays_per_block, Net net, int white_bkgd,
                   float* __restrict__ rgb_map, float* __restrict__ disp_map,
                   float* __restrict__ acc_map, float* __restrict__ weights,
                   float* __restrict__ depth_map) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* pex = smem;              // [PX][P] position encoding
  float* ped = pex + PX * P;      // [PD][P] view encoding
  float* h = ped + PD * P;        // [W][P]  activations
  float* raw = h + W * P;         // [4][P]  r, g, b logits, sigma
  float* pts = raw + 4 * P;       // [6][P]  x, y, z, vx, vy, vz
  float* ray_raw = pts + 6 * P;   // [4][R*S] the block's raw field
  float* ray_z = ray_raw + 4 * rays_per_block * n_samples;  // [R*S] depths

  const int tid = threadIdx.x;
  const int S = n_samples;
  const int stride = rays_per_block * S;
  const long long ray0 = static_cast<long long>(blockIdx.x) * rays_per_block;
  const int n_here = static_cast<int>(
      n_rays - ray0 < rays_per_block ? n_rays - ray0 : rays_per_block);
  const int T = n_here * S;

  for (int t0 = 0; t0 < T; t0 += P) {
    // ---- point generation: x = o + d * z (no fma, like the reference) ----
    if (tid < P) ray_point(rays_o, rays_d, viewdirs, z_vals, ray0, S, t0 + tid, T, ray_z, pts, tid);
    __syncthreads();
    encode_tile<false, false>(pts, pex, ped, net);
    __syncthreads();
    mlp_core<false>(pex, ped, h, raw, net);
    // raw is next written after two more barriers of the next sub-tile
    const int c = tid / P, p = tid % P;  // THREADS == 4 * P
    if (t0 + p < T) ray_raw[c * stride + t0 + p] = raw[c * P + p];
  }
  composite(ray_raw, ray_z, stride, n_here, S, ray0, rays_d, white_bkgd, rgb_map, disp_map,
            acc_map, weights, depth_map);
}

// bf16: the block walks ray groups blockIdx.x, +gridDim.x, ... of R rays;
// warpgroup g runs points [64g, 64g+64) of each 128-point sub-tile. FAST:
// net.fast_epilogue.
template <bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
render_tile_wgmma(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                  const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
                  long long n_rays, int n_samples, int rays_per_block, Net net,
                  wg::Plan plan, int white_bkgd, float* __restrict__ rgb_map,
                  float* __restrict__ disp_map, float* __restrict__ acc_map,
                  float* __restrict__ weights, float* __restrict__ depth_map) {
  extern __shared__ float4 smem4[];
  const int S = n_samples;
  const int R = rays_per_block;
  const int stride = R * S;
  const long long groups = (n_rays + R - 1) / R;
  long long tiles = 0;  // 128-point sub-tiles this block runs
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long n_here = n_rays - grp * R < R ? n_rays - grp * R : R;
    tiles += (n_here * S + wg::TILE - 1) / wg::TILE;
  }
  wg::Core core = wg::make_core(smem4, plan);
  float* ray_raw = reinterpret_cast<float*>(core.base + wg::CORE_BYTES);  // [4][R*S]
  float* ray_z = ray_raw + 4 * stride;                                    // [R*S]
  core.ring.init(tiles * plan.per_tile);
  const int t = threadIdx.x & 127;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long ray0 = grp * R;
    const int n_here = static_cast<int>(n_rays - ray0 < R ? n_rays - ray0 : R);
    const int T = n_here * S;
    for (int t0 = 0; t0 < T; t0 += wg::TILE) {
      const int l0 = t0 + core.group * P;  // this warpgroup's first point
      wg::wg_barrier(core.group);          // the previous sub-tile's pts and raw are read
      if (t < P) ray_point(rays_o, rays_d, viewdirs, z_vals, ray0, S, l0 + t, T, ray_z, core.pts, t);
      wg::wg_barrier(core.group);
      wg::run_tile<FAST>(core, net);
      for (int idx = t; idx < 4 * P; idx += 128) {
        const int c = idx / P, p = idx % P;
        if (l0 + p < T) ray_raw[c * stride + l0 + p] = core.raw[c * P + p];
      }
    }
    composite(ray_raw, ray_z, stride, n_here, S, ray0, rays_d, white_bkgd, rgb_map, disp_map,
              acc_map, weights, depth_map);
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Rays per block for S samples per ray: R*S a multiple of the `tile`-point
// sub-tile where that keeps R*S <= max_points, else the fewest rays that
// fill one sub-tile.
int block_rays(int n_samples, int tile, int max_points) {
  const int r = tile / gcd(n_samples, tile);
  if (r * n_samples <= max_points) return r;
  return n_samples >= tile ? 1 : (tile + n_samples - 1) / n_samples;
}

}  // namespace

extern "C" {

// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb; packed:
// the bf16 weight chunks of raymarch.py pack_wgmma_weights (bf16 only,
// 16-byte aligned). Returns a cudaError_t value: 0 when the launch was
// accepted.
int render_tile(const float* rays_o, const float* rays_d, const float* viewdirs,
                const float* z_vals, long long n_rays, int n_samples,
                const void* const* weights, int depth, unsigned skip_mask,
                int in_ch, int in_ch_views, int bf16, const void* packed,
                int fast_epilogue, int white_bkgd, float* rgb_map, float* disp_map,
                float* acc_map, float* weights_out, float* depth_map, void* stream) {
  Net net;
  const int err = make_net(weights, depth, skip_mask, in_ch, in_ch_views,
                           fast_epilogue, &net);
  if (err != 0) return err;
  if (n_samples < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int rays = block_rays(n_samples, wg::TILE, MAX_POINTS);
    if (static_cast<long long>(rays) * n_samples > MAX_POINTS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = wg::CORE_BYTES + wg::SMEM_ALIGN +
                        5 * static_cast<size_t>(rays) * n_samples * sizeof(float);
    return wg::launch_persistent(fast_epilogue ? render_tile_wgmma<true> : render_tile_wgmma<false>,
                                 (n_rays + rays - 1) / rays, smem, s,
                                 rays_o, rays_d, viewdirs, z_vals, n_rays, n_samples, rays,
                                 net, wg::make_plan(packed, depth, skip_mask), white_bkgd,
                                 rgb_map, disp_map, acc_map, weights_out, depth_map);
  }
  const int rays = block_rays(n_samples, P, MAX_POINTS);
  const long long blocks = (n_rays + rays - 1) / rays;
  const size_t smem =
      (CORE_FLOATS + 6 * P + 5 * static_cast<size_t>(rays) * n_samples) * sizeof(float);
  return launch(render_tile_kernel, blocks, smem, s, rays_o, rays_d, viewdirs, z_vals,
                n_rays, n_samples, rays, net, white_bkgd, rgb_map, disp_map, acc_map,
                weights_out, depth_map);
}

}  // extern "C"
