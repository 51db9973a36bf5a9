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
// Bound on this card: operations, the FP32 rate in float32 (nerf_mlp.cuh;
// 27.86 ms at 8192 rays x 192 samples) and the bf16 tensor-core rate in
// bf16 (nerf_mlp_wgmma.cuh; 1.888 ms); per sample it reads 4 bytes of z and
// writes 4 bytes of weight.
//
// Design: persistent blocks walk groups of R whole rays (groups blockIdx.x,
// +gridDim.x, ...) and run the MLP over each group's points in sub-tiles of
// the core's tile, keeping the raw outputs and depths in shared [4][R*seg]
// and [R*seg] buffers beside the core. A group takes its rays' samples in
// segments of seg: all S at once where the buffers fit R rays of S samples
// (every S of the exact and production renders at the default net), else
// one ray per group in segments of the most samples that fit (a multiple of
// the sub-tile when at least one fits), so any S runs. The MLP:
//   - float32: sub-tiles of the FP32 core's tile (nerf_mlp.cuh: 128 or 64
//     points at W = 256, 64 or 32 at W = 512, 32 or 16 at W = 1024), R up
//     to tile / gcd(S, tile): the tile and R that waste the least of the
//     FP32 pipes, given what the buffers leave room for (at W = 256: 128
//     points and R = 2 for S = 64 and 192, 64 points and R = 4 for S = 144;
//     at W = 1024: 32 points, whole rays for S = 64 and segments of 96 for
//     S = 192);
//   - bf16: sub-tiles of the wgmma core's tile (nerf_mlp_wgmma.cuh: 128
//     points at W = 256, 64 at W = 512, 32 on the transposed core), R =
//     tile / gcd(S, tile) where the buffers fit (R = 2 for S = 64 and 192 at
//     W = 256), else the fewest rays that fill one sub-tile.
// Both stream their packed weights through the core's shared-memory ring
// (each header reckons the weight traffic). A net neither core of its
// dtype has room for runs, in either dtype, on the streaming core of
// nerf_mlp_stream.cuh (entry render_tile_stream): sub-tiles of its tile (32
// to 4 points) and the groups and segments of the bf16 plan, with masked
// sub-tile slots in its clusters as on the standard wgmma core.
// When all of a segment's points are in, the block turns every point's
// density into alpha and its logits into sigmoids in parallel (a segment's
// last sample reads the next depth from z); then thread r runs ray r's
// exclusive product and sums over shared memory in sample order (the order
// of torch.cumprod), in float32, from the transmittance and sums that the
// ray's earlier segments left in shared memory, so a segmented ray sums
// exactly as a whole one. The TPU kernel computed the product as
// exp(log(1 - alpha) @ U) with a triangular matrix only because Mosaic has
// no cumprod; here it is a plain loop of a few multiply-adds per sample.

#include "nerf_mlp_stream.cuh"
#include "nerf_mlp_wgmma.cuh"

using namespace nerf;

namespace {

// shared bytes per point of a segment: raw [4] and z; per ray of a group:
// its transmittance and its r, g, b, depth and acc sums, carried from one
// segment to the next
constexpr int POINT_BYTES = 5 * 4;
constexpr int RAY_BYTES = 6 * 4;

// The barrier of the threads that composite: the whole block of the FP32
// core (CONSUMERS false), the THREADS consumer threads of a wgmma block.
template <bool CONSUMERS>
__device__ __forceinline__ void composite_sync() {
  if constexpr (CONSUMERS) {
    wg::consumer_sync();
  } else {
    __syncthreads();
  }
}

// Alpha-composites samples [s0, s0 + len) of the block's n_here rays (from
// ray0) from shared ray_raw [4][stride] (r, g, b logits, sigma; sigma and
// the logits are overwritten) and ray_z [stride], the rays' earlier
// segments' transmittance and sums in carry [6][R]; writes the segment's
// weights, and each ray's maps after its last segment. Called by each of
// the block's THREADS compositing threads once the segment's points are in.
template <bool CONSUMERS>
__device__ __forceinline__ void composite(float* ray_raw, const float* ray_z, float* carry,
                                          int stride, int R, int n_here, int s0, int len, int S,
                                          long long ray0, const float* __restrict__ rays_d,
                                          const float* __restrict__ z_vals, int white_bkgd,
                                          float* __restrict__ rgb_map,
                                          float* __restrict__ disp_map,
                                          float* __restrict__ acc_map,
                                          float* __restrict__ weights,
                                          float* __restrict__ depth_map) {
  const int tid = threadIdx.x;
  const int T = n_here * len;
  composite_sync<CONSUMERS>();

  // ---- per point, in parallel: alpha over the raw density, sigmoid rgb --
  for (int l = tid; l < T; l += THREADS) {
    const int r = l / len, sl = l - r * len, s = s0 + sl;
    const long long ray = ray0 + r;
    const float* d = rays_d + ray * 3;
    const float dn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    float dist = 1e10f;
    if (s + 1 < S) dist = (sl + 1 < len ? ray_z[l + 1] : z_vals[ray * S + s + 1]) - ray_z[l];
    dist *= dn;
    float* sigma = ray_raw + 3 * stride + l;
    *sigma = 1.f - expf(-relu(*sigma) * dist);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ray_raw[c * stride + l] = 1.f / (1.f + expf(-ray_raw[c * stride + l]));
    }
  }
  composite_sync<CONSUMERS>();

  // ---- compositing: thread r owns ray ray0 + r, product and sums in order
  if (tid < n_here) {
    const long long ray = ray0 + tid;
    const int l0 = tid * len;
    float trans = 1.f, r = 0.f, g = 0.f, b = 0.f, dep = 0.f, acc = 0.f;
    if (s0 > 0) {
      trans = carry[tid];
      r = carry[R + tid];
      g = carry[2 * R + tid];
      b = carry[3 * R + tid];
      dep = carry[4 * R + tid];
      acc = carry[5 * R + tid];
    }
    for (int s = 0; s < len; ++s) {
      const int l = l0 + s;
      const float alpha = ray_raw[3 * stride + l];
      const float w = alpha * trans;
      trans = trans * (1.f - alpha + 1e-10f);
      weights[ray * S + s0 + s] = w;
      r += w * ray_raw[l];
      g += w * ray_raw[stride + l];
      b += w * ray_raw[2 * stride + l];
      dep += w * ray_z[l];
      acc += w;
    }
    if (s0 + len < S) {
      carry[tid] = trans;
      carry[R + tid] = r;
      carry[2 * R + tid] = g;
      carry[3 * R + tid] = b;
      carry[4 * R + tid] = dep;
      carry[5 * R + tid] = acc;
    } else {
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
      disp_map[ray] = 1.f / fmax_nan(dep / fmax_nan(acc, 1e-10f), 1e-10f);
    }
  }
  composite_sync<CONSUMERS>();  // ray_raw, ray_z and carry are free again
}

// Point l of a segment's T = n_here * len points (rays from ray0, samples
// from s0): its depth into ray_z[l] and x = o + d * z (no fma, like the
// reference) into column p of a [6][stride] tile; zero past T.
__device__ __forceinline__ void ray_point(const float* __restrict__ rays_o,
                                          const float* __restrict__ rays_d,
                                          const float* __restrict__ viewdirs,
                                          const float* __restrict__ z_vals, long long ray0,
                                          int S, int s0, int len, int l, int T, float* ray_z,
                                          float* pts, int stride, int p) {
  float x[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (l < T) {
    const int r = l / len;
    const long long ray = ray0 + r;
    const float zv = z_vals[ray * S + s0 + (l - r * len)];
    ray_z[l] = zv;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = __fadd_rn(rays_o[ray * 3 + c], __fmul_rn(rays_d[ray * 3 + c], zv));
      x[3 + c] = viewdirs[ray * 3 + c];
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) pts[c * stride + p] = x[c];
}

// The sub-tiles of TILE points that block `block` runs over its ray groups'
// segments.
template <int TILE>
__device__ __forceinline__ long long block_tiles(long long block, long long n_rays, int S, int R,
                                                 int seg) {
  const long long groups = (n_rays + R - 1) / R;
  long long tiles = 0;
  for (long long grp = block; grp < groups; grp += gridDim.x) {
    const long long n_here = n_rays - grp * R < R ? n_rays - grp * R : R;
    for (int s0 = 0; s0 < S; s0 += seg) {
      const int len = S - s0 < seg ? S - s0 : seg;
      tiles += (n_here * len + TILE - 1) / TILE;
    }
  }
  return tiles;
}

// float32: the block walks ray groups blockIdx.x, +gridDim.x, ... of R rays,
// in segments of seg samples, in sub-tiles of TILE points on the FP32 core.
template <int TILE, int W>
__global__ void __launch_bounds__(THREADS, 1)
render_tile_f32(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
                long long n_rays, int n_samples, int rays_per_block, int seg, Net net, Plan plan,
                int rx, int rd, int white_bkgd, float* __restrict__ rgb_map,
                float* __restrict__ disp_map, float* __restrict__ acc_map,
                float* __restrict__ weights, float* __restrict__ depth_map) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int S = n_samples;
  const int R = rays_per_block;
  const int stride = R * seg;
  const long long groups = (n_rays + R - 1) / R;
  f32::Core<TILE, W> core = f32::make_core<TILE, W>(smem4, plan, rx, rd);
  // [4][R*seg] the segment's raw field, [R*seg] its depths, [6][R] the carry
  unsigned char* core_end =
      reinterpret_cast<unsigned char*>(smem4) + f32::core_bytes(TILE, W, rx, rd);
  float* ray_raw = reinterpret_cast<float*>(core_end);
  float* ray_z = ray_raw + 4 * stride;
  float* carry = ray_z + stride;
  core.ring.init(block_tiles<TILE>(blockIdx.x, n_rays, S, R, seg) * plan.per_tile);
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long ray0 = grp * R;
    const int n_here = static_cast<int>(n_rays - ray0 < R ? n_rays - ray0 : R);
    for (int s0 = 0; s0 < S; s0 += seg) {
      const int len = S - s0 < seg ? S - s0 : seg;
      const int T = n_here * len;
      for (int t0 = 0; t0 < T; t0 += TILE) {
        __syncthreads();  // the previous sub-tile's raw outputs are read
        if (tid < TILE) {
          ray_point(rays_o, rays_d, viewdirs, z_vals, ray0, S, s0, len, t0 + tid, T, ray_z,
                    core.pts, TILE, tid);
        }
        __syncthreads();
        f32::run_tile<TILE, W, false>(core, net);
        for (int idx = tid; idx < 4 * TILE; idx += THREADS) {
          const int c = idx / TILE, p = idx % TILE;
          if (t0 + p < T) ray_raw[c * stride + t0 + p] = core.raw[c * TILE + p];
        }
      }
      composite<false>(ray_raw, ray_z, carry, stride, R, n_here, s0, len, S, ray0, rays_d,
                       z_vals, white_bkgd, rgb_map, disp_map, acc_map, weights, depth_map);
    }
  }
}

// bf16: the block walks ray groups blockIdx.x, +gridDim.x, ... of R rays, in
// segments of seg samples, in sub-tiles of wg::Core<W, NX>::TILE points: at
// W = 256 warpgroup g runs points [64g, 64g+64) of each 128-point sub-tile,
// at W = 512 both run the columns of one 64-point sub-tile (both in
// clusters, with a producer warpgroup), on the transposed core (NX = 0) of
// one 32-point sub-tile. A block with fewer sub-tiles than the most of its
// cluster runs the difference masked after its own (zero points, no
// outputs), so that every block of a cluster consumes every chunk. FAST:
// net.fast_epilogue.
template <int W, int NX, bool FAST>
__global__ void __launch_bounds__(wg::Core<W, NX>::BLOCK, 1)
render_tile_wgmma(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                  const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
                  long long n_rays, int n_samples, int rays_per_block, int seg, Net net,
                  Plan plan, int nd, int white_bkgd, float* __restrict__ rgb_map,
                  float* __restrict__ disp_map, float* __restrict__ acc_map,
                  float* __restrict__ weights, float* __restrict__ depth_map) {
  extern __shared__ float4 smem4[];
  constexpr int TILE = wg::Core<W, NX>::TILE, PTS = wg::Core<W, NX>::PTS;
  const int S = n_samples;
  const int R = rays_per_block;
  const int stride = R * seg;
  wg::Core<W, NX> core = wg::make_core<W, NX>(smem4, plan, nd);
  // [4][R*seg] the segment's raw field, [R*seg] its depths, [6][R] the carry
  int core_size;
  if constexpr (NX == 0) {
    core_size = wg::t_core_bytes(W, wg::x_chunks(net.in_ch), nd);
  } else {
    core_size = wg::core_bytes(W, NX, nd);
  }
  float* ray_raw = reinterpret_cast<float*>(core.base + core_size);
  float* ray_z = ray_raw + 4 * stride;
  float* carry = ray_z + stride;
  const long long mine = block_tiles<TILE>(blockIdx.x, n_rays, S, R, seg);
  long long slots = 0;
  for (int r = 0; r < wg::Core<W, NX>::CLUSTER; ++r) {
    const long long n = block_tiles<TILE>(blockIdx.x - core.rank + r, n_rays, S, R, seg);
    slots = n > slots ? n : slots;
  }
  if (wg::start(core, slots * plan.per_tile)) return;
  const int t = threadIdx.x & 127;
  // one loop over the slots, so that the core is inlined once: slot k is
  // sub-tile t0 of segment s0 of group grp while k < mine, then masked
  long long grp = blockIdx.x;
  int s0 = 0, t0 = 0;
  for (long long k = 0; k < slots; ++k) {
    const bool real = k < mine;
    const long long ray0 = grp * R;
    const int n_here = real ? static_cast<int>(n_rays - ray0 < R ? n_rays - ray0 : R) : 0;
    const int len = S - s0 < seg ? S - s0 : seg;
    const int T = n_here * len;           // 0 when masked: zero points, no outputs
    const int l0 = t0 + core.point0();    // this warpgroup's first point
    core.sync();                          // the previous sub-tile's pts and raw are read
    if (core.io() && t < PTS) {
      ray_point(rays_o, rays_d, viewdirs, z_vals, ray0, S, s0, len, l0 + t, T, ray_z, core.pts,
                PTS, t);
    }
    core.sync();
    wg::run_tile<W, NX, FAST, false>(core, net);
    if (core.io()) {
      for (int idx = t; idx < 4 * PTS; idx += 128) {
        const int c = idx / PTS, p = idx % PTS;
        if (l0 + p < T) ray_raw[c * stride + l0 + p] = core.raw[c * PTS + p];
      }
    }
    if (real && (t0 += TILE) >= T) {
      composite<true>(ray_raw, ray_z, carry, stride, R, n_here, s0, len, S, ray0, rays_d,
                      z_vals, white_bkgd, rgb_map, disp_map, acc_map, weights, depth_map);
      t0 = 0;
      if ((s0 += seg) >= S) {
        s0 = 0;
        grp += gridDim.x;
      }
    }
  }
  wg::finish(core);
}

// The streaming core: the block walks ray groups blockIdx.x, +gridDim.x,
// ... of R rays, in segments of seg samples, in sub-tiles of TILE points, in
// clusters (stream::cluster_for) of blocks of two consumer warpgroups and a
// producer warp. A block with fewer sub-tiles than the most of its cluster
// runs the difference masked after its own (zero points, no outputs), so
// that every block consumes every piece. FAST: net.fast_epilogue (bf16
// only).
template <int TILE, bool BF16, bool FAST>
__global__ void __launch_bounds__(stream::BLOCK, 1)
stream_render_tile(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                   const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
                   long long n_rays, int n_samples, int rays_per_block, int seg, Net net,
                   stream::Layers layers, int white_bkgd, float* __restrict__ rgb_map,
                   float* __restrict__ disp_map, float* __restrict__ acc_map,
                   float* __restrict__ weights, float* __restrict__ depth_map) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int S = n_samples;
  const int R = rays_per_block;
  const int stride = R * seg;
  stream::Core<TILE, BF16> core = stream::make_core<TILE, BF16>(smem4, layers, net);
  // [4][R*seg] the segment's raw field, [R*seg] its depths, [6][R] the carry
  float* ray_raw = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(core.ring.buf) +
      stream::core_bytes(TILE, layers.stages, layers.width, net.in_ch, net.in_ch_views, BF16));
  float* ray_z = ray_raw + 4 * stride;
  float* carry = ray_z + stride;
  const long long mine = block_tiles<TILE>(blockIdx.x, n_rays, S, R, seg);
  long long slots = 0;
  for (int r = 0; r < layers.cluster; ++r) {
    const long long n = block_tiles<TILE>(blockIdx.x - core.rank + r, n_rays, S, R, seg);
    slots = n > slots ? n : slots;
  }
  if (stream::start(core, slots * layers.per_tile)) return;
  // one loop over the slots, so that the core is inlined once: slot k is
  // sub-tile t0 of segment s0 of group grp while k < mine, then masked
  long long grp = blockIdx.x;
  int s0 = 0, t0 = 0;
  for (long long k = 0; k < slots; ++k) {
    const bool real = k < mine;
    const long long ray0 = grp * R;
    const int n_here = real ? static_cast<int>(n_rays - ray0 < R ? n_rays - ray0 : R) : 0;
    const int len = S - s0 < seg ? S - s0 : seg;
    const int T = n_here * len;  // 0 when masked: zero points, no outputs
    core.sync();                 // the previous sub-tile's pts and raw are read
    if (tid < TILE) {
      ray_point(rays_o, rays_d, viewdirs, z_vals, ray0, S, s0, len, t0 + tid, T, ray_z, core.pts,
                TILE, tid);
    }
    core.sync();
    stream::run_tile<TILE, BF16, FAST, false>(core, net);
    for (int idx = tid; idx < 4 * TILE; idx += THREADS) {
      const int c = idx / TILE, p = idx % TILE;
      if (t0 + p < T) ray_raw[c * stride + t0 + p] = core.raw[c * TILE + p];
    }
    if (real && (t0 += TILE) >= T) {
      composite<true>(ray_raw, ray_z, carry, stride, R, n_here, s0, len, S, ray0, rays_d,
                      z_vals, white_bkgd, rgb_map, disp_map, acc_map, weights, depth_map);
      t0 = 0;
      if ((s0 += seg) >= S) {
        s0 = 0;
        grp += gridDim.x;
      }
    }
  }
  stream::finish(core);
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Shared bytes of a group of `rays` rays in segments of `seg` samples.
long long group_bytes(int rays, int seg) {
  return static_cast<long long>(rays) * (static_cast<long long>(seg) * POINT_BYTES + RAY_BYTES);
}

// bf16 rays per group for whole rays of S samples in `room` bytes: R*S a
// multiple of the `tile`-point sub-tile where that fits, else the fewest
// rays that fill one sub-tile, else as many as fit (0 when not one does).
int block_rays(int n_samples, int tile, long long room) {
  const int r = tile / gcd(n_samples, tile);
  if (group_bytes(r, n_samples) <= room) return r;
  const int fill = n_samples >= tile ? 1 : (tile + n_samples - 1) / n_samples;
  const long long fit = room / group_bytes(1, n_samples);
  return fill < fit ? fill : static_cast<int>(fit);
}

// Samples per segment of one ray per group in `room` bytes: the most that
// fit, rounded down to whole sub-tiles of `tile` points where at least one
// fits; 0 when not one sample does.
int segment_samples(int tile, long long room) {
  const long long fit = room < RAY_BYTES ? 0 : (room - RAY_BYTES) / POINT_BYTES;
  const long long seg = fit >= tile ? fit / tile * tile : fit;
  return static_cast<int>(seg < 0x7fffffff ? seg : 0x7fffffff);
}

// The FP32 core's smaller tile runs at this fraction of its big tile's rate
// per point (kernel 1, float32, 64- vs 128-point tiles at W = 256 on an
// H100: 0.80-0.87)
constexpr float SMALL_TILE_RATE = 0.85f;

// The float32 sub-tile (the width's big tile or half of it), rays per group
// and samples per segment for S samples: of each tile's plans, the one that
// runs the points fastest, counting the pad points of each sub-tile run and
// SMALL_TILE_RATE. A tile's plans: whole rays, R up to tile / gcd(S, tile)
// of them where they fit beside the tile's core, else one ray per group in
// the longest segments that fit (whole sub-tiles of the big tile; a
// segmented ray costs only its segments' compositing passes, so at
// W = 1024, S = 192 the 32-point tile in two segments beats whole rays on
// 16-point tiles); false if not one sample fits.
bool pick_f32(int n_samples, int width, int rx, int rd, int smem_max, int* tile, int* rays,
              int* seg) {
  float best = 0.f;
  const int big = f32::big_tile(width);
  const int tiles[2] = {big, big / 2};
  for (const int t : tiles) {
    const long long room = smem_max - f32::core_bytes(t, width, rx, rd);
    const float speed = t == big ? 1.f : SMALL_TILE_RATE;
    const auto consider = [&](int r, int s, long long padded) {
      const float rate = speed * static_cast<float>(static_cast<long long>(r) * n_samples) /
                         static_cast<float>(padded);
      if (rate > best) {
        best = rate;
        *tile = t;
        *rays = r;
        *seg = s;
      }
    };
    const int most = t / gcd(n_samples, t);
    bool whole = false;
    for (int r = 1; r <= most && group_bytes(r, n_samples) <= room; ++r) {
      const long long points = static_cast<long long>(r) * n_samples;
      consider(r, n_samples, (points + t - 1) / t * t);
      whole = true;
    }
    const int s = whole ? 0 : segment_samples(t, room);
    if (s >= t || (t == big / 2 && s > 0)) {
      // full segments of s samples, then the rest, each in sub-tiles of t
      const long long padded = static_cast<long long>(n_samples / s) * ((s + t - 1) / t * t) +
                               (n_samples % s + t - 1) / t * t;
      consider(1, s, padded);
    }
  }
  return best > 0.f;
}

// The launches of one instantiation, for the cores' dispatch.
struct TileF32 {
  template <int TILE, int W>
  static int run(long long blocks, size_t smem, cudaStream_t s, const float* rays_o,
                 const float* rays_d, const float* viewdirs, const float* z_vals, long long n_rays,
                 int n_samples, int rays, int seg, Net net, Plan plan, int rx, int rd,
                 int white_bkgd, float* rgb_map, float* disp_map, float* acc_map,
                 float* weights_out, float* depth_map) {
    return launch_persistent(render_tile_f32<TILE, W>, blocks, smem, s, rays_o, rays_d, viewdirs,
                             z_vals, n_rays, n_samples, rays, seg, net, plan, rx, rd, white_bkgd,
                             rgb_map, disp_map, acc_map, weights_out, depth_map);
  }
};

template <bool FAST>
struct TileWgmma {
  template <int W, int NX>
  static int run(long long blocks, size_t smem, cudaStream_t s, const float* rays_o,
                 const float* rays_d, const float* viewdirs, const float* z_vals, long long n_rays,
                 int n_samples, int rays, int seg, Net net, Plan plan, int nd, int white_bkgd,
                 float* rgb_map, float* disp_map, float* acc_map, float* weights_out,
                 float* depth_map) {
    return wg::launch_core<W, NX>(render_tile_wgmma<W, NX, FAST>, blocks, smem, s, rays_o,
                                  rays_d, viewdirs, z_vals, n_rays, n_samples, rays, seg, net,
                                  plan, nd, white_bkgd, rgb_map, disp_map, acc_map, weights_out,
                                  depth_map);
  }
};

template <bool FAST>
struct TileStream {
  template <int TILE, bool BF16>
  static int run(long long blocks, size_t smem, cudaStream_t s, const float* rays_o,
                 const float* rays_d, const float* viewdirs, const float* z_vals, long long n_rays,
                 int n_samples, int rays, int seg, Net net, stream::Layers layers, int white_bkgd,
                 float* rgb_map, float* disp_map, float* acc_map, float* weights_out,
                 float* depth_map) {
    // float32 has no fast epilogue: one instantiation
    return wg::launch_clusters(stream_render_tile<TILE, BF16, FAST && BF16>, blocks,
                               layers.cluster, stream::BLOCK, smem, s, rays_o, rays_d, viewdirs,
                               z_vals, n_rays, n_samples, rays, seg, net, layers, white_bkgd,
                               rgb_map, disp_map, acc_map, weights_out, depth_map);
  }
};

// The streaming core's launch for S samples in `smem_max` bytes: the
// largest tile that leaves room for one sample beside the core on
// MIN_STAGES, the bf16 plan's rays per group (whole rays where they fit,
// else one ray in segments), then as many more ring stages as the rest
// holds; false when not one sample fits.
bool plan_stream(int n_samples, int width, int in_ch, int in_ch_views, bool bf16, int smem_max,
                 int* tile, int* stages, int* rays, int* seg) {
  if (stream::pick(width, in_ch, in_ch_views, bf16, group_bytes(1, 1), tile, stages) != 0 ||
      *tile == 0) {
    return false;
  }
  const long long room = smem_max - stream::launch_bytes(*tile, stream::MIN_STAGES, width, in_ch,
                                                         in_ch_views, bf16);
  *rays = block_rays(n_samples, *tile, room);
  *seg = n_samples;
  if (*rays < 1) {
    *rays = 1;
    *seg = segment_samples(*tile, room);
  }
  if (*seg < 1) return false;
  const long long more = (room - group_bytes(*rays, *seg)) / (stream::PIECE + 16);
  *stages = stream::MIN_STAGES +
            static_cast<int>(more < stream::MAX_STAGES - stream::MIN_STAGES
                                 ? more : stream::MAX_STAGES - stream::MIN_STAGES);
  return true;
}

}  // namespace

extern "C" {

// The most samples of one segment (one ray per group) on a core (0: the
// FP32 core, 1: wgmma, 2 / 3: the streaming core in float32 / bf16 at the
// tile of its launches, on MIN_STAGES) for a net's width and encodings,
// from the device's shared memory; 0 when the core leaves no room for one.
// A ray of more samples runs in segments.
int render_tile_max_samples(int core, int width, int in_ch, int in_ch_views) {
  int smem_max = 0;
  if (smem_optin(&smem_max) != 0) return 0;
  long long bytes;
  if (core >= 2) {
    const bool bf16 = core == 3;
    int tile = 0, stages = 0;
    if (stream::pick(width, in_ch, in_ch_views, bf16, group_bytes(1, 1), &tile, &stages) != 0 ||
        tile == 0) {
      return 0;
    }
    bytes = stream::launch_bytes(tile, stream::MIN_STAGES, width, in_ch, in_ch_views, bf16);
  } else {
    bytes = core ? wg::launch_bytes(width, in_ch, in_ch_views)
                 : f32::smallest_bytes(width, in_ch, in_ch_views);
  }
  return segment_samples(1, static_cast<long long>(smem_max) - bytes);
}

// The streaming core's plan of a launch for S samples on the current
// device in a dtype (the sub-tile, ring stages, rays per group and samples
// per segment) and its shared memory; 0 bytes when not one sample fits.
long long render_tile_stream_plan(int n_samples, int width, int in_ch, int in_ch_views, int bf16,
                                  int* tile, int* stages, int* rays, int* seg) {
  int smem_max = 0;
  if (n_samples < 1 || smem_optin(&smem_max) != 0 ||
      !plan_stream(n_samples, width, in_ch, in_ch_views, bf16 != 0, smem_max, tile, stages, rays,
                   seg)) {
    return 0;
  }
  return stream::launch_bytes(*tile, *stages, width, in_ch, in_ch_views, bf16 != 0) +
         group_bytes(*rays, *seg);
}

// The FP32 core's plan of a launch for S samples on the current device (the
// sub-tile, rays per group and samples per segment) and its shared memory;
// 0 bytes when not one sample fits.
int render_tile_f32_plan(int n_samples, int width, int in_ch, int in_ch_views, int* tile,
                         int* rays, int* seg) {
  int smem_max = 0;
  const int rx = f32::rows(in_ch), rd = f32::rows(in_ch_views);
  if (n_samples < 1 || smem_optin(&smem_max) != 0 ||
      !pick_f32(n_samples, width, rx, rd, smem_max, tile, rays, seg)) {
    return 0;
  }
  return f32::core_bytes(*tile, width, rx, rd) + static_cast<int>(group_bytes(*rays, *seg));
}

// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb, padded
// to a trunk of `width` (256, 512 or 1024); table: the net's device table
// (Net: bias pointers, then the skip mask's words); n_skips: the number of
// skips; packed: the weight chunks of the core this dtype runs (raymarch.py
// pack_f32_weights in float32, pack_wgmma_weights in bf16; 16-byte
// aligned). Returns a cudaError_t value: 0 when the launch was accepted.
int render_tile(const float* rays_o, const float* rays_d, const float* viewdirs,
                const float* z_vals, long long n_rays, int n_samples,
                const void* const* weights, const void* table, int width, int depth,
                int n_skips, int in_ch, int in_ch_views, int bf16, const void* packed,
                int fast_epilogue, int white_bkgd, float* rgb_map, float* disp_map,
                float* acc_map, float* weights_out, float* depth_map, void* stream) {
  Net net;
  const int err =
      make_net(weights, table, width, depth, in_ch, in_ch_views, fast_epilogue, &net);
  if (err != 0) return err;
  if (n_samples < 1 || packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int smem_max = 0;
  const int e = smem_optin(&smem_max);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int core = wg::launch_bytes(width, in_ch, in_ch_views);
    const long long room = static_cast<long long>(smem_max) - core;
    const int tile = wg::tile_points(width, in_ch, in_ch_views);
    int rays = room < 0 ? 0 : block_rays(n_samples, tile, room);
    int seg = n_samples;
    if (rays < 1) {
      rays = 1;
      seg = room < 0 ? 0 : segment_samples(tile, room);
    }
    if (seg < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = core + static_cast<size_t>(group_bytes(rays, seg));
    const Plan plan = wg::make_plan(packed, width, depth, n_skips, in_ch, in_ch_views);
    const int nx = wg::core_nx(width, in_ch, in_ch_views), nd = wg::d_chunks(in_ch_views);
    const long long blocks = (n_rays + rays - 1) / rays;
    return fast_epilogue
        ? wg::dispatch<TileWgmma<true>>(width, nx, blocks, smem, s, rays_o, rays_d, viewdirs,
                                        z_vals, n_rays, n_samples, rays, seg, net, plan, nd,
                                        white_bkgd, rgb_map, disp_map, acc_map, weights_out,
                                        depth_map)
        : wg::dispatch<TileWgmma<false>>(width, nx, blocks, smem, s, rays_o, rays_d, viewdirs,
                                         z_vals, n_rays, n_samples, rays, seg, net, plan, nd,
                                         white_bkgd, rgb_map, disp_map, acc_map, weights_out,
                                         depth_map);
  }
  const int rx = f32::rows(in_ch), rd = f32::rows(in_ch_views);
  int tile = 0, rays = 0, seg = 0;
  if (!pick_f32(n_samples, width, rx, rd, smem_max, &tile, &rays, &seg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = f32::make_plan(packed, tile, width, depth, n_skips, in_ch, in_ch_views);
  const size_t smem =
      f32::core_bytes(tile, width, rx, rd) + static_cast<size_t>(group_bytes(rays, seg));
  return f32::dispatch<TileF32>(width, tile, (n_rays + rays - 1) / rays, smem, s, rays_o, rays_d,
                                viewdirs, z_vals, n_rays, n_samples, rays, seg, net, plan, rx, rd,
                                white_bkgd, rgb_map, disp_map, acc_map, weights_out, depth_map);
}

// render_tile on the streaming core (nerf_mlp_stream.cuh), for the nets the
// other cores have no room for: the same arguments, with weights padded to
// a trunk of `width` (a multiple of 128) and `packed` the core's pieces of
// this dtype (raymarch.py pack_stream_weights; 16-byte aligned). Returns a
// cudaError_t value.
int render_tile_stream(const float* rays_o, const float* rays_d, const float* viewdirs,
                       const float* z_vals, long long n_rays, int n_samples,
                       const void* const* weights, const void* table, int width, int depth,
                       int n_skips, int in_ch, int in_ch_views, int bf16, const void* packed,
                       int fast_epilogue, int white_bkgd, float* rgb_map, float* disp_map,
                       float* acc_map, float* weights_out, float* depth_map, void* stream_) {
  Net net;
  if (!stream::width_ok(width)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_net(weights, table, depth, in_ch, in_ch_views, fast_epilogue, &net);
  if (err != 0) return err;
  if (n_samples < 1 || packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int smem_max = 0;
  const int e = smem_optin(&smem_max);
  if (e != 0) return e;
  int tile = 0, stages = 0, rays = 0, seg = 0;
  if (!plan_stream(n_samples, width, in_ch, in_ch_views, bf16 != 0, smem_max, &tile, &stages,
                   &rays, &seg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(
      stream::launch_bytes(tile, stages, width, in_ch, in_ch_views, bf16 != 0) +
      group_bytes(rays, seg));
  const stream::Layers layers{
      static_cast<const unsigned char*>(packed),
      stream::tile_pieces(width, depth, n_skips, in_ch, in_ch_views, bf16 != 0), stages,
      stream::cluster_for(tile), width};
  const long long blocks = (n_rays + rays - 1) / rays;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  return fast_epilogue
      ? stream::dispatch<TileStream<true>>(tile, bf16, blocks, smem, s, rays_o, rays_d, viewdirs,
                                           z_vals, n_rays, n_samples, rays, seg, net, layers,
                                           white_bkgd, rgb_map, disp_map, acc_map, weights_out,
                                           depth_map)
      : stream::dispatch<TileStream<false>>(tile, bf16, blocks, smem, s, rays_o, rays_d,
                                            viewdirs, z_vals, n_rays, n_samples, rays, seg, net,
                                            layers, white_bkgd, rgb_map, disp_map, acc_map,
                                            weights_out, depth_map);
}

}  // extern "C"
