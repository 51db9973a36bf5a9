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
//   - float32: tiles of 128 points at W = 256, 64 at W = 512 and 32 at
//     W = 1024 (half that for nets with long encodings) on the FP32 core of
//     nerf_mlp.cuh, its packed float32 weights streamed through the core's
//     shared-memory ring;
//   - bf16: blocks of two warpgroups on a wgmma core of nerf_mlp_wgmma.cuh
//     (128-point tiles at W = 256, 64-point tiles whose columns the
//     warpgroups split at W = 512; 32-point tiles of the transposed core at
//     W = 1024 and for narrower nets with long encodings), its packed bf16
//     weights streamed the same way;
//   - a net neither core of its dtype has room for (a trunk past 1024, or
//     encodings past their shared memory), in either dtype: the streaming
//     core of nerf_mlp_stream.cuh on tiles of 32 to 4 points (in clusters of
//     2 blocks on 32-point tiles), its packed pieces streamed through its
//     own ring (entry nerf_march_stream).
// Each header reckons its core's weight traffic.

#include "nerf_mlp_stream.cuh"
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
template <int TILE, int W>
__global__ void __launch_bounds__(THREADS, 1)
nerf_march_f32(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
               const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
               int total, int n_samples, Net net, Plan plan, int rx, int rd,
               float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + TILE - 1) / TILE;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  f32::Core<TILE, W> core = f32::make_core<TILE, W>(smem4, plan, rx, rd);
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
    f32::run_tile<TILE, W, false>(core, net);
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

// bf16: blocks of two consumer warpgroups over tiles of wg::Core<W,
// NX>::TILE points (tile slots blockIdx.x, +gridDim.x, ...; a slot past the
// last tile runs masked, see Core::slots): at W = 256 warpgroup g runs
// points [64g, 64g+64) of each 128-point tile, at W = 512 both run the
// columns of one 64-point tile (both in clusters, with a producer
// warpgroup), on the transposed core (NX = 0) both run the columns of one
// 32-point tile.
template <int W, int NX>
__global__ void __launch_bounds__(wg::Core<W, NX>::BLOCK, 1)
nerf_march_wgmma(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                 const float* __restrict__ viewdirs, const float* __restrict__ z_vals,
                 int total, int n_samples, Net net, Plan plan, int nd,
                 float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  constexpr int TILE = wg::Core<W, NX>::TILE, PTS = wg::Core<W, NX>::PTS;
  const int n_tiles = (total + TILE - 1) / TILE;
  wg::Core<W, NX> core = wg::make_core<W, NX>(smem4, plan, nd);
  const long long slots = core.slots(n_tiles);
  if (wg::start(core, slots * plan.per_tile)) return;
  const int t = threadIdx.x & 127;
  for (long long k = 0; k < slots; ++k) {
    const int tile = static_cast<int>(blockIdx.x + k * gridDim.x);
    const int base = tile * TILE + core.point0();
    core.sync();  // the previous tile's points and raw are read
    if (core.io() && t < PTS) {
      make_point(rays_o, rays_d, viewdirs, z_vals, base + t, total, n_samples, core.pts, PTS, t);
    }
    core.sync();
    wg::run_tile<W, NX, false, false>(core, net);  // the march has no fast epilogue
    if (core.io()) {
      for (int idx = t; idx < 4 * PTS; idx += 128) {
        const int c = idx / PTS, p = idx % PTS;
        const int gp = base + p;
        if (gp < total) {
          if (c == 3) {
            sigma[gp] = core.raw[3 * PTS + p];
          } else {
            rgb[static_cast<long long>(c) * total + gp] = core.raw[c * PTS + p];
          }
        }
      }
    }
  }
  wg::finish(core);
}

// The streaming core (the nets the other cores have no room for): tile
// slots blockIdx.x, +gridDim.x, ... of TILE points (a slot past the last
// tile runs masked, see stream::Core::slots), in clusters (stream::
// cluster_for) of blocks of two consumer warpgroups and a producer warp.
template <int TILE, bool BF16>
__global__ void __launch_bounds__(stream::BLOCK, 1)
stream_march(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
             const float* __restrict__ viewdirs, const float* __restrict__ z_vals, int total,
             int n_samples, Net net, stream::Layers layers, float* __restrict__ sigma,
             float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + TILE - 1) / TILE;
  stream::Core<TILE, BF16> core = stream::make_core<TILE, BF16>(smem4, layers, net);
  const long long slots = core.slots(n_tiles);
  if (stream::start(core, slots * layers.per_tile)) return;
  const int tid = threadIdx.x;
  for (long long k = 0; k < slots; ++k) {
    const int base = static_cast<int>(blockIdx.x + k * gridDim.x) * TILE;
    core.sync();  // the previous tile's raw outputs are read
    if (tid < TILE) {
      make_point(rays_o, rays_d, viewdirs, z_vals, base + tid, total, n_samples, core.pts, TILE,
                 tid);
    }
    core.sync();
    stream::run_tile<TILE, BF16, false, false>(core, net);
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
  stream::finish(core);
}

// The launches of one instantiation, for the cores' dispatch.
struct MarchF32 {
  template <int TILE, int W>
  static int run(long long total, size_t smem, cudaStream_t s, const float* rays_o,
                 const float* rays_d, const float* viewdirs, const float* z_vals, int n_samples,
                 Net net, Plan plan, int rx, int rd, float* sigma, float* rgb) {
    return launch_persistent(nerf_march_f32<TILE, W>, (total + TILE - 1) / TILE, smem, s, rays_o,
                             rays_d, viewdirs, z_vals, static_cast<int>(total), n_samples, net,
                             plan, rx, rd, sigma, rgb);
  }
};

struct MarchWgmma {
  template <int W, int NX>
  static int run(long long total, size_t smem, cudaStream_t s, const float* rays_o,
                 const float* rays_d, const float* viewdirs, const float* z_vals, int n_samples,
                 Net net, Plan plan, int nd, float* sigma, float* rgb) {
    constexpr int TILE = wg::Core<W, NX>::TILE;
    return wg::launch_core<W, NX>(nerf_march_wgmma<W, NX>, (total + TILE - 1) / TILE, smem, s,
                                  rays_o, rays_d, viewdirs, z_vals, static_cast<int>(total),
                                  n_samples, net, plan, nd, sigma, rgb);
  }
};

struct MarchStream {
  template <int TILE, bool BF16>
  static int run(long long total, size_t smem, cudaStream_t s, const float* rays_o,
                 const float* rays_d, const float* viewdirs, const float* z_vals, int n_samples,
                 Net net, stream::Layers layers, float* sigma, float* rgb) {
    return wg::launch_clusters(stream_march<TILE, BF16>, (total + TILE - 1) / TILE,
                               layers.cluster, stream::BLOCK, smem, s, rays_o, rays_d, viewdirs,
                               z_vals, static_cast<int>(total), n_samples, net, layers, sigma,
                               rgb);
  }
};

}  // namespace

extern "C" {

// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb, padded
// to a trunk of `width` (256, 512 or 1024); table: the net's device table
// (Net: bias pointers, then the skip mask's words); n_skips: the number of
// skips; packed: the weight chunks of the core this dtype runs (raymarch.py
// pack_f32_weights in float32, pack_wgmma_weights in bf16; 16-byte
// aligned). Returns a cudaError_t value: 0 when the launch was accepted.
int nerf_march(const float* rays_o, const float* rays_d, const float* viewdirs,
               const float* z_vals, long long n_rays, int n_samples,
               const void* const* weights, const void* table, int width, int depth,
               int n_skips, int in_ch, int in_ch_views, int bf16, const void* packed,
               float* sigma, float* rgb, void* stream) {
  Net net;
  const int err = make_net(weights, table, width, depth, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  const long long total = n_rays * n_samples;
  // a cluster's masked tile slots reach up to 4 P points past the end:
  // their indices must stay in int as well
  if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 ||
      total > 0x7fffffffLL - 8 * P) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const Plan plan = wg::make_plan(packed, width, depth, n_skips, in_ch, in_ch_views);
    return wg::dispatch<MarchWgmma>(width, wg::core_nx(width, in_ch, in_ch_views), total,
                                    static_cast<size_t>(wg::launch_bytes(width, in_ch, in_ch_views)),
                                    s, rays_o, rays_d, viewdirs, z_vals, n_samples, net, plan,
                                    wg::d_chunks(in_ch_views), sigma, rgb);
  }
  const int rx = f32::rows(in_ch), rd = f32::rows(in_ch_views);
  int tile = 0;
  const int e = f32::pick_tile(width, rx, rd, 0, &tile);
  if (e != 0) return e;
  const Plan plan = f32::make_plan(packed, tile, width, depth, n_skips, in_ch, in_ch_views);
  return f32::dispatch<MarchF32>(width, tile, total,
                                 static_cast<size_t>(f32::core_bytes(tile, width, rx, rd)), s,
                                 rays_o, rays_d, viewdirs, z_vals, n_samples, net, plan, rx, rd,
                                 sigma, rgb);
}

// nerf_march on the streaming core (nerf_mlp_stream.cuh), for the nets the
// other cores have no room for: the same arguments, with weights padded to
// a trunk of `width` (a multiple of 128) and `packed` the core's pieces of
// this dtype (raymarch.py pack_stream_weights; 16-byte aligned). Both
// dtypes: bf16 rounds where the JAX package does. Returns a cudaError_t
// value.
int nerf_march_stream(const float* rays_o, const float* rays_d, const float* viewdirs,
                      const float* z_vals, long long n_rays, int n_samples,
                      const void* const* weights, const void* table, int width, int depth,
                      int n_skips, int in_ch, int in_ch_views, int bf16, const void* packed,
                      float* sigma, float* rgb, void* stream_) {
  Net net;
  if (!stream::width_ok(width)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_net(weights, table, depth, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  const long long total = n_rays * n_samples;
  // a cluster's masked tile slots reach one tile past the end: their
  // indices must stay in int as well
  if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 ||
      total > 0x7fffffffLL - 2 * stream::MAX_TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile = 0, stages = 0;
  const int e = stream::pick(width, in_ch, in_ch_views, bf16 != 0, 0, &tile, &stages);
  if (e != 0) return e;
  const stream::Layers layers{
      static_cast<const unsigned char*>(packed),
      stream::tile_pieces(width, depth, n_skips, in_ch, in_ch_views, bf16 != 0), stages,
      stream::cluster_for(tile), width};
  return stream::dispatch<MarchStream>(
      tile, bf16, total,
      static_cast<size_t>(
          stream::launch_bytes(tile, stages, width, in_ch, in_ch_views, bf16 != 0)),
      static_cast<cudaStream_t>(stream_), rays_o, rays_d, viewdirs, z_vals, n_samples, net,
      layers, sigma, rgb);
}

}  // extern "C"
