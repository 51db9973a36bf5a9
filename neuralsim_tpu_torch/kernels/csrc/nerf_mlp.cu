// nerf_mlp.cu - the point-major NeRF MLP kernels for Hopper (sm_90a).
//
// One kernel per core, three input stages, each replacing a Pallas TPU
// kernel of neuralsim_tpu/kernels/raymarch.py; all write raw [M,4] (r, g, b
// logits, raw density sigma) for M points:
//
//   PROJECTION  `_mlp_widepe_kernel` (fused_nerf_mlp_widepe): points and
//               view directions [M,3], encoded in place with cos(y) as
//               sin(y + pi/2), as the TPU kernel's wide-lane tables do;
//   TRUE_COS    `_mlp_pe_kernel` (fused_nerf_mlp_pe): the same inputs,
//               encoded with a true cosf, as its `_pe_matmul` does;
//   ENCODED     `_mlp_kernel` (fused_nerf_mlp): pre-encoded inputs
//               x_pe [M, in_ch] and d_pe [M, in_ch_views].
//
// The TPU kernels' wide-lane PE tables exist for Mosaic's layouts; this
// kernel encodes from the coordinates, as nerf_march.cu does.
//
// Bound on this card: operations, the FP32 rate in float32 (nerf_mlp.cuh;
// 27.86 ms at 8192 x 192 points) and the bf16 tensor-core rate in bf16
// (nerf_mlp_wgmma.cuh; 1.887 ms). Per point it reads 24 bytes (pts, dirs)
// or 360 bytes (encoded) and writes 16: even the encoded stage moves its
// bytes (0.18 ms per 8192 x 192 launch) in a tenth of the bf16 operations
// bound.
//
// Design: persistent blocks over tiles of consecutive points; a tile's
// inputs are read with consecutive threads on consecutive addresses (the
// [M,3] / [M,C] rows of a tile are one contiguous run), and raw [M,4] goes
// back as one contiguous run.
//   - float32: tiles of 128 points at W = 256, 64 at W = 512 and 32 at
//     W = 1024 (half that for nets with long encodings) on the FP32 core of
//     nerf_mlp.cuh; the inputs are scattered into the core's feature-major
//     [channel][point] tiles;
//   - bf16, every stage: blocks of two warpgroups on a wgmma core of
//     nerf_mlp_wgmma.cuh (128-point tiles at W = 256, 64-point tiles whose
//     columns the warpgroups split at W = 512, 32-point tiles of the
//     transposed core at W = 1024 and for narrower nets with long
//     encodings). A tile's rows are read as points into the core's [6][PTS]
//     tile (encoded by the core, with a true cosf in TRUE_COS), or as x_pe
//     and d_pe straight into the swizzled tiles (load_tile_encodings);
//   - a net neither core of its dtype has room for, in either dtype: the
//     streaming core of nerf_mlp_stream.cuh (entry nerf_mlp_stream), the
//     inputs scattered into its tiles (stream::load_encodings) or read as
//     points.
// Both cores stream their packed weights through the shared-memory ring of
// nerf_mlp.cuh.

#include "nerf_mlp_stream.cuh"
#include "nerf_mlp_wgmma.cuh"

using namespace nerf;

namespace {

enum Input : int { PROJECTION = 0, TRUE_COS = 1, ENCODED = 2 };

// Rows [base, base + here) of src [*, n_ch] -> dst [rows][TILE + 4]; zero
// where the channel is >= n_ch or the point is past the end. Reads are
// coalesced: idx walks the tile's contiguous run.
template <int TILE>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int n_ch, int base,
                                          int here, float* dst, int rows) {
  constexpr int HS = TILE + 4;
  for (int idx = threadIdx.x; idx < rows * TILE; idx += THREADS) {
    const int c = idx / TILE, p = idx % TILE;
    if (c >= n_ch || p >= here) dst[c * HS + p] = 0.f;
  }
  const float* run = src + static_cast<long long>(base) * n_ch;
  for (int idx = threadIdx.x; idx < here * n_ch; idx += THREADS) {
    const int p = idx / n_ch, c = idx - p * n_ch;
    dst[c * HS + p] = run[idx];
  }
}

// float32: the block runs tiles blockIdx.x, +gridDim.x, ... of TILE points
// on the FP32 core.
template <int TILE, int W, int INPUT>
__global__ void __launch_bounds__(THREADS, 1)
nerf_mlp_f32(const float* __restrict__ a, const float* __restrict__ b, int total, Net net,
             Plan plan, int rx, int rd, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + TILE - 1) / TILE;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  f32::Core<TILE, W> core = f32::make_core<TILE, W>(smem4, plan, rx, rd);
  core.ring.init(static_cast<long long>(mine) * plan.per_tile);
  const int tid = threadIdx.x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    const int here = total - base < TILE ? total - base : TILE;
    __syncthreads();  // the previous tile's raw outputs are read
    if constexpr (INPUT == ENCODED) {
      load_rows<TILE>(a, net.in_ch, base, here, core.x, core.rx);
      load_rows<TILE>(b, net.in_ch_views, base, here, core.d, core.rd);
      __syncthreads();
      f32::mlp_tile<TILE, W>(core, net);
    } else {
      // a = points, b = view directions: the tile's rows of each are one
      // run of 3 * TILE floats
      const long long run = static_cast<long long>(base) * 3;
      for (int idx = tid; idx < 6 * TILE; idx += THREADS) {
        const int which = idx / (3 * TILE), j = idx - which * 3 * TILE;
        const int p = j / 3, c = j - 3 * p;
        const float* src = which ? b : a;
        core.pts[(3 * which + c) * TILE + p] = p < here ? src[run + j] : 0.f;
      }
      __syncthreads();
      f32::run_tile<TILE, W, INPUT == TRUE_COS>(core, net);
    }
    // ---- raw [M,4]: thread -> (point, channel), one contiguous run --------
    for (int idx = tid; idx < 4 * TILE; idx += THREADS) {
      const int p = idx >> 2, c = idx & 3;
      if (p < here) out[static_cast<long long>(base) * 4 + idx] = core.raw[c * TILE + p];
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
template <int W, int NX, int INPUT>
__global__ void __launch_bounds__(wg::Core<W, NX>::BLOCK, 1)
nerf_mlp_wgmma(const float* __restrict__ a, const float* __restrict__ b, int total, Net net,
               Plan plan, int nd, float* __restrict__ out) {
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
    const int here = total - base < PTS ? total - base : PTS;  // <= 0 past the end
    core.sync();  // the previous tile's inputs and raw are read
    if constexpr (INPUT == ENCODED) {
      wg::load_tile_encodings<W, NX>(a + static_cast<long long>(base) * net.in_ch,
                                     b + static_cast<long long>(base) * net.in_ch_views, here,
                                     core, net);
      wg::mlp_tile<W, NX, false>(core, net);
    } else {
      // a = points, b = view directions: the tile's rows of each are one
      // run of 3 * PTS floats
      if (core.io()) {
        const long long run = static_cast<long long>(base) * 3;
        for (int idx = t; idx < 6 * PTS; idx += 128) {
          const int which = idx / (3 * PTS), j = idx - which * 3 * PTS;
          const int p = j / 3, c = j - 3 * p;
          const float* src = which ? b : a;
          core.pts[(3 * which + c) * PTS + p] = p < here ? src[run + j] : 0.f;
        }
      }
      core.sync();
      // nerf_mlp.cu has no fast epilogue
      wg::run_tile<W, NX, false, INPUT == TRUE_COS>(core, net);
    }
    // ---- raw [M,4]: thread -> (point, channel), one contiguous run -------
    if (core.io()) {
      for (int idx = t; idx < 4 * PTS; idx += 128) {
        const int p = idx >> 2, c = idx & 3;
        if (p < here) out[static_cast<long long>(base) * 4 + idx] = core.raw[c * PTS + p];
      }
    }
  }
  wg::finish(core);
}

// The streaming core (the nets the other cores have no room for): tile
// slots blockIdx.x, +gridDim.x, ... of TILE points (a slot past the last
// tile runs masked, see stream::Core::slots), in clusters (stream::
// cluster_for) of blocks of two consumer warpgroups and a producer warp.
template <int TILE, bool BF16, int INPUT>
__global__ void __launch_bounds__(stream::BLOCK, 1)
stream_mlp(const float* __restrict__ a, const float* __restrict__ b, int total, Net net,
           stream::Layers layers, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + TILE - 1) / TILE;
  stream::Core<TILE, BF16> core = stream::make_core<TILE, BF16>(smem4, layers, net);
  const long long slots = core.slots(n_tiles);
  if (stream::start(core, slots * layers.per_tile)) return;
  const int tid = threadIdx.x;
  for (long long k = 0; k < slots; ++k) {
    const int base = static_cast<int>(blockIdx.x + k * gridDim.x) * TILE;
    const int here = total - base < TILE ? total - base : TILE;  // <= 0 past the end
    core.sync();  // the previous tile's inputs and raw outputs are read
    if constexpr (INPUT == ENCODED) {
      stream::load_encodings<TILE, BF16>(core, a + static_cast<long long>(base) * net.in_ch,
                                         b + static_cast<long long>(base) * net.in_ch_views, here,
                                         net);
      stream::mlp_tile<TILE, BF16, false>(core, net);
    } else {
      // a = points, b = view directions: the tile's rows of each are one
      // run of 3 * TILE floats
      const long long run = static_cast<long long>(base) * 3;
      for (int idx = tid; idx < 6 * TILE; idx += THREADS) {
        const int which = idx / (3 * TILE), j = idx - which * 3 * TILE;
        const int p = j / 3, c = j - 3 * p;
        const float* src = which ? b : a;
        core.pts[(3 * which + c) * TILE + p] = p < here ? src[run + j] : 0.f;
      }
      core.sync();
      stream::run_tile<TILE, BF16, false, INPUT == TRUE_COS>(core, net);
    }
    for (int idx = tid; idx < 4 * TILE; idx += THREADS) {
      const int p = idx >> 2, c = idx & 3;
      if (p < here) out[static_cast<long long>(base) * 4 + idx] = core.raw[c * TILE + p];
    }
  }
  stream::finish(core);
}

// The launches of one instantiation, for the cores' dispatch.
template <int INPUT>
struct MlpF32 {
  template <int TILE, int W>
  static int run(int total, size_t smem, cudaStream_t s, const float* a, const float* b, Net net,
                 Plan plan, int rx, int rd, float* out) {
    return launch_persistent(nerf_mlp_f32<TILE, W, INPUT>, (total + TILE - 1) / TILE, smem, s, a,
                             b, total, net, plan, rx, rd, out);
  }
};

template <int INPUT>
struct MlpWgmma {
  template <int W, int NX>
  static int run(int total, size_t smem, cudaStream_t s, const float* a, const float* b, Net net,
                 Plan plan, int nd, float* out) {
    constexpr int TILE = wg::Core<W, NX>::TILE;
    return wg::launch_core<W, NX>(nerf_mlp_wgmma<W, NX, INPUT>, (total + TILE - 1) / TILE, smem,
                                  s, a, b, total, net, plan, nd, out);
  }
};

template <int INPUT>
struct MlpStream {
  template <int TILE, bool BF16>
  static int run(int total, size_t smem, cudaStream_t s, const float* a, const float* b, Net net,
                 stream::Layers layers, float* out) {
    return wg::launch_clusters(stream_mlp<TILE, BF16, INPUT>, (total + TILE - 1) / TILE,
                               layers.cluster, stream::BLOCK, smem, s, a, b, total, net, layers,
                               out);
  }
};

// One stage's kernel on the streaming core.
template <int INPUT>
int launch_stream_stage(int total, const float* a, const float* b, int width, const void* packed,
                        int n_skips, int bf16, const Net& net, cudaStream_t s, float* out) {
  int tile = 0, stages = 0;
  const int e = stream::pick(width, net.in_ch, net.in_ch_views, bf16 != 0, 0, &tile, &stages);
  if (e != 0) return e;
  const stream::Layers layers{static_cast<const unsigned char*>(packed),
                              stream::tile_pieces(width, net.depth, n_skips, net.in_ch,
                                                  net.in_ch_views, bf16 != 0),
                              stages, stream::cluster_for(tile), width};
  return stream::dispatch<MlpStream<INPUT>>(
      tile, bf16, total,
      static_cast<size_t>(
          stream::launch_bytes(tile, stages, width, net.in_ch, net.in_ch_views, bf16 != 0)),
      s, a, b, net, layers, out);
}

// One stage's kernel in one dtype.
template <int INPUT>
int launch_stage(int bf16, int total, const float* a, const float* b, int width,
                 const void* packed, int n_skips, const Net& net, cudaStream_t s, float* out) {
  if (bf16) {
    const Plan plan =
        wg::make_plan(packed, width, net.depth, n_skips, net.in_ch, net.in_ch_views);
    return wg::dispatch<MlpWgmma<INPUT>>(
        width, wg::core_nx(width, net.in_ch, net.in_ch_views), total,
        static_cast<size_t>(wg::launch_bytes(width, net.in_ch, net.in_ch_views)), s, a, b, net,
        plan, wg::d_chunks(net.in_ch_views), out);
  }
  const int rx = f32::rows(net.in_ch), rd = f32::rows(net.in_ch_views);
  int tile = 0;
  const int e = f32::pick_tile(width, rx, rd, 0, &tile);
  if (e != 0) return e;
  const Plan plan =
      f32::make_plan(packed, tile, width, net.depth, n_skips, net.in_ch, net.in_ch_views);
  return f32::dispatch<MlpF32<INPUT>>(width, tile, total,
                                      static_cast<size_t>(f32::core_bytes(tile, width, rx, rd)),
                                      s, a, b, net, plan, rx, rd, out);
}

}  // namespace

extern "C" {

// a, b: points and view directions [M,3] (kind 0: projection encoding,
// kind 1: true cos) or x_pe [M,in_ch] and d_pe [M,in_ch_views] (kind 2).
// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb, padded
// to a trunk of `width` (256, 512 or 1024); table: the net's device table
// (Net: bias pointers, then the skip mask's words); n_skips: the number of
// skips; packed: the weight chunks of the core the dtype runs (raymarch.py
// pack_wgmma_weights in bf16, pack_f32_weights in float32; 16-byte
// aligned). out: raw [M,4]. Returns a cudaError_t value: 0 when the launch
// was accepted.
int nerf_mlp(const float* a, const float* b, long long total, int kind,
             const void* const* weights, const void* table, int width, int depth, int n_skips,
             int in_ch, int in_ch_views, int bf16, const void* packed, float* out,
             void* stream) {
  Net net;
  const int err = make_net(weights, table, width, depth, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  // a cluster's masked tile slots reach up to 4 P points past the end:
  // their indices must stay in int as well
  if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 ||
      total > 0x7fffffffLL - 8 * P) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(total);
  switch (kind) {
    case PROJECTION:
      return launch_stage<PROJECTION>(bf16, m, a, b, width, packed, n_skips, net, s, out);
    case TRUE_COS:
      return launch_stage<TRUE_COS>(bf16, m, a, b, width, packed, n_skips, net, s, out);
    case ENCODED:
      return launch_stage<ENCODED>(bf16, m, a, b, width, packed, n_skips, net, s, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// nerf_mlp on the streaming core (nerf_mlp_stream.cuh), for the nets the
// other cores have no room for: the same arguments, with weights padded to
// a trunk of `width` (a multiple of 128) and `packed` the core's pieces of
// this dtype (raymarch.py pack_stream_weights; 16-byte aligned). Returns a
// cudaError_t value.
int nerf_mlp_stream(const float* a, const float* b, long long total, int kind,
                    const void* const* weights, const void* table, int width, int depth,
                    int n_skips, int in_ch, int in_ch_views, int bf16, const void* packed,
                    float* out, void* stream_) {
  Net net;
  if (!stream::width_ok(width)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_net(weights, table, depth, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  // a cluster's masked tile slots reach one tile past the end: their
  // indices must stay in int as well
  if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 ||
      total > 0x7fffffffLL - 2 * stream::MAX_TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const int m = static_cast<int>(total);
  switch (kind) {
    case PROJECTION:
      return launch_stream_stage<PROJECTION>(m, a, b, width, packed, n_skips, bf16, net, s, out);
    case TRUE_COS:
      return launch_stream_stage<TRUE_COS>(m, a, b, width, packed, n_skips, bf16, net, s, out);
    case ENCODED:
      return launch_stream_stage<ENCODED>(m, a, b, width, packed, n_skips, bf16, net, s, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
