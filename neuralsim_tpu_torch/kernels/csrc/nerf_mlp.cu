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
//   - float32, and TRUE_COS in both types: tiles of 128 points (64 for nets
//     with long encodings) on the FP32 core of nerf_mlp.cuh; the inputs are
//     scattered into the core's feature-major [channel][point] tiles;
//   - bf16 PROJECTION and ENCODED: blocks of two warpgroups over 128-point
//     tiles on the wgmma core of nerf_mlp_wgmma.cuh. A warpgroup reads its
//     64 rows: points into the core's [6][P] tile (encoded by the core), or
//     x_pe and d_pe straight into the swizzled A tiles (load_encodings).
// Both cores stream their packed weights through the shared-memory ring of
// nerf_mlp.cuh.

#include "nerf_mlp_wgmma.cuh"

using namespace nerf;

namespace {

enum Input : int { PROJECTION = 0, TRUE_COS = 1, ENCODED = 2 };

// Rows [base, base + here) of src [*, n_ch] -> dst [rows][TILE + 4],
// rounded to the compute type; zero where the channel is >= n_ch or the
// point is past the end. Reads are coalesced: idx walks the tile's
// contiguous run.
template <int TILE, bool BF16>
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
    dst[c * HS + p] = round_cd<BF16>(run[idx]);
  }
}

// The FP32 core: the block runs tiles blockIdx.x, +gridDim.x, ... of TILE
// points.
template <int TILE, bool BF16, int INPUT>
__global__ void __launch_bounds__(THREADS, 1)
nerf_mlp_f32(const float* __restrict__ a, const float* __restrict__ b, int total, Net net,
             Plan plan, int rx, int rd, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + TILE - 1) / TILE;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  f32::Core<TILE> core = f32::make_core<TILE>(smem4, plan, rx, rd);
  core.ring.init(static_cast<long long>(mine) * plan.per_tile);
  const int tid = threadIdx.x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    const int here = total - base < TILE ? total - base : TILE;
    __syncthreads();  // the previous tile's raw outputs are read
    if constexpr (INPUT == ENCODED) {
      load_rows<TILE, BF16>(a, net.in_ch, base, here, core.x, core.rx);
      load_rows<TILE, BF16>(b, net.in_ch_views, base, here, core.d, core.rd);
      __syncthreads();
      f32::mlp_tile<TILE, BF16>(core, net);
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
      f32::run_tile<TILE, BF16, INPUT == TRUE_COS>(core, net);
    }
    // ---- raw [M,4]: thread -> (point, channel), one contiguous run --------
    for (int idx = tid; idx < 4 * TILE; idx += THREADS) {
      const int p = idx >> 2, c = idx & 3;
      if (p < here) out[static_cast<long long>(base) * 4 + idx] = core.raw[c * TILE + p];
    }
  }
}

// bf16 PROJECTION and ENCODED: warpgroup g of a block runs points
// [64g, 64g+64) of each of the block's 128-point tiles (tiles blockIdx.x,
// +gridDim.x, ...).
template <int INPUT>
__global__ void __launch_bounds__(THREADS, 1)
nerf_mlp_wgmma(const float* __restrict__ a, const float* __restrict__ b, int total, Net net,
               Plan plan, int nx, float* __restrict__ out) {
  static_assert(INPUT == PROJECTION || INPUT == ENCODED, "TRUE_COS runs the FP32 core");
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + wg::TILE - 1) / wg::TILE;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  wg::Core core = wg::make_core(smem4, plan, nx);
  core.ring.init(static_cast<long long>(mine) * plan.per_tile);
  const int t = threadIdx.x & 127;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * wg::TILE + core.group * P;
    const int here = total - base < P ? total - base : P;  // <= 0 past the end
    wg::wg_barrier(core.group);  // the previous tile's inputs and raw are read
    if constexpr (INPUT == ENCODED) {
      wg::load_encodings(a + static_cast<long long>(base) * net.in_ch,
                         b + static_cast<long long>(base) * net.in_ch_views, here, core.a, net,
                         nx);
      wg::mlp_tile<false>(core, net);
    } else {
      // a = points, b = view directions: the warpgroup's rows of each are
      // one run of 3P floats
      const long long run = static_cast<long long>(base) * 3;
      for (int idx = t; idx < 6 * P; idx += 128) {
        const int which = idx / (3 * P), j = idx - which * 3 * P;
        const int p = j / 3, c = j - 3 * p;
        const float* src = which ? b : a;
        core.pts[(3 * which + c) * P + p] = p < here ? src[run + j] : 0.f;
      }
      wg::wg_barrier(core.group);
      wg::run_tile<false>(core, net);  // nerf_mlp.cu has no fast epilogue
    }
    // ---- raw [M,4]: thread -> (point, channel), one contiguous run -------
    for (int idx = t; idx < 4 * P; idx += 128) {
      const int p = idx >> 2, c = idx & 3;
      if (p < here) out[static_cast<long long>(base) * 4 + idx] = core.raw[c * P + p];
    }
  }
}

// The FP32 core's kernel of a stage, in float32 (every stage) or bf16
// (TRUE_COS only).
template <int TILE>
int launch_f32(int kind, int bf16, size_t smem, cudaStream_t s, const float* a, const float* b,
               int total, const Net& net, const Plan& plan, int rx, int rd, float* out) {
  const long long tiles = (total + TILE - 1) / TILE;
  if (bf16) {
    if (kind != TRUE_COS) return static_cast<int>(cudaErrorInvalidValue);
    return launch_persistent(nerf_mlp_f32<TILE, true, TRUE_COS>, tiles, smem, s, a, b, total,
                             net, plan, rx, rd, out);
  }
  switch (kind) {
    case PROJECTION:
      return launch_persistent(nerf_mlp_f32<TILE, false, PROJECTION>, tiles, smem, s, a, b,
                               total, net, plan, rx, rd, out);
    case TRUE_COS:
      return launch_persistent(nerf_mlp_f32<TILE, false, TRUE_COS>, tiles, smem, s, a, b, total,
                               net, plan, rx, rd, out);
    case ENCODED:
      return launch_persistent(nerf_mlp_f32<TILE, false, ENCODED>, tiles, smem, s, a, b, total,
                               net, plan, rx, rd, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a, b: points and view directions [M,3] (kind 0: projection encoding,
// kind 1: true cos) or x_pe [M,in_ch] and d_pe [M,in_ch_views] (kind 2).
// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb, padded
// to the cores' width; packed: the weight chunks of the core the stage
// runs (raymarch.py pack_wgmma_weights for bf16 kinds 0 and 2,
// pack_f32_weights otherwise; 16-byte aligned). out: raw [M,4]. Returns a
// cudaError_t value: 0 when the launch was accepted.
int nerf_mlp(const float* a, const float* b, long long total, int kind,
             const void* const* weights, int depth, unsigned skip_mask,
             int in_ch, int in_ch_views, int bf16, const void* packed, float* out,
             void* stream) {
  Net net;
  const int err = make_net(weights, depth, skip_mask, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 ||
      total > 0x7fffffffLL - wg::TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && (kind == PROJECTION || kind == ENCODED)) {
    const long long tiles = (total + wg::TILE - 1) / wg::TILE;
    const int nx = wg::x_chunks(in_ch);
    const size_t smem = wg::core_bytes(nx) + wg::SMEM_ALIGN;
    const Plan plan = wg::make_plan(packed, depth, skip_mask, in_ch);
    return kind == PROJECTION
        ? launch_persistent(nerf_mlp_wgmma<PROJECTION>, tiles, smem, s, a, b,
                            static_cast<int>(total), net, plan, nx, out)
        : launch_persistent(nerf_mlp_wgmma<ENCODED>, tiles, smem, s, a, b,
                            static_cast<int>(total), net, plan, nx, out);
  }
  const int rx = f32::rows(in_ch), rd = f32::rows(in_ch_views);
  int tile = 0;
  const int e = f32::pick_tile(rx, rd, 0, &tile);
  if (e != 0) return e;
  const Plan plan = f32::make_plan(packed, depth, skip_mask, in_ch, in_ch_views);
  const size_t smem = f32::core_bytes(tile, rx, rd);
  const int m = static_cast<int>(total);
  if (tile == 128) return launch_f32<128>(kind, bf16, smem, s, a, b, m, net, plan, rx, rd, out);
  if (tile == 64) return launch_f32<64>(kind, bf16, smem, s, a, b, m, net, plan, rx, rd, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
