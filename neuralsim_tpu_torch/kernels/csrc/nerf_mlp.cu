// nerf_mlp.cu - the point-major NeRF MLP kernels for Hopper (sm_90a).
//
// One kernel, three input stages, each replacing a Pallas TPU kernel of
// neuralsim_tpu/kernels/raymarch.py; all write raw [M,4] (r, g, b logits,
// raw density sigma) for M points:
//
//   PROJECTION  `_mlp_widepe_kernel` (fused_nerf_mlp_widepe): points and
//               view directions [M,3], encoded in place with cos(y) as
//               sin(y + pi/2), as the TPU kernel's wide-lane tables do;
//   TRUE_COS    `_mlp_pe_kernel` (fused_nerf_mlp_pe): the same inputs,
//               encoded with a true cosf, as its `_pe_matmul` does;
//   ENCODED     `_mlp_kernel` (fused_nerf_mlp): pre-encoded inputs
//               x_pe [M, in_ch] and d_pe [M, in_ch_views].
//
// The TPU kernels' wide-lane PE tables and zero-padded weight rows exist
// for Mosaic's layouts; this kernel takes the unpadded weights and encodes
// from the coordinates, as nerf_march.cu does.
//
// Bound on this card: operations, the FP32 rate in float32 (nerf_mlp.cuh)
// and the bf16 tensor-core rate in bf16 (nerf_mlp_wgmma.cuh; 1.887 ms at
// 8192 x 192 points). Per point it reads 24 bytes (pts, dirs) or 360 bytes
// (encoded) and writes 16: even the encoded stage moves its bytes (0.18 ms
// per 8192 x 192 launch) in a tenth of the bf16 operations bound.
//
// Design:
//   - float32, and TRUE_COS in both types: one block of 256 threads per
//     tile of P=64 consecutive points on the FP32 core of nerf_mlp.cuh;
//     the tile's inputs are read with consecutive threads on consecutive
//     addresses (the [M,3] / [M,C] rows of the block are one contiguous
//     run) and scattered into the feature-major [channel][point] tiles of
//     the core; the [64,4] output tile is written back the same way;
//   - bf16 PROJECTION and ENCODED: persistent blocks of two warpgroups
//     over 128-point tiles on the wgmma core of nerf_mlp_wgmma.cuh, the
//     packed bf16 weights streamed through the core's shared-memory ring,
//     as in nerf_march.cu. A warpgroup reads its 64 rows as one contiguous
//     run: points into the core's [6][P] tile (encoded by the core), or
//     x_pe and d_pe straight into the swizzled A tiles (load_encodings);
//     raw [64,4] goes back as one contiguous run.

#include "nerf_mlp_wgmma.cuh"

using namespace nerf;

namespace {

enum Input : int { PROJECTION = 0, TRUE_COS = 1, ENCODED = 2 };

constexpr int SMEM_FLOATS = CORE_FLOATS + 6 * P;

// Rows [base, base + P) of src [total, n_ch] -> dst [rows][P], rounded to
// the compute type; zero where the channel is >= n_ch or the point is past
// the end. Reads are coalesced: idx walks the block's contiguous run.
template <bool BF16>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int n_ch, long long base,
                                          long long total, float* dst, int rows) {
  const int here = static_cast<int>(total - base < P ? total - base : P);
  for (int idx = threadIdx.x; idx < rows * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    if (c >= n_ch || p >= here) dst[idx] = 0.f;
  }
  const float* run = src + base * n_ch;
  for (int idx = threadIdx.x; idx < here * n_ch; idx += THREADS) {
    const int p = idx / n_ch, c = idx - p * n_ch;
    dst[c * P + p] = round_cd<BF16>(run[idx]);
  }
}

template <bool BF16, int INPUT>
__global__ void __launch_bounds__(THREADS)
nerf_mlp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                long long total, Net net, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* pex = smem;              // [PX][P] position encoding
  float* ped = pex + PX * P;      // [PD][P] view encoding
  float* h = ped + PD * P;        // [W][P]  activations
  float* raw = h + W * P;         // [4][P]  r, g, b logits, sigma
  float* pts = raw + 4 * P;       // [6][P]  x, y, z, vx, vy, vz

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * P;

  if constexpr (INPUT == ENCODED) {
    load_rows<BF16>(a, net.in_ch, base, total, pex, PX);
    load_rows<BF16>(b, net.in_ch_views, base, total, ped, PD);
  } else {
    // a = points, b = view directions, both [M,3]
    for (int idx = tid; idx < 6 * P; idx += THREADS) {
      const int which = idx / (3 * P), j = idx % (3 * P);
      const int p = j / 3, c = j % 3;
      const float* src = which ? b : a;
      pts[(3 * which + c) * P + p] = base + p < total ? src[base * 3 + j] : 0.f;
    }
    __syncthreads();
    encode_tile<BF16, INPUT == TRUE_COS>(pts, pex, ped, net);
  }
  __syncthreads();
  mlp_core<BF16>(pex, ped, h, raw, net);

  // ---- raw [M,4]: thread -> (point, channel), one contiguous run --------
  const int p = tid / 4, c = tid % 4;  // THREADS == 4 * P
  if (base + p < total) out[base * 4 + tid] = raw[c * P + p];
}

// bf16 PROJECTION and ENCODED: warpgroup g of a block runs points
// [64g, 64g+64) of each of the block's 128-point tiles (tiles blockIdx.x,
// +gridDim.x, ...).
template <int INPUT>
__global__ void __launch_bounds__(THREADS, 1)
nerf_mlp_wgmma(const float* __restrict__ a, const float* __restrict__ b, int total, Net net,
               wg::Plan plan, float* __restrict__ out) {
  static_assert(INPUT == PROJECTION || INPUT == ENCODED, "TRUE_COS runs the FP32 core");
  extern __shared__ float4 smem4[];
  const int n_tiles = (total + wg::TILE - 1) / wg::TILE;
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  wg::Core core = wg::make_core(smem4, plan);
  core.ring.init(static_cast<long long>(mine) * plan.per_tile);
  const int t = threadIdx.x & 127;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * wg::TILE + core.group * P;
    const int here = total - base < P ? total - base : P;  // <= 0 past the end
    wg::wg_barrier(core.group);  // the previous tile's inputs and raw are read
    if constexpr (INPUT == ENCODED) {
      wg::load_encodings(a + static_cast<long long>(base) * net.in_ch,
                         b + static_cast<long long>(base) * net.in_ch_views, here, core.a, net);
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

// float32: every kind on the FP32 core.
int launch_f32(int kind, long long blocks, size_t smem, cudaStream_t s, const float* a,
               const float* b, long long total, const Net& net, float* out) {
  switch (kind) {
    case PROJECTION:
      return launch(nerf_mlp_kernel<false, PROJECTION>, blocks, smem, s, a, b, total, net, out);
    case TRUE_COS:
      return launch(nerf_mlp_kernel<false, TRUE_COS>, blocks, smem, s, a, b, total, net, out);
    case ENCODED:
      return launch(nerf_mlp_kernel<false, ENCODED>, blocks, smem, s, a, b, total, net, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a, b: points and view directions [M,3] (kind 0: projection encoding,
// kind 1: true cos) or x_pe [M,in_ch] and d_pe [M,in_ch_views] (kind 2).
// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb; packed:
// the bf16 weight chunks of raymarch.py pack_wgmma_weights (bf16 kinds 0
// and 2 only, 16-byte aligned). out: raw [M,4]. Returns a cudaError_t
// value: 0 when the launch was accepted.
int nerf_mlp(const float* a, const float* b, long long total, int kind,
             const void* const* weights, int depth, unsigned skip_mask,
             int in_ch, int in_ch_views, int bf16, const void* packed, float* out,
             void* stream) {
  Net net;
  const int err = make_net(weights, depth, skip_mask, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && (kind == PROJECTION || kind == ENCODED)) {
    if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 ||
        total > 0x7fffffffLL - wg::TILE) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long tiles = (total + wg::TILE - 1) / wg::TILE;
    const size_t smem = wg::CORE_BYTES + wg::SMEM_ALIGN;
    const wg::Plan plan = wg::make_plan(packed, depth, skip_mask);
    return kind == PROJECTION
        ? wg::launch_persistent(nerf_mlp_wgmma<PROJECTION>, tiles, smem, s, a, b,
                                static_cast<int>(total), net, plan, out)
        : wg::launch_persistent(nerf_mlp_wgmma<ENCODED>, tiles, smem, s, a, b,
                                static_cast<int>(total), net, plan, out);
  }
  const long long blocks = (total + P - 1) / P;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  if (!bf16) return launch_f32(kind, blocks, smem, s, a, b, total, net, out);
  if (kind != TRUE_COS) return static_cast<int>(cudaErrorInvalidValue);
  return launch(nerf_mlp_kernel<true, TRUE_COS>, blocks, smem, s, a, b, total, net, out);
}

}  // extern "C"
