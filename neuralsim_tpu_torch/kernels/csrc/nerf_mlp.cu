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
// Bound on this card: operations (nerf_mlp.cuh). Per point it reads 24
// bytes (pts, dirs) or 360 bytes (encoded) and writes 16: even the encoded
// stage is ~10x below the operations bound in bytes.
//
// Design: one block of 256 threads per tile of P=64 consecutive points;
// the tile's inputs are read with consecutive threads on consecutive
// addresses (the [M,3] / [M,C] rows of the block are one contiguous run)
// and scattered into the feature-major [channel][point] tiles of the
// shared core; the [64,4] output tile is written back the same way.

#include "nerf_mlp.cuh"

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

template <bool BF16>
int launch_kind(int kind, long long blocks, size_t smem, cudaStream_t s,
                const float* a, const float* b, long long total, const Net& net,
                float* out) {
  switch (kind) {
    case PROJECTION:
      return launch(nerf_mlp_kernel<BF16, PROJECTION>, blocks, smem, s, a, b,
                    total, net, out);
    case TRUE_COS:
      return launch(nerf_mlp_kernel<BF16, TRUE_COS>, blocks, smem, s, a, b,
                    total, net, out);
    case ENCODED:
      return launch(nerf_mlp_kernel<BF16, ENCODED>, blocks, smem, s, a, b,
                    total, net, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a, b: points and view directions [M,3] (kind 0: projection encoding,
// kind 1: true cos) or x_pe [M,in_ch] and d_pe [M,in_ch_views] (kind 2).
// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb.
// out: raw [M,4]. Returns a cudaError_t value: 0 when the launch was
// accepted.
int nerf_mlp(const float* a, const float* b, long long total, int kind,
             const void* const* weights, int depth, unsigned skip_mask,
             int in_ch, int in_ch_views, int bf16, float* out, void* stream) {
  Net net;
  const int err = make_net(weights, depth, skip_mask, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  const long long blocks = (total + P - 1) / P;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_kind<true>(kind, blocks, smem, s, a, b, total, net, out);
  return launch_kind<false>(kind, blocks, smem, s, a, b, total, net, out);
}

}  // extern "C"
