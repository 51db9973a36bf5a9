// nerf_mlp_stream.cuh - the streaming NeRF MLP core for Hopper: every net
// that the three other cores have no room for, in float32 and in bf16.
//
// The FP32 core (nerf_mlp.cuh) and the two wgmma cores
// (nerf_mlp_wgmma.cuh) take trunks of W = 256, 512 and 1024 and the
// encodings that fit beside their weight rings and tiles in a block's
// shared memory. The JAX kernels of neuralsim_tpu/kernels/raymarch.py take
// any net whose VMEM blocks (every weight whole, double-buffered) stay
// under the launcher's vmem_limit_bytes of 100 MiB: an 8-deep trunk up to
// W ~ 1,233 in float32 and ~1,748 in bf16, and encodings far past what
// the other cores hold. raymarch.py's core_for sends every such net here
// (and nothing else): a trunk past 1024, or encodings that overflow the
// other core of its dtype (the Python side checks the JAX budget first).
// All five kernel entries run it: nerf_march.cu (`_march_channels_kernel`),
// nerf_mlp.cu's three stages (`_mlp_widepe_kernel`, `_mlp_pe_kernel`,
// `_mlp_kernel`) and render_tile.cu (`_render_tile_kernel`).
//
// Bound on the card: operations, as the other cores (an 8x1152 point costs
// 11.4 M multiply-adds against a few dozen bytes of input and output). What
// bounds this simple core first is the weight stream: nothing of the net
// lives in shared memory, each weight is read from L2 (__ldg) once per
// tile of TILE points and feeds TILE multiply-adds, so at TILE = 16 the
// block needs 4 bytes of L2 per 16 FMAs (at the FP32 rate about 7 TB/s
// over the card, beyond what L2 serves). A later pass can stage the
// weights as the other cores do; this one is right first.
//
// Design:
//   - the net's kernels are read in place: the wrapper's zero-padded
//     weights (trunk padded to a multiple of 64, the views layer to half
//     of it, pad rows and columns zero, which is exact as on the other
//     cores), row-major [in][out] float32, found through a device table
//     of their pointers (Layers); bf16 kernels arrive rounded to bf16 (in
//     float32), so both dtypes read the same layout;
//   - persistent blocks of THREADS threads over tiles of TILE points (32,
//     16, 8 or 4: the largest whose activations fit, pick_tile). The layer
//     input and output live in two feature-major [W][TILE] float32 tiles of
//     shared memory that trade places each layer, beside the encodings x_pe
//     [in_ch][TILE] and d_pe [in_ch_views][TILE]; in bf16 every value they
//     hold is a bf16 value (encodings rounded, each activation rounded after
//     its epilogue), so the float32 storage is exact;
//   - a layer's output columns are split into units of 32 (a warp: lane l
//     takes column 32u + l, so a weight row's loads are 128 coalesced bytes
//     a warp); warp w takes a contiguous run of the layer's units, CT at a
//     time (CT x TILE = 64 accumulators a lane, CT = 64 / TILE) and the
//     rest one at a time, so the runs differ by at most one unit. Per input
//     row a lane loads CT weights and the row's TILE activations (float4
//     broadcasts) and issues CT x TILE fmaf; the row loop runs over the
//     input's tiles in order ([x_pe, h] after a skip, [feature, d_pe] in
//     the views layer), so each output is one float32 sum in row order;
//   - products are fmaf in float32 in both dtypes: in bf16 the operands are
//     bf16 values, whose products are exact in float32, as on the tensor
//     cores; the epilogue adds the bias, applies ReLU (max.NaN, which keeps
//     a NaN) and in bf16 rounds where the JAX package rounds (each post-ReLU
//     activation, the feature after its bias, with fast_epilogue the product
//     and the bias before the add);
//   - the alpha (W -> 1) and rgb (W/2 -> 3) heads: thread t sums the
//     columns t / TILE, + THREADS / TILE, ... for point t % TILE, and the
//     TILE-point sums are reduced over those groups in group order through
//     shared memory (a fixed order, no atomics).

#pragma once

#include "nerf_mlp_wgmma.cuh"

namespace nerf {
namespace stream {

constexpr int UNIT = 32;                // output columns of a warp's unit
constexpr int WARPS = THREADS / 32;
constexpr int ALIGN = 64;               // the trunk is padded to a multiple of this
constexpr int MAX_TILE = 32;
constexpr int MIN_TILE = 4;

// Units a lane runs at once on tiles of TILE points: 64 accumulators.
__host__ __device__ constexpr int units_at_once(int tile) { return 64 / tile; }

// Shared memory of the core for tiles of `tile` points at trunk width
// `width`: the two activation tiles [W][tile], x_pe [in_ch][tile], d_pe
// [in_ch_views][tile], the points [6][tile], raw [4][tile], the heads'
// partial sums [4][THREADS]. Every part starts 16-byte aligned.
__host__ __device__ constexpr long long core_bytes(int tile, int width, int in_ch,
                                                   int in_ch_views) {
  return 4LL * ((2LL * width + in_ch + in_ch_views + 10) * tile + 4 * THREADS);
}

// The tile of a launch: the largest of 32, 16, 8, 4 points whose core and
// `extra` bytes fit the device's shared memory; 0 when none does.
inline int pick_tile(int width, int in_ch, int in_ch_views, long long extra, int* tile) {
  int smem_max = 0;
  const int err = smem_optin(&smem_max);
  if (err != 0) return err;
  *tile = 0;
  for (int t = MAX_TILE; t >= MIN_TILE; t /= 2) {
    if (core_bytes(t, width, in_ch, in_ch_views) + extra <= smem_max) {
      *tile = t;
      break;
    }
  }
  return 0;
}

// A C call's widths: the trunk a positive multiple of ALIGN.
inline bool width_ok(int width) { return width >= ALIGN && width % ALIGN == 0; }

// Calls L::run<TILE>(args...) for a launch's tile; cudaErrorInvalidValue
// for any other.
template <typename L, typename... Args>
int dispatch(int tile, Args... args) {
  switch (tile) {
    case 32: return L::template run<32>(args...);
    case 16: return L::template run<16>(args...);
    case 8: return L::template run<8>(args...);
    case 4: return L::template run<4>(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The net's kernels on this core: a device table of their pointers in
// raymarch.param_keys order (pts_0 .. pts_{depth-1}, feature, alpha,
// views_0, rgb), each [in][out] float32, padded to the launch's width.
struct Layers {
  const unsigned long long* kernels;
  int width;
  int bf16;
};

__device__ __forceinline__ const float* kernel_of(const Layers& layers, int i) {
  return reinterpret_cast<const float*>(__ldg(layers.kernels + i));
}

template <int TILE>
struct Core {
  float* h[2];   // [W][TILE] the layer input and output, trading places
  float* x;      // [in_ch][TILE] position encoding
  float* d;      // [in_ch_views][TILE] view encoding
  float* pts;    // [6][TILE] x, y, z, vx, vy, vz
  float* raw;    // [4][TILE] r, g, b logits, sigma
  float* part;   // [4][THREADS] the heads' partial sums
  Layers layers;
};

// Pointers into the core's shared memory at the start of the kernel's
// dynamic shared buffer (core_bytes(TILE, W, in_ch, in_ch_views) of it).
template <int TILE>
__device__ __forceinline__ Core<TILE> make_core(void* dyn, const Layers& layers, const Net& net) {
  Core<TILE> c;
  float* base = static_cast<float*>(dyn);
  c.h[0] = base;
  c.h[1] = c.h[0] + layers.width * TILE;
  c.x = c.h[1] + layers.width * TILE;
  c.d = c.x + net.in_ch * TILE;
  c.pts = c.d + net.in_ch_views * TILE;
  c.raw = c.pts + 6 * TILE;
  c.part = c.raw + 4 * TILE;
  c.layers = layers;
  return c;
}

// acc[j][p] += sum over the k rows r of a of a[r][p] * w[r][32 j] for the
// lane's CT columns (w at the lane's first column of row 0, rows n floats
// apart); returns w advanced past the k rows.
template <int TILE, int CT>
__device__ __forceinline__ const float* rows_fma(float (&acc)[CT][TILE], const float* a, int k,
                                                 const float* __restrict__ w, int n) {
#pragma unroll 4
  for (int r = 0; r < k; ++r) {
    float wv[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) wv[j] = __ldg(w + UNIT * j);
    float av[TILE];
#pragma unroll
    for (int q = 0; q < TILE / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(a + r * TILE)[q];
      av[4 * q] = t.x;
      av[4 * q + 1] = t.y;
      av[4 * q + 2] = t.z;
      av[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int p = 0; p < TILE; ++p) acc[j][p] = fmaf(av[p], wv[j], acc[j][p]);
    }
    w += n;
  }
  return w;
}

// The epilogue of one output: bias, ReLU where `relu_on`, and in bf16 the
// rounding of the JAX package (fast: the product and the bias rounded
// before the add).
__device__ __forceinline__ float finish(float acc, float b, bool relu_on, bool fast, bool bf16) {
  float v = bf16 && fast ? wg::round_bf16(acc) + wg::round_bf16(b) : acc + b;
  if (relu_on) v = relu(v);
  return bf16 ? wg::round_bf16(v) : v;
}

// CT units of 32 columns from unit u: out[c][p] = finish(sum over [a0 (k0
// rows), a1 (k1 rows)] . w [k0 + k1][n] + bias[c]).
template <int TILE, int CT>
__device__ __forceinline__ void units(const float* a0, int k0, const float* a1, int k1,
                                      const float* __restrict__ w, int n,
                                      const float* __restrict__ bias, float* out, int u,
                                      bool relu_on, bool fast, bool bf16) {
  const int col = u * UNIT + (threadIdx.x & 31);
  float acc[CT][TILE];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
#pragma unroll
    for (int p = 0; p < TILE; ++p) acc[j][p] = 0.f;
  }
  const float* wr = rows_fma<TILE, CT>(acc, a0, k0, w + col, n);
  rows_fma<TILE, CT>(acc, a1, k1, wr, n);
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int c = col + UNIT * j;
    const float b = __ldg(bias + c);
    float4* dst = reinterpret_cast<float4*>(out + c * TILE);
#pragma unroll
    for (int q = 0; q < TILE / 4; ++q) {
      dst[q] = make_float4(finish(acc[j][4 * q], b, relu_on, fast, bf16),
                           finish(acc[j][4 * q + 1], b, relu_on, fast, bf16),
                           finish(acc[j][4 * q + 2], b, relu_on, fast, bf16),
                           finish(acc[j][4 * q + 3], b, relu_on, fast, bf16));
    }
  }
}

// One layer of n output columns (a multiple of 32) into out [n][TILE]: the
// warps take contiguous runs of its units. Inlined, so that the compiler
// keeps the tiles' shared address space (a generic pointer would make
// every activation load a generic one).
template <int TILE>
__device__ __forceinline__ void layer(const float* a0, int k0, const float* a1, int k1,
                                   const float* __restrict__ w, int n,
                                   const float* __restrict__ bias, float* out, bool relu_on,
                                   bool fast, bool bf16) {
  constexpr int CT = units_at_once(TILE);
  const int warp = threadIdx.x >> 5;
  const int n_units = n / UNIT;
  const int u1 = n_units * (warp + 1) / WARPS;
  int u = n_units * warp / WARPS;
  for (; u + CT <= u1; u += CT) {
    units<TILE, CT>(a0, k0, a1, k1, w, n, bias, out, u, relu_on, fast, bf16);
  }
  for (; u < u1; ++u) units<TILE, 1>(a0, k0, a1, k1, w, n, bias, out, u, relu_on, fast, bf16);
}

// Thread t's partial sums of a head over `rows` rows of h [rows][TILE]
// with kernel k [rows][NC]: point t % TILE, rows t / TILE + g THREADS /
// TILE; into part[c][t] for channels c0 .. c0 + NC - 1.
template <int TILE, int NC>
__device__ __forceinline__ void head_part(const float* h, int rows, const float* __restrict__ k,
                                          float* part, int c0) {
  constexpr int GROUPS = THREADS / TILE;
  const int t = threadIdx.x, p = t % TILE;
  float s[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) s[c] = 0.f;
  for (int r = t / TILE; r < rows; r += GROUPS) {
    const float v = h[r * TILE + p];
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] = fmaf(v, __ldg(k + r * NC + c), s[c]);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) part[(c0 + c) * THREADS + t] = s[c];
}

// The MLP on one tile whose encodings are in core.x and core.d (written and
// synchronised): raw [4][TILE] (r, g, b logits, sigma) in core.raw,
// synchronised on return.
template <int TILE>
__device__ __forceinline__ void mlp_tile(Core<TILE>& core, const Net& net) {
  const Layers& L = core.layers;
  const int W = L.width, depth = net.depth;
  const bool bf16 = L.bf16 != 0, fast = net.fast_epilogue != 0;
  // ---- trunk: layer i writes h[i % 2] -------------------------------------
  // (selected, not indexed: a run-time index into h would put the core in
  // local memory)
  for (int i = 0; i < depth; ++i) {
    const float* in = i & 1 ? core.h[0] : core.h[1];
    float* out = i & 1 ? core.h[1] : core.h[0];
    const float* w = kernel_of(L, i);
    if (i == 0) {
      layer<TILE>(core.x, net.in_ch, nullptr, 0, w, W, bias_of(net, 0), out, true, fast, bf16);
    } else if (skips_after(net, i - 1)) {
      layer<TILE>(core.x, net.in_ch, in, W, w, W, bias_of(net, i), out, true, fast, bf16);
    } else {
      layer<TILE>(in, W, nullptr, 0, w, W, bias_of(net, i), out, true, fast, bf16);
    }
    __syncthreads();
  }
  float* trunk = depth & 1 ? core.h[0] : core.h[1];
  float* other = depth & 1 ? core.h[1] : core.h[0];
  // ---- density head, then the feature layer (no ReLU, rounded after its
  // bias), then the views layer [feature, d_pe] -> W/2 into the trunk's tile
  head_part<TILE, 1>(trunk, W, net.alpha_k, core.part, 3);
  layer<TILE>(trunk, W, nullptr, 0, kernel_of(L, depth), W, bias_of(net, depth), other, false,
              false, bf16);
  __syncthreads();
  layer<TILE>(other, W, core.d, net.in_ch_views, kernel_of(L, depth + 2), W / 2,
              bias_of(net, depth + 2), trunk, true, fast, bf16);
  __syncthreads();
  // ---- rgb head, then each head's sum over the groups in group order -----
  head_part<TILE, 3>(trunk, W / 2, net.rgb_k, core.part, 0);
  __syncthreads();
  if (threadIdx.x < 4 * TILE) {
    const int c = threadIdx.x / TILE, p = threadIdx.x % TILE;
    const float* sums = core.part + c * THREADS + p;
    float v = sums[0];
    for (int g = 1; g < THREADS / TILE; ++g) v += sums[g * TILE];
    core.raw[c * TILE + p] =
        v + __ldg(c == 3 ? bias_of(net, depth + 1) : bias_of(net, depth + 3) + c);
  }
  __syncthreads();
}

// x rounded to bf16 where the launch is bf16.
__device__ __forceinline__ float as_compute(float x, bool bf16) {
  return bf16 ? wg::round_bf16(x) : x;
}

// core.pts [6][TILE] (written and synchronised) -> the encodings in core.x
// and core.d, then mlp_tile.
template <int TILE, bool TRUE_COS>
__device__ __forceinline__ void run_tile(Core<TILE>& core, const Net& net) {
  const bool bf16 = core.layers.bf16 != 0;
  for (int idx = threadIdx.x; idx < net.in_ch * TILE; idx += THREADS) {
    core.x[idx] = as_compute(encode<TRUE_COS>(core.pts + idx % TILE, TILE, idx / TILE, net.in_ch),
                             bf16);
  }
  for (int idx = threadIdx.x; idx < net.in_ch_views * TILE; idx += THREADS) {
    core.d[idx] = as_compute(
        encode<TRUE_COS>(core.pts + 3 * TILE + idx % TILE, TILE, idx / TILE, net.in_ch_views),
        bf16);
  }
  __syncthreads();
  mlp_tile<TILE>(core, net);
}

// Rows [base, base + here) of src [*, n_ch] -> dst [n_ch][TILE] (zero for
// points past the end), in the compute dtype; reads coalesced.
template <int TILE>
__device__ __forceinline__ void load_encoded(const float* __restrict__ src, int n_ch,
                                             long long base, int here, float* dst, bool bf16) {
  const float* run = src + base * n_ch;
  for (int idx = threadIdx.x; idx < TILE * n_ch; idx += THREADS) {
    const int p = idx / n_ch, c = idx - p * n_ch;
    dst[c * TILE + p] = p < here ? as_compute(run[idx], bf16) : 0.f;
  }
}

// The smallest tile's shared memory for a net.
inline long long smallest_bytes(int width, int in_ch, int in_ch_views) {
  return core_bytes(MIN_TILE, width, in_ch, in_ch_views);
}

}  // namespace stream
}  // namespace nerf

// The streaming core's shared memory, for the Python wrapper's check and
// chip_smoke.py's log. Defined once in each shared library.
extern "C" {
// shared memory of the core's smallest tile (4 points) for a net; the
// wrapper refuses a net it exceeds on this device
long long nerf_stream_smem_bytes(int width, int in_ch, int in_ch_views) {
  return nerf::stream::smallest_bytes(width, in_ch, in_ch_views);
}
// the tile and shared memory with which the point kernels (nerf_march.cu,
// nerf_mlp.cu) launch the core for a net on the current device; 0 bytes
// when no tile fits
long long nerf_stream_launch_bytes(int width, int in_ch, int in_ch_views, int* tile) {
  if (nerf::stream::pick_tile(width, in_ch, in_ch_views, 0, tile) != 0 || *tile == 0) return 0;
  return nerf::stream::core_bytes(*tile, width, in_ch, in_ch_views);
}
}
