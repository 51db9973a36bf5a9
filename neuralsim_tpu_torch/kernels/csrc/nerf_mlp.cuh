// nerf_mlp.cuh - what the port's Hopper kernels share: the NeRF MLP's shape
// limits, the positional encoding, the weight ring, and the FP32 MLP core.
//
// Every TPU kernel of neuralsim_tpu/kernels/raymarch.py runs the same
// NeRF MLP (by default a 13-layer net: 8x256 trunk with a skip, alpha /
// feature / views / rgb heads) on a tile of points and differs only in what
// goes in and what comes out. This header holds the common part:
//
//   - the shape limits of the two MLP cores (and, once per shared library,
//     the C functions that report them to the Python wrapper): a trunk of
//     W = 256, 512 or 1024 (the wrapper zero-pads a narrower net's weights
//     to the next of the three, which is exact: pad columns hold
//     ReLU(0 + 0) = 0 and meet zero rows), any depth and any skips (the
//     wrapper's device table of bias pointers and skip-mask words, Net),
//     and any encodings that fit in a block's shared memory (the cores'
//     *_smem_bytes, which the wrapper checks: every net up to multires 42 /
//     multires_views 20 fits both cores at every width);
//   - the positional encoding of a point, with cos as sin(y + pi/2) (the
//     JAX projection form) or as a true cosf (TRUE_COS, the form of
//     fused_nerf_mlp_pe);
//   - Plan and Ring: a net's weights, packed on the host into chunks in the
//     order a core consumes them, streamed by thread 0 with cp.async.bulk
//     through an mbarrier ring in shared memory (both cores);
//   - namespace f32: the FP32 core, which every float32 instantiation runs.
//     The bf16 tensor-core core, which every bf16 instantiation runs, is
//     nerf_mlp_wgmma.cuh.
//
// FP32 core. All five TPU kernels run it in float32: _march_channels_kernel
// (nerf_march.cu), _mlp_widepe_kernel, _mlp_kernel and _mlp_pe_kernel
// (nerf_mlp.cu) and _render_tile_kernel (render_tile.cu). Bound on the card:
// operations. One point of the default net costs 593,408 multiply-adds
// (1.19 MFLOP) and moves at most 376 bytes, so a kernel on this core is
// bound by the FP32 rate (67 TFLOP/s on an H100 SXM: 27.86 ms for 8192 rays
// x 192 samples; 425.3 ms for the 8x1024 net). The products are fmaf on the
// FP32 pipes: true float32 like the JAX package's Precision.HIGHEST, never
// TF32.
//
// What bounds such a core below that rate: the shared-memory reads that
// feed the FMAs (a W-wide layer product feeds each FMA a weight and an
// activation), the weight stream from L2 (the whole net per tile), the
// ring's waits, and bank conflicts in the epilogue's column stores. The
// design:
//   - persistent blocks (one per SM) of 256 threads over tiles of TILE
//     points: 128 at W = 256, 64 at W = 512 and 32 at W = 1024, so that a
//     block's layer output stays W x TILE = 32,768 values, 128 accumulators
//     a thread; half that where a net's encodings leave no room (0.85 of the
//     speed per point at W = 256);
//   - the host packs the weights once per weight set (raymarch.py
//     pack_f32_weights) into chunks of 16 input rows, in the order the core
//     consumes them, each row's columns permuted so that column cg + 16 j
//     lies at position 64 (j / 4) + 4 cg + j % 4: a lane's columns are
//     float4 lying beside its neighbours'. The chunks run through a 2-stage
//     ring (Ring below) of KC = 16 rows at W = 256 and 8 rows at 512 (16 KB
//     stages) and at 1024 (32 KB: 4-row stages, at any ring depth, ran 10%
//     slower; 4 rows on the 16-point tiles of long encodings), so the
//     weights are shared-memory reads common to all eight warps, and the
//     next stage lands while this one multiplies. Each
//     128-point tile of the default net reads the 2.38 MB of chunks from
//     L2: 29 GB per launch at 8192 x 192 points, 0.8 TB/s at 38 ms, well
//     inside the L2's rate;
//   - the 16 half-warps of a block split a layer's output (Split below):
//     below W = 1024 each holds a point group of TILE/16 points and all W
//     columns (8 points x 16 columns a lane at W = 256, 4 x 32 at 512); per
//     input row a lane's one or two activation loads (broadcast within the
//     half-warp) and W/64 conflict-free float4 weight loads feed 128 fmaf,
//     so that shared memory serves the FMAs with room to spare (a warp reads
//     a 1 KB weight row for 16 points at W = 256): 66-72% of the FP32 rate
//     at W = 256 and 512 (PERF.md);
//   - at W = 1024 the same lane tile would be 2 points x 64 columns: a warp
//     reads the whole 4 KB weight row for 4 points, so per input row the
//     block's shared-memory reads take as long as its FMAs, and the core ran
//     at 45% of the FP32 rate. There the half-warps split the columns
//     instead: on 32-point tiles 4 column quarters x 4 point groups of 8, on
//     16-point tiles 8 column eighths x 2 point groups. A lane keeps the
//     W = 256 lane tile (8 points x 16 columns of its quarter, 8 x 8 of its
//     eighth), and a warp reads 1 KB of weights per row for 16 points, the
//     W = 256 ratio: 69-72% of the FP32 rate on the 8x1024 net (PERF.md).
//     The packing is unchanged: quarter Q's columns lie in positions
//     [256 Q, 256 Q + 256) of a row in W = 256 order. A 32-point
//     tile reads the 36.2 MB of the 8x1024 net's chunks from L2 (1.78 TB per
//     8192 x 192 launch): a ring that skips the copies ran only 4% faster
//     (chip_variants.py), so the stream is not what bounds it;
//   - activations never leave shared memory: feature-major [row][point]
//     tiles with a row stride of TILE + 4 floats, so the epilogue's stores
//     by 16 lanes to 16 rows fall in distinct banks;
//   - the skip concat [x_pe, h] and the views concat [feature, d_pe] are one
//     run of chunks each, read from two tiles; the alpha and rgb heads are
//     reduced from the registers of the last trunk and the views layer over
//     the 16 lanes that share a point group and, where the columns are
//     split, then over the parts in part order through shared memory (no
//     atomics: a fixed order). Each output column's dot product runs over
//     the input rows in chunk order inside one lane at every width.
// Variants of it are timed by chip_variants.py.
//
// bf16 (the wgmma core) rounds where the JAX package rounds: the encodings,
// the weight matrices (rounded by the caller) and each post-ReLU
// activation; the feature is rounded after its bias. Products of bf16
// values are exact in float32, accumulation and biases are float32.
//
// The encoding uses the accurate sinf / cosf, never the fast intrinsics:
// arguments reach 2^19 * |x| (2^41 * |x| at multires 42), where the
// intrinsics lose all accuracy. For the same reason the build never turns
// on nvcc's fast-math flag (tests/test_torch_imports.py checks both).
// Above multires 20 the top rows are float32 noise in both packages (the
// ulp of 2^20 * |x| is about 0.1 rad); the JAX kernels compute them
// anyway, and so does the port. From k = 128 on, 2^k is +inf in float32 in
// both packages, so those rows are NaN, and ReLU keeps a NaN (as torch.relu
// and jnp.maximum do): such a net's outputs are NaN as the JAX package's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nerf {

constexpr int P = 64;          // points per warpgroup of the wgmma core
constexpr int THREADS = 256;   // 8 warps per block, both cores
constexpr int MAX_W = 1024;    // widest trunk; both cores take W = 256, 512 and 1024
constexpr float HALF_PI = 1.57079632679489661923f;

struct Net {
  // the net's device table (raymarch.py _packed_weights builds it once per
  // weight set): the bias pointers [out] of pts_0 .. pts_{depth-1},
  // feature, alpha, views_0, rgb (padded to the core's width), then the
  // skip mask in 64-bit words (bit i % 64 of word i / 64: layer i's output
  // is concatenated with x_pe); read with __ldg, so a net of any depth
  // passes in a few words
  const unsigned long long* table;
  // the alpha [W][1] and rgb [W/2][3] kernels (row-major). The trunk,
  // feature and views kernels reach the cores only as packed chunks (Plan)
  const float* alpha_k;
  const float* rgb_k;
  int depth;
  int in_ch;
  int in_ch_views;
  int fast_epilogue;
};

// The Net of a C call: weights is a host array of 2 * (depth + 4) device
// pointers, kernel then bias per layer, padded to the trunk width of the
// core that runs it; table the net's device table (8-byte aligned). Returns
// a cudaError_t value.
inline int set_net(const void* const* weights, const void* table, int depth, int in_ch,
                   int in_ch_views, int fast_epilogue, Net* net) {
  if (depth < 1 || in_ch < 1 || in_ch_views < 1 || table == nullptr ||
      reinterpret_cast<uintptr_t>(table) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *net = Net{};
  net->table = static_cast<const unsigned long long*>(table);
  net->alpha_k = static_cast<const float*>(weights[2 * (depth + 1)]);
  net->rgb_k = static_cast<const float*>(weights[2 * (depth + 3)]);
  net->depth = depth;
  net->in_ch = in_ch;
  net->in_ch_views = in_ch_views;
  net->fast_epilogue = fast_epilogue;
  return 0;
}

// set_net for the FP32 and wgmma cores: a trunk of `width` 256, 512 or 1024.
inline int make_net(const void* const* weights, const void* table, int width, int depth,
                    int in_ch, int in_ch_views, int fast_epilogue, Net* net) {
  if (width != 256 && width != 512 && width != MAX_W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return set_net(weights, table, depth, in_ch, in_ch_views, fast_epilogue, net);
}

// The bias of layer i: pts_i for i < depth, then feature, alpha, views_0,
// rgb.
__device__ __forceinline__ const float* bias_of(const Net& net, int i) {
  return reinterpret_cast<const float*>(__ldg(net.table + i));
}

// Whether trunk layer i's output is concatenated with x_pe.
__device__ __forceinline__ bool skips_after(const Net& net, int i) {
  return (__ldg(net.table + net.depth + 4 + (i >> 6)) >> (i & 63)) & 1ull;
}

// Whether trunk layer i + 1 reads [x_pe, h]. The cores read it, and layer
// i's bias pointer, before layer i's products, so that the table's latency
// (an L2 read where L1 lost it) hides behind them.
__device__ __forceinline__ bool prefetch_skip(const Net& net, int i) {
  return i + 1 < net.depth && skips_after(net, i);
}

// max(a, b), NaN when either is NaN (max.NaN; fmaxf would return the
// other operand).
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ReLU that keeps a NaN, as torch.relu and jnp.maximum(x, 0) do.
__device__ __forceinline__ float relu(float v) { return fmax_nan(v, 0.f); }

// The dynamic shared memory a block of the current device may opt into.
inline int smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return static_cast<int>(err);
}

// Sets the dynamic shared memory a kernel needs and launches it on
// `blocks` blocks of THREADS threads. Returns a cudaError_t value: 0 when
// the launch was accepted.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long blocks, size_t smem_bytes,
           cudaStream_t stream, Args... args) {
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem_bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Launches `kernel` on one persistent block per SM (at most `work` blocks).
// Returns a cudaError_t value.
template <typename... Params, typename... Args>
int launch_persistent(void (*kernel)(Params...), long long work, size_t smem_bytes,
                      cudaStream_t stream, Args... args) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = smem_optin(&smem_max);
  if (e != 0) return e;
  if (smem_bytes > static_cast<size_t>(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(kernel, work < sms ? work : sms, smem_bytes, stream, args...);
}

// Encoding channel c of a point (order of ops/encoding.py):
// [x0, x1, x2, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(...)].
// xyz points at the point's first coordinate in a [3][stride] tile; zero
// for c >= n_ch. cos(y) is sin(y + pi/2) like the JAX projection form, or
// cosf(y) with TRUE_COS; y = x * 2^k is exact either way (2^k built from
// its exponent bits, +inf from k = 128 on as 2.0 ** k is in float32).
template <bool TRUE_COS>
__device__ __forceinline__ float encode(const float* xyz, int stride, int c, int n_ch) {
  if (c < 3) return xyz[c * stride];
  if (c >= n_ch) return 0.f;
  const int j = c - 3;
  const int k = j / 6;
  const int r = j - 6 * k;
  const int dim = r % 3;
  const int e = 127 + k < 255 ? 127 + k : 255;
  const float y = __fmul_rn(xyz[dim * stride], __int_as_float(e << 23));
  if constexpr (TRUE_COS) {
    return r < 3 ? sinf(y) : cosf(y);
  } else {
    return sinf(__fadd_rn(y, r < 3 ? 0.f : HALF_PI));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// This block's rank within its cluster (0 outside a cluster launch).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// A barrier of every thread of every block of the cluster, with release /
// acquire order across it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// One cp.async.bulk of `bytes` from global src into shared dst, completing
// on the mbarrier bar; with CLUSTER > 1 multicast to the same offsets of
// every block of the cluster.
template <int CLUSTER>
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  if constexpr (CLUSTER == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar),
          "h"(static_cast<uint16_t>((1u << CLUSTER) - 1u)) : "memory");
  }
}

// A net's packed weights and their chunk order per tile: chunks [0,
// n_wide) of a tile (trunk and feature layers, W columns) take wide_bytes
// each, the rest (the views layer, W/2 columns) narrow_bytes. With ways = 2
// the counts are each warpgroup's share (Ring<STAGES, true>): it takes
// `run` consecutive pieces of every 2 * run wide ones and `narrow_run` of
// every 2 * narrow_run narrow ones (runs of 1, 2 or 4).
struct Plan {
  const unsigned char* packed;
  int per_tile;
  int n_wide;
  int wide_bytes;
  int narrow_bytes;
  int ways = 1;
  int run = 1;
  int narrow_run = 1;

  // bytes of one tile's chunks, all ways
  long long tile_bytes() const {
    return ways * (static_cast<long long>(n_wide) * wide_bytes +
                   static_cast<long long>(per_tile - n_wide) * narrow_bytes);
  }
};

// The weight ring: the block's chunks go round STAGES stages (of
// plan.wide_bytes each) in order; full[s] completes when a chunk's bytes
// landed, empty[s] when all 8 warps are done with it. Thread 0 issues every
// copy. Every thread tracks the stage and phase of the chunk it acquires
// next and of the oldest chunk it still holds; thread 0 also the next
// chunk to issue. No 64-bit division: its subroutine call would spill.
// HALVES: each warpgroup has a ring of its own (its 4 warps release a
// stage, its first thread issues) that streams its share of the chunks
// (Plan::ways = 2), so the two consume the same layer side by side.
template <int STAGES, bool HALVES = false>
struct Ring {
  static constexpr int WARPS = HALVES ? 4 : THREADS / 32;
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  Plan plan;
  long long left;     // thread 0: chunks still to issue
  int next_q;         // thread 0: index within its tile of the next chunk to issue
  int read_stage;     // the chunk acquired next
  uint32_t read_phase;
  int free_stage;     // the oldest chunk held
  uint32_t free_phase;

  // The thread that issues this ring's copies.
  __device__ static bool leader() {
    return HALVES ? (threadIdx.x & 127) == 0 : threadIdx.x == 0;
  }

  // Every thread calls it once, with its ring's number of chunks.
  __device__ void init(long long total) {
    read_stage = free_stage = 0;
    read_phase = free_phase = 0;
    left = total;
    next_q = 0;
    if (leader()) {
      for (int s = 0; s < STAGES; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + s)));
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     ::"r"(smem_addr(empty + s)), "r"(WARPS));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (leader()) {
      for (int s = 0; s < STAGES && left > 0; ++s) issue(s);
    }
  }

  // The leader: the next chunk of the sequence into stage s.
  __device__ void issue(int s) {
    const int q = next_q;
    const bool wide = q < plan.n_wide;
    const int bytes = wide ? plan.wide_bytes : plan.narrow_bytes;
    size_t off;
    if constexpr (HALVES) {
      // this warpgroup's piece q of its section: pieces come in runs of
      // `run` (1, 2 or 4: shifts of run / 2) out of every 2 * run
      const int g = threadIdx.x >> 7;
      const int run = wide ? plan.run : plan.narrow_run, sh = run >> 1;
      const int k = wide ? q : q - plan.n_wide;
      const size_t piece =
          static_cast<size_t>(((k >> sh) << (sh + 1)) + (g << sh) + (k & (run - 1)));
      off = wide ? piece * plan.wide_bytes
                 : static_cast<size_t>(2 * plan.n_wide) * plan.wide_bytes +
                       piece * plan.narrow_bytes;
    } else {
      off = wide ? static_cast<size_t>(q) * plan.wide_bytes
                 : static_cast<size_t>(plan.n_wide) * plan.wide_bytes +
                       static_cast<size_t>(q - plan.n_wide) * plan.narrow_bytes;
    }
    const uint32_t bar = smem_addr(full + s);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes) : "memory");
    bulk_copy<1>(smem_addr(buf + s * plan.wide_bytes), plan.packed + off, bytes, bar);
    next_q = q + 1 == plan.per_tile ? 0 : q + 1;
    --left;
  }

  __device__ static void wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
  }

  // The stage of the next chunk, once it has landed.
  __device__ int next_stage() {
    wait(full + read_stage, read_phase);
    const int s = read_stage;
    if (++read_stage == STAGES) {
      read_stage = 0;
      read_phase ^= 1u;
    }
    return s;
  }

  // The next chunk's shared address (for wgmma descriptors) ...
  __device__ uint32_t acquire() { return smem_addr(buf + next_stage() * plan.wide_bytes); }

  // ... or its floats.
  __device__ const float* acquire_floats() {
    return reinterpret_cast<const float*>(buf + next_stage() * plan.wide_bytes);
  }

  // This warp is done with its oldest chunk (its reads of the stage have
  // completed); the leader then refills the stage with the chunk STAGES
  // further on, once every warp of the ring is done with it.
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   ::"r"(smem_addr(empty + free_stage)) : "memory");
    }
    if (leader() && left > 0) {
      wait(empty + free_stage, free_phase);
      issue(free_stage);
    }
    __syncwarp();
    if (++free_stage == STAGES) {
      free_stage = 0;
      free_phase ^= 1u;
    }
  }
};

namespace f32 {

constexpr int STAGES = 2;      // weight ring depth
constexpr int PACK_ROWS = 16;  // input rows of a packed chunk

// Points per tile at trunk width W, and the smaller tile where a net's
// encodings leave no room for it: 128 / 64 at W = 256, 64 / 32 at 512,
// 32 / 16 at 1024.
__host__ __device__ constexpr int big_tile(int width) { return 128 * 256 / width; }

// Bytes of a ring stage for tiles of `tile` points at trunk width W: KC
// rows of W columns (the same rows of the views layer's W/2 columns take
// half a stage). 32 KB on the 32-point tiles of W = 1024, where 16 KB
// stages (4 rows) ran 10% slower at any ring depth (chip_variants.py,
// PERF.md: a stage's barriers every 512 FMAs a lane); 16 KB elsewhere,
// which leaves the 16-point tiles of long encodings their room.
__host__ __device__ constexpr int stage_bytes(int tile, int width) {
  return width == MAX_W && tile == big_tile(width) ? 32 * 1024 : 16 * 1024;
}

// Input rows per ring stage: 16 at W = 256, 8 at 512 and at 1024 on 32-point
// tiles, 4 at 1024 on 16-point tiles.
__host__ __device__ constexpr int kc(int tile, int width) {
  return stage_bytes(tile, width) / (4 * width);
}

// Column parts of a layer's output at trunk width W (Split): 4 on 32-point
// tiles and 8 on 16-point tiles at W = 1024, else 1.
__host__ __device__ constexpr int col_parts(int tile, int width) {
  return width == MAX_W ? 128 / tile : 1;
}

// Rows of an encoding tile: the channels rounded up to whole packed chunks.
inline int rows(int channels) { return (channels + PACK_ROWS - 1) / PACK_ROWS * PACK_ROWS; }

// The chunk order per tile of `tile` points, in ring stages of kc(tile,
// width) rows: layer 0 (x_pe), each trunk layer i >= 1 (x_pe first after a
// skip, then the h chunks), the feature layer, then the views layer (the
// feature's h chunks, then the d_pe chunks, W/2 columns). A packed chunk of
// 16 rows is two or four stages: its rows lie contiguous.
inline Plan make_plan(const void* packed, int tile, int width, int depth, int n_skips,
                      int in_ch, int in_ch_views) {
  const int k = kc(tile, width), bytes = stage_bytes(tile, width);
  const int nx = rows(in_ch) / k, nd = rows(in_ch_views) / k, h = width / k;
  const int n_wide = nx + h * (depth - 1) + nx * n_skips + h;
  return Plan{static_cast<const unsigned char*>(packed), n_wide + h + nd, n_wide, bytes,
              bytes / 2};
}

// Shared memory of the core for tiles of `tile` points at trunk width
// `width`, rx rows of x_pe and rd of d_pe: the ring, the activation tiles h
// [W], x [rx], d [rd] (row stride tile + 4), the points [6][tile], the raw
// outputs [4][tile], where the columns are split the heads' partial sums
// [4][parts][tile], then the ring's barriers. Every part starts 16-byte
// aligned.
__host__ __device__ constexpr int core_bytes(int tile, int width, int rx, int rd) {
  return STAGES * stage_bytes(tile, width) + (width + rx + rd) * (tile + 4) * 4 +
         10 * tile * 4 +
         (col_parts(tile, width) > 1 ? 16 * col_parts(tile, width) * tile : 0) +
         2 * STAGES * 8;
}

// The tile of a launch: the width's big tile where the core and `extra`
// bytes fit the device's shared memory, else half of it; 0 when neither
// fits.
inline int pick_tile(int width, int rx, int rd, long long extra, int* tile) {
  int smem_max = 0;
  const int err = smem_optin(&smem_max);
  if (err != 0) return err;
  const int big = big_tile(width);
  *tile = core_bytes(big, width, rx, rd) + extra <= smem_max ? big
        : core_bytes(big / 2, width, rx, rd) + extra <= smem_max ? big / 2 : 0;
  return 0;
}

// Calls L::run<TILE, W>(args...) for a launch's tile and trunk width (the
// instantiations of the core); cudaErrorInvalidValue for any other.
template <typename L, typename... Args>
int dispatch(int width, int tile, Args... args) {
  if (width == 256 && tile == 128) return L::template run<128, 256>(args...);
  if (width == 256 && tile == 64) return L::template run<64, 256>(args...);
  if (width == 512 && tile == 64) return L::template run<64, 512>(args...);
  if (width == 512 && tile == 32) return L::template run<32, 512>(args...);
  if (width == 1024 && tile == 32) return L::template run<32, 1024>(args...);
  if (width == 1024 && tile == 16) return L::template run<16, 1024>(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Thread roles on tiles of TILE points at trunk width W. The 16 half-warps
// of a block split a layer's output into PARTS column parts x NPG point
// groups: half-warp hw takes part hw / NPG (the two half-warps of a warp
// share it, so their weight loads broadcast) and point group hw % NPG.
// Lane cg of a half-warp holds PT points x C columns {col0 + cg + 16 j} of
// its part, whose SPAN columns start at col0 = part * SPAN; the views
// layer's W/2 columns split the same way (C/2 a lane from col0 / 2). Below
// W = 1024 one part: 8 points x 16 columns at W = 256 (128-point tiles),
// 4 x 32 at 512. At W = 1024 quarters on 32-point tiles and eighths on
// 16-point tiles, 8 points x 16 and 8 x 8 columns a lane.
template <int TILE, int W>
struct Split {
  static constexpr int PARTS = col_parts(TILE, W);
  static constexpr int NPG = 16 / PARTS;
  static constexpr int PT = TILE / NPG;
  static constexpr int SPAN = W / PARTS;
  static constexpr int C = SPAN / 16;
  static_assert(PT * NPG == TILE && (PT == 1 || PT == 2 || PT % 4 == 0) && C % 8 == 0,
                "a lane holds 1, 2 or 4k points and whole float4 of trunk and views columns");
  __device__ static int part() { return PARTS == 1 ? 0 : (threadIdx.x >> 4) / NPG; }
  __device__ static int group() { return (threadIdx.x >> 4) % NPG; }
};

template <int TILE, int W>
struct Core {
  Ring<STAGES> ring;
  float* h;      // [W][TILE + 4] activations
  float* x;      // [rx][TILE + 4] position encoding
  float* d;      // [rd][TILE + 4] view encoding
  float* pts;    // [6][TILE] x, y, z, vx, vy, vz
  float* raw;    // [4][TILE] r, g, b logits, sigma
  float* heads;  // [4][PARTS][TILE] the heads' sums over each column part
  int rx;
  int rd;

  // Where part `part` of head channel c (r, g, b, sigma) goes: raw itself
  // when the columns are not split.
  __device__ float* head(int c, int part) {
    constexpr int PARTS = Split<TILE, W>::PARTS;
    return PARTS == 1 ? raw + c * TILE : heads + (c * PARTS + part) * TILE;
  }
};

// Pointers into the core's shared memory at the start of the kernel's
// dynamic shared buffer (core_bytes(TILE, W, rx, rd) of it); the ring is set
// up by Ring::init, called by every thread.
template <int TILE, int W>
__device__ __forceinline__ Core<TILE, W> make_core(void* dyn, const Plan& plan, int rx, int rd) {
  constexpr int HS = TILE + 4;
  constexpr int PARTS = Split<TILE, W>::PARTS;
  Core<TILE, W> c;
  unsigned char* base = static_cast<unsigned char*>(dyn);
  c.ring.buf = base;
  c.h = reinterpret_cast<float*>(base + STAGES * stage_bytes(TILE, W));
  c.x = c.h + W * HS;
  c.d = c.x + rx * HS;
  c.pts = c.d + rd * HS;
  c.raw = c.pts + 6 * TILE;
  c.heads = c.raw + 4 * TILE;
  c.ring.full = reinterpret_cast<uint64_t*>(c.heads + (PARTS > 1 ? 4 * PARTS * TILE : 0));
  c.ring.empty = c.ring.full + STAGES;
  c.ring.plan = plan;
  c.rx = rx;
  c.rd = rd;
  return c;
}

// Lane cg of a half-warp: its columns {col0 + cg + 16j} (Split).
__device__ __forceinline__ int col_group() { return threadIdx.x & 15; }

// The PT floats at p (16-byte aligned for PT >= 4, 8-byte for 2) into v.
template <int PT>
__device__ __forceinline__ void load_points(float (&v)[PT], const float* p) {
  if constexpr (PT == 1) {
    v[0] = *p;
  } else if constexpr (PT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PT / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
    static_assert(PT == 2, "a point group holds 1, 2, 4 or 8 points");
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

// acc[p][4q + e] += sum over the chunk's KC rows k of act[k][p] *
// w[k][64q + e]: act points at the thread's first point in row 0 of a
// [KC][HS] activation block, w at the thread's first float4 in row 0 of a
// ring stage whose rows are ROW floats (NQ float4 of each row per thread,
// 64 floats apart).
template <int PT, int NQ, int HS, int KC, int ROW>
__device__ __forceinline__ void chunk_fma(float (&acc)[PT][4 * NQ], const float* act,
                                          const float* w) {
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    float a[PT];
    load_points<PT>(a, act + k * HS);
    float b[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(w + k * ROW + 64 * q);
      b[4 * q] = t.x;
      b[4 * q + 1] = t.y;
      b[4 * q + 2] = t.z;
      b[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int p = 0; p < PT; ++p) {
#pragma unroll
      for (int j = 0; j < 4 * NQ; ++j) acc[p][j] = fmaf(a[p], b[j], acc[p][j]);
    }
  }
}

// The products of one layer: acc += [a0 (n0 stages of rows), a1 (n1)] . W
// over the next n0 + n1 stages of the ring, for the thread's points from p0
// and its columns' packed positions from wpos.
template <int PT, int NQ, int HS, int KC, int ROW>
__device__ __forceinline__ void layer(float (&acc)[PT][4 * NQ], const float* a0, int n0,
                                      const float* a1, int n1, Ring<STAGES>& ring, int p0,
                                      int wpos) {
#pragma unroll 1
  for (int c = 0; c < n0 + n1; ++c) {
    const float* act = c < n0 ? a0 + c * (KC * HS) : a1 + (c - n0) * (KC * HS);
    chunk_fma<PT, NQ, HS, KC, ROW>(acc, act + p0, ring.acquire_floats() + wpos);
    ring.release();
  }
}

template <int PT, int N>
__device__ __forceinline__ void zero(float (&acc)[PT][N]) {
#pragma unroll
  for (int p = 0; p < PT; ++p) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[p][j] = 0.f;
  }
}

// Sum over the 16 lanes of a half-warp (one point group).
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v + __shfl_xor_sync(0xffffffffu, v, 8);
}

// The MLP on one tile whose encodings are in core.x and core.d (written and
// synchronised): raw [4][TILE] (r, g, b logits, sigma) in core.raw,
// synchronised on return. Consumes the tile's plan.per_tile chunks.
template <int TILE, int W>
__device__ __forceinline__ void mlp_tile(Core<TILE, W>& core, const Net& net) {
  using S = Split<TILE, W>;
  constexpr int PT = S::PT;  // points of a thread
  constexpr int C = S::C;    // trunk columns of a thread
  constexpr int HS = TILE + 4;
  constexpr int KC = kc(TILE, W);
  const int cg = col_group();
  const int part = S::part();
  const int p0 = S::group() * PT;
  const int col0 = part * S::SPAN;  // the part's first trunk column, and its packed position
  const int depth = net.depth;
  const int nx = core.rx / KC, nd = core.rd / KC;
  float acc[PT][C];

  // ---- trunk layers 0 .. depth-1, then the feature layer (i == depth) -----
  bool with_x = true;  // layer 0 reads x_pe
#pragma unroll 1
  for (int i = 0; i <= depth; ++i) {
    // the net's table read before the products (prefetch_skip)
    const float* bias = bias_of(net, i);
    const bool next_x = prefetch_skip(net, i);
    zero(acc);
    layer<PT, C / 4, HS, KC, W>(acc, core.x, with_x ? nx : 0, core.h, i == 0 ? 0 : W / KC,
                                core.ring, p0, col0 + 4 * cg);
    __syncthreads();  // every warp has read h
    const bool relu_on = i < depth;  // the feature layer has none
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = col0 + cg + 16 * j;
      const float b = __ldg(bias + col);
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        float v = acc[p][j] + b;
        if (relu_on) v = relu(v);
        acc[p][j] = v;
      }
      float* dst = core.h + col * HS + p0;
      if constexpr (PT % 4 == 0) {
#pragma unroll
        for (int v = 0; v < PT / 4; ++v) {
          reinterpret_cast<float4*>(dst)[v] = make_float4(acc[4 * v][j], acc[4 * v + 1][j],
                                                          acc[4 * v + 2][j], acc[4 * v + 3][j]);
        }
      } else if constexpr (PT == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[0][j], acc[1][j]);
      } else {
        *dst = acc[0][j];
      }
    }
    if (i == depth - 1) {
      // density head (alpha [W][1]) on the trunk output in the registers:
      // the part's sum, or with one part the head itself
      const float* ak = net.alpha_k;
      float s[PT];
#pragma unroll
      for (int p = 0; p < PT; ++p) s[p] = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float w = __ldg(ak + col0 + cg + 16 * j);
#pragma unroll
        for (int p = 0; p < PT; ++p) s[p] = fmaf(acc[p][j], w, s[p]);
      }
      const float b = S::PARTS == 1 ? __ldg(bias_of(net, depth + 1)) : 0.f;
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        const float t = group_sum(s[p]);
        if (cg == 0) core.head(3, part)[p0 + p] = t + b;
      }
    }
    __syncthreads();
    with_x = next_x;
  }

  // ---- views layer: [feature, d_pe] -> W/2, ReLU; then the rgb head ------
  const float* vb = bias_of(net, depth + 2);
  const float* rb = bias_of(net, depth + 3);
  float accv[PT][C / 2];
  zero(accv);
  layer<PT, C / 8, HS, KC, W / 2>(accv, core.h, W / KC, core.d, nd, core.ring, p0,
                                  col0 / 2 + 4 * cg);
  const float* rk = net.rgb_k;
  float s[3][PT];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int p = 0; p < PT; ++p) s[c][p] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < C / 2; ++j) {
    const int col = col0 / 2 + cg + 16 * j;
    const float b = __ldg(vb + col);
    const float w[3] = {__ldg(rk + 3 * col), __ldg(rk + 3 * col + 1), __ldg(rk + 3 * col + 2)};
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const float v = relu(accv[p][j] + b);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c][p] = fmaf(v, w[c], s[c][p]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float b = S::PARTS == 1 ? __ldg(rb + c) : 0.f;
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const float t = group_sum(s[c][p]);
      if (cg == 0) core.head(c, part)[p0 + p] = t + b;
    }
  }
  if constexpr (S::PARTS > 1) {
    // each head: its parts' sums in part order, then the bias
    __syncthreads();
    for (int idx = threadIdx.x; idx < 4 * TILE; idx += THREADS) {
      const int c = idx / TILE, p = idx % TILE;
      float v = core.head(c, 0)[p];
#pragma unroll
      for (int q = 1; q < S::PARTS; ++q) v += core.head(c, q)[p];
      core.raw[c * TILE + p] = v + __ldg(c == 3 ? bias_of(net, depth + 1) : rb + c);
    }
  }
  __syncthreads();
}

// core.pts [6][TILE] (written and synchronised) -> the encodings in core.x
// and core.d (zero past each encoding's channels), then mlp_tile.
template <int TILE, int W, bool TRUE_COS>
__device__ __forceinline__ void run_tile(Core<TILE, W>& core, const Net& net) {
  constexpr int HS = TILE + 4;
  for (int idx = threadIdx.x; idx < core.rx * TILE; idx += THREADS) {
    const int c = idx / TILE, p = idx % TILE;
    core.x[c * HS + p] = encode<TRUE_COS>(core.pts + p, TILE, c, net.in_ch);
  }
  for (int idx = threadIdx.x; idx < core.rd * TILE; idx += THREADS) {
    const int c = idx / TILE, p = idx % TILE;
    core.d[c * HS + p] = encode<TRUE_COS>(core.pts + 3 * TILE + p, TILE, c, net.in_ch_views);
  }
  __syncthreads();
  mlp_tile<TILE, W>(core, net);
}

// Shared memory of the core's smallest tile for a net.
inline int smallest_bytes(int width, int in_ch, int in_ch_views) {
  return core_bytes(big_tile(width) / 2, width, rows(in_ch), rows(in_ch_views));
}

}  // namespace f32
}  // namespace nerf

// The shape limits of the cores, the bytes of a net's packed weights and
// of the shared memory a core needs for it; the Python wrapper checks them
// before every launch and raises on anything else. Defined once in each
// shared library (each includes this header from one source).
extern "C" {
int nerf_width() { return nerf::MAX_W; }
// the dynamic shared memory a block of the current device may opt into
int nerf_smem_optin() {
  int bytes = 0;
  return nerf::smem_optin(&bytes) == 0 ? bytes : 0;
}
// bytes of the FP32 core's packed weights (raymarch.py pack_f32_weights)
long long nerf_f32_plan_bytes(int width, int depth, int n_skips, int in_ch, int in_ch_views) {
  return nerf::f32::make_plan(nullptr, nerf::f32::big_tile(width), width, depth, n_skips, in_ch,
                              in_ch_views)
      .tile_bytes();
}
// shared memory of the FP32 core's smallest tile for a net
int nerf_f32_smem_bytes(int width, int in_ch, int in_ch_views) {
  return nerf::f32::smallest_bytes(width, in_ch, in_ch_views);
}
// the shared memory and tile with which the point kernels (nerf_march.cu,
// nerf_mlp.cu) launch the FP32 core for a net on the current device; 0 bytes
// when no tile fits
int nerf_f32_launch_bytes(int width, int in_ch, int in_ch_views, int* tile) {
  const int rx = nerf::f32::rows(in_ch), rd = nerf::f32::rows(in_ch_views);
  if (nerf::f32::pick_tile(width, rx, rd, 0, tile) != 0 || *tile == 0) return 0;
  return nerf::f32::core_bytes(*tile, width, rx, rd);
}
}
