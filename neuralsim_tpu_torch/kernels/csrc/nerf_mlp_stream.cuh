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
// 11.4 M multiply-adds against a few dozen bytes of input and output): the
// bf16 tensor-core rate in bf16, the FP32 rate in float32. What bounds a
// core whose weights do not fit in shared memory first is the weight
// stream: every tile of T points reads the whole net (22.9 MB in bf16 on
// 8x1152) through L2 and feeds each weight to T points, so the L2 serves
// 8 / T bytes a multiply-add in bf16 and 16 / T in float32, and the tile
// is as large as two [W][T] activation tiles allow. The design:
//   - a block is two consumer warpgroups (threads 0-255) and a producer
//     warp (256-287). The host packs the net once per weight set
//     (raymarch.py pack_stream_weights) into pieces of 16 KB in the order
//     the core consumes them: each layer's output columns in blocks of NB =
//     128, and for each column block the layer's input rows in chunks ([x_pe,
//     h] after a skip, [feature, d_pe] in the views layer, each padded with
//     zero rows to whole chunks); pad columns (the views layer's W/2 to a
//     multiple of 128) are zero. One producer thread streams the pieces
//     with cp.async.bulk through a ring of 2-8 stages (as many as shared
//     memory leaves, PieceRing), so that one copy from L2 feeds every warp;
//   - on 32-point tiles blocks run as clusters of 2 on neighbouring SMs,
//     each block its own tile: the producer of rank r copies half r of
//     every piece into the same stage of both blocks (one multicast
//     cp.async.bulk) and a stage is refilled once the consumer warps of both
//     blocks released it, so L2 serves each piece once per two tiles. Both
//     blocks walk the same number of tile slots (a block with fewer tiles
//     runs its last slots masked: zero points, no outputs). Smaller tiles
//     run clusters of 1: there a piece's products are half as long and
//     tying the two blocks' rings together cost more than the halved L2
//     stream saved (8x1664 in bf16 5% slower in clusters of 2, 8x1152 8%
//     faster: chip_variants.py, PERF.md);
//   - the layer input and output live in two activation tiles that trade
//     places each layer (the output's columns are written block by block
//     while later blocks still read the input), beside the encodings x_pe
//     and d_pe;
//   - bf16: the products run on the tensor cores, wgmma.m64nTk16 with the
//     weights as the A operand (a piece is [128 columns][64 inputs] in the
//     128-byte swizzled image of a K-major A tile: warpgroup g multiplies
//     its rows [64 g, 64 g + 64)) and the activations as the B operand
//     ([T points][64] chunks, K-major, swizzled, as the transposed wgmma
//     core keeps them): tiles of T = 32 points where two [W][32] bf16 tiles
//     fit (8x1152), else 16 (8x1664) or 8. The operands are bf16 values, so
//     the products are exact and accumulate in float32, as on the other
//     wgmma cores; the epilogue adds the bias, applies ReLU (max.NaN) and
//     rounds where the JAX package rounds (each post-ReLU activation, the
//     feature after its bias, with fast_epilogue the product and the bias
//     before the add);
//   - float32: FMAs on the FP32 pipes (never TF32: the JAX package asks for
//     Precision.HIGHEST), a piece is [32 inputs][128 columns] row-major and
//     the activations are feature-major [rows][T] float32. The two
//     warpgroups split each piece's rows (warpgroup h its rows [16 h, 16 h
//     + 16)), and a thread holds a register tile of PT = 8 points x C
//     columns (C = 4, 2, 1 on tiles of 32, 16, 8 points; 4 x 1 on 4), so
//     each weight it reads from shared memory feeds 8 points and each
//     activation (a broadcast) C columns. After a column block warpgroup 1
//     leaves its partial sums in shared memory (two buffers, by column
//     block parity) and warpgroup 0 adds them to its own, then the bias and
//     ReLU: each output is (its sum over rows 0-15 of every 32-row chunk, in
//     order) + (its sum over rows 16-31, in order);
//   - the alpha (W -> 1) and rgb (W/2 -> 3) heads: each finishing thread
//     sums its columns of the last trunk layer and of the views layer as
//     they are finished, then the lanes that share its points (a fixed
//     butterfly), then the warps in order through shared memory (no
//     atomics: the same sums every run).
// Weight traffic: 22.9 MB of bf16 pieces per 32-point tile of 8x1152, 172
// GB per 8192 x 64 launch with the clusters' multicast; twice that per
// point in float32 on 16-point tiles.

#pragma once

#include "nerf_mlp_wgmma.cuh"

namespace nerf {
namespace stream {

constexpr int ALIGN = 128;            // the trunk is padded to a multiple of this
constexpr int NB = 128;               // output columns of a piece (a column block)
constexpr int PIECE = 16 * 1024;      // bytes of a piece
constexpr int MAX_CLUSTER = 2;        // blocks of a cluster, on the largest tiles
constexpr int WARPS = THREADS / 32;   // consumer warps of a block
constexpr int BLOCK = THREADS + 32;   // two consumer warpgroups and a producer warp
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 8;
constexpr int MAX_TILE = 32;

// Input rows of a piece: [NB][64] bf16, or [32][NB] float32.
__host__ __device__ constexpr int piece_rows(bool bf16) { return bf16 ? 64 : 32; }
// The smallest tile: wgmma's N = 8 in bf16, 4 points in float32.
__host__ __device__ constexpr int min_tile(bool bf16) { return bf16 ? 8 : 4; }
// Rows of an encoding tile: its channels rounded up to whole pieces.
__host__ __device__ constexpr int tile_rows(int channels, bool bf16) {
  return (channels + piece_rows(bf16) - 1) / piece_rows(bf16) * piece_rows(bf16);
}
// Column blocks of a layer of `cols` outputs.
__host__ __device__ constexpr int col_blocks(int cols) { return (cols + NB - 1) / NB; }

// Pieces of one tile: every layer's column blocks times its input chunks.
__host__ __device__ constexpr long long tile_pieces(int width, int depth, int n_skips, int in_ch,
                                                    int in_ch_views, bool bf16) {
  const long long k = piece_rows(bf16);
  const long long nx = tile_rows(in_ch, bf16) / k, nh = width / k;
  const long long nd = tile_rows(in_ch_views, bf16) / k;
  return col_blocks(width) * (nx + nh * (depth - 1) + nx * n_skips + nh) +
         col_blocks(width / 2) * (nh + nd);
}

// Shared memory of the core from its 1024-aligned base: the ring, the two
// activation tiles [W][tile], x_pe and d_pe [rows][tile] (bf16 or float32),
// in float32 the two buffers of warpgroup 1's partial sums [NB][tile], the
// points [6][tile], raw [4][tile], the heads' partial sums [8][4][tile],
// then the ring's barriers. Every part starts 1024-aligned in bf16 (the
// swizzled chunks) and 16-aligned in float32. Launches ask for SMEM_ALIGN
// more.
__host__ __device__ constexpr long long core_bytes(int tile, int stages, int width, int in_ch,
                                                   int in_ch_views, bool bf16) {
  return static_cast<long long>(stages) * PIECE +
         (2LL * width + tile_rows(in_ch, bf16) + tile_rows(in_ch_views, bf16)) * tile *
             (bf16 ? 2 : 4) +
         (bf16 ? 0 : 2LL * NB * tile * 4) + (10LL + 4 * WARPS) * tile * 4 + 16LL * stages;
}

__host__ __device__ constexpr long long launch_bytes(int tile, int stages, int width, int in_ch,
                                                     int in_ch_views, bool bf16) {
  return core_bytes(tile, stages, width, in_ch, in_ch_views, bf16) + wg::SMEM_ALIGN;
}

// The tile and ring stages of a launch: the largest tile (32, 16, 8, then 4
// in float32) whose core on MIN_STAGES and `extra` bytes fit the device's
// shared memory, then as many more stages as the rest holds, up to
// MAX_STAGES; tile 0 when none fits.
inline int pick(int width, int in_ch, int in_ch_views, bool bf16, long long extra, int* tile,
                int* stages) {
  int smem_max = 0;
  const int err = smem_optin(&smem_max);
  if (err != 0) return err;
  *tile = *stages = 0;
  for (int t = MAX_TILE; t >= min_tile(bf16); t /= 2) {
    const long long need =
        launch_bytes(t, MIN_STAGES, width, in_ch, in_ch_views, bf16) + extra;
    if (need <= smem_max) {
      const long long more = (smem_max - need) / (PIECE + 16);
      *tile = t;
      *stages = MIN_STAGES + static_cast<int>(more < MAX_STAGES - MIN_STAGES
                                                  ? more : MAX_STAGES - MIN_STAGES);
      break;
    }
  }
  return 0;
}

// Blocks of a cluster on tiles of `tile` points: 2 on the largest tiles,
// else 1.
inline int cluster_for(int tile) { return tile == MAX_TILE ? MAX_CLUSTER : 1; }

// A C call's widths: the trunk a positive multiple of ALIGN.
inline bool width_ok(int width) { return width >= ALIGN && width % ALIGN == 0; }

// Calls L::run<TILE, BF16>(args...) for a launch's tile and dtype (the
// instantiations of the core); cudaErrorInvalidValue for any other.
template <typename L, typename... Args>
int dispatch(int tile, int bf16, Args... args) {
  if (bf16) {
    switch (tile) {
      case 32: return L::template run<32, true>(args...);
      case 16: return L::template run<16, true>(args...);
      case 8: return L::template run<8, true>(args...);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (tile) {
    case 32: return L::template run<32, false>(args...);
    case 16: return L::template run<16, false>(args...);
    case 8: return L::template run<8, false>(args...);
    case 4: return L::template run<4, false>(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A launch's packed pieces (raymarch.py pack_stream_weights; 16-byte
// aligned), their count per tile, its ring stages, its blocks per cluster
// (cluster_for) and its trunk width.
struct Layers {
  const unsigned char* packed;
  long long per_tile;
  int stages;
  int cluster;
  int width;
};

// The ring of the pieces: McRing's protocol (nerf_mlp_wgmma.cuh) over
// `stages` stages of PIECE bytes, across a cluster of `cluster` blocks (1
// or 2). The producer thread of the block of rank r copies part r of each
// piece into the same stage of every block of the cluster (with 2 one
// multicast cp.async.bulk), after arming its own full[s] for the whole
// piece; empty[s] completes when the 8 consumer warps of every block are
// done with the stage (lane r of each warp arrives on the block of rank r),
// and only then does a producer refill it.
struct PieceRing {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  const unsigned char* packed;
  long long per_tile;
  int stages;
  int cluster;
  int read_stage;  // the piece acquired next
  uint32_t read_phase;
  int free_stage;  // the oldest piece held

  // Every thread of the block calls it once: the barriers, then a cluster
  // barrier, so that no partner's copy or arrive reaches them earlier.
  __device__ void init() {
    read_stage = free_stage = 0;
    read_phase = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + s)));
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     ::"r"(smem_addr(empty + s)), "r"(WARPS * cluster));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();
  }

  // The producer thread of the block of rank `rank`: `total` pieces, each
  // into the next stage once both blocks freed it.
  __device__ void produce(long long total, uint32_t rank) {
    const int part = PIECE / cluster;
    int s = 0;
    long long q = 0;
    uint32_t phase = 0;
#pragma unroll 1
    for (long long i = 0; i < total; ++i) {
      if (i >= stages) Ring<2>::wait(empty + s, phase ^ 1u);
      const uint32_t bar = smem_addr(full + s);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "n"(PIECE) : "memory");
      const uint32_t dst = smem_addr(buf + s * PIECE) + rank * part;
      const unsigned char* src = packed + q * PIECE + rank * part;
      if (cluster == 1) {
        bulk_copy<1>(dst, src, part, bar);
      } else {
        bulk_copy<MAX_CLUSTER>(dst, src, part, bar);
      }
      q = q + 1 == per_tile ? 0 : q + 1;
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
  }

  // The next piece, once all of it has landed.
  __device__ unsigned char* acquire() {
    Ring<2>::wait(full + read_stage, read_phase);
    const int s = read_stage;
    if (++read_stage == stages) {
      read_stage = 0;
      read_phase ^= 1u;
    }
    return buf + s * PIECE;
  }

  // This warp is done with its oldest piece (its reads of the stage have
  // completed).
  __device__ void release() {
    __syncwarp();
    const uint32_t lane = threadIdx.x & 31;
    if (lane < cluster) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote) : "r"(smem_addr(empty + free_stage)), "r"(lane));
      asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
    }
    __syncwarp();
    if (++free_stage == stages) free_stage = 0;
  }
};

// The core of one kernel instantiation: pointers into its shared memory.
template <int T, bool BF16>
struct Core {
  PieceRing ring;
  unsigned char* h[2];  // the layer input and output, trading places
  unsigned char* x;     // x_pe [rx][T]
  unsigned char* d;     // d_pe [rd][T]
  float* red;           // float32: warpgroup 1's partial sums [2][NB][T]
  float* pts;           // [6][T] x, y, z, vx, vy, vz
  float* raw;           // [4][T] r, g, b logits, sigma
  float* part;          // [8 warps][4][T] the heads' partial sums
  int width;
  int rx;               // rows of x_pe and d_pe
  int rd;
  uint32_t rank;        // this block's rank in its cluster

  // The barrier of the consumer threads.
  __device__ void sync() const { wg::consumer_sync(); }
  // The tile slots of this block, of tiles blockIdx.x, + gridDim.x, ...: as
  // many as the first block of its cluster has tiles below n_tiles (a slot
  // past the last tile runs masked).
  __device__ long long slots(long long n_tiles) const {
    const long long first = static_cast<long long>(blockIdx.x) - rank;
    return n_tiles > first ? (n_tiles - first + gridDim.x - 1) / gridDim.x : 0;
  }
};

// Pointers into the core's shared memory, from the kernel's dynamic shared
// buffer aligned up to SMEM_ALIGN (launch_bytes of it); the ring is set up
// by start().
template <int T, bool BF16>
__device__ __forceinline__ Core<T, BF16> make_core(void* dyn, const Layers& layers,
                                                   const Net& net) {
  constexpr int ESZ = BF16 ? 2 : 4;
  Core<T, BF16> c;
  // offset from the shared array itself, so the compiler still knows every
  // pointer below is shared
  const uint32_t pad =
      (wg::SMEM_ALIGN - (smem_addr(dyn) & (wg::SMEM_ALIGN - 1))) & (wg::SMEM_ALIGN - 1);
  unsigned char* base = static_cast<unsigned char*>(dyn) + pad;
  c.width = layers.width;
  c.rx = tile_rows(net.in_ch, BF16);
  c.rd = tile_rows(net.in_ch_views, BF16);
  c.rank = cluster_rank();
  c.ring.buf = base;
  c.ring.packed = layers.packed;
  c.ring.per_tile = layers.per_tile;
  c.ring.stages = layers.stages;
  c.ring.cluster = layers.cluster;
  c.h[0] = base + layers.stages * PIECE;
  c.h[1] = c.h[0] + layers.width * T * ESZ;
  c.x = c.h[1] + layers.width * T * ESZ;
  c.d = c.x + c.rx * T * ESZ;
  c.red = reinterpret_cast<float*>(c.d + c.rd * T * ESZ);
  c.pts = c.red + (BF16 ? 0 : 2 * NB * T);
  c.raw = c.pts + 6 * T;
  c.part = c.raw + 4 * T;
  c.ring.full = reinterpret_cast<uint64_t*>(c.part + 4 * WARPS * T);
  c.ring.empty = c.ring.full + layers.stages;
  return c;
}

// Sets up the ring for `pieces` pieces; every thread of the block calls it
// first. The producer warp streams the pieces, waits at the cluster barrier
// that ends the kernel and gets true (its kernel returns); the consumers get
// false and call finish() after their last tile slot.
template <int T, bool BF16>
__device__ __forceinline__ bool start(Core<T, BF16>& core, long long pieces) {
  core.ring.init();
  if (threadIdx.x >= THREADS) {
    if (threadIdx.x == THREADS) core.ring.produce(pieces, core.rank);
    __syncwarp();
    cluster_sync();
    return true;
  }
  return false;
}

// The consumers' end of a kernel: the cluster barrier, so that no block
// exits while a partner may still copy or arrive into it.
template <int T, bool BF16>
__device__ __forceinline__ void finish(Core<T, BF16>&) {
  cluster_sync();
}

// The epilogue of one output in bf16: bias, ReLU where `relu_on`, and the
// rounding of the JAX package (fast: the product and the bias rounded
// before the add).
template <bool FAST>
__device__ __forceinline__ float finish_bf16(float acc, float b, bool relu_on) {
  float v = FAST ? wg::round_bf16(acc) + wg::round_bf16(b) : acc + b;
  if (relu_on) v = relu(v);
  return wg::round_bf16(v);
}

// ---- bf16: wgmma, the weights as A and the activations as B -----------------

// acc += A B on one k16 step, m64nTk16 (T = 8, 16 or 32 points).
template <int T>
__device__ __forceinline__ void mma_t(float (&d)[T / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (T == 32) {
    wg::wgmma_n32(d, desc_a, desc_b);
  } else if constexpr (T == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  } else {
    static_assert(T == 8, "wgmma tiles of 8, 16 or 32 points");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
}

// One column block's products: acc (this warpgroup's 64 columns x T
// points) += its rows of the next n0 + n1 pieces times the activations, n0
// chunks ([T][64], T * 128 bytes) at a0 then n1 at a1. Each piece is freed
// once the next one's products are issued, the last once all completed.
template <int T>
__device__ __forceinline__ void block_mma(float (&acc)[T / 2], uint32_t a0, int n0, uint32_t a1,
                                          int n1, PieceRing& ring, int group) {
  constexpr int CH = T * wg::CHUNK_K * 2;
  const int chunks = n0 + n1;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const uint32_t b = c < n0 ? a0 + c * CH : a1 + (c - n0) * CH;
    const uint32_t w = smem_addr(ring.acquire()) + group * wg::A_CHUNK_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_t<T>(acc, wg::desc_sw128(w + 32 * kk), wg::desc_sw128(b + 32 * kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      wg::fence_regs(acc);
      ring.release();
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg::fence_regs(acc);
  ring.release();
}

// A column block's epilogue in bf16, for this warpgroup's 64 columns from
// col0 (a multiple of 64): finish_bf16 in acc, the values into the output
// tile's chunk col0 / 64 (unless out is null), and where head_k is set each
// value times its head weights into s. Slot 4j + 2hi + lo holds column col0
// + 16*warp + lane/4 + 8hi and point 8j + 2*(lane%4) + lo; s[c][2j + lo]
// that point's sum.
template <int T, int NCH, bool FAST>
__device__ __forceinline__ void block_out_bf16(float (&acc)[T / 2], const float* bias, int col0,
                                               bool relu_on, unsigned char* out,
                                               const float* head_k, float (&s)[NCH][T / 4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  unsigned char* chunk = out == nullptr ? nullptr : out + (col0 / 64) * (T * wg::CHUNK_K * 2);
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int col = col0 + r0 + 8 * hi;
    const float b = __ldg(bias + col);
    float w[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) w[c] = head_k == nullptr ? 0.f : __ldg(head_k + NCH * col + c);
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
#pragma unroll
      for (int lo = 0; lo < 2; ++lo) {
        float& v = acc[4 * j + 2 * hi + lo];
        v = finish_bf16<FAST>(v, b, relu_on);
        if (head_k != nullptr) {
#pragma unroll
          for (int c = 0; c < NCH; ++c) s[c][2 * j + lo] = fmaf(v, w[c], s[c][2 * j + lo]);
        }
        if (chunk != nullptr) {
          wg::store_bf16_rows<T>(chunk, 8 * j + 2 * (lane & 3) + lo, r0 + 8 * hi, v);
        }
      }
    }
  }
}

// A head's sums s (bf16 layout: s[c][i] of point 8(i/2) + 2*(lane%4) +
// i%2) over the 8 lanes that share each point, into part [8 warps][4][T] at
// channels ch0 ...
template <int T, int NCH>
__device__ __forceinline__ void head_out_bf16(float (&s)[NCH][T / 4], float* part, int ch0) {
  const int lane = threadIdx.x & 31;
  float* dst = part + (threadIdx.x >> 5) * 4 * T;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < T / 4; ++i) {
      float v = s[c][i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) dst[(ch0 + c) * T + 8 * (i >> 1) + 2 * lane + (i & 1)] = v;
    }
  }
}

// The MLP of one tile in bf16, once its encodings are in core.x and core.d
// (written; published here): raw [4][T] in core.raw, readable by every
// consumer on return. Every column block of every layer consumes its
// pieces in the order of the pack.
template <int T, bool FAST>
__device__ __forceinline__ void mlp_bf16(Core<T, true>& core, const Net& net) {
  constexpr int K = wg::CHUNK_K;
  const int W = core.width, depth = net.depth;
  const int group = threadIdx.x >> 7;
  const int nx = core.rx / K, nd = core.rd / K, nh = W / K;
  const uint32_t x = smem_addr(core.x), d = smem_addr(core.d);
  float acc[T / 2];
  float sa[1][T / 4], srgb[3][T / 4];
#pragma unroll
  for (int i = 0; i < T / 4; ++i) {
    sa[0][i] = 0.f;
    srgb[0][i] = srgb[1][i] = srgb[2][i] = 0.f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  core.sync();
  // ---- trunk layers 0 .. depth-1 (layer i writes h[i % 2]), then the
  // feature layer (i == depth: no ReLU, rounded after its bias) ------------
  bool with_x = true;  // layer 0 reads x_pe
#pragma unroll 1
  for (int i = 0; i <= depth; ++i) {
    // the net's table read before the products (prefetch_skip)
    const float* bias = bias_of(net, i);
    const bool next_x = prefetch_skip(net, i);
    // (selected, not indexed: a run-time index into h would put the core in
    // local memory)
    unsigned char* in = i & 1 ? core.h[0] : core.h[1];
    unsigned char* out = i & 1 ? core.h[1] : core.h[0];
    const bool trunk = i < depth;
#pragma unroll 1
    for (int cb = 0; cb < W / NB; ++cb) {
#pragma unroll
      for (int e = 0; e < T / 2; ++e) acc[e] = 0.f;
      block_mma<T>(acc, x, with_x ? nx : 0, smem_addr(in), i == 0 ? 0 : nh, core.ring, group);
      const int col0 = cb * NB + 64 * group;
      if (trunk) {
        block_out_bf16<T, 1, FAST>(acc, bias, col0, true, out,
                                   i == depth - 1 ? net.alpha_k : nullptr, sa);
      } else {
        block_out_bf16<T, 1, false>(acc, bias, col0, false, out, nullptr, sa);
      }
    }
    // the layer's output is written, and every warp's reads of its input
    // are complete
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    core.sync();
    with_x = next_x;
  }
  // ---- views layer [feature, d_pe] -> W/2, ReLU, and the rgb head -------
  const unsigned char* feature = depth & 1 ? core.h[1] : core.h[0];
  const float* views_bias = bias_of(net, depth + 2);
#pragma unroll 1
  for (int cb = 0; cb < col_blocks(W / 2); ++cb) {
#pragma unroll
    for (int e = 0; e < T / 2; ++e) acc[e] = 0.f;
    block_mma<T>(acc, smem_addr(feature), nh, d, nd, core.ring, group);
    const int col0 = cb * NB + 64 * group;
    if (col0 < W / 2) {  // a warpgroup's columns past W/2 are padding
      block_out_bf16<T, 3, FAST>(acc, views_bias, col0, true, nullptr, net.rgb_k, srgb);
    }
  }
  head_out_bf16<T, 1>(sa, core.part, 3);
  head_out_bf16<T, 3>(srgb, core.part, 0);
  core.sync();
  if (threadIdx.x < 4 * T) {
    const int c = threadIdx.x / T, p = threadIdx.x % T;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += core.part[(4 * w + c) * T + p];
    core.raw[c * T + p] =
        v + __ldg(c == 3 ? bias_of(net, depth + 1) : bias_of(net, depth + 3) + c);
  }
  core.sync();
}

// ---- float32: FMAs, a register tile of PT points x C columns ---------------

// Thread roles on tiles of T points: warpgroup h takes rows [16 h, 16 h +
// 16) of every piece; within it, point group pg = (t % 128) / SLOTS holds
// points [PT pg, PT pg + PT) and slot t % SLOTS the C columns [C slot, C
// slot + C) of the column block (a warp lies in one point group, so its
// activation loads are broadcasts and its weight loads one contiguous run).
template <int T>
struct Lanes {
  static constexpr int PT = T < 8 ? T : 8;
  static constexpr int NPG = T / PT;
  static constexpr int SLOTS = 128 / NPG;
  static constexpr int C = NB / SLOTS;
  static constexpr int HALF = 16;  // rows of a piece per warpgroup
  static_assert(SLOTS % 32 == 0 && PT % 4 == 0 && (C == 1 || C == 2 || C == 4),
                "whole warps per point group, float4 points, 1, 2 or 4 columns");
};

template <int C>
__device__ __forceinline__ void load_cols(float (&w)[C], const float* p) {
  if constexpr (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    w[0] = t.x;
    w[1] = t.y;
    w[2] = t.z;
    w[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  } else {
    w[0] = *p;
  }
}

// One column block's products in float32: acc[p][j] += this warpgroup's
// rows of the next n0 + n1 pieces times the activations ([rows][T] tiles,
// 32 rows a piece: n0 pieces' rows at a0, then n1 at a1), for the thread's
// points and columns.
template <int T>
__device__ __forceinline__ void block_fma(float (&acc)[Lanes<T>::PT][Lanes<T>::C],
                                          const float* a0, int n0, const float* a1, int n1,
                                          PieceRing& ring, int half, int pg, int slot) {
  using L = Lanes<T>;
  constexpr int K = 32;
  const int chunks = n0 + n1;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const float* act =
        (c < n0 ? a0 + c * K * T : a1 + (c - n0) * K * T) + half * L::HALF * T + pg * L::PT;
    const float* w = reinterpret_cast<const float*>(ring.acquire()) + half * L::HALF * NB +
                     slot * L::C;
#pragma unroll 4
    for (int r = 0; r < L::HALF; ++r) {
      float a[L::PT];
      f32::load_points<L::PT>(a, act + r * T);
      float b[L::C];
      load_cols<L::C>(b, w + r * NB);
#pragma unroll
      for (int p = 0; p < L::PT; ++p) {
#pragma unroll
        for (int j = 0; j < L::C; ++j) acc[p][j] = fmaf(a[p], b[j], acc[p][j]);
      }
    }
    ring.release();
  }
}

// A column block's epilogue in float32 over columns [col_base, col_base +
// NB) of a layer of n_cols outputs: warpgroup 1 leaves its sums in red
// ([NB][T]); after the consumers' barrier warpgroup 0 adds them to its own
// (its sum first), then the bias and ReLU where relu_on, writes the values
// into out ([n_cols][T]) unless it is null, and where head_k is set adds
// each value times its head weights into s[c][p].
template <int T, int NCH>
__device__ __forceinline__ void block_out_f32(float (&acc)[Lanes<T>::PT][Lanes<T>::C], float* red,
                                              const float* bias, int col_base, int n_cols,
                                              bool relu_on, float* out, const float* head_k,
                                              float (&s)[NCH][Lanes<T>::PT], int half, int pg,
                                              int slot) {
  using L = Lanes<T>;
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < L::C; ++j) {
      float4* dst = reinterpret_cast<float4*>(red + (slot * L::C + j) * T + pg * L::PT);
#pragma unroll
      for (int q = 0; q < L::PT / 4; ++q) {
        dst[q] = make_float4(acc[4 * q][j], acc[4 * q + 1][j], acc[4 * q + 2][j],
                             acc[4 * q + 3][j]);
      }
    }
  }
  wg::consumer_sync();
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < L::C; ++j) {
      const int col = col_base + slot * L::C + j;
      if (col >= n_cols) continue;  // the views layer's pad columns
      const float b = __ldg(bias + col);
      const float4* other = reinterpret_cast<const float4*>(red + (slot * L::C + j) * T +
                                                            pg * L::PT);
      float v[L::PT];
#pragma unroll
      for (int q = 0; q < L::PT / 4; ++q) {
        const float4 o = other[q];
        v[4 * q] = acc[4 * q][j] + o.x;
        v[4 * q + 1] = acc[4 * q + 1][j] + o.y;
        v[4 * q + 2] = acc[4 * q + 2][j] + o.z;
        v[4 * q + 3] = acc[4 * q + 3][j] + o.w;
      }
#pragma unroll
      for (int p = 0; p < L::PT; ++p) {
        v[p] += b;
        if (relu_on) v[p] = relu(v[p]);
      }
      if (out != nullptr) {
        float4* dst = reinterpret_cast<float4*>(out + col * T + pg * L::PT);
#pragma unroll
        for (int q = 0; q < L::PT / 4; ++q) {
          dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
      }
      if (head_k != nullptr) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float w = __ldg(head_k + NCH * col + c);
#pragma unroll
          for (int p = 0; p < L::PT; ++p) s[c][p] = fmaf(v[p], w, s[c][p]);
        }
      }
    }
  }
}

// A head's sums s (warpgroup 0, float32 layout: s[c][p] of point PT pg + p)
// over the lanes of a warp (a fixed butterfly), into part [8 warps][4][T]
// at channels ch0 ... by lane 0 of each warp of warpgroup 0.
template <int T, int NCH>
__device__ __forceinline__ void head_out_f32(float (&s)[NCH][Lanes<T>::PT], float* part, int ch0,
                                             int pg) {
  using L = Lanes<T>;
  if (threadIdx.x >= 128) return;
  float* dst = part + (threadIdx.x >> 5) * 4 * T;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int p = 0; p < L::PT; ++p) {
      float v = s[c][p];
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if ((threadIdx.x & 31) == 0) dst[(ch0 + c) * T + pg * L::PT + p] = v;
    }
  }
}

// The MLP of one tile in float32, once its encodings are in core.x and
// core.d (written; synchronised here): raw [4][T] in core.raw, readable by
// every consumer on return.
template <int T>
__device__ __forceinline__ void mlp_f32(Core<T, false>& core, const Net& net) {
  using L = Lanes<T>;
  constexpr int K = 32;
  const int W = core.width, depth = net.depth;
  const int t = threadIdx.x, half = t >> 7, r = t & 127;
  const int pg = r / L::SLOTS, slot = r % L::SLOTS;
  const int nx = core.rx / K, nd = core.rd / K, nh = W / K;
  const float* x = reinterpret_cast<const float*>(core.x);
  const float* d = reinterpret_cast<const float*>(core.d);
  float acc[L::PT][L::C];
  float sa[1][L::PT], srgb[3][L::PT];
#pragma unroll
  for (int p = 0; p < L::PT; ++p) {
    sa[0][p] = 0.f;
    srgb[0][p] = srgb[1][p] = srgb[2][p] = 0.f;
  }
  int blk = 0;  // column blocks done: the parity picks the buffer of red
  core.sync();
  bool with_x = true;  // layer 0 reads x_pe
#pragma unroll 1
  for (int i = 0; i <= depth; ++i) {
    const float* bias = bias_of(net, i);
    const bool next_x = prefetch_skip(net, i);
    const float* in = reinterpret_cast<const float*>(i & 1 ? core.h[0] : core.h[1]);
    float* out = reinterpret_cast<float*>(i & 1 ? core.h[1] : core.h[0]);
    const bool trunk = i < depth;
#pragma unroll 1
    for (int cb = 0; cb < W / NB; ++cb, ++blk) {
#pragma unroll
      for (int p = 0; p < L::PT; ++p) {
#pragma unroll
        for (int j = 0; j < L::C; ++j) acc[p][j] = 0.f;
      }
      block_fma<T>(acc, x, with_x ? nx : 0, in, i == 0 ? 0 : nh, core.ring, half, pg, slot);
      block_out_f32<T, 1>(acc, core.red + (blk & 1) * NB * T, bias, cb * NB, W, trunk, out,
                          trunk && i == depth - 1 ? net.alpha_k : nullptr, sa, half, pg, slot);
    }
    core.sync();  // the layer's output is written
    with_x = next_x;
  }
  // ---- views layer [feature, d_pe] -> W/2, ReLU, and the rgb head -------
  const float* feature = reinterpret_cast<const float*>(depth & 1 ? core.h[1] : core.h[0]);
  const float* views_bias = bias_of(net, depth + 2);
#pragma unroll 1
  for (int cb = 0; cb < col_blocks(W / 2); ++cb, ++blk) {
#pragma unroll
    for (int p = 0; p < L::PT; ++p) {
#pragma unroll
      for (int j = 0; j < L::C; ++j) acc[p][j] = 0.f;
    }
    block_fma<T>(acc, feature, nh, d, nd, core.ring, half, pg, slot);
    block_out_f32<T, 3>(acc, core.red + (blk & 1) * NB * T, views_bias, cb * NB, W / 2, true,
                        nullptr, net.rgb_k, srgb, half, pg, slot);
  }
  head_out_f32<T, 1>(sa, core.part, 3, pg);
  head_out_f32<T, 3>(srgb, core.part, 0, pg);
  core.sync();
  if (threadIdx.x < 4 * T) {
    // each head: the sums of warpgroup 0's warps on the point's group, in
    // warp order, then the bias
    const int c = threadIdx.x / T, p = threadIdx.x % T;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (w * 32 / L::SLOTS == p / L::PT) v += core.part[(4 * w + c) * T + p];
    }
    core.raw[c * T + p] =
        v + __ldg(c == 3 ? bias_of(net, depth + 1) : bias_of(net, depth + 3) + c);
  }
  core.sync();
}

// The MLP of one tile, once the consumers have written its encodings
// (encode_tile or load_encodings): raw [4][T] in core.raw, readable by every
// consumer on return.
template <int T, bool BF16, bool FAST>
__device__ __forceinline__ void mlp_tile(Core<T, BF16>& core, const Net& net) {
  if constexpr (BF16) {
    mlp_bf16<T, FAST>(core, net);
  } else {
    mlp_f32<T>(core, net);
  }
}

// core.pts [6][T] (written and synchronised) -> the encodings in core.x
// and core.d (zero past each encoding's channels; bf16 values in bf16; cos
// as sin(y + pi/2), or with TRUE_COS a true cosf), then mlp_tile.
template <int T, bool BF16, bool FAST, bool TRUE_COS>
__device__ __forceinline__ void run_tile(Core<T, BF16>& core, const Net& net) {
  if constexpr (BF16) {
    wg::encode_transposed<TRUE_COS, T>(core.pts, core.x, core.d, net, core.rx / wg::CHUNK_K,
                                       core.rd / wg::CHUNK_K);
  } else {
    float* x = reinterpret_cast<float*>(core.x);
    float* d = reinterpret_cast<float*>(core.d);
    for (int idx = threadIdx.x; idx < core.rx * T; idx += THREADS) {
      x[idx] = encode<TRUE_COS>(core.pts + idx % T, T, idx / T, net.in_ch);
    }
    for (int idx = threadIdx.x; idx < core.rd * T; idx += THREADS) {
      d[idx] = encode<TRUE_COS>(core.pts + 3 * T + idx % T, T, idx / T, net.in_ch_views);
    }
  }
  mlp_tile<T, BF16, FAST>(core, net);
}

// Rows [0, here) of src [*, n_ch] -> a float32 encoding tile [rows][T] (zero
// past the channels and the points); reads coalesced.
template <int T>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int n_ch, int here,
                                          float* dst, int rows) {
  for (int idx = threadIdx.x; idx < rows * T; idx += THREADS) {
    const int c = idx / T, p = idx % T;
    if (c >= n_ch || p >= here) dst[idx] = 0.f;
  }
  for (int idx = threadIdx.x; idx < here * n_ch; idx += THREADS) {
    const int p = idx / n_ch, c = idx - p * n_ch;
    dst[c * T + p] = src[idx];
  }
}

// A tile's x_pe and d_pe from rows [0, here) of x_pe [*, in_ch] and d_pe [*,
// in_ch_views] (here <= 0 for a masked slot), every column of each, into the
// core's tiles (rounded to bf16 in bf16).
template <int T, bool BF16>
__device__ __forceinline__ void load_encodings(Core<T, BF16>& core, const float* x_pe,
                                               const float* d_pe, int here, const Net& net) {
  if constexpr (BF16) {
    wg::load_transposed<T>(x_pe, net.in_ch, core.rx / wg::CHUNK_K, here, core.x);
    wg::load_transposed<T>(d_pe, net.in_ch_views, core.rd / wg::CHUNK_K, here, core.d);
  } else {
    load_rows<T>(x_pe, net.in_ch, here, reinterpret_cast<float*>(core.x), core.rx);
    load_rows<T>(d_pe, net.in_ch_views, here, reinterpret_cast<float*>(core.d), core.rd);
  }
}

// The smallest tile's shared memory for a net (the wrapper refuses a net it
// exceeds on the device).
inline long long smallest_bytes(int width, int in_ch, int in_ch_views, bool bf16) {
  return launch_bytes(min_tile(bf16), MIN_STAGES, width, in_ch, in_ch_views, bf16);
}

}  // namespace stream
}  // namespace nerf

// The streaming core's plan and shared memory, for the Python wrapper's
// checks and chip_smoke.py's log. Defined once in each shared library.
extern "C" {
// bytes of the streaming core's packed pieces (raymarch.py
// pack_stream_weights) for a net of trunk `width` (a multiple of 128)
long long nerf_stream_plan_bytes(int width, int depth, int n_skips, int in_ch, int in_ch_views,
                                 int bf16) {
  return nerf::stream::tile_pieces(width, depth, n_skips, in_ch, in_ch_views, bf16 != 0) *
         nerf::stream::PIECE;
}
// shared memory of the core's smallest tile on MIN_STAGES for a net; the
// wrapper refuses a net it exceeds on this device
long long nerf_stream_smem_bytes(int width, int in_ch, int in_ch_views, int bf16) {
  return nerf::stream::smallest_bytes(width, in_ch, in_ch_views, bf16 != 0);
}
// the tile, ring stages and shared memory with which the point kernels
// (nerf_march.cu, nerf_mlp.cu) launch the core for a net on the current
// device; 0 bytes when no tile fits
long long nerf_stream_launch_bytes(int width, int in_ch, int in_ch_views, int bf16, int* tile,
                                   int* stages) {
  if (nerf::stream::pick(width, in_ch, in_ch_views, bf16 != 0, 0, tile, stages) != 0 ||
      *tile == 0) {
    return 0;
  }
  return nerf::stream::launch_bytes(*tile, *stages, width, in_ch, in_ch_views, bf16 != 0);
}
}
