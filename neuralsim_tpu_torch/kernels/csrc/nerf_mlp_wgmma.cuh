// nerf_mlp_wgmma.cuh - the NeRF MLP core on Hopper's tensor cores (wgmma),
// bf16 only.
//
// Every bf16 instantiation of the port's kernels runs its MLP here:
// nerf_march.cu (replacing the Pallas TPU kernel `_march_channels_kernel` of
// neuralsim_tpu/kernels/raymarch.py), render_tile.cu (`_render_tile_kernel`)
// and nerf_mlp.cu's three stages (`_mlp_widepe_kernel`, `_mlp_pe_kernel`,
// `_mlp_kernel`); every float32 instantiation runs the FP32 core of
// nerf_mlp.cuh. Same function as that core in bf16 (nerf_mlp.cuh states the
// rounding and the net shapes taken: a narrower net comes zero-padded to a
// trunk of W = 256, 512 or 1024). Two cores: the standard one below (W = 256
// and 512) and the transposed one (W = 1024, and W = 256 / 512 where the
// standard core has no room for the encodings), described before its code.
//
// Bound on the card: operations on the tensor cores. One point of the
// default 8x256 net costs 593,408 bf16 multiply-adds; at the published 989
// TFLOP/s a launch on 8192 rays x 192 samples takes at least 1.887 ms.
//
// Design of the standard core:
//   - a block is two consumer warpgroups (threads 0-255) and a producer
//     warpgroup (256-383): 384 threads. The producer gives up registers
//     (setmaxnreg.dec to PRODUCER_REGS) and one of its threads issues every
//     weight copy; the consumers raise theirs (setmaxnreg.inc to
//     CONSUMER_REGS; 2 x 128 x 240 + 128 x 24 = 64,512 of the SM's 65,536).
//     Each consumer warpgroup issues wgmma.mma_async m64n256k16 (trunk,
//     feature) and m64n128k16 (views) over 64 points, with f32 accumulators
//     in registers (128 per thread); every trunk, feature and views product
//     runs on the tensor cores;
//   - W = 256: warpgroup g owns points [64g, 64g+64) of the block's
//     128-point tile and all columns, in A tiles of its own, so one
//     warpgroup barrier, not a block barrier, stands between layers. (A
//     skew of warpgroup 1 one chunk behind warpgroup 0, so that one
//     warpgroup's epilogue runs under the other's products, made kernel 1
//     11% slower: with both warpgroups holding two chunks a chunk apart, the
//     three ring stages leave none loading; PERF.md);
//   - W = 512: the two warpgroups split the columns of one 64-point tile
//     (g owns trunk columns [256g, 256g+256) and views columns [128g,
//     128g+128)) over one shared A tile; a barrier of the 256 consumer
//     threads between a layer's products and its epilogue lets both finish
//     reading A before either writes, and the alpha and rgb heads add the
//     two halves' partial sums (no skew: both need all of h);
//   - activations never touch device memory: a layer's epilogue (bias in
//     f32, ReLU, round to bf16) writes its rows and columns into the A tile
//     in the layout wgmma reads ([64][64] K-chunks, 128-byte swizzle), 64
//     scalar 32-bit stores a thread per layer (stmatrix.m8n8.x4, 16 a
//     thread, ran 4% slower at W = 256 and no faster at 512: PERF.md).
//     (Kept in registers as the next layer's A fragments, the 64 packed
//     registers beside the 128 accumulators spilled.);
//   - the encodings x_pe (up to 256 channels, in NX = 1-4 chunks of 64; 63
//     -> 64 by default; longer ones run on the transposed core) and d_pe
//     (up to 128 channels, in nd = 1 or 2 chunks,
//     of which the views layer multiplies the last chunk's k16 steps that
//     hold channels: 27 -> 32 by default) are written once per tile into A
//     tiles of their own, zero past the channels, with cos as sin(y + pi/2)
//     (the JAX projection form) or, with TRUE_COS, a true cosf (the form of
//     `_mlp_pe_kernel`); the skip layer [x_pe, h] and the views layer
//     [feature, d_pe] are two partial sums into the same accumulators;
//   - the alpha (W -> 1) and rgb (W/2 -> 3) heads run on the CUDA cores from
//     the accumulator registers, reduced over the four lanes of a row.
//
// Shared memory, in bytes from a 1024-aligned base (core_bytes): the ring
// (STAGES x one chunk of [W][64] bf16: 32 KB at W = 256, 64 KB at 512),
// the A tiles (W = 256: one set per warpgroup; 512: one shared set) of NX
// x_pe, W/64 h and nd d_pe chunks of 8 KB, then the ring's barriers. A
// tile's [6][64] points live in its h tiles and its raw outputs in its first
// x_pe tile: both are dead there when the other is live. Default nets:
//   W = 256, NX = nd = 1: 3 x 32 KB + 2 x 6 x 8 KB + 48 = 196,656 B (+ 1024
//     to align), leaving 34,768 B of the 232,448 a block may have, where
//     the render tile keeps its rays' raw field;
//   W = 512, NX = nd = 1: 2 x 64 KB + 10 x 8 KB + 32 = 213,024 B (+ 1024).
// Three stages where they fit (W = 256 and NX <= 2), else two; W = 512
// takes NX + nd <= 4 chunks of encodings, W = 256 up to NX = 4 and nd = 2
// (on two stages: 229,408 B + 1024); the transposed core takes the rest.
// The cluster and the producer add no shared memory: the cluster shares the
// ring's barriers.
//
// Weight traffic (standard core). The host packs the weights once (raymarch.py
// pack_wgmma_weights) into bf16 chunks of 64 input rows, each in the exact
// shared-memory image the B descriptor reads ([N][64], 128-byte swizzle):
// 34 chunks of 32 KB (N = 256) and 5 of 16 KB (views, N = 128), 1.196 MB
// for the default 8x256 net. Blocks are persistent and launched as clusters
// of cluster_size(W) blocks on neighbouring SMs (cudaLaunchKernelEx; the
// grid is cudaOccupancyMaxActiveClusters clusters, or fewer where there are
// fewer tiles), and the ring (McRing) runs on from one tile into the next.
// W = 512 takes clusters of 2: every chunk goes to both blocks, the producer
// of rank r copies part r of it (half its bytes, one cp.async.bulk ...
// .multicast::cluster) into the same stage of each block, so each block's
// full barrier expects the whole chunk, and a stage is refilled only once
// the consumer warps of both blocks have released it (each warp arrives on
// its own block's empty barrier and, through mapa, on its partner's). The
// blocks of a cluster therefore walk the same number of tile slots: a block
// with fewer tiles runs its last slots masked (zero points, no outputs),
// and a cluster barrier follows the barriers' init and precedes exit, so no
// block leaves while a partner may still copy or arrive into it. Each tile
// still multiplies every chunk, but L2 serves each chunk once per cluster:
// at S = 192 the 8x512 net reads 114 GB per launch without a cluster, 57 GB
// with one of 2. W = 256 takes clusters of 1 (the same code, no partner):
// there the stream cost 7-9% of a launch and halving it bought nothing
// measurable (PERF.md); 12,288 tiles of the default net at S = 192 read
// 14.7 GB.

#pragma once

#include <type_traits>

#include "nerf_mlp.cuh"

namespace nerf {
namespace wg {

constexpr int CHUNK_K = 64;                       // input rows per chunk
constexpr int N = 256;                            // trunk columns of one product
constexpr int NV = N / 2;                         // views columns of one product
constexpr int A_CHUNK_BYTES = P * CHUNK_K * 2;    // 8 KB: [64 rows][64] bf16
constexpr int SMEM_ALIGN = 1024;                  // the swizzle's repeat
static_assert(4 * P == THREADS, "W = 512 sums the heads' halves one value a thread");

// The standard core's clusters (blocks that share each weight chunk by
// multicast: 2 at W = 512, 1 at W = 256), its block (the THREADS consumer
// threads and a producer warpgroup) and the registers of each role
// (setmaxnreg).
constexpr int cluster_size(int width) { return width == 2 * N ? 2 : 1; }
constexpr int STD_THREADS = THREADS + 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536,
              "the roles' registers must fit the SM's register file");

// What the trunk width sets: W = 256 runs two 64-point tiles per block, one
// per warpgroup; W = 512 one, its columns split between the warpgroups.
template <int W>
struct Shape {
  static_assert(W == N || W == 2 * N, "the core takes trunks of 256 or 512");
  static constexpr bool SPLIT = W == 2 * N;
  static constexpr int TILE = SPLIT ? P : 2 * P;   // points per block tile
  static constexpr int GROUPS = SPLIT ? 1 : 2;     // sets of A tiles
  static constexpr int H = W / CHUNK_K;            // h chunks
};

__host__ __device__ constexpr int chunk_bytes(int width) { return width * CHUNK_K * 2; }
// Ring stages: three where they fit, else two.
__host__ __device__ constexpr int stages(int width, int nx) {
  return width == N && nx <= 2 ? 3 : 2;
}

// A chunks of a net's encodings: x_pe 1-4, d_pe 1-2.
__host__ __device__ inline int x_chunks(int in_ch) { return (in_ch + CHUNK_K - 1) / CHUNK_K; }
__host__ __device__ inline int d_chunks(int in_ch_views) {
  return (in_ch_views + CHUNK_K - 1) / CHUNK_K;
}

// Shared memory of the core, in bytes from a 1024-aligned base: the ring,
// the A tiles (nx x_pe chunks, h, nd d_pe chunks: every layer's input
// chunks lie contiguous, in the order the ring delivers the weights; one
// set per warpgroup at W = 256, one shared set at 512), then the ring's
// barriers. Launches ask for SMEM_ALIGN more.
__host__ __device__ constexpr int a_bytes(int width, int nx, int nd) {
  return (nx + width / CHUNK_K + nd) * A_CHUNK_BYTES;
}
__host__ __device__ constexpr int core_bytes(int width, int nx, int nd) {
  return stages(width, nx) * chunk_bytes(width) + (width == N ? 2 : 1) * a_bytes(width, nx, nd) +
         2 * stages(width, nx) * 8;
}

// The packed weights of one net and its chunk order per tile: layer 0
// (x_pe), each trunk layer i >= 1 (x_pe first after a skip, then the h
// chunks), feature (h), then views (the feature's h chunks and the d_pe
// chunks, N = W/2).
inline Plan make_plan_standard(const void* packed, int width, int depth,
                               int n_skips, int in_ch, int in_ch_views) {
  const int nx = x_chunks(in_ch), h = width / CHUNK_K;
  const int n_wide = nx + h * (depth - 1) + nx * n_skips + h;
  return Plan{static_cast<const unsigned char*>(packed), n_wide + h + d_chunks(in_ch_views),
              n_wide, chunk_bytes(width), chunk_bytes(width / 2)};
}

// wgmma descriptor of a K-major bf16 operand with 128-byte swizzle: rows of
// 64 values (128 bytes), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of (row, col) in a K-major tile of [ROWS][64] chunks with
// 128-byte swizzle: the 16-byte unit col/8 of a row sits at unit
// (col/8) ^ (row % 8). The standard core's A tiles have 64 rows.
template <int ROWS>
__device__ __forceinline__ int tile_offset(int row, int col) {
  return (col >> 6) * (ROWS * 128) + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

__device__ __forceinline__ int a_offset(int row, int col) { return tile_offset<P>(row, col); }

template <int ROWS>
__device__ __forceinline__ void store_bf16x2_rows(unsigned char* tile, int row, int col,
                                                  float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset<ROWS>(row, col)) =
      __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ void store_bf16x2(unsigned char* tile, int row, int col, float lo,
                                             float hi) {
  store_bf16x2_rows<P>(tile, row, col, lo, hi);
}

// A barrier of the 128 threads of warpgroup `group` (named barrier 1 or 2).
__device__ __forceinline__ void wg_barrier(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

// A barrier of the block's THREADS consumer threads (named barrier 3): the
// whole block of the transposed core, all but the producer warpgroup of the
// standard core's.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(THREADS) : "memory");
}

// The warpgroup of this thread, uniform across its warp (setmaxnreg must
// run in warpgroup-uniform code).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
}

// The standard core's weight ring across a cluster of CLUSTER blocks (the
// FP32 and transposed cores keep Ring). The chunks go round STAGES stages
// (of plan.wide_bytes each) in order in every block of the cluster. One
// producer thread per block streams them: the block of rank r copies part r
// (1/CLUSTER of a chunk's bytes) into the same stage of every block with one
// multicast cp.async.bulk, after arming its own full[s] for the whole
// chunk; empty[s] completes when the 8 consumer warps of every block of the
// cluster are done with the stage, and only then does any producer refill
// it. Consumers track the stage and phase of the chunk they acquire next and
// the stage of the oldest chunk they hold.
template <int STAGES, int CLUSTER>
struct McRing {
  static constexpr int WARPS = THREADS / 32;
  static_assert(CLUSTER == 1 || CLUSTER == 2, "clusters of 1 or 2 blocks");
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  Plan plan;
  int read_stage;     // the chunk acquired next
  uint32_t read_phase;
  int free_stage;     // the oldest chunk held

  // Every thread of the block calls it once: the barriers, then a cluster
  // barrier, so that no partner's copy or arrive reaches them earlier.
  __device__ void init() {
    read_stage = free_stage = 0;
    read_phase = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + s)));
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     ::"r"(smem_addr(empty + s)), "n"(WARPS * CLUSTER));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();
  }

  // The producer thread of the block of rank `rank`: `total` chunks of the
  // plan's sequence, each into the next stage once every block freed it.
  __device__ void produce(long long total, uint32_t rank) {
    int s = 0, q = 0;
    uint32_t phase = 0;
#pragma unroll 1
    for (long long i = 0; i < total; ++i) {
      if (i >= STAGES) Ring<STAGES>::wait(empty + s, phase ^ 1u);
      const bool wide = q < plan.n_wide;
      const int bytes = wide ? plan.wide_bytes : plan.narrow_bytes;
      const size_t off = wide ? static_cast<size_t>(q) * plan.wide_bytes
                              : static_cast<size_t>(plan.n_wide) * plan.wide_bytes +
                                    static_cast<size_t>(q - plan.n_wide) * plan.narrow_bytes;
      const int part = bytes / CLUSTER;
      const uint32_t bar = smem_addr(full + s);
      const uint32_t dst = smem_addr(buf + s * plan.wide_bytes) + rank * part;
      const unsigned char* src = plan.packed + off + rank * part;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(bytes) : "memory");
      bulk_copy<CLUSTER>(dst, src, part, bar);
      q = q + 1 == plan.per_tile ? 0 : q + 1;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1u;
      }
    }
  }

  // The next chunk's shared address, once all of it has landed.
  __device__ uint32_t acquire() {
    Ring<STAGES>::wait(full + read_stage, read_phase);
    const int s = read_stage;
    if (++read_stage == STAGES) {
      read_stage = 0;
      read_phase ^= 1u;
    }
    return smem_addr(buf + s * plan.wide_bytes);
  }

  // This warp is done with its oldest chunk (its reads of the stage have
  // completed): lane r arrives on the empty barrier of the cluster's block
  // of rank r.
  __device__ void release() {
    __syncwarp();
    const uint32_t lane = threadIdx.x & 31;
    if (lane < CLUSTER) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote) : "r"(smem_addr(empty + free_stage)), "r"(lane));
      asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
    }
    __syncwarp();
    if (++free_stage == STAGES) free_stage = 0;
  }
};

// acc += A B on one k16 step, m64n256k16: A [64 x 16] and B [16 x 256] bf16 in
// shared memory behind their descriptors (K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// acc += A B on one k16 step, m64n128k16: A [64 x 16] and B [16 x 128] bf16 in
// shared memory behind their descriptors (K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int NC>
__device__ __forceinline__ void wgmma_k16(float (&d)[NC / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (NC == 256) {
    wgmma_n256(d, desc_a, desc_b);
  } else {
    wgmma_n128(d, desc_a, desc_b);
  }
}

// Pins the accumulators at this point of the program: an empty asm that
// reads and writes each one, so the compiler moves no use of them across
// the wgmma wait that completes them.
template <int NR>
__device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The products of one layer: acc += A . W over `chunks` consecutive
// chunks of the ring, A chunk c at shared address a + c * A_CHUNK_BYTES
// (K-major [64][64], 128-byte swizzle), each chunk's B operand at byte
// b_rows of the chunk (this warpgroup's columns), LAST_KSTEPS k16 steps of
// the last chunk (4 for the others). Each chunk's products queue behind the
// previous chunk's; the previous chunk is freed once they are issued, the
// last once all completed.
template <int NC, int LAST_KSTEPS, typename R>
__device__ __forceinline__ void layer_mma(float (&acc)[NC / 2], uint32_t a, uint32_t b_rows,
                                          int chunks, R& ring) {
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const uint32_t b = ring.acquire() + b_rows;
    const uint32_t ac = a + c * A_CHUNK_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const int ksteps = c + 1 == chunks ? LAST_KSTEPS : 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < ksteps) wgmma_k16<NC>(acc, desc_sw128(ac + 32 * kk), desc_sw128(b + 32 * kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(acc);
      ring.release();
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);
  ring.release();
}

// x rounded to the nearest bf16.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats of a net's weights or biases, through the read-only path: a
// bias pointer comes from the net's table in global memory, and a plain
// load through it could alias the epilogue's shared-memory stores.
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC / 2]) {
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
}

// Bias, optional ReLU and the bf16 rounding of a layer, left in acc and,
// unless h is null, written into columns [col0, col0 + NC) of the h tiles.
// Accumulator slot 4j + e holds row 16*warp + lane/4 + 8*(e/2) and column
// 8j + 2*(lane%4) + e%2 of the product (bias points at its column 0).
// With FAST the product and the bias are rounded to bf16 before the add (a
// template flag: as a runtime one the compiler computes both forms of all
// 128 values under a predicate).
template <int NC, bool RELU, bool FAST>
__device__ __forceinline__ void epilogue(float (&acc)[NC / 2], const float* bias,
                                         unsigned char* h, int col0) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 b = load2(bias + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bb = (e & 1) ? b.y : b.x;
      float x = acc[4 * j + e];
      x = FAST ? round_bf16(x) + round_bf16(bb) : x + bb;
      if (RELU) x = relu(x);
      acc[4 * j + e] = round_bf16(x);
    }
    if (h != nullptr) {
      store_bf16x2(h, row, col0 + col, acc[4 * j], acc[4 * j + 1]);
      store_bf16x2(h, row + 8, col0 + col, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// Sum over the four lanes that share a row.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The barrier between the threads that share a set of A tiles: the
// warpgroup at W = 256, the two consumer warpgroups at W = 512.
template <int W>
__device__ __forceinline__ void tile_sync(int group) {
  if constexpr (Shape<W>::SPLIT) {
    consumer_sync();
  } else {
    wg_barrier(group);
  }
}

// Those threads' generic-proxy writes of their A tiles become visible to
// their wgmma (async proxy) reads.
template <int W>
__device__ __forceinline__ void tile_publish(int group) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  tile_sync<W>(group);
}

// A tile's encodings, bf16, into its NX x_pe A chunks and nd d_pe chunks
// (every column, zero past each encoding's channels); pts is its [6][P]
// point tile. In a step, thread lane of warp w writes row 16w + lane/4 (+8
// in odd steps), channel pair 2*(lane%4) + 8*(step/2) of a chunk; with
// SPLIT the two warpgroups take every other step.
template <int NX, bool TRUE_COS, bool SPLIT>
__device__ __forceinline__ void encode_tiles(const float* pts, unsigned char* xt,
                                             unsigned char* dt, const Net& net, int nd,
                                             int group) {
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  constexpr int n_x = 2 * (CHUNK_K / 8) * NX;  // steps over the x_pe chunks
  const int steps = n_x + 2 * (CHUNK_K / 8) * nd;
#pragma unroll 1
  for (int i = SPLIT ? group : 0; i < steps; i += SPLIT ? 2 : 1) {
    const bool view = i >= n_x;
    const int k = view ? i - n_x : i;
    const int row = row0 + 8 * (k & 1);
    const int col = 8 * (k >> 1) + 2 * (lane & 3);
    const float* xyz = pts + (view ? 3 * P : 0) + row;
    const int n_ch = view ? net.in_ch_views : net.in_ch;
    store_bf16x2(view ? dt : xt, row, col, encode<TRUE_COS>(xyz, P, col, n_ch),
                 encode<TRUE_COS>(xyz, P, col + 1, n_ch));
  }
}

// Columns [0, COLS) of a tile of A chunks from channels [col0, col0 + COLS)
// of the rows of a pre-encoded input, rounded to bf16: row p < here of the
// tile is src[p * n_ch + col0 ...]. Every column the products read is
// written, zero where the channel is >= n_ch or the row >= here: pad
// columns must hold zeros, not whatever the tile held (a NaN there times a
// zero weight is NaN). Lane pair c of a row reads channels 2c, 2c+1, so a
// row is read by consecutive threads on consecutive addresses (rows are
// 4-byte aligned only: no vector loads).
template <int COLS>
__device__ __forceinline__ void load_encoding(const float* __restrict__ src, int n_ch, int col0,
                                              int here, unsigned char* tile) {
  static_assert(128 % (COLS / 2) == 0, "a row's channel pairs must divide the warpgroup");
  constexpr int PAIRS = COLS / 2;
  const int t = threadIdx.x & 127;
  const int col = 2 * (t % PAIRS);
  const int ch = col0 + col;
#pragma unroll 4
  for (int row = t / PAIRS; row < P; row += 128 / PAIRS) {
    float lo = 0.f, hi = 0.f;
    if (row < here) {
      const float* r = src + row * n_ch;
      if (ch < n_ch) lo = __ldg(r + ch);
      if (ch + 1 < n_ch) hi = __ldg(r + ch + 1);
    }
    store_bf16x2(tile, row, col, lo, hi);
  }
}

// A tile's x_pe and d_pe A chunks (a: NX x_pe chunks, the h chunks, nd d_pe
// chunks) from rows [0, here) of x_pe [*, in_ch] and d_pe [*, in_ch_views]:
// every column of each. With SPLIT warpgroup 0 loads x_pe and 1 d_pe.
template <int W, int NX>
__device__ __forceinline__ void load_encodings(const float* x_pe, const float* d_pe, int here,
                                               unsigned char* a, const Net& net, int nd,
                                               int group) {
  constexpr bool SPLIT = Shape<W>::SPLIT;
  if (!SPLIT || group == 0) {
    if constexpr (NX == 3) {
      load_encoding<2 * CHUNK_K>(x_pe, net.in_ch, 0, here, a);
      load_encoding<CHUNK_K>(x_pe, net.in_ch, 2 * CHUNK_K, here, a + 2 * A_CHUNK_BYTES);
    } else {
      load_encoding<NX * CHUNK_K>(x_pe, net.in_ch, 0, here, a);
    }
  }
  if (!SPLIT || group == 1) {
    unsigned char* d = a + (NX + Shape<W>::H) * A_CHUNK_BYTES;
    if (nd == 1) {
      load_encoding<CHUNK_K>(d_pe, net.in_ch_views, 0, here, d);
    } else {
      load_encoding<2 * CHUNK_K>(d_pe, net.in_ch_views, 0, here, d);
    }
  }
}

// The MLP on a tile of 64 points, whose encodings are in the A tiles at a
// (NX x_pe chunks, the h chunks, ND d_pe chunks; published): raw [4][P]
// (r, g, b logits, sigma) of this warpgroup's columns, written by the lanes
// that hold each row (at W = 512 partial sums, the bias in warpgroup 0's).
// Consumes the tile's plan.per_tile chunks from the ring. FAST
// (net.fast_epilogue), NX, ND and the views layer's last k16 steps are
// template flags: as runtime values they cost the registers the 128
// accumulators need: the kernel spills and runs slower.
template <int W, int NX, int ND, bool FAST, typename R>
__device__ __forceinline__ void mlp_core_wgmma(unsigned char* a, float* raw, const Net& net,
                                               R& ring, int group) {
  using S = Shape<W>;
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const uint32_t x = smem_addr(a);            // x_pe, then h, then d_pe
  const uint32_t h = x + NX * A_CHUNK_BYTES;
  unsigned char* h_tile = a + NX * A_CHUNK_BYTES;
  // this warpgroup's first trunk and views columns, and their rows of each
  // packed chunk ([W][64] and [W/2][64], 128 bytes a row)
  const int col0 = S::SPLIT ? N * group : 0;
  const int vcol0 = S::SPLIT ? NV * group : 0;
  const uint32_t b_rows = S::SPLIT ? static_cast<uint32_t>(N * 128 * group) : 0u;
  const uint32_t bv_rows = S::SPLIT ? static_cast<uint32_t>(NV * 128 * group) : 0u;
  const bool head_bias = !S::SPLIT || group == 0;
  float acc[N / 2];

  // ---- trunk -------------------------------------------------------------
  bool with_x = false;  // layer i (> 0) reads [x_pe, h]
  for (int i = 0; i < net.depth; ++i) {
    // the net's table read before the products (prefetch_skip)
    const float* bias = bias_of(net, i) + col0;
    const bool next_x = prefetch_skip(net, i);
    zero<N>(acc);
    if (i == 0) {
      layer_mma<N, 4>(acc, x, b_rows, NX, ring);
    } else if (with_x) {
      layer_mma<N, 4>(acc, x, b_rows, NX + S::H, ring);  // [x_pe, h]
    } else {
      layer_mma<N, 4>(acc, h, b_rows, S::H, ring);
    }
    tile_sync<W>(group);  // every warp's products that read h are complete
    epilogue<N, true, FAST>(acc, bias, h_tile, col0);
    tile_publish<W>(group);
    with_x = next_x;
  }

  // ---- density head (alpha [W][1]) on the trunk output, CUDA cores -------
  {
    const float* ak = net.alpha_k + col0;
    float top = 0.f, bot = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 w = load2(ak + 8 * j + 2 * (lane & 3));
      top = fmaf(acc[4 * j], w.x, fmaf(acc[4 * j + 1], w.y, top));
      bot = fmaf(acc[4 * j + 2], w.x, fmaf(acc[4 * j + 3], w.y, bot));
    }
    top = row_sum(top);
    bot = row_sum(bot);
    if ((lane & 3) == 0) {
      const float b = head_bias ? __ldg(bias_of(net, net.depth + 1)) : 0.f;
      raw[3 * P + row] = top + b;
      raw[3 * P + row + 8] = bot + b;
    }
  }

  // ---- feature layer (no ReLU, rounded after its bias) -------------------
  const float* feature_bias = bias_of(net, net.depth) + col0;
  const float* views_bias = bias_of(net, net.depth + 2) + vcol0;
  zero<N>(acc);
  layer_mma<N, 4>(acc, h, b_rows, S::H, ring);
  tile_sync<W>(group);
  epilogue<N, false, false>(acc, feature_bias, h_tile, col0);
  tile_publish<W>(group);

  // ---- views layer: [feature, d_pe] -> W/2, ReLU -------------------------
  float accv[NV / 2];
  zero<NV>(accv);
  // [feature, d_pe], over the last d_pe chunk's k16 steps that hold channels
  switch ((net.in_ch_views - CHUNK_K * (ND - 1) + 15) / 16) {
    case 1: layer_mma<NV, 1>(accv, h, bv_rows, S::H + ND, ring); break;
    case 2: layer_mma<NV, 2>(accv, h, bv_rows, S::H + ND, ring); break;
    case 3: layer_mma<NV, 3>(accv, h, bv_rows, S::H + ND, ring); break;
    default: layer_mma<NV, 4>(accv, h, bv_rows, S::H + ND, ring); break;
  }
  // the rgb head reads the registers: nothing to store
  epilogue<NV, true, FAST>(accv, views_bias, nullptr, 0);

  // ---- rgb head (rgb [W/2][3]), CUDA cores -------------------------------
  const float* rk = net.rgb_k + 3 * vcol0;
  float top[3] = {0.f, 0.f, 0.f}, bot[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    const int k0 = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float w0 = rk[3 * k0 + c], w1 = rk[3 * (k0 + 1) + c];
      top[c] = fmaf(accv[4 * j], w0, fmaf(accv[4 * j + 1], w1, top[c]));
      bot[c] = fmaf(accv[4 * j + 2], w0, fmaf(accv[4 * j + 3], w1, bot[c]));
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t = row_sum(top[c]), b = row_sum(bot[c]);
    if ((lane & 3) == 0) {
      const float bias = head_bias ? __ldg(bias_of(net, net.depth + 3) + c) : 0.f;
      raw[c * P + row] = t + bias;
      raw[c * P + row + 8] = b + bias;
    }
  }
}

// ---- the transposed core: W = 1024, and long encodings at W = 256 and 512 --
//
// At W = 1024 a 64-point layer output is 64 x 1024 f32 = 256 KB, the whole
// register file of an SM, and its bf16 A tile is 128 KB of the 227 KB of
// shared memory; computing the columns in passes would stage half a layer
// (64 KB more) and leave no room for a weight ring, and splitting the
// columns over a 2-block cluster needs distributed shared memory and
// cluster barriers in every layer. This core turns the products around
// instead: out^T = W^T h^T, the weights are the A operand (M = 64 output
// columns per m64 block, read straight from the packed chunks: a chunk's
// rows are the output columns, 128 bytes each, the layout of a K-major A
// tile) and the activations the B operand, N = TP = 32 points. So a layer
// output of 32 points x 1024 columns is 128 accumulators in each of the 256
// threads, and the h tile is [32][1024] bf16 = 64 KB:
//   - a block runs one 32-point tile; warpgroup g owns trunk columns
//     [W/2 g, W/2 (g+1)) (MB m64 blocks, wgmma.m64n32k16) and views columns
//     [W/4 g, W/4 (g+1)) (MV blocks);
//   - each warpgroup streams its share of every chunk through a ring of its
//     own (Ring<t_stages(W), true> of nerf_mlp.cuh; its first thread
//     issues): pieces of at most 128 rows (16 KB) of a trunk chunk (RUN = 4
//     of them per chunk at W = 1024) and of a views chunk (RUNV = 2), four
//     stages a warpgroup at W = 512 and 1024 (two at 256), so three pieces
//     load while one multiplies. Rings of two 32 KB stages in the same
//     shared memory keep one piece in flight: with them the five kernels
//     on 8x1024 take 1.03-1.06 of this time (chip_compare.py, PERF.md).
//     Blocks in clusters of 2 that multicast
//     each piece (L2 then serves it once per two tiles) ran 5-11% slower
//     than blocks alone, and 34% with a refill that does not wait: each
//     piece's stage waits for both blocks' warps, and the issuing thread, a
//     consumer, holds its warpgroup while it waits (PERF.md);
//   - a block barrier stands between a layer's products and its epilogue
//     (both warpgroups read all of h); the epilogue writes each value as one
//     bf16 into the h tiles ([32][64] chunks, 128-byte swizzle);
//   - the alpha and rgb heads sum each thread's columns, then the 8 lanes
//     of a point group, then the 8 warps in a fixed order through shared
//     memory (no atomics: the same sums every run);
//   - the encodings' chunk counts are run-time values (one instantiation
//     takes every encoding that fits): x_pe and d_pe in [32][64] chunks of
//     4 KB.
// Shared memory (t_core_bytes): the two rings (128 KB at W = 512 and 1024,
// 64 KB at 256), h (W/64 chunks of 4 KB), a scratch of 6 KB (points, raw
// outputs, head partial sums, the rings' barriers), then nx x_pe and nd
// d_pe chunks: 202,752 + 4,096 (nx + nd) B at W = 1024 (211,968 with the
// launch's alignment for the default encodings), 169,984 + 4,096 (nx + nd)
// at W = 512, 88,064 + 4,096 (nx + nd) at W = 256. The standard core runs
// every net it has room for (W = 256 with NX <= 4 and nd <= 2, W = 512 with
// NX + nd <= 4); this one the rest, where they fit.
// Weight traffic: each 32-point tile reads every packed chunk (18.2 MB for
// the 8x1024 default-shaped net) from L2, 892 GB per 8192 x 192 launch,
// against 28.8 ms of bf16 tensor-core work. A ring that issues no copies
// runs 0.75-0.77 of the time (chip_variants.py): the L2 stream is a quarter
// of it; the rest is the products' own (N = 32: every k16 step reads its 2
// KB of weights and 1 KB of activations from shared memory).

constexpr int TP = 32;                            // points of a transposed tile
constexpr int T_CHUNK_BYTES = TP * CHUNK_K * 2;   // 4 KB: an activation chunk [32][64]
constexpr int T_SCRATCH = 6 * 1024;               // pts, raw, partial sums, barriers

// Rows of a trunk piece (a warpgroup's share of a trunk chunk, or a part
// of it: at most 128 rows, 16 KB) and its bytes; rows of a views piece
// (of the views chunk's W/2 rows, a warpgroup's W/4, at most 128) and its
// bytes; ring stages of a warpgroup: four of 16 KB at W = 512 and 1024, two
// at W = 256 (the shared memory of the rings of two stages of 32 KB that
// they replaced: deeper rings keep more pieces in flight).
__host__ __device__ constexpr int t_piece_rows(int width) { return width / 2 < 128 ? width / 2 : 128; }
__host__ __device__ constexpr int t_piece_bytes(int width) {
  return t_piece_rows(width) * CHUNK_K * 2;
}
__host__ __device__ constexpr int t_views_rows(int width) { return width / 4 < 128 ? width / 4 : 128; }
__host__ __device__ constexpr int t_stages(int width) { return width == N ? 2 : 4; }

template <int W>
struct TShape {
  static_assert(W == N || W == 2 * N || W == 4 * N,
                "the transposed core takes trunks of 256, 512 or 1024");
  static constexpr int MB = W / 2 / 64;                 // trunk m64 blocks of a warpgroup
  static constexpr int MV = W / 4 / 64;                 // views m64 blocks of a warpgroup
  static constexpr int RUN = W / 2 / t_piece_rows(W);   // trunk pieces of a warpgroup per chunk
  static constexpr int PB = t_piece_rows(W) / 64;       // m64 blocks of a trunk piece
  static constexpr int RUNV = W / 4 / t_views_rows(W);  // views pieces of a warpgroup per chunk
  static constexpr int PBV = MV / RUNV;                 // m64 blocks of a views piece
  static constexpr int H = W / CHUNK_K;                 // h chunks
};

// Shared memory of the transposed core from a 1024-aligned base.
__host__ __device__ constexpr int t_fixed_bytes(int width) {
  return 2 * t_stages(width) * t_piece_bytes(width) + width / CHUNK_K * T_CHUNK_BYTES + T_SCRATCH;
}
__host__ __device__ constexpr int t_core_bytes(int width, int nx, int nd) {
  return t_fixed_bytes(width) + (nx + nd) * T_CHUNK_BYTES;
}

// Whether a net runs on the transposed core: every W = 1024 net, and a net
// of W = 256 or 512 whose encodings the standard core has no room for.
__host__ __device__ inline bool transposed(int width, int in_ch, int in_ch_views) {
  const int nx = x_chunks(in_ch), nd = d_chunks(in_ch_views);
  return width == 4 * N || (width == 2 * N && nx + nd > 4) || (width == N && (nx > 4 || nd > 2));
}

// The transposed core's plan: the same packed chunks (pack_wgmma_weights),
// each warpgroup's pieces counted (Plan::ways = 2).
inline Plan make_plan_transposed(const void* packed, int width, int depth,
                                 int n_skips, int in_ch, int in_ch_views) {
  const int nx = x_chunks(in_ch), h = width / CHUNK_K, run = width / 2 / t_piece_rows(width);
  const int run_v = width / 4 / t_views_rows(width);
  const int wide = nx + h * (depth - 1) + nx * n_skips + h;
  const int narrow = h + d_chunks(in_ch_views);
  return Plan{static_cast<const unsigned char*>(packed), wide * run + narrow * run_v, wide * run,
              t_piece_bytes(width), t_views_rows(width) * CHUNK_K * 2, 2, run, run_v};
}

inline Plan make_plan(const void* packed, int width, int depth, int n_skips,
                      int in_ch, int in_ch_views) {
  return transposed(width, in_ch, in_ch_views)
      ? make_plan_transposed(packed, width, depth, n_skips, in_ch, in_ch_views)
      : make_plan_standard(packed, width, depth, n_skips, in_ch, in_ch_views);
}

// acc += A B on one k16 step, m64n32k16 (A the weights, B the activations).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M][16]) {
#pragma unroll
  for (int m = 0; m < M; ++m) fence_regs(d[m]);
}

template <int M>
__device__ __forceinline__ void zero_t(float (&acc)[M][16]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;
  }
}

// The products of one layer in the transposed core: acc (this warpgroup's M
// = RUN * PB column blocks) += its rows of the layer's packed chunks times
// the activations, n0 chunks at a0 then n1 at a1 (B operands, [TP][64]
// chunks), `last` k16 steps of the last chunk. Piece r of a chunk feeds
// blocks [PB r, PB r + PB); each piece is freed once the next one's products
// are issued, the last once all completed.
template <int M, int PB, int RUN, typename R>
__device__ __forceinline__ void layer_t(float (&acc)[M][16], uint32_t a0, int n0, uint32_t a1,
                                        int n1, int last, R& ring) {
  static_assert(M == RUN * PB, "a warpgroup's blocks are its pieces' blocks");
  const int chunks = n0 + n1;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const uint32_t b = c < n0 ? a0 + c * T_CHUNK_BYTES : a1 + (c - n0) * T_CHUNK_BYTES;
    const int ksteps = c + 1 == chunks ? last : 4;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const uint32_t w = ring.acquire();
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ksteps) {
#pragma unroll
          for (int m = 0; m < PB; ++m) {
            wgmma_n32(acc[PB * r + m], desc_sw128(w + m * A_CHUNK_BYTES + 32 * kk),
                      desc_sw128(b + 32 * kk));
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (c > 0 || r > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(acc);
        ring.release();
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);
  ring.release();
}

// The bf16 value x at (row, col) of a K-major [ROWS][64]-chunk tile with
// 128-byte swizzle.
template <int ROWS>
__device__ __forceinline__ void store_bf16_rows(unsigned char* tile, int row, int col, float x) {
  *reinterpret_cast<__nv_bfloat16*>(tile + tile_offset<ROWS>(row, col)) = __float2bfloat16_rn(x);
}

// Bias, optional ReLU and the bf16 rounding of this warpgroup's M column
// blocks, left in acc and, unless h is null, written into the h tiles
// ([TP][64] chunks) at columns col0 + ..., one bf16 a store (two a 32-bit
// store, pairing each value with the neighbouring column's from lane ^ 4
// by a shuffle, ran 6-21% slower: PERF.md). Slot 4j + e of block m holds
// column 64m + 16*warp + lane/4 + 8*(e/2) (bias points at column 0 of the
// warpgroup) and point 8j + 2*(lane%4) + e%2. FAST as in `epilogue`.
template <int M, bool RELU, bool FAST>
__device__ __forceinline__ void epilogue_t(float (&acc)[M][16], const float* bias,
                                           unsigned char* h, int col0) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int col = 64 * m + r0 + 8 * hi;
      const float bb = __ldg(bias + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int lo = 0; lo < 2; ++lo) {
          float x = acc[m][4 * j + 2 * hi + lo];
          x = FAST ? round_bf16(x) + round_bf16(bb) : x + bb;
          if (RELU) x = relu(x);
          x = round_bf16(x);
          acc[m][4 * j + 2 * hi + lo] = x;
          if (h != nullptr) store_bf16_rows<TP>(h, 8 * j + 2 * (lane & 3) + lo, col0 + col, x);
        }
      }
    }
  }
}

// A head (NCH outputs, kernel w [cols][NCH] at this warpgroup's column 0) on
// the values in acc: each thread's columns, then the 8 lanes that share its
// points, into part [8 warps][4][TP] at channels ch0 .. ch0 + NCH - 1.
template <int M, int NCH>
__device__ __forceinline__ void head_t(const float (&acc)[M][16], const float* w, float* part,
                                       int ch0) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float s[NCH][8];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[c][i] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int col = 64 * m + r0 + 8 * hi;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float wc = __ldg(w + NCH * col + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int lo = 0; lo < 2; ++lo) {
            s[c][2 * j + lo] = fmaf(acc[m][4 * j + 2 * hi + lo], wc, s[c][2 * j + lo]);
          }
        }
      }
    }
  }
  float* dst = part + (threadIdx.x >> 5) * 4 * TP;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = s[c][i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) dst[(ch0 + c) * TP + 8 * (i >> 1) + 2 * lane + (i & 1)] = v;
    }
  }
}

// The MLP of one 32-point tile on the transposed core, once its encodings
// are in the x_pe and d_pe tiles (published): raw [4][TP] (r, g, b logits,
// sigma) in raw, readable by every thread on return.
template <int W, bool FAST, typename R>
__device__ __forceinline__ void mlp_transposed(unsigned char* x_tiles, unsigned char* h_tiles,
                                               float* part, float* raw, const Net& net, R& ring,
                                               int group) {
  using T = TShape<W>;
  const int nx = x_chunks(net.in_ch), nd = d_chunks(net.in_ch_views);
  const uint32_t x = smem_addr(x_tiles), h = smem_addr(h_tiles);
  const uint32_t d = x + nx * T_CHUNK_BYTES;
  const int col0 = W / 2 * group, vcol0 = W / 4 * group;
  float acc[T::MB][16];

  // ---- trunk -------------------------------------------------------------
  bool with_x = true;  // layer 0 reads x_pe
  for (int i = 0; i < net.depth; ++i) {
    // the net's table read before the products (prefetch_skip)
    const float* bias = bias_of(net, i) + col0;
    const bool next_x = prefetch_skip(net, i);
    zero_t(acc);
    layer_t<T::MB, T::PB, T::RUN>(acc, x, with_x ? nx : 0, h, i == 0 ? 0 : T::H, 4, ring);
    __syncthreads();  // every warp's products that read h are complete
    epilogue_t<T::MB, true, FAST>(acc, bias, h_tiles, col0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    with_x = next_x;
  }
  head_t<T::MB, 1>(acc, net.alpha_k + col0, part, 3);

  // ---- feature layer (no ReLU, rounded after its bias) -------------------
  const float* feature_bias = bias_of(net, net.depth) + col0;
  const float* views_bias = bias_of(net, net.depth + 2) + vcol0;
  zero_t(acc);
  layer_t<T::MB, T::PB, T::RUN>(acc, h, T::H, h, 0, 4, ring);
  __syncthreads();
  epilogue_t<T::MB, false, false>(acc, feature_bias, h_tiles, col0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // ---- views layer [feature, d_pe] -> W/2, ReLU, then the rgb head -------
  float accv[T::MV][16];
  zero_t(accv);
  const int last = (net.in_ch_views - CHUNK_K * (nd - 1) + 15) / 16;
  layer_t<T::MV, T::PBV, T::RUNV>(accv, h, T::H, d, nd, last, ring);
  epilogue_t<T::MV, true, FAST>(accv, views_bias, nullptr, 0);
  head_t<T::MV, 3>(accv, net.rgb_k + 3 * vcol0, part, 0);

  // ---- the heads' sums over the 8 warps, in order ------------------------
  __syncthreads();
  if (threadIdx.x < 4 * TP) {
    const int c = threadIdx.x / TP, p = threadIdx.x % TP;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) v += part[(4 * w + c) * TP + p];
    raw[c * TP + p] =
        v + __ldg(c == 3 ? bias_of(net, net.depth + 1) : bias_of(net, net.depth + 3) + c);
  }
  __syncthreads();
}

// A transposed tile's encodings, bf16, into its nx x_pe and nd d_pe chunks
// ([ROWS][64] each: every column, zero past each encoding's channels) from
// its [6][ROWS] points; threads 0-255, a channel pair of a point each.
template <bool TRUE_COS, int ROWS = TP>
__device__ __forceinline__ void encode_transposed(const float* pts, unsigned char* xt,
                                                  unsigned char* dt, const Net& net, int nx,
                                                  int nd) {
  const int n_x = nx * (CHUNK_K / 2) * ROWS;
  const int total = n_x + nd * (CHUNK_K / 2) * ROWS;
#pragma unroll 1
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const bool view = i >= n_x;
    const int k = view ? i - n_x : i;
    const int row = k % ROWS, col = 2 * (k / ROWS);
    const float* xyz = pts + (view ? 3 * ROWS : 0) + row;
    const int n_ch = view ? net.in_ch_views : net.in_ch;
    store_bf16x2_rows<ROWS>(view ? dt : xt, row, col, encode<TRUE_COS>(xyz, ROWS, col, n_ch),
                            encode<TRUE_COS>(xyz, ROWS, col + 1, n_ch));
  }
}

// Rows [0, here) of a pre-encoded input src [*, n_ch], rounded to bf16, into
// n [ROWS][64] chunks of a transposed tile (zero past the channels and the
// rows); a row's channel pairs are read by consecutive threads (0-255).
template <int ROWS = TP>
__device__ __forceinline__ void load_transposed(const float* __restrict__ src, int n_ch, int n,
                                                int here, unsigned char* tile) {
  const int pairs = n * CHUNK_K / 2;
#pragma unroll 1
  for (int i = threadIdx.x; i < ROWS * pairs; i += THREADS) {
    const int row = i / pairs, col = 2 * (i - row * pairs);
    float lo = 0.f, hi = 0.f;
    if (row < here) {
      const float* r = src + row * n_ch;
      if (col < n_ch) lo = __ldg(r + col);
      if (col + 1 < n_ch) hi = __ldg(r + col + 1);
    }
    store_bf16x2_rows<ROWS>(tile, row, col, lo, hi);
  }
}

// ---- a kernel's core: the standard one (NX = the x_pe chunks) or the
// transposed one (NX = 0) ------------------------------------------------------

// The core of one kernel instantiation: pointers into its shared memory.
template <int W, int NX>
struct Core {
  static constexpr bool TRANSPOSED = NX == 0;
  static constexpr int STAGES = TRANSPOSED ? t_stages(W) : stages(W, NX);
  // points of a block tile, and of the tile a warpgroup reads and writes
  static constexpr int TILE = TRANSPOSED ? TP : W == N ? 2 * P : P;
  static constexpr int PTS = TRANSPOSED ? TP : P;
  // both warpgroups work on one tile
  static constexpr bool SHARED = TRANSPOSED || W != N;
  // blocks of a cluster and threads of a block: the standard core's
  // clusters multicast every chunk, and its blocks add a producer warpgroup
  static constexpr int CLUSTER = TRANSPOSED ? 1 : cluster_size(W);
  static constexpr int BLOCK = TRANSPOSED ? THREADS : STD_THREADS;
  using RingType =
      typename std::conditional<TRANSPOSED, Ring<STAGES, true>, McRing<STAGES, CLUSTER>>::type;
  unsigned char* base;  // 1024-aligned
  RingType ring;
  uint32_t rank;        // this block's rank in its cluster
  unsigned char* a;     // this warpgroup's A tiles: x_pe (NX chunks), h, d_pe (nd);
                        // transposed: the x_pe then d_pe chunks
  unsigned char* h;     // transposed: the h chunks
  float* part;          // transposed: the heads' partial sums
  float* pts;           // the tile's [6][PTS] points
  float* raw;           // this warpgroup's [4][PTS] raw outputs
  int group;            // warpgroup 0 or 1
  int nd;               // d_pe chunks

  // The first point of this warpgroup's tile within a block tile.
  __device__ int point0() const { return SHARED ? 0 : group * P; }
  // Whether this warpgroup reads its tile's points and writes its outputs
  // (both warpgroups at W = 256; warpgroup 0 for a shared tile).
  __device__ bool io() const { return !SHARED || group == 0; }
  // The barrier of the threads that share this warpgroup's tile.
  __device__ void sync() const {
    if constexpr (TRANSPOSED) {
      __syncthreads();
    } else {
      tile_sync<W>(group);
    }
  }
  // The tile slots of this block, of tiles blockIdx.x, + gridDim.x, ...:
  // as many as the first block of its cluster has tiles below n_tiles, so
  // that every block of a cluster consumes every chunk (a slot past the
  // last tile runs masked).
  __device__ long long slots(long long n_tiles) const {
    const long long first = static_cast<long long>(blockIdx.x) - rank;
    return n_tiles > first ? (n_tiles - first + gridDim.x - 1) / gridDim.x : 0;
  }
};

// Pointers into the core's shared memory, from the kernel's dynamic shared
// buffer (aligned up to SMEM_ALIGN here; launches ask for core_bytes +
// SMEM_ALIGN plus their own part). The ring is set up by start().
template <int W, int NX>
__device__ __forceinline__ Core<W, NX> make_core(void* dyn, const Plan& plan, int nd) {
  Core<W, NX> c;
  // offset from the shared array itself, so the compiler still knows every
  // pointer below is shared (plain st.shared / ld.shared, 32-bit addresses)
  const uint32_t pad = (SMEM_ALIGN - (smem_addr(dyn) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1);
  c.base = static_cast<unsigned char*>(dyn) + pad;
  c.ring.plan = plan;
  c.rank = NX == 0 ? 0u : cluster_rank();
  c.group = threadIdx.x >> 7;
  c.nd = nd;
  if constexpr (NX == 0) {
    // the two rings, h, the scratch, then the x_pe and d_pe chunks
    c.ring.buf = c.base + c.group * t_stages(W) * t_piece_bytes(W);
    c.h = c.base + 2 * t_stages(W) * t_piece_bytes(W);
    c.pts = reinterpret_cast<float*>(c.h + TShape<W>::H * T_CHUNK_BYTES);
    c.raw = c.pts + 6 * TP;
    c.part = c.raw + 4 * TP;
    c.ring.full = reinterpret_cast<uint64_t*>(c.part + (THREADS / 32) * 4 * TP) +
                  2 * t_stages(W) * c.group;
    c.ring.empty = c.ring.full + t_stages(W);
    c.a = c.h + TShape<W>::H * T_CHUNK_BYTES + T_SCRATCH;
  } else {
    unsigned char* tiles = c.base + Core<W, NX>::STAGES * chunk_bytes(W);  // after the ring
    const int ab = a_bytes(W, NX, nd);
    c.ring.buf = c.base;
    c.a = tiles + (Shape<W>::SPLIT ? 0 : c.group * ab);
    c.h = nullptr;
    c.part = nullptr;
    c.pts = reinterpret_cast<float*>(c.a + NX * A_CHUNK_BYTES);
    c.raw = reinterpret_cast<float*>(c.a) + (Shape<W>::SPLIT ? c.group * 4 * P : 0);
    c.ring.full = reinterpret_cast<uint64_t*>(tiles + Shape<W>::GROUPS * ab);
    c.ring.empty = c.ring.full + Core<W, NX>::STAGES;
  }
  return c;
}

// The MLP of one tile, once this thread has written its part of the x_pe
// and d_pe A tiles: publish them, run the MLP, and leave raw [4][PTS] in the
// io() warpgroup's core.raw, readable by it on return.
template <int W, int NX, bool FAST>
__device__ __forceinline__ void mlp_tile(Core<W, NX>& core, const Net& net) {
  if constexpr (NX == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    mlp_transposed<W, FAST>(core.a, core.h, core.part, core.raw, net, core.ring, core.group);
    return;
  } else {
    tile_publish<W>(core.group);
    // the d_pe chunk count picks one of two inlined cores at run time: the
    // builds with a single inlined core spill (PERF.md)
    if (core.nd == 1) {
      mlp_core_wgmma<W, NX, 1, FAST>(core.a, core.raw, net, core.ring, core.group);
    } else {
      mlp_core_wgmma<W, NX, 2, FAST>(core.a, core.raw, net, core.ring, core.group);
    }
    if constexpr (Shape<W>::SPLIT) {
      // warpgroup 0's raw += warpgroup 1's partial sums, one value a thread
      consumer_sync();
      float* raw0 = reinterpret_cast<float*>(core.a);
      raw0[threadIdx.x] += raw0[4 * P + threadIdx.x];
      consumer_sync();
    } else {
      wg_barrier(core.group);
    }
  }
}

// Sets up the core's ring for `chunks` chunks; every thread of the block
// calls it first. Standard core: the producer warpgroup streams the chunks,
// waits at the cluster barrier that ends the kernel, and gets true (its
// kernel returns); the consumers get false and call finish() after their
// last tile slot. Transposed core: Ring::init, false.
template <int W, int NX>
__device__ __forceinline__ bool start(Core<W, NX>& core, long long chunks) {
  if constexpr (NX == 0) {
    core.ring.init(chunks);
    return false;
  } else {
    core.ring.init();
    if (warpgroup() == THREADS / 128) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
      if (threadIdx.x == THREADS) core.ring.produce(chunks, core.rank);
      __syncwarp();
      cluster_sync();
      return true;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    return false;
  }
}

// The consumers' end of a kernel: on the standard core the cluster barrier,
// so that no block exits while a partner may still copy or arrive into it.
template <int W, int NX>
__device__ __forceinline__ void finish(Core<W, NX>&) {
  if constexpr (NX != 0) cluster_sync();
}

// One tile, once its [6][PTS] points are in core.pts (published by
// core.sync()): encode (cos as sin(y + pi/2), or with TRUE_COS a true
// cosf), then mlp_tile.
template <int W, int NX, bool FAST, bool TRUE_COS>
__device__ __forceinline__ void run_tile(Core<W, NX>& core, const Net& net) {
  if constexpr (NX == 0) {
    const int nx = x_chunks(net.in_ch);
    encode_transposed<TRUE_COS>(core.pts, core.a, core.a + nx * T_CHUNK_BYTES, net, nx,
                                core.nd);
  } else {
    encode_tiles<NX, TRUE_COS, Shape<W>::SPLIT>(
        core.pts, core.a, core.a + (NX + Shape<W>::H) * A_CHUNK_BYTES, net, core.nd, core.group);
  }
  mlp_tile<W, NX, FAST>(core, net);
}

// A tile's x_pe and d_pe from rows [0, here) of x_pe [*, in_ch] and d_pe
// [*, in_ch_views], every column of each, into the core's tiles.
template <int W, int NX>
__device__ __forceinline__ void load_tile_encodings(const float* x_pe, const float* d_pe,
                                                    int here, Core<W, NX>& core,
                                                    const Net& net) {
  if constexpr (NX == 0) {
    const int nx = x_chunks(net.in_ch);
    load_transposed(x_pe, net.in_ch, nx, here, core.a);
    load_transposed(d_pe, net.in_ch_views, core.nd, here, core.a + nx * T_CHUNK_BYTES);
  } else {
    load_encodings<W, NX>(x_pe, d_pe, here, core.a, net, core.nd, core.group);
  }
}

// The template argument NX of a net's core: its x_pe chunks on the
// standard core, 0 on the transposed one.
inline int core_nx(int width, int in_ch, int in_ch_views) {
  return transposed(width, in_ch, in_ch_views) ? 0 : x_chunks(in_ch);
}

// Points of a block tile of a net's core.
inline int tile_points(int width, int in_ch, int in_ch_views) {
  return transposed(width, in_ch, in_ch_views) ? TP : width == N ? 2 * P : P;
}

// Calls L::run<W, NX>(args...) for a net's trunk width (256, 512 or 1024)
// and core_nx: the instantiations of the cores (the standard core at W = 512
// takes at most three x_pe chunks: four leave no room for the ring).
// cudaErrorInvalidValue for any other.
template <typename L, typename... Args>
int dispatch(int width, int nx, Args... args) {
  if (width == N) {
    switch (nx) {
      case 0: return L::template run<N, 0>(args...);
      case 1: return L::template run<N, 1>(args...);
      case 2: return L::template run<N, 2>(args...);
      case 3: return L::template run<N, 3>(args...);
      case 4: return L::template run<N, 4>(args...);
      default: break;
    }
  } else if (width == 2 * N) {
    switch (nx) {
      case 0: return L::template run<2 * N, 0>(args...);
      case 1: return L::template run<2 * N, 1>(args...);
      case 2: return L::template run<2 * N, 2>(args...);
      case 3: return L::template run<2 * N, 3>(args...);
      default: break;
    }
  } else if (width == 4 * N && nx == 0) {
    return L::template run<4 * N, 0>(args...);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The last cluster launch of this library (chip_smoke.py prints it): blocks
// per cluster, blocks, the device's most active clusters of the kernel at
// its shared memory, threads per block.
inline int last_launch[4] = {0, 0, 0, 0};

// cudaOccupancyMaxActiveClusters of a kernel at a cluster size and shared
// memory, asked once per process (a query costs host time at every launch
// otherwise).
struct ActiveClusters {
  const void* kernel;
  size_t smem_bytes;
  int cluster;
  int active;
};
inline ActiveClusters active_clusters[64];
inline int n_active_clusters = 0;

// Launches `kernel` on persistent clusters of `cluster` blocks of `threads`
// threads: as many clusters as the device keeps active at once
// (cudaOccupancyMaxActiveClusters), at most enough for `work` blocks.
// Returns a cudaError_t value: 0 when the launch was accepted.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), long long work, int cluster, int threads,
                    size_t smem_bytes, cudaStream_t stream, Args... args) {
  int smem_max = 0;
  const int e = smem_optin(&smem_max);
  if (e != 0) return e;
  if (work < 1 || smem_bytes > static_cast<size_t>(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  for (int i = 0; i < n_active_clusters; ++i) {
    const ActiveClusters& a = active_clusters[i];
    if (a.kernel == reinterpret_cast<const void*>(kernel) && a.smem_bytes == smem_bytes &&
        a.cluster == cluster) {
      active = a.active;
    }
  }
  if (active == 0) {
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (n_active_clusters < 64) {
      active_clusters[n_active_clusters++] =
          ActiveClusters{reinterpret_cast<const void*>(kernel), smem_bytes, cluster, active};
    }
  }
  const long long want = (work + cluster - 1) / cluster;
  const long long n = want < active ? want : active;
  cfg.gridDim = dim3(static_cast<unsigned>(n * cluster), 1, 1);
  last_launch[0] = cluster;
  last_launch[1] = static_cast<int>(n * cluster);
  last_launch[2] = active;
  last_launch[3] = threads;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launches a kernel of core Core<W, NX> on `work` block tiles: the
// standard core on clusters (launch_clusters), the transposed core on one
// persistent block per SM.
template <int W, int NX, typename... Params, typename... Args>
int launch_core(void (*kernel)(Params...), long long work, size_t smem_bytes,
                cudaStream_t stream, Args... args) {
  using C = Core<W, NX>;
  if constexpr (C::TRANSPOSED) {
    return launch_persistent(kernel, work, smem_bytes, stream, args...);
  } else {
    return launch_clusters(kernel, work, C::CLUSTER, C::BLOCK, smem_bytes, stream, args...);
  }
}

// Dynamic shared memory a launch asks for: the core, aligned.
inline int launch_bytes(int width, int in_ch, int in_ch_views) {
  const int nx = x_chunks(in_ch), nd = d_chunks(in_ch_views);
  return (transposed(width, in_ch, in_ch_views) ? t_core_bytes(width, nx, nd)
                                                : core_bytes(width, nx, nd)) +
         SMEM_ALIGN;
}

}  // namespace wg
}  // namespace nerf

// Bytes of the wgmma cores' packed weights (raymarch.py pack_wgmma_weights)
// and of the shared memory the core of a net needs (the library refuses a
// launch that asks for more than the device's nerf_smem_optin()). Defined
// once in each shared library, as the limits of nerf_mlp.cuh.
extern "C" {
long long nerf_wgmma_plan_bytes(int width, int depth, int n_skips, int in_ch, int in_ch_views) {
  return nerf::wg::make_plan(nullptr, width, depth, n_skips, in_ch, in_ch_views).tile_bytes();
}
int nerf_wgmma_smem_bytes(int width, int in_ch, int in_ch_views) {
  return nerf::wg::launch_bytes(width, in_ch, in_ch_views);
}
// The last cluster launch of the standard core in this library, into
// info[4]: blocks per cluster, blocks, the device's most active clusters
// of that kernel, threads per block. Returns 0.
int nerf_wgmma_last_launch(int* info) {
  for (int i = 0; i < 4; ++i) info[i] = nerf::wg::last_launch[i];
  return 0;
}
}
