// nerf_mlp_wgmma.cuh - the NeRF MLP core on Hopper's tensor cores (wgmma),
// bf16 only.
//
// The bf16 instantiations of nerf_march.cu (replacing the Pallas TPU kernel
// `_march_channels_kernel` of neuralsim_tpu/kernels/raymarch.py),
// render_tile.cu (replacing `_render_tile_kernel`) and of nerf_mlp.cu's
// PROJECTION and ENCODED stages (replacing `_mlp_widepe_kernel` and
// `_mlp_kernel`) run their MLP here; every float32 instantiation, and
// nerf_mlp.cu's TRUE_COS stage (`_mlp_pe_kernel`) in both types, keep the
// FP32 core of nerf_mlp.cuh. Same function as that core in bf16
// (nerf_mlp.cuh states the rounding), on tiles of 128 points.
//
// Bound on the card: operations on the tensor cores. One point costs
// 593,408 bf16 multiply-adds; at the published 989 TFLOP/s a launch on
// 8192 rays x 192 samples takes at least 1.887 ms.
//
// Design:
//   - a block is two consumer warpgroups (256 threads); warpgroup g owns
//     points [64g, 64g+64) of the block's 128-point tile and issues
//     wgmma.mma_async m64n256k16 (trunk, feature) and m64n128k16 (views)
//     with f32 accumulators in registers; every trunk, feature and views
//     product runs on the tensor cores;
//   - activations never touch device memory: a layer's epilogue (bias in
//     f32, ReLU, round to bf16) writes the warpgroup's own 64 rows into a
//     shared A tile in the layout wgmma reads ([64][64] K-chunks, 128-byte
//     swizzle), so one warpgroup barrier, not a block barrier, stands
//     between layers. (Kept in registers as the next layer's A fragments,
//     the 64 packed registers beside the 128 accumulators spilled.);
//   - the encodings x_pe (63 -> 64 channels) and d_pe (27 -> 32, in a
//     64-wide chunk) are written once per tile into A tiles of their own;
//     the skip layer [x_pe, h] and the views layer [feature, d_pe] are two
//     partial sums into the same accumulators;
//   - the alpha (256 -> 1) and rgb (128 -> 3) heads run on the CUDA cores
//     from the accumulator registers, reduced over the four lanes of a row.
//
// Weight traffic. The host packs the weights once (raymarch.py
// pack_wgmma_weights) into bf16 chunks of 64 input rows, each in the exact
// shared-memory image the B descriptor reads ([N][64], 128-byte swizzle):
// 34 chunks of 32 KB (N = 256) and 5 of 16 KB (views, N = 128), 1.196 MB
// for the default 8x256 net. Thread 0 streams them with one
// cp.async.bulk each into a ring of STAGES = 3 stages, so two chunks are in
// flight while one multiplies, and a warpgroup frees a chunk only after
// issuing its next one, so the tensor core has the next product queued.
// Blocks are persistent (one per SM) and the ring runs on from one tile
// into the next. Each 128-point tile still reads all 1.196 MB from L2: at
// S = 192, 12,288 tiles read 14.7 GB per launch, served by the 50 MB L2.
// Larger tiles, and cluster multicast of each chunk, are what cut that
// next.

#pragma once

#include "nerf_mlp.cuh"

namespace nerf {
namespace wg {

constexpr int TILE = 2 * P;                       // points per block tile
constexpr int STAGES = 3;                         // weight ring depth
constexpr int CHUNK_K = 64;                       // input rows per chunk
constexpr int CHUNK_BYTES = W * CHUNK_K * 2;      // 32 KB, N = 256
constexpr int VIEWS_CHUNK_BYTES = (W / 2) * CHUNK_K * 2;  // 16 KB, N = 128
constexpr int A_CHUNK_BYTES = P * CHUNK_K * 2;    // 8 KB: [64 rows][64] bf16
constexpr int A_BYTES = (W / CHUNK_K + 2) * A_CHUNK_BYTES;  // x_pe, h, d_pe

// Shared memory of the core, in bytes from a 1024-aligned base: the ring,
// each warpgroup's A tiles (x_pe, h in 4 chunks, d_pe: every layer's input
// chunks lie contiguous, in the order the ring delivers the weights), each
// warpgroup's [6][P] points and [4][P] raw outputs, then the ring's
// barriers.
constexpr int RING_OFF = 0;
constexpr int A_OFF = RING_OFF + STAGES * CHUNK_BYTES;
constexpr int PTS_OFF = A_OFF + 2 * A_BYTES;
constexpr int RAW_OFF = PTS_OFF + 2 * 6 * P * 4;
constexpr int BAR_OFF = RAW_OFF + 2 * 4 * P * 4;
constexpr int CORE_BYTES = BAR_OFF + 2 * STAGES * 8;
constexpr int SMEM_ALIGN = 1024;                  // the swizzle's repeat

// The packed weights of one net and its chunk order per tile: layer 0
// (x_pe), each trunk layer i >= 1 (x_pe first after a skip, then four h
// chunks), feature (four), then views (four feature chunks and one d_pe
// chunk, N = 128).
struct Plan {
  const unsigned char* packed;
  int per_tile;  // chunks per tile
  int n256;      // of which N = 256 (all but the views layer's five)
};

inline Plan make_plan(const void* packed, int depth, unsigned skip_mask) {
  const int n256 = 1 + 4 * (depth - 1) + __builtin_popcount(skip_mask) + 4;
  return Plan{static_cast<const unsigned char*>(packed), n256 + 5, n256};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major bf16 operand with 128-byte swizzle: rows of
// 64 values (128 bytes), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of (row, col) in a K-major A tile of [64][64] chunks with
// 128-byte swizzle: the 16-byte unit col/8 of a row sits at unit
// (col/8) ^ (row % 8).
__device__ __forceinline__ int a_offset(int row, int col) {
  return (col >> 6) * A_CHUNK_BYTES + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

__device__ __forceinline__ void store_bf16x2(unsigned char* tile, int row, int col, float lo,
                                             float hi) {
  *reinterpret_cast<__nv_bfloat162*>(tile + a_offset(row, col)) = __floats2bfloat162_rn(lo, hi);
}

// A barrier of the 128 threads of warpgroup `group` (named barrier 1 or 2).
__device__ __forceinline__ void wg_barrier(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

// The warpgroup's generic-proxy writes of its A tiles become visible to
// its wgmma (async proxy) reads.
__device__ __forceinline__ void wg_publish(int group) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_barrier(group);
}

// The weight ring: the block's chunks go round STAGES stages in order;
// full[s] completes when a chunk's bytes landed, empty[s] when all 8 warps
// are done with it. Thread 0 issues every copy. Every thread tracks the
// stage and phase of the chunk it acquires next and of the oldest chunk it
// still holds; thread 0 also the next chunk to issue. No 64-bit division:
// its subroutine call would spill the accumulators.
struct Ring {
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

  __device__ void init(long long total) {
    read_stage = free_stage = 0;
    read_phase = free_phase = 0;
    left = total;
    next_q = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + s)));
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     ::"r"(smem_addr(empty + s)), "r"(THREADS / 32));
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES && left > 0; ++s) issue(s);
    }
  }

  // Thread 0: the next chunk of the sequence into stage s.
  __device__ void issue(int s) {
    const int q = next_q;
    const int bytes = q < plan.n256 ? CHUNK_BYTES : VIEWS_CHUNK_BYTES;
    const size_t off = q < plan.n256
        ? static_cast<size_t>(q) * CHUNK_BYTES
        : static_cast<size_t>(plan.n256) * CHUNK_BYTES +
              static_cast<size_t>(q - plan.n256) * VIEWS_CHUNK_BYTES;
    const uint32_t bar = smem_addr(full + s);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(buf + s * CHUNK_BYTES)), "l"(plan.packed + off), "r"(bytes),
          "r"(bar) : "memory");
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

  // The shared address of the next chunk, once it has landed.
  __device__ uint32_t acquire() {
    wait(full + read_stage, read_phase);
    const uint32_t addr = smem_addr(buf + read_stage * CHUNK_BYTES);
    if (++read_stage == STAGES) {
      read_stage = 0;
      read_phase ^= 1u;
    }
    return addr;
  }

  // This warp is done with its oldest chunk (the wgmma that read it
  // completed); thread 0 then refills the stage with the chunk STAGES
  // further on, once every warp is done with it.
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   ::"r"(smem_addr(empty + free_stage)) : "memory");
    }
    if (threadIdx.x == 0 && left > 0) {
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

template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (N == 256) {
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
// (K-major [64][64], 128-byte swizzle), LAST_KSTEPS k16 steps of the last
// chunk (4 for the others). Each chunk's products queue behind the
// previous chunk's; the previous chunk is freed once they are issued, the
// last once all completed.
template <int N, int LAST_KSTEPS>
__device__ __forceinline__ void layer_mma(float (&acc)[N / 2], uint32_t a, int chunks,
                                          Ring& ring) {
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const uint32_t b = ring.acquire();
    const uint32_t ac = a + c * A_CHUNK_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const int ksteps = c + 1 == chunks ? LAST_KSTEPS : 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < ksteps) wgmma_k16<N>(acc, desc_sw128(ac + 32 * kk), desc_sw128(b + 32 * kk));
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
}

// Bias, optional ReLU and the bf16 rounding of a layer, left in acc and,
// unless h is null, written into the warpgroup's h tiles. Accumulator slot 4j + e
// holds row 16*warp + lane/4 + 8*(e/2) and column 8j + 2*(lane%4) + e%2.
// With FAST the product and the bias are rounded to bf16 before the add (a
// template flag: as a runtime one the compiler computes both forms of all
// 128 values under a predicate).
template <int N, bool RELU, bool FAST>
__device__ __forceinline__ void epilogue(float (&acc)[N / 2], const float* bias,
                                         unsigned char* h) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 b = load2(bias + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bb = (e & 1) ? b.y : b.x;
      float x = acc[4 * j + e];
      x = FAST ? round_cd<true>(x) + round_cd<true>(bb) : x + bb;
      if (RELU) x = fmaxf(x, 0.f);
      acc[4 * j + e] = round_cd<true>(x);
    }
    if (h != nullptr) {
      store_bf16x2(h, row, col, acc[4 * j], acc[4 * j + 1]);
      store_bf16x2(h, row + 8, col, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// Sum over the four lanes that share a row.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The warpgroup's encodings, bf16, into its x_pe and d_pe A tiles; pts is
// its [6][P] point tile. Thread lane of warp w writes rows 16w + lane/4
// (+8), channel pairs 2*(lane%4) + 8i.
__device__ __forceinline__ void encode_tiles(const float* pts, unsigned char* xt,
                                             unsigned char* dt, const Net& net) {
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll 1
  for (int i = 0; i < 2 * (CHUNK_K / 8 + PD / 8); ++i) {
    const bool view = i >= 2 * (CHUNK_K / 8);
    const int k = view ? i - 2 * (CHUNK_K / 8) : i;
    const int row = row0 + 8 * (k & 1);
    const int col = 8 * (k >> 1) + 2 * (lane & 3);
    const float* xyz = pts + (view ? 3 * P : 0) + row;
    const int n_ch = view ? net.in_ch_views : net.in_ch;
    store_bf16x2(view ? dt : xt, row, col, encode<false>(xyz, col, n_ch),
                 encode<false>(xyz, col + 1, n_ch));
  }
}

// Columns [0, COLS) of a warpgroup's A tile from the rows of a pre-encoded
// input, rounded to bf16: row p < here of the tile is src[p * n_ch ...].
// Every column the products read is written, zero where the channel is >=
// n_ch or the row >= here: pad columns must hold zeros, not whatever the
// tile held (a NaN there times a zero weight is NaN). Lane pair c of a row
// reads channels 2c, 2c+1, so a row is read by consecutive threads on
// consecutive addresses (rows are 4-byte aligned only: no vector loads).
template <int COLS>
__device__ __forceinline__ void load_encoding(const float* __restrict__ src, int n_ch, int here,
                                              unsigned char* tile) {
  constexpr int PAIRS = COLS / 2;
  const int t = threadIdx.x & 127;
  const int col = 2 * (t % PAIRS);
#pragma unroll 4
  for (int row = t / PAIRS; row < P; row += 128 / PAIRS) {
    float lo = 0.f, hi = 0.f;
    if (row < here) {
      const float* r = src + row * n_ch;
      if (col < n_ch) lo = __ldg(r + col);
      if (col + 1 < n_ch) hi = __ldg(r + col + 1);
    }
    store_bf16x2(tile, row, col, lo, hi);
  }
}

// The warpgroup's x_pe and d_pe A tiles (a: x_pe, h chunks 1-4, d_pe) from
// rows [0, here) of x_pe [*, in_ch] and d_pe [*, in_ch_views]: all CHUNK_K
// columns of x_pe, the PD columns of d_pe that the views layer reads.
__device__ __forceinline__ void load_encodings(const float* x_pe, const float* d_pe, int here,
                                               unsigned char* a, const Net& net) {
  load_encoding<CHUNK_K>(x_pe, net.in_ch, here, a);
  load_encoding<PD>(d_pe, net.in_ch_views, here, a + 5 * A_CHUNK_BYTES);
}

// The MLP on one warpgroup's 64 points, whose encodings encode_tiles left
// in its A tiles (a: x_pe, h chunks 1-4, d_pe; published): raw [4][P]
// (r, g, b logits, sigma) of the warpgroup, written by the lanes that hold
// each row. Consumes the tile's plan.per_tile chunks from the ring. FAST:
// net.fast_epilogue, as a template flag.
template <bool FAST>
__device__ __forceinline__ void mlp_core_wgmma(unsigned char* a, float* raw, const Net& net,
                                               Ring& ring, int group) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const uint32_t x = smem_addr(a);            // x_pe, then h, then d_pe
  const uint32_t h = x + A_CHUNK_BYTES;
  unsigned char* h_tile = a + A_CHUNK_BYTES;
  float acc[W / 2];

  // ---- trunk -------------------------------------------------------------
  for (int i = 0; i < net.depth; ++i) {
    zero<W>(acc);
    if (i == 0) {
      layer_mma<W, 4>(acc, x, 1, ring);
    } else if ((net.skip_mask >> (i - 1)) & 1u) {
      layer_mma<W, 4>(acc, x, 5, ring);    // [x_pe, h]
    } else {
      layer_mma<W, 4>(acc, h, 4, ring);
    }
    wg_barrier(group);  // every warp's products that read h are complete
    epilogue<W, true, FAST>(acc, net.b[i], h_tile);
    wg_publish(group);
  }

  // ---- density head (alpha [W][1]) on the trunk output, CUDA cores -------
  {
    const float* ak = net.k[net.depth + 1];
    float top = 0.f, bot = 0.f;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float2 w = load2(ak + 8 * j + 2 * (lane & 3));
      top = fmaf(acc[4 * j], w.x, fmaf(acc[4 * j + 1], w.y, top));
      bot = fmaf(acc[4 * j + 2], w.x, fmaf(acc[4 * j + 3], w.y, bot));
    }
    top = row_sum(top);
    bot = row_sum(bot);
    if ((lane & 3) == 0) {
      const float b = __ldg(net.b[net.depth + 1]);
      raw[3 * P + row] = top + b;
      raw[3 * P + row + 8] = bot + b;
    }
  }

  // ---- feature layer (no ReLU, rounded after its bias) -------------------
  zero<W>(acc);
  layer_mma<W, 4>(acc, h, 4, ring);
  wg_barrier(group);
  epilogue<W, false, false>(acc, net.b[net.depth], h_tile);
  wg_publish(group);

  // ---- views layer: [feature, d_pe] -> W/2, ReLU -------------------------
  float accv[W / 4];
  zero<W / 2>(accv);
  layer_mma<W / 2, PD / 16>(accv, h, 5, ring);   // [feature, d_pe]
  // the rgb head reads the registers: nothing to store
  epilogue<W / 2, true, FAST>(accv, net.b[net.depth + 2], nullptr);

  // ---- rgb head (rgb [W/2][3]), CUDA cores -------------------------------
  const float* rk = net.k[net.depth + 3];
  float top[3] = {0.f, 0.f, 0.f}, bot[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < W / 16; ++j) {
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
      const float bias = __ldg(net.b[net.depth + 3] + c);
      raw[c * P + row] = t + bias;
      raw[c * P + row + 8] = b + bias;
    }
  }
}

// Pointers into the core's shared memory, from the kernel's dynamic
// shared buffer (aligned up to SMEM_ALIGN here; launches ask for
// CORE_BYTES + SMEM_ALIGN plus their own part).
struct Core {
  unsigned char* base;  // 1024-aligned
  Ring ring;
  unsigned char* a;     // this warpgroup's A tiles: x_pe, h (4 chunks), d_pe
  float* pts;           // this warpgroup's [6][P]
  float* raw;           // this warpgroup's [4][P]
  int group;            // warpgroup 0 or 1
};

// The ring is set up by Ring::init, called by every thread.
__device__ __forceinline__ Core make_core(void* dyn, const Plan& plan) {
  Core c;
  // offset from the shared array itself, so the compiler still knows every
  // pointer below is shared (plain st.shared / ld.shared, 32-bit addresses)
  const uint32_t pad = (SMEM_ALIGN - (smem_addr(dyn) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1);
  c.base = static_cast<unsigned char*>(dyn) + pad;
  c.ring.buf = c.base + RING_OFF;
  c.ring.full = reinterpret_cast<uint64_t*>(c.base + BAR_OFF);
  c.ring.empty = c.ring.full + STAGES;
  c.ring.plan = plan;
  c.group = threadIdx.x >> 7;
  c.a = c.base + A_OFF + c.group * A_BYTES;
  c.pts = reinterpret_cast<float*>(c.base + PTS_OFF) + c.group * 6 * P;
  c.raw = reinterpret_cast<float*>(c.base + RAW_OFF) + c.group * 4 * P;
  return c;
}

// The MLP of one tile of a warpgroup, once this thread has written its part
// of the x_pe and d_pe A tiles: publish them, run the MLP, and leave raw
// [4][P] in core.raw, readable by the whole warpgroup on return.
template <bool FAST>
__device__ __forceinline__ void mlp_tile(Core& core, const Net& net) {
  wg_publish(core.group);
  mlp_core_wgmma<FAST>(core.a, core.raw, net, core.ring, core.group);
  wg_barrier(core.group);
}

// One tile of a warpgroup, once its [6][P] points are in core.pts
// (published by a warpgroup barrier): encode, then mlp_tile.
template <bool FAST>
__device__ __forceinline__ void run_tile(Core& core, const Net& net) {
  encode_tiles(core.pts, core.a, core.a + 5 * A_CHUNK_BYTES, net);
  mlp_tile<FAST>(core, net);
}

// Sets the dynamic shared memory and launches `kernel` on one persistent
// block per SM (at most `work` blocks). Returns a cudaError_t value.
template <typename... Params, typename... Args>
int launch_persistent(void (*kernel)(Params...), long long work, size_t smem_bytes,
                      cudaStream_t stream, Args... args) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > static_cast<size_t>(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(kernel, work < sms ? work : sms, smem_bytes, stream, args...);
}

}  // namespace wg
}  // namespace nerf
