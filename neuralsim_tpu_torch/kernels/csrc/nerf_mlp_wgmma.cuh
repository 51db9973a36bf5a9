// nerf_mlp_wgmma.cuh - the NeRF MLP core on Hopper's tensor cores (wgmma),
// bf16 only.
//
// The bf16 instantiations of nerf_march.cu (replacing the Pallas TPU kernel
// `_march_channels_kernel` of neuralsim_tpu/kernels/raymarch.py),
// render_tile.cu (replacing `_render_tile_kernel`) and of nerf_mlp.cu's
// PROJECTION and ENCODED stages (replacing `_mlp_widepe_kernel` and
// `_mlp_kernel`) run their MLP here; every float32 instantiation, and
// nerf_mlp.cu's TRUE_COS stage (`_mlp_pe_kernel`) in both types, run the
// FP32 core of nerf_mlp.cuh. Same function as that core in bf16
// (nerf_mlp.cuh states the rounding and the net shapes taken: a narrower
// net comes zero-padded to W = 256), on tiles of 128 points.
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
//   - the encodings x_pe (up to 128 channels, in one or two 64-wide
//     chunks; 63 -> 64 by default) and d_pe (up to 64, in one chunk, of
//     which the views layer multiplies the k16 steps that hold channels:
//     27 -> 32 by default) are written once per tile into A tiles of their
//     own, zero past the channels;
//     the skip layer [x_pe, h] and the views layer [feature, d_pe] are two
//     partial sums into the same accumulators;
//   - the alpha (256 -> 1) and rgb (128 -> 3) heads run on the CUDA cores
//     from the accumulator registers, reduced over the four lanes of a row.
//
// Weight traffic. The host packs the weights once (raymarch.py
// pack_wgmma_weights) into bf16 chunks of 64 input rows, each in the exact
// shared-memory image the B descriptor reads ([N][64], 128-byte swizzle):
// 34 chunks of 32 KB (N = 256) and 5 of 16 KB (views, N = 128), 1.196 MB
// for the default 8x256 net. Thread 0 streams them with one cp.async.bulk
// each through a ring of STAGES = 3 stages (the Ring of nerf_mlp.cuh, which
// the FP32 core shares), so two chunks are in flight while one multiplies,
// and a warpgroup frees a chunk only after issuing its next one, so the
// tensor core has the next product queued.
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
constexpr int SMEM_ALIGN = 1024;                  // the swizzle's repeat

using Ring = nerf::Ring<STAGES>;

// A chunks of a net's x_pe: 1, or 2 when it has more than 64 channels.
inline int x_chunks(int in_ch) { return (in_ch + CHUNK_K - 1) / CHUNK_K; }

// Shared memory of the core, in bytes from a 1024-aligned base: the ring,
// each warpgroup's A tiles (nx x_pe chunks, h in 4, d_pe in 1: every
// layer's input chunks lie contiguous, in the order the ring delivers the
// weights), each warpgroup's [6][P] points and [4][P] raw outputs, then
// the ring's barriers.
__host__ __device__ constexpr int a_bytes(int nx) { return (nx + W / CHUNK_K + 1) * A_CHUNK_BYTES; }
__host__ __device__ constexpr int core_bytes(int nx) {
  return STAGES * CHUNK_BYTES + 2 * a_bytes(nx) + 2 * 10 * P * 4 + 2 * STAGES * 8;
}

// The packed weights of one net and its chunk order per tile: layer 0
// (x_pe), each trunk layer i >= 1 (x_pe first after a skip, then four h
// chunks), feature (four), then views (four feature chunks and one d_pe
// chunk, N = 128).
inline Plan make_plan(const void* packed, int depth, unsigned skip_mask, int in_ch) {
  const int nx = x_chunks(in_ch), h = W / CHUNK_K;
  const int n_wide = nx + h * (depth - 1) + nx * __builtin_popcount(skip_mask) + h;
  return Plan{static_cast<const unsigned char*>(packed), n_wide + h + 1, n_wide, CHUNK_BYTES,
              VIEWS_CHUNK_BYTES};
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

// The warpgroup's encodings, bf16, into its nx x_pe A chunks and its d_pe
// chunk (every column, zero past each encoding's channels); pts is its
// [6][P] point tile. Thread lane of warp w writes rows 16w + lane/4 (+8),
// channel pairs 2*(lane%4) + 8i.
__device__ __forceinline__ void encode_tiles(const float* pts, unsigned char* xt,
                                             unsigned char* dt, const Net& net, int nx) {
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int n_x = 2 * (CHUNK_K / 8) * nx;  // steps over the x_pe chunks
#pragma unroll 1
  for (int i = 0; i < n_x + 2 * (CHUNK_K / 8); ++i) {
    const bool view = i >= n_x;
    const int k = view ? i - n_x : i;
    const int row = row0 + 8 * (k & 1);
    const int col = 8 * (k >> 1) + 2 * (lane & 3);
    const float* xyz = pts + (view ? 3 * P : 0) + row;
    const int n_ch = view ? net.in_ch_views : net.in_ch;
    store_bf16x2(view ? dt : xt, row, col, encode<false>(xyz, P, col, n_ch),
                 encode<false>(xyz, P, col + 1, n_ch));
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

// The warpgroup's x_pe and d_pe A tiles (a: nx x_pe chunks, 4 h chunks,
// d_pe) from rows [0, here) of x_pe [*, in_ch] and d_pe [*, in_ch_views]:
// every column of each.
__device__ __forceinline__ void load_encodings(const float* x_pe, const float* d_pe, int here,
                                               unsigned char* a, const Net& net, int nx) {
  if (nx == 1) {
    load_encoding<CHUNK_K>(x_pe, net.in_ch, here, a);
  } else {
    load_encoding<2 * CHUNK_K>(x_pe, net.in_ch, here, a);
  }
  load_encoding<CHUNK_K>(d_pe, net.in_ch_views, here, a + (nx + W / CHUNK_K) * A_CHUNK_BYTES);
}

// The MLP on one warpgroup's 64 points, whose encodings encode_tiles left
// in its A tiles (a: nx x_pe chunks, 4 h chunks, d_pe; published): raw [4][P]
// (r, g, b logits, sigma) of the warpgroup, written by the lanes that hold
// each row. Consumes the tile's plan.per_tile chunks from the ring. FAST
// (net.fast_epilogue), nx (the x_pe chunks, 1 or 2) and the views layer's
// last k16 steps are template flags: as runtime values they cost the
// registers the 128 accumulators need: the kernel spills and runs slower
// (chip_variants.py times the runtime-nx variant).
template <bool FAST, int nx>
__device__ __forceinline__ void mlp_core_wgmma(unsigned char* a, float* raw, const Net& net,
                                               Ring& ring, int group) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const uint32_t x = smem_addr(a);            // x_pe, then h, then d_pe
  const uint32_t h = x + nx * A_CHUNK_BYTES;
  unsigned char* h_tile = a + nx * A_CHUNK_BYTES;
  float acc[W / 2];

  // ---- trunk -------------------------------------------------------------
  for (int i = 0; i < net.depth; ++i) {
    zero<W>(acc);
    if (i == 0) {
      layer_mma<W, 4>(acc, x, nx, ring);
    } else if ((net.skip_mask >> (i - 1)) & 1u) {
      layer_mma<W, 4>(acc, x, nx + 4, ring);  // [x_pe, h]
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
  // [feature, d_pe], over the d_pe chunk's k16 steps that hold channels
  switch ((net.in_ch_views + 15) / 16) {
    case 1: layer_mma<W / 2, 1>(accv, h, 5, ring); break;
    case 2: layer_mma<W / 2, 2>(accv, h, 5, ring); break;
    case 3: layer_mma<W / 2, 3>(accv, h, 5, ring); break;
    default: layer_mma<W / 2, 4>(accv, h, 5, ring); break;
  }
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
// core_bytes(nx) + SMEM_ALIGN plus their own part).
struct Core {
  unsigned char* base;  // 1024-aligned
  Ring ring;
  unsigned char* a;     // this warpgroup's A tiles: x_pe (nx chunks), h (4), d_pe
  float* pts;           // this warpgroup's [6][P]
  float* raw;           // this warpgroup's [4][P]
  int group;            // warpgroup 0 or 1
  int nx;               // x_pe chunks
};

// The ring is set up by Ring::init, called by every thread.
__device__ __forceinline__ Core make_core(void* dyn, const Plan& plan, int nx) {
  Core c;
  // offset from the shared array itself, so the compiler still knows every
  // pointer below is shared (plain st.shared / ld.shared, 32-bit addresses)
  const uint32_t pad = (SMEM_ALIGN - (smem_addr(dyn) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1);
  c.base = static_cast<unsigned char*>(dyn) + pad;
  unsigned char* tiles = c.base + STAGES * CHUNK_BYTES;  // after the ring
  c.ring.buf = c.base;
  c.ring.plan = plan;
  c.group = threadIdx.x >> 7;
  c.nx = nx;
  c.a = tiles + c.group * a_bytes(nx);
  c.pts = reinterpret_cast<float*>(tiles + 2 * a_bytes(nx)) + c.group * 6 * P;
  c.raw = reinterpret_cast<float*>(tiles + 2 * a_bytes(nx)) + 2 * 6 * P + c.group * 4 * P;
  c.ring.full = reinterpret_cast<uint64_t*>(tiles + 2 * a_bytes(nx) + 2 * 10 * P * 4);
  c.ring.empty = c.ring.full + STAGES;
  return c;
}

// The MLP of one tile of a warpgroup, once this thread has written its part
// of the x_pe and d_pe A tiles: publish them, run the MLP, and leave raw
// [4][P] in core.raw, readable by the whole warpgroup on return.
template <bool FAST>
__device__ __forceinline__ void mlp_tile(Core& core, const Net& net) {
  wg_publish(core.group);
  if (core.nx == 1) {
    mlp_core_wgmma<FAST, 1>(core.a, core.raw, net, core.ring, core.group);
  } else {
    mlp_core_wgmma<FAST, 2>(core.a, core.raw, net, core.ring, core.group);
  }
  wg_barrier(core.group);
}

// One tile of a warpgroup, once its [6][P] points are in core.pts
// (published by a warpgroup barrier): encode, then mlp_tile.
template <bool FAST>
__device__ __forceinline__ void run_tile(Core& core, const Net& net) {
  encode_tiles(core.pts, core.a, core.a + (core.nx + W / CHUNK_K) * A_CHUNK_BYTES, net, core.nx);
  mlp_tile<FAST>(core, net);
}

}  // namespace wg
}  // namespace nerf

// Bytes of the wgmma core's packed weights (raymarch.py pack_wgmma_weights);
// the view encoding always fits its one chunk. Defined once in each shared
// library, as the limits of nerf_mlp.cuh.
extern "C" long long nerf_wgmma_plan_bytes(int depth, unsigned skip_mask, int in_ch,
                                           int in_ch_views) {
  (void)in_ch_views;
  return nerf::wg::make_plan(nullptr, depth, skip_mask, in_ch).tile_bytes();
}
