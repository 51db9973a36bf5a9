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
//     ReLU(0 + 0) = 0 and meet zero rows), at most MAX_DEPTH (64) trunk
//     layers with any skips (the bits of a 64-bit skip mask), encodings of
//     multires and multires_views <= 128 (MAX_X, MAX_D: the frequencies
//     2^k, k < 128, that a float32 holds), and what fits in a block's shared
//     memory (the cores' *_smem_bytes, which the wrapper checks: every net
//     up to multires 42 / multires_views 20 fits both cores at every
//     width);
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
// FP32 core. Bound on the card: operations. One point of the default net
// costs 593,408 multiply-adds (1.19 MFLOP) and moves at most 376 bytes, so a
// kernel on this core is bound by the FP32 rate (67 TFLOP/s on an H100 SXM:
// 27.86 ms for 8192 rays x 192 samples). The products are fmaf on the FP32
// pipes: true float32 like the JAX package's Precision.HIGHEST, never TF32.
//
// What bounds such a core below that rate: the weight reads (a W-wide
// layer product feeds each FMA a weight; read by every warp from L1 they
// compete with the FMAs), the weight stream from L2 (the whole net per
// tile), the issue slots of the shared-memory loads, and bank conflicts in
// the epilogue's column stores. The design:
//   - persistent blocks (one per SM) of 256 threads over tiles of TILE
//     points: 128 at W = 256, 64 at W = 512 and 32 at W = 1024, so that a
//     block's layer output stays W x TILE = 32,768 values, 128 accumulators
//     a thread; half that where a net's encodings leave no room (0.85 of the
//     speed per point at W = 256);
//   - the host packs the weights once per weight set (raymarch.py
//     pack_f32_weights) into chunks of 16 input rows, in the order the core
//     consumes them, each row's columns permuted so that a thread's columns
//     {cg + 16j} are float4 lying beside its neighbours'. The chunks run
//     through a 2-stage ring (Ring below) of 16 KB stages, KC = 16 rows of
//     W = 256 (8 rows of W = 512 and 4 of W = 1024: the ring delivers each
//     packed chunk as two or four; with 16-row stages a 64-point tile of
//     W = 512 needs 233,504 B, 1 KB over what a block may have), so the
//     weights are shared-memory reads common to all eight warps, and the
//     next chunk lands while this one multiplies. Each 128-point tile of the default net reads the
//     2.38 MB of chunks from L2: 29 GB per launch at 8192 x 192 points,
//     0.8 TB/s at 38 ms, well inside the L2's rate;
//   - each thread owns a PT x W/16 register tile (8 points x 16 columns at
//     W = 256, 4 x 32 at 512, 2 x 64 at 1024): per input row one or two
//     activation loads (broadcast within a half-warp) and W/64
//     conflict-free float4 weight loads feed 128 fmaf. At W = 1024 that is
//     16 weight loads per 128 fmaf (4 at W = 256), and each 32-point tile
//     reads the whole net's packed chunks from L2 (36.2 MB for the 8x1024
//     default-shaped net: 1.78 TB per 8192 x 192 launch); a simple core
//     that is right, whose second pass is queued (ROADMAP.md);
//   - activations never leave shared memory: feature-major [row][point]
//     tiles with a row stride of TILE + 4 floats, so the epilogue's stores
//     by 16 lanes to 16 rows fall in distinct banks;
//   - the skip concat [x_pe, h] and the views concat [feature, d_pe] are one
//     run of chunks each, read from two tiles; the alpha and rgb heads are
//     reduced from the registers of the last trunk and the views layer over
//     the 16 lanes that share a point group.
// It runs at 68-71% of the FP32 peak at 8192 x 64 and x 192 points on an
// H100 (PERF.md); variants of it are timed by chip_variants.py.
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
// anyway, and so does the port (2^k is built from its exponent bits, so k
// stops at 127: multires <= 128).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nerf {

constexpr int P = 64;          // points per warpgroup of the wgmma core
constexpr int THREADS = 256;   // 8 warps per block, both cores
constexpr int MAX_W = 1024;    // widest trunk; both cores take W = 256, 512 and 1024
constexpr int MAX_X = 3 + 6 * 128;  // channels of the position encoding (multires <= 128)
constexpr int MAX_D = 3 + 6 * 128;  // channels of the view encoding
constexpr int MAX_DEPTH = 64;  // trunk layers: the bits of a skip mask
constexpr int MAX_LAYERS = MAX_DEPTH + 4;  // trunk + feature, alpha, views, rgb
constexpr float HALF_PI = 1.57079632679489661923f;

struct Net {
  // biases [out] of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb,
  // padded to the core's width; the alpha [W][1] and rgb [W/2][3] kernels
  // (row-major). The trunk, feature and views kernels reach the cores only
  // as packed chunks (Plan), so their pointers stay out of the parameters.
  const float* b[MAX_LAYERS];
  const float* alpha_k;
  const float* rgb_k;
  // bit i of the 64-bit skip mask (word i / 32): layer i's output is
  // concatenated with x_pe; read a word at a time, as the biases are
  unsigned skip_mask[2];
  int depth;
  int in_ch;
  int in_ch_views;
  int fast_epilogue;
};
// a kernel parameter, passed by value beside a Plan and a few pointers:
// far inside the 4 KB a launch's parameters may take
static_assert(sizeof(Net) <= 1024, "Net outgrows the kernel parameter space");

// The Net of a C call: weights is a host array of 2 * (depth + 4) device
// pointers, kernel then bias per layer, padded to a trunk of `width` (256,
// 512 or 1024). Returns a cudaError_t value.
inline int make_net(const void* const* weights, int width, int depth,
                    unsigned long long skip_mask, int in_ch, int in_ch_views, int fast_epilogue,
                    Net* net) {
  if ((width != 256 && width != 512 && width != MAX_W) || depth + 4 > MAX_LAYERS || depth < 1 ||
      in_ch < 1 || in_ch > MAX_X || in_ch_views < 1 || in_ch_views > MAX_D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *net = Net{};
  for (int i = 0; i < depth + 4; ++i) {
    net->b[i] = static_cast<const float*>(weights[2 * i + 1]);
  }
  net->alpha_k = static_cast<const float*>(weights[2 * (depth + 1)]);
  net->rgb_k = static_cast<const float*>(weights[2 * (depth + 3)]);
  net->depth = depth;
  net->skip_mask[0] = static_cast<unsigned>(skip_mask);
  net->skip_mask[1] = static_cast<unsigned>(skip_mask >> 32);
  net->in_ch = in_ch;
  net->in_ch_views = in_ch_views;
  net->fast_epilogue = fast_epilogue;
  return 0;
}

// Whether trunk layer i's output is concatenated with x_pe.
__device__ __forceinline__ bool skips_after(const Net& net, int i) {
  return (net.skip_mask[i >> 5] >> (i & 31)) & 1u;
}

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
// its exponent bits: k reaches 41).
template <bool TRUE_COS>
__device__ __forceinline__ float encode(const float* xyz, int stride, int c, int n_ch) {
  if (c < 3) return xyz[c * stride];
  if (c >= n_ch) return 0.f;
  const int j = c - 3;
  const int k = j / 6;
  const int r = j - 6 * k;
  const int dim = r % 3;
  const float y = __fmul_rn(xyz[dim * stride], __int_as_float((127 + k) << 23));
  if constexpr (TRUE_COS) {
    return r < 3 ? sinf(y) : cosf(y);
  } else {
    return sinf(__fadd_rn(y, r < 3 ? 0.f : HALF_PI));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A net's packed weights and their chunk order per tile: chunks [0,
// n_wide) of a tile (trunk and feature layers, W columns) take wide_bytes
// each, the rest (the views layer, W/2 columns) narrow_bytes. With ways = 2
// the counts are each warpgroup's share (Ring<STAGES, true>): it takes
// `run` consecutive pieces of every 2 * run wide ones and every other
// narrow one.
struct Plan {
  const unsigned char* packed;
  int per_tile;
  int n_wide;
  int wide_bytes;
  int narrow_bytes;
  int ways = 1;
  int run = 1;

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
      // this warpgroup's piece q: wide pieces come in runs of plan.run (1
      // or 2) out of every 2 * run, narrow ones every other one
      const int g = threadIdx.x >> 7, sh = plan.run - 1;
      off = wide ? static_cast<size_t>(((q >> sh) << (sh + 1)) + (g << sh) + (q & sh)) *
                       plan.wide_bytes
                 : static_cast<size_t>(2 * plan.n_wide) * plan.wide_bytes +
                       static_cast<size_t>(2 * (q - plan.n_wide) + g) * plan.narrow_bytes;
    } else {
      off = wide ? static_cast<size_t>(q) * plan.wide_bytes
                 : static_cast<size_t>(plan.n_wide) * plan.wide_bytes +
                       static_cast<size_t>(q - plan.n_wide) * plan.narrow_bytes;
    }
    const uint32_t bar = smem_addr(full + s);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(buf + s * plan.wide_bytes)), "l"(plan.packed + off), "r"(bytes),
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

constexpr int STAGES = 2;                     // weight ring depth
constexpr int PACK_ROWS = 16;                 // input rows of a packed chunk
constexpr int WIDE_BYTES = 16 * 1024;         // a ring stage: KC rows of W columns
constexpr int NARROW_BYTES = WIDE_BYTES / 2;  // the same rows of the views layer's W/2

// Input rows per ring stage at trunk width W: 16 at W = 256, 8 at 512, 4 at
// 1024.
__host__ __device__ constexpr int kc(int width) { return WIDE_BYTES / (4 * width); }

// Points per tile at trunk width W, and the smaller tile where a net's
// encodings leave no room for it: 128 / 64 at W = 256, 64 / 32 at 512,
// 32 / 16 at 1024.
__host__ __device__ constexpr int big_tile(int width) { return 128 * 256 / width; }

// Rows of an encoding tile: the channels rounded up to whole packed chunks.
inline int rows(int channels) { return (channels + PACK_ROWS - 1) / PACK_ROWS * PACK_ROWS; }

// The chunk order per tile, in ring stages of kc(width) rows: layer 0
// (x_pe), each trunk layer i >= 1 (x_pe first after a skip, then the h
// chunks), the feature layer, then the views layer (the feature's h chunks,
// then the d_pe chunks, W/2 columns). A packed chunk of 16 rows is two
// stages at W = 512 and four at 1024: its rows lie contiguous.
inline Plan make_plan(const void* packed, int width, int depth, unsigned long long skip_mask,
                      int in_ch, int in_ch_views) {
  const int k = kc(width);
  const int nx = rows(in_ch) / k, nd = rows(in_ch_views) / k, h = width / k;
  const int n_wide = nx + h * (depth - 1) + nx * __builtin_popcountll(skip_mask) + h;
  return Plan{static_cast<const unsigned char*>(packed), n_wide + h + nd, n_wide, WIDE_BYTES,
              NARROW_BYTES};
}

// Shared memory of the core for tiles of `tile` points at trunk width
// `width`, rx rows of x_pe and rd of d_pe: the ring, the activation tiles h
// [W], x [rx], d [rd] (row stride tile + 4), the points [6][tile], the raw
// outputs [4][tile], then the ring's barriers. Every part starts 16-byte
// aligned.
__host__ __device__ constexpr int core_bytes(int tile, int width, int rx, int rd) {
  return STAGES * WIDE_BYTES + (width + rx + rd) * (tile + 4) * 4 + 10 * tile * 4 +
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

template <int TILE, int W>
struct Core {
  Ring<STAGES> ring;
  float* h;    // [W][TILE + 4] activations
  float* x;    // [rx][TILE + 4] position encoding
  float* d;    // [rd][TILE + 4] view encoding
  float* pts;  // [6][TILE] x, y, z, vx, vy, vz
  float* raw;  // [4][TILE] r, g, b logits, sigma
  int rx;
  int rd;
};

// Pointers into the core's shared memory at the start of the kernel's
// dynamic shared buffer (core_bytes(TILE, W, rx, rd) of it); the ring is set
// up by Ring::init, called by every thread.
template <int TILE, int W>
__device__ __forceinline__ Core<TILE, W> make_core(void* dyn, const Plan& plan, int rx, int rd) {
  constexpr int HS = TILE + 4;
  Core<TILE, W> c;
  unsigned char* base = static_cast<unsigned char*>(dyn);
  c.ring.buf = base;
  c.h = reinterpret_cast<float*>(base + STAGES * WIDE_BYTES);
  c.x = c.h + W * HS;
  c.d = c.x + rx * HS;
  c.pts = c.d + rd * HS;
  c.raw = c.pts + 6 * TILE;
  c.ring.full = reinterpret_cast<uint64_t*>(c.raw + 4 * TILE);
  c.ring.empty = c.ring.full + STAGES;
  c.ring.plan = plan;
  c.rx = rx;
  c.rd = rd;
  return c;
}

// Thread roles: column group cg (columns {cg + 16j}) and point group pg
// (points [PT*pg, PT*pg + PT)); a half-warp shares its point group.
__device__ __forceinline__ int col_group() { return threadIdx.x & 15; }
__device__ __forceinline__ int point_group() { return threadIdx.x >> 4; }

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
// w[k][cg + 16 (4q + e)]: act points at the thread's first point in row 0
// of a [KC][HS] activation block, w at the thread's first float4 in row 0
// of a packed chunk (NQ float4 of each row per thread, 64 floats apart).
template <int PT, int NQ, int HS, int KC>
__device__ __forceinline__ void chunk_fma(float (&acc)[PT][4 * NQ], const float* act,
                                          const float* w) {
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    float a[PT];
    load_points<PT>(a, act + k * HS);
    float b[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(w + k * (64 * NQ) + 64 * q);
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

// The products of one layer: acc += [a0 (n0 chunks of rows), a1 (n1)] . W
// over the next n0 + n1 chunks of the ring.
template <int PT, int NQ, int HS, int KC>
__device__ __forceinline__ void layer(float (&acc)[PT][4 * NQ], const float* a0, int n0,
                                      const float* a1, int n1, Ring<STAGES>& ring) {
  const int off = point_group() * PT;
  const int wcol = 4 * col_group();
#pragma unroll 1
  for (int c = 0; c < n0 + n1; ++c) {
    const float* act = c < n0 ? a0 + c * (KC * HS) : a1 + (c - n0) * (KC * HS);
    chunk_fma<PT, NQ, HS, KC>(acc, act + off, ring.acquire_floats() + wcol);
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
  constexpr int PT = TILE / 16;   // points of a thread
  constexpr int C = W / 16;       // columns of a thread
  constexpr int HS = TILE + 4;
  constexpr int KC = kc(W);
  const int cg = col_group();
  const int p0 = point_group() * PT;
  const int depth = net.depth;
  const int nx = core.rx / KC, nd = core.rd / KC;
  float acc[PT][C];

  // ---- trunk layers 0 .. depth-1, then the feature layer (i == depth) -----
#pragma unroll 1
  for (int i = 0; i <= depth; ++i) {
    zero(acc);
    const bool with_x = i == 0 || (i < depth && skips_after(net, i - 1));
    layer<PT, C / 4, HS, KC>(acc, core.x, with_x ? nx : 0, core.h, i == 0 ? 0 : W / KC,
                             core.ring);
    __syncthreads();  // every warp has read h
    const float* bias = net.b[i];
    const bool relu = i < depth;  // the feature layer has none
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = cg + 16 * j;
      const float b = __ldg(bias + col);
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        float v = acc[p][j] + b;
        if (relu) v = fmaxf(v, 0.f);
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
      // density head (alpha [W][1]) on the trunk output in the registers
      const float* ak = net.alpha_k;
      float s[PT];
#pragma unroll
      for (int p = 0; p < PT; ++p) s[p] = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float w = __ldg(ak + cg + 16 * j);
#pragma unroll
        for (int p = 0; p < PT; ++p) s[p] = fmaf(acc[p][j], w, s[p]);
      }
      const float b = __ldg(net.b[depth + 1]);
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        const float t = group_sum(s[p]);
        if (cg == 0) core.raw[3 * TILE + p0 + p] = t + b;
      }
    }
    __syncthreads();
  }

  // ---- views layer: [feature, d_pe] -> W/2, ReLU; then the rgb head ------
  float accv[PT][C / 2];
  zero(accv);
  layer<PT, C / 8, HS, KC>(accv, core.h, W / KC, core.d, nd, core.ring);
  const float* vb = net.b[depth + 2];
  const float* rk = net.rgb_k;
  float s[3][PT];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int p = 0; p < PT; ++p) s[c][p] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < C / 2; ++j) {
    const int col = cg + 16 * j;
    const float b = __ldg(vb + col);
    const float w[3] = {__ldg(rk + 3 * col), __ldg(rk + 3 * col + 1), __ldg(rk + 3 * col + 2)};
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const float v = fmaxf(accv[p][j] + b, 0.f);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c][p] = fmaf(v, w[c], s[c][p]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float b = __ldg(net.b[depth + 3] + c);
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const float t = group_sum(s[c][p]);
      if (cg == 0) core.raw[c * TILE + p0 + p] = t + b;
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
int nerf_max_layers() { return nerf::MAX_LAYERS; }
int nerf_max_in_ch() { return nerf::MAX_X; }
int nerf_max_in_ch_views() { return nerf::MAX_D; }
// the dynamic shared memory a block of the current device may opt into
int nerf_smem_optin() {
  int bytes = 0;
  return nerf::smem_optin(&bytes) == 0 ? bytes : 0;
}
// bytes of the FP32 core's packed weights (raymarch.py pack_f32_weights)
long long nerf_f32_plan_bytes(int width, int depth, unsigned long long skip_mask, int in_ch,
                              int in_ch_views) {
  return nerf::f32::make_plan(nullptr, width, depth, skip_mask, in_ch, in_ch_views).tile_bytes();
}
// shared memory of the FP32 core's smallest tile for a net
int nerf_f32_smem_bytes(int width, int in_ch, int in_ch_views) {
  return nerf::f32::smallest_bytes(width, in_ch, in_ch_views);
}
}
