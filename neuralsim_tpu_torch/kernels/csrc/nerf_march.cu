// nerf_march.cu - the NeRF ray march for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_march_channels_kernel`, launched by
// `_fused_march_channels` / `fused_nerf_march` in
// neuralsim_tpu/kernels/raymarch.py. Same function: for rays o, d, unit
// viewdir [N,3] and depths z [N,S], every sample point x = o + d*z is
// positionally encoded (L=10 -> 63 ch, view L=4 -> 27 ch) and run through
// the whole NeRF MLP; the raw density is written to sigma [N,S] and the rgb
// logits to three planes rgb [3,N,S].
//
// Bound on this card: operations (see nerf_mlp.cuh). One point reads 4
// bytes of z (plus 36 bytes per ray) and writes 16 bytes, so the bytes
// bound is ~100x below the operations bound.
//
// Design: one block of 256 threads per tile of P=64 consecutive points of
// the flattened N*S sample index; each point finds its ray (idx / S), so a
// tile need not align with rays and the ragged tail is masked. Point
// generation and the channel-plane output are this file's; the encoding
// and the MLP are the shared core of nerf_mlp.cuh.

#include "nerf_mlp.cuh"

using namespace nerf;

namespace {

constexpr int SMEM_FLOATS = CORE_FLOATS + 6 * P;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
nerf_march_kernel(const float* __restrict__ rays_o,
                  const float* __restrict__ rays_d,
                  const float* __restrict__ viewdirs,
                  const float* __restrict__ z_vals,
                  long long total, int n_samples, Net net,
                  float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* pex = smem;              // [PX][P] position encoding
  float* ped = pex + PX * P;      // [PD][P] view encoding
  float* h = ped + PD * P;        // [W][P]  activations
  float* raw = h + W * P;         // [4][P]  r, g, b logits, sigma
  float* pts = raw + 4 * P;       // [6][P]  x, y, z, vx, vy, vz

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * P;

  // ---- point generation: x = o + d * z (no fma, like the JAX reference) --
  if (tid < P) {
    const long long g = base + tid;
    float x[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (g < total) {
      const long long ray = g / n_samples;
      const float zv = z_vals[g];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[c] = __fadd_rn(rays_o[ray * 3 + c], __fmul_rn(rays_d[ray * 3 + c], zv));
        x[3 + c] = viewdirs[ray * 3 + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) pts[c * P + tid] = x[c];
  }
  __syncthreads();

  encode_tile<BF16, false>(pts, pex, ped, net);
  __syncthreads();
  mlp_core<BF16>(pex, ped, h, raw, net);

  // ---- channel planes: sigma [N,S], rgb [3,N,S] --------------------------
  const int c = tid / P, p = tid % P;  // THREADS == 4 * P
  const long long g = base + p;
  if (g < total) {
    if (c == 3) {
      sigma[g] = raw[3 * P + p];
    } else {
      rgb[c * total + g] = raw[c * P + p];
    }
  }
}

}  // namespace

extern "C" {

// weights: host array of 2 * (depth + 4) device pointers, kernel then bias
// for each of pts_0 .. pts_{depth-1}, feature, alpha, views_0, rgb.
// Returns a cudaError_t value: 0 when the launch was accepted.
int nerf_march(const float* rays_o, const float* rays_d, const float* viewdirs,
               const float* z_vals, long long n_rays, int n_samples,
               const void* const* weights, int depth, unsigned skip_mask,
               int in_ch, int in_ch_views, int bf16, float* sigma, float* rgb,
               void* stream) {
  Net net;
  const int err = make_net(weights, depth, skip_mask, in_ch, in_ch_views, 0, &net);
  if (err != 0) return err;
  const long long total = n_rays * n_samples;
  const long long blocks = (total + P - 1) / P;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch(nerf_march_kernel<true>, blocks, smem, s, rays_o, rays_d,
                  viewdirs, z_vals, total, n_samples, net, sigma, rgb);
  }
  return launch(nerf_march_kernel<false>, blocks, smem, s, rays_o, rays_d,
                viewdirs, z_vals, total, n_samples, net, sigma, rgb);
}

}  // extern "C"
