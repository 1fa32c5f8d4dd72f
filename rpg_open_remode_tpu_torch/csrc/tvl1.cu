// Weighted TV-L1 primal-dual denoiser: one launch per iteration, ping-pong
// buffers for the carried state (u, u_head, p_x, p_y).
//
// Replaces both Pallas kernels of rpg_open_remode_tpu/ops/denoise_pallas.py:
// _kernel (wrapper tvl1_pallas, all iterations resident in VMEM) and
// _tiled_kernel (wrapper tvl1_pallas_tiled, 64-row bands with a 2C-row halo
// for frames beyond the VMEM budget). They compute the same iteration; the
// split exists only for the TPU's VMEM size, so one kernel serves every
// frame size here. Plain PyTorch version:
// rpg_open_remode_tpu_torch/ops/denoise_cuda.py:tvl1_plain (a loop of
// ops/denoise.tvl1_iteration).
//
// Iteration (reference discretization, src/depthmap_denoiser.cu:61-118):
// dual ascent with the clamped forward difference of u_head at the
// neighbour against u at the centre (at the east/south edge the neighbour
// is the pixel itself, so the gradient is u_head - u), projection onto the
// unit ball; primal descent with the zero-flux divergence (cur_px/cur_py
// zero at the east/south edge, west/north neighbours zero at the border);
// shrinkage toward the noisy input by tau*lambda; theta over-relaxation.
//
// What bounds it on an H100: per launch, bytes (6 fields read, 4 written:
// 40 B per pixel for ~40 flops); per solve, the 200 launches' fixed cost at
// 640x480, whose state (4.9 MB) stays in the 50 MB L2. Design: each block
// computes the dual step for its 32x8 tile plus a one-pixel west column and
// north row of halo in shared memory, recomputing those neighbours' p from
// the previous iteration's state with identical arithmetic, so the dual
// and primal half-steps need no grid-wide barrier. A persistent
// all-iterations kernel is later work.
//
// Built with -fmad=false (kernels.py): every operation rounds as in the
// plain version, in the same order. The iteration is not contractive for
// weights g > 1, so over 200 iterations an FMA's different rounding grows
// to ~1e-3 of the depth range; without contraction the kernel matches the
// plain version to float32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kBx = 32;
constexpr int kBy = 8;

struct Dual {
  float px, py;
};

__device__ __forceinline__ Dual dual_step(const float* __restrict__ u,
                                          const float* __restrict__ uh,
                                          const float* __restrict__ px,
                                          const float* __restrict__ py,
                                          const float* __restrict__ g, int y, int x,
                                          int h, int w, float sigma_d) {
  const size_t i = (size_t)y * w + x;
  const float uc = u[i];
  const float uh_e = x < w - 1 ? uh[i + 1] : uh[i];
  const float uh_s = y < h - 1 ? uh[i + w] : uh[i];
  const float gi = g[i];
  const float tpx = gi * (uh_e - uc) * sigma_d + px[i];
  const float tpy = gi * (uh_s - uc) * sigma_d + py[i];
  const float mag = sqrtf(tpx * tpx + tpy * tpy);
  const float scale = 1.0f / fmaxf(1.0f, mag);
  return {tpx * scale, tpy * scale};
}

__global__ void tvl1_iteration_kernel(
    const float* __restrict__ u, const float* __restrict__ uh,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ noisy, const float* __restrict__ g,
    float* __restrict__ u_o, float* __restrict__ uh_o, float* __restrict__ px_o,
    float* __restrict__ py_o, int h, int w, float sigma_d, float tau, float theta,
    float thr) {
  __shared__ float px_s[kBy][kBx + 1];  // column 0: west halo
  __shared__ float py_s[kBy + 1][kBx];  // row 0: north halo
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * kBx + tx;
  const int y = blockIdx.y * kBy + ty;
  const bool inside = x < w && y < h;

  Dual p = {0.0f, 0.0f};
  if (inside) {
    p = dual_step(u, uh, px, py, g, y, x, h, w, sigma_d);
    px_s[ty][tx + 1] = p.px;
    py_s[ty + 1][tx] = p.py;
    if (tx == 0)
      px_s[ty][0] = x > 0 ? dual_step(u, uh, px, py, g, y, x - 1, h, w, sigma_d).px
                          : 0.0f;
    if (ty == 0)
      py_s[0][tx] = y > 0 ? dual_step(u, uh, px, py, g, y - 1, x, h, w, sigma_d).py
                          : 0.0f;
  }
  __syncthreads();
  if (!inside) return;

  const size_t i = (size_t)y * w + x;
  const float cur_px = x >= w - 1 ? 0.0f : p.px;
  const float cur_py = y >= h - 1 ? 0.0f : p.py;
  const float div = cur_px - px_s[ty][tx] + cur_py - py_s[ty][tx];
  const float uc = u[i];
  const float gi = g[i];
  const float nz = noisy[i];
  const float temp_u = uc + tau * gi * div;
  const float diff = temp_u - nz;
  const float u_new = diff > thr ? temp_u - thr : (diff < -thr ? temp_u + thr : nz);
  u_o[i] = u_new;
  uh_o[i] = u_new + theta * (u_new - uc);
  px_o[i] = p.px;
  py_o[i] = p.py;
}

}  // namespace

// Runs `iterations` launches. State A = (a_u, a_uh, a_px, a_py) holds the
// initial state; iteration i reads A and writes B when i is even, and the
// reverse when odd, so the result ends in A for an even count, else in B.
extern "C" int remode_tvl1(const float* noisy, const float* g, float* a_u,
                           float* a_uh, float* a_px, float* a_py, float* b_u,
                           float* b_uh, float* b_px, float* b_py, int h, int w,
                           int iterations, float sigma_d, float tau, float theta,
                           float thr, void* stream) {
  const dim3 block(kBx, kBy);
  const dim3 grid((w + kBx - 1) / kBx, (h + kBy - 1) / kBy);
  for (int it = 0; it < iterations; ++it) {
    const bool even = (it % 2) == 0;
    tvl1_iteration_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        even ? a_u : b_u, even ? a_uh : b_uh, even ? a_px : b_px,
        even ? a_py : b_py, noisy, g, even ? b_u : a_u, even ? b_uh : a_uh,
        even ? b_px : a_px, even ? b_py : a_py, h, w, sigma_d, tau, theta, thr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
