// Weighted TV-L1 primal-dual denoiser: kSteps iterations per launch on
// shared-memory tiles, ping-pong buffers for the carried state
// (u, u_head, p_x, p_y) between launches.
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
// What bounds it on an H100: at 640x480 one iteration is ~0.3 M pixels of
// ~40 flops (with an IEEE square root and division each, which the plain
// version's rounding needs), under a microsecond of the card; a launch per
// iteration (the first design) paid ~5 us each, 200 per keyframe. Design
// (temporal blocking): a block loads its 64x40 tile with a kSteps-pixel
// halo on every side (72x48 cells), runs kSteps iterations there, and writes
// back the tile. One iteration moves information by one pixel in each
// direction (the dual step reads the east and south u_head, the primal step
// the west and north p), so the cells that are not on the image edge lose
// one valid ring per iteration and the tile is exact after kSteps; cells on
// the image edge apply its rules as the plain version does. Each of the
// block's 864 threads owns one column of the tile and every twelfth row of
// it (4 cells), and keeps their u, g and noisy input in registers; u_head
// and p, which neighbours read, live in shared memory (41 KB). Within an
// iteration the dual half-step updates each cell's p in place (it reads
// only its own p and the unchanged u, u_head), then the primal half-step
// its u and u_head (it reads only its own u and the unchanged p). The tile
// size puts one block on each SM at 640x480 (120 blocks) with
// (72 * 48) / (64 * 40) = 1.35 cell updates per output; 200 iterations are
// 50 launches.
//
// Built with -fmad=false (kernels.py): every operation rounds as in the
// plain version, in the same order. The iteration is not contractive for
// weights g > 1, so over 200 iterations an FMA's different rounding grows
// to ~1e-3 of the depth range; without contraction the kernel equals the
// plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTw = 64;                  // output tile
constexpr int kTh = 40;
constexpr int kSteps = 4;                // iterations per launch = halo width
constexpr int kAw = kTw + 2 * kSteps;    // tile with its halo: 72 x 48
constexpr int kAh = kTh + 2 * kSteps;
constexpr int kRowStep = 12;             // a thread's rows are kRowStep apart
constexpr int kThreads = kAw * kRowStep;
constexpr int kRows = kAh / kRowStep;    // cells per thread
static_assert(kAh % kRowStep == 0, "rows must split evenly over the threads");

__global__ void __launch_bounds__(kThreads)
    tvl1_steps_kernel(const float* __restrict__ u, const float* __restrict__ uh,
                      const float* __restrict__ px, const float* __restrict__ py,
                      const float* __restrict__ noisy, const float* __restrict__ g,
                      float* __restrict__ u_o, float* __restrict__ uh_o,
                      float* __restrict__ px_o, float* __restrict__ py_o, int h, int w,
                      int steps, float sigma_d, float tau, float theta, float thr) {
  __shared__ float suh[kAh * kAw];
  __shared__ float spx[kAh * kAw];
  __shared__ float spy[kAh * kAw];
  const int lx = threadIdx.x % kAw, ly0 = threadIdx.x / kAw;
  const int oy = blockIdx.y * kTh - kSteps;  // image row of the array's row 0
  const int gx = blockIdx.x * kTw - kSteps + lx;
  const bool col_in = gx >= 0 && gx < w;
  // the array's own edge (not the image's) reads its own cell or a zero: a
  // wrong value there reaches one ring further in per iteration
  const bool has_e = gx < w - 1 && lx < kAw - 1;
  const bool has_w = gx > 0 && lx > 0;
  const bool east_edge = gx >= w - 1;

  float ur[kRows], gr[kRows], nr[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ly = ly0 + j * kRowStep, gy = oy + ly, i = ly * kAw + lx;
    const bool in = col_in && gy >= 0 && gy < h;
    const size_t k = in ? (size_t)gy * w + gx : 0;
    ur[j] = in ? u[k] : 0.0f;
    gr[j] = in ? g[k] : 0.0f;
    nr[j] = in ? noisy[k] : 0.0f;
    suh[i] = in ? uh[k] : 0.0f;
    spx[i] = in ? px[k] : 0.0f;
    spy[i] = in ? py[k] : 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    // dual ascent, each cell's p in place
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int ly = ly0 + j * kRowStep, gy = oy + ly, i = ly * kAw + lx;
      if (!col_in || gy < 0 || gy >= h) continue;
      const float uc = ur[j];
      const float uh_e = has_e ? suh[i + 1] : suh[i];
      const float uh_s = gy < h - 1 && ly < kAh - 1 ? suh[i + kAw] : suh[i];
      const float gi = gr[j];
      const float tpx = gi * (uh_e - uc) * sigma_d + spx[i];
      const float tpy = gi * (uh_s - uc) * sigma_d + spy[i];
      const float mag = sqrtf(tpx * tpx + tpy * tpy);
      const float scale = 1.0f / fmaxf(1.0f, mag);
      spx[i] = tpx * scale;
      spy[i] = tpy * scale;
    }
    __syncthreads();
    // primal descent and over-relaxation: u in registers, u_head in place
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int ly = ly0 + j * kRowStep, gy = oy + ly, i = ly * kAw + lx;
      if (!col_in || gy < 0 || gy >= h) continue;
      const float cur_px = east_edge ? 0.0f : spx[i];
      const float cur_py = gy >= h - 1 ? 0.0f : spy[i];
      const float west = has_w ? spx[i - 1] : 0.0f;
      const float north = gy > 0 && ly > 0 ? spy[i - kAw] : 0.0f;
      const float div = cur_px - west + cur_py - north;
      const float uc = ur[j];
      const float gi = gr[j];
      const float nz = nr[j];
      const float temp_u = uc + tau * gi * div;
      const float diff = temp_u - nz;
      const float u_new = diff > thr ? temp_u - thr : (diff < -thr ? temp_u + thr : nz);
      ur[j] = u_new;
      suh[i] = u_new + theta * (u_new - uc);
    }
    __syncthreads();
  }

  if (lx < kSteps || lx >= kSteps + kTw || !col_in) return;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ly = ly0 + j * kRowStep, gy = oy + ly, i = ly * kAw + lx;
    if (ly < kSteps || ly >= kSteps + kTh || gy >= h) continue;
    const size_t k = (size_t)gy * w + gx;
    u_o[k] = ur[j];
    uh_o[k] = suh[i];
    px_o[k] = spx[i];
    py_o[k] = spy[i];
  }
}

}  // namespace

// Runs `iterations` iterations in launches of up to kSteps and writes the
// number of launches to *launches. State A = (a_u, a_uh, a_px, a_py) holds
// the initial state; launch l reads A and writes B when l is even, and the
// reverse when odd, so the result ends in A for an even number of launches,
// else in B.
extern "C" int remode_tvl1(const float* noisy, const float* g, float* a_u,
                           float* a_uh, float* a_px, float* a_py, float* b_u,
                           float* b_uh, float* b_px, float* b_py, int h, int w,
                           int iterations, float sigma_d, float tau, float theta,
                           float thr, int* launches, void* stream) {
  const dim3 grid((w + kTw - 1) / kTw, (h + kTh - 1) / kTh);
  int l = 0;
  for (int it = 0; it < iterations; it += kSteps, ++l) {
    const bool even = (l % 2) == 0;
    const int steps = iterations - it < kSteps ? iterations - it : kSteps;
    tvl1_steps_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        even ? a_u : b_u, even ? a_uh : b_uh, even ? a_px : b_px,
        even ? a_py : b_py, noisy, g, even ? b_u : a_u, even ? b_uh : a_uh,
        even ? b_px : a_px, even ? b_py : a_py, h, w, steps, sigma_d, tau, theta, thr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      *launches = l;
      return (int)err;
    }
  }
  *launches = l;
  return 0;
}
