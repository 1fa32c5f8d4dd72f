// The two 1-D passes of the two-pass homography warp: a vertical and a
// horizontal resampler, one thread per output pixel, looping over the C
// channels with one shared pair of weights.
//
// Replaces the Pallas kernels rpg_open_remode_tpu/ops/warp_pallas.py:
// _resample0_kernel (wrapper resample_rows_pallas) and _resample1_kernel
// (wrapper resample_cols_pallas). Plain PyTorch versions:
// rpg_open_remode_tpu_torch/ops/resample_cuda.py:resample_rows_plain and
// resample_cols_plain.
//
// Value: the tent-weight sum of rpg_open_remode_tpu/utils/warp.py:46-101,
// sum_j max(0, 1 - |q - j|) img[j] with q clamped to [0, n - 1], has at most
// two non-zero taps, so it is computed exactly as a 2-tap lerp. The Pallas
// tap windows (SPAN_V/SPAN_U), their XLA fallback and the -1 pad-row
// sentinels are TPU scheduling and are gone.
//
// What bounds it on an H100: bytes. ~3 flops per channel per output against
// 4 bytes written, the source read (mostly once, through L1/L2) and the
// coordinate field read once per output pixel. The design keeps one thread
// per output pixel so that neighbouring threads read neighbouring
// coordinates and write neighbouring outputs (coalesced), and reads the
// coordinate once for all C channels.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void lerp_taps(float q, int n, int* i0, int* i1, float* f) {
  q = fminf(fmaxf(q, 0.0f), (float)(n - 1));
  int j = (int)floorf(q);
  if (j > n - 2) j = n - 2;
  if (j < 0) j = 0;
  *i0 = j;
  *i1 = j + 1 < n ? j + 1 : j;
  *f = q - (float)j;
}

// out[c, yo, x] = lerp of img[c, :, x] at row q[yo, x]
__global__ void resample_rows_kernel(const float* __restrict__ img,  // [C, Hs, W]
                                     const float* __restrict__ q,    // [Ho, W]
                                     float* __restrict__ out,        // [C, Ho, W]
                                     int C, int hs, int w, int ho) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int yo = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || yo >= ho) return;
  int j0, j1;
  float f;
  lerp_taps(q[(size_t)yo * w + x], hs, &j0, &j1, &f);
  const float w0 = 1.0f - f;
  for (int c = 0; c < C; ++c) {
    const float* src = img + (size_t)c * hs * w;
    out[((size_t)c * ho + yo) * w + x] =
        w0 * __ldg(src + (size_t)j0 * w + x) + f * __ldg(src + (size_t)j1 * w + x);
  }
}

// out[c, y, xo] = lerp of img[c, y, :] at column u[y, xo]
__global__ void resample_cols_kernel(const float* __restrict__ img,  // [C, H, Ws]
                                     const float* __restrict__ u,    // [H, Wo]
                                     float* __restrict__ out,        // [C, H, Wo]
                                     int C, int h, int ws, int wo) {
  const int xo = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (xo >= wo || y >= h) return;
  int i0, i1;
  float f;
  lerp_taps(u[(size_t)y * wo + xo], ws, &i0, &i1, &f);
  const float w0 = 1.0f - f;
  for (int c = 0; c < C; ++c) {
    const float* src = img + ((size_t)c * h + y) * ws;
    out[((size_t)c * h + y) * wo + xo] = w0 * __ldg(src + i0) + f * __ldg(src + i1);
  }
}

}  // namespace

extern "C" int remode_resample_rows(const float* img, const float* q, float* out,
                                    int C, int hs, int w, int ho, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((w + block.x - 1) / block.x, (ho + block.y - 1) / block.y);
  resample_rows_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, q, out, C, hs,
                                                                 w, ho);
  return (int)cudaGetLastError();
}

extern "C" int remode_resample_cols(const float* img, const float* u, float* out,
                                    int C, int h, int ws, int wo, void* stream) {
  const dim3 block(128, 2);
  const dim3 grid((wo + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  resample_cols_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, u, out, C, h,
                                                                 ws, wo);
  return (int)cudaGetLastError();
}
