// Integer-disparity ZNCC sweep on the rectified grid, one thread per pixel.
//
// Replaces the Pallas kernel rpg_open_remode_tpu/ops/sweep_pallas.py:
// _sweep_kernel (wrapper disparity_sweep). Its plain PyTorch version is
// rpg_open_remode_tpu_torch/ops/sweep_cuda.py:disparity_sweep_plain, a port
// of rect_match._sweep_xla.
//
// What bounds it on an H100: operations. Each (pixel, plane) pair that its
// band admits costs 3 patch sums (curr, curr^2, curr*ref: ~5 flops per tap,
// 125 at the 5x5 patch, 405 at 9x9) against ~36 bytes of unique input per
// pixel, so the fp32 pipe, not HBM, is the limit; the taps hit L1/L2.
// What the design does about it: each thread loops over its OWN band
// [ceil(dlo - 0.5), floor(dhi + 0.5)] and nothing else (the per-pixel band
// mask decides the result, so planes outside it cannot change it), skips
// pixels whose reference patch fails the validity/texture guard before any
// plane, and computes the reference template statistics once per pixel.
// The TPU blocking (bands, tiles, plane groups, block plane hulls, rolls)
// is gone. Shared-memory tiling of the taps is later work.
//
// Semantics kept exactly (ROADMAP queue 3): masked plane scores -1e30;
// best starts at -1 and its plane at -10; strict '>' keeps the lowest plane
// among ties; 'right' takes the score of plane best+1 even when masked;
// parabolic refinement only when both neighbours are > -5e29 and
// |den| > 1e-12, clipped to +-0.5; found = best >= threshold && best >= 0.
// Reads outside the buffers return 0 (the zero halo of the Pallas layout).
//
// Built with -fmad=false (kernels.py), and the patch sums add in the plain
// version's order, so the kernel rounds as the plain version does: the
// parabolic refinement divides by the NCC's second difference, which is
// small on smooth real texture, and an FMA's different rounding moved the
// refined disparity by more than 1e-3 on ~1/4 of a real frame's pixels.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kFltMin = 1.1754944e-38f;

__device__ __forceinline__ float load_or_zero(const float* __restrict__ p, int y,
                                              int x, int h, int w) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? __ldg(p + (size_t)y * w + x)
                                              : 0.0f;
}

__global__ void sweep_kernel(const float* __restrict__ curr,   // [H, W + 2 pad]
                             const float* __restrict__ xlim,   // [H, 2]
                             const float* __restrict__ ref,    // [H, W]
                             const float* __restrict__ valid,  // [H, W]
                             const float* __restrict__ dlo,    // [H, W]
                             const float* __restrict__ dhi,    // [H, W]
                             float* __restrict__ disp, float* __restrict__ ncc_out,
                             unsigned char* __restrict__ found, int h, int w,
                             int pad, int num_planes, int hp, float threshold,
                             int refine) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t idx = (size_t)y * w + x;
  const int wc = w + 2 * pad;
  const float area = (float)((2 * hp + 1) * (2 * hp + 1));

  float best = -1.0f, left = kNeg, right = kNeg, prev = kNeg;
  int bk = -10;

  // the plane range the band mask admits, clamped in float first: empty
  // bands carry +inf / -inf, which must not reach an int cast
  const float lo = dlo[idx] - 0.5f;
  const float hi = dhi[idx] + 0.5f;
  const float klo = fmaxf(ceilf(lo), 0.0f);
  const float khi = fminf(floorf(hi), (float)(num_planes - 1));
  if (!isnan(lo) && !isnan(hi) && klo <= khi) {
    // patch sums as the plain version's separable box sums add: each row
    // of the patch left to right, then the rows top to bottom
    float st = 0.0f, stt = 0.0f, sv = 0.0f;
    for (int dy = -hp; dy <= hp; ++dy) {
      float rt = 0.0f, rtt = 0.0f, rv = 0.0f;
      for (int dx = -hp; dx <= hp; ++dx) {
        const float r = load_or_zero(ref, y + dy, x + dx, h, w);
        rt += r;
        rtt += r * r;
        rv += load_or_zero(valid, y + dy, x + dx, h, w) > 0.999f ? 1.0f : 0.0f;
      }
      st += rt;
      stt += rtt;
      sv += rv;
    }
    const float denom_t = area * stt - st * st;
    if (sv > area - 0.5f && denom_t > 1e-10f) {
      const float xmin = xlim[2 * y], xmax = xlim[2 * y + 1];
      const int k0 = (int)klo, k1 = (int)khi;
      for (int k = k0; k <= k1; ++k) {
        const float delta = (float)k;
        const float xs = (float)x - delta;
        float ncc = kNeg;
        if (xs >= xmin && xs <= xmax) {
          const int cx = x + pad - k;  // curr_pad column of this pixel at plane k
          float si = 0.0f, sii = 0.0f, sit = 0.0f;
          for (int dy = -hp; dy <= hp; ++dy) {
            float ri = 0.0f, rii = 0.0f, rit = 0.0f;
            for (int dx = -hp; dx <= hp; ++dx) {
              const float c = load_or_zero(curr, y + dy, cx + dx, h, wc);
              const float r = load_or_zero(ref, y + dy, x + dx, h, w);
              ri += c;
              rii += c * c;
              rit += c * r;
            }
            si += ri;
            sii += rii;
            sit += rit;
          }
          const float num = area * sit - si * st;
          const float den_l = area * sii - si * si;
          if (den_l > 1e-10f) ncc = num * rsqrtf(fmaxf(den_l * denom_t, kFltMin));
        }
        if (ncc > best) {
          left = prev;
          right = kNeg;
          bk = k;
          best = ncc;
        } else if (bk == k - 1) {
          right = ncc;
        }
        prev = ncc;
      }
    }
  }

  float kf = (float)bk;
  if (refine) {
    const bool have = left > 0.5f * kNeg && right > 0.5f * kNeg;
    const float den = left - 2.0f * best + right;
    const float frac =
        (have && fabsf(den) > 1e-12f) ? 0.5f * (left - right) / den : 0.0f;
    kf += fminf(fmaxf(frac, -0.5f), 0.5f);
  }
  disp[idx] = kf;
  ncc_out[idx] = best;
  found[idx] = (best >= threshold && bk >= 0) ? 1 : 0;
}

}  // namespace

extern "C" int remode_sweep(const float* curr, const float* xlim, const float* ref,
                            const float* valid, const float* dlo, const float* dhi,
                            float* disp, float* ncc, unsigned char* found, int h,
                            int w, int pad, int num_planes, int patch_side,
                            float threshold, int refine, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      curr, xlim, ref, valid, dlo, dhi, disp, ncc, found, h, w, pad, num_planes,
      patch_side / 2, threshold, refine);
  return (int)cudaGetLastError();
}
