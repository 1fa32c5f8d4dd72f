// The two-pass homography warp as one kernel: each thread computes its
// output pixels' source coordinates from the homography in registers, runs
// both 1-D passes there, and writes the warped image (and, when asked, the
// source coordinates u and v). A batch of P homographies warps one shared
// source stack in one launch.
//
// Replaces the Pallas kernels rpg_open_remode_tpu/ops/warp_pallas.py:73
// (_resample0_kernel, the vertical pass) and :124 (_resample1_kernel, the
// horizontal pass), together with the coordinate fields that XLA fused
// outside them (rpg_open_remode_tpu/utils/warp.py:159-168). Plain PyTorch
// version: rpg_open_remode_tpu_torch/ops/warp_cuda.py:homography_warp_plain.
//
// Value (rpg_open_remode_tpu_torch/utils/warp.py, module docstring): for
// output pixel (xo, yo) = (x0 + col, y0 + row) of plane p under H (output
// pixel -> source pixel),
//   u, v   = homography_coords(H, xo, yo)
//   i0, i1, f = the clamped 2-tap lerp of u over [0, Ws - 1]
//   for X in {i0, i1}: q(X, yo) = v(x~, yo) where u(x~, yo) = X,
//     mid_X = the clamped lerp of column X of the image at row q(X, yo)
//   out    = (1 - f) mid_i0 + f mid_i1, for every channel with one set of
//            weights.
// Every expression is evaluated in the plain version's order, and the
// library is built with -fmad=false and IEEE division, so the result equals
// the plain version (and the former two kernels of csrc/resample.cu fed with
// the plain coordinate fields) bit for bit.
//
// What bounds it on an H100: bytes. The function reads the source stack
// (C Hs Ws floats) and the 9 floats of each homography, and writes
// P C Ho Wo floats (plus 2 P Ho Wo of u and v when asked); the coordinate
// math is ~48 operations a pixel and the lerps 12 a channel, far below the
// card's float rate for those bytes. What the design does about it:
//   - fields: no q, mid or u field goes through device memory; u and v are
//     written only when the caller uses them (want_uv);
//   - launches: one launch replaces the tens of elementwise launches of the
//     coordinate math and the two resampler launches, and a P axis in the
//     grid warps a batch of homographies (the 96 planes of a propagated
//     reseed) in one launch;
//   - stores: each thread owns VEC = 4 neighbouring output columns where
//     Wo % 4 == 0, so a warp writes 512 contiguous bytes with 16-byte
//     stores; neighbouring threads take neighbouring columns;
//   - taps: the source is read through the read-only data cache (__ldg):
//     the taps of a tile fall within a few source rows, which L1 and L2
//     serve after the first touch;
//   - tails: a block is 32 x 4 threads (a 128 x 4 pixel tile at VEC = 4),
//     so many small blocks share each SM and a 640x480 warp's last wave
//     is short; a ragged last tile returns its idle threads at once.
// On the H100 the small warps (C = 1 at 640x480, ~6 us) are held by each
// thread's chain of dependent loads and divisions rather than by bytes:
// reusing the vertical taps of shared source columns, two or one output
// columns a thread, and capping registers for occupancy were no faster.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 4;
// float32(1e-8), as PyTorch casts utils/warp.py's _EPS against float32
constexpr float EPS = 0x1.5798eep-27f;

__device__ __forceinline__ float safe(float den) {
  return fabsf(den) < EPS ? (den >= 0.0f ? EPS : -EPS) : den;
}

// ops/resample_cuda.py:_taps (and csrc/resample.cu:lerp_taps)
__device__ __forceinline__ void lerp_taps(float q, int n, int* i0, int* i1, float* f) {
  q = fminf(fmaxf(q, 0.0f), (float)(n - 1));
  int j = (int)floorf(q);
  if (j > n - 2) j = n - 2;
  if (j < 0) j = 0;
  *i0 = j;
  *i1 = j + 1 < n ? j + 1 : j;
  *f = q - (float)j;
}

struct Homography {
  float a, b, c, d, e, f, g, h, i;
};

// q(X, yo) of utils/warp.py: x~ = (X (h yo + i) - b yo - c) / (a - X g),
// q = (d x~ + e yo + f) / (g x~ + h yo + i); hy_i = h yo + i, byo = b yo,
// eyo = e yo
__device__ __forceinline__ float row_of(const Homography& H, float X, float hy_i, float byo,
                                        float eyo) {
  const float xt = (X * hy_i - byo - H.c) / safe(H.a - X * H.g);
  return (H.d * xt + eyo + H.f) / safe(H.g * xt + hy_i);
}

template <int VEC>
__global__ void __launch_bounds__(BX * BY)
homography_warp_kernel(const float* __restrict__ img,   // [C, Hs, Ws]
                       const float* __restrict__ Hm,    // [P, 3, 3]
                       float* __restrict__ out,         // [P, C, Ho, Wo]
                       float* __restrict__ u_out,       // [P, Ho, Wo] or null
                       float* __restrict__ v_out,       // [P, Ho, Wo] or null
                       int C, int hs, int ws, int ho, int wo, float x0, float y0,
                       int want_uv) {
  const int p = blockIdx.z;
  const int row = blockIdx.y * BY + threadIdx.y;
  const int col = (blockIdx.x * BX + threadIdx.x) * VEC;
  if (row >= ho || col >= wo) return;
  const float* hp = Hm + (size_t)p * 9;
  const Homography H{__ldg(hp + 0), __ldg(hp + 1), __ldg(hp + 2), __ldg(hp + 3), __ldg(hp + 4),
                     __ldg(hp + 5), __ldg(hp + 6), __ldg(hp + 7), __ldg(hp + 8)};

  const float yo = y0 + (float)row;
  const float byo = H.b * yo;
  const float eyo = H.e * yo;
  const float hyo = H.h * yo;
  const float hy_i = hyo + H.i;

  // per output column: the source offsets of its four taps and the weights
  int o00[VEC], o01[VEC], o10[VEC], o11[VEC];
  float fu[VEC], fq0[VEC], fq1[VEC];
  float us[VEC], vs[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float xo = x0 + (float)(col + k);
    // utils/warp.homography_coords
    const float den = safe(H.g * xo + hyo + H.i);
    us[k] = (H.a * xo + byo + H.c) / den;
    vs[k] = (H.d * xo + eyo + H.f) / den;
    int i0, i1, j0, j1;
    lerp_taps(us[k], ws, &i0, &i1, &fu[k]);
    lerp_taps(row_of(H, (float)i0, hy_i, byo, eyo), hs, &j0, &j1, &fq0[k]);
    o00[k] = j0 * ws + i0;
    o01[k] = j1 * ws + i0;
    lerp_taps(row_of(H, (float)i1, hy_i, byo, eyo), hs, &j0, &j1, &fq1[k]);
    o10[k] = j0 * ws + i1;
    o11[k] = j1 * ws + i1;
  }

  const size_t plane = (size_t)hs * ws;
  const size_t px = (size_t)row * wo + col;
  for (int c = 0; c < C; ++c) {
    const float* src = img + (size_t)c * plane;
    float o[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float m0 = (1.0f - fq0[k]) * __ldg(src + o00[k]) + fq0[k] * __ldg(src + o01[k]);
      const float m1 = (1.0f - fq1[k]) * __ldg(src + o10[k]) + fq1[k] * __ldg(src + o11[k]);
      o[k] = (1.0f - fu[k]) * m0 + fu[k] * m1;
    }
    float* dst = out + ((size_t)p * C + c) * ho * wo + px;
    if (VEC == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[k] = o[k];
    }
  }
  if (want_uv) {
    const size_t at = (size_t)p * ho * wo + px;
    if (VEC == 4) {
      *reinterpret_cast<float4*>(u_out + at) = make_float4(us[0], us[1], us[2], us[3]);
      *reinterpret_cast<float4*>(v_out + at) = make_float4(vs[0], vs[1], vs[2], vs[3]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        u_out[at + k] = us[k];
        v_out[at + k] = vs[k];
      }
    }
  }
}

template <int VEC>
void launch(const float* img, const float* H, float* out, float* u, float* v, int C, int hs,
            int ws, int ho, int wo, int P, float x0, float y0, int want_uv,
            cudaStream_t stream) {
  const dim3 block(BX, BY);
  const dim3 grid((wo + BX * VEC - 1) / (BX * VEC), (ho + BY - 1) / BY, P);
  homography_warp_kernel<VEC><<<grid, block, 0, stream>>>(img, H, out, u, v, C, hs, ws, ho,
                                                          wo, x0, y0, want_uv);
}

}  // namespace

// 16-byte stores need Wo % 4 == 0 (every row then starts 16-byte aligned
// in the allocator's aligned buffers); other widths store one float a
// column.
extern "C" int remode_homography_warp(const float* img, const float* H, float* out, float* u,
                                      float* v, int C, int hs, int ws, int ho, int wo, int P,
                                      float x0, float y0, int want_uv, void* stream) {
  if (wo % 4 == 0) {
    launch<4>(img, H, out, u, v, C, hs, ws, ho, wo, P, x0, y0, want_uv, (cudaStream_t)stream);
  } else {
    launch<1>(img, H, out, u, v, C, hs, ws, ho, wo, P, x0, y0, want_uv, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
