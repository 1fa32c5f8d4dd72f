// The inverse-depth plane sweep of the PLANE_SWEEP regime in one kernel:
// for each reference pixel of a tile, every plane's bilinear warp of the
// current image, the three 'valid' box sums (s_i, s_ii, s_it against the
// reference), the ZNCC, the visibility, band and segment masks and the
// running best with its neighbours, then the sub-plane parabolic
// refinement and the projection of the best depth.
//
// Replaces no Pallas kernel: the JAX package leaves this loop to XLA, which
// fuses it. Plain PyTorch version:
// rpg_open_remode_tpu_torch/ops/planesweep_cuda.py:planesweep_match_plain
// (the loop of epipolar.match_planesweep_tile), ~103 whole-image PyTorch
// kernels a plane, ~13,000 a frame at 127 planes.
//
// Value: every expression is evaluated in the plain version's order, each
// PyTorch operation rounded once as its own kernel rounds it. The library
// is built with -fmad=false and IEEE division and square root; rsqrtf is
// the CUDA math library's, which torch.rsqrt calls. In particular:
//   - _project_depth is fx * px / pz + cx with px = Rf * d + t;
//   - 1.0 / tensor is reciprocal(tensor) * 1.0, an IEEE division;
//   - utils/interp.bilinear: the coordinates clamped (NaN passes), floor,
//     the lerps top = i00 + fu * (i01 - i00), then top + fv * (bot - top);
//   - each box sum adds its window in order, columns first, then rows
//     (window_sum(window_sum(x, side, 1), side, 0)), over products rounded
//     before they are added;
//   - ncc = num * rsqrt(den + FLT_MIN) and the strict > of the running best.
// Rf_ext (the bearings rotated into the current frame) and the plane set
// (inv_lo, inv_step) are PyTorch operations before the launch, read here.
//
// What bounds it on an H100: operations. A frame at 640x480 and 127 planes
// scores 39.0 M (pixel, plane) pairs at ~12 * hp + 11 operations each
// (ops/accounting.py): 1.37 GFLOP, ~0.02 ms at 67 TFLOP/s, against ~16 MB
// of planes read and written once, ~0.005 ms at 3.35 TB/s. What the design
// does about it:
//   - fields: one block takes a tile of 32 x 8 reference pixels with its
//     p-pixel halo; the warped window, its three horizontal sums and the
//     reference window live in shared memory, the running best (best,
//     best_k, left, right, prev) and each pixel's band and segment in
//     registers, for all planes: no per-plane plane goes through device
//     memory (the plain version writes and reads ~100 whole-image
//     temporaries a plane);
//   - launches: one launch replaces ~13,000;
//   - work: each pixel's prologue (sigma, the band, the projections of mu
//     and of the band's ends, the segment's half length) runs once, not per
//     plane, and the window's rotated bearings stay in registers;
//   - skipping: a plane for which no pixel of the tile is visible, in its
//     band and within its segment scores -1e30 everywhere in the plain
//     version; the block skips its warp and sums (one vote,
//     __syncthreads_or) and only shifts prev and right as the plain loop
//     does. The skipped (tile, plane) pairs and all pairs are counted on
//     the device (remode_planesweep_plane_counts);
//   - shape: the patch radius is a template parameter (patch sides 5 to
//     17), the plane count and the tile and image extents runtime ints, so
//     one kernel serves the whole image with a clamped halo ("sweep" mode,
//     the PLANE_SWEEP regime) and the mesh's tiles, whose current image is
//     the whole image.

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;                     // tile width: a warp's row
constexpr int kTY = 8;                      // tile height
constexpr int kThreads = kTX * kTY;         // one output a thread
// the float32 values PyTorch gives the plain version's Python scalars
constexpr float kNeg = (float)-1e30;                  // _NEG
constexpr float kHalfNeg = (float)(-1e30 * 0.5);      // _NEG * 0.5
constexpr float kFltMin = (float)1.1754944e-38;       // _FLT_MIN
constexpr float kDenomMin = (float)1e-12;

// (tile, plane) pairs skipped, and in all, since the last reset
__device__ unsigned long long g_plane_counts[2];

// torch.clamp: NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// The frame's scalars, the same for every pixel.
struct Frame {
  float fx, fy, cx, cy;
  float t0, t1, t2;     // translation of T_curr_ref
};

// epipolar._project_depth at depth d on the rotated bearing (r0, r1, r2)
__device__ __forceinline__ void project(const Frame& F, float r0, float r1, float r2, float d,
                                        float& u, float& v, float& z) {
  const float px = r0 * d + F.t0;
  const float py = r1 * d + F.t1;
  z = r2 * d + F.t2;
  u = F.fx * px / z + F.cx;
  v = F.fy * py / z + F.cy;
}

// utils/interp.bilinear of img [height, width] at (u, v), clamp addressing
__device__ __forceinline__ float bilinear(const float* __restrict__ img, int height, int width,
                                          float u, float v) {
  u = clamp(u, 0.0f, (float)(width - 1));
  v = clamp(v, 0.0f, (float)(height - 1));
  const float u0f = floorf(u);
  const float v0f = floorf(v);
  const float fu = u - u0f;
  const float fv = v - v0f;
  // a NaN coordinate gives NaN whatever is read: keep the read in bounds
  const int u0 = min(max((int)u0f, 0), width - 1);
  const int v0 = min(max((int)v0f, 0), height - 1);
  const int u1 = min(u0 + 1, width - 1);
  const int v1 = min(v0 + 1, height - 1);
  const float i00 = __ldg(img + v0 * width + u0);
  const float i01 = __ldg(img + v0 * width + u1);
  const float i10 = __ldg(img + v1 * width + u0);
  const float i11 = __ldg(img + v1 * width + u1);
  const float top = i00 + fu * (i01 - i00);
  const float bot = i10 + fu * (i11 - i10);
  return top + fv * (bot - top);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
planesweep_match_kernel(const float* __restrict__ ref_ext, const float* __restrict__ Rf_ext,
                        const float* __restrict__ mu, const float* __restrict__ sigma_sq,
                        const float* __restrict__ sum_templ,
                        const float* __restrict__ const_templ_denom,
                        const float* __restrict__ curr, const float* __restrict__ T,
                        const float* __restrict__ fx, const float* __restrict__ fy,
                        const float* __restrict__ cx, const float* __restrict__ cy,
                        const float* __restrict__ inv_lo_p, const float* __restrict__ inv_step_p,
                        unsigned char* __restrict__ found, float* __restrict__ u_out,
                        float* __restrict__ v_out, float* __restrict__ best_out, int th, int tw,
                        int height, int width, int num_planes, float area, float m, float u_end,
                        float v_end, float sigma_band, float min_depth, float max_extent,
                        float ncc_threshold, int refine) {
  constexpr int kSide = 2 * P + 1;
  constexpr int kEX = kTX + 2 * P;            // the window: the tile and its halo
  constexpr int kEY = kTY + 2 * P;
  constexpr int kExt = kEX * kEY;
  constexpr int kPerThread = (kExt + kThreads - 1) / kThreads;
  __shared__ float s_ref[kExt];
  __shared__ float s_w[kExt];
  __shared__ float s_i[kEY * kTX];            // horizontal sums of w, w * w, w * ref
  __shared__ float s_ii[kEY * kTX];
  __shared__ float s_it[kEY * kTX];

  const int tid = threadIdx.x;
  const int lx = tid % kTX, ly = tid / kTX;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int ew = tw + 2 * P, eh = th + 2 * P;
  const int eplane = ew * eh;

  Frame F;
  F.fx = __ldg(fx);
  F.fy = __ldg(fy);
  F.cx = __ldg(cx);
  F.cy = __ldg(cy);
  F.t0 = __ldg(T + 3);
  F.t1 = __ldg(T + 7);
  F.t2 = __ldg(T + 11);
  const float inv_lo = __ldg(inv_lo_p);
  const float inv_step = __ldg(inv_step_p);

  // the window's reference pixels (shared) and rotated bearings (registers)
  float r0[kPerThread], r1[kPerThread], r2[kPerThread];
  bool inside[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = tid + e * kThreads;
    const int ey = i / kEX, ex = i - ey * kEX;
    inside[e] = i < kExt && y0 + ey < eh && x0 + ex < ew;
    float ref = 0.0f;
    r0[e] = r1[e] = r2[e] = 0.0f;
    if (inside[e]) {
      const int g = (y0 + ey) * ew + x0 + ex;
      ref = __ldg(ref_ext + g);
      r0[e] = __ldg(Rf_ext + g);
      r1[e] = __ldg(Rf_ext + eplane + g);
      r2[e] = __ldg(Rf_ext + 2 * eplane + g);
    }
    if (i < kExt) s_ref[i] = ref;
  }

  // the output's prologue: its bearing, band, projections and segment
  const int oy = y0 + ly, ox = x0 + lx;
  const bool valid = oy < th && ox < tw;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d_lo = 0.0f, d_hi = 0.0f;
  float u_mu = 0.0f, v_mu = 0.0f, half = 0.0f, st = 0.0f, ctd = 0.0f;
  if (valid) {
    const int g = (oy + P) * ew + ox + P;
    c0 = __ldg(Rf_ext + g);
    c1 = __ldg(Rf_ext + eplane + g);
    c2 = __ldg(Rf_ext + 2 * eplane + g);
    const int o = oy * tw + ox;
    const float m0 = __ldg(mu + o);
    const float band = sigma_band * sqrtf(__ldg(sigma_sq + o));
    d_lo = clamp_min(m0 - band, min_depth);
    d_hi = m0 + band;
    float z, u_a, v_a, u_b, v_b;
    project(F, c0, c1, c2, m0, u_mu, v_mu, z);
    project(F, c0, c1, c2, d_lo, u_a, v_a, z);
    project(F, c0, c1, c2, d_hi, u_b, v_b, z);
    const float du = u_b - u_a, dv = v_b - v_a;
    half = 0.5f * clamp_max(sqrtf(du * du + dv * dv), max_extent);
    st = __ldg(sum_templ + o);
    ctd = __ldg(const_templ_denom + o);
  }

  float best = -1.0f, left = kNeg, right = kNeg, prev = kNeg;
  int best_k = -10;
  unsigned long long skipped = 0;
  for (int k = 0; k < num_planes; ++k) {
    const float d = 1.0f / (inv_lo + inv_step * (float)k);

    // whether the output scores this plane: visible, in band, within the
    // segment
    bool mask = false;
    if (valid && d >= d_lo && d <= d_hi) {
      float u, v, z;
      project(F, c0, c1, c2, d, u, v, z);
      const bool visible = u >= m && u < u_end && v >= m && v < v_end && z > 0.0f;
      const float du = u - u_mu, dv = v - v_mu;
      mask = visible && sqrtf(du * du + dv * dv) <= half;
    }
    if (!__syncthreads_or(mask)) {
      // every output scores -1e30: nothing improves
      if (best_k == k - 1) right = kNeg;
      prev = kNeg;
      ++skipped;
      continue;
    }

    // the window warped into the reference view at depth d
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int i = tid + e * kThreads;
      if (i < kExt) {
        float w = 0.0f;
        if (inside[e]) {
          float u, v, z;
          project(F, r0[e], r1[e], r2[e], d, u, v, z);
          w = bilinear(curr, height, width, u, v);
        }
        s_w[i] = w;
      }
    }
    __syncthreads();

    // horizontal window sums, in window order
    for (int r = ly; r < kEY; r += kTY) {
      const float* w = s_w + r * kEX + lx;
      const float* ref = s_ref + r * kEX + lx;
      float a = w[0];
      float aa = w[0] * w[0];
      float at = w[0] * ref[0];
#pragma unroll
      for (int q = 1; q < kSide; ++q) {
        const float x = w[q];
        a = a + x;
        aa = aa + x * x;
        at = at + x * ref[q];
      }
      s_i[r * kTX + lx] = a;
      s_ii[r * kTX + lx] = aa;
      s_it[r * kTX + lx] = at;
    }
    __syncthreads();

    // vertical window sums and the ZNCC where the plane scores, the running
    // best everywhere
    float ncc = kNeg;
    if (mask) {
      float b = s_i[ly * kTX + lx];
      float bb = s_ii[ly * kTX + lx];
      float bt = s_it[ly * kTX + lx];
#pragma unroll
      for (int q = 1; q < kSide; ++q) {
        b = b + s_i[(ly + q) * kTX + lx];
        bb = bb + s_ii[(ly + q) * kTX + lx];
        bt = bt + s_it[(ly + q) * kTX + lx];
      }
      const float num = area * bt - b * st;
      const float den = (area * bb - b * b) * ctd;
      ncc = num * rsqrtf(den + kFltMin);
    }
    const bool improved = ncc > best;
    if (best_k == k - 1) right = ncc;
    if (improved) {
      left = prev;
      right = kNeg;
      best_k = k;
      best = ncc;
    }
    prev = ncc;
  }

  // sub-plane parabolic refinement in inverse depth, the best depth's
  // projection
  if (valid) {
    float kf = (float)best_k;
    if (refine) {
      const bool have = left > kHalfNeg && right > kHalfNeg;
      const float denom = left - 2.0f * best + right;
      const float delta =
          have && fabsf(denom) > kDenomMin ? 0.5f * (left - right) / denom : 0.0f;
      kf = kf + clamp(delta, -0.5f, 0.5f);
    }
    const float d_best = 1.0f / (inv_lo + inv_step * kf);
    float u, v, z;
    project(F, c0, c1, c2, d_best, u, v, z);
    const int o = oy * tw + ox;
    found[o] = best >= ncc_threshold && best_k >= 0;
    u_out[o] = u;
    v_out[o] = v;
    best_out[o] = best;
  }
  if (tid == 0) {
    atomicAdd(g_plane_counts, skipped);
    atomicAdd(g_plane_counts + 1, (unsigned long long)num_planes);
  }
}

template <int P>
cudaError_t launch(const float* ref_ext, const float* Rf_ext, const float* mu,
                   const float* sigma_sq, const float* sum_templ,
                   const float* const_templ_denom, const float* curr, const float* T,
                   const float* fx, const float* fy, const float* cx, const float* cy,
                   const float* inv_lo, const float* inv_step, unsigned char* found,
                   float* u, float* v, float* best_ncc, int th, int tw, int height, int width,
                   int num_planes, float area, float m, float u_end, float v_end,
                   float sigma_band, float min_depth, float max_extent, float ncc_threshold,
                   int refine, cudaStream_t stream) {
  const dim3 grid((tw + kTX - 1) / kTX, (th + kTY - 1) / kTY);
  planesweep_match_kernel<P><<<grid, kThreads, 0, stream>>>(
      ref_ext, Rf_ext, mu, sigma_sq, sum_templ, const_templ_denom, curr, T, fx, fy, cx, cy,
      inv_lo, inv_step, found, u, v, best_ncc, th, tw, height, width, num_planes, area, m,
      u_end, v_end, sigma_band, min_depth, max_extent, ncc_threshold, refine);
  return cudaGetLastError();
}

}  // namespace

// The patch sides 5, 7, ..., 17; any other returns cudaErrorInvalidValue.
// An empty tile launches nothing.
extern "C" int remode_planesweep(
    const float* ref_ext, const float* Rf_ext, const float* mu, const float* sigma_sq,
    const float* sum_templ, const float* const_templ_denom, const float* curr, const float* T,
    const float* fx, const float* fy, const float* cx, const float* cy, const float* inv_lo,
    const float* inv_step, unsigned char* found, float* u, float* v, float* best_ncc, int th,
    int tw, int height, int width, int num_planes, int patch_side, float area, float m,
    float u_end, float v_end, float sigma_band, float min_depth, float max_extent,
    float ncc_threshold, int refine, void* stream) {
  if (th <= 0 || tw <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define REMODE_PLANESWEEP_CASE(SIDE)                                                          \
  case SIDE:                                                                                  \
    return (int)launch<SIDE / 2>(ref_ext, Rf_ext, mu, sigma_sq, sum_templ, const_templ_denom, \
                                 curr, T, fx, fy, cx, cy, inv_lo, inv_step, found, u, v,      \
                                 best_ncc, th, tw, height, width, num_planes, area, m, u_end, \
                                 v_end, sigma_band, min_depth, max_extent, ncc_threshold,     \
                                 refine, s);
  switch (patch_side) {
    REMODE_PLANESWEEP_CASE(5)
    REMODE_PLANESWEEP_CASE(7)
    REMODE_PLANESWEEP_CASE(9)
    REMODE_PLANESWEEP_CASE(11)
    REMODE_PLANESWEEP_CASE(13)
    REMODE_PLANESWEEP_CASE(15)
    REMODE_PLANESWEEP_CASE(17)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REMODE_PLANESWEEP_CASE
}

// Copies the device's counts (skipped, all (tile, plane) pairs) to the
// host's counts[2], after the work before it on the legacy default stream;
// with reset, zeroes them. The caller synchronizes the device first.
extern "C" int remode_planesweep_plane_counts(unsigned long long* counts, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(counts, g_plane_counts, sizeof(g_plane_counts));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    e = cudaMemcpyToSymbol(g_plane_counts, zero, sizeof(zero));
  }
  return (int)e;
}
