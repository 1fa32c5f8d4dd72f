// The head of a rectified frame step in eight kernels: the seed
// classification, the rectification geometry with the footprint interval,
// the reference grid's bands (two launches), the rect grid's bands and
// disparity rebasing, the rebased bands with the coarse pass's inputs and
// gate, the coarse-to-fine narrowing, and the back-warp's input stack.
// Between them run the hand kernels already in place, unchanged: the three
// warps (csrc/warp.cu) and the two sweeps (csrc/sweep.cu). A rectified
// update launches, in order: classify, rect_geometry, ref_fruitless,
// ref_bands, warp, rect_bands, warp, rect_rebase, sweep (coarse),
// coarse_narrow, sweep (full), back_stack, warp, seed_update. Every other
// regime launches classify alone of these.
//
// Replaces no Pallas kernel: the JAX package leaves this glue to XLA, which
// fuses it. Plain PyTorch versions, one per kernel: seed_check.classify
// (border_mask and classify_seeds) and the *_plain pieces of
// rpg_open_remode_tpu_torch/ops/rect_match.py that prepare_sweep and
// match_rectified_planes chain (rect_geometry and _footprint_xlim, the band
// math, straggler_slice_bands, coarse_sweep_args, the narrowing, the stack
// before the back-warp), ~330 PyTorch kernels a frame. The launchers are in
// ops/rect_head_cuda.py.
//
// Value: every expression is evaluated in the plain version's order, each
// PyTorch operation rounded once as its own kernel rounds it. The library is
// built with -fmad=false and IEEE division and square root. Where a plain
// operation is one library call that contracts or orders a sum its own way,
// the kernel does the same, as measured on an H100 with PyTorch 2.11 and
// CUDA 12.8 against random operands:
//   - a 3x3 matrix product with both operands as stored (cuBLAS sgemm's NN
//     form) and the matrix-vector product -R^T t (sgemv): each entry
//     fma(a1, b1, a0 b0) + a2 b2 (dot_nn);
//   - a product with its right operand a transposed view (A @ B.T, also the
//     [4, 3] corner products) and torch.dot: (a0 b0 + a1 b1) + a2 b2
//     (dot_nt);
//   - torch.einsum("j,jhw->hw") (a batched sgemm): fma(a2, b2, fma(a1, b1,
//     a0 b0)) (dot_einsum);
//   - torch.linalg.norm of a 3-vector: sqrt((x0^2 + x2^2) + x1^2), as in
//     csrc/seed_update.cu;
//   - torch.linalg.cross: each component fma(a_i, b_j, -(a_j b_i));
//   - `c / tensor` is reciprocal(tensor) * c; a 0-d tensor divides as an
//     IEEE division; mean() is the sum times (1 / N) in float32;
//   - full reductions (max, min) propagate NaN; they are exact in any order,
//     so blocks combine them with atomics on an order-preserving integer
//     encoding, and the count with an integer atomicAdd.
//
// What bounds each kernel on an H100:
//   - rect_geometry is one block: a few hundred dependent scalar operations
//     (one thread) and the footprint's 4 edges x rect_h rows; launch latency
//     bounds it;
//   - the grid passes are bound by bytes at 3.35 TB/s. At 640x480 (a
//     1.23 MB plane; the rect grid 512x768, a 1.57 MB plane): classify
//     reads 3 planes and writes 1 (4.9 MB, 1.5 us), ref_fruitless reads 1
//     (0.4 us), ref_bands reads 9 and writes 5 (17.2 MB, 5.1 us), rect_bands
//     reads 6 rect planes and writes 3 (14.2 MB, 4.2 us), rect_rebase reads
//     ~5.3 and writes ~4.7 (15.7 MB, 4.7 us), coarse_narrow ~2.6 and 2
//     (7.3 MB, 2.2 us), back_stack ~2.3 and 3 (8.3 MB, 2.5 us). Their
//     arithmetic is a few dozen operations a pixel, far below the card's
//     rate for those bytes. Each is one thread a pixel (rect_rebase: a
//     column pair) over the flattened grid, 256 a block, so any extent runs
//     (752 wide is no multiple of a tile) and loads and stores coalesce;
//   - the launches: ~330 plain kernels become 8 launches, and the image-wide
//     reductions (the fruitless maximum, the least valid band, the wide-band
//     count) need no launch of their own: rect_geometry resets their
//     accumulators, the grid passes add to them, and the last block of
//     rect_bands (rect_rebase) to finish turns them into kbase and the
//     shifted homography (the coarse gate). Nothing is read on the host, so
//     a CUDA graph captures the step.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kGeoThreads = 512;
// ConvergenceState (rpg_open_remode_tpu_torch/config.py)
constexpr int kUpdate = 0;
constexpr int kConverged = 1;
constexpr int kBorder = 2;
constexpr int kDiverged = 3;
// the geometry buffer (ops/rect_head_cuda.py: GEO): four homographies, the
// rectifying rotation and the shifted H_rect_to_curr, each 3x3 row-major,
// then the baseline C, its length B, the rect scale s, |s| B and kbase
constexpr int kHRectToRef = 0;
constexpr int kHRectToCurr = 9;
constexpr int kHCurrToRect = 18;
constexpr int kHRefToRect = 27;
constexpr int kRRect = 36;
constexpr int kHShift = 45;
constexpr int kC = 54;
constexpr int kB = 57;
constexpr int kS = 58;
constexpr int kFxB = 59;
constexpr int kKbase = 60;
// the accumulators (ops/rect_head_cuda.py: ACC_LEN)
constexpr int kFruitMax = 0;
constexpr int kFruitNan = 1;
constexpr int kLoMin = 2;
constexpr int kLoNan = 3;
constexpr int kTicketBands = 4;
constexpr int kWide = 5;
constexpr int kTicketRebase = 6;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// ---- PyTorch's elementwise operations as its CUDA kernels round them

// torch.clamp(x, min=lo) / (x, max=hi): NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
// torch.clamp with tensor bounds
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}
// torch.maximum / torch.minimum, and max / min reductions: NaN propagates
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// Tensor.reciprocal; `c / tensor` is rcp(tensor) * c
__device__ __forceinline__ float rcp(float x) { return 1.0f / x; }
__device__ __forceinline__ float sign(float x) {
  return (float)((0.0f < x) - (x < 0.0f));
}

// ---- the library calls with three-term sums (see the header)

__device__ __forceinline__ float dot_nn(float a0, float a1, float a2, float b0, float b1,
                                        float b2) {
  return __fmaf_rn(a1, b1, a0 * b0) + a2 * b2;
}
__device__ __forceinline__ float dot_nt(float a0, float a1, float a2, float b0, float b1,
                                        float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}
__device__ __forceinline__ float dot_einsum(float a0, float a1, float a2, float b0, float b1,
                                            float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, a0 * b0));
}
__device__ __forceinline__ float norm3(const float* x) {
  return sqrtf((x[0] * x[0] + x[2] * x[2]) + x[1] * x[1]);
}
__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = __fmaf_rn(a[1], b[2], -(a[2] * b[1]));
  c[1] = __fmaf_rn(a[2], b[0], -(a[0] * b[2]));
  c[2] = __fmaf_rn(a[0], b[1], -(a[1] * b[0]));
}
// C = A @ B, both as stored
__device__ void mm(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = dot_nn(A[i * 3], A[i * 3 + 1], A[i * 3 + 2], B[j], B[3 + j], B[6 + j]);
}
// C = A @ B.T
__device__ void mm_t(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = dot_nt(A[i * 3], A[i * 3 + 1], A[i * 3 + 2], B[j * 3], B[j * 3 + 1],
                            B[j * 3 + 2]);
}
// the image of corner (x, y, 1) under H: (x', y') = H[0:2] p / H[2] p,
// with the [4, 3] @ H.T product's rounding
__device__ __forceinline__ void project(const float* H, float x, float y, float* px,
                                        float* py) {
  const float w = dot_nt(x, y, 1.0f, H[6], H[7], H[8]);
  *px = dot_nt(x, y, 1.0f, H[0], H[1], H[2]) / w;
  *py = dot_nt(x, y, 1.0f, H[3], H[4], H[5]) / w;
}

// ---- order-preserving integer encoding of a float (for atomicMax/Min)

__device__ __forceinline__ int enc(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int i) { return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff); }

struct MaxOp {
  __device__ float operator()(float a, float b) const { return maximum(a, b); }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return minimum(a, b); }
};

// The block's reduction of v; the result is thread 0's. Every thread of the
// block must call it.
template <class Op>
__device__ float block_reduce(float v, Op op) {
  __shared__ float warp_vals[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_vals[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kBlock / 32; ++w) v = op(v, warp_vals[w]);
  return v;
}

// ---- classify: seed_check.border_mask and classify_seeds

__global__ void __launch_bounds__(kBlock)
classify_kernel(const float* __restrict__ sigma_sq, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ epsilon,
                int* __restrict__ conv, int height, int width, int margin, float eta_inlier,
                float eta_outlier) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= height * width) return;
  const int y = i / width, x = i - y * width;
  const bool border = x < margin || x > width - margin - 1 || y < margin ||
                      y > height - margin - 1;
  const float ai = a[i], bi = b[i];
  const float ab = ai + bi;
  const bool converged = (ai / ab > eta_inlier) && (sigma_sq[i] < __ldg(epsilon));
  const bool diverged = (ai - 1.0f) / (ab - 2.0f) < eta_outlier;
  conv[i] = border ? kBorder : (converged ? kConverged : (diverged ? kDiverged : kUpdate));
}

// ---- rect_geometry: rect_match.rect_geometry and _footprint_xlim

struct Footprint {
  float px[4], py[4];
};

// One thread: the geometry into geo, the footprint's corners into fp.
__device__ void geometry(const float* T, float fx, float fy, float cx, float cy, int height,
                         int width, int rect_h, int rect_w, float* geo, Footprint* fp) {
  float R[9], t[3], C[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = T[i * 4 + j];
    t[i] = T[i * 4 + 3];
  }
  // C = -R^T t
  for (int i = 0; i < 3; ++i) C[i] = dot_nn(-R[i], -R[3 + i], -R[6 + i], t[0], t[1], t[2]);
  const float B = norm3(C);
  // utils/warp.intrinsic_matrix, intrinsic_inv
  const float Kc[9] = {fx, 0.0f, cx, 0.0f, fy, cy, 0.0f, 0.0f, 1.0f};
  const float Kci[9] = {rcp(fx) * 1.0f, 0.0f, -cx / fx, 0.0f, rcp(fy) * 1.0f, -cy / fy,
                        0.0f, 0.0f, 1.0f};

  // _rect_rotation(sign(fx) * C)
  float Cs[3], e1[3], e2[3], e3[3];
  for (int i = 0; i < 3; ++i) Cs[i] = sign(fx) * C[i];
  const float nb = clamp_min(norm3(Cs), 1e-12f);
  for (int i = 0; i < 3; ++i) e1[i] = Cs[i] / nb;
  const float z_axis[3] = {0.0f, 0.0f, 1.0f};
  cross3(z_axis, e1, e2);
  const float n2 = norm3(e2);
  const float n2c = clamp_min(n2, 1e-12f);
  const float y_alt[3] = {0.0f, 1.0f, 0.0f};
  for (int i = 0; i < 3; ++i) e2[i] = n2 > 1e-3f ? e2[i] / n2c : y_alt[i];
  const float d = dot_nt(e2[0], e2[1], e2[2], e1[0], e1[1], e1[2]);
  for (int i = 0; i < 3; ++i) e2[i] = e2[i] - d * e1[i];
  const float n3 = clamp_min(norm3(e2), 1e-12f);
  for (int i = 0; i < 3; ++i) e2[i] = e2[i] / n3;
  cross3(e1, e2, e3);
  const float Rr[9] = {e1[0], e1[1], e1[2], e2[0], e2[1], e2[2], e3[0], e3[1], e3[2]};

  // _fit_rect_intrinsics: the zigzag corners' rays, rotated
  const float w1 = (float)width - 1.0f, h1 = (float)height - 1.0f;
  const float zx[4] = {0.0f, w1, 0.0f, w1}, zy[4] = {0.0f, 0.0f, h1, h1};
  float xh[4], yh[4];
  for (int c = 0; c < 4; ++c) {
    float ray[3], Y[3];
    for (int i = 0; i < 3; ++i)
      ray[i] = dot_nt(zx[c], zy[c], 1.0f, Kci[i * 3], Kci[i * 3 + 1], Kci[i * 3 + 2]);
    for (int i = 0; i < 3; ++i)
      Y[i] = dot_nt(ray[0], ray[1], ray[2], Rr[i * 3], Rr[i * 3 + 1], Rr[i * 3 + 2]);
    xh[c] = Y[0] / Y[2];
    yh[c] = Y[1] / Y[2];
  }
  float xmin = xh[0], xmax = xh[0], ymin = yh[0], ymax = yh[0];
  for (int c = 1; c < 4; ++c) {
    xmin = minimum(xmin, xh[c]);
    xmax = maximum(xmax, xh[c]);
    ymin = minimum(ymin, yh[c]);
    ymax = maximum(ymax, yh[c]);
  }
  const float sx_m = rcp(clamp_min(xmax - xmin, 1e-6f)) * ((float)rect_w - 1.0f);
  const float sy_m = rcp(clamp_min(ymax - ymin, 1e-6f)) * ((float)rect_h - 1.0f);
  const float s = minimum(sx_m, sy_m);
  const float sx = sign(fx) * s, sy = sign(fy) * s;
  const float cxr = -minimum(sx * xmin, sx * xmax);
  const float cyr = -minimum(sy * ymin, sy * ymax);
  // _kmat, _kmat_inv
  const float Kr[9] = {sx, 0.0f, cxr, 0.0f, sy, cyr, 0.0f, 0.0f, 1.0f};
  const float ix = rcp(sx) * 1.0f, iy = rcp(sy) * 1.0f;
  const float Kri[9] = {ix, 0.0f, -cxr * ix, 0.0f, iy, -cyr * iy, 0.0f, 0.0f, 1.0f};

  // the homographies, multiplied left to right as the plain expressions
  float P[9], Q[9];
  mm_t(Kc, Rr, P);
  mm(P, Kri, geo + kHRectToRef);          // Kc @ R_rect.T @ Kr_inv
  mm(Kc, R, P);
  mm_t(P, Rr, Q);
  mm(Q, Kri, geo + kHRectToCurr);         // Kc @ R @ R_rect.T @ Kr_inv
  mm(Kr, Rr, P);
  mm_t(P, R, Q);
  mm(Q, Kci, geo + kHCurrToRect);         // Kr @ R_rect @ R.T @ Kc_inv
  mm(P, Kci, geo + kHRefToRect);          // Kr @ R_rect @ Kc_inv
  for (int k = 0; k < 9; ++k) geo[kRRect + k] = Rr[k];
  for (int i = 0; i < 3; ++i) geo[kC + i] = C[i];
  geo[kB] = B;
  geo[kS] = s;
  geo[kFxB] = fabsf(s) * B;

  // _footprint_xlim's ring corners under H_curr_to_rect
  const float rx[4] = {0.0f, w1, w1, 0.0f}, ry[4] = {0.0f, 0.0f, h1, h1};
  for (int c = 0; c < 4; ++c) project(geo + kHCurrToRect, rx[c], ry[c], &fp->px[c], &fp->py[c]);
}

// _footprint_xlim before the vertical window: the interval in which rect
// row y crosses the quad's edges
__device__ void footprint_row(const Footprint& fp, float y, float* lo, float* hi) {
  const float inf = inf_f();
  float mn = 0.0f, mx = 0.0f;
  for (int k = 0; k < 4; ++k) {
    const int q = (k + 1) & 3;
    const float dy = fp.py[q] - fp.py[k];
    const float den = fabsf(dy) < 1e-12f ? 1e-12f : dy;
    const float t = (y - fp.py[k]) / den;
    const bool crossing = t >= 0.0f && t <= 1.0f;
    const float x_at = fp.px[k] + t * (fp.px[q] - fp.px[k]);
    const float vmin = crossing ? x_at : inf, vmax = crossing ? x_at : -inf;
    mn = k == 0 ? vmin : minimum(mn, vmin);
    mx = k == 0 ? vmax : maximum(mx, vmax);
  }
  *lo = mn;
  *hi = mx;
}

__global__ void __launch_bounds__(kGeoThreads)
rect_geometry_kernel(const float* __restrict__ T, const float* __restrict__ fx,
                     const float* __restrict__ fy, const float* __restrict__ cx,
                     const float* __restrict__ cy, float* __restrict__ geo,
                     float* __restrict__ xlim, int* __restrict__ acc, int height, int width,
                     int rect_h, int rect_w, float reach, int vrows) {
  extern __shared__ float rows[];   // [2, rect_h]: each row's crossing interval
  __shared__ Footprint fp;
  if (threadIdx.x == 0) {
    geometry(T, __ldg(fx), __ldg(fy), __ldg(cx), __ldg(cy), height, width, rect_h, rect_w,
             geo, &fp);
    acc[kFruitMax] = enc(-inf_f());
    acc[kFruitNan] = 0;
    acc[kLoMin] = enc(inf_f());
    acc[kLoNan] = 0;
    acc[kTicketBands] = 0;
    acc[kWide] = 0;
    acc[kTicketRebase] = 0;
  }
  __syncthreads();
  for (int y = threadIdx.x; y < rect_h; y += kGeoThreads)
    footprint_row(fp, (float)y, rows + y, rows + rect_h + y);
  __syncthreads();
  // _window_extreme: 'same' sliding max of the lower ends, min of the upper
  const int hp = vrows / 2;
  const float inf = inf_f();
  for (int y = threadIdx.x; y < rect_h; y += kGeoThreads) {
    float lo = 0.0f, hi = 0.0f;
    for (int k = 0; k < vrows; ++k) {
      const int r = y - hp + k;
      const bool in = r >= 0 && r < rect_h;
      const float l = in ? rows[r] : -inf, h = in ? rows[rect_h + r] : inf;
      lo = k == 0 ? l : maximum(lo, l);
      hi = k == 0 ? h : minimum(hi, h);
    }
    xlim[2 * y] = lo + reach;
    xlim[2 * y + 1] = hi - reach;
  }
}

// ---- ref_fruitless: torch.max(b - b_init), into the accumulators

__global__ void __launch_bounds__(kBlock)
ref_fruitless_kernel(const float* __restrict__ b, int* __restrict__ acc, int n, float b_init) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const float v = block_reduce(i < n ? b[i] - b_init : -inf_f(), MaxOp());
  if (threadIdx.x == 0) {
    if (isnan(v)) atomicOr(acc + kFruitNan, 1);
    else atomicMax(acc + kFruitMax, enc(v));
  }
}

// ---- ref_bands: the Bayesian band, straggler_slice_bands, the depth-to-z
// factor rz and the 5-plane stack the reference warp reads

struct BandParams {
  float sigma_band, min_search_depth, b_init, straggler_after, s_planes, max_extent;
  int straggler;
};

__global__ void __launch_bounds__(kBlock)
ref_bands_kernel(const float* __restrict__ mu, const float* __restrict__ sigma_sq,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ conv, const float* __restrict__ ref_img,
                 const float* __restrict__ f_ref, const float* __restrict__ geo,
                 const int* __restrict__ acc, float* __restrict__ stack, int n, BandParams p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float m = mu[i];
  const float band = sqrtf(sigma_sq[i]) * p.sigma_band;
  float d_lo = clamp_min(m - band, p.min_search_depth);
  float d_hi = m + band;
  float d_center = m;
  if (p.straggler) {
    const float ai = a[i], bi = b[i];
    const bool flag = (bi - p.b_init >= p.straggler_after) && (ai / (ai + bi) < 0.45f);
    const float n_est = acc[kFruitNan] ? nan_f() : dec(acc[kFruitMax]);
    const float fxB = clamp_min(geo[kFxB], 1e-6f);
    float i_lo = rcp(d_hi) * 1.0f;
    float i_hi = rcp(d_lo) * 1.0f;
    const float i_mu0 = rcp(clamp_t(m, d_lo, d_hi)) * 1.0f;
    const float half = (0.5f * clamp_max((i_hi - i_lo) * fxB, p.max_extent)) / fxB;
    i_lo = maximum(i_lo, i_mu0 - half);
    i_hi = minimum(i_hi, i_mu0 + half);
    const float Wi = i_hi - i_lo;
    const float Si = rcp(fxB) * p.s_planes;
    const bool sliced = flag && (Wi > Si);
    const float phase = 0.6180339887f * n_est;
    const float phi = phase - floorf(phase);
    // torch.remainder(floor(n_est), 3.0)
    float r3 = fmodf(floorf(n_est), 3.0f);
    if (r3 != 0.0f && r3 < 0.0f) r3 += 3.0f;
    const bool exploit = r3 < 0.5f;
    const float lo_explore = i_lo + phi * (Wi - Si);
    const float lo_center = minimum(maximum(i_mu0 - 0.5f * Si, i_lo), i_hi - Si);
    const float lo_s = exploit ? lo_center : lo_explore;
    const float hi_s = lo_s + Si;
    if (sliced) {
      d_lo = rcp(hi_s) * 1.0f;
      d_hi = rcp(lo_s) * 1.0f;
      d_center = rcp(lo_s + hi_s) * 2.0f;
    }
  }
  const int plane = n;
  const float rz = clamp_min(dot_einsum(geo[kRRect + 6], geo[kRRect + 7], geo[kRRect + 8],
                                        f_ref[i], f_ref[plane + i], f_ref[2 * plane + i]),
                             1e-3f);
  stack[i] = ref_img[i];
  stack[plane + i] = clamp_min(d_lo * rz, 1e-4f);
  stack[2 * plane + i] = clamp_min(d_center * rz, 1e-4f);
  stack[3 * plane + i] = clamp_min(d_hi * rz, 1e-4f);
  stack[4 * plane + i] = conv[i] == kUpdate ? 1.0f : 0.0f;
}

// ---- rect_bands: validity, the disparity bands (disparity = |s| B / z) and,
// in the last block, kbase and H_rect_to_curr @ M_aff

// kbase into geo and the shifted homography H_rect_to_curr @ [[1, 0, -kbase],
// [0, 1, 0], [0, 0, 1]]
__device__ void write_shift(float* geo, float kbase) {
  const float M[9] = {1.0f, 0.0f, -kbase, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float H[9];
  for (int k = 0; k < 9; ++k) H[k] = geo[kHRectToCurr + k];
  mm(H, M, geo + kHShift);
  geo[kKbase] = kbase;
}

__global__ void __launch_bounds__(kBlock)
rect_bands_kernel(const float* __restrict__ warped, const float* __restrict__ u,
                  const float* __restrict__ v, float* __restrict__ geo, int* __restrict__ acc,
                  float* __restrict__ valid_r, float* __restrict__ disp_lo,
                  float* __restrict__ disp_hi, int n, int height, int width, float max_extent,
                  int rebase) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const float inf = inf_f();
  float lo_valid = inf;
  if (i < n) {
    const float us = u[i], vs = v[i];
    const float valid = (us >= 0.0f && us <= (float)width - 1.0f && vs >= 0.0f &&
                         vs <= (float)height - 1.0f) ? 1.0f : 0.0f;
    const float fxB = geo[kFxB];
    float lo = fxB / warped[3 * n + i];
    float hi = fxB / warped[n + i];
    const float mid = fxB / warped[2 * n + i];
    const float half = 0.5f * clamp_max(hi - lo, max_extent);
    lo = maximum(lo, mid - half);
    hi = minimum(hi, mid + half);
    // inactive rect pixels get an empty interval
    const bool active = warped[4 * n + i] > 1e-3f;
    lo = active ? lo : inf;
    hi = active ? hi : -inf;
    valid_r[i] = valid;
    disp_lo[i] = lo;
    disp_hi[i] = hi;
    lo_valid = valid > 0.999f ? lo : inf;
  }
  if (!rebase) {
    if (blockIdx.x == 0 && threadIdx.x == 0) write_shift(geo, 0.0f);
    return;
  }
  const float m = block_reduce(lo_valid, MinOp());
  if (threadIdx.x == 0) {
    if (isnan(m)) atomicOr(acc + kLoNan, 1);
    else atomicMin(acc + kLoMin, enc(m));
    __threadfence();
    if (atomicAdd(acc + kTicketBands, 1) == (int)gridDim.x - 1) {
      __threadfence();
      const float lo_min = *(volatile int*)(acc + kLoNan)
                               ? nan_f() : dec(*(volatile int*)(acc + kLoMin));
      const float base_raw = floorf(lo_min) - 1.0f;
      write_shift(geo, isfinite(base_raw) ? clamp_min(base_raw, 0.0f) : 0.0f);
    }
  }
}

// ---- rect_rebase: the bands less kbase, xlim + kbase and the coarse pass's
// x-decimated inputs, its wide-band count and, in the last block, its gate.
// One thread a column pair of the padded current image.

struct RebaseParams {
  float wide, hp_margin;
  int coarse;
};

__global__ void __launch_bounds__(kBlock)
rect_rebase_kernel(const float* __restrict__ curr_pad, const float* __restrict__ ref_r,
                   const float* __restrict__ valid_r, float* __restrict__ disp_lo,
                   float* __restrict__ disp_hi, const float* __restrict__ xlim_raw,
                   const float* __restrict__ geo, int* __restrict__ acc,
                   float* __restrict__ xlim, float* __restrict__ curr_h,
                   float* __restrict__ ref_h, float* __restrict__ valid_h,
                   float* __restrict__ xlim_h, float* __restrict__ lo_h,
                   float* __restrict__ hi_h, unsigned char* __restrict__ gate, int rect_h,
                   int rect_w, int pad, RebaseParams p) {
  const int wh = rect_w / 2;           // half-grid columns
  const int wph = wh + pad;            // half columns of the padded image
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const float kbase = geo[kKbase];
  bool wide0 = false, wide1 = false;
  if (i < rect_h * wph) {
    const int y = i / wph, j = i - y * wph;
    if (p.coarse) {
      const float* c = curr_pad + (size_t)y * 2 * wph + 2 * j;
      curr_h[i] = 0.5f * (c[0] + c[1]);
    }
    if (j < wh) {
      const int x = y * rect_w + 2 * j;
      const float lo0 = disp_lo[x] - kbase, lo1 = disp_lo[x + 1] - kbase;
      const float hi0 = disp_hi[x] - kbase, hi1 = disp_hi[x + 1] - kbase;
      disp_lo[x] = lo0;
      disp_lo[x + 1] = lo1;
      disp_hi[x] = hi0;
      disp_hi[x + 1] = hi1;
      if (p.coarse) {
        const float e0 = hi0 - lo0, e1 = hi1 - lo1;
        wide0 = isfinite(e0) && e0 > p.wide;
        wide1 = isfinite(e1) && e1 > p.wide;
        const int h = y * wh + j;
        ref_h[h] = 0.5f * (ref_r[x] + ref_r[x + 1]);
        valid_h[h] = minimum(valid_r[x], valid_r[x + 1]);
        lo_h[h] = minimum(lo0, lo1) * 0.5f;
        hi_h[h] = maximum(hi0, hi1) * 0.5f;
      }
    }
    if (j == 0) {
      const float xl = xlim_raw[2 * y] + kbase, xr = xlim_raw[2 * y + 1] + kbase;
      xlim[2 * y] = xl;
      xlim[2 * y + 1] = xr;
      if (p.coarse) {
        xlim_h[2 * y] = xl * 0.5f + p.hp_margin;
        xlim_h[2 * y + 1] = xr * 0.5f - p.hp_margin;
      }
    }
  }
  if (!p.coarse) return;
  // wide_n.float().mean() > 0.15: an exact count, times 1 / N as mean() does
  const int n_wide = __syncthreads_count(wide0) + __syncthreads_count(wide1);
  if (threadIdx.x == 0) {
    if (n_wide) atomicAdd(acc + kWide, n_wide);
    __threadfence();
    if (atomicAdd(acc + kTicketRebase, 1) == (int)gridDim.x - 1) {
      __threadfence();
      const float count = (float)*(volatile int*)(acc + kWide);
      *gate = count * (1.0f / (float)(rect_h * rect_w)) > 0.15f;
    }
  }
}

// ---- coarse_narrow: _coarse_narrow after its sweep, in place

__global__ void __launch_bounds__(kBlock)
coarse_narrow_kernel(const float* __restrict__ d_c, const unsigned char* __restrict__ found_c,
                     const unsigned char* __restrict__ gate, float* __restrict__ disp_lo,
                     float* __restrict__ disp_hi, int rect_h, int rect_w, float radius) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= rect_h * rect_w) return;
  const int y = i / rect_w, x = i - y * rect_w;
  const int h = y * (rect_w / 2) + x / 2;
  const float d_up = 2.0f * d_c[h];
  const float lo2 = maximum(disp_lo[i], d_up - radius);
  const float hi2 = minimum(disp_hi[i], d_up + radius);
  if (found_c[h] && lo2 <= hi2 && *gate) {
    disp_lo[i] = lo2;
    disp_hi[i] = hi2;
  }
}

// ---- back_stack: the back-warp's input, found-masked

__global__ void __launch_bounds__(kBlock)
back_stack_kernel(const float* __restrict__ disp, const float* __restrict__ ncc,
                  const unsigned char* __restrict__ found, const float* __restrict__ kbase,
                  float* __restrict__ out, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float f = found[i] ? 1.0f : 0.0f;
  out[i] = (disp[i] + __ldg(kbase)) * f;
  out[n + i] = ncc[i] * f;
  out[2 * n + i] = f;
}

inline dim3 grid_of(int n) { return dim3((n + kBlock - 1) / kBlock); }

}  // namespace

extern "C" int remode_classify(const float* sigma_sq, const float* a, const float* b,
                               const float* epsilon, int* conv, int height, int width,
                               int margin, float eta_inlier, float eta_outlier, void* stream) {
  classify_kernel<<<grid_of(height * width), kBlock, 0, (cudaStream_t)stream>>>(
      sigma_sq, a, b, epsilon, conv, height, width, margin, eta_inlier, eta_outlier);
  return (int)cudaGetLastError();
}

// acc: the ACC_LEN accumulators, reset here for the kernels that follow
extern "C" int remode_rect_geometry(const float* T, const float* fx, const float* fy,
                                    const float* cx, const float* cy, float* geo, float* xlim,
                                    int* acc, int height, int width, int rect_h, int rect_w,
                                    float reach, int vrows, void* stream) {
  rect_geometry_kernel<<<1, kGeoThreads, 2 * rect_h * sizeof(float), (cudaStream_t)stream>>>(
      T, fx, fy, cx, cy, geo, xlim, acc, height, width, rect_h, rect_w, reach, vrows);
  return (int)cudaGetLastError();
}

extern "C" int remode_ref_fruitless(const float* b, int* acc, int n, float b_init,
                                    void* stream) {
  ref_fruitless_kernel<<<grid_of(n), kBlock, 0, (cudaStream_t)stream>>>(b, acc, n, b_init);
  return (int)cudaGetLastError();
}

extern "C" int remode_ref_bands(const float* mu, const float* sigma_sq, const float* a,
                                const float* b, const int* conv, const float* ref_img,
                                const float* f_ref, const float* geo, const int* acc,
                                float* stack, int n, float sigma_band, float min_search_depth,
                                int straggler, float b_init, float straggler_after,
                                float s_planes, float max_extent, void* stream) {
  const BandParams p{sigma_band, min_search_depth, b_init, straggler_after, s_planes,
                     max_extent, straggler};
  ref_bands_kernel<<<grid_of(n), kBlock, 0, (cudaStream_t)stream>>>(
      mu, sigma_sq, a, b, conv, ref_img, f_ref, geo, acc, stack, n, p);
  return (int)cudaGetLastError();
}

extern "C" int remode_rect_bands(const float* warped, const float* u, const float* v,
                                 float* geo, int* acc, float* valid_r, float* disp_lo,
                                 float* disp_hi, int n, int height, int width,
                                 float max_extent, int rebase, void* stream) {
  rect_bands_kernel<<<grid_of(n), kBlock, 0, (cudaStream_t)stream>>>(
      warped, u, v, geo, acc, valid_r, disp_lo, disp_hi, n, height, width, max_extent,
      rebase);
  return (int)cudaGetLastError();
}

// disp_lo, disp_hi are rebased in place; the coarse outputs (curr_h to gate)
// may be null when coarse is 0
extern "C" int remode_rect_rebase(const float* curr_pad, const float* ref_r,
                                  const float* valid_r, float* disp_lo, float* disp_hi,
                                  const float* xlim_raw, const float* geo, int* acc,
                                  float* xlim, float* curr_h, float* ref_h, float* valid_h,
                                  float* xlim_h, float* lo_h, float* hi_h, unsigned char* gate,
                                  int rect_h, int rect_w, int pad, float wide,
                                  float hp_margin, int coarse, void* stream) {
  const RebaseParams p{wide, hp_margin, coarse};
  rect_rebase_kernel<<<grid_of(rect_h * (rect_w / 2 + pad)), kBlock, 0,
                       (cudaStream_t)stream>>>(
      curr_pad, ref_r, valid_r, disp_lo, disp_hi, xlim_raw, geo, acc, xlim, curr_h, ref_h,
      valid_h, xlim_h, lo_h, hi_h, gate, rect_h, rect_w, pad, p);
  return (int)cudaGetLastError();
}

extern "C" int remode_coarse_narrow(const float* d_c, const unsigned char* found_c,
                                    const unsigned char* gate, float* disp_lo, float* disp_hi,
                                    int rect_h, int rect_w, float radius, void* stream) {
  coarse_narrow_kernel<<<grid_of(rect_h * rect_w), kBlock, 0, (cudaStream_t)stream>>>(
      d_c, found_c, gate, disp_lo, disp_hi, rect_h, rect_w, radius);
  return (int)cudaGetLastError();
}

extern "C" int remode_back_stack(const float* disp, const float* ncc,
                                 const unsigned char* found, const float* kbase, float* out,
                                 int n, void* stream) {
  back_stack_kernel<<<grid_of(n), kBlock, 0, (cudaStream_t)stream>>>(disp, ncc, found, kbase,
                                                                     out, n);
  return (int)cudaGetLastError();
}
