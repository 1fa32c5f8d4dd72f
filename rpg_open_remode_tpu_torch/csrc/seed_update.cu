// The tail of a frame step in one kernel: for each reference pixel, the
// post-match state transition, the triangulated depth measurement with its
// one-pixel-angle uncertainty, the Gaussian x Beta moment matching, the
// stored match, the found-masked NCC and the five state counts. In the
// rectified regime it also finishes the matcher: it renormalizes the
// back-warped planes and unrectifies the match into the current image.
//
// Replaces no Pallas kernel: the JAX package leaves this tail to XLA, which
// fuses it. Plain PyTorch version:
// rpg_open_remode_tpu_torch/ops/seed_update_cuda.py:seed_update_plain
// (rect_match.unrectify, epipolar.apply_match_to_conv,
// seed_update.update_seeds, reduction.convergence_stats and the masked NCC
// plane of models/depthmap.update_step), ~240 PyTorch kernels a frame.
//
// Value: every expression is evaluated in the plain version's order, each
// PyTorch operation rounded once as its own kernel rounds it. The library
// is built with -fmad=false and IEEE division and square root; the
// transcendentals are the CUDA math library's acosf, sinf, expf, atan2f
// and rsqrtf, which PyTorch's kernels call. Where a plain operation is one
// PyTorch kernel that contracts or orders a sum its own way, the kernel
// does the same:
//   - a sum or 2-norm over the 3 components of a [H, W, 3] field is a
//     PyTorch reduction (ATen/native/cuda/Reduce.cuh, four accumulators a
//     thread). Over a contiguous last axis two lanes share each output:
//     lane 0 takes components 0 and 2, lane 1 component 1, so the result is
//     (x0 + x2) + x1 (sum_inner). Where the field has the layout of f_ref
//     ([3, H, W] in memory) one thread takes all three: (x0 + x1) + x2
//     (sum_outer). A full reduction of a 3-vector is reduced as over a
//     contiguous axis. The identity 0 is added where the reduction adds it.
//   - se3.rotate's f_curr @ R^T is a cuBLAS product with K = 3: an FMA
//     chain over k (rotate3).
//
// What bounds it on an H100: bytes. A pixel reads 13 float32 planes in the
// rectified flavour (conv, mu, sigma_sq, a, b, f_ref x3, match_u, match_v,
// the back-warp x3; the generic flavour reads found, u, v and best_ncc
// instead of the back-warp) and writes 8, ~84 bytes: 25.8 MB at 640x480,
// 7.7 us at 3.35 TB/s. The arithmetic, ~250 operations and 5
// transcendentals for each seed that is updated, is below the card's rate
// for those bytes. What the design does about it:
//   - fields: no intermediate plane goes through device memory (the plain
//     version writes and reads ~210 whole-image temporaries a frame);
//   - launches: one launch replaces ~240; the counts are reduced per block
//     (__syncthreads_count) and added with one integer atomicAdd per block
//     and state, exact in any order, into a buffer the caller zeroes;
//   - divergence: only the seeds in UPDATE after the match run the
//     update's arithmetic; the others only copy, as the plain version's
//     torch.where keeps their values;
//   - shape: one thread a pixel over the flattened image, 256 a block, so
//     any H, W runs (752 is not a multiple of any tile) and loads and
//     stores are coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
// ConvergenceState (rpg_open_remode_tpu_torch/config.py)
constexpr int kUpdate = 0;
constexpr int kNoMatch = 4;
constexpr int kStates = 5;
// the float32 values PyTorch gives its Python scalars
constexpr float kEps = 0x1.5798eep-27f;      // 1e-8
constexpr float kWgtMin = 0x1.0c6f7ap-20f;   // 1e-6
constexpr float kPi = 0x1.921fb6p+1f;        // math.pi
constexpr float kTwoPi = 0x1.921fb6p+2f;     // 2.0 * math.pi

// torch.clamp with a lower bound: NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// utils/warp.py:_safe
__device__ __forceinline__ float safe(float den) {
  return fabsf(den) < kEps ? (den >= 0.0f ? kEps : -kEps) : den;
}

// torch.sum over a contiguous axis of 3 (lanes {0, 2} and {1})
__device__ __forceinline__ float sum_inner(float x0, float x1, float x2) {
  const float lane0 = (((0.0f + x0) + (0.0f + x2)) + 0.0f) + 0.0f;
  const float lane1 = (((0.0f + x1) + 0.0f) + 0.0f) + 0.0f;
  return lane0 + lane1;
}

// torch.sum over the [3, H, W] layout's outer axis (one thread)
__device__ __forceinline__ float sum_outer(float x0, float x1, float x2) {
  return (((0.0f + x0) + (0.0f + x1)) + (0.0f + x2)) + 0.0f;
}

// the 2-norm's reduce step, acc + x * x, as PyTorch's kernel contracts it
__device__ __forceinline__ float sq(float x) { return __fmaf_rn(x, x, 0.0f); }

__device__ __forceinline__ float norm_inner(float x0, float x1, float x2) {
  const float lane0 = ((sq(x0) + sq(x2)) + 0.0f) + 0.0f;
  const float lane1 = ((sq(x1) + 0.0f) + 0.0f) + 0.0f;
  return sqrtf(lane0 + lane1);
}

__device__ __forceinline__ float norm_outer(float x0, float x1, float x2) {
  return sqrtf(((sq(x0) + sq(x1)) + sq(x2)) + 0.0f);
}

// row j of f @ R^T
__device__ __forceinline__ float rotate3(const float* Rj, float f0, float f1, float f2) {
  return __fmaf_rn(f2, Rj[2], __fmaf_rn(f1, Rj[1], __fmaf_rn(f0, Rj[0], 0.0f)));
}

// The frame's scalars, the same for every pixel.
struct Frame {
  float R[9];          // rotation of T_ref_curr, row-major
  float t[3];          // its translation
  float fx, fy, cx, cy;
  float t_norm;        // linalg.norm(t)
  float angle;         // one_pix_angle, widened by the rotational pose noise
  float inv_range;     // 1 / depth_range
  int has_trans;
  float trans_scale;   // MAG3 * pose_noise_trans_m / clamp(t_norm, 1e-6)
};

__device__ __forceinline__ Frame load_frame(const float* T, const float* fx, const float* fy,
                                            const float* cx, const float* cy,
                                            const float* depth_range, int has_rot,
                                            float rot_angle, int has_trans, float trans_mag) {
  Frame F;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) F.R[j * 3 + k] = __ldg(T + j * 4 + k);
    F.t[j] = __ldg(T + j * 4 + 3);
  }
  F.fx = __ldg(fx);
  F.fy = __ldg(fy);
  F.cx = __ldg(cx);
  F.cy = __ldg(cy);
  F.t_norm = norm_inner(F.t[0], F.t[1], F.t[2]);
  // camera.one_pix_angle: atan2(1, 2 fx) * 2
  F.angle = atan2f(1.0f, 2.0f * F.fx) * 2.0f;
  if (has_rot) F.angle = F.angle + rot_angle;
  // 1.0 / tensor is reciprocal(tensor) * 1.0
  F.inv_range = (1.0f / __ldg(depth_range)) * 1.0f;
  F.has_trans = has_trans;
  F.trans_scale = has_trans ? (1.0f / clamp_min(F.t_norm, kWgtMin)) * trans_mag : 0.0f;
  return F;
}

struct Seed {
  float mu, sigma_sq, a, b;
};

// seed_update.update_seeds for one seed in UPDATE matched at (u, v) of the
// current image; fr is its reference bearing. Returns the seed unchanged
// behind the camera or where the update is NaN.
__device__ Seed update_seed(const Frame& F, const Seed& s, float fr0, float fr1, float fr2,
                            float u, float v) {
  // camera.cam2world, normalized
  const float x = (u - F.cx) / F.fx;
  const float y = (v - F.cy) / F.fy;
  const float n = norm_inner(x, y, 1.0f);
  const float fc0 = x / n, fc1 = y / n, fc2 = 1.0f / n;

  // triangulation.triangulate_midpoint
  const float* t = F.t;
  const float f20 = rotate3(F.R + 0, fc0, fc1, fc2);
  const float f21 = rotate3(F.R + 3, fc0, fc1, fc2);
  const float f22 = rotate3(F.R + 6, fc0, fc1, fc2);
  const float b0 = sum_outer(fr0 * t[0], fr1 * t[1], fr2 * t[2]);
  const float b1 = sum_inner(f20 * t[0], f21 * t[1], f22 * t[2]);
  const float a00 = sum_outer(fr0 * fr0, fr1 * fr1, fr2 * fr2);
  const float a01 = sum_outer(fr0 * f20, fr1 * f21, fr2 * f22);
  const float a10 = -a01;
  const float a11 = -sum_inner(f20 * f20, f21 * f21, f22 * f22);
  const float det = a00 * a11 - a10 * a01;
  const float lam0 = (a11 * b0 - a10 * b1) / det;
  const float lam1 = (-a01 * b0 + a00 * b1) / det;
  const float p0 = 0.5f * (lam0 * fr0 + (t[0] + lam1 * f20));
  const float p1 = 0.5f * (lam0 * fr1 + (t[1] + lam1 * f21));
  const float p2 = 0.5f * (lam0 * fr2 + (t[2] + lam1 * f22));
  const float depth = norm_outer(p0, p1, p2);

  // triangulation.triangulation_uncertainty
  const float q0 = fr0 * depth - t[0];
  const float q1 = fr1 * depth - t[1];
  const float q2 = fr2 * depth - t[2];
  const float q_norm = norm_outer(q0, q1, q2);
  const float cos_alpha = b0 / F.t_norm;
  const float cos_beta = -sum_outer(q0 * t[0], q1 * t[1], q2 * t[2]) / (F.t_norm * q_norm);
  const float alpha = acosf(clamp(cos_alpha, -1.0f, 1.0f));
  const float beta = acosf(clamp(cos_beta, -1.0f, 1.0f));
  const float beta_plus = beta + F.angle;
  const float gamma_plus = (kPi - alpha) - beta_plus;
  const float z_plus = F.t_norm * sinf(beta_plus) / sinf(gamma_plus);
  const float tau = z_plus - depth;
  float tau_sq = tau * tau;
  if (F.has_trans) {
    const float tau_t = depth * F.trans_scale;
    tau_sq = tau_sq + tau_t * tau_t;
  }

  // Gaussian x Beta moment matching
  const float mu = s.mu, sigma_sq = s.sigma_sq, a = s.a, b = s.b;
  const float s_sq = (tau_sq * sigma_sq) / (tau_sq + sigma_sq);
  const float m = s_sq * (mu / sigma_sq + depth / tau_sq);
  const float ab = a + b;
  const float d = depth - mu;
  const float var = sigma_sq + tau_sq;
  const float pdf = expf(-(d * d) / (2.0f * var)) * rsqrtf(kTwoPi * var);
  float c1 = (a / ab) * pdf;
  float c2 = (b / ab) * F.inv_range;
  const float norm_const = c1 + c2;
  c1 = c1 / norm_const;
  c2 = c2 / norm_const;
  const float ab1 = ab + 1.0f;
  const float ab2 = ab + 2.0f;
  const float a1 = a + 1.0f;
  const float f = c1 * (a1 / ab1) + c2 * (a / ab1);
  const float e = c1 * (a1 * (a + 2.0f)) / (ab1 * ab2) + c2 * (a * a1 / (ab1 * ab2));
  const float c1m = c1 * m;
  if (!(p2 >= 0.0f) || isnan(c1m)) return s;
  const float mu_new = c1m + c2 * mu;
  Seed out;
  out.mu = mu_new;
  out.sigma_sq = c1 * (s_sq + m * m) + c2 * (sigma_sq + mu * mu) - mu_new * mu_new;
  out.a = (e - f) / (f - e / f);
  out.b = out.a * (1.0f - f) / f;
  return out;
}

// The match of one pixel: the rectified flavour unrectifies it from the
// back-warped planes (rect_match.unrectify), the generic one reads it.
struct Match {
  bool found;
  float u, v, best_ncc;
};

__device__ __forceinline__ Match unrectify(const float* back, const float* Hr, const float* Hc,
                                           float ncc_threshold, int i, int plane, int x,
                                           int y) {
  const float found_b = back[2 * plane + i];
  const float wgt = clamp_min(found_b, kWgtMin);
  const float disp_b = back[i] / wgt;
  const float ncc_b = back[plane + i] / wgt;
  // utils/warp.homography_coords under H_ref_to_rect
  const float xo = (float)x, yo = (float)y;
  const float den = safe(Hr[6] * xo + Hr[7] * yo + Hr[8]);
  const float xr = (Hr[0] * xo + Hr[1] * yo + Hr[2]) / den;
  const float yr = (Hr[3] * xo + Hr[4] * yo + Hr[5]) / den;
  const float uc_r = xr - disp_b;
  float den_c = Hc[6] * uc_r + Hc[7] * yr + Hc[8];
  den_c = fabsf(den_c) < kEps ? kEps : den_c;
  Match r;
  r.u = (Hc[0] * uc_r + Hc[1] * yr + Hc[2]) / den_c;
  r.v = (Hc[3] * uc_r + Hc[4] * yr + Hc[5]) / den_c;
  r.found = (found_b > 0.5f) && (ncc_b >= ncc_threshold);
  r.best_ncc = clamp(ncc_b, -1.0f, 1.0f);
  return r;
}

template <bool kRectified>
__global__ void __launch_bounds__(kBlock)
seed_update_kernel(const int* __restrict__ conv1, const float* __restrict__ mu,
                   const float* __restrict__ sigma_sq, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ f_ref,
                   const float* __restrict__ match_u, const float* __restrict__ match_v,
                   const float* __restrict__ back, const float* __restrict__ H_ref_to_rect,
                   const float* __restrict__ H_rect_to_curr,
                   const unsigned char* __restrict__ found, const float* __restrict__ u,
                   const float* __restrict__ v, const float* __restrict__ best_ncc,
                   const float* __restrict__ T_ref_curr, const float* __restrict__ fx,
                   const float* __restrict__ fy, const float* __restrict__ cx,
                   const float* __restrict__ cy, const float* __restrict__ depth_range,
                   float* __restrict__ mu_out, float* __restrict__ sigma_sq_out,
                   float* __restrict__ a_out, float* __restrict__ b_out,
                   int* __restrict__ conv_out, float* __restrict__ match_u_out,
                   float* __restrict__ match_v_out, float* __restrict__ ncc_out,
                   int* __restrict__ counts, int height, int width, float ncc_threshold,
                   int has_rot, float rot_angle, int has_trans, float trans_mag) {
  const int plane = height * width;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  int state = -1;
  if (i < plane) {
    Match mt;
    if (kRectified) {
      float Hr[9], Hc[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        Hr[k] = __ldg(H_ref_to_rect + k);
        Hc[k] = __ldg(H_rect_to_curr + k);
      }
      mt = unrectify(back, Hr, Hc, ncc_threshold, i, plane, i % width, i / width);
    } else {
      mt.found = found[i] != 0;
      mt.u = u[i];
      mt.v = v[i];
      mt.best_ncc = best_ncc[i];
    }
    // epipolar.apply_match_to_conv
    const int c1 = conv1[i];
    state = c1 == kUpdate ? (mt.found ? kUpdate : kNoMatch) : c1;
    Seed s{mu[i], sigma_sq[i], a[i], b[i]};
    if (state == kUpdate) {
      const Frame F = load_frame(T_ref_curr, fx, fy, cx, cy, depth_range, has_rot, rot_angle,
                                 has_trans, trans_mag);
      s = update_seed(F, s, f_ref[i], f_ref[plane + i], f_ref[2 * plane + i], mt.u, mt.v);
    } else if (state == kNoMatch) {
      s.b = s.b + 1.0f;
    }
    mu_out[i] = s.mu;
    sigma_sq_out[i] = s.sigma_sq;
    a_out[i] = s.a;
    b_out[i] = s.b;
    conv_out[i] = state;
    match_u_out[i] = state == kUpdate ? mt.u : match_u[i];
    match_v_out[i] = state == kUpdate ? mt.v : match_v[i];
    ncc_out[i] = mt.found ? mt.best_ncc : 0.0f;
  }
  // reduction.convergence_stats
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int n = __syncthreads_count(state == k);
    if (threadIdx.x == 0 && n > 0) atomicAdd(counts + k, n);
  }
}

}  // namespace

// counts must be zero on entry; the kernel adds each state's count to it.
extern "C" int remode_seed_update(
    const int* conv1, const float* mu, const float* sigma_sq, const float* a, const float* b,
    const float* f_ref, const float* match_u, const float* match_v, const float* back,
    const float* H_ref_to_rect, const float* H_rect_to_curr, const unsigned char* found,
    const float* u, const float* v, const float* best_ncc, const float* T_ref_curr,
    const float* fx, const float* fy, const float* cx, const float* cy,
    const float* depth_range, float* mu_out, float* sigma_sq_out, float* a_out, float* b_out,
    int* conv_out, float* match_u_out, float* match_v_out, float* ncc_out, int* counts,
    int height, int width, float ncc_threshold, int has_rot, float rot_angle, int has_trans,
    float trans_mag, int rectified, void* stream) {
  const int n = height * width;
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (rectified) {
    seed_update_kernel<true><<<grid, kBlock, 0, s>>>(
        conv1, mu, sigma_sq, a, b, f_ref, match_u, match_v, back, H_ref_to_rect,
        H_rect_to_curr, found, u, v, best_ncc, T_ref_curr, fx, fy, cx, cy, depth_range, mu_out,
        sigma_sq_out, a_out, b_out, conv_out, match_u_out, match_v_out, ncc_out, counts, height,
        width, ncc_threshold, has_rot, rot_angle, has_trans, trans_mag);
  } else {
    seed_update_kernel<false><<<grid, kBlock, 0, s>>>(
        conv1, mu, sigma_sq, a, b, f_ref, match_u, match_v, back, H_ref_to_rect,
        H_rect_to_curr, found, u, v, best_ncc, T_ref_curr, fx, fy, cx, cy, depth_range, mu_out,
        sigma_sq_out, a_out, b_out, conv_out, match_u_out, match_v_out, ncc_out, counts, height,
        width, ncc_threshold, has_rot, rot_angle, has_trans, trans_mag);
  }
  return (int)cudaGetLastError();
}
