// Integer-disparity ZNCC sweep on the rectified grid, with the (pixel, plane)
// pairs of each 8x32 tile spread evenly over its threads.
//
// Replaces the Pallas kernel rpg_open_remode_tpu/ops/sweep_pallas.py:
// _sweep_kernel (wrapper disparity_sweep). Its plain PyTorch version is
// rpg_open_remode_tpu_torch/ops/sweep_cuda.py:disparity_sweep_plain, a port
// of rect_match._sweep_xla.
//
// What bounds it on an H100: operations. Each (pixel, plane) pair that its
// band admits costs 3 patch sums (curr, curr^2, curr*ref: ~5 flops per tap,
// 125 at the 5x5 patch, 405 at 9x9) against ~36 bytes of unique input per
// pixel. What held the one-thread-per-pixel loop back: a warp ran as long
// as its longest band (bands are ragged: a young frame's median is 6 planes,
// its p99 61), so about half of the lanes idled, and every tap was two
// bounds-checked loads. The design:
//
//  1. Each thread owns one pixel of the block's 8x32 tile and computes the
//     one interval of planes its masks admit: the band [ceil(dlo - 0.5),
//     floor(dhi + 0.5)], the plane cap [0, K - 1] and the footprint limit
//     xlim (x - k in [xmin, xmax], a monotone test in k, so an interval too;
//     its ends are found in float and then fixed with the exact test). A
//     block whose pixels admit no plane writes the not-found result and
//     leaves before it loads anything.
//  2. The ref and valid tiles (with their halo) are staged in shared memory
//     with cp.async, zero-filled outside the buffers as the plain version's
//     zero padding; each pixel computes its template statistics once.
//  3. A block prefix sum of the interval lengths numbers the tile's pairs;
//     the window of curr_pad that the tile's planes reach, (32 + hull + 2 hp)
//     x (8 + 2 hp) floats, is staged with cp.async; then the threads take the
//     pairs in turn (pair t -> thread t mod 256), so every warp but the
//     tile's last is full, and each score goes to shared memory.
//  4. Each pixel's owner scans its own scores in plane order with the
//     running-best rules. Planes outside the interval score -1e30, and
//     starting prev and right at -1e30 gives exactly the result of the scan
//     over all K planes: a masked plane never beats best (which starts at
//     -1) and matters only as a neighbour, where -1e30 is what the full scan
//     would see. The scan costs a few operations per pair, against ~7 per
//     tap of the score.
// Pairs are processed in chunks of kChunk, so shared memory stays bounded
// whatever the bands; the scan carries its state from chunk to chunk.
//
// remode_sweep_lanes runs a counting build of the same kernel, which adds
// up, for every warp-step of the scoring loop (step 3) and of the per-pixel
// loops (the owner map and the scan, step 4), the lanes that ran it
// (__activemask) and the warp's 32 lanes: the measured lane efficiency of
// each. remode_sweep's build has no counters.
//
// Semantics kept exactly (ROADMAP queue 3): masked plane scores -1e30;
// best starts at -1 and its plane at -10; strict '>' keeps the lowest plane
// among ties; 'right' takes the score of plane best+1 even when masked;
// parabolic refinement only when both neighbours are > -5e29 and
// |den| > 1e-12, clipped to +-0.5; found = best >= threshold && best >= 0.
//
// The gate: the coarse pass is launched on every rectified frame with a
// device pointer to the 0-d bool that decides whether it is wanted (the JAX
// package's lax.cond, ops/rect_match.prepare_sweep), so no host reads it.
// When it is off, every pixel's interval is empty: each block writes the
// not-found result (disp -10, ncc -1, found 0) and leaves without staging
// anything. A null gate is on.
//
// Built with -fmad=false (kernels.py), and each patch sum adds as the plain
// version's separable box sums do (every row left to right, then the rows
// top to bottom), so the kernel equals the plain version bit for bit: the
// parabolic refinement divides by the NCC's second difference, which is
// small on smooth real texture, and an FMA's different rounding moved the
// refined disparity by more than 1e-3 on ~1/4 of a real frame's pixels.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kFltMin = 1.1754944e-38f;
constexpr int kTw = 32;                 // tile width: one warp of x
constexpr int kTh = 8;                  // tile height: eight warps
constexpr int kThreads = kTw * kTh;
constexpr int kChunk = 2048;            // pairs scored between two scans

// 4-byte asynchronous copy global -> shared; reads nothing and writes 0
// when `pred` is false (the zero halo outside the buffers)
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// stage rows [r0, r0 + rows) x cols [c0, c0 + cols) of an [h, w] buffer
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0,
                                      int c0, int rows, int cols, int h, int w) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = r0 + i / cols, c = c0 + i % cols;
    const bool in = r >= 0 && r < h && c >= 0 && c < w;
    cp_async_f32(dst + i, in ? src + (size_t)r * w + c : src, in);
  }
}

// counting build only: one warp-step of a loop, the lanes that ran it
// into lanes[0] and 32 into lanes[1]
template <bool kCount>
__device__ __forceinline__ void count_lanes(unsigned long long* lanes) {
  if constexpr (kCount) {
    const unsigned m = __activemask();
    if ((threadIdx.x & 31) == __ffs(m) - 1) {
      atomicAdd(lanes, (unsigned long long)__popc(m));
      atomicAdd(lanes + 1, 32ull);
    }
  }
}

// exclusive block prefix sum of v; returns the sum before this thread's and
// writes the block total to *total
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < kTh; ++i) {
    before += i < wid ? warp_sums[i] : 0;
    all += warp_sums[i];
  }
  *total = all;
  return before + incl - v;
}

template <int HP, bool kCount>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ curr,   // [H, W + 2 pad]
                 const float* __restrict__ xlim,   // [H, 2]
                 const float* __restrict__ ref,    // [H, W]
                 const float* __restrict__ valid,  // [H, W]
                 const float* __restrict__ dlo,    // [H, W]
                 const float* __restrict__ dhi,    // [H, W]
                 float* __restrict__ disp, float* __restrict__ ncc_out,
                 unsigned char* __restrict__ found, int h, int w, int pad, int num_planes,
                 float threshold, int refine,
                 const unsigned char* __restrict__ gate,    // 0-d bool or null
                 unsigned long long* __restrict__ lanes) {  // [4], counting build

  constexpr int kS = 2 * HP + 1;
  constexpr int kRw = kTw + 2 * HP, kRh = kTh + 2 * HP;  // tile with its halo
  const float area = (float)(kS * kS);
  const int tid = threadIdx.x, tx = tid % kTw, ty = tid / kTw;
  const int x0 = blockIdx.x * kTw, y0 = blockIdx.y * kTh;
  const int x = x0 + tx, y = y0 + ty;
  const bool in = x < w && y < h;
  const size_t idx = (size_t)y * w + x;
  const int wc = w + 2 * pad;

  extern __shared__ float smem[];
  float* ref_t = smem;                        // [kRh, kRw]
  float* val_t = ref_t + kRh * kRw;           // [kRh, kRw]
  float* st_s = val_t + kRh * kRw;            // [kThreads] template sum
  float* dt_s = st_s + kThreads;              // [kThreads] template denominator
  float* score = dt_s + kThreads;             // [kChunk]
  int* base_s = reinterpret_cast<int*>(score + kChunk);  // [kThreads] k - t
  int* misc = base_s + kThreads;              // [kTh] warp sums, then 2: hull
  unsigned char* owner = reinterpret_cast<unsigned char*>(misc + kTh + 2);  // [kChunk]
  float* win = reinterpret_cast<float*>(owner + kChunk);  // [kRh, 32 + K - 1 + 2 HP]

  // 1. the interval of planes this pixel's masks admit; a gate that is off
  // empties every interval, so the block writes the not-found result and
  // leaves before it loads anything else
  int k0 = 0, k1 = -1;
  if (in && (gate == nullptr || *gate != 0)) {
    // clamped in float first: empty bands carry +inf / -inf
    const float lo = dlo[idx] - 0.5f, hi = dhi[idx] + 0.5f;
    const float klo = fmaxf(ceilf(lo), 0.0f);
    const float khi = fminf(floorf(hi), (float)(num_planes - 1));
    const float xmin = xlim[2 * y], xmax = xlim[2 * y + 1];
    if (!isnan(lo) && !isnan(hi) && !isnan(xmin) && !isnan(xmax) && klo <= khi) {
      k0 = (int)klo;
      k1 = (int)khi;
      // plane k passes iff xf - k >= xmin (true up to some k) and
      // xf - k <= xmax (true from some k): estimate both ends in float,
      // clamped to [k0 - 1, k1 + 1], then settle them with the exact test
      const float xf = (float)x;
      int ub = (int)fminf(fmaxf(floorf(xf - xmin), (float)(k0 - 1)), (float)(k1 + 1));
      while (ub >= k0 && !(xf - (float)ub >= xmin)) --ub;
      while (ub + 1 <= k1 && xf - (float)(ub + 1) >= xmin) ++ub;
      int lb = (int)fminf(fmaxf(ceilf(xf - xmax), (float)(k0 - 1)), (float)(k1 + 1));
      while (lb <= k1 && !(xf - (float)lb <= xmax)) ++lb;
      while (lb - 1 >= k0 && xf - (float)(lb - 1) <= xmax) --lb;
      k0 = max(k0, lb);
      k1 = min(k1, ub);
    }
  }

  float best = -1.0f, left = kNeg, right = kNeg;
  int bk = -10;
  if (__syncthreads_or(k0 <= k1)) {
    // 2. ref and valid tiles with their halo; template statistics, added
    // as the plain version's separable box sums add
    stage(ref_t, ref, y0 - HP, x0 - HP, kRh, kRw, h, w);
    stage(val_t, valid, y0 - HP, x0 - HP, kRh, kRw, h, w);
    cp_async_wait_all();
    __syncthreads();
    int n = 0;
    if (k0 <= k1) {
      float st = 0.0f, stt = 0.0f, sv = 0.0f;
#pragma unroll
      for (int dy = 0; dy < kS; ++dy) {
        float rt = 0.0f, rtt = 0.0f, rv = 0.0f;
#pragma unroll
        for (int dx = 0; dx < kS; ++dx) {
          const float r = ref_t[(ty + dy) * kRw + tx + dx];
          rt += r;
          rtt += r * r;
          rv += val_t[(ty + dy) * kRw + tx + dx] > 0.999f ? 1.0f : 0.0f;
        }
        st += rt;
        stt += rtt;
        sv += rv;
      }
      const float denom_t = area * stt - st * st;
      st_s[tid] = st;
      dt_s[tid] = denom_t;
      if (sv > area - 0.5f && denom_t > 1e-10f) n = k1 - k0 + 1;
    }

    // 3. number the tile's pairs; the hull of its planes
    int total;
    const int off = block_scan(n, misc, &total);
    if (tid == 0) {
      misc[kTh] = num_planes;
      misc[kTh + 1] = -1;
    }
    __syncthreads();
    if (n > 0) {
      atomicMin(&misc[kTh], k0);
      atomicMax(&misc[kTh + 1], k1);
    }
    base_s[tid] = k0 - off;
    __syncthreads();
    const int kmin = misc[kTh], kmax = misc[kTh + 1];
    if (total > 0) {
      // curr_pad columns x + pad - k + (dx - HP) over the tile's x and planes
      const int ww = kTw + (kmax - kmin) + 2 * HP;
      stage(win, curr, y0 - HP, x0 + pad - kmax - HP, kRh, ww, h, wc);
      cp_async_wait_all();
      __syncthreads();

      float prev = kNeg;
      for (int cs = 0; cs < total; cs += kChunk) {
        const int ce = min(total, cs + kChunk);
        const int t0 = max(off, cs), t1 = min(off + n, ce);
        for (int t = t0; t < t1; ++t) {
          count_lanes<kCount>(lanes + 2);
          owner[t - cs] = (unsigned char)tid;
        }
        __syncthreads();
        for (int t = cs + tid; t < ce; t += kThreads) {
          count_lanes<kCount>(lanes);
          const int p = owner[t - cs];
          const int k = t + base_s[p];
          const int px = p % kTw, py = p / kTw;
          const float* wr = win + py * ww + px + (kmax - k);
          const float* rr = ref_t + py * kRw + px;
          float si = 0.0f, sii = 0.0f, sit = 0.0f;
#pragma unroll
          for (int dy = 0; dy < kS; ++dy) {
            float ri = 0.0f, rii = 0.0f, rit = 0.0f;
#pragma unroll
            for (int dx = 0; dx < kS; ++dx) {
              const float c = wr[dy * ww + dx];
              const float r = rr[dy * kRw + dx];
              ri += c;
              rii += c * c;
              rit += c * r;
            }
            si += ri;
            sii += rii;
            sit += rit;
          }
          const float num = area * sit - si * st_s[p];
          const float den_l = area * sii - si * si;
          score[t - cs] =
              den_l > 1e-10f ? num * rsqrtf(fmaxf(den_l * dt_s[p], kFltMin)) : kNeg;
        }
        __syncthreads();
        // 4. this pixel's scores in plane order
        for (int t = t0; t < t1; ++t) {
          count_lanes<kCount>(lanes + 2);
          const int k = t + base_s[tid];
          const float v = score[t - cs];
          if (v > best) {
            left = prev;
            right = kNeg;
            bk = k;
            best = v;
          } else if (bk == k - 1) {
            right = v;
          }
          prev = v;
        }
        __syncthreads();
      }
    }
  }
  if (!in) return;

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

// The dynamic shared memory of one block (the layout at the top of
// sweep_kernel; the curr window as wide as num_planes can make it), opted
// in past the default 48 KB (patch 15 with 383 planes needs 59,112 B).
// The opt-in is made once per device and size, at the first launch that
// needs it: a launch captured into a CUDA graph after an eager one of the
// same shapes sets no attribute.
template <int HP, bool kCount>
cudaError_t block_smem(int num_planes, size_t* bytes) {
  constexpr int kRw = kTw + 2 * HP, kRh = kTh + 2 * HP;
  constexpr int kDevices = 64;
  static size_t opted[kDevices] = {};  // bytes opted in so far, per device
  const size_t win = (size_t)kRh * (kTw + num_planes - 1 + 2 * HP);
  *bytes = sizeof(float) * (2 * kRh * kRw + 2 * kThreads + kChunk) +
           sizeof(int) * (kThreads + kTh + 2) + kChunk + sizeof(float) * win;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && opted[dev] >= *bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(sweep_kernel<HP, kCount>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  if (e == cudaSuccess && dev < kDevices) opted[dev] = *bytes;
  return e;
}

template <int HP>
int occupancy(int num_planes, int* bytes, int* blocks) {
  size_t b = 0;
  cudaError_t e = block_smem<HP, false>(num_planes, &b);
  *bytes = (int)b;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sweep_kernel<HP, false>,
                                                            kThreads, b);
}

template <int HP, bool kCount>
int launch(const float* curr, const float* xlim, const float* ref, const float* valid,
           const float* dlo, const float* dhi, float* disp, float* ncc,
           unsigned char* found, int h, int w, int pad, int num_planes, float threshold,
           int refine, const unsigned char* gate, unsigned long long* lanes,
           cudaStream_t stream) {
  size_t bytes = 0;
  const cudaError_t e = block_smem<HP, kCount>(num_planes, &bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w + kTw - 1) / kTw, (h + kTh - 1) / kTh);
  sweep_kernel<HP, kCount><<<grid, kThreads, bytes, stream>>>(
      curr, xlim, ref, valid, dlo, dhi, disp, ncc, found, h, w, pad, num_planes, threshold,
      refine, gate, lanes);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, HP>) for the patch's half-width HP = 0..8
// (patches 1..17), each HP its own kernel instance
template <typename F>
int with_half_patch(int patch_side, F&& f) {
  switch (patch_side / 2) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kCount>
int dispatch(const float* curr, const float* xlim, const float* ref, const float* valid,
             const float* dlo, const float* dhi, float* disp, float* ncc,
             unsigned char* found, int h, int w, int pad, int num_planes, int patch_side,
             float threshold, int refine, const unsigned char* gate,
             unsigned long long* lanes, cudaStream_t s) {
  return with_half_patch(patch_side, [&](auto hp) {
    return launch<decltype(hp)::value, kCount>(curr, xlim, ref, valid, dlo, dhi, disp, ncc,
                                               found, h, w, pad, num_planes, threshold,
                                               refine, gate, lanes, s);
  });
}

}  // namespace

extern "C" int remode_sweep(const float* curr, const float* xlim, const float* ref,
                            const float* valid, const float* dlo, const float* dhi,
                            float* disp, float* ncc, unsigned char* found, int h,
                            int w, int pad, int num_planes, int patch_side,
                            float threshold, int refine, const unsigned char* gate,
                            void* stream) {
  return dispatch<false>(curr, xlim, ref, valid, dlo, dhi, disp, ncc, found, h, w, pad,
                         num_planes, patch_side, threshold, refine, gate, nullptr,
                         (cudaStream_t)stream);
}

// The counting build (see the header): lanes[0..1] for the scoring loop,
// lanes[2..3] for the per-pixel loops, added to what they hold.
extern "C" int remode_sweep_lanes(const float* curr, const float* xlim, const float* ref,
                                  const float* valid, const float* dlo, const float* dhi,
                                  float* disp, float* ncc, unsigned char* found, int h,
                                  int w, int pad, int num_planes, int patch_side,
                                  float threshold, int refine, const unsigned char* gate,
                                  unsigned long long* lanes, void* stream) {
  return dispatch<true>(curr, xlim, ref, valid, dlo, dhi, disp, ncc, found, h, w, pad,
                        num_planes, patch_side, threshold, refine, gate, lanes,
                        (cudaStream_t)stream);
}

// The launch figures of remode_sweep at this patch and plane count: the
// dynamic shared memory of one block, in bytes, and the blocks of 256
// threads one SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int remode_sweep_occupancy(int patch_side, int num_planes, int* bytes,
                                      int* blocks) {
  return with_half_patch(patch_side, [&](auto hp) {
    return occupancy<decltype(hp)::value>(num_planes, bytes, blocks);
  });
}
