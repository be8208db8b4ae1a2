// K2, K2k and K3: semi-global matching scans over an (H, W, D) cost volume
// (COST orientation; SCORE volumes arrive negated from box_cv.cu).
//
// K2 `sgm_pass_kernel` replaces the TPU kernel `_dhw_rows_kernel` with its DP
// step `_dw_step` (libstevi_tpu/ops/sgm_pallas_dhw.py:164, :84), launched by
// `_rows_call` (:581).  One launch runs ONE scan direction and adds that
// direction's adjustment into the f32 accumulator acc (H, W, D):
//   adj = min(prev[d], prev[d +- 1] + P1, min(prev) + P2) - min(prev)
//         (+ Pout where j + d >= W, j the image column),  carry = cost + adj,
// with lines starting from a zero carry and enumerated as `addDirectionalCost`
// does (libstevi_tpu/ops/sgm.py `_build_lines`): the diagonal line that starts
// at the image corner is enumerated from both start edges and counts twice.
//
// K2k `sgm_knight_kernel` carries the eight knight-move directions of
// 16-direction SGM, which the TPU kernels ran as extra carries of the same
// passes (`_knight_row` :107, `_knight_weights` :532).  A knight line
// alternates two steps (`sgm.h:112-155`): step c uses steps[c % 2], the
// first of which moves along the primary axis only and the second also
// drifts one pixel sideways.  `addDirectionalCost` (sgm.h:329-355) seeds a
// line at every pixel of two edges, and here lines are NOT disjoint: the
// line from the corner and the line from the next side pixel both reach,
// e.g. for UPLEFT2DOWN, (1, 0) and (3, 1).  The step taken at a pixel
// depends only on the parity of its distance from its seed along the
// primary axis, so lines whose seeds lie at the same parity never meet:
// phase 0 holds the start-edge seeds (offset 0) and the side seeds at even
// offsets, phase 1 the side seeds at odd offsets.  One launch runs one
// phase, one warp a line; inside a launch every pixel lies on at most one
// line, except the corner line, enumerated from both edges, which one warp
// walks with weight 2.  Two launches a direction on one stream: no
// atomics, and the same acc on every run.
//
// K3 `sgm_wta_kernel` replaces `_dhw_wta_kernel` (sgm_pallas_dhw.py:374,
// launched at :975): the last direction (right to left) fused with
// C = cost + acc + adj, the tie-last argmin (the largest d among equal
// minima), the band C[idx - r .. idx + r] (+inf outside [0, D)) and the
// parabola subpixel with the SAME-mode NaN rules of `truncated_cost_volume`.
//
// Layout and mapping: one warp per scanline; lane l owns d = l + 32k
// (k < K = ceil(D / 32), so D = 120 takes 4 values a lane), lanes with
// d >= D hold +inf.  d +- 1 comes from warp shuffles across the k slices and
// min over d is a shuffle reduction, so the carry never leaves registers and
// the DP runs in f32 whatever the volume's type.  The volume's D axis is
// contiguous, so each step reads one pixel's D values with consecutive lanes.
// For K2 every pixel lies on exactly one line of a direction, so a launch
// needs no atomics and is deterministic; directions run one launch after
// another on the caller's stream.  K2 and K2k take the image column of the
// volume's first column (col0) and the image width (W_pout) for the Pout
// test, so a region inside SGM margins runs as a volume of its own; K3
// takes whole images (with margins the caller runs WTA and band itself).
// D <= 320: K = ceil(D / 32) <= 10 values a lane.  The TPU path needed a
// (W, D, H) transpose of the volume and of the accumulator for the
// horizontal passes; this one reads (H, W, D) for every direction.
//
// What bounds it on an H100: at 480x640x120 the bf16 volume is 73.7 MB and
// the f32 acc 147 MB, so one pass moves ~370 MB (~0.11 ms at 3.35 TB/s).  But
// a scan has only H, W or H + W - 1 lines (480 to 1119 warps for 132 SMs), and
// each step is a dependent chain of shuffles, so the DP is latency and issue
// bound, not bandwidth bound.  The next pixel's cost and acc are loaded
// before the current step's shuffles to hide part of the load latency.  A
// K2k direction is two such launches in a row, each as long as its longest
// line, and its phase-1 launch has only H / 2 or W / 2 lines.
// Left for later PRs: tiles of d per warp with coalesced 16-byte loads, a
// fused multi-direction pass (fewer acc round trips; for K2k, one phase of
// one direction beside another direction's), deeper prefetch, and CUDA
// graphs over the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;  // scanlines (warps) per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// One step of the cost-mode recurrence (correlation/sgm.h:230-300; the JAX
// `_line_recurrence`, op for op) for the K slices a lane owns.  j is the
// image column of the pixel and W the image width, for the Pout test.
template <int K>
__device__ __forceinline__ void dp_step(const float (&prev)[K], float (&adj)[K],
                                        int lane, int j, int W, float P1,
                                        float P2, float Pout) {
  float p[K];
  float lm = INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    p[k] = isfinite(prev[k]) ? prev[k] : INFINITY;
    lm = fminf(lm, p[k]);
  }
  const float m = warp_min(lm);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float up = __shfl_up_sync(FULL, p[k], 1);  // prev[d - 1]
    const float up_wrap =
        __shfl_sync(FULL, k > 0 ? p[k > 0 ? k - 1 : 0] : INFINITY, 31);
    if (lane == 0) up = up_wrap;
    float dn = __shfl_down_sync(FULL, p[k], 1);  // prev[d + 1]
    const float dn_wrap =
        __shfl_sync(FULL, k + 1 < K ? p[k + 1 < K ? k + 1 : k] : INFINITY, 0);
    if (lane == 31) dn = dn_wrap;
    float agg = fminf(fminf(p[k], m + P2), fminf(up + P1, dn + P1));
    if (j + lane + 32 * k >= W) agg += Pout;  // disparity leaves the image
    adj[k] = (isfinite(agg) && isfinite(m)) ? agg - m : 0.f;
  }
}

// K2: one scan direction (di, dj) in {-1, 0, 1}^2 \ {(0, 0)}.
template <int K, typename T>
__global__ void __launch_bounds__(32 * WARPS)
sgm_pass_kernel(const T* __restrict__ cv, float* __restrict__ acc, int H,
                int W, int D, int di, int dj, float P1, float P2, float Pout,
                int accumulate, int col0, int W_pout) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int si, sj, len;
  float w = 1.f;
  if (di == 0) {  // horizontal: one line per row
    if (line >= H) return;
    si = line;
    sj = dj > 0 ? 0 : W - 1;
    len = W;
  } else if (dj == 0) {  // vertical: one line per column
    if (line >= W) return;
    si = di > 0 ? 0 : H - 1;
    sj = line;
    len = H;
  } else {  // diagonal: H lines from the side edge, W - 1 from the top/bottom
    if (line >= H + W - 1) return;
    const int ie = di > 0 ? 0 : H - 1, je = dj > 0 ? 0 : W - 1;
    if (line < H) {
      si = line;
      sj = je;
      if (si == ie) w = 2.f;  // the corner line, enumerated from both edges
    } else {
      const int t = line - H + 1;
      si = ie;
      sj = dj > 0 ? t : W - 1 - t;
    }
    len = min(di > 0 ? H - si : si + 1, dj > 0 ? W - sj : sj + 1);
  }
  const long long step = (long long)di * W + dj;
  long long pix = (long long)si * W + sj;

  float carry[K], bn[K], an[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    carry[k] = d < D ? 0.f : INFINITY;  // lines start from a zero carry
    bn[k] = d < D ? load(cv + pix * D + d) : INFINITY;
    an[k] = (accumulate && d < D) ? acc[pix * D + d] : 0.f;
  }
  int j = sj;
  for (int t = 0; t < len; ++t) {
    float b[K], a[K], adj[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      b[k] = bn[k];
      a[k] = an[k];
    }
    if (t + 1 < len) {  // prefetch the next pixel of the line
      const long long nxt = pix + step;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane + 32 * k;
        if (d < D) {
          bn[k] = load(cv + nxt * D + d);
          an[k] = accumulate ? acc[nxt * D + d] : 0.f;
        }
      }
    }
    dp_step<K>(carry, adj, lane, col0 + j, W_pout, P1, P2, Pout);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        carry[k] = b[k] + adj[k];
        acc[pix * D + d] = a[k] + w * adj[k];
      }
    }
    pix += step;
    j += dj;
  }
}

// K2k: one seed phase of one knight direction with steps (v0, h0), (v1, h1).
// Vertical-primary directions (v0 == v1) seed at every column of the top
// or bottom row and at every row of one side column; horizontal-primary
// ones the other way round.  The start edge is the one whose seeds sit at
// offset 0 along the primary axis; the corner seed belongs to both edges.
template <int K, typename T>
__global__ void __launch_bounds__(32 * WARPS)
sgm_knight_kernel(const T* __restrict__ cv, float* __restrict__ acc, int H,
                  int W, int D, int v0, int v1, int h0, int h1, int phase,
                  float P1, float P2, float Pout, int col0, int W_pout) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int si_top = (v0 >= 0 && v1 >= 0) ? 0 : H - 1;   // sgm.h:329-355
  const int sj_side = (h0 >= 0 && h1 >= 0) ? 0 : W - 1;
  const bool vert = v0 == v1;
  const int n_edge = vert ? W : H;  // start-edge seeds, offset 0
  const int n_side = vert ? H : W;  // seeds along the other edge, by offset
  int si, sj;
  float w = 1.f;
  if (phase == 0 && line < n_edge) {
    si = vert ? si_top : line;
    sj = vert ? line : sj_side;
    if (si == si_top && sj == sj_side) w = 2.f;  // the corner line
  } else {
    const int off = phase == 0 ? 2 * (line - n_edge + 1) : 2 * line + 1;
    if (off >= n_side) return;
    if (vert) {
      si = si_top == 0 ? off : si_top - off;
      sj = sj_side;
    } else {
      si = si_top;
      sj = sj_side == 0 ? off : sj_side - off;
    }
  }
  long long pix = (long long)si * W + sj;

  float carry[K], bn[K], an[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    carry[k] = d < D ? 0.f : INFINITY;  // lines start from a zero carry
    bn[k] = d < D ? load(cv + pix * D + d) : INFINITY;
    an[k] = d < D ? acc[pix * D + d] : 0.f;
  }
  int i = si, j = sj;
  for (int c = 0;; ++c) {
    float b[K], a[K], adj[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      b[k] = bn[k];
      a[k] = an[k];
    }
    const int ni = i + ((c & 1) ? v1 : v0), nj = j + ((c & 1) ? h1 : h0);
    const bool more = ni >= 0 && ni < H && nj >= 0 && nj < W;
    const long long nxt = (long long)ni * W + nj;
    if (more) {  // prefetch the next pixel of the line
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane + 32 * k;
        if (d < D) {
          bn[k] = load(cv + nxt * D + d);
          an[k] = acc[nxt * D + d];
        }
      }
    }
    dp_step<K>(carry, adj, lane, col0 + j, W_pout, P1, P2, Pout);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        carry[k] = b[k] + adj[k];
        acc[pix * D + d] = a[k] + w * adj[k];
      }
    }
    if (!more) break;
    pix = nxt;
    i = ni;
    j = nj;
  }
}

// K3: the right-to-left direction fused with WTA, band and subpixel.  One
// warp per image row of a whole image.  disp may be null (no subpixel).
template <int K, typename T>
__global__ void __launch_bounds__(32 * WARPS)
sgm_wta_kernel(const T* __restrict__ cv, const float* __restrict__ acc,
               int* __restrict__ idx_out, float* __restrict__ bands,
               float* __restrict__ disp, int H, int W, int D, float P1,
               float P2, float Pout, int r, int hr, int vr) {
  __shared__ float cbuf[WARPS][32 * K];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int i = blockIdx.x * WARPS + wid;
  if (i >= H) return;
  float* c_s = cbuf[wid];
  const int nb = 2 * r + 1;
  const bool row_ok = i >= vr && i + vr < H;

  long long pix = (long long)i * W + (W - 1);
  float carry[K], bn[K], an[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    carry[k] = d < D ? 0.f : INFINITY;
    bn[k] = d < D ? load(cv + pix * D + d) : INFINITY;
    an[k] = d < D ? acc[pix * D + d] : 0.f;
  }
  for (int j = W - 1; j >= 0; --j, --pix) {
    float b[K], a[K], adj[K], C[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      b[k] = bn[k];
      a[k] = an[k];
    }
    if (j > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane + 32 * k;
        if (d < D) {
          bn[k] = load(cv + (pix - 1) * D + d);
          an[k] = acc[(pix - 1) * D + d];
        }
      }
    }
    dp_step<K>(carry, adj, lane, j, W, P1, P2, Pout);
    float lm = INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      C[k] = INFINITY;
      if (d < D) {
        carry[k] = b[k] + adj[k];
        C[k] = a[k] + adj[k] + b[k];
        c_s[d] = C[k];
      }
      lm = fminf(lm, C[k]);
    }
    const float m = warp_min(lm);
    int best = -1;
#pragma unroll
    for (int k = 0; k < K; ++k)  // slices ascend in d: keep the last hit
      if (lane + 32 * k < D && C[k] == m) best = lane + 32 * k;
    best = warp_max(best);  // ties go to the LAST index (correlation_base.h:446)
    __syncwarp();
    for (int s = lane; s < nb; s += 32) {
      const int p = best + s - r;
      bands[pix * nb + s] = (p >= 0 && p < D) ? c_s[p] : INFINITY;
    }
    if (lane == 0) {
      idx_out[pix] = best;
      if (disp != nullptr) {
        // SAME-mode slot validity (correlation_base.h:582-674): NaN slots
        // make the refined disparity NaN, as the composed chain does
        auto slot = [&](int off) {
          const int p = best + off;
          const bool ok = p >= 0 && p < D && j >= hr && j + p + hr < W && row_ok;
          return ok ? c_s[p] : NAN;
        };
        const float cm1 = slot(-1), c0 = slot(0), c1 = slot(1);
        disp[pix] = (float)best + (cm1 - c1) / (2.f * (c1 - 2.f * c0 + cm1));
      }
    }
    __syncwarp();  // c_s is rewritten at the next pixel
  }
}

template <typename T>
cudaError_t pass_t(int K, const void* cv, float* acc, int H, int W, int D,
                   int di, int dj, float P1, float P2, float Pout,
                   int accumulate, int col0, int W_pout, cudaStream_t s) {
  const int lines = di == 0 ? H : (dj == 0 ? W : H + W - 1);
  const int blocks = (lines + WARPS - 1) / WARPS;
  const T* v = static_cast<const T*>(cv);
#define SGM_PASS_CASE(k)                                                   \
  case k:                                                                  \
    sgm_pass_kernel<k, T><<<blocks, 32 * WARPS, 0, s>>>(                   \
        v, acc, H, W, D, di, dj, P1, P2, Pout, accumulate, col0, W_pout);  \
    break;
  switch (K) {
    SGM_PASS_CASE(1) SGM_PASS_CASE(2) SGM_PASS_CASE(3) SGM_PASS_CASE(4)
    SGM_PASS_CASE(5) SGM_PASS_CASE(6) SGM_PASS_CASE(7) SGM_PASS_CASE(8)
    SGM_PASS_CASE(9) SGM_PASS_CASE(10)
    default: return cudaErrorInvalidValue;
  }
#undef SGM_PASS_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t knight_t(int K, const void* cv, float* acc, int H, int W, int D,
                     int v0, int v1, int h0, int h1, int phase, float P1,
                     float P2, float Pout, int col0, int W_pout,
                     cudaStream_t s) {
  const bool vert = v0 == v1;
  const int n_edge = vert ? W : H, n_side = vert ? H : W;
  const int lines = phase == 0 ? n_edge + (n_side - 1) / 2 : n_side / 2;
  if (lines == 0) return cudaSuccess;
  const int blocks = (lines + WARPS - 1) / WARPS;
  const T* v = static_cast<const T*>(cv);
#define SGM_KNIGHT_CASE(k)                                                 \
  case k:                                                                  \
    sgm_knight_kernel<k, T><<<blocks, 32 * WARPS, 0, s>>>(                 \
        v, acc, H, W, D, v0, v1, h0, h1, phase, P1, P2, Pout, col0,        \
        W_pout);                                                           \
    break;
  switch (K) {
    SGM_KNIGHT_CASE(1) SGM_KNIGHT_CASE(2) SGM_KNIGHT_CASE(3)
    SGM_KNIGHT_CASE(4) SGM_KNIGHT_CASE(5) SGM_KNIGHT_CASE(6)
    SGM_KNIGHT_CASE(7) SGM_KNIGHT_CASE(8) SGM_KNIGHT_CASE(9)
    SGM_KNIGHT_CASE(10)
    default: return cudaErrorInvalidValue;
  }
#undef SGM_KNIGHT_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t wta_t(int K, const void* cv, const float* acc, int* idx,
                  float* bands, float* disp, int H, int W, int D, float P1,
                  float P2, float Pout, int r, int hr, int vr,
                  cudaStream_t s) {
  const int blocks = (H + WARPS - 1) / WARPS;
  const T* v = static_cast<const T*>(cv);
#define SGM_WTA_CASE(k)                                                    \
  case k:                                                                  \
    sgm_wta_kernel<k, T><<<blocks, 32 * WARPS, 0, s>>>(                    \
        v, acc, idx, bands, disp, H, W, D, P1, P2, Pout, r, hr, vr);       \
    break;
  switch (K) {
    SGM_WTA_CASE(1) SGM_WTA_CASE(2) SGM_WTA_CASE(3) SGM_WTA_CASE(4)
    SGM_WTA_CASE(5) SGM_WTA_CASE(6) SGM_WTA_CASE(7) SGM_WTA_CASE(8)
    SGM_WTA_CASE(9) SGM_WTA_CASE(10)
    default: return cudaErrorInvalidValue;
  }
#undef SGM_WTA_CASE
  return cudaGetLastError();
}

constexpr int MAX_D = 320;  // K = ceil(D / 32) <= 10 values a lane

bool bad_geometry(int H, int W, int D, int col0, int W_pout) {
  return H < 1 || W < 1 || D < 1 || D > MAX_D || col0 < 0 ||
         W_pout < col0 + W;
}

}  // namespace

extern "C" int sgm_pass_launch(const void* cv, int cv_bf16, void* acc, int H,
                               int W, int D, int di, int dj, float P1,
                               float P2, float Pout, int accumulate, int col0,
                               int W_pout, void* stream) {
  if (bad_geometry(H, W, D, col0, W_pout) || di < -1 || di > 1 || dj < -1 ||
      dj > 1 || (di == 0 && dj == 0))
    return (int)cudaErrorInvalidValue;
  const int K = (D + 31) / 32;
  float* a = static_cast<float*>(acc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cv_bf16 ? pass_t<__nv_bfloat16>(K, cv, a, H, W, D, di, dj, P1,
                                               P2, Pout, accumulate, col0,
                                               W_pout, s)
                       : pass_t<float>(K, cv, a, H, W, D, di, dj, P1, P2, Pout,
                                       accumulate, col0, W_pout, s));
}

extern "C" int sgm_knight_launch(const void* cv, int cv_bf16, void* acc,
                                 int H, int W, int D, int v0, int v1, int h0,
                                 int h1, int phase, float P1, float P2,
                                 float Pout, int col0, int W_pout,
                                 void* stream) {
  // a knight direction: one axis steps every time (+-1), the other
  // alternates 0 and +-1
  const bool vert = v0 == v1 && (v0 == 1 || v0 == -1) && h0 == 0 &&
                    (h1 == 1 || h1 == -1);
  const bool horz = h0 == h1 && (h0 == 1 || h0 == -1) && v0 == 0 &&
                    (v1 == 1 || v1 == -1);
  if (bad_geometry(H, W, D, col0, W_pout) || !(vert || horz) || phase < 0 ||
      phase > 1)
    return (int)cudaErrorInvalidValue;
  const int K = (D + 31) / 32;
  float* a = static_cast<float*>(acc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cv_bf16 ? knight_t<__nv_bfloat16>(K, cv, a, H, W, D, v0, v1,
                                                 h0, h1, phase, P1, P2, Pout,
                                                 col0, W_pout, s)
                       : knight_t<float>(K, cv, a, H, W, D, v0, v1, h0, h1,
                                         phase, P1, P2, Pout, col0, W_pout,
                                         s));
}

extern "C" int sgm_wta_launch(const void* cv, int cv_bf16, const void* acc,
                              void* idx, void* bands, void* disp, int H, int W,
                              int D, float P1, float P2, float Pout, int r,
                              int hr, int vr, void* stream) {
  if (bad_geometry(H, W, D, 0, W) || r < 0 || hr < 0 || vr < 0 ||
      (disp != nullptr && r < 1))
    return (int)cudaErrorInvalidValue;
  const int K = (D + 31) / 32;
  const float* a = static_cast<const float*>(acc);
  int* ix = static_cast<int*>(idx);
  float* bd = static_cast<float*>(bands);
  float* dp = static_cast<float*>(disp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cv_bf16 ? wta_t<__nv_bfloat16>(K, cv, a, ix, bd, dp, H, W, D,
                                              P1, P2, Pout, r, hr, vr, s)
                       : wta_t<float>(K, cv, a, ix, bd, dp, H, W, D, P1, P2,
                                      Pout, r, hr, vr, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
