// K1: the dot-family box cost volume (CC / NCC / ZCC / ZNCC), RIGHT_TO_LEFT,
// in two kernels: the window statistics, then the volume.
//
// Replaces the TPU kernel `_kernel` / `_kernel_body` of
// libstevi_tpu/ops/box_pallas.py (:99, :183), launched by `_fused_call`
// (:425), and the XLA glue before it (`_prep_inputs`, :378).
//
// box_stats_kernel: one launch for both images (blockIdx.z picks the image)
// writes the window sum and the inverse norm (NCC) or inverse sigma (the
// others) of every pixel, 0 where that denominator is 0.  It replaces the
// ~60 small torch launches of ops/box_cuda._prep_inputs, its plain version.
//
// box_cv_kernel: per disparity d,
//   cross_d = sum over the (2v+1) x (2h+1) window of src(i', j') *
//             tgt(i', j' + d), zero outside the image;
//   CC = cross, NCC = (cross * inv_s) * inv_t_d,
//   ZCC = cross - (sum_s * sum_t_d) * (1/n), ZNCC = (ZCC * inv_s) * inv_t_d,
// negated for SCORE volumes, and 0 where j + d >= W.  Stored as f32, or as
// bf16 by one rounding of the f32 value.  Layout (H, W, D), D contiguous:
// the layout the SGM scans read (sgm_scan.cu), so no transpose follows.
//
// Bitwise contract.  Both kernels repeat their plain versions
// (ops/box_cuda._prep_inputs and box_cv_plain, built on
// ops/filters.box_filter_2d) operation by operation: squares and products
// rounded first, a window sum folded over its rows a = 0..2v from the top
// (zero-padded) row, then over its columns b = 0..2h from the left, the
// variance s2 - (s * s) / n with an IEEE division, clamped at 0, then the
// square root.  Every operation is an `_rn` intrinsic, so nvcc contracts
// nothing into an FMA, and the outputs equal the plain versions' bit for
// bit (up to the sign of a zero).  This matters beyond tidiness: on a flat
// window s2 - s * s / n cancels to a few ulps, the inverse sigma becomes
// large, and any other summation order moves such ZNCC entries by O(1).
//
// What bounds the volume on an H100: writing it, 73.7 MB in bf16 at
// 480x640x120 (22 us at 3.35 TB/s); its operations come second.  The
// window sums are separable: a column's vertical sum serves the 2h + 1
// output columns that need it, so an entry costs 2v + 1 products, 2v
// vertical adds and 2h horizontal adds (19 operations at 7x7) instead of
// the 49 FMAs of a direct window sum, and fewer still as a thread shares
// each product among the R rows it owns.
// Design: a block stages a tile of src (its output rows and columns plus
// the window halo) and the same rows of tgt (plus the block's 32
// disparities) in shared memory once.  Lanes own disparities (d =
// blockIdx.x * 32 + lane): the target reads of a warp are consecutive (no
// bank conflicts), the source value is a broadcast, and a warp stores 32
// consecutive d of one pixel.  The disparity chunk is the fastest grid
// axis, so the blocks that fill one pixel's D values run together and
// their partial-sector stores merge in L2.  A thread owns R = 4 rows (1
// where the window has fewer than 4 rows) and walks the tile's columns,
// keeping the last 2h + 1 vertical sums of each row in registers: a ring
// whose slots are compile-time indices in blocks of 2h + 1 unrolled
// outputs (window widths 3 to 11; other widths recompute the vertical
// sums, as h = 0 does anyway).  One launch takes any D.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TJ = 64;     // volume: output columns per block
constexpr int SJ = 32;     // statistics: pixels per block row (one warp)
constexpr int SI = 8;      // statistics: block rows

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  // above 48 KB only as opted-in dynamic memory
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Window sums and inverse denominators of one image per blockIdx.z (0: src,
// 1: tgt) into stats[z][0] (sum) and stats[z][1] (inverse), (H, W) each.
__global__ void __launch_bounds__(SJ * SI)
box_stats_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 float* __restrict__ stats, int H, int W, int hr, int vr,
                 int ncc, float n) {
  extern __shared__ float smem[];
  const float* x = blockIdx.z ? tgt : src;
  float* sum = stats + (size_t)blockIdx.z * 2 * H * W;
  float* inv = sum + (size_t)H * W;
  const int i0 = blockIdx.y * SI, j0 = blockIdx.x * SJ;
  const int nv = 2 * vr + 1, nh = 2 * hr + 1;
  const int rows = SI + 2 * vr, sw = SJ + 2 * hr;
  float* xs = smem;               // rows x sw image values, 0 outside
  float* vs = xs + rows * sw;     // SI x sw vertical sums of x
  float* vq = vs + SI * sw;       // SI x sw vertical sums of x * x
  const int tid = threadIdx.y * SJ + threadIdx.x;
  for (int e = tid; e < rows * sw; e += SJ * SI) {
    const int gi = i0 - vr + e / sw, gj = j0 - hr + e % sw;
    xs[e] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                ? x[(size_t)gi * W + gj] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < SI * sw; e += SJ * SI) {
    const float* col = xs + (e / sw) * sw + e % sw;
    float s = col[0], q = __fmul_rn(col[0], col[0]);
    for (int a = 1; a < nv; ++a) {
      const float y = col[a * sw];
      s = __fadd_rn(s, y);
      q = __fadd_rn(q, __fmul_rn(y, y));
    }
    vs[e] = s;
    vq[e] = q;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= H || j >= W) return;
  const int e = threadIdx.y * sw + threadIdx.x;
  float s = vs[e], q = vq[e];
  for (int b = 1; b < nh; ++b) {
    s = __fadd_rn(s, vs[e + b]);
    q = __fadd_rn(q, vq[e + b]);
  }
  const float var = __fsub_rn(q, __fdiv_rn(__fmul_rn(s, s), n));
  const float den = ncc ? __fsqrt_rn(q) : __fsqrt_rn(fmaxf(var, 0.f));
  const size_t p = (size_t)i * W + j;
  sum[p] = s;
  inv[p] = den > 0.f ? __fdiv_rn(1.f, den) : 0.f;
}

// kind: 0 CC, 1 NCC, 2 ZCC, 3 ZNCC (bit 1: zero mean, bit 0: normalized).
// NH: the window width 2h + 1 when the ring is unrolled for it, else 0.
// R: the image rows a thread owns (R <= 2v + 1); a block has warps(R)
// warps, warp w the tile rows w * R .. w * R + R - 1.
__host__ __device__ constexpr int warps(int R) { return R == 1 ? 8 : 4; }

template <int NH, int R, typename OutT>
__global__ void __launch_bounds__(32 * warps(R))
box_cv_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              const float* __restrict__ sum_s, const float* __restrict__ inv_s,
              const float* __restrict__ sum_t, const float* __restrict__ inv_t,
              OutT* __restrict__ out, int H, int W, int D, int hr, int vr,
              int kind, float inv_n, int negate) {
  constexpr int TI = warps(R) * R;  // output rows per block
  extern __shared__ float smem[];
  // blockIdx.x, the fastest in the launch order, picks the 32 disparities,
  // so the blocks that fill one pixel's D values run together and their
  // partial-sector stores merge in L2
  const int d0 = blockIdx.x * 32, j0 = blockIdx.y * TJ, i0 = blockIdx.z * TI;
  const int nv = 2 * vr + 1, nh = 2 * hr + 1;
  const int rows = TI + 2 * vr;
  const int sw = TJ + 2 * hr;   // src: window columns j0-h .. j0+TJ-1+h
  const int tw = sw + 31;       // tgt: the same, plus the block's 32 d
  float* s_tile = smem;
  float* t_tile = smem + rows * sw;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int e = tid; e < rows * sw; e += 32 * warps(R)) {
    const int gi = i0 - vr + e / sw, gj = j0 - hr + e % sw;
    s_tile[e] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                    ? src[(size_t)gi * W + gj] : 0.f;
  }
  for (int e = tid; e < rows * tw; e += 32 * warps(R)) {
    const int gi = i0 - vr + e / tw, gj = j0 - hr + d0 + e % tw;
    t_tile[e] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                    ? tgt[(size_t)gi * W + gj] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x, ib = i0 + threadIdx.y * R, d = d0 + lane;
  if (ib >= H || d >= D) return;
  // src(ib-v+k, j0-h+c) is sp[k * sw + c]; tgt(ib-v+k, j0-h+c+d) is
  // tp[k * tw + c]
  const float* sp = s_tile + threadIdx.y * R * sw;
  const float* tp = t_tile + threadIdx.y * R * tw + lane;
  // The vertical sums of window column c for the thread's R rows: row r
  // folds the products of tile rows k = r .. r + nv - 1 in order, from its
  // top row.  Each product is computed once: in the first R rows it starts
  // row k and adds to the rows above; then it adds to every row; in the
  // last R - 1 it adds to the rows that still need it.
  auto column = [&](int c, float (&acc)[R]) {
    const float* s = sp + c;
    const float* t = tp + c;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float p = __fmul_rn(s[k * sw], t[k * tw]);
#pragma unroll
      for (int r = 0; r < k; ++r) acc[r] = __fadd_rn(acc[r], p);
      acc[k] = p;
    }
    for (int k = R; k < nv; ++k) {
      const float p = __fmul_rn(s[k * sw], t[k * tw]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], p);
    }
#pragma unroll
    for (int e = 0; e + 1 < R; ++e) {
      const float p = __fmul_rn(s[(nv + e) * sw], t[(nv + e) * tw]);
#pragma unroll
      for (int r = e + 1; r < R; ++r) acc[r] = __fadd_rn(acc[r], p);
    }
  };
  // The statistics of output column j0 + q for the R rows, read at
  // clamped indices without a branch, so the loads start at the top of an
  // iteration and their latency hides behind its window sums.
  struct Stats { float ss[R], is[R], st[R], it[R]; };
  auto fetch = [&](int q, Stats& f) {
    const int j = j0 + q, jd = min(j + d, W - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t p = (size_t)min(ib + r, H - 1) * W;
      f.ss[r] = sum_s[p + j];
      f.is[r] = inv_s[p + j];
      f.st[r] = sum_t[p + jd];
      f.it[r] = inv_t[p + jd];
    }
  };
  auto emit = [&](int q, const float (&cross)[R], const Stats& f) {
    const int j = j0 + q;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (ib + r >= H) break;
      float c = cross[r];
      if (kind & 2)
        c = __fsub_rn(c, __fmul_rn(__fmul_rn(f.ss[r], f.st[r]), inv_n));
      if (kind & 1) c = __fmul_rn(__fmul_rn(c, f.is[r]), f.it[r]);
      // out of range: the all-zero target feature
      const float val = j + d < W ? (negate ? -c : c) : 0.f;
      store(out + ((size_t)(ib + r) * W + j) * D + d, val);
    }
  };
  const int nq = min(TJ, W - j0);  // output columns of this tile
  float cross[R];
  Stats f;
  if constexpr (NH > 0) {
    // ring[c % NH] holds the vertical sums of window column c.  Output q
    // folds columns q .. q + NH - 1; in blocks of NH outputs unrolled, the
    // slots are compile-time indices and no sum moves between registers.
    float ring[NH][R];
#pragma unroll
    for (int c = 0; c + 1 < NH; ++c) column(c, ring[c]);
    for (int q0 = 0; q0 < nq; q0 += NH) {
#pragma unroll
      for (int u = 0; u < NH; ++u) {
        const int q = q0 + u;
        if (q >= nq) break;
        fetch(q, f);
        column(q + NH - 1, ring[(u + NH - 1) % NH]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cross[r] = ring[u][r];
#pragma unroll
          for (int k = 1; k < NH; ++k)
            cross[r] = __fadd_rn(cross[r], ring[(u + k) % NH][r]);
        }
        emit(q, cross, f);
      }
    }
  } else {
    float col[R];
    for (int q = 0; q < nq; ++q) {
      fetch(q, f);
      column(q, cross);
      for (int b = 1; b < nh; ++b) {
        column(q + b, col);
#pragma unroll
        for (int r = 0; r < R; ++r) cross[r] = __fadd_rn(cross[r], col[r]);
      }
      emit(q, cross, f);
    }
  }
}

template <int NH, int R, typename OutT>
cudaError_t launch(const float* src, const float* tgt, const float* sum_s,
                   const float* inv_s, const float* sum_t, const float* inv_t,
                   void* out, int H, int W, int D, int hr, int vr, int kind,
                   float inv_n, int negate, cudaStream_t stream) {
  constexpr int TI = warps(R) * R;
  const dim3 block(32, warps(R));
  const dim3 grid((D + 31) / 32, (W + TJ - 1) / TJ, (H + TI - 1) / TI);
  const size_t smem = sizeof(float) * (TI + 2 * vr) *
                      (2 * (TJ + 2 * hr) + 31);
  const cudaError_t e =
      set_smem((const void*)box_cv_kernel<NH, R, OutT>, smem);
  if (e != cudaSuccess) return e;
  box_cv_kernel<NH, R, OutT><<<grid, block, smem, stream>>>(
      src, tgt, sum_s, inv_s, sum_t, inv_t, static_cast<OutT*>(out), H, W, D,
      hr, vr, kind, inv_n, negate);
  return cudaGetLastError();
}

// R = 4 rows a thread where the window has at least 4 rows, else 1.
template <int R, typename OutT>
cudaError_t dispatch_rows(const float* src, const float* tgt,
                          const float* sum_s, const float* inv_s,
                          const float* sum_t, const float* inv_t, void* out,
                          int H, int W, int D, int hr, int vr, int kind,
                          float inv_n, int negate, cudaStream_t stream) {
#define BOX_CV_CASE(nh)                                                   \
  case nh:                                                                \
    return launch<nh, R, OutT>(src, tgt, sum_s, inv_s, sum_t, inv_t, out, \
                               H, W, D, hr, vr, kind, inv_n, negate,      \
                               stream);
  switch (2 * hr + 1) {
    BOX_CV_CASE(3) BOX_CV_CASE(5) BOX_CV_CASE(7) BOX_CV_CASE(9)
    BOX_CV_CASE(11)
    default:
      return launch<0, R, OutT>(src, tgt, sum_s, inv_s, sum_t, inv_t, out, H,
                                W, D, hr, vr, kind, inv_n, negate, stream);
  }
#undef BOX_CV_CASE
}

template <typename OutT>
cudaError_t dispatch(const float* src, const float* tgt, const float* sum_s,
                     const float* inv_s, const float* sum_t,
                     const float* inv_t, void* out, int H, int W, int D,
                     int hr, int vr, int kind, float inv_n, int negate,
                     cudaStream_t stream) {
  return 2 * vr + 1 >= 4
             ? dispatch_rows<4, OutT>(src, tgt, sum_s, inv_s, sum_t, inv_t,
                                      out, H, W, D, hr, vr, kind, inv_n,
                                      negate, stream)
             : dispatch_rows<1, OutT>(src, tgt, sum_s, inv_s, sum_t, inv_t,
                                      out, H, W, D, hr, vr, kind, inv_n,
                                      negate, stream);
}

}  // namespace

extern "C" int box_stats_launch(const void* src, const void* tgt, void* stats,
                                int H, int W, int hr, int vr, int ncc,
                                float n, void* stream) {
  if (H < 1 || W < 1 || hr < 0 || vr < 0 || (H + SI - 1) / SI > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(SJ, SI);
  const dim3 grid((W + SJ - 1) / SJ, (H + SI - 1) / SI, 2);
  const int sw = SJ + 2 * hr;
  const size_t smem = sizeof(float) * (SI + 2 * vr + 2 * SI) * sw;
  const cudaError_t e = set_smem((const void*)box_stats_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  box_stats_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<float*>(stats), H, W, hr, vr, ncc, n);
  return (int)cudaGetLastError();
}

extern "C" int box_cv_launch(const void* src, const void* tgt,
                             const void* sum_s, const void* inv_s,
                             const void* sum_t, const void* inv_t, void* out,
                             int H, int W, int D, int hr, int vr, int kind,
                             float inv_n, int negate, int out_bf16,
                             void* stream) {
  if (H < 1 || W < 1 || D < 1 || (W + TJ - 1) / TJ > 65535 ||
      (H + 7) / 8 > 65535 || hr < 0 || vr < 0 || kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *a = static_cast<const float*>(src), *b = static_cast<const float*>(tgt),
              *c = static_cast<const float*>(sum_s), *d = static_cast<const float*>(inv_s),
              *e = static_cast<const float*>(sum_t), *g = static_cast<const float*>(inv_t);
  return (int)(out_bf16
                   ? dispatch<__nv_bfloat16>(a, b, c, d, e, g, out, H, W, D,
                                             hr, vr, kind, inv_n, negate, s)
                   : dispatch<float>(a, b, c, d, e, g, out, H, W, D, hr, vr,
                                     kind, inv_n, negate, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
