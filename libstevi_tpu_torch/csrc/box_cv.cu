// K1: the dot-family box cost volume (CC / NCC / ZCC / ZNCC), RIGHT_TO_LEFT.
//
// Replaces the TPU kernel `_kernel` / `_kernel_body` of
// libstevi_tpu/ops/box_pallas.py (:99, :183), launched by `_fused_call`
// (:425).  Same arithmetic: cross_d = sum over the (2v+1) x (2h+1) window of
// src(i', j') * tgt(i', j' + d), zero outside the image; then, from the
// window sums and inverse sigmas the wrapper precomputes (0 where sigma is 0):
//   CC = cross, NCC = cross * inv|S| * inv|T_d|,
//   ZCC = cross - sum_s * sum_t_d / n, ZNCC = ZCC * inv_sigma_s * inv_sigma_t_d,
// negated for SCORE volumes, and 0 where j + d >= W.  Stored as f32 or bf16.
//
// Layout: (H, W, D), D contiguous.  That is the layout the SGM scans read
// (sgm_scan.cu), so no transpose follows; the TPU kernel wrote (D, H, W)
// tiles and the pipeline then transposed the whole volume.  Pout is not
// baked into the volume: the SGM scans add it in their DP step.
//
// What bounds it on an H100: writing the volume, 73.7 MB in bf16 at
// 480x640x120 (22 us at 3.35 TB/s), and the window sums, 49 FMAs per entry
// (1.8 GFLOP).  Design: a block stages a TI x TJ pixel tile of src and the
// same rows of tgt (window halo plus every column the disparities reach) in
// shared memory once.  Lanes own disparities (d = lane + 32k): a warp reads
// consecutive tgt columns (no bank conflicts, the src value is a broadcast)
// and writes 32 consecutive d of one pixel.  Each thread keeps K partial
// sums, so one src load feeds K FMAs.
// One launch writes one slice of at most 320 disparities, [d0, d0 + Ds)
// of the volume's D (K <= 10): at Ds = 320 and a 7x7 window a block stages
// 10 x (38 + 357) floats, 15.8 KB of shared memory.  Wider ranges are
// several launches over slices (ops/box_cuda.py), sharing one set of window
// statistics.
// Left for later PRs: separable row-then-column sums instead of 49 FMAs per
// entry, 16-byte stores, computing the window statistics in the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TJ = 32;     // image columns per block
constexpr int TI = 4;      // image rows per block
constexpr int WARPS = 8;   // warp w computes tile columns w, w + WARPS, ...

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// kind: 0 CC, 1 NCC, 2 ZCC, 3 ZNCC (bit 1: zero mean, bit 0: normalized)
template <int K, typename OutT>
__global__ void __launch_bounds__(32 * WARPS)
box_cv_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              const float* __restrict__ sum_s, const float* __restrict__ den_s,
              const float* __restrict__ sum_t, const float* __restrict__ den_t,
              OutT* __restrict__ out, int H, int W, int D, int d0, int Ds,
              int hr, int vr, int kind, float inv_n, int negate) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.y * TI;
  const int j0 = blockIdx.x * TJ;
  const int rows = TI + 2 * vr;
  const int sw = TJ + 2 * hr;               // src columns j0-h .. j0+TJ-1+h
  const int tw = TJ + 2 * hr + 32 * K - 1;  // tgt: plus every d a lane owns
  float* s_tile = smem;
  float* t_tile = smem + rows * sw;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int e = tid; e < rows * sw; e += 32 * WARPS) {
    const int gi = i0 - vr + e / sw, gj = j0 - hr + e % sw;
    s_tile[e] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                    ? src[(size_t)gi * W + gj] : 0.f;
  }
  for (int e = tid; e < rows * tw; e += 32 * WARPS) {
    const int gi = i0 - vr + e / tw, gj = j0 - hr + d0 + e % tw;
    t_tile[e] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                    ? tgt[(size_t)gi * W + gj] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x;
  const int nh = 2 * hr + 1, nv = 2 * vr + 1;
  for (int li = 0; li < TI && i0 + li < H; ++li) {
    const int i = i0 + li;
    for (int lj = threadIdx.y; lj < TJ && j0 + lj < W; lj += WARPS) {
      const int j = j0 + lj;
      float cross[K];
#pragma unroll
      for (int k = 0; k < K; ++k) cross[k] = 0.f;
      for (int a = 0; a < nv; ++a) {
        // src(i-v+a, j-h+b) is srow[b]; tgt(i-v+a, j-h+b+d0+d) is
        // trow[b+32k] for the slice's d = lane + 32k
        const float* srow = s_tile + (li + a) * sw + lj;
        const float* trow = t_tile + (li + a) * tw + lj + lane;
        for (int b = 0; b < nh; ++b) {
          const float s = srow[b];
#pragma unroll
          for (int k = 0; k < K; ++k)
            cross[k] = fmaf(s, trow[b + 32 * k], cross[k]);
        }
      }
      const size_t pix = (size_t)i * W + j;
      const float ss = sum_s[pix], ds = den_s[pix];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + lane + 32 * k;
        if (lane + 32 * k >= Ds) break;
        float val = 0.f;  // out of range: the all-zero target feature
        if (j + d < W) {
          float c = cross[k];
          // _rn intrinsics: no FMA contraction, the same roundings as the
          // plain version's separate multiply and subtract
          if (kind & 2) c = __fsub_rn(c, __fmul_rn(__fmul_rn(ss, sum_t[pix + d]), inv_n));
          if (kind & 1) c = __fmul_rn(__fmul_rn(c, ds), den_t[pix + d]);
          val = negate ? -c : c;
        }
        store(out + pix * D + d, val);
      }
    }
  }
}

template <int K, typename OutT>
cudaError_t launch(const float* src, const float* tgt, const float* sum_s,
                   const float* den_s, const float* sum_t, const float* den_t,
                   void* out, int H, int W, int D, int d0, int Ds, int hr,
                   int vr, int kind, float inv_n, int negate,
                   cudaStream_t stream) {
  const dim3 block(32, WARPS);
  const dim3 grid((W + TJ - 1) / TJ, (H + TI - 1) / TI);
  const size_t smem = sizeof(float) * (TI + 2 * vr) *
                      ((TJ + 2 * hr) + (TJ + 2 * hr + 32 * K - 1));
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t e = cudaFuncSetAttribute(
        box_cv_kernel<K, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  box_cv_kernel<K, OutT><<<grid, block, smem, stream>>>(
      src, tgt, sum_s, den_s, sum_t, den_t, static_cast<OutT*>(out), H, W, D,
      d0, Ds, hr, vr, kind, inv_n, negate);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(int K, const float* src, const float* tgt,
                     const float* sum_s, const float* den_s,
                     const float* sum_t, const float* den_t, void* out, int H,
                     int W, int D, int d0, int Ds, int hr, int vr, int kind,
                     float inv_n, int negate, cudaStream_t stream) {
#define BOX_CV_CASE(k)                                                      \
  case k:                                                                   \
    return launch<k, OutT>(src, tgt, sum_s, den_s, sum_t, den_t, out, H, W, \
                           D, d0, Ds, hr, vr, kind, inv_n, negate, stream);
  switch (K) {
    BOX_CV_CASE(1) BOX_CV_CASE(2) BOX_CV_CASE(3) BOX_CV_CASE(4)
    BOX_CV_CASE(5) BOX_CV_CASE(6) BOX_CV_CASE(7) BOX_CV_CASE(8)
    BOX_CV_CASE(9) BOX_CV_CASE(10)
    default: return cudaErrorInvalidValue;
  }
#undef BOX_CV_CASE
}

}  // namespace

extern "C" int box_cv_launch(const void* src, const void* tgt,
                             const void* sum_s, const void* den_s,
                             const void* sum_t, const void* den_t, void* out,
                             int H, int W, int D, int d0, int Ds, int hr,
                             int vr, int kind, float inv_n, int negate,
                             int out_bf16, void* stream) {
  if (H < 1 || W < 1 || Ds < 1 || Ds > 320 || d0 < 0 || d0 + Ds > D ||
      hr < 0 || vr < 0 || kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  const int K = (Ds + 31) / 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *a = static_cast<const float*>(src), *b = static_cast<const float*>(tgt),
              *c = static_cast<const float*>(sum_s), *d = static_cast<const float*>(den_s),
              *e = static_cast<const float*>(sum_t), *g = static_cast<const float*>(den_t);
  return (int)(out_bf16
                   ? dispatch<__nv_bfloat16>(K, a, b, c, d, e, g, out, H, W, D,
                                             d0, Ds, hr, vr, kind, inv_n,
                                             negate, s)
                   : dispatch<float>(K, a, b, c, d, e, g, out, H, W, D, d0, Ds,
                                     hr, vr, kind, inv_n, negate, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
