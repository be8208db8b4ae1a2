// K5: the feature-volume cost volume for the elementwise comparison
// families 'dot' (CC/NCC/ZCC/ZNCC after normalization), 'ssd' (SSD/ZSSD)
// and 'sad' (SAD/ZSAD).
//
// Replaces the TPU kernel `_fv_kernel` of libstevi_tpu/ops/fv_backend.py
// (:38), launched by `fused_fv_cost_volume` (:58, call :97).  Same result:
//   cost[i, j, d] = sum_f cmp(src[i, j, f], tgt[i, j + shifts[d], f]),
// with zero target features where j + shifts[d] is outside [0, W), for any
// static shift list (negative shifts come from LEFT_TO_RIGHT and offset
// searches).  Summed in f32 in the order f = 0 .. F-1 (no TF32), stored as
// f32 or bf16 (round to nearest even).
//
// Layout: (H, W, F) inputs with F contiguous, (H, W, D) output with D
// contiguous, the layout `extract_selected_index` and the SGM scans read.
//
// What bounds it on an H100: the f32 pipe and the shared-memory reads that
// feed it.  At 480x640, D = 120, F = 49 the volume is 1.8 G compare-adds,
// 0.061 ms at the f32 rate, and the 147 MB f32 store 0.044 ms; the first
// form (`fv_cv_general_kernel`) read two shared-memory values for every
// compare-add, one thread an entry (0.714 ms).  Two instances:
// - tiled (`fv_cv_tiled_kernel<KIND, OutT, STEP>`), where `shifts` is a
//   run of step +1 or -1 (RIGHT_TO_LEFT's range(D), LEFT_TO_RIGHT's -d,
//   offset ranges): a thread owns a register tile of JC = 4 columns x
//   DC = 8 disparities.  Along a unit-step list, entry (c, d) reads target
//   column c + d (or c - d), so for each f the thread reads its 4 source
//   values (one 16-byte load) and a run of JC + DC - 1 = 11 target values
//   (three 16-byte loads) and does 32 compare-adds: 0.5 shared words a
//   compare-add, not 2.  Threads run along columns, so a quarter-warp's
//   16-byte loads cover 128 contiguous bytes (no bank conflict).  A block
//   is a row, WT = 128 columns and up to 16 d-tiles (128 disparities;
//   wider D takes more blocks, each staging only its d-range's target
//   span), and stages F in chunks of FC = 16 features, double-buffered
//   with cp.async, so the next chunk's loads overlap this chunk's
//   arithmetic.  Staging lanes take 8 features x 4 columns, and the row
//   strides are 4 (mod 8) words, so those writes hit 32 distinct banks.
// - general (`fv_cv_general_kernel`): any other shift list, the first
//   form: one block per (row, 32 columns) stages the source tile and the
//   target span whole, one thread an entry.
// `fused_fits` (ops/fv_backend.py) keeps the general form's shared-memory
// rule for both, so which calls take K5 is unchanged.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WT = 32;        // image columns per block (general)
constexpr int THREADS = 256;  // threads per block (general)
constexpr size_t MAX_SMEM = 232448;   // what one block may opt in to (sm_90)
// the tiled instance
constexpr int JC = 4;         // columns a thread
constexpr int DC = 8;         // disparities a thread
constexpr int TWT = 128;      // image columns per block
constexpr int MAX_DT = 16;    // d-tiles per block (128 disparities)
constexpr int FC = 16;        // features a staged chunk

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// kind: 0 dot, 1 ssd, 2 sad
template <int KIND>
__device__ __forceinline__ float cmp(float a, float b) {
  if (KIND == 0) return a * b;
  const float d = a - b;
  return KIND == 1 ? d * d : fabsf(d);
}

__host__ __device__ inline int odd(int n) { return n | 1; }

template <int KIND, typename OutT>
__global__ void __launch_bounds__(THREADS)
fv_cv_general_kernel(const float* __restrict__ src,
                     const float* __restrict__ tgt,
                     const int* __restrict__ shifts, OutT* __restrict__ out,
                     int H, int W, int F, int D, int min_shift, int span) {
  extern __shared__ float smem[];
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * WT;
  const int tw = WT + span;        // target columns j0 + min_shift + c
  const int ss = odd(WT), ts = odd(tw);
  float* s_tile = smem;            // [F][ss]
  float* t_tile = smem + F * ss;   // [F][ts]
  int* s_shift = reinterpret_cast<int*>(t_tile + F * ts);   // [D]
  const size_t row = static_cast<size_t>(i) * W;

  // staging: consecutive threads read consecutive f of one pixel
  for (int e = threadIdx.x; e < F * WT; e += THREADS) {
    const int c = e / F, f = e % F, j = j0 + c;
    s_tile[f * ss + c] = j < W ? src[(row + j) * F + f] : 0.f;
  }
  for (int e = threadIdx.x; e < F * tw; e += THREADS) {
    const int c = e / F, f = e % F, j = j0 + min_shift + c;
    t_tile[f * ts + c] = (j >= 0 && j < W) ? tgt[(row + j) * F + f] : 0.f;
  }
  for (int d = threadIdx.x; d < D; d += THREADS)
    s_shift[d] = shifts[d] - min_shift;
  __syncthreads();

  const int wt = min(WT, W - j0);
  OutT* o = out + (row + j0) * D;
  for (int p = threadIdx.x; p < wt * D; p += THREADS) {
    const int c = p / D, d = p - c * D;
    const float* a = s_tile + c;
    const float* b = t_tile + c + s_shift[d];
    float acc = 0.f;
    for (int f = 0; f < F; ++f) acc += cmp<KIND>(a[f * ss], b[f * ts]);
    store(o + p, acc);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared, or 4 zero bytes where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// The tiled instance's row strides (words): the source tile's, and the
// target span's for nd d-tiles; both 4 (mod 8), so 16-byte rows and
// conflict-free staging writes.
__host__ __device__ inline int tiled_ss() { return TWT + 4; }
__host__ __device__ inline int tiled_ts(int nd) { return TWT + DC * nd + 4; }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One block: row blockIdx.y, columns [j0, j0 + TWT), d-tiles
// [z * tpc, min(ND, (z + 1) * tpc)) for z = blockIdx.z; a thread (ct, dt)
// owns columns j0 + 4 ct .. + 3 and disparities d0 = 8 (z tpc + dt) .. + 7.
// Target column of (c, d): c + shifts[d] - lo, i.e. c + d - d_first
// (STEP = 1) or c - d + d_last (STEP = -1), relative to j0 + lo; the block
// stages target columns j0 + lo + T0 + u, u < ts, with T0 chosen so that
// each thread's run of 11 starts 16-byte aligned at u = B (below).
template <int KIND, typename OutT, int STEP>
__global__ void __launch_bounds__(32 * MAX_DT)
fv_cv_tiled_kernel(const float* __restrict__ src,
                   const float* __restrict__ tgt, OutT* __restrict__ out,
                   int H, int W, int F, int D, int lo, int tpc) {
  extern __shared__ __align__(16) float tsm[];
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * TWT;
  const int ND = (D + DC - 1) / DC;
  const int tA = blockIdx.z * tpc;              // first d-tile
  const int nd = min(tpc, ND - tA);             // d-tiles of this block
  const int dA = tA * DC;
  const int ss = tiled_ss(), ts = tiled_ts(nd);
  const int chunk = FC * (ss + ts);             // floats a buffer
  // lo + T0: the first staged target column, relative to j0
  const int T0 = STEP > 0 ? dA : D - dA - DC * nd;
  const int tcol = lo + T0;
  const size_t row = static_cast<size_t>(i) * W;

  // chunk q of F into buffer b: its nf <= FC features of the source tile
  // and of the target span.  A warp copies 8 features x 4 columns at a
  // time (unit k: features 8 (k & g) .. + 7 of column quad k >> g, g = 1
  // where nf > 8), lane (f, c) = (lane & 7, lane >> 3).  Only what the
  // arithmetic reads is copied: features < F, the TWT source columns (past
  // the image their sums are never stored), the target columns up to
  // TWT + DC nd, zero outside the image.
  auto stage = [&](int q, int b) {
    float* sb = tsm + b * chunk;
    float* tb = sb + FC * ss;
    const int f0 = q * FC, nf = min(FC, F - f0), g = nf > 8 ? 1 : 0;
    const int lane = threadIdx.x & 31, fo = lane & 7, co = lane >> 3;
    const int nw = blockDim.x >> 5, units = (TWT / 4) << g;
    const int tunits = ((TWT + DC * nd) / 4) << g;
    for (int k = threadIdx.x >> 5; k < units; k += nw) {
      const int fl = ((k & g) << 3) + fo, u = ((k >> g) << 2) + co;
      const int j = j0 + u;
      if (fl < nf && j < W)
        cp_async4(sb + fl * ss + u, src + (row + j) * F + f0 + fl, true);
    }
    for (int k = threadIdx.x >> 5; k < tunits; k += nw) {
      const int fl = ((k & g) << 3) + fo, u = ((k >> g) << 2) + co;
      const int j = j0 + tcol + u;
      const bool ok = j >= 0 && j < W;
      if (fl < nf)
        cp_async4(tb + fl * ts + u, ok ? tgt + (row + j) * F + f0 + fl : tgt,
                  ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int ct = threadIdx.x & 31, dt = threadIdx.x >> 5;
  const bool live = dt < nd;  // the last block along z may hold fewer
  const int c0 = JC * ct, d0 = dA + DC * dt;
  const int B = STEP > 0 ? c0 + DC * dt : c0 + DC * (nd - 1 - dt);
  float acc[JC][DC];
#pragma unroll
  for (int a = 0; a < JC; ++a)
#pragma unroll
    for (int b = 0; b < DC; ++b) acc[a][b] = 0.f;

  const int NQ = (F + FC - 1) / FC;
  stage(0, 0);
  for (int q = 0; q < NQ; ++q) {
    if (q + 1 < NQ) {
      stage(q + 1, (q + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // chunk q staged by every thread
    const float* sb = tsm + (q & 1) * chunk + c0;
    const float* tb = tsm + (q & 1) * chunk + FC * ss + B;
    const int nf = live ? min(FC, F - q * FC) : 0;
    for (int fl = 0; fl < nf; ++fl) {  // f = 0 .. F-1, in order
      const float4 a4 = lds4(sb + fl * ss);
      const float4 t0 = lds4(tb + fl * ts), t1 = lds4(tb + fl * ts + 4),
                   t2 = lds4(tb + fl * ts + 8);
      const float av[JC] = {a4.x, a4.y, a4.z, a4.w};
      const float tv[12] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y,
                            t1.z, t1.w, t2.x, t2.y, t2.z, t2.w};
#pragma unroll
      for (int a = 0; a < JC; ++a)
#pragma unroll
        for (int b = 0; b < DC; ++b)
          acc[a][b] += cmp<KIND>(av[a], tv[STEP > 0 ? a + b : a + DC - 1 - b]);
    }
    __syncthreads();  // chunk q read: its buffer takes chunk q + 2
  }

  // each column's DC disparities are contiguous in the output
  if (!live) return;
  const bool vec = d0 + DC <= D &&
                   (sizeof(OutT) == 4 ? D % 4 == 0 : D % 8 == 0);
#pragma unroll
  for (int a = 0; a < JC; ++a) {
    const int j = j0 + c0 + a;
    if (j >= W) break;
    OutT* o = out + (row + j) * D + d0;
    if (vec && sizeof(OutT) == 4) {
      float* of = reinterpret_cast<float*>(o);
      *reinterpret_cast<float4*>(of) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      *reinterpret_cast<float4*>(of + 4) =
          make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    } else if (vec) {
      __align__(16) OutT v[DC];
#pragma unroll
      for (int b = 0; b < DC; ++b) store(v + b, acc[a][b]);
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
    } else {
#pragma unroll
      for (int b = 0; b < DC; ++b)
        if (d0 + b < D) store(o + b, acc[a][b]);
    }
  }
}

size_t smem_bytes(int F, int D, int span) {
  return sizeof(float) * (static_cast<size_t>(F) * (odd(WT) + odd(WT + span)))
         + sizeof(int) * static_cast<size_t>(D);
}

cudaError_t allow(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // above: opted-in dynamic
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int KIND, typename OutT>
cudaError_t launch(const float* src, const float* tgt, const int* shifts,
                   void* out, int H, int W, int F, int D, int min_shift,
                   int span, int step, cudaStream_t stream) {
  OutT* o = static_cast<OutT*>(out);
  if (step == 0) {
    const size_t smem = smem_bytes(F, D, span);
    const cudaError_t e = allow((const void*)fv_cv_general_kernel<KIND, OutT>,
                                smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((W + WT - 1) / WT, H);
    fv_cv_general_kernel<KIND, OutT><<<grid, THREADS, smem, stream>>>(
        src, tgt, shifts, o, H, W, F, D, min_shift, span);
    return cudaGetLastError();
  }
  // d-tiles split evenly over ceil(ND / MAX_DT) blocks
  const int ND = (D + DC - 1) / DC;
  const int nz = (ND + MAX_DT - 1) / MAX_DT;
  const int tpc = (ND + nz - 1) / nz;
  const size_t smem =
      sizeof(float) * 2 * FC * (size_t)(tiled_ss() + tiled_ts(tpc));
  const dim3 grid((W + TWT - 1) / TWT, H, (ND + tpc - 1) / tpc);
  const void* fn = step > 0
      ? (const void*)fv_cv_tiled_kernel<KIND, OutT, 1>
      : (const void*)fv_cv_tiled_kernel<KIND, OutT, -1>;
  const cudaError_t e = allow(fn, smem);
  if (e != cudaSuccess) return e;
  if (step > 0)
    fv_cv_tiled_kernel<KIND, OutT, 1><<<grid, 32 * tpc, smem, stream>>>(
        src, tgt, o, H, W, F, D, min_shift, tpc);
  else
    fv_cv_tiled_kernel<KIND, OutT, -1><<<grid, 32 * tpc, smem, stream>>>(
        src, tgt, o, H, W, F, D, min_shift, tpc);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(int kind, const float* src, const float* tgt,
                     const int* shifts, void* out, int H, int W, int F, int D,
                     int min_shift, int span, int step, cudaStream_t s) {
  switch (kind) {
    case 0: return launch<0, OutT>(src, tgt, shifts, out, H, W, F, D, min_shift, span, step, s);
    case 1: return launch<1, OutT>(src, tgt, shifts, out, H, W, F, D, min_shift, span, step, s);
    case 2: return launch<2, OutT>(src, tgt, shifts, out, H, W, F, D, min_shift, span, step, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// step: +1 or -1 where shifts[d] = shifts[0] + step * d (the tiled
// instance; the caller checks it, ops/fv_backend.unit_step), else 0.
extern "C" int fv_cv_launch(const void* src, const void* tgt,
                            const void* shifts, void* out, int H, int W,
                            int F, int D, int min_shift, int span, int kind,
                            int out_bf16, int step, void* stream) {
  if (H < 1 || W < 1 || F < 1 || D < 1 || span < 0 || H > 65535 ||
      step < -1 || step > 1 || (step != 0 && span != D - 1) ||
      smem_bytes(F, D, span) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(src);
  const float* b = static_cast<const float*>(tgt);
  const int* sh = static_cast<const int*>(shifts);
  return (int)(out_bf16
                   ? dispatch<__nv_bfloat16>(kind, a, b, sh, out, H, W, F, D,
                                             min_shift, span, step, s)
                   : dispatch<float>(kind, a, b, sh, out, H, W, F, D,
                                     min_shift, span, step, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
