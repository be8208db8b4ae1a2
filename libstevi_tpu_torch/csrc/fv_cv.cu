// K5: the feature-volume cost volume for the elementwise comparison
// families 'dot' (CC/NCC/ZCC/ZNCC after normalization), 'ssd' (SSD/ZSSD)
// and 'sad' (SAD/ZSAD).
//
// Replaces the TPU kernel `_fv_kernel` of libstevi_tpu/ops/fv_backend.py
// (:38), launched by `fused_fv_cost_volume` (:58, call :97).  Same result:
//   cost[i, j, d] = sum_f cmp(src[i, j, f], tgt[i, j + shifts[d], f]),
// with zero target features where j + shifts[d] is outside [0, W), for any
// static shift list (negative shifts come from LEFT_TO_RIGHT and offset
// searches).  Summed in f32 in the order f = 0 .. F-1, stored as f32 or bf16.
//
// Layout: (H, W, F) inputs with F contiguous, (H, W, D) output with D
// contiguous, the layout `extract_selected_index` and the SGM scans read.
//
// What bounds it on an H100: shared-memory reads.  Each (j, d) entry reads
// F source and F target values from shared memory (1.8 G entry-features at
// 480x640, D=120, F=49); device memory moves only the two feature volumes
// once and the volume out (147 MB in f32).  Design: one block per (row i,
// tile of WT columns) stages the source tile (F x WT) and the target span
// (F x (WT + shift span)) in shared memory, zero outside the image, with
// odd row strides so the staging writes do not collide in one bank.  A
// thread owns (j, d) pairs, p = j_local * D + d, so a warp reads
// consecutive target columns (distinct banks), the source value as a
// broadcast, and writes consecutive output addresses.
// Left for later PRs: register tiles (several d per thread sharing one
// source load), the F = 147 span split over d tiles to fit more blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WT = 32;        // image columns per block
constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;   // what one block may opt in to (sm_90)

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
fv_cv_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
             const int* __restrict__ shifts, OutT* __restrict__ out, int H,
             int W, int F, int D, int min_shift, int span) {
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

size_t smem_bytes(int F, int D, int span) {
  return sizeof(float) * (static_cast<size_t>(F) * (odd(WT) + odd(WT + span)))
         + sizeof(int) * static_cast<size_t>(D);
}

template <int KIND, typename OutT>
cudaError_t launch(const float* src, const float* tgt, const int* shifts,
                   void* out, int H, int W, int F, int D, int min_shift,
                   int span, cudaStream_t stream) {
  const size_t smem = smem_bytes(F, D, span);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t e = cudaFuncSetAttribute(
        fv_cv_kernel<KIND, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + WT - 1) / WT, H);
  fv_cv_kernel<KIND, OutT><<<grid, THREADS, smem, stream>>>(
      src, tgt, shifts, static_cast<OutT*>(out), H, W, F, D, min_shift, span);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(int kind, const float* src, const float* tgt,
                     const int* shifts, void* out, int H, int W, int F, int D,
                     int min_shift, int span, cudaStream_t s) {
  switch (kind) {
    case 0: return launch<0, OutT>(src, tgt, shifts, out, H, W, F, D, min_shift, span, s);
    case 1: return launch<1, OutT>(src, tgt, shifts, out, H, W, F, D, min_shift, span, s);
    case 2: return launch<2, OutT>(src, tgt, shifts, out, H, W, F, D, min_shift, span, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fv_cv_launch(const void* src, const void* tgt,
                            const void* shifts, void* out, int H, int W,
                            int F, int D, int min_shift, int span, int kind,
                            int out_bf16, void* stream) {
  if (H < 1 || W < 1 || F < 1 || D < 1 || span < 0 || H > 65535 ||
      smem_bytes(F, D, span) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(src);
  const float* b = static_cast<const float*>(tgt);
  const int* sh = static_cast<const int*>(shifts);
  return (int)(out_bf16
                   ? dispatch<__nv_bfloat16>(kind, a, b, sh, out, H, W, F, D,
                                             min_shift, span, s)
                   : dispatch<float>(kind, a, b, sh, out, H, W, F, D,
                                     min_shift, span, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
