// K6 and K7: PatchMatch propagation sweep and candidate probe over a
// precomputed cost-oriented volume.
//
// K6 `pm_sweep_kernel` replaces the TPU kernel `_sweep_kernel` of
// libstevi_tpu/ops/patchmatch_pallas.py (:47), launched by `sweep` (:176,
// call :197).  K7 `pm_probe_kernel` replaces `_probe_kernel` (:118),
// launched by `probe` (:144, call :167).
//
// Semantics (the naive recurrence, which the TPU kernel's chunked chain
// resolution reproduces exactly, `_sweep_kernel` :53-64):
//   sweep: along the scan axis, line l's pixel tests the already-updated
//     disparity v of line l-1 (l+1 on reverse) and accepts it when l is not
//     the first line of the sweep, v is in [lower, lower + D), the volume
//     value sel = cv[pixel, v - lower] is finite, and sel <= the pixel's
//     cost (ties accept, `patchmatch.h:210`);
//   probe: the K candidate fields are tried in order per pixel with the
//     same guards.  An out-of-range candidate is rejected before any load
//     (the TPU's one-hot select returned 0 for it, which its in-range test
//     then rejected: the same result).
//
// Layout: the (H, W, D) f32 volume with D contiguous, read in place for
// either scan axis through a line stride and a pixel stride; the TPU path
// padded to multiples of 128 and kept a transposed copy of the volume for
// the row sweep, which this kernel does not need.  State: (H, W) int32
// disparity and f32 cost, read from the inputs, written to the outputs.
//
// What bounds it on an H100: K6 is latency-bound by design in this first
// version.  One thread owns one pixel of the line (480 or 640 threads in
// all) and walks the scan axis with the carried disparity in a register:
// each step's volume address depends on the step before, so a sweep is L
// dependent device-memory loads (L = 640 or 480).  The next line's state is
// loaded one step ahead, off that chain.  A later PR may bring back the TPU
// kernel's idea of evaluating the candidates of a chunk independently.
// K7 is a gather of K values per pixel, all independent, one thread per
// pixel: it is bound by the scattered 32-byte sectors it reads.

#include <cuda_runtime.h>

namespace {

constexpr int SWEEP_THREADS = 32;   // spread the few chains over many SMs
constexpr int PROBE_THREADS = 256;

__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
pm_sweep_kernel(const float* __restrict__ cv, const int* __restrict__ disp_in,
                const float* __restrict__ cost_in, int* __restrict__ disp_out,
                float* __restrict__ cost_out, int L, int S, int D, int lower,
                long long line_stride, long long pix_stride, int reverse) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const long long step = reverse ? -line_stride : line_stride;
  long long idx = (reverse ? (long long)(L - 1) : 0LL) * line_stride +
                  (long long)s * pix_stride;
  // the first line of the sweep takes no candidate
  int carry = disp_in[idx];
  disp_out[idx] = carry;
  cost_out[idx] = cost_in[idx];
  int nxt_d = 0;
  float nxt_c = 0.f;
  if (L > 1) {
    nxt_d = disp_in[idx + step];
    nxt_c = cost_in[idx + step];
  }
  for (int n = 1; n < L; ++n) {
    idx += step;
    const int cur_d = nxt_d;
    const float cur_c = nxt_c;
    if (n + 1 < L) {  // prefetch the next line's state, off the carry chain
      nxt_d = disp_in[idx + step];
      nxt_c = cost_in[idx + step];
    }
    const int k = carry - lower;
    bool acc = false;
    float sel = 0.f;
    if (k >= 0 && k < D) {
      sel = cv[idx * D + k];
      acc = finite(sel) && sel <= cur_c;
    }
    carry = acc ? carry : cur_d;
    disp_out[idx] = carry;
    cost_out[idx] = acc ? sel : cur_c;
  }
}

__global__ void __launch_bounds__(PROBE_THREADS)
pm_probe_kernel(const float* __restrict__ cv, const int* __restrict__ cand,
                const int* __restrict__ disp_in,
                const float* __restrict__ cost_in, int* __restrict__ disp_out,
                float* __restrict__ cost_out, long long N, int K, int D,
                int lower) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  int d = disp_in[p];
  float c = cost_in[p];
  for (int k = 0; k < K; ++k) {
    const int v = cand[k * N + p];
    const int kk = v - lower;
    if (kk < 0 || kk >= D) continue;
    const float sel = cv[p * D + kk];
    if (finite(sel) && sel <= c) {
      d = v;
      c = sel;
    }
  }
  disp_out[p] = d;
  cost_out[p] = c;
}

}  // namespace

// axis 0: scan along H (line = row i, pixels across j);
// axis 1: scan along W (line = column j, pixels across i).
extern "C" int pm_sweep_launch(const void* cv, const void* disp_in,
                               const void* cost_in, void* disp_out,
                               void* cost_out, int H, int W, int D, int lower,
                               int axis, int reverse, void* stream) {
  if (H < 1 || W < 1 || D < 1 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const int L = axis == 0 ? H : W;
  const int S = axis == 0 ? W : H;
  const long long line_stride = axis == 0 ? W : 1;
  const long long pix_stride = axis == 0 ? 1 : W;
  const int blocks = (S + SWEEP_THREADS - 1) / SWEEP_THREADS;
  pm_sweep_kernel<<<blocks, SWEEP_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cv), static_cast<const int*>(disp_in),
      static_cast<const float*>(cost_in), static_cast<int*>(disp_out),
      static_cast<float*>(cost_out), L, S, D, lower, line_stride, pix_stride,
      reverse);
  return (int)cudaGetLastError();
}

extern "C" int pm_probe_launch(const void* cv, const void* cand,
                               const void* disp_in, const void* cost_in,
                               void* disp_out, void* cost_out, int H, int W,
                               int D, int K, int lower, void* stream) {
  if (H < 1 || W < 1 || D < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const long long N = (long long)H * W;
  const long long blocks = (N + PROBE_THREADS - 1) / PROBE_THREADS;
  pm_probe_kernel<<<(unsigned)blocks, PROBE_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cv), static_cast<const int*>(cand),
      static_cast<const int*>(disp_in), static_cast<const float*>(cost_in),
      static_cast<int*>(disp_out), static_cast<float*>(cost_out), N, K, D,
      lower);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
