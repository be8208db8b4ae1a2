// The census cost volume, RIGHT_TO_LEFT, in two kernels: the census words
// of both images, then the Hamming volume.
//
// Replaces no TPU kernel: the JAX package builds census volumes with XLA
// ops (unfold, `census_features`, one xor and popcount a disparity), which
// the port ran as torch ops (ops/cost_volume._shifted_compare_scan, ~2300
// launches a VGA frame).  Definition (LibStevi correlation/census.h:70-131,
// ops/census.py):
//
// census_words_kernel: one launch for both images (blockIdx.z: 0 the source,
// the right image; 1 the target, the left one).  A pixel's window is its
// (2v+1) x (2h+1) samples in row-major order over (dy, dx), zeros outside
// the image; bit b of word w is sample 0 > sample 1 + 32 w + b, where
// sample 0 is the window's FIRST sample (its top-left corner), not its
// centre.  A trailing partial word has its unused bits 0.  Words are
// stored (2, n_words, H, W) as uint32.
//
// census_cv_kernel: cost(i, j, d) = sum over the words w of
// popcount(src_w(i, j) ^ tgt_w(i, j + d)), the target words 0 where
// j + d >= W, stored (H, W, D), D contiguous, as f32 or as bf16 by one
// rounding of the f32 value (costs are integers; bf16 holds them exactly
// up to 256).
//
// What bounds it on an H100: writing the volume (357.7 MB in f32 at
// 375x1242x192, 0.107 ms at 3.35 TB/s); the words are 2 x 3.7 MB at that
// size and the integer work (xor, popcount, add a word an entry) is far
// below the store.  Design: a block owns one image row, TJ output columns
// and DC disparities; it stages the row's source words of its columns and
// the target words of columns j0 + d0 .. j0 + d0 + TJ + DC - 2 in shared
// memory once (zero past W), then each warp writes 32 consecutive d of one
// pixel a store (128 bytes in f32), so the stores are coalesced along D
// and the blocks of one pixel's D run together (the disparity chunk is the
// fastest grid axis).  The target reads of a warp are consecutive shared
// words (no bank conflicts), the source word is a broadcast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SJ = 32;   // words: pixels per block row (one warp)
constexpr int SI = 8;    // words: block rows
constexpr int TJ = 32;   // volume: output columns per block
constexpr int DC = 256;  // volume: disparities per block (at most)
constexpr int VW = 8;    // volume: warps per block

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

// The census words of one image per blockIdx.z into words[z] (n_words, H, W).
__global__ void __launch_bounds__(SJ * SI)
census_words_kernel(const float* __restrict__ src,
                    const float* __restrict__ tgt,
                    uint32_t* __restrict__ words, int H, int W, int hr,
                    int vr, int n_words) {
  extern __shared__ float tile[];  // (SI + 2v) x (SJ + 2h), 0 outside
  const float* x = blockIdx.z ? tgt : src;
  uint32_t* out = words + (size_t)blockIdx.z * n_words * H * W;
  const int i0 = blockIdx.y * SI, j0 = blockIdx.x * SJ;
  const int nv = 2 * vr + 1, nh = 2 * hr + 1;
  const int rows = SI + 2 * vr, sw = SJ + 2 * hr;
  const int tid = threadIdx.y * SJ + threadIdx.x;
  for (int e = tid; e < rows * sw; e += SJ * SI) {
    const int gi = i0 - vr + e / sw, gj = j0 - hr + e % sw;
    tile[e] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                  ? x[(size_t)gi * W + gj] : 0.f;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= H || j >= W) return;
  const float* win = tile + threadIdx.y * sw + threadIdx.x;
  const float s0 = win[0];
  const size_t plane = (size_t)H * W, p = (size_t)i * W + j;
  uint32_t word = 0;
  int bit = 0, w = 0;
  for (int a = 0; a < nv; ++a) {
    for (int b = (a == 0); b < nh; ++b) {
      word |= (uint32_t)(s0 > win[a * sw + b]) << bit;
      if (++bit == 32) {
        out[w++ * plane + p] = word;
        word = 0;
        bit = 0;
      }
    }
  }
  if (bit) out[w * plane + p] = word;  // the trailing partial word
}

// One block: row blockIdx.z, columns j0 .. j0 + TJ - 1, disparities
// d0 .. d0 + DC - 1.
template <typename OutT>
__global__ void __launch_bounds__(32 * VW)
census_cv_kernel(const uint32_t* __restrict__ words, OutT* __restrict__ out,
                 int H, int W, int D, int n_words) {
  extern __shared__ uint32_t sm[];
  const int d0 = blockIdx.x * DC, j0 = blockIdx.y * TJ, i = blockIdx.z;
  const int nd = min(DC, D - d0), nq = min(TJ, W - j0);
  const int tw = TJ + DC - 1;           // target columns staged a word
  uint32_t* s_w = sm;                   // n_words x TJ
  uint32_t* t_w = sm + n_words * TJ;    // n_words x tw
  const size_t plane = (size_t)H * W;
  const uint32_t* src = words + (size_t)i * W;
  const uint32_t* tgt = src + (size_t)n_words * plane;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int e = tid; e < n_words * TJ; e += 32 * VW) {
    const int w = e / TJ, j = j0 + e % TJ;
    s_w[e] = j < W ? src[w * plane + j] : 0u;
  }
  for (int e = tid; e < n_words * tw; e += 32 * VW) {
    const int w = e / tw, j = j0 + d0 + e % tw;
    t_w[e] = j < W ? tgt[w * plane + j] : 0u;  // out of range: zero words
  }
  __syncthreads();
  for (int q = threadIdx.y; q < nq; q += VW) {
    OutT* o = out + ((size_t)i * W + j0 + q) * D + d0;
    for (int dd = threadIdx.x; dd < nd; dd += 32) {
      int cost = 0;
      for (int w = 0; w < n_words; ++w)
        cost += __popc(s_w[w * TJ + q] ^ t_w[w * tw + q + dd]);
      store(o + dd, (float)cost);
    }
  }
}

template <typename OutT>
cudaError_t launch_cv(const uint32_t* words, void* out, int H, int W, int D,
                      int n_words, cudaStream_t stream) {
  const dim3 block(32, VW);
  const dim3 grid((D + DC - 1) / DC, (W + TJ - 1) / TJ, H);
  const size_t smem = sizeof(uint32_t) * n_words * (TJ + TJ + DC - 1);
  const cudaError_t e = set_smem((const void*)census_cv_kernel<OutT>, smem);
  if (e != cudaSuccess) return e;
  census_cv_kernel<OutT><<<grid, block, smem, stream>>>(
      words, static_cast<OutT*>(out), H, W, D, n_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" int census_words_launch(const void* src, const void* tgt,
                                   void* words, int H, int W, int hr, int vr,
                                   int n_words, void* stream) {
  const int n_bits = (2 * hr + 1) * (2 * vr + 1) - 1;
  if (H < 1 || W < 1 || hr < 0 || vr < 0 || n_bits < 1 ||
      n_words != (n_bits + 31) / 32 || (H + SI - 1) / SI > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(SJ, SI);
  const dim3 grid((W + SJ - 1) / SJ, (H + SI - 1) / SI, 2);
  const size_t smem = sizeof(float) * (SI + 2 * vr) * (SJ + 2 * hr);
  const cudaError_t e = set_smem((const void*)census_words_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  census_words_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<uint32_t*>(words), H, W, hr, vr, n_words);
  return (int)cudaGetLastError();
}

extern "C" int census_cv_launch(const void* words, void* out, int H, int W,
                                int D, int n_words, int out_bf16,
                                void* stream) {
  if (H < 1 || W < 1 || D < 1 || n_words < 1 || H > 65535 ||
      (W + TJ - 1) / TJ > 65535 ||
      sizeof(uint32_t) * n_words * (TJ + TJ + DC - 1) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  return (int)(out_bf16
                   ? launch_cv<__nv_bfloat16>(w, out, H, W, D, n_words, s)
                   : launch_cv<float>(w, out, H, W, D, n_words, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
