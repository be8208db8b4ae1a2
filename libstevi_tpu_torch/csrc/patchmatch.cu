// K6 and K7: PatchMatch propagation sweep and candidate probe over a
// precomputed cost-oriented volume.
//
// K6 (`pm_runs_kernel`, `pm_chain_kernel`, `pm_cost_kernel`, one sweep a
// `pm_sweep_launch`) replaces the TPU kernel `_sweep_kernel` of
// libstevi_tpu/ops/patchmatch_pallas.py (:47), launched by `sweep` (:176,
// call :197).  K7 (`pm_probe_kernel`) replaces `_probe_kernel` (:118),
// launched by `probe` (:144, call :167); its SEARCH instance also forms
// the random-search candidates from raw draws (`search_probe`).
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
// the row sweep, which these kernels do not need.  State: (H, W) int32
// disparity and f32 cost, read from the inputs, written to the outputs.
//
// K6's design.  The naive chain (one thread a chain, each step's volume
// address decided by the step before) is L dependent device-memory round
// trips, since the 147 MB volume at 480x640x120 is far past the 50 MB L2:
// ~0.68 us a line.  It rests on two exact facts instead.  Along a chain
// (one pixel position across the lines, in sweep order), call line m a
// source when the carry into line m + 1 is d_old[m]: line 0 is one, and so
// is every line that rejects its candidate.  (1) The lines after a source
// accept d_old[m] until the first line l that rejects it, which is then the
// next source; whether line l accepts d_old[m] depends on (l, d_old[m])
// alone, not on the chain.  (2) A line l with d_old[l] == d_old[m] may be
// taken as the next source whether it accepts or not: the carry into l + 1
// is d_old[l] either way.  So the chain is a walk from source to source,
// and the distance to the next source can be found for every line up
// front, in parallel:
//   A `pm_runs_kernel`, whole card, a thread a pixel: nxt[m] = the sweep
//     index of the first line after m that breaks the run of d_old[m]
//     (equal, or rejecting it), L where the run reaches the sweep's end.
//     It looks
//     1, 3, 4, 8, then 16 lines at a time, each batch's loads issued together
//     (the volume loads only where d_old differs), to the run's end.  An
//     out-of-range d_old[m] breaks at once; in a converged field most runs
//     break at the next line by equality, with no volume load; only the
//     few sources whose value floods far (a pixel of +inf cost accepts any
//     finite candidate) take many batches, in parallel with the rest.
//   B `pm_chain_kernel`, a thread of warp 0 a chain, 32 chains a block:
//     walks its chain through tiles of 32 lines x 32 chains of d_old and
//     nxt that the block's 8 warps copy into shared memory with cp.async
//     two tiles ahead (coalesced for either axis: the tile's contiguous
//     side is the chains for the column sweep and the lines for the row
//     sweep), and writes d_out through the same tile.  The tile's 64
//     values are read into registers first; then a line is a compare and
//     two selects (is it the next source; the value, the next source), on
//     registers only, with no load and no branch on the chain.
//   C `pm_cost_kernel`, whole card, a thread a pixel: with d_out known,
//     cost_out = sel if line l accepts d_out[l - 1], else cost_in: one
//     scattered load a pixel.
// What bounds it: the state planes (d_old and cost read, nxt written and
// read, d_out written and read, cost written: ~30 bytes a pixel, in L2 at
// 480x640) and the scattered 32-byte sectors of the volume (A: about one a
// pixel whose run does not break by equality; C: one a pixel), against the
// chain's L steps in B on 480 or 640 threads.  A and C fill the card; B is
// the part that stays sequential, and no step of it waits on device
// memory.
//
// K7: a thread takes 4 pixels (16-byte loads of each candidate plane and
// of the state where the planes are aligned), issues the K x 4 volume
// loads together (K a template argument, 1 to 8 a launch) and accepts in
// order in registers: bound by the scattered sectors.

#include <cuda_runtime.h>

namespace {

constexpr int RUNS_THREADS = 256;
constexpr int COST_THREADS = 256;
constexpr int PROBE_THREADS = 128;
constexpr int TL = 32;   // lines (and chains) a tile in B
constexpr int CW = 8;    // warps a block in B
constexpr int NB = 3;    // tile buffers in B
constexpr int MAX_K = 8; // candidate planes a K7 launch

__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ bool accepts(float sel, float cost) {
  return finite(sel) && sel <= cost;
}

// Lines g0 .. g0 + G - 1 (up to lim) after the source at q0 (q0 + g * step
// is the pixel g lines on): whether one breaks the run of v (volume index
// k), and at which offset.
template <int G>
__device__ __forceinline__ bool run_break(const float* __restrict__ cv,
                                          const int* __restrict__ disp,
                                          const float* __restrict__ cost,
                                          long long q0, long long step, int D,
                                          int k, int v, int g0, int lim,
                                          int& off) {
  int dl[G];
  float cl[G], sel[G];
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (g0 + t <= lim) {
      const long long q = q0 + (g0 + t) * step;
      dl[t] = disp[q];
      cl[t] = cost[q];
    }
  }
#pragma unroll
  for (int t = 0; t < G; ++t)
    if (g0 + t <= lim && dl[t] != v)
      sel[t] = cv[(q0 + (g0 + t) * step) * D + k];
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (g0 + t <= lim && (dl[t] == v || !accepts(sel[t], cl[t]))) {
      off = g0 + t;
      return true;
    }
  }
  return false;
}

// A: nxt[p] for every pixel p (see the note above).
__global__ void __launch_bounds__(RUNS_THREADS)
pm_runs_kernel(const float* __restrict__ cv, const int* __restrict__ disp,
               const float* __restrict__ cost, int* __restrict__ nxt, int H,
               int W, int D, int lower, int axis, int reverse) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)H * W) return;
  const int L = axis == 0 ? H : W;
  const int line = axis == 0 ? (int)(p / W) : (int)(p % W);
  const int n = reverse ? L - 1 - line : line;  // the line's sweep index
  const long long step =
      (reverse ? -1LL : 1LL) * (axis == 0 ? (long long)W : 1LL);
  const int rem = L - 1 - n;                    // lines after it
  const int v = disp[p], k = v - lower;
  int o = 1;  // the end, or every later line rejects v
  if (rem > 0 && k >= 0 && k < D &&
      !run_break<1>(cv, disp, cost, p, step, D, k, v, 1, rem, o) &&
      !run_break<3>(cv, disp, cost, p, step, D, k, v, 2, rem, o) &&
      !run_break<4>(cv, disp, cost, p, step, D, k, v, 5, rem, o) &&
      !run_break<8>(cv, disp, cost, p, step, D, k, v, 9, rem, o)) {
    o = rem + 1;  // past the end, unless a later batch breaks the run
    for (int g0 = 17; g0 <= rem; g0 += 16)
      if (run_break<16>(cv, disp, cost, p, step, D, k, v, g0, rem, o)) break;
  }
  nxt[p] = n + o;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// B: chains s0 .. s0 + 31, walked by warp 0; the CW warps of the block
// share the copies of the tiles and the stores of d_out.  Element (t, c)
// of a tile is line n0 + t (sweep order) of chain s0 + c; tile k sits in
// buffer k % NB and is copied two tiles ahead, one commit group a tile
// (empty past the last line).  Entries past the last line or chain hold
// stale values, which the chain may read but nothing writes out.
__global__ void __launch_bounds__(32 * CW)
pm_chain_kernel(const int* __restrict__ disp, const int* __restrict__ nxt,
                int* __restrict__ disp_out, int L, int S,
                long long line_stride, long long pix_stride, int reverse) {
  __shared__ int sd[NB][TL][TL + 1], sn[NB][TL][TL + 1];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int s0 = blockIdx.x * TL;
  // a thread's elements are e = wid + CW i of the tile's contiguous side:
  // the chains (pixel stride 1: (t, c) = (e, lane)) or the lines
  // ((t, c) = (lane, e)); element e lies e * q_step past element 0
  const bool by_chain = pix_stride == 1;
  const long long to_next = reverse ? -line_stride : line_stride;
  const long long q_step = by_chain ? to_next : pix_stride;
  const int s_step = by_chain ? TL + 1 : 1;      // in the tile, ints
  const int s_lane = by_chain ? lane : lane * (TL + 1);
  auto first = [&](int n0) {  // the address of the thread's element 0
    return (long long)(reverse ? L - 1 - n0 : n0) * line_stride +
           (long long)s0 * pix_stride + lane * (by_chain ? 1 : to_next);
  };
  auto fetch = [&](int n0, int b) {
    const long long q0 = first(n0);
    const int lim = by_chain ? L - n0 : S - s0;  // e < lim
    const bool ok = by_chain ? s0 + lane < S : n0 + lane < L;
#pragma unroll
    for (int i = 0; i < TL / CW; ++i) {
      const int e = wid + CW * i;
      if (ok && e < lim) {
        const long long q = q0 + e * q_step;
        cp_async4(&sd[b][0][0] + s_lane + e * s_step, disp + q);
        cp_async4(&sn[b][0][0] + s_lane + e * s_step, nxt + q);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  int v = 0, nb = 0;  // the value carried, the next source
  fetch(0, 0);
  fetch(TL, 1);
  for (int n0 = 0, b = 0; n0 < L; n0 += TL, b = b + 1 == NB ? 0 : b + 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile
    __syncthreads();
    fetch(n0 + 2 * TL, b + 2 < NB ? b + 2 : b + 2 - NB);  // off the chain
    if (wid == 0) {  // the chain, on registers
      int dl[TL], nl[TL];
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        dl[t] = sd[b][t][lane];
        nl[t] = sn[b][t][lane];
      }
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        const bool src = n0 + t == nb;
        v = src ? dl[t] : v;
        nb = src ? nl[t] : nb;
        dl[t] = v;
      }
#pragma unroll
      for (int t = 0; t < TL; ++t) sd[b][t][lane] = dl[t];
    }
    __syncthreads();
    const long long q0 = first(n0);
    const int lim = by_chain ? L - n0 : S - s0;
    const bool ok = by_chain ? s0 + lane < S : n0 + lane < L;
#pragma unroll
    for (int i = 0; i < TL / CW; ++i) {
      const int e = wid + CW * i;
      if (ok && e < lim)
        disp_out[q0 + e * q_step] = (&sd[b][0][0])[s_lane + e * s_step];
    }
  }
}

// C: the costs, from d_out.
__global__ void __launch_bounds__(COST_THREADS)
pm_cost_kernel(const float* __restrict__ cv, const int* __restrict__ disp_out,
               const float* __restrict__ cost, float* __restrict__ cost_out,
               int H, int W, int D, int lower, int axis, int reverse) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)H * W) return;
  const int L = axis == 0 ? H : W;
  const int line = axis == 0 ? (int)(p / W) : (int)(p % W);
  const int n = reverse ? L - 1 - line : line;
  float c = cost[p];
  if (n > 0) {
    const long long step =
        (reverse ? -1LL : 1LL) * (axis == 0 ? (long long)W : 1LL);
    const int k = disp_out[p - step] - lower;  // the candidate line n took
    if (k >= 0 && k < D) {
      const float sel = cv[p * D + k];
      if (accepts(sel, c)) c = sel;
    }
  }
  cost_out[p] = c;
}

// floor((a) / b) for b > 0, as the candidate scaling's `//` on int32
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// K7: candidate planes k0 .. k0 + K - 1 of a probe (SEARCH: raw draws,
// formed into candidates from `base`, the pre-probe disparity, by the
// k-th scaling of n_random), four pixels a thread.
template <int K, bool SEARCH>
__global__ void __launch_bounds__(PROBE_THREADS)
pm_probe_kernel(const float* __restrict__ cv, const int* __restrict__ cand,
                const int* __restrict__ base, const int* __restrict__ disp_in,
                const float* __restrict__ cost_in, int* __restrict__ disp_out,
                float* __restrict__ cost_out, long long N, int D, int lower,
                int k0, int n_random, int vec) {
  const long long p0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (p0 >= N) return;
  const bool v4 = vec && p0 + 4 <= N;
  int d[4], b[4], cd[K][4];
  float c[4];
  if (v4) {
    const int4 d4 = *reinterpret_cast<const int4*>(disp_in + p0);
    const float4 c4 = *reinterpret_cast<const float4*>(cost_in + p0);
    d[0] = d4.x, d[1] = d4.y, d[2] = d4.z, d[3] = d4.w;
    c[0] = c4.x, c[1] = c4.y, c[2] = c4.z, c[3] = c4.w;
    if (SEARCH) {
      const int4 b4 = *reinterpret_cast<const int4*>(base + p0);
      b[0] = b4.x, b[1] = b4.y, b[2] = b4.z, b[3] = b4.w;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int4 x = *reinterpret_cast<const int4*>(cand + k * N + p0);
      cd[k][0] = x.x, cd[k][1] = x.y, cd[k][2] = x.z, cd[k][3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long p = p0 + i < N ? p0 + i : N - 1;  // repeats the last
      d[i] = disp_in[p];
      c[i] = cost_in[p];
      if (SEARCH) b[i] = base[p];
#pragma unroll
      for (int k = 0; k < K; ++k) cd[k][i] = cand[k * N + p];
    }
  }
  if (SEARCH) {  // `_scaled_candidate`: toward base, forced off it
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = b[i] + floor_div((cd[k][i] - b[i]) * (k0 + k + 1),
                                       n_random + 1);
        cd[k][i] = x == b[i] ? b[i] + 1 : x;
      }
  }
  float sel[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = cd[k][i] - lower;
      const long long p = p0 + i < N ? p0 + i : N - 1;
      sel[k][i] = (kk >= 0 && kk < D) ? cv[p * D + kk] : INFINITY;
    }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (accepts(sel[k][i], c[i])) {  // +inf: out of range or invalid
        d[i] = cd[k][i];
        c[i] = sel[k][i];
      }
  if (v4) {
    *reinterpret_cast<int4*>(disp_out + p0) = make_int4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(cost_out + p0) =
        make_float4(c[0], c[1], c[2], c[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (p0 + i < N) {
        disp_out[p0 + i] = d[i];
        cost_out[p0 + i] = c[i];
      }
  }
}

template <bool SEARCH>
cudaError_t probe_t(const float* cv, const int* cand, const int* base,
                    const int* d_in, const float* c_in, int* d_out,
                    float* c_out, long long N, int D, int K, int lower,
                    int k0, int n_random, int vec, cudaStream_t s) {
  const long long blocks = ((N + 3) / 4 + PROBE_THREADS - 1) / PROBE_THREADS;
#define PM_PROBE_CASE(k)                                                    \
  case k:                                                                   \
    pm_probe_kernel<k, SEARCH><<<(unsigned)blocks, PROBE_THREADS, 0, s>>>( \
        cv, cand, base, d_in, c_in, d_out, c_out, N, D, lower, k0,          \
        n_random, vec);                                                     \
    break;
  switch (K) {
    PM_PROBE_CASE(1) PM_PROBE_CASE(2) PM_PROBE_CASE(3) PM_PROBE_CASE(4)
    PM_PROBE_CASE(5) PM_PROBE_CASE(6) PM_PROBE_CASE(7) PM_PROBE_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef PM_PROBE_CASE
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

}  // namespace

// One sweep, three launches.  axis 0: scan along H (line = row i, pixels
// across j); axis 1: scan along W (line = column j, pixels across i).
// runs: H x W int32 scratch (A's next sources).
extern "C" int pm_sweep_launch(const void* cv, const void* disp_in,
                               const void* cost_in, void* disp_out,
                               void* cost_out, void* runs, int H, int W,
                               int D, int lower, int axis, int reverse,
                               void* stream) {
  if (H < 1 || W < 1 || D < 1 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(cv);
  const int* d_in = static_cast<const int*>(disp_in);
  const float* c_in = static_cast<const float*>(cost_in);
  int* nxt = static_cast<int*>(runs);
  const long long N = (long long)H * W;
  const unsigned pix_blocks = (unsigned)((N + RUNS_THREADS - 1) / RUNS_THREADS);
  pm_runs_kernel<<<pix_blocks, RUNS_THREADS, 0, s>>>(v, d_in, c_in, nxt, H, W,
                                                     D, lower, axis, reverse);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int L = axis == 0 ? H : W;
  const int S = axis == 0 ? W : H;
  pm_chain_kernel<<<(S + TL - 1) / TL, 32 * CW, 0, s>>>(
      d_in, nxt, static_cast<int*>(disp_out), L, S, axis == 0 ? W : 1,
      axis == 0 ? 1 : W, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pm_cost_kernel<<<(unsigned)((N + COST_THREADS - 1) / COST_THREADS),
                   COST_THREADS, 0, s>>>(
      v, static_cast<const int*>(disp_out), c_in,
      static_cast<float*>(cost_out), H, W, D, lower, axis, reverse);
  return (int)cudaGetLastError();
}

// K candidate planes (K x H x W int32, 1 <= K <= MAX_K) tried in order.
// search != 0: the planes are raw draws, and plane k is the candidate
// base + floor((draw - base) * (k0 + k + 1) / (n_random + 1)), moved to
// base + 1 where it equals base (base: the pre-probe disparity).
extern "C" int pm_probe_launch(const void* cv, const void* cand,
                               const void* base, const void* disp_in,
                               const void* cost_in, void* disp_out,
                               void* cost_out, int H, int W, int D, int K,
                               int lower, int search, int k0, int n_random,
                               void* stream) {
  if (H < 1 || W < 1 || D < 1 || K < 1 || K > MAX_K ||
      (search && (base == nullptr || n_random < 1 || k0 < 0)))
    return (int)cudaErrorInvalidValue;
  const long long N = (long long)H * W;
  const int vec = N % 4 == 0 && aligned16(cand) && aligned16(disp_in) &&
                  aligned16(cost_in) && aligned16(disp_out) &&
                  aligned16(cost_out) && (!search || aligned16(base));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(cv);
  const int* c = static_cast<const int*>(cand);
  const int* b = static_cast<const int*>(base);
  const int* d_in = static_cast<const int*>(disp_in);
  const float* c_in = static_cast<const float*>(cost_in);
  int* d_out = static_cast<int*>(disp_out);
  float* c_out = static_cast<float*>(cost_out);
  return (int)(search ? probe_t<true>(v, c, b, d_in, c_in, d_out, c_out, N,
                                      D, K, lower, k0, n_random, vec, s)
                      : probe_t<false>(v, c, b, d_in, c_in, d_out, c_out, N,
                                       D, K, lower, k0, n_random, vec, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
