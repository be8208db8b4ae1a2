// K4a, K4b, K4c and K4d: the lane-layout SGM kernels, for any disparity
// range.
//
// They replace the TPU kernels of libstevi_tpu/ops/sgm_pallas.py:
//   K4a `shift_rows_kernel` <- `_shift_rows_kernel` (:43, launched by
//       `_shift_rows` :59): out[i, c, :] = in[i, clamp(base + slope*i, 0,
//       smax) + c, :], the per-row window copy behind shear / unshear;
//   K4b `fused_rows_kernel` <- `_fused_rows_kernel` (:147): one sweep down
//       (or up) that carries the vertical direction and both diagonal
//       families at once, so the volume is read once for three directions;
//   K4c `fused_rows_kernel` with carries in and out, a global row offset
//       and the global height <- `sgm_rows_shard_pass` (:496, call :531);
//       the column half of K4c (`sgm_cols_shard_pass` :542) is K4b's
//       `fused_cols_kernel` on the shard's block, unchanged;
//   K4b `fused_cols_kernel` <- `_fused_cols_kernel` (:269) and, with WTA,
//       `_make_fused_cols_wta` (:297): the column scans, the reverse one
//       optionally fused with C = acc + adj + cv, the tie-last argmin and
//       the 2r+1 band (the centre slot is the minimum itself);
//   K4d `chunked_rows_kernel` <- `_chunked_rows_kernel` (:586, launched by
//       `_chunked_pass` :667): one W-chunk of a row sweep, carrying the
//       vertical direction (optional) and one diagonal family, with an (H, D)
//       edge history in and out.
//
// The DP step is `_fused_step` (:132-144): m = min(prev),
//   agg = min(min(prev[d], m + P2), min(prev[d-1], prev[d+1]) + P1),
//   adj = (agg - m) + pout,  carry = cv + adj,
// with prev[-1] = prev[D] = +inf and no isfinite guards; a line starts from
// a zero carry (a null carry pointer below).  The sums follow the TPU
// kernels' order: total = acc + adj_v + adj_p * mult + adj_n * mult, where
// mult is 2 on the corner line that `addDirectionalCost` enumerates from
// both start edges and 1 elsewhere (exact products, so a fused multiply-add
// rounds the same).  The plain versions in ops/sgm_lane_cuda.py repeat these
// operations in this order, so kernel and plain version agree to the bit.
//
// Unbounded D: K3 (sgm_scan.cu) keeps ceil(D/32) <= 10 values a lane in
// registers, and K2's any-D instance walks one line a warp.  Here every
// carry lives in shared memory (D floats per column
// and direction, double-buffered by row parity so no read of row i-1 races
// a write of row i); a warp walks one column (or one row, for the column
// scans), its lanes loop over d in 32-wide slices, the min over d is a loop
// plus a warp reduction, and d +- 1 are plain shared-memory reads.
//
// K4b rows is one cooperative grid of at most one block per SM.  Block b
// owns columns [b*ncols, (b+1)*ncols) and keeps their carries on chip
// (2 buffers x 3 carries x ncols x D x 4 B; 1 carry for 4 directions).  A
// diagonal carry moves one column per row, so each row a block also needs
// the previous row's carry of the neighbouring block's edge column: every
// block writes its two edge columns to a global buffer (again by row
// parity), and `grid.sync()` closes each row.  The rule that follows (see
// ops/sgm_lane_cuda.fused_fits): (2 * 3 * ceil(W / SMs) + 2) * D * 4 B (the
// carries and a two-carry halo; 2 * ceil(W / SMs) * D * 4 B for 4
// directions) must fit one block's shared memory (227 KiB).  On an H100 SXM
// (132 SMs) that holds 480x640 at D = 384 (48 KiB) and 720x1280 at D = 640
// (155 KiB).
//
// K4d is the route beyond that rule: chunks of CW columns run one after
// another, one block each, with the diagonal carry crossing a chunk edge
// through the edge history.  It runs on one SM at a time, so it is
// latency-bound by design; a wavefront over chunks is queued in ROADMAP.md.
//
// What bounds them on an H100: bytes.  A sweep reads the f32 volume (and
// the accumulator) once and writes the accumulator once; at 480x640x384 one
// volume stream is 472 MB, 0.14 ms at 3.35 TB/s.  The scans are chains of
// dependent row (or column) steps, each a min pass and an update pass over
// D in shared memory, so they run latency-bound well above that.  Each
// lane issues the loads of U = 8 d-slices before it computes or stores, so a
// step pays the global-load latency once per 256 disparities, not once per
// slice (the first version, one slice at a time, ran 1.8-2.4x slower).
// No float atomics anywhere: every carry has one writer, so two runs give
// the same bits.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int COLS_WARPS = 4;       // rows (warps) per block of the column scan
constexpr int U = 8;                // d-slices a lane loads before it computes
constexpr int SMEM_MAX = 232448;    // 227 KB, the most a block can opt into

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

// min over d of a carry (null: a zero carry); every lane gets it
__device__ __forceinline__ float carry_min(const float* p, int D, int lane) {
  if (p == nullptr) return 0.f;
  float m = INFINITY;
  for (int d = lane; d < D; d += 32) m = fminf(m, p[d]);
  return warp_min(m);
}

// `_fused_step`'s adjustment at disparity d (prev null: a zero carry)
__device__ __forceinline__ float step_adj(const float* prev, int d, int D,
                                          float m, float P1, float P2,
                                          float pout) {
  const float c = prev ? prev[d] : 0.f;
  const float left = d > 0 ? (prev ? prev[d - 1] : 0.f) : INFINITY;
  const float right = d + 1 < D ? (prev ? prev[d + 1] : 0.f) : INFINITY;
  const float agg = fminf(fminf(c, m + P2), fminf(left, right) + P1);
  return __fadd_rn(__fsub_rn(agg, m), pout);
}

// K4a: one block row of the per-row window copy.  Row i of the output is
// the contiguous run in[i, s_i : s_i + W_out, :], so the copy is flat, in
// 16-byte words (V = float4) when Dp is a multiple of 4.
template <typename V>
__global__ void shift_rows_kernel(const float* __restrict__ in,
                                  float* __restrict__ out, int W_in,
                                  int W_out, int Dp, int base, int slope,
                                  int smax) {
  constexpr int N = sizeof(V) / sizeof(float);
  const int i = blockIdx.y;
  const int s = max(0, min(base + slope * i, smax));
  const V* src = reinterpret_cast<const V*>(in + ((size_t)i * W_in + s) * Dp);
  V* dst = reinterpret_cast<V*>(out + (size_t)i * W_out * Dp);
  const size_t n = (size_t)W_out * Dp / N;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x)
    dst[e] = src[e];
}

// K4b rows: one sweep (down, or up with `reverse`) over the whole region.
// acc may alias out (accumulate in place) or be null.  edge is a global
// (2, 2, W, D) buffer for the block-edge diagonal carries; each row the
// block first stages the two neighbour-block carries it reads into shared
// memory (`halo`), so no warp waits on a chain of global loads.
//
// K4c (`sgm_rows_shard_pass`, sgm_pallas.py:496; `_fused_rows_kernel` with
// carries, :147-200) is the same sweep over one row shard: rows [i0, i0 +
// H) of an image H_img rows high.  cin, (1 or 3, W, D), holds the previous
// shard's post-step carries of its last scan row (null: a zero line start);
// the first scan row reads them where a whole image reads nothing, the
// diagonal ones shifted by one column as every row does.  The last scan
// row writes its carries to cout (null: none).  The corner multipliers key
// on the global row i0 + i and H_img.
template <bool DIAG>
__global__ void fused_rows_kernel(const float* __restrict__ cv,
                                  const float* acc, float* out, float* edge,
                                  const float* __restrict__ cin,
                                  float* __restrict__ cout, int H, int W,
                                  int D, int ncols, int col0, int W_pout,
                                  float P1, float P2, float Pout, int reverse,
                                  int i0, int H_img) {
  extern __shared__ float sm[];
  constexpr int NC = DIAG ? 3 : 1;  // vertical, pos (j - i), neg (i + j)
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c_lo = blockIdx.x * ncols, c_hi = min(W, c_lo + ncols);
  auto car = [&](int buf, int f, int lc) {
    return sm + ((size_t)(buf * NC + f) * ncols + lc) * D;
  };
  float* halo = sm + (size_t)2 * NC * ncols * D;  // [2 families][D]
  auto edg = [&](int buf, int f, int c) {
    return edge + (((size_t)buf * 2 + (f - 1)) * W + c) * D;
  };
  // the out-of-block column family f reads: pos reads c - 1 forward and
  // c + 1 reverse, neg the mirror
  const int halo_c[2] = {reverse ? c_hi : c_lo - 1, reverse ? c_lo - 1 : c_hi};
  // the previous row's carry of family f at column c (null: line start)
  auto src = [&](int rb, int f, int c) -> const float* {
    if (c < 0 || c >= W) return nullptr;
    if (c >= c_lo && c < c_hi) return car(rb, f, c - c_lo);
    return halo + (size_t)(f - 1) * D;
  };
  // the carry family f of column c that the first scan row continues
  auto cin_at = [&](int f, int c) -> const float* {
    if (cin == nullptr || c < 0 || c >= W) return nullptr;
    return cin + ((size_t)f * W + c) * D;
  };
  for (int t = 0; t < H; ++t) {
    const int i = reverse ? H - 1 - t : t;
    const int ig = i0 + i;  // the global row
    const int wb = t & 1, rb = wb ^ 1;
    const bool last = t == H - 1;
    if (DIAG && t) {
      for (int e = threadIdx.x; e < 2 * D; e += blockDim.x) {
        const int c = halo_c[e / D];
        if (c >= 0 && c < W) halo[e] = edg(rb, 1 + e / D, c)[e % D];
      }
      __syncthreads();
    }
    for (int c = c_lo + warp; c < c_hi; c += nwarps) {
      const int lc = c - c_lo;
      const bool at_edge = c == c_lo || c == c_hi - 1;
      const size_t pix = ((size_t)i * W + c) * D;
      const float* pv = t ? car(rb, 0, lc) : cin_at(0, c);
      const float *pp = nullptr, *pn = nullptr;
      float mult_p = 1.f, mult_n = 1.f;
      if (DIAG) {
        // pos: forward from column c-1, reverse from c+1; neg mirrored
        const int cp = reverse ? c + 1 : c - 1, cn = reverse ? c - 1 : c + 1;
        pp = t ? src(rb, 1, cp) : cin_at(1, cp);
        pn = t ? src(rb, 2, cn) : cin_at(2, cn);
        if (c == (reverse ? W - H_img + ig : ig)) mult_p = 2.f;
        if (c == (reverse ? H_img - 1 - ig : W - 1 - ig)) mult_n = 2.f;
      }
      const float mv = carry_min(pv, D, lane);
      const float mp = DIAG ? carry_min(pp, D, lane) : 0.f;
      const float mn = DIAG ? carry_min(pn, D, lane) : 0.f;
      float* cv_w = car(wb, 0, lc);
      float* co = (last && cout) ? cout + (size_t)c * D : nullptr;
      const size_t fs = (size_t)W * D;  // cout's family stride
      for (int d0 = lane; d0 < D; d0 += 32 * U) {
        float bs[U], as[U];  // issue U slices' loads before any store
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int d = d0 + 32 * k;
          bs[k] = d < D ? cv[pix + d] : 0.f;
          as[k] = (acc && d < D) ? acc[pix + d] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int d = d0 + 32 * k;
          if (d >= D) break;
          const float base = bs[k];
          const float pout = col0 + c + d >= W_pout ? Pout : 0.f;
          float total = as[k];
          const float av = step_adj(pv, d, D, mv, P1, P2, pout);
          cv_w[d] = __fadd_rn(base, av);
          if (co) co[d] = cv_w[d];
          total = __fadd_rn(total, av);
          if (DIAG) {
            const float ap = step_adj(pp, d, D, mp, P1, P2, pout);
            const float an = step_adj(pn, d, D, mn, P1, P2, pout);
            const float cp = __fadd_rn(base, ap), cn = __fadd_rn(base, an);
            car(wb, 1, lc)[d] = cp;
            car(wb, 2, lc)[d] = cn;
            if (at_edge) {
              edg(wb, 1, c)[d] = cp;
              edg(wb, 2, c)[d] = cn;
            }
            if (co) {
              co[fs + d] = cp;
              co[2 * fs + d] = cn;
            }
            total = __fadd_rn(total, __fmul_rn(ap, mult_p));
            total = __fadd_rn(total, __fmul_rn(an, mult_n));
          }
          out[pix + d] = total;
        }
      }
    }
    grid.sync();  // row i's carries and edges are complete everywhere
    __syncthreads();
  }
}

// K4b columns: one warp scans one row (left to right, or right to left
// with `reverse`), adding each column's adjustment into acc (out may alias
// acc).  With WTA (reverse only) it writes idx and the bands instead.
template <bool WTA>
__global__ void __launch_bounds__(32 * COLS_WARPS)
fused_cols_kernel(const float* __restrict__ cv, const float* acc, float* out,
                  int* __restrict__ idx, float* __restrict__ bands, int H,
                  int W, int D, int col0, int W_pout, float P1, float P2,
                  float Pout, int reverse, int r) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * COLS_WARPS + warp;
  if (i >= H) return;
  float* bufs = sm + (size_t)warp * (WTA ? 3 : 2) * D;
  float* Cs = bufs + 2 * D;  // the WTA pass's C at one pixel
  const int nb = 2 * r + 1;
  for (int t = 0; t < W; ++t) {
    const int j = reverse ? W - 1 - t : t;
    const float* prev = t ? bufs + ((t - 1) & 1) * D : nullptr;
    float* cur = bufs + (t & 1) * D;
    const float m = carry_min(prev, D, lane);
    const size_t pix = ((size_t)i * W + j) * D;
    float lm = INFINITY;
    for (int d0 = lane; d0 < D; d0 += 32 * U) {
      float bs[U], as[U];  // issue U slices' loads before any store
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int d = d0 + 32 * k;
        bs[k] = d < D ? cv[pix + d] : 0.f;
        as[k] = d < D ? acc[pix + d] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int d = d0 + 32 * k;
        if (d >= D) break;
        const float base = bs[k];
        const float pout = col0 + j + d >= W_pout ? Pout : 0.f;
        const float adj = step_adj(prev, d, D, m, P1, P2, pout);
        cur[d] = __fadd_rn(base, adj);
        if (WTA) {
          const float C = __fadd_rn(__fadd_rn(as[k], adj), base);
          Cs[d] = C;
          lm = fminf(lm, C);
        } else {
          out[pix + d] = __fadd_rn(as[k], adj);
        }
      }
    }
    __syncwarp();
    if (WTA) {
      const float mC = warp_min(lm);
      int best = -1;
      for (int d = lane; d < D; d += 32)  // ascending d: keep the last hit
        if (Cs[d] == mC) best = d;
      best = warp_max(best);  // ties go to the LAST index
      const size_t p = (size_t)i * W + j;
      for (int s = lane; s < nb; s += 32) {
        const int q = best + s - r;
        bands[p * nb + s] = s == r ? mC
                                   : (q >= 0 && q < D ? Cs[q] : INFINITY);
      }
      if (lane == 0) idx[p] = best;
      __syncwarp();  // Cs is rewritten at the next pixel
    }
  }
}

// K4d: one chunk of columns [c0, c0 + Wc) of a row sweep, one block.
// shift_down: the diagonal carry moves to higher columns each row and the
// chunk's column 0 takes the history row; otherwise to lower columns and
// column Wc-1 takes it.  hout[i] is the boundary column's post-row carry
// (the one the neighbour chunk consumes), or hin[i] without the diagonal.
__global__ void chunked_rows_kernel(
    const float* __restrict__ cv, const float* acc, float* out,
    const float* __restrict__ hin, float* __restrict__ hout, int H, int W,
    int D, int c0, int Wc, int col0, int W_pout, float P1, float P2,
    float Pout, int reverse, int shift_down, int corner_c0, int corner_slope,
    int with_vertical, int with_diag, int accumulate) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  auto car = [&](int buf, int f, int lc) {  // f 0: vertical, 1: diagonal
    return sm + ((size_t)(buf * 2 + f) * Wc + lc) * D;
  };
  float* hrow = sm + (size_t)4 * Wc * D;  // the history row, staged
  for (int t = 0; t < H; ++t) {
    const int i = reverse ? H - 1 - t : t;
    const int wb = t & 1, rb = wb ^ 1;
    const int cj = corner_c0 + corner_slope * i - c0;
    if (with_diag) {
      for (int d = threadIdx.x; d < D; d += blockDim.x)
        hrow[d] = hin[(size_t)i * D + d];
      __syncthreads();
    }
    for (int lc = warp; lc < Wc; lc += nwarps) {
      const int c = c0 + lc;
      const size_t pix = ((size_t)i * W + c) * D;
      const float* pv = (with_vertical && t) ? car(rb, 0, lc) : nullptr;
      const float* pd = nullptr;
      if (with_diag) {
        const int ls = shift_down ? lc - 1 : lc + 1;
        if (ls < 0 || ls >= Wc) pd = hrow;
        else if (t) pd = car(rb, 1, ls);
      }
      const bool boundary = lc == (shift_down ? Wc - 1 : 0);
      const float mult = lc == cj ? 2.f : 1.f;
      const float mv = with_vertical ? carry_min(pv, D, lane) : 0.f;
      const float md = with_diag ? carry_min(pd, D, lane) : 0.f;
      for (int d0 = lane; d0 < D; d0 += 32 * U) {
        float bs[U], as[U];  // issue U slices' loads before any store
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int d = d0 + 32 * k;
          bs[k] = d < D ? cv[pix + d] : 0.f;
          as[k] = (accumulate && d < D) ? acc[pix + d] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int d = d0 + 32 * k;
          if (d >= D) break;
          const float base = bs[k];
          const float pout = col0 + c + d >= W_pout ? Pout : 0.f;
          float total = as[k];
          if (with_vertical) {
            const float av = step_adj(pv, d, D, mv, P1, P2, pout);
            car(wb, 0, lc)[d] = __fadd_rn(base, av);
            total = __fadd_rn(total, av);
          }
          if (with_diag) {
            const float ad = step_adj(pd, d, D, md, P1, P2, pout);
            const float cd = __fadd_rn(base, ad);
            car(wb, 1, lc)[d] = cd;
            if (boundary) hout[(size_t)i * D + d] = cd;
            total = __fadd_rn(total, __fmul_rn(ad, mult));
          }
          out[pix + d] = total;
        }
      }
    }
    __syncthreads();
  }
  if (!with_diag)
    for (size_t e = threadIdx.x; e < (size_t)H * D; e += blockDim.x)
      hout[e] = hin[e];
}

bool bad_region(int H, int W, int D, int col0, int W_pout) {
  return H < 1 || W < 1 || D < 1 || col0 < 0 || W_pout < col0 + W;
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int shift_rows_launch(const void* in, void* out, int H, int W_in,
                                 int W_out, int Dp, int base, int slope,
                                 void* stream) {
  const int smax = W_in - W_out;
  if (H < 1 || W_out < 1 || Dp < 1 || smax < 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)W_out * Dp;
  const int threads = 256;
  const int bx = (int)((n + threads * 16 - 1) / (threads * 16));
  const dim3 grid(bx, H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(in);
  float* y = static_cast<float*>(out);
  if (Dp % 4 == 0)  // every row start is then 16-byte aligned
    shift_rows_kernel<float4><<<grid, threads, 0, s>>>(x, y, W_in, W_out, Dp,
                                                       base, slope, smax);
  else
    shift_rows_kernel<float><<<grid, threads, 0, s>>>(x, y, W_in, W_out, Dp,
                                                      base, slope, smax);
  return (int)cudaGetLastError();
}

// cin / cout: null, or (1 or 3, W, D) carries in / out (K4c); the region
// is rows [i0, i0 + H) of an image H_img rows high.
extern "C" int fused_rows_launch(const void* cv, const void* acc, void* out,
                                 void* edge, const void* cin, void* cout,
                                 int H, int W, int D, int ncols, int col0,
                                 int W_pout, float P1, float P2, float Pout,
                                 int reverse, int diag, int i0, int H_img,
                                 void* stream) {
  if (bad_region(H, W, D, col0, W_pout) || ncols < 1 || i0 < 0 ||
      H_img < i0 + H)
    return (int)cudaErrorInvalidValue;
  const int blocks = (W + ncols - 1) / ncols;
  const int threads = 32 * min(ncols, 32);
  const size_t smem =
      sizeof(float) * (2 * (diag ? 3 : 1) * ncols + (diag ? 2 : 0)) * (size_t)D;
  const void* fn = diag ? (const void*)fused_rows_kernel<true>
                        : (const void*)fused_rows_kernel<false>;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  // a cooperative grid must be resident at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, threads, smem)) != cudaSuccess)
    return (int)e;
  if ((long long)per_sm * sms < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* c = static_cast<const float*>(cv);
  const float* a = static_cast<const float*>(acc);
  float* o = static_cast<float*>(out);
  float* g = static_cast<float*>(edge);
  const float* ci = static_cast<const float*>(cin);
  float* co = static_cast<float*>(cout);
  void* args[] = {&c,    &a,   &o,      &g,  &ci, &co, &H,   &W,
                  &D,    &ncols, &col0, &W_pout, &P1, &P2, &Pout, &reverse,
                  &i0,   &H_img};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int fused_cols_launch(const void* cv, const void* acc, void* out,
                                 void* idx, void* bands, int H, int W, int D,
                                 int col0, int W_pout, float P1, float P2,
                                 float Pout, int reverse, int r, int wta,
                                 void* stream) {
  if (bad_region(H, W, D, col0, W_pout) || (wta && (!reverse || r < 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * COLS_WARPS * (wta ? 3 : 2) * (size_t)D;
  const void* fn = wta ? (const void*)fused_cols_kernel<true>
                       : (const void*)fused_cols_kernel<false>;
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (H + COLS_WARPS - 1) / COLS_WARPS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cv);
  const float* a = static_cast<const float*>(acc);
  if (wta)
    fused_cols_kernel<true><<<blocks, 32 * COLS_WARPS, smem, s>>>(
        c, a, nullptr, static_cast<int*>(idx), static_cast<float*>(bands), H,
        W, D, col0, W_pout, P1, P2, Pout, reverse, r);
  else
    fused_cols_kernel<false><<<blocks, 32 * COLS_WARPS, smem, s>>>(
        c, a, static_cast<float*>(out), nullptr, nullptr, H, W, D, col0,
        W_pout, P1, P2, Pout, reverse, 0);
  return (int)cudaGetLastError();
}

extern "C" int chunked_rows_launch(const void* cv, const void* acc, void* out,
                                   const void* hin, void* hout, int H, int W,
                                   int D, int c0, int Wc, int col0,
                                   int W_pout, float P1, float P2, float Pout,
                                   int reverse, int shift_down, int corner_c0,
                                   int corner_slope, int with_vertical,
                                   int with_diag, int accumulate,
                                   void* stream) {
  if (bad_region(H, W, D, col0, W_pout) || c0 < 0 || Wc < 1 || c0 + Wc > W)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (4 * (size_t)Wc + 1) * D;
  const cudaError_t e = allow_smem((const void*)chunked_rows_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  chunked_rows_kernel<<<1, 32 * min(Wc, 32), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cv), static_cast<const float*>(acc),
      static_cast<float*>(out), static_cast<const float*>(hin),
      static_cast<float*>(hout), H, W, D, c0, Wc, col0, W_pout, P1, P2, Pout,
      reverse, shift_down, corner_c0, corner_slope, with_vertical, with_diag,
      accumulate);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
