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
// K2s is K2 and K2k on one shard of a distributed image, the TPU kernel's
// `with_carries` mode (`sgm_rows_shard_pass_dhw` :1013, called at :1078;
// `sgm_cols_shard_pass_dhw` :1088): carries in and out (one D-vector per
// column, or per row for the horizontal-primary knights, which run on
// column shards), the shard's global first scan row and the global extent,
// on which the corner weights and the knight drift parity key.  The
// parity is a run-time integer, so shards of any height give the whole
// image's result; the carries relay exactly, so shard after shard equals
// the whole-image pass bit for bit.  K2k past D = 320 runs
// `sgm_knight_smem_kernel`, the same lines with the carry in shared memory.
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
// D <= 320: K = ceil(D / 32) <= 10 values a lane (K2k: any D, above).  The TPU path needed a
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
//
// K2s (a vertical or diagonal direction on one row shard of an image; the
// TPU kernel's `with_carries` mode, sgm_pallas_dhw.py:164, :201-213,
// :363-371): the block holds image rows [i0, i0 + H) of an image H_img
// rows high.  A line crossing the shard's first scan row continues the
// previous shard's line: it starts from cin[c'] (W x D, the previous row's
// post-step carries; c' = c - dj, the column the line left; null or c' off
// the image: a zero carry, the line start), and a line reaching the last
// scan row leaves its post-step carry in cout[c].  Lines that start inside
// the shard start at the side edge.  The corner line is the one through
// the global corner row, so its weight keys on the global row.  A whole
// image is the shard i0 = 0, H_img = H with no carries.
template <int K, typename T>
__global__ void __launch_bounds__(32 * WARPS)
sgm_pass_kernel(const T* __restrict__ cv, float* __restrict__ acc,
                const float* __restrict__ cin, float* __restrict__ cout,
                int H, int W, int D, int di, int dj, float P1, float P2,
                float Pout, int accumulate, int col0, int W_pout, int i0,
                int H_img) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int si, sj, len;
  float w = 1.f;
  const float* src = nullptr;  // the carry the line starts from (null: zero)
  if (di == 0) {  // horizontal: one line per row
    if (line >= H) return;
    si = line;
    sj = dj > 0 ? 0 : W - 1;
    len = W;
  } else {
    // W lines cross the shard's first scan row; a diagonal direction adds
    // H - 1 lines that start at the side edge of the shard's other rows
    const int ir = di > 0 ? 0 : H - 1, je = dj > 0 ? 0 : W - 1;
    if (line < W) {
      si = ir;
      sj = line;
      const int pc = sj - dj;
      if (cin != nullptr && pc >= 0 && pc < W) src = cin + (size_t)pc * D;
      // the corner line, enumerated from both edges: it passes global row
      // ig at column je + dj * (steps from the global start row)
      const int ig = i0 + ir;
      if (dj != 0 && sj == je + dj * (di > 0 ? ig : H_img - 1 - ig)) w = 2.f;
    } else {
      if (dj == 0 || line >= W + H - 1) return;
      const int t = line - W + 1;
      si = di > 0 ? t : H - 1 - t;
      sj = je;
    }
    len = dj == 0 ? H
                  : min(di > 0 ? H - si : si + 1, dj > 0 ? W - sj : sj + 1);
  }
  const long long step = (long long)di * W + dj;
  long long pix = (long long)si * W + sj;
  const int i_last = di > 0 ? H - 1 : 0;  // the shard's last scan row

  float carry[K], bn[K], an[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    carry[k] = d < D ? (src ? src[d] : 0.f) : INFINITY;
    bn[k] = d < D ? load(cv + pix * D + d) : INFINITY;
    an[k] = (accumulate && d < D) ? acc[pix * D + d] : 0.f;
  }
  int i = si, j = sj;
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
    const bool out = cout != nullptr && di != 0 && i == i_last;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        carry[k] = b[k] + adj[k];
        acc[pix * D + d] = a[k] + w * adj[k];
        if (out) cout[(size_t)j * D + d] = carry[k];
      }
    }
    pix += step;
    i += di;
    j += dj;
  }
}

// The knight line one warp walks in one seed phase of a block of scan rows.
//
// Vertical-primary directions (v0 == v1) scan rows and drift along columns;
// horizontal-primary ones the other way round.  The block is scan rows
// [s0, s0 + N) of N_img (global); t is the global scan step of a pixel,
// counted from the start edge.  A line of phase p drifts on its way into
// step t exactly when t % 2 == p, so in each phase every lateral position
// x holds at most one line at every step, and the lines are: those that
// cross the block's first scan row (t0), and side seeds at the block's
// later steps t with t % 2 == p.  At t0 phase 0 covers every lateral
// position, and phase 1 the positions u <= (t0 - 1) / 2 (u the distance
// from the side edge: phase-1 lines are the odd side seeds, and each
// drift lets one more in).  A crossing line starts from cin at the
// lateral position it left (null, or off the block: a zero carry); the
// corner line (phase 0, u == t / 2) has weight 2.  A whole image is the
// block s0 = 0, N_img = N with no carries, which gives `addDirectionalCost`'s
// enumeration: the start-edge seeds, then the side seeds by offset.
struct KnightLine {
  int i, j;   // first pixel
  int c;      // parity of the first step's index along the line
  int src;    // lateral position of the carry it starts from, or -1
  float w;    // 2 on the corner line
  bool ok;
};

__device__ __forceinline__ KnightLine knight_line(int line, int H, int W,
                                                  int v0, int v1, int h0,
                                                  int h1, int phase, int s0,
                                                  int N_img) {
  const bool vert = v0 == v1;
  const int N = vert ? H : W, X = vert ? W : H;
  const int pstep = vert ? v0 : h0, drift = vert ? h1 : v1;
  const int p_first = pstep > 0 ? 0 : N - 1;
  const int t0 = pstep > 0 ? s0 : N_img - s0 - N;
  const int n_entry =
      phase == 0 ? X : (t0 > 0 ? min(X, (t0 - 1) / 2 + 1) : 0);
  KnightLine L;
  L.w = 1.f;
  L.src = -1;
  L.ok = true;
  int p, x, t;
  if (line < n_entry) {
    x = drift > 0 ? line : X - 1 - line;
    p = p_first;
    t = t0;
    const int px = (t0 & 1) == phase ? x - drift : x;
    if (px >= 0 && px < X) L.src = px;
    if (phase == 0 && line == t0 / 2) L.w = 2.f;
  } else {
    const int t_first = t0 + 1 + (((t0 + 1) & 1) != phase);
    t = t_first + 2 * (line - n_entry);
    if (t >= t0 + N) {
      L.ok = false;
      return L;
    }
    p = p_first + pstep * (t - t0);
    x = drift > 0 ? 0 : X - 1;
  }
  L.i = vert ? p : x;
  L.j = vert ? x : p;
  L.c = (t + phase) & 1;
  return L;
}

__host__ __device__ inline int knight_lines(int H, int W, int v0, int h0,
                                            int phase, int s0, int N_img,
                                            bool vert) {
  const int N = vert ? H : W, X = vert ? W : H;
  const int pstep = vert ? v0 : h0;
  const int t0 = pstep > 0 ? s0 : N_img - s0 - N;
  const int n_b = t0 > 0 ? (t0 - 1) / 2 + 1 : 0;
  const int n_entry = phase == 0 ? X : (n_b < X ? n_b : X);
  const int t_first = t0 + 1 + (((t0 + 1) & 1) != phase);
  return n_entry + (t_first < t0 + N ? (t0 + N - t_first + 1) / 2 : 0);
}

// K2k: one seed phase of one knight direction with steps (v0, h0), (v1, h1),
// on a whole image or (K2s) on one block of scan rows with carries in and
// out (`knight_line`).  Vertical-primary directions (v0 == v1) seed at
// every column of the top or bottom row and at every row of one side
// column; horizontal-primary ones the other way round.  The start edge is
// the one whose seeds sit at offset 0 along the primary axis; the corner
// seed belongs to both edges.  cin and cout hold one D-vector per lateral
// position (W x D for vertical-primary directions, H x D otherwise).
template <int K, typename T>
__global__ void __launch_bounds__(32 * WARPS)
sgm_knight_kernel(const T* __restrict__ cv, float* __restrict__ acc,
                  const float* __restrict__ cin, float* __restrict__ cout,
                  int H, int W, int D, int v0, int v1, int h0, int h1,
                  int phase, float P1, float P2, float Pout, int col0,
                  int W_pout, int s0, int N_img) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const KnightLine L =
      knight_line(line, H, W, v0, v1, h0, h1, phase, s0, N_img);
  if (!L.ok) return;
  const bool vert = v0 == v1;
  const int last = vert ? (v0 > 0 ? H - 1 : 0) : (h0 > 0 ? W - 1 : 0);
  const float w = L.w;
  const float* src =
      (cin != nullptr && L.src >= 0) ? cin + (size_t)L.src * D : nullptr;
  long long pix = (long long)L.i * W + L.j;

  float carry[K], bn[K], an[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    carry[k] = d < D ? (src ? src[d] : 0.f) : INFINITY;
    bn[k] = d < D ? load(cv + pix * D + d) : INFINITY;
    an[k] = d < D ? acc[pix * D + d] : 0.f;
  }
  int i = L.i, j = L.j;
  for (int c = L.c;; ++c) {
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
    float* co = nullptr;
    if (cout != nullptr && (vert ? i : j) == last)
      co = cout + (size_t)(vert ? j : i) * D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        carry[k] = b[k] + adj[k];
        acc[pix * D + d] = a[k] + w * adj[k];
        if (co) co[d] = carry[k];
      }
    }
    if (!more) break;
    pix = nxt;
    i = ni;
    j = nj;
  }
}

// K2k for any D: `sgm_knight_kernel` with the carry in shared memory in
// place of registers (K = ceil(D / 32) > 10 would not fit them).  Each warp
// keeps two D-float carries (the previous and the current step, swapped
// every step); lanes loop over 32-wide d-slices, the min over d is a loop
// plus a warp reduction and d +- 1 are shared-memory reads, as in
// sgm_lane.cu.  The lines, the DP step (`dp_step`'s operations in its
// order, the isfinite guards included) and the accumulation are
// `sgm_knight_kernel`'s.  Each lane issues the loads of U d-slices before
// it computes, so a step pays the load latency once per 32 * U disparities.
constexpr int U = 8;

__device__ __forceinline__ float finite_or_inf(float x) {
  return isfinite(x) ? x : INFINITY;
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
sgm_knight_smem_kernel(const T* __restrict__ cv, float* __restrict__ acc,
                       const float* __restrict__ cin,
                       float* __restrict__ cout, int H, int W, int D, int v0,
                       int v1, int h0, int h1, int phase, float P1, float P2,
                       float Pout, int col0, int W_pout, int s0, int N_img) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int line = blockIdx.x * WARPS + warp;
  const KnightLine L =
      knight_line(line, H, W, v0, v1, h0, h1, phase, s0, N_img);
  if (!L.ok) return;
  const bool vert = v0 == v1;
  const int last = vert ? (v0 > 0 ? H - 1 : 0) : (h0 > 0 ? W - 1 : 0);
  const float w = L.w;
  float* bufs = sm + (size_t)warp * 2 * D;
  const float* src =
      (cin != nullptr && L.src >= 0) ? cin + (size_t)L.src * D : nullptr;
  for (int d = lane; d < D; d += 32) bufs[d] = src ? src[d] : 0.f;
  __syncwarp();
  int i = L.i, j = L.j, cur = 0;
  for (int c = L.c;; ++c) {
    const float* prev = bufs + cur * D;
    float* next = bufs + (cur ^ 1) * D;
    const long long pix = (long long)i * W + j;
    float lm = INFINITY;
    for (int d = lane; d < D; d += 32) lm = fminf(lm, finite_or_inf(prev[d]));
    const float m = warp_min(lm);
    float* co = nullptr;
    if (cout != nullptr && (vert ? i : j) == last)
      co = cout + (size_t)(vert ? j : i) * D;
    for (int d0 = lane; d0 < D; d0 += 32 * U) {
      float bs[U], as[U];  // issue U slices' loads before any store
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int d = d0 + 32 * k;
        bs[k] = d < D ? load(cv + pix * D + d) : 0.f;
        as[k] = d < D ? acc[pix * D + d] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int d = d0 + 32 * k;
        if (d >= D) break;
        const float p = finite_or_inf(prev[d]);
        const float up = d > 0 ? finite_or_inf(prev[d - 1]) : INFINITY;
        const float dn = d + 1 < D ? finite_or_inf(prev[d + 1]) : INFINITY;
        float agg = fminf(fminf(p, m + P2), fminf(up + P1, dn + P1));
        if (col0 + j + d >= W_pout) agg += Pout;  // disparity leaves the image
        const float adj = (isfinite(agg) && isfinite(m)) ? agg - m : 0.f;
        const float nc = bs[k] + adj;
        next[d] = nc;
        acc[pix * D + d] = as[k] + w * adj;
        if (co) co[d] = nc;
      }
    }
    __syncwarp();  // `next` is complete before it is read as `prev`
    const int ni = i + ((c & 1) ? v1 : v0), nj = j + ((c & 1) ? h1 : h0);
    if (ni < 0 || ni >= H || nj < 0 || nj >= W) break;
    i = ni;
    j = nj;
    cur ^= 1;
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
cudaError_t pass_t(int K, const void* cv, float* acc, const float* cin,
                   float* cout, int H, int W, int D, int di, int dj, float P1,
                   float P2, float Pout, int accumulate, int col0, int W_pout,
                   int i0, int H_img, cudaStream_t s) {
  const int lines = di == 0 ? H : (dj == 0 ? W : H + W - 1);
  const int blocks = (lines + WARPS - 1) / WARPS;
  const T* v = static_cast<const T*>(cv);
#define SGM_PASS_CASE(k)                                                   \
  case k:                                                                  \
    sgm_pass_kernel<k, T><<<blocks, 32 * WARPS, 0, s>>>(                   \
        v, acc, cin, cout, H, W, D, di, dj, P1, P2, Pout, accumulate,      \
        col0, W_pout, i0, H_img);                                          \
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

constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block can opt into

template <typename T>
cudaError_t knight_t(int K, const void* cv, float* acc, const float* cin,
                     float* cout, int H, int W, int D, int v0, int v1, int h0,
                     int h1, int phase, float P1, float P2, float Pout,
                     int col0, int W_pout, int s0, int N_img,
                     cudaStream_t s) {
  const int lines = knight_lines(H, W, v0, h0, phase, s0, N_img, v0 == v1);
  if (lines == 0) return cudaSuccess;
  const int blocks = (lines + WARPS - 1) / WARPS;
  const T* v = static_cast<const T*>(cv);
  if (K > 10) {  // any D: the carries in shared memory
    const size_t smem = sizeof(float) * WARPS * 2 * (size_t)D;
    if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          (const void*)sgm_knight_smem_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    sgm_knight_smem_kernel<T><<<blocks, 32 * WARPS, smem, s>>>(
        v, acc, cin, cout, H, W, D, v0, v1, h0, h1, phase, P1, P2, Pout,
        col0, W_pout, s0, N_img);
    return cudaGetLastError();
  }
#define SGM_KNIGHT_CASE(k)                                                 \
  case k:                                                                  \
    sgm_knight_kernel<k, T><<<blocks, 32 * WARPS, 0, s>>>(                 \
        v, acc, cin, cout, H, W, D, v0, v1, h0, h1, phase, P1, P2, Pout,   \
        col0, W_pout, s0, N_img);                                          \
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

bool bad_region(int H, int W, int D, int col0, int W_pout) {
  return H < 1 || W < 1 || D < 1 || col0 < 0 || W_pout < col0 + W;
}

bool bad_geometry(int H, int W, int D, int col0, int W_pout) {
  return bad_region(H, W, D, col0, W_pout) || D > MAX_D;
}

}  // namespace

// cin / cout may be null (a zero line start / no carries out); with carries
// the block is rows [i0, i0 + H) of an image H_img rows high (K2s).
extern "C" int sgm_pass_launch(const void* cv, int cv_bf16, void* acc,
                               const void* cin, void* cout, int H, int W,
                               int D, int di, int dj, float P1, float P2,
                               float Pout, int accumulate, int col0,
                               int W_pout, int i0, int H_img, void* stream) {
  if (bad_geometry(H, W, D, col0, W_pout) || di < -1 || di > 1 || dj < -1 ||
      dj > 1 || (di == 0 && dj == 0) || i0 < 0 || H_img < i0 + H ||
      (di == 0 && (cin != nullptr || cout != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int K = (D + 31) / 32;
  float* a = static_cast<float*>(acc);
  const float* ci = static_cast<const float*>(cin);
  float* co = static_cast<float*>(cout);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cv_bf16 ? pass_t<__nv_bfloat16>(K, cv, a, ci, co, H, W, D, di,
                                               dj, P1, P2, Pout, accumulate,
                                               col0, W_pout, i0, H_img, s)
                       : pass_t<float>(K, cv, a, ci, co, H, W, D, di, dj, P1,
                                       P2, Pout, accumulate, col0, W_pout, i0,
                                       H_img, s));
}

// Any D (the shared-memory instance past D = 320).  With carries the block
// is scan rows [s0, s0 + N) of N_img along the primary axis (rows for
// vertical-primary directions, columns otherwise), and cin / cout hold one
// D-vector per position along the other axis (K2s).
extern "C" int sgm_knight_launch(const void* cv, int cv_bf16, void* acc,
                                 const void* cin, void* cout, int H, int W,
                                 int D, int v0, int v1, int h0, int h1,
                                 int phase, float P1, float P2, float Pout,
                                 int col0, int W_pout, int s0, int N_img,
                                 void* stream) {
  // a knight direction: one axis steps every time (+-1), the other
  // alternates 0 and +-1
  const bool vert = v0 == v1 && (v0 == 1 || v0 == -1) && h0 == 0 &&
                    (h1 == 1 || h1 == -1);
  const bool horz = h0 == h1 && (h0 == 1 || h0 == -1) && v0 == 0 &&
                    (v1 == 1 || v1 == -1);
  if (bad_region(H, W, D, col0, W_pout) || !(vert || horz) || phase < 0 ||
      phase > 1 || s0 < 0 || N_img < s0 + (vert ? H : W))
    return (int)cudaErrorInvalidValue;
  const int K = (D + 31) / 32;
  float* a = static_cast<float*>(acc);
  const float* ci = static_cast<const float*>(cin);
  float* co = static_cast<float*>(cout);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cv_bf16 ? knight_t<__nv_bfloat16>(K, cv, a, ci, co, H, W, D,
                                                 v0, v1, h0, h1, phase, P1,
                                                 P2, Pout, col0, W_pout, s0,
                                                 N_img, s)
                       : knight_t<float>(K, cv, a, ci, co, H, W, D, v0, v1,
                                         h0, h1, phase, P1, P2, Pout, col0,
                                         W_pout, s0, N_img, s));
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
