// K2, K2k and K3: semi-global matching scans over an (H, W, D) cost volume
// (COST orientation; SCORE volumes arrive negated from box_cv.cu).
//
// K2 `sgm_pass_kernel` replaces the TPU kernel `_dhw_rows_kernel` with its DP
// step `_dw_step` (libstevi_tpu/ops/sgm_pallas_dhw.py:164, :84), launched by
// `_rows_call` (:581).  One launch runs one scan direction, or up to
// MAX_DIRS of them side by side (the grid's second axis picks the
// direction, and direction y uses volume y of acc), and adds each
// direction's adjustment into its f32 accumulator (H, W, D), or writes it
// there (accumulate = 0):
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
// phase of up to 8 directions side by side (the grid's second axis picks
// the direction), one warp a line, each direction into a volume of its
// own: phase 0 has a line at every pixel and writes w * adj there (the
// corner line, enumerated from both edges, is one warp with weight 2),
// phase 1 adds its lines' adj, so volume y ends as p0 + p1 of direction y
// with no zero fill, no atomics and the same bits on every run.  Callers
// add the volumes to the principal sum one after another, acc + (p0 + p1)
// per direction, the JAX XLA path's order (`sgm + pad(knight_adj)`).
// What bounds K2k on an H100: one direction's phase has X + N / 2 lines
// (~880 at 480x640, fewer than the card's 528 schedulers can hide a step's
// chain with) and a step waits on its pixel's loads; in series, 16 launches
// of ~0.36 ms each at 480x640x120 read-modified-wrote one accumulator.  So
// the 8 directions share a launch (~7000 lines, the card full), each line
// stages its pixels S steps ahead through K2's TMA ring (a knight line's
// pixel k steps on is known from its first pixel and parity), and no
// launch re-reads an accumulator (phase 0 writes, phase 1 re-reads only
// where its lines live, about a quarter of the pixels).  At 480x640x120
// f32 the form moves ~3.3 GB (each direction reads cv and writes its
// volume, phase 1 re-reads and rewrites a quarter), ~1 ms at 3.35 TB/s;
// the function's own work (cv read, acc read and written) bounds it at
// 0.132 ms.  This costs 8 f32 volumes of device memory; where they do not
// fit, the caller runs one direction a launch pair into one scratch volume
// (`ops/sgm_cuda.py`, `add_knight_volumes`).

// K2s is K2 and K2k on one shard of a distributed image, the TPU kernel's
// `with_carries` mode (`sgm_rows_shard_pass_dhw` :1013, called at :1078;
// `sgm_cols_shard_pass_dhw` :1088): carries in and out (one D-vector per
// column, or per row for the horizontal-primary knights, which run on
// column shards), the shard's global first scan row and the global extent,
// on which the corner weights and the knight drift parity key.  The
// parity is a run-time integer, so shards of any height give the whole
// image's result; the carries relay exactly, so shard after shard equals
// the whole-image pass bit for bit.
//
// K3 `sgm_wta_kernel` replaces `_dhw_wta_kernel` (sgm_pallas_dhw.py:374,
// launched at :975): the last direction (right to left) fused with
// C = acc + adj + cost, the tie-last argmin (the largest d among equal
// minima), the band C[idx - r .. idx + r] (+inf outside [0, D)) and the
// parabola subpixel with the SAME-mode NaN rules of `truncated_cost_volume`.
// acc may come as n volumes, the other directions' adjustments one a
// volume: K3 sums them in their order, (((a_0 + a_1) + a_2) + ...), which is
// the sum K2 launches accumulating one after another would leave in one
// volume, bit for bit (the adjustments are computed alike and added in the
// same order; only the sign of a zero may differ).  Only the recurrence is
// serial along a row; the rest of a pixel reads its adj and nothing later
// in the row reads it, so K3 splits the two (a scan warp and reduce warps
// a row, below).
//
// Layout and mapping: one warp per scanline (in K3 the row's scan warp;
// its reduce warps use the same lanes for a pixel); lane l owns d = l + 32k
// (k < K = ceil(D / 32), so D = 120 takes 4 values a lane), lanes with
// d >= D hold +inf.  d +- 1 come from two warp shuffles a slice (a rotation
// by one lane each way; lanes 0 and 31 take the neighbouring slice's value),
// min over d is one `redux.sync` on the order-preserving integer image of
// the floats (min is exact, so the value is the shuffle tree's), so the
// carry never leaves registers and the DP runs in f32 whatever the volume's
// type.  Every pixel lies on exactly one line of a principal direction, so a
// K2 launch needs no atomics and is deterministic.  K2 and K2k take the
// image column of the volume's first column (col0) and the image width
// (W_pout) for the Pout test, so a region inside SGM margins runs as a
// volume of its own; K3 takes whole images (with margins the caller runs WTA
// and band itself).  K2 and K2k take any D: past K = 10 register slices
// (D > 320) K2 runs a line a block of warps with D split across them
// (`sgm_pass_group_kernel`, `sgm_pass_buf_kernel`, below) and K2k one warp
// a line with the carry in shared memory (`sgm_knight_smem_kernel`); K3
// takes D <= 320 and sums up to MAX_ACC volumes (SGM-16's 7 principal and
// 8 knight ones).
// The TPU path needed a (W, D, H) transpose of the volume and of the
// accumulator for the horizontal passes; this one reads (H, W, D) for every
// direction.
//
// What bounds K2 on an H100, and what the design does about it.  At
// 480x640x120 the bf16 volume is 73.7 MB and the f32 acc 147 MB, so one
// pass moves ~370 MB (~0.11 ms at 3.35 TB/s).  But a scan has only H, W or
// H + W - 1 lines (480 to 1119 warps for 132 SMs, 528 warp schedulers), and
// each step of a line waits on the one before.
// - Loads.  A step that loads its pixel when it needs it waits an HBM round
//   trip.  So each warp keeps a ring of up to RING stages in shared memory,
//   fed by the Tensor Memory Accelerator: for the pixel S steps ahead, lane
//   0 issues one bulk copy of its cost D-vector and lane 1 one of its acc
//   D-vector (`cp.async.bulk`, completing on the stage's mbarrier), and a
//   step waits only on its own stage.  A pixel's D-vector is contiguous, so
//   a stage is one contiguous read a volume (the 16-byte-aligned cover of
//   the vector: where D * elt % 16 != 0, e.g. D = 300 bf16, it starts
//   mid-chunk and the step reads from the cover's offset).  The depth S
//   shrinks where the launch's lines would not all fit the card's shared
//   memory at once.  Measured on an H100: with TMA feeding the ring the
//   depth stopped mattering, and bf16 runs as fast as f32; per-lane 16-byte
//   `cp.async` copies were slower (the warp stalled issuing them).
// - The step's own chain.  With the loads hidden, a step costs its
//   instruction chain (the redux, the shuffles, the f32 min/add chain and
//   the stores, in order on one warp), and a pass has fewer lines than the
//   card has schedulers, so one direction cannot hide it.  So the WTA path
//   may run its K2 directions in one launch, one adjustment volume each
//   (accumulate = 0), and K3 sums those volumes in direction order as it
//   stages them: the directions' lines together fill the card, and no pass
//   re-reads an accumulator (the bytes moved are the same as in series).
//   This costs one f32 volume a direction of device memory, so the caller
//   takes this form only where the volumes fit (`ops/sgm_cuda.py`).
// The knights (K2k) take the same two measures: their 8 directions share
// a launch, a volume each, and each line stages through the ring.
//
// What bounds K3.  Its form reads the cost volume and the n_acc direction
// volumes once: (1 + n_acc) volumes, 1.11 GB at 480x640x120 bf16 with 7
// (0.33 ms at 3.35 TB/s) and 2.87 GB at 375x1242x192 f32 (0.86 ms).  It
// used to run one warp a row through the whole pixel on every step of the
// row's chain: wait for the pixel's 1 + n_acc copies, sum the acc vectors,
// issue the next copies, the DP step, C, two reductions, the band and the
// parabola, in program order.  That was H warps (480 at VGA, 375 at KITTI;
// under 4 an SM, fewer than an SM has schedulers), so nothing hid a step's
// latency: 1.40 us a step at VGA and 1.63 us at KITTI, 37% and 42% of the
// byte floor (0.896 and 2.024 ms on an H100).  Only the recurrence is
// serial, so now a row is a block: a scan warp runs the DP alone (a step
// is a few hundred cycles, well inside a row's share of the bandwidth),
// and R reduce warps take the row's pixels in turn, each staging its own
// pixels' 1 + n_acc vectors S pixels ahead and waiting on the scan warp
// only for the pixel's adj.  A block's reduce rings are sized
// (`wta_layout`) so the rows an SM holds keep ~100 KB or more of copies in
// flight, far more than the card's bandwidth-latency product needs (~25 KB
// an SM), so the (1 + n_acc) volume reads bound the form.  Where the SMs
// cannot hold all H rows at once, the rows run in waves, one after
// another, each as long as a row's chain, and a row with fewer reduce
// warps than it needs to keep pace with its scan warp (WTA_PACE) runs
// slower; `wta_layout` plans the rows an SM holds that end soonest.  At
// 720x1280x320 bf16 over 7 volumes that is 2 rows an SM with 4 reduce
// warps, 3 waves: 3.5 ms, where 1 row with 8 (6 waves) took 5.9 ms and
// the old form's warp a row 4.0 ms (H100).  The reduce work per pixel is
// unchanged, op for op, so idx, bands and disp keep their bits.
// Left for later PRs: several directions in one sweep (the TPU kernel's
// layout: fewer bytes and no direction volumes; for the knights, both
// phases of a direction in one sweep), and fewer f32 volumes between K2
// and K3.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LINE_WARPS = 2;   // scanlines (warps) per block
constexpr int RING = 8;         // pixels staged ahead of the step
constexpr int REG_K = 10;       // register slices: D <= 320
// directions of one K2 launch: SGM-8's directions but K3's own
constexpr int MAX_DIRS = 7;
// directions of one K2k launch: the knight directions of SGM-16
constexpr int MAX_KNIGHTS = 8;
// acc volumes K3 sums: SGM-16's directions but K3's own
constexpr int MAX_ACC = MAX_DIRS + MAX_KNIGHTS;
// K3's layout (`wta_layout`): the most reduce warps a row, the reduce
// warps a row needs to keep pace with its scan warp (a reduce warp's pixel
// takes about 4 scan steps, measured on an H100), the warps an
// SM plans with (its registers), a scan chunk's bytes of cost vectors and
// the scan ring's chunks
constexpr int WTA_REDUCE = 8;
constexpr int WTA_PACE = 4;
constexpr int WTA_WARPS_SM = 24;
constexpr int WTA_CHUNK = 2048;
constexpr int WTA_CHUNKS = 4;
// K3's barriers: the scan chunks', two an adj slot (A = 2 R), a stage's
constexpr int WTA_BARS = WTA_CHUNKS + 4 * WTA_REDUCE + WTA_REDUCE * RING;
static_assert(1 + WTA_REDUCE <= WTA_WARPS_SM / 2, "K3's launch bounds");
constexpr unsigned FULL = 0xffffffffu;

// The directions of one K2 launch, (di, dj) each; blockIdx.y picks one.
struct Dirs {
  int di[MAX_DIRS], dj[MAX_DIRS];
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// min over the warp, exact: the order-preserving integer image of a float
// (negative values with their magnitude bits flipped) reduced by one
// redux.sync.  NaN counts as +inf, as fminf treats it beside a number.
__device__ __forceinline__ float warp_min(float x) {
  int i = __float_as_int(isnan(x) ? INFINITY : x);
  i ^= (i >> 31) & 0x7fffffff;
  i = __reduce_min_sync(FULL, i);
  i ^= (i >> 31) & 0x7fffffff;
  return __int_as_float(i);
}

__device__ __forceinline__ int warp_max(int x) {
  return __reduce_max_sync(FULL, x);
}

// One step of the cost-mode recurrence (correlation/sgm.h:230-300; the JAX
// `_line_recurrence`, op for op) for the K slices a lane owns.  j is the
// image column of the pixel and W the image width, for the Pout test.
template <int K>
__device__ __forceinline__ void dp_step(const float (&prev)[K], float (&adj)[K],
                                        int lane, int j, int W, float P1,
                                        float P2, float Pout) {
  float p[K], ru[K], rd[K];
  float lm = INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    p[k] = isfinite(prev[k]) ? prev[k] : INFINITY;
    lm = fminf(lm, p[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {  // lane - 1's and lane + 1's value, cyclic
    ru[k] = __shfl_sync(FULL, p[k], (lane + 31) & 31);
    rd[k] = __shfl_sync(FULL, p[k], (lane + 1) & 31);
  }
  const float m = warp_min(lm);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // prev[d - 1]: lane 0 takes lane 31's value of the slice below
    const float up =
        lane > 0 ? ru[k] : (k > 0 ? ru[k > 0 ? k - 1 : 0] : INFINITY);
    // prev[d + 1]: lane 31 takes lane 0's value of the slice above
    const float dn =
        lane < 31 ? rd[k] : (k + 1 < K ? rd[k + 1 < K ? k + 1 : k] : INFINITY);
    float agg = fminf(fminf(p[k], m + P2), fminf(up + P1, dn + P1));
    if (j + lane + 32 * k >= W) agg += Pout;  // disparity leaves the image
    adj[k] = (isfinite(agg) && isfinite(m)) ? agg - m : 0.f;
  }
}

__device__ __forceinline__ float finite_or_inf(float x) {
  return isfinite(x) ? x : INFINITY;
}

// ---------------------------------------------------------------------------
// The staging ring of K2 and K3
// ---------------------------------------------------------------------------
// A stage holds one pixel: the 16-byte-aligned cover of its cost D-vector
// (cb bytes), then that of each staged acc D-vector (ab bytes each).  A
// vector starts at its address's offset inside the first 16-byte chunk.
// The cover never leaves the memory pages the vector lies on, so reading it
// cannot fault.  One lane a vector issues a stage's bulk copies; each stage
// has an mbarrier that completes when their bytes have landed, once per
// use, so a stage's k-th use waits on parity k & 1.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one arrival of the calling thread (release: its earlier shared-memory
// writes and reads are ordered before the phase completes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ const char* down16(const void* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) &
                                       ~static_cast<uintptr_t>(15));
}

// where a vector that starts at global address g sits in its stage slot
template <typename V>
__device__ __forceinline__ const V* staged(const unsigned char* slot,
                                           const V* g) {
  return reinterpret_cast<const V*>(
      slot + (reinterpret_cast<uintptr_t>(g) & 15));
}

// the bytes of the 16-byte-aligned cover of n elements at g
template <typename V>
__device__ __forceinline__ unsigned cover(const V* g, int n) {
  return static_cast<unsigned>(
      (reinterpret_cast<const char*>(g + n) - down16(g) + 15) & ~15);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(down16(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Stage pixel `pix` (element offset pix * D) into `st`: lane 0 copies the
// cost vector, lane q (1 <= q <= n) that of acc volume q - 1 (acc_stride
// floats apart), each arriving on the stage's barrier with its bytes, so
// the n + 1 copies issue side by side.  Lanes past n do nothing.
// A vector is D elements, or its first cnt where cnt >= 0 (a slice: the
// any-D K2 stages each warp's part of D, from cv and acc offset to it).
template <typename T>
__device__ __forceinline__ void stage_pixel(unsigned char* st, int cb, int ab,
                                            const T* cv, const float* acc,
                                            int n, long long acc_stride,
                                            long long pix, int D,
                                            uint64_t* bar, int lane,
                                            int cnt = -1) {
  if (lane > n) return;
  const int len = cnt < 0 ? D : cnt;
  const void* src;
  unsigned char* dst;
  unsigned bytes;
  if (lane == 0) {
    const T* c = cv + pix * D;
    src = c;
    dst = st;
    bytes = cover(c, len);
  } else {
    const float* a = acc + (lane - 1) * acc_stride + pix * D;
    src = a;
    dst = st + cb + (lane - 1) * ab;
    bytes = cover(a, len);
  }
  // the stage was read by the warp's generic loads: order them before the
  // async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  bulk_copy(dst, src, bytes, bar);
}

// The warp: lane 0 initialises the S stage barriers (n + 1 arrivals a
// phase), then lanes 0..n stage the first min(S, len) pixels of the line
// (pix_at(0), pix_at(1), ...).  Ends with the warp converged.
template <typename T, typename PixAt>
__device__ __forceinline__ void ring_start(unsigned char* ring, uint64_t* bar,
                                           int S, int stage, int cb, int ab,
                                           const T* cv, const float* acc,
                                           int n, long long acc_stride,
                                           PixAt pix_at, int len, int D,
                                           int lane, int cnt = -1) {
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bar[s], n + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int s = 0; s < S && s < len; ++s)
    stage_pixel(ring + s * stage, cb, ab, cv, acc, n, acc_stride, pix_at(s),
                D, &bar[s], lane, cnt);
  __syncwarp();
}

// The line one warp of a K2 launch walks.
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
struct PassLine {
  int si, sj, len;
  float w;           // 2 on the corner line
  const float* src;  // the carry the line starts from (null: zero)
  bool ok;
};

__device__ __forceinline__ PassLine pass_line(int line, int H, int W, int D,
                                              int di, int dj,
                                              const float* cin, int i0,
                                              int H_img) {
  PassLine L;
  L.w = 1.f;
  L.src = nullptr;
  L.ok = true;
  if (di == 0) {  // horizontal: one line per row
    L.ok = line < H;
    L.si = line;
    L.sj = dj > 0 ? 0 : W - 1;
    L.len = W;
    return L;
  }
  // W lines cross the shard's first scan row; a diagonal direction adds
  // H - 1 lines that start at the side edge of the shard's other rows
  const int ir = di > 0 ? 0 : H - 1, je = dj > 0 ? 0 : W - 1;
  if (line < W) {
    L.si = ir;
    L.sj = line;
    const int pc = L.sj - dj;
    if (cin != nullptr && pc >= 0 && pc < W) L.src = cin + (size_t)pc * D;
    // the corner line, enumerated from both edges: it passes global row
    // ig at column je + dj * (steps from the global start row)
    const int ig = i0 + ir;
    if (dj != 0 && L.sj == je + dj * (di > 0 ? ig : H_img - 1 - ig)) L.w = 2.f;
  } else {
    if (dj == 0 || line >= W + H - 1) {
      L.ok = false;
      return L;
    }
    const int t = line - W + 1;
    L.si = di > 0 ? t : H - 1 - t;
    L.sj = je;
  }
  L.len = dj == 0 ? H
                  : min(di > 0 ? H - L.si : L.si + 1,
                        dj > 0 ? W - L.sj : L.sj + 1);
  return L;
}

// K2: the scan direction (di, dj) in {-1, 0, 1}^2 \ {(0, 0)} that blockIdx.y
// picks, into volume blockIdx.y of acc; D <= 32 K, the carry in registers.
// Each warp's ring is S stages of `stage` bytes at smem + warp * S * stage;
// its barriers are static.
template <int K, typename T>
__global__ void __launch_bounds__(32 * LINE_WARPS)
sgm_pass_kernel(const T* __restrict__ cv, float* __restrict__ acc,
                const float* __restrict__ cin, float* __restrict__ cout,
                int H, int W, int D, Dirs dirs, float P1, float P2,
                float Pout, int accumulate, int col0, int W_pout, int i0,
                int H_img, int S, int cb, int stage) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  __shared__ __align__(8) uint64_t bars[LINE_WARPS][RING];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int line = blockIdx.x * (blockDim.x >> 5) + wid;
  const int di = dirs.di[blockIdx.y], dj = dirs.dj[blockIdx.y];
  acc += (size_t)blockIdx.y * H * W * D;
  const PassLine L = pass_line(line, H, W, D, di, dj, cin, i0, H_img);
  if (!L.ok) return;
  unsigned char* ring = pass_smem + (size_t)wid * S * stage;
  uint64_t* bar = bars[wid];
  const int n_acc = accumulate ? 1 : 0, ab = stage - cb;
  const long long step = (long long)di * W + dj;
  long long pix = (long long)L.si * W + L.sj;
  ring_start(ring, bar, S, stage, cb, ab, cv, acc, n_acc, 0,
             [=](int s) { return pix + s * step; }, L.len, D, lane);
  const int i_last = di > 0 ? H - 1 : 0;  // the shard's last scan row
  const float w = L.w;

  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    carry[k] = d < D ? (L.src ? L.src[d] : 0.f) : INFINITY;
  }
  int i = L.si, j = L.sj, slot = 0;
  for (int t = 0; t < L.len; ++t) {
    mbar_wait(&bar[slot], (unsigned)(t / S) & 1u);  // this pixel's stage
    unsigned char* st = ring + slot * stage;
    const T* cs = staged(st, cv + pix * D);
    const float* as = staged(st + cb, acc + pix * D);
    float b[K], a[K], adj[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      b[k] = d < D ? load(cs + d) : INFINITY;
      a[k] = (accumulate && d < D) ? as[d] : 0.f;
    }
    __syncwarp();  // the stage is read: refill it with the pixel S ahead
    if (t + S < L.len)
      stage_pixel(st, cb, ab, cv, acc, n_acc, 0, pix + S * step, D,
                  &bar[slot], lane);
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
    slot = slot + 1 == S ? 0 : slot + 1;
  }
}

// K2 for any D (D > 320; `sgm_pass_kernel` keeps ceil(D / 32) <= 10
// slices of a line's carry in one warp's registers).  What held the
// earlier any-D form back: one warp a line looped over every 32-wide
// d-slice twice a step (the min, then the DP), through shared memory, so a
// step cost ceil(D / 32) dependent rounds (~2.2 us at D = 330), and the
// relay shapes' few lines left the card nearly empty.  Here a line is one
// block of G warps with D split across them (K4b's column scans,
// csrc/sgm_lane.cu, are the precedent), in one of three instances that
// `pass_layout` picks from D alone (ops/sgm_cuda.pass_layout is its
// Python twin: change both together):
// - registers (`sgm_pass_group_kernel<K>`, D <= GROUP_MAX_D): warp g owns
//   d = 32 K g + lane + 32 k (k < K; K = 4 up to D = 1024, G <= 8, then
//   K = 8, G <= 32: 1024 threads leave 64 registers a thread).  d +- 1
//   come from two shuffles a slice, and at the warp's two ends from the
//   neighbour warps' edge values; the min over d is each warp's
//   `warp_min` of its new carry, and the G minima and the 2 G edge values
//   go to shared memory, double-buffered by step parity, so a step has
//   ONE block barrier (a warp may write buffer b only at step t + 1,
//   after every warp has passed step t's barrier, i.e. read buffer b).
//   Each warp stages its own part of the pixel's cost vector (and of acc
//   where the pass accumulates) S pixels ahead through K2's TMA ring, so
//   the step never waits on device memory.
// - shared (`sgm_pass_buf_kernel<T, false>`, D <= BUF_MAX_D): 32 warps, a
//   run of 32-wide slices each; the two carries (the previous and the
//   current step) in shared memory, d +- 1 read from them, the parts'
//   minima double-buffered beside them: again one barrier a step.  Cost
//   and acc are loaded directly (a pixel's 8 D bytes would leave no room
//   for a ring), U slices' loads issued before any of them is used.
// - device (`sgm_pass_buf_kernel<T, true>`, past BUF_MAX_D): the same with
//   the two carries in a global area of the line's own, line `line` of
//   direction y at (y * (H + W) + line) * r16(8 D) (a direction has fewer
//   than H + W lines); the block barrier orders those accesses as it
//   orders shared memory.
// One line a block: G >= 3 warps already lets 21 blocks fill an SM's 64
// warp slots (32 blocks at most), and packing lines into a block would
// crowd a relay shape's few lines (12 for a 12x64 shard passed left to
// right) onto fewer SMs.  Every instance keeps `dp_step`'s operations in
// their order (the isfinite guards included), the corner line's weight,
// the carries in and out, i0 / H_img, col0 / W_pout and a volume per
// direction from blockIdx.y, so K2s equals its plain version bit for bit.
// What bounds a pass: it reads cv and acc and writes acc (12 D bytes a
// pixel in f32), so a 540x3840x384 shard pass moves 9.55 GB, 2.85 ms at
// 3.35 TB/s; the registers instance's step chain (shuffles, a redux, one
// barrier) is ~0.2 us, so lines of 3840 steps stay under that floor.
constexpr int MAX_GROUP = 32;       // warps a line
constexpr int GROUP_K4_MAX_D = 1024;  // registers, K = 4 (G <= 8)
constexpr int GROUP_MAX_D = 8192;     // registers, K = 8 (G <= 32)
// the shared instance's two carries within PASS_SMEM bytes
constexpr int PASS_SMEM = 232448 - 4096;  // less the static arrays
constexpr int BUF_MAX_D = PASS_SMEM / 8;
constexpr int BUF_U = 8;            // slices a lane loads before it computes

template <int K, typename T>
__global__ void __launch_bounds__(K == 4 ? 256 : 1024)
sgm_pass_group_kernel(const T* __restrict__ cv, float* __restrict__ acc,
                      const float* __restrict__ cin,
                      float* __restrict__ cout, int H, int W, int D,
                      Dirs dirs, float P1, float P2, float Pout,
                      int accumulate, int col0, int W_pout, int i0,
                      int H_img, int S, int cb, int stage) {
  extern __shared__ __align__(16) unsigned char group_smem[];
  __shared__ __align__(8) uint64_t gbars[MAX_GROUP][RING];
  __shared__ float gmins[2][MAX_GROUP];
  __shared__ float gedges[2][MAX_GROUP][2];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int G = blockDim.x >> 5;
  const int di = dirs.di[blockIdx.y], dj = dirs.dj[blockIdx.y];
  acc += (size_t)blockIdx.y * H * W * D;
  const PassLine L = pass_line(blockIdx.x, H, W, D, di, dj, cin, i0, H_img);
  if (!L.ok) return;  // the whole block: one line
  const int d_lo = 32 * K * g;
  const int cnt = min(D - d_lo, 32 * K);  // this warp's part (>= 1)
  const T* cvp = cv + d_lo;               // pixel p's part: cvp + p * D
  float* accp = acc + d_lo;
  unsigned char* ring = group_smem + (size_t)g * S * stage;
  uint64_t* bar = gbars[g];
  const int n_acc = accumulate ? 1 : 0, ab = stage - cb;
  const long long step = (long long)di * W + dj;
  long long pix = (long long)L.si * W + L.sj;
  ring_start(ring, bar, S, stage, cb, ab, cvp, accp, n_acc, 0,
             [=](int s) { return pix + s * step; }, L.len, D, lane, cnt);
  const int i_last = di > 0 ? H - 1 : 0;  // the shard's last scan row
  const float w = L.w;

  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d_lo + lane + 32 * k;
    carry[k] = d < D ? (L.src ? L.src[d] : 0.f) : INFINITY;
  }
  // this warp's minimum of the carry and its two end values, into buffer b
  auto publish = [&](int b) {
    float lm = INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) lm = fminf(lm, finite_or_inf(carry[k]));
    lm = warp_min(lm);
    if (lane == 0) {
      gmins[b][g] = lm;
      gedges[b][g][0] = finite_or_inf(carry[0]);
    }
    if (lane == 31) gedges[b][g][1] = finite_or_inf(carry[K - 1]);
  };
  publish(0);
  __syncthreads();
  int i = L.si, j = L.sj, slot = 0;
  for (int t = 0; t < L.len; ++t) {
    const int b = t & 1;
    const float m = warp_min(lane < G ? gmins[b][lane] : INFINITY);
    const float e_lo = g > 0 ? gedges[b][g - 1][1] : INFINITY;  // d_lo - 1
    const float e_hi = g + 1 < G ? gedges[b][g + 1][0] : INFINITY;
    mbar_wait(&bar[slot], (unsigned)(t / S) & 1u);  // this pixel's stage
    unsigned char* st = ring + slot * stage;
    const T* cs = staged(st, cvp + pix * D);
    const float* as = staged(st + cb, accp + pix * D);
    float bv[K], av[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int dl = lane + 32 * k;
      bv[k] = dl < cnt ? load(cs + dl) : INFINITY;
      av[k] = (accumulate && dl < cnt) ? as[dl] : 0.f;
    }
    __syncwarp();  // the stage is read: refill it with the pixel S ahead
    if (t + S < L.len)
      stage_pixel(st, cb, ab, cvp, accp, n_acc, 0, pix + S * step, D,
                  &bar[slot], lane, cnt);
    // `dp_step`, with the neighbour warps' ends at this warp's ends
    float p[K], ru[K], rd[K];
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = finite_or_inf(carry[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) {  // lane - 1's and lane + 1's value, cyclic
      ru[k] = __shfl_sync(FULL, p[k], (lane + 31) & 31);
      rd[k] = __shfl_sync(FULL, p[k], (lane + 1) & 31);
    }
    const bool out = cout != nullptr && di != 0 && i == i_last;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d_lo + lane + 32 * k;
      // prev[d - 1]: lane 0 takes lane 31's value of the slice below
      const float up =
          lane > 0 ? ru[k] : (k > 0 ? ru[k > 0 ? k - 1 : 0] : e_lo);
      // prev[d + 1]: lane 31 takes lane 0's value of the slice above
      const float dn =
          lane < 31 ? rd[k] : (k + 1 < K ? rd[k + 1 < K ? k + 1 : k] : e_hi);
      float agg = fminf(fminf(p[k], m + P2), fminf(up + P1, dn + P1));
      if (col0 + j + d >= W_pout) agg += Pout;  // disparity leaves the image
      const float adj = (isfinite(agg) && isfinite(m)) ? agg - m : 0.f;
      if (d < D) {
        carry[k] = bv[k] + adj;
        acc[pix * D + d] = av[k] + w * adj;
        if (out) cout[(size_t)j * D + d] = carry[k];
      }
    }
    publish(b ^ 1);
    __syncthreads();  // the minima and ends of this step whole
    pix += step;
    i += di;
    j += dj;
    slot = slot + 1 == S ? 0 : slot + 1;
  }
}

// The shared and device instances (see above): 32 warps a line, each a
// run of 32-wide slices [d_lo, d_hi) of D; the two carries in shared
// memory, or with SPILL in the line's global area.
template <typename T, bool SPILL>
__global__ void __launch_bounds__(32 * MAX_GROUP)
sgm_pass_buf_kernel(const T* __restrict__ cv, float* __restrict__ acc,
                    const float* __restrict__ cin, float* __restrict__ cout,
                    unsigned char* spill, int H, int W, int D, Dirs dirs,
                    float P1, float P2, float Pout, int accumulate, int col0,
                    int W_pout, int i0, int H_img) {
  extern __shared__ __align__(16) unsigned char buf_smem[];
  __shared__ float bmins[2][MAX_GROUP];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int G = blockDim.x >> 5;
  const int line = blockIdx.x;
  const int di = dirs.di[blockIdx.y], dj = dirs.dj[blockIdx.y];
  acc += (size_t)blockIdx.y * H * W * D;
  const PassLine L = pass_line(line, H, W, D, di, dj, cin, i0, H_img);
  if (!L.ok) return;
  const size_t carry_bytes = (2 * sizeof(float) * D + 15) & ~(size_t)15;
  float* bufs = reinterpret_cast<float*>(
      SPILL ? spill + ((size_t)blockIdx.y * (H + W) + line) * carry_bytes
            : buf_smem);
  const int SP = ((D + 31) / 32 + G - 1) / G;  // 32-wide slices a warp
  const int d_lo = g * SP * 32, d_hi = min(D, d_lo + SP * 32);
  float lm = INFINITY;
  for (int d = d_lo + lane; d < d_hi; d += 32) {
    const float v = L.src ? L.src[d] : 0.f;
    bufs[d] = v;
    lm = fminf(lm, finite_or_inf(v));
  }
  lm = warp_min(lm);
  if (lane == 0) bmins[0][g] = lm;
  __syncthreads();
  const long long step = (long long)di * W + dj;
  long long pix = (long long)L.si * W + L.sj;
  const int i_last = di > 0 ? H - 1 : 0;
  const float w = L.w;
  int i = L.si, j = L.sj;
  for (int t = 0; t < L.len; ++t) {
    const int b = t & 1;
    const float* prev = bufs + b * D;
    float* next = bufs + (b ^ 1) * D;
    const float m = warp_min(lane < G ? bmins[b][lane] : INFINITY);
    const T* cs = cv + pix * D;
    float* as = acc + pix * D;
    float* co = (cout != nullptr && di != 0 && i == i_last)
                    ? cout + (size_t)j * D
                    : nullptr;
    lm = INFINITY;
    for (int d0 = d_lo + lane; d0 < d_hi; d0 += 32 * BUF_U) {
      float bs[BUF_U], ac[BUF_U];  // issue U slices' loads before any use
#pragma unroll
      for (int u = 0; u < BUF_U; ++u) {
        const int d = d0 + 32 * u;
        bs[u] = d < d_hi ? load(cs + d) : 0.f;
        ac[u] = (accumulate && d < d_hi) ? as[d] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BUF_U; ++u) {
        const int d = d0 + 32 * u;
        if (d >= d_hi) break;
        const float p = finite_or_inf(prev[d]);
        const float up = d > 0 ? finite_or_inf(prev[d - 1]) : INFINITY;
        const float dn = d + 1 < D ? finite_or_inf(prev[d + 1]) : INFINITY;
        float agg = fminf(fminf(p, m + P2), fminf(up + P1, dn + P1));
        if (col0 + j + d >= W_pout) agg += Pout;  // disparity leaves the image
        const float adj = (isfinite(agg) && isfinite(m)) ? agg - m : 0.f;
        const float nc = bs[u] + adj;
        next[d] = nc;
        as[d] = ac[u] + w * adj;
        if (co) co[d] = nc;
        lm = fminf(lm, finite_or_inf(nc));
      }
    }
    lm = warp_min(lm);
    if (lane == 0) bmins[b ^ 1][g] = lm;
    __syncthreads();  // `next` and its parts' minima whole
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
// drift lets one more in).  Phase 0 thus has a line at every pixel of the
// block: the side seed at u = 0 fills the position each drift leaves.  A
// crossing line starts from cin at the lateral position it left (null, or
// off the block: a zero carry); the corner line (phase 0, u == t / 2) has
// weight 2.  A whole image is the block s0 = 0, N_img = N with no carries,
// which gives `addDirectionalCost`'s enumeration: the start-edge seeds,
// then the side seeds by offset.
//
// The line's pixels are known up front: step c of the line takes
// steps[c % 2], and the second step is the one that drifts, so after k
// steps from a first step of parity c the line has drifted
// ((c + k) >> 1) times and taken steps[0] the other times.  It ends where
// either coordinate leaves the block: after its primary extent, or after
// 2 * room + 2 - c pixels, room being the drifts left before the far side.
struct KnightLine {
  int i, j;   // first pixel
  int c;      // parity of the first step's index along the line
  int len;    // pixels on the line inside the block
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
  const int room = drift > 0 ? X - 1 - x : x;
  L.len = min(pstep > 0 ? N - p : p + 1, 2 * room + 2 - L.c);
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

// pixel k of the line (k steps from its first pixel)
__device__ __forceinline__ long long knight_pix(const KnightLine& L, int k,
                                                int W, int v0, int v1,
                                                int h0, int h1) {
  const int odd = (L.c + k) >> 1, even = k - odd;
  return (long long)(L.i + v0 * even + v1 * odd) * W +
         (L.j + h0 * even + h1 * odd);
}

// The knight directions of one K2k launch, steps (v0, h0) and (v1, h1),
// and the global extent along the primary axis; blockIdx.y picks one.
struct KDirs {
  int v0[MAX_KNIGHTS], v1[MAX_KNIGHTS], h0[MAX_KNIGHTS], h1[MAX_KNIGHTS];
  int n_img[MAX_KNIGHTS];
};

// K2k: one seed phase of the knight direction that blockIdx.y picks, into
// volume blockIdx.y of vol; D <= 32 K, the carry in registers.  Phase 0
// writes w * adj (it has a line at every pixel, so it writes every entry of
// the volume), phase 1 adds its lines' adj to what phase 0 left: the volume
// ends as p0 + p1, one direction's adjustment.  Inside a launch the lines
// of one direction are disjoint (the corner line is one line of weight 2),
// and each direction has a volume of its own: no atomics, the same bits on
// every run.  Each warp stages its line's pixels S ahead in a ring, as K2
// does (phase 0 stages the cost vector, phase 1 also the volume's vector
// that phase 0 wrote).  With carries (K2s, one direction) the block is
// scan rows [s0, s0 + N) of n_img and cin / cout hold one D-vector per
// lateral position (`knight_line`).  Vertical-primary directions seed at
// every column of the top or bottom row and at every row of one side
// column; horizontal-primary ones the other way round.
template <int K, typename T>
__global__ void __launch_bounds__(32 * LINE_WARPS)
sgm_knight_kernel(const T* __restrict__ cv, float* __restrict__ vol,
                  const float* __restrict__ cin, float* __restrict__ cout,
                  int H, int W, int D, KDirs dirs, int phase, float P1,
                  float P2, float Pout, int col0, int W_pout, int s0, int S,
                  int cb, int stage) {
  extern __shared__ __align__(16) unsigned char knight_smem[];
  __shared__ __align__(8) uint64_t bars_k[LINE_WARPS][RING];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int line = blockIdx.x * (blockDim.x >> 5) + wid;
  const int y = blockIdx.y;
  const int v0 = dirs.v0[y], v1 = dirs.v1[y], h0 = dirs.h0[y],
            h1 = dirs.h1[y];
  vol += (size_t)y * H * W * D;
  const KnightLine L =
      knight_line(line, H, W, v0, v1, h0, h1, phase, s0, dirs.n_img[y]);
  if (!L.ok) return;
  unsigned char* ring = knight_smem + (size_t)wid * S * stage;
  uint64_t* bar = bars_k[wid];
  const int ab = stage - cb;
  ring_start(ring, bar, S, stage, cb, ab, cv, vol, phase, 0,
             [=](int k) { return knight_pix(L, k, W, v0, v1, h0, h1); },
             L.len, D, lane);
  const bool vert = v0 == v1;
  const int last = vert ? (v0 > 0 ? H - 1 : 0) : (h0 > 0 ? W - 1 : 0);
  const float w = L.w;
  const float* src =
      (cin != nullptr && L.src >= 0) ? cin + (size_t)L.src * D : nullptr;

  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    carry[k] = d < D ? (src ? src[d] : 0.f) : INFINITY;
  }
  int i = L.i, j = L.j, slot = 0;
  long long pix = (long long)i * W + j;
  for (int t = 0; t < L.len; ++t) {
    mbar_wait(&bar[slot], (unsigned)(t / S) & 1u);  // this pixel's stage
    unsigned char* st = ring + slot * stage;
    const T* cs = staged(st, cv + pix * D);
    const float* vs = staged(st + cb, vol + pix * D);
    float b[K], a[K], adj[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      b[k] = d < D ? load(cs + d) : INFINITY;
      a[k] = (phase && d < D) ? vs[d] : 0.f;
    }
    __syncwarp();  // the stage is read: refill it with the pixel S ahead
    if (t + S < L.len)
      stage_pixel(st, cb, ab, cv, vol, phase, 0,
                  knight_pix(L, t + S, W, v0, v1, h0, h1), D, &bar[slot],
                  lane);
    dp_step<K>(carry, adj, lane, col0 + j, W_pout, P1, P2, Pout);
    float* co = nullptr;
    if (cout != nullptr && (vert ? i : j) == last)
      co = cout + (size_t)(vert ? j : i) * D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        carry[k] = b[k] + adj[k];
        vol[pix * D + d] = phase ? a[k] + adj[k] : w * adj[k];
        if (co) co[d] = carry[k];
      }
    }
    const bool drift = (L.c + t) & 1;  // this step's index is odd
    i += drift ? v1 : v0;
    j += drift ? h1 : h0;
    pix = (long long)i * W + j;
    slot = slot + 1 == S ? 0 : slot + 1;
  }
}

// K2k for any D: `sgm_knight_kernel` with the carry in shared memory in
// place of registers (K = ceil(D / 32) > 10 would not fit them).  Each warp
// keeps two D-float carries after its ring (the previous and the current
// step, swapped every step); lanes loop over 32-wide d-slices, the min
// over d is a loop plus the warp reduction and d +- 1 are shared-memory
// reads.  The lines, the ring, the DP step
// (`dp_step`'s operations in its order, the isfinite guards included) and
// the volume writes are `sgm_knight_kernel`'s.  Where not even a ring of
// two stages and the carries fit a block (`ring_layout`; f32 volumes past
// D = 9640) the launcher passes `spill`: the line loads its pixels
// directly (S = 0) and keeps its two carries in a global area of its own,
// line `line` of direction y at (y * (H + W) + line) * carry_bytes (a
// direction has fewer than H + W lines); __syncwarp orders them as it
// does shared memory.  SPILL is a template argument, so that the shared
// instance keeps shared-memory instructions.
template <typename T, bool SPILL>
__global__ void __launch_bounds__(32 * LINE_WARPS)
sgm_knight_smem_kernel(const T* __restrict__ cv, float* __restrict__ vol,
                       const float* __restrict__ cin,
                       float* __restrict__ cout,
                       unsigned char* spill, int H, int W,
                       int D, KDirs dirs, int phase, float P1, float P2,
                       float Pout, int col0, int W_pout, int s0, int S,
                       int cb, int stage) {
  extern __shared__ __align__(16) unsigned char knight_smem_d[];
  __shared__ __align__(8) uint64_t bars_kd[LINE_WARPS][RING];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int line = blockIdx.x * (blockDim.x >> 5) + wid;
  const int y = blockIdx.y;
  const int v0 = dirs.v0[y], v1 = dirs.v1[y], h0 = dirs.h0[y],
            h1 = dirs.h1[y];
  vol += (size_t)y * H * W * D;
  const KnightLine L =
      knight_line(line, H, W, v0, v1, h0, h1, phase, s0, dirs.n_img[y]);
  if (!L.ok) return;
  // each warp's area stays 16-byte aligned: the carries are rounded up
  const size_t carry_bytes = (2 * sizeof(float) * D + 15) & ~(size_t)15;
  unsigned char* ring =
      knight_smem_d +
      (size_t)wid * ((size_t)S * stage + (SPILL ? 0 : carry_bytes));
  float* bufs = reinterpret_cast<float*>(
      SPILL ? spill + ((size_t)y * (H + W) + line) * carry_bytes
            : ring + (size_t)S * stage);
  uint64_t* bar = bars_kd[wid];
  const int ab = stage - cb;
  if (S > 0)
    ring_start(ring, bar, S, stage, cb, ab, cv, vol, phase, 0,
               [=](int k) { return knight_pix(L, k, W, v0, v1, h0, h1); },
               L.len, D, lane);
  const bool vert = v0 == v1;
  const int last = vert ? (v0 > 0 ? H - 1 : 0) : (h0 > 0 ? W - 1 : 0);
  const float w = L.w;
  const float* src =
      (cin != nullptr && L.src >= 0) ? cin + (size_t)L.src * D : nullptr;
  for (int d = lane; d < D; d += 32) bufs[d] = src ? src[d] : 0.f;
  int i = L.i, j = L.j, slot = 0, cur = 0;
  long long pix = (long long)i * W + j;
  for (int t = 0; t < L.len; ++t) {
    __syncwarp();  // the carry written at the last step
    unsigned char* st = ring + slot * stage;
    const T* cs = cv + pix * D;
    const float* vs = vol + pix * D;
    if (S > 0) {
      mbar_wait(&bar[slot], (unsigned)(t / S) & 1u);
      cs = staged(st, cs);
      vs = staged(st + cb, vs);
    }
    const float* prev = bufs + cur * D;
    float* next = bufs + (cur ^ 1) * D;
    float lm = INFINITY;
    for (int d = lane; d < D; d += 32) lm = fminf(lm, finite_or_inf(prev[d]));
    const float m = warp_min(lm);
    float* co = (cout != nullptr && (vert ? i : j) == last)
                    ? cout + (size_t)(vert ? j : i) * D
                    : nullptr;
    for (int d = lane; d < D; d += 32) {
      const float p = finite_or_inf(prev[d]);
      const float up = d > 0 ? finite_or_inf(prev[d - 1]) : INFINITY;
      const float dn = d + 1 < D ? finite_or_inf(prev[d + 1]) : INFINITY;
      float agg = fminf(fminf(p, m + P2), fminf(up + P1, dn + P1));
      if (col0 + j + d >= W_pout) agg += Pout;  // disparity leaves the image
      const float adj = (isfinite(agg) && isfinite(m)) ? agg - m : 0.f;
      const float nc = load(cs + d) + adj;
      next[d] = nc;
      vol[pix * D + d] = phase ? vs[d] + adj : w * adj;
      if (co) co[d] = nc;
    }
    __syncwarp();  // the stage is read and `next` complete
    if (S > 0 && t + S < L.len)
      stage_pixel(st, cb, ab, cv, vol, phase, 0,
                  knight_pix(L, t + S, W, v0, v1, h0, h1), D, &bar[slot],
                  lane);
    const bool drift = (L.c + t) & 1;
    i += drift ? v1 : v0;
    j += drift ? h1 : h0;
    pix = (long long)i * W + j;
    slot = slot + 1 >= S ? 0 : slot + 1;
    cur ^= 1;
  }
}

// How a K3 launch lays out a row's block (`wta_layout`): R reduce warps,
// each with S stages of `stage` bytes (the cost cover, cb bytes, then
// n_acc acc covers of ab bytes) and 32 K floats of C; the scan warp's SC
// chunks of P pixels' cost vectors (pb bytes each); A adj slots of 32 K
// floats.  smem is the dynamic shared memory a block, rows the rows an SM
// is planned to hold at once.
struct WtaLayout {
  int R, S, cb, ab, stage, P, pb, SC, A;
  int smem, rows;
};

// K3: the right-to-left direction fused with WTA, band and subpixel, one
// image row a block of 1 + R warps (`WtaLayout`; D <= 32 K).  Warp 0 scans:
// it stages the row's cost vectors P pixels a bulk copy (a row's vectors
// are contiguous), runs `dp_step` and carry = cost + adj, and leaves each
// pixel's adj in slot t % A of the block's adj ring (t the scan step, from
// the right), whose `full` barrier its 32 lanes arrive on.  Reduce warp q
// (warps 1..R) takes steps q, q + R, q + 2 R, ...: it stages each pixel's
// cost and n_acc acc vectors S of its pixels ahead (`stage_pixel`), sums
// the acc vectors in their order, waits for the pixel's adj slot, reads
// it and releases it (`empty`), then forms C and writes idx, the band and
// disp from its own 32 K floats of C.  disp may be null (no subpixel).
// The launch bounds hold a thread to 80 registers, so any WTA_WARPS_SM
// warps fit an SM's registers, as `wta_layout` plans (the K = 10
// instances would take 96, and an SM would hold 5 of 6 planned rows).
template <int K, typename T>
__global__ void __launch_bounds__(32 * WTA_WARPS_SM / 2, 2)
sgm_wta_kernel(const T* __restrict__ cv, const float* __restrict__ acc,
               int n_acc, int* __restrict__ idx_out,
               float* __restrict__ bands, float* __restrict__ disp, int H,
               int W, int D, float P1, float P2, float Pout, int r, int hr,
               int vr, WtaLayout ly) {
  extern __shared__ __align__(16) unsigned char wta_smem[];
  __shared__ __align__(8) uint64_t wta_bars[WTA_BARS];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int i = blockIdx.x;  // the image row
  uint64_t* chunk_bar = wta_bars;        // SC: a scan chunk landed
  uint64_t* full = chunk_bar + ly.SC;    // A: an adj slot written
  uint64_t* empty = full + ly.A;         // A: an adj slot read
  uint64_t* stage_bar = empty + ly.A;    // R x S: a reduce stage landed
  unsigned char* chunks = wta_smem;
  float* adj_ring = reinterpret_cast<float*>(chunks + (size_t)ly.SC * ly.pb);
  unsigned char* reduce_area =
      reinterpret_cast<unsigned char*>(adj_ring) + (size_t)ly.A * 128 * K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ly.SC; ++s) mbar_init(&chunk_bar[s], 1);
    for (int a = 0; a < ly.A; ++a) {
      mbar_init(&full[a], 32);
      mbar_init(&empty[a], 32);
    }
    for (int s = 0; s < ly.R * ly.S; ++s) mbar_init(&stage_bar[s], n_acc + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long row = (long long)i * W;

  if (wid == 0) {  // the scan warp: the right-to-left recurrence alone
    const T* cvr = cv + row * D;
    const int P = ly.P, n_chunks = (W + P - 1) / P;
    // chunk c holds scan steps [c P, c P + P): pixels lo(c) .. W - 1 - c P
    auto lo_of = [&](int c) { return max(0, W - (c + 1) * P); };
    auto load_chunk = [&](int c, int s) {  // lane 0
      const int lo = lo_of(c);
      const T* g = cvr + (size_t)lo * D;
      const unsigned bytes = cover(g, (W - c * P - lo) * D);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(&chunk_bar[s])),
          "r"(bytes)
          : "memory");
      bulk_copy(chunks + (size_t)s * ly.pb, g, bytes, &chunk_bar[s]);
    };
    if (lane == 0)
      for (int c = 0; c < ly.SC && c < n_chunks; ++c) load_chunk(c, c);
    float carry[K];
#pragma unroll
    for (int k = 0; k < K; ++k) carry[k] = lane + 32 * k < D ? 0.f : INFINITY;
    int c = 0, s = 0, in = 0, a = 0, use = 0;  // chunk, its slot, step in it
    const T* base = nullptr;
    for (int t = 0; t < W; ++t) {
      const int j = W - 1 - t;
      if (in == 0) {
        mbar_wait(&chunk_bar[s], (unsigned)(c / ly.SC) & 1u);
        base = staged(chunks + (size_t)s * ly.pb, cvr + (size_t)lo_of(c) * D);
      }
      const T* cs = base + (size_t)(j - lo_of(c)) * D;
      float b[K], adj[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane + 32 * k;
        b[k] = d < D ? load(cs + d) : INFINITY;
      }
      if (++in == P || t == W - 1) {  // the chunk is read: refill its slot
        __syncwarp();
        if (lane == 0 && c + ly.SC < n_chunks) load_chunk(c + ly.SC, s);
        in = 0;
        ++c;
        s = s + 1 == ly.SC ? 0 : s + 1;
      }
      dp_step<K>(carry, adj, lane, j, W, P1, P2, Pout);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane + 32 * k < D) carry[k] = b[k] + adj[k];
      // hand adj to the pixel's reduce warp once it has read the slot's
      // last use
      if (use > 0) mbar_wait(&empty[a], (unsigned)(use - 1) & 1u);
      float* slot = adj_ring + (size_t)a * 32 * K;
#pragma unroll
      for (int k = 0; k < K; ++k) slot[lane + 32 * k] = adj[k];
      mbar_arrive(&full[a]);
      if (++a == ly.A) {
        a = 0;
        ++use;
      }
    }
    return;
  }

  // a reduce warp
  const int q = wid - 1, R = ly.R, S = ly.S;
  if (q >= W) return;
  unsigned char* ring =
      reduce_area + (size_t)q * ((size_t)S * ly.stage + 128 * K);
  float* c_s = reinterpret_cast<float*>(ring + (size_t)S * ly.stage);
  uint64_t* bar = stage_bar + q * S;
  const int cb = ly.cb, ab = ly.ab;
  const long long acc_stride = (long long)H * W * D;
  const int nb = 2 * r + 1;
  const bool row_ok = i >= vr && i + vr < H;
  const int n_pix = (W - 1 - q) / R + 1;
  // its u-th pixel: scan step q + u R, column W - 1 - q - u R
  for (int u = 0; u < S && u < n_pix; ++u)
    stage_pixel(ring + (size_t)u * ly.stage, cb, ab, cv, acc, n_acc,
                acc_stride, row + W - 1 - q - u * R, D, &bar[u], lane);
  // step t's adj slot is t % A, in its (t / A)-th use; R < A
  int slot = 0, adj_slot = q, adj_use = 0;
  for (int u = 0; u < n_pix; ++u) {
    const int j = W - 1 - q - u * R;
    const long long pix = row + j;
    __syncwarp();  // c_s is free again (the last pixel's band is written)
    mbar_wait(&bar[slot], (unsigned)(u / S) & 1u);
    unsigned char* st = ring + (size_t)slot * ly.stage;
    const T* cs = staged(st, cv + pix * D);
    float b[K], a[K], adj[K], C[K];
    // the acc volumes in their order, (((a_0 + a_1) + a_2) + ...)
    const float* as = staged(st + cb, acc + pix * D);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      b[k] = d < D ? load(cs + d) : INFINITY;
      a[k] = d < D ? as[d] : 0.f;
    }
#pragma unroll 4
    for (int v = 1; v < n_acc; ++v) {
      as = staged(st + cb + v * ab, acc + v * acc_stride + pix * D);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane + 32 * k;
        if (d < D) a[k] = a[k] + as[d];
      }
    }
    __syncwarp();  // the stage is read: refill it with this warp's pixel S on
    if (u + S < n_pix)
      stage_pixel(st, cb, ab, cv, acc, n_acc, acc_stride, pix - S * R, D,
                  &bar[slot], lane);
    mbar_wait(&full[adj_slot], adj_use & 1u);
    const float* adj_s = adj_ring + (size_t)adj_slot * 32 * K;
#pragma unroll
    for (int k = 0; k < K; ++k) adj[k] = adj_s[lane + 32 * k];
    mbar_arrive(&empty[adj_slot]);
    adj_slot += R;  // this warp's next step, t + R
    if (adj_slot >= ly.A) {
      adj_slot -= ly.A;
      ++adj_use;
    }
    float lm = INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      C[k] = INFINITY;
      if (d < D) {
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
    __syncwarp();  // c_s complete
    for (int s = lane; s < nb; s += 32) {
      const int p = best + s - r;
      bands[pix * nb + s] = (p >= 0 && p < D) ? c_s[p] : INFINITY;
    }
    if (lane == 0) {
      idx_out[pix] = best;
      if (disp != nullptr) {
        // SAME-mode slot validity (correlation_base.h:582-674): NaN slots
        // make the refined disparity NaN, as the composed chain does
        auto slotv = [&](int off) {
          const int p = best + off;
          const bool ok = p >= 0 && p < D && j >= hr && j + p + hr < W && row_ok;
          return ok ? c_s[p] : NAN;
        };
        const float cm1 = slotv(-1), c0 = slotv(0), c1 = slotv(1);
        disp[pix] = (float)best + (cm1 - c1) / (2.f * (c1 - 2.f * c0 + cm1));
      }
    }
    slot = slot + 1 == S ? 0 : slot + 1;
  }
}

// How a K2 / K2k launch lays out its shared memory: each warp holds S stages
// of `stage` bytes (the cost cover, cb bytes, then n_acc acc covers), then
// `extra` bytes (a multiple of 16); a block holds up to LINE_WARPS warps.
// The ring is RING stages deep, or shallower where the launch's lines would
// not all fit the card's shared memory at once (a line that waits for a
// slot costs a whole line's time; 4 stages already hide the loads).
// 227 KB, the most a block can opt into, less room for static barriers
constexpr int SMEM_MAX = 232448 - 1024;
constexpr double SMEM_SM = 0.9 * 233472;  // of an SM's 228 KB

struct Layout {
  int S, cb, stage, warps;
  size_t smem;
};

int round16(int x) { return (x + 15) & ~15; }

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

bool ring_layout(int D, int elt, int n_acc, int extra, int lines,
                 Layout& r) {
  r.cb = round16(D * elt + 15);
  r.stage = r.cb + n_acc * round16(D * 4 + 15);
  const double per_line = SMEM_SM * sm_count() / (lines > 0 ? lines : 1);
  r.S = (int)((per_line - extra) / r.stage);
  r.S = r.S > RING ? RING : (r.S < 2 ? 2 : r.S);
  auto area = [&] { return (size_t)r.S * r.stage + extra; };
  while (area() > (size_t)SMEM_MAX && r.S > 2) --r.S;
  if (area() > (size_t)SMEM_MAX) return false;
  r.warps = LINE_WARPS;
  while (r.warps > 1 && r.warps * area() > (size_t)SMEM_MAX) --r.warps;
  r.smem = r.warps * area();
  return true;
}

// How the any-D K2 (D > 320) runs a launch: the instance (where the
// carries live), K (d-slices a lane) and G (warps a line), and for the
// registers instance the ring (S stages of `stage` bytes a warp, the
// covers of its part of the cost vector, cb bytes, and of acc's), as deep
// as RING where the launch's lines would all fit the card's shared memory
// at once.  A pure function of its arguments; ops/sgm_cuda.pass_layout is
// its Python twin.
enum PassInstance { PASS_REGISTERS = 0, PASS_SHARED = 1, PASS_DEVICE = 2 };

struct PassLayout {
  int inst, K, G, S, cb, stage;
  size_t smem;
};

PassLayout pass_layout(int D, int elt, int n_acc, int lines, int sms) {
  PassLayout r = {};
  if (D > GROUP_MAX_D) {
    r.inst = D <= BUF_MAX_D ? PASS_SHARED : PASS_DEVICE;
    r.G = MAX_GROUP;
    r.smem = r.inst == PASS_SHARED ? (size_t)round16(8 * D) : 0;
    return r;
  }
  r.inst = PASS_REGISTERS;
  r.K = D <= GROUP_K4_MAX_D ? 4 : 8;
  r.G = (D + 32 * r.K - 1) / (32 * r.K);
  r.cb = round16(32 * r.K * elt + 15);
  r.stage = r.cb + n_acc * round16(32 * r.K * 4 + 15);
  const double per_line = SMEM_SM * sms / (lines > 0 ? lines : 1);
  r.S = (int)(per_line / ((double)r.G * r.stage));
  r.S = r.S > RING ? RING : (r.S < 2 ? 2 : r.S);
  while ((size_t)r.G * r.S * r.stage > (size_t)PASS_SMEM && r.S > 2) --r.S;
  r.smem = (size_t)r.G * r.S * r.stage;
  return r;
}

// A block takes more than 48 KB of shared memory, its static arrays and
// the dynamic part together, only where its kernel opts in; the kernels
// here keep at most 4 KB static (PASS_SMEM's margin).
cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem + 4096 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
cudaError_t pass_t(const void* cv, float* acc, const float* cin, float* cout,
                   unsigned char* spill, int H, int W, int D,
                   const Dirs& dirs, int n, float P1, float P2, float Pout,
                   int accumulate, int col0, int W_pout, int i0, int H_img,
                   int* used, cudaStream_t s) {
  const int K = (D + 31) / 32;
  int lines = 0, most = 0;  // all directions' lines, and one's most
  for (int y = 0; y < n; ++y) {
    const int l =
        dirs.di[y] == 0 ? H : (dirs.dj[y] == 0 ? W : H + W - 1);
    lines += l;
    most = l > most ? l : most;
  }
  const T* v = static_cast<const T*>(cv);
  cudaError_t e;
  if (K > REG_K) {  // any D: a line a block of G warps (`pass_layout`)
    const PassLayout pl =
        pass_layout(D, sizeof(T), accumulate ? 1 : 0, lines, sm_count());
    // the caller allocates the global carry areas exactly where the
    // layout says so (ops/sgm_cuda.pass_layout)
    if ((spill != nullptr) != (pl.inst == PASS_DEVICE))
      return cudaErrorInvalidValue;
    if (used != nullptr) {  // the layout this launch runs, for the caller
      const int r[5] = {pl.inst, pl.K, pl.G, pl.S, (int)pl.smem};
      for (int k = 0; k < 5; ++k) used[k] = r[k];
    }
    const dim3 grid(most, n);
    if (pl.inst == PASS_DEVICE) {
      sgm_pass_buf_kernel<T, true><<<grid, 32 * pl.G, 0, s>>>(
          v, acc, cin, cout, spill, H, W, D, dirs, P1, P2, Pout, accumulate,
          col0, W_pout, i0, H_img);
      return cudaGetLastError();
    }
    if (pl.inst == PASS_SHARED) {
      e = allow_smem((const void*)sgm_pass_buf_kernel<T, false>, pl.smem);
      if (e != cudaSuccess) return e;
      sgm_pass_buf_kernel<T, false><<<grid, 32 * pl.G, pl.smem, s>>>(
          v, acc, cin, cout, nullptr, H, W, D, dirs, P1, P2, Pout,
          accumulate, col0, W_pout, i0, H_img);
      return cudaGetLastError();
    }
#define SGM_GROUP_CASE(k)                                                  \
  case k:                                                                  \
    e = allow_smem((const void*)sgm_pass_group_kernel<k, T>, pl.smem);     \
    if (e != cudaSuccess) return e;                                        \
    sgm_pass_group_kernel<k, T><<<grid, 32 * pl.G, pl.smem, s>>>(          \
        v, acc, cin, cout, H, W, D, dirs, P1, P2, Pout, accumulate, col0,  \
        W_pout, i0, H_img, pl.S, pl.cb, pl.stage);                         \
    break;
    switch (pl.K) {
      SGM_GROUP_CASE(4) SGM_GROUP_CASE(8)
      default: return cudaErrorInvalidValue;
    }
#undef SGM_GROUP_CASE
    return cudaGetLastError();
  }
  if (spill != nullptr) return cudaErrorInvalidValue;
  Layout ly;
  if (!ring_layout(D, sizeof(T), accumulate ? 1 : 0, 0, lines, ly))
    return cudaErrorInvalidValue;
  const dim3 grid((most + ly.warps - 1) / ly.warps, n);
#define SGM_PASS_CASE(k)                                                   \
  case k:                                                                  \
    e = allow_smem((const void*)sgm_pass_kernel<k, T>, ly.smem);           \
    if (e != cudaSuccess) return e;                                        \
    sgm_pass_kernel<k, T><<<grid, 32 * ly.warps, ly.smem, s>>>(            \
        v, acc, cin, cout, H, W, D, dirs, P1, P2, Pout, accumulate, col0,  \
        W_pout, i0, H_img, ly.S, ly.cb, ly.stage);                         \
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
cudaError_t knight_t(const void* cv, float* vol, const float* cin,
                     float* cout, unsigned char* spill, int H, int W, int D,
                     const KDirs& dirs, int n, int phase, float P1, float P2,
                     float Pout, int col0, int W_pout, int s0,
                     cudaStream_t s) {
  const int K = (D + 31) / 32;
  const bool regs = K <= REG_K;
  int lines = 0, most = 0;  // all directions' lines, and one's most
  for (int y = 0; y < n; ++y) {
    const int l = knight_lines(H, W, dirs.v0[y], dirs.h0[y], phase, s0,
                               dirs.n_img[y], dirs.v0[y] == dirs.v1[y]);
    lines += l;
    most = l > most ? l : most;
  }
  if (most == 0) return cudaSuccess;
  Layout ly;  // phase 1 also stages the volume's vector
  if (spill != nullptr) {  // direct loads, the carries in global memory
    if (regs) return cudaErrorInvalidValue;
    ly.S = ly.cb = ly.stage = 0;
    ly.warps = LINE_WARPS;
    ly.smem = 0;
  } else if (!ring_layout(D, sizeof(T), phase, regs ? 0 : round16(8 * D),
                          lines, ly)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((most + ly.warps - 1) / ly.warps, n);
  const T* v = static_cast<const T*>(cv);
  cudaError_t e;
  if (!regs && spill != nullptr) {  // any D, the carries in global memory
    sgm_knight_smem_kernel<T, true><<<grid, 32 * ly.warps, 0, s>>>(
        v, vol, cin, cout, spill, H, W, D, dirs, phase, P1, P2, Pout, col0,
        W_pout, s0, ly.S, ly.cb, ly.stage);
    return cudaGetLastError();
  }
  if (!regs) {  // any D: the carries in shared memory
    e = allow_smem((const void*)sgm_knight_smem_kernel<T, false>, ly.smem);
    if (e != cudaSuccess) return e;
    sgm_knight_smem_kernel<T, false><<<grid, 32 * ly.warps, ly.smem, s>>>(
        v, vol, cin, cout, nullptr, H, W, D, dirs, phase, P1, P2, Pout,
        col0, W_pout, s0, ly.S, ly.cb, ly.stage);
    return cudaGetLastError();
  }
#define SGM_KNIGHT_CASE(k)                                                 \
  case k:                                                                  \
    e = allow_smem((const void*)sgm_knight_kernel<k, T>, ly.smem);         \
    if (e != cudaSuccess) return e;                                        \
    sgm_knight_kernel<k, T><<<grid, 32 * ly.warps, ly.smem, s>>>(          \
        v, vol, cin, cout, H, W, D, dirs, phase, P1, P2, Pout, col0,       \
        W_pout, s0, ly.S, ly.cb, ly.stage);                                \
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

// K3's layout, a pure function of its arguments (ops/sgm_cuda.wta_layout
// is its Python twin: change both together).  A row is one block.  Each row
// an SM is planned to hold at once gets an equal share of SMEM_SM (all of
// SMEM_MAX where one reduce warp of two stages needs it).  The scan warp's
// ring is WTA_CHUNKS chunks of P = WTA_CHUNK / (D elt) pixels (at least
// 1); a reduce warp takes two stages, its C vector and two adj slots
// (A = 2 R: the scan warp may run a slot ahead of every reduce warp), and a
// row takes as many as its share holds, up to WTA_REDUCE and to
// WTA_WARPS_SM warps on the SM; what is left deepens the reduce rings, up
// to RING stages.  The rows an SM plans, n, are the count whose rows end
// soonest: they run in ceil(H / (n sms)) waves, one after another, and a
// row with R < WTA_PACE reduce warps takes WTA_PACE / R times as long as
// its scan warp alone; the fewest rows among equals.  More rows an SM cut
// the waves but thin each row's reduce warps (720 rows of D = 320 over 7
// volumes: 2 rows an SM, 4 reduce warps each, 3 waves).
int wta_reduce_warps(int budget, int scan, int warp, int rows) {
  int R = (budget - scan) / warp;
  if (R > WTA_REDUCE) R = WTA_REDUCE;
  if (R > WTA_WARPS_SM / rows - 1) R = WTA_WARPS_SM / rows - 1;
  return R;
}

bool wta_layout(int D, int elt, int n_acc, int H, int sms, WtaLayout& ly) {
  const int K = (D + 31) / 32, vec = 128 * K;
  ly.cb = round16(D * elt + 15);
  ly.ab = round16(D * 4 + 15);
  ly.stage = ly.cb + n_acc * ly.ab;
  ly.P = WTA_CHUNK / (D * elt) > 1 ? WTA_CHUNK / (D * elt) : 1;
  ly.pb = round16(ly.P * D * elt + 15);
  ly.SC = WTA_CHUNKS;
  const int scan = ly.SC * ly.pb, warp = 2 * ly.stage + 3 * vec;
  if (scan + warp > SMEM_MAX) return false;
  auto share = [&](int rows) {
    const int b = (int)(SMEM_SM / rows);
    return b > SMEM_MAX ? SMEM_MAX : (scan + warp > b ? SMEM_MAX : b);
  };
  // a count of rows n is better than m where its waves over its pace,
  // ceil(H / (n sms)) / min(R, WTA_PACE), are fewer
  int rows = 1, waves = (H + sms - 1) / sms;
  int pace = wta_reduce_warps(share(1), scan, warp, 1);
  pace = pace < WTA_PACE ? pace : WTA_PACE;
  for (int n = 2; n <= WTA_WARPS_SM / 2 && scan + warp <= SMEM_SM / n; ++n) {
    const int w = (H + n * sms - 1) / (n * sms);
    int p = wta_reduce_warps(share(n), scan, warp, n);
    p = p < WTA_PACE ? p : WTA_PACE;
    if ((long long)w * pace < (long long)waves * p) {
      rows = n;
      waves = w;
      pace = p;
    }
  }
  const int budget = share(rows);
  ly.R = wta_reduce_warps(budget, scan, warp, rows);
  ly.A = 2 * ly.R;
  ly.S = (budget - scan - ly.R * 3 * vec) / (ly.R * ly.stage);
  ly.S = ly.S > RING ? RING : ly.S;
  ly.smem = scan + ly.A * vec + ly.R * (ly.S * ly.stage + vec);
  ly.rows = rows;
  return true;
}

template <typename T>
cudaError_t wta_t(const void* cv, const float* acc, int n_acc, int* idx,
                  float* bands, float* disp, int H, int W, int D, float P1,
                  float P2, float Pout, int r, int hr, int vr, int* used,
                  cudaStream_t s) {
  const int K = (D + 31) / 32;
  WtaLayout ly;
  if (!wta_layout(D, sizeof(T), n_acc, H, sm_count(), ly))
    return cudaErrorInvalidValue;
  if (used != nullptr) {  // the layout this launch runs, for the caller
    const int u[7] = {ly.R, ly.S, ly.P, ly.SC, ly.A, ly.smem, ly.rows};
    for (int k = 0; k < 7; ++k) used[k] = u[k];
  }
  const T* v = static_cast<const T*>(cv);
  cudaError_t e;
  // used[7]: the blocks of this layout an SM can hold, by the compiled
  // instance's registers and the card's limits (the plan's check)
#define SGM_WTA_CASE(k)                                                    \
  case k:                                                                  \
    e = allow_smem((const void*)sgm_wta_kernel<k, T>, ly.smem);            \
    if (e != cudaSuccess) return e;                                        \
    if (used != nullptr)                                                   \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
          &used[7], sgm_wta_kernel<k, T>, 32 * (1 + ly.R), ly.smem);       \
    if (e != cudaSuccess) return e;                                        \
    sgm_wta_kernel<k, T><<<H, 32 * (1 + ly.R), ly.smem, s>>>(              \
        v, acc, n_acc, idx, bands, disp, H, W, D, P1, P2, Pout, r, hr, vr, \
        ly);                                                               \
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

bool bad_region(int H, int W, int D, int col0, int W_pout) {
  return H < 1 || W < 1 || D < 1 || col0 < 0 || W_pout < col0 + W;
}

}  // namespace

// Any D: past D = 320 the instance `pass_layout` picks (registers,
// shared or device).  steps holds n directions (di, dj), 1 <= n <=
// MAX_DIRS; direction y uses volume y of acc (H * W * D floats apart).
// cin / cout may be null (a zero line start / no carries out); with
// carries (one direction only) the block is rows [i0, i0 + H) of an image
// H_img rows high (K2s).  spill: n x (H + W) areas of r16(8 D) bytes in
// global memory for the carries where `pass_layout` says device, else
// null (either way round is refused).  used, where not null, receives
// the layout an any-D launch runs (instance, K, G, ring stages, dynamic
// shared-memory bytes); below D = 321 it is left as it was.
extern "C" int sgm_pass_launch(const void* cv, int cv_bf16, void* acc,
                               const void* cin, void* cout, void* spill,
                               int n, const int* steps, int H, int W, int D,
                               float P1, float P2, float Pout, int accumulate,
                               int col0, int W_pout, int i0, int H_img,
                               int* used, void* stream) {
  const bool carries = cin != nullptr || cout != nullptr;
  if (bad_region(H, W, D, col0, W_pout) || n < 1 || n > MAX_DIRS ||
      (n > 1 && carries) || i0 < 0 || H_img < i0 + H)
    return (int)cudaErrorInvalidValue;
  Dirs dirs = {};
  for (int y = 0; y < n; ++y) {
    const int di = steps[2 * y], dj = steps[2 * y + 1];
    if (di < -1 || di > 1 || dj < -1 || dj > 1 || (di == 0 && dj == 0) ||
        (di == 0 && carries))
      return (int)cudaErrorInvalidValue;
    dirs.di[y] = di;
    dirs.dj[y] = dj;
  }
  float* a = static_cast<float*>(acc);
  const float* ci = static_cast<const float*>(cin);
  float* co = static_cast<float*>(cout);
  unsigned char* sp = static_cast<unsigned char*>(spill);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cv_bf16 ? pass_t<__nv_bfloat16>(cv, a, ci, co, sp, H, W, D,
                                               dirs, n, P1, P2, Pout,
                                               accumulate, col0, W_pout, i0,
                                               H_img, used, s)
                       : pass_t<float>(cv, a, ci, co, sp, H, W, D, dirs, n,
                                       P1, P2, Pout, accumulate, col0, W_pout,
                                       i0, H_img, used, s));
}

// One seed phase (0: write, 1: add) of n knight directions, any D (the
// shared-memory instance past D = 320).  steps holds (v0, v1, h0, h1) for
// each, 1 <= n <= MAX_KNIGHTS; direction y writes volume y of vol (H * W * D
// floats apart).  cin / cout may be null (a zero line start / no carries
// out); with carries (one direction) the block is scan rows [s0, s0 + N) of
// N_img along the primary axis (rows for vertical-primary directions,
// columns otherwise), and cin / cout hold one D-vector per position along
// the other axis (K2s).  N_img = 0 takes each direction's own extent (a
// whole image).  spill: null, or n x (H + W) areas of r16(8 D) bytes in
// global memory for the carries (D > 320, where `ring_layout` refuses:
// ops/sgm_cuda.ring_fits).
extern "C" int sgm_knight_launch(const void* cv, int cv_bf16, void* vol,
                                 const void* cin, void* cout, void* spill,
                                 int n,
                                 const int* steps, int H, int W, int D,
                                 int phase, float P1, float P2, float Pout,
                                 int col0, int W_pout, int s0, int N_img,
                                 void* stream) {
  const bool carries = cin != nullptr || cout != nullptr;
  if (bad_region(H, W, D, col0, W_pout) || n < 1 || n > MAX_KNIGHTS ||
      (n > 1 && (carries || s0 != 0)) || phase < 0 || phase > 1 || s0 < 0)
    return (int)cudaErrorInvalidValue;
  KDirs dirs = {};
  for (int y = 0; y < n; ++y) {
    const int v0 = steps[4 * y], v1 = steps[4 * y + 1], h0 = steps[4 * y + 2],
              h1 = steps[4 * y + 3];
    // a knight direction: one axis steps every time (+-1), the other
    // alternates 0 and +-1
    const bool vert = v0 == v1 && (v0 == 1 || v0 == -1) && h0 == 0 &&
                      (h1 == 1 || h1 == -1);
    const bool horz = h0 == h1 && (h0 == 1 || h0 == -1) && v0 == 0 &&
                      (v1 == 1 || v1 == -1);
    const int N = vert ? H : W, n_img = N_img > 0 ? N_img : N;
    if (!(vert || horz) || n_img < s0 + N) return (int)cudaErrorInvalidValue;
    dirs.v0[y] = v0;
    dirs.v1[y] = v1;
    dirs.h0[y] = h0;
    dirs.h1[y] = h1;
    dirs.n_img[y] = n_img;
  }
  float* a = static_cast<float*>(vol);
  const float* ci = static_cast<const float*>(cin);
  float* co = static_cast<float*>(cout);
  unsigned char* sp = static_cast<unsigned char*>(spill);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cv_bf16 ? knight_t<__nv_bfloat16>(cv, a, ci, co, sp, H, W, D,
                                                 dirs, n, phase, P1, P2, Pout,
                                                 col0, W_pout, s0, s)
                       : knight_t<float>(cv, a, ci, co, sp, H, W, D, dirs, n,
                                         phase, P1, P2, Pout, col0, W_pout,
                                         s0, s));
}

// D <= 320 (K = ceil(D / 32) <= 10 register slices); whole images.  acc is
// n_acc <= MAX_ACC volumes of H * W * D floats, one after another, summed
// in order.  used, where not null, receives 8 ints: the layout the launch
// runs (R, S, P, SC, A, the dynamic shared-memory bytes and the rows an SM
// is planned to hold), then the blocks of it an SM can hold.
extern "C" int sgm_wta_launch(const void* cv, int cv_bf16, const void* acc,
                              int n_acc, void* idx, void* bands, void* disp,
                              int H, int W, int D, float P1, float P2,
                              float Pout, int r, int hr, int vr, void* used,
                              void* stream) {
  if (bad_region(H, W, D, 0, W) || D > 32 * REG_K || n_acc < 1 ||
      n_acc > MAX_ACC || r < 0 || hr < 0 || vr < 0 ||
      (disp != nullptr && r < 1))
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(acc);
  int* ix = static_cast<int*>(idx);
  float* bd = static_cast<float*>(bands);
  float* dp = static_cast<float*>(disp);
  int* u = static_cast<int*>(used);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cv_bf16 ? wta_t<__nv_bfloat16>(cv, a, n_acc, ix, bd, dp, H, W,
                                              D, P1, P2, Pout, r, hr, vr, u, s)
                       : wta_t<float>(cv, a, n_acc, ix, bd, dp, H, W, D, P1,
                                      P2, Pout, r, hr, vr, u, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
