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
//   K4d `chunked_sweep_kernel` <- `_chunked_rows_kernel` (:586, launched by
//       `_chunked_pass` :667, one pallas_call a chunk, chained by
//       `sgm_chunked_adj` :706): a whole row sweep of the vertical direction
//       (optional) and one diagonal family over W-chunks, all chunks in one
//       launch, the diagonal carry crossing each chunk edge through a
//       history of the boundary column's carries.
//
// The DP step is `_fused_step` (:132-144): m = min(prev),
//   agg = min(min(prev[d], m + P2), min(prev[d-1], prev[d+1]) + P1),
//   adj = (agg - m) + pout,  carry = cv + adj,
// with prev[-1] = prev[D] = +inf and no isfinite guards; a line starts from
// a zero carry (a null carry pointer below).  The sums follow the TPU
// kernels' order: total = acc + adj_v + adj_p * mult + adj_n * mult, where
// mult is 2 on the corner line that `addDirectionalCost` enumerates from
// both start edges and 1 elsewhere (exact products, so a fused multiply-add
// rounds the same).  The column scans may take a stack of up to 8 knight
// volumes beside acc and add them first, (((acc + k_0) + k_1) + ...), which
// is what adding them into acc one after another leaves.  The plain
// versions in ops/sgm_lane_cuda.py repeat these operations in this order,
// so kernel and plain version agree to the bit.  Every carry lives in
// shared memory (D floats per column and direction, double-buffered by row
// parity; d +- 1 are shared-memory reads), except where a block's shared
// memory does not hold it: past K4d's chunk of one column (D = 11622 with
// the diagonal) and the column scans' area (14460 with WTA) the same
// kernels keep it in a global area of the block's own, read through the
// same generic pointers (ops/sgm_lane_cuda.chunk_layout, cols_spills), so
// the route takes any D, as the TPU's XLA path does.
//
// The TPU kept a row chunk's full width in one core's VMEM and ran rows in
// order, so its sweep needed no barrier.  On an H100 the width is spread
// over the SMs: the row sweep is one cooperative grid, one block per SM,
// and block b owns columns [b*ncols, (b+1)*ncols), ncols = ceil(W / SMs),
// keeping their carries on chip.  The rule that follows (see
// ops/sgm_lane_cuda.fused_fits): (2 * 3 * ncols + 2) * D * 4 B (the
// carries and a two-carry halo; 2 * ncols * D * 4 B for 4 directions) must
// fit one block's shared memory (227 KiB): 48 KiB at 480x640 D = 384, 155
// KiB at 720x1280 D = 640.
//
// What bounds K4b and K4c on an H100.  The function's bytes are small (one
// 472 MB volume stream at 480x640x384 is 0.14 ms at 3.35 TB/s); a sweep is
// a chain of H dependent row steps, and a row step is latency: the loads
// of the row's cv and acc, the step's own shared-memory chain, and the
// wait for the neighbouring columns' carries.  The first version paid
// all three in full, 6.6-9.1 us a row: a grid barrier closed every row, the
// loads were issued after it, and each column was one warp (5-10 warps an
// SM) walking three min loops and the step over D in order.  This version:
// - Row slabs through a TMA ring.  Block b's columns of row i are one
//   contiguous run of ncols * D floats, so one thread issues one bulk copy
//   (`cp.async.bulk`, completing on the stage's mbarrier) for cv and one
//   for acc, S rows ahead of the step; a row waits only on its stage.  S
//   comes from the shared memory the carries leave (up to RING stages; at
//   720x1280x640, 2 cv stages, acc then loaded directly); where no stage
//   fits the same kernel loads directly (S = 0).  The 16-byte-aligned
//   cover of a slab is copied and read from its offset, so any D works.
// - Neighbour-only row sync.  Only a block's two edge columns need another
//   block's carries (a diagonal carry moves one column a row).  A block
//   writes its edge columns' diagonal carries (and their parts' minima) to
//   the global edge buffer, closes the row with __syncthreads, and one
//   thread publishes the count of rows done with a release store at GPU
//   scope: the first warp of an interior column, which also stages the
//   rows, since the edge columns' warps set a row's pace.  Before row t,
//   the warps of an edge column spin with acquire loads until the neighbour
//   block's count reaches t, copy the part of its edge carry they need
//   into shared memory through L2 (__ldcg, all loads in flight at once),
//   and go on; interior columns never wait.  Blocks drift apart by at most
//   a row from their neighbours.  (No __threadfence before the release:
//   the release is cumulative over the writes the barrier ordered before
//   it, and the fence measured slower.)  Spinning on another block needs
//   every block resident: the launch stays cooperative, with the occupancy
//   check.  The counters are a small int buffer the wrapper zeroes for each
//   launch (a stream-ordered memset; an epoch would have to outlive the
//   launch, in memory the kernel may not allocate).  (Edge words tagged
//   with their row and polled directly, with no counter, measured slower:
//   the 64-bit words and reload loops cost registers and spills; PERF.md.)
// - Why the parity edge buffer stays race-free.  Block b writes edge
//   carries of row t into slot t & 1; its neighbour reads them during its
//   row t + 1, and slot t & 1 is written again at b's row t + 2.  Each edge
//   column's carries are read by exactly one neighbour, and the warps that
//   write them are the warps that, at the start of every row, wait for that
//   same neighbour (the left column of block b serves and waits on b - 1,
//   the right column b + 1).  So before writing row t + 2 they have seen
//   the neighbour's count reach t + 2, i.e. the neighbour finished row t + 1
//   and with it its read of slot t & 1.  A reader, in turn, reads slot
//   (t - 1) & 1 only after the writer's count reached t, published after
//   those writes (__syncthreads, then the release store).
// - A cheaper step.  A column's D is split over G warps (parts of whole
//   32-wide slices; G = 24 // ncols, at most ceil(D / 32)), so 20 warps
//   share an SM at 480x640 and 720x1280 where there were 5 and 10.  The min
//   over d of each new carry is taken as it is written (a warp min a part,
//   the parts' mins in shared memory beside the carries, and in the edge
//   buffer for the neighbour), so no step walks a carry only to find its
//   minimum; a part reads d +- 1 across its range from the previous row's
//   buffer, complete after the row's __syncthreads.  Where those few
//   floats do not fit beside the carries the kernel takes G = 1 and finds
//   the minima by a loop, as before.
// What bounds them now (`python -m libstevi_tpu_torch.lane_probe`:
// clock64 phase counts of one block, PERF.md): neither bytes nor a grid
// barrier but a row's latency chain.  The edge columns' part warps wait
// for the neighbour's count and load its halo through L2, every part warp
// then runs its step (20 warps sharing the SM's issue) and its minima, the
// row's barrier waits for the slowest, and the issuer also pays the
// release store, which waits for the block's writes.
// The column scans run one block a row: the carry in shared memory, D
// split over COLS_WARPS warps (ops/sgm_lane_cuda.cols_layout) that take
// the min of their part of the new carry as they write it and meet at one
// barrier a step (two with WTA: the min of C, then its last index); warp 0
// stages each pixel's cv, acc and knight D-vectors S steps ahead through a
// TMA ring, as K2 does (csrc/sgm_scan.cu).  (A producer warp for the ring
// measured no faster at 480x640 and slower at 720x1280.)
// No float atomics anywhere: every carry and output has one writer, so two
// runs give the same bits.
//
// K4d is the route beyond K4b's fit rule (a 4K-wide frame at D = 384:
// entry.uhd_wide_forward).  The TPU ran its W-chunks one pallas_call after
// another, and the first port did too, one block each: one SM of 132 busy,
// n_w x H dependent rows (260.7 ms at 480x640x384).  Each of K4d's four
// sweeps carries ONE diagonal family (sgm_lane_cuda.chunked_adj's table),
// so a chunk's row t needs only its upstream neighbour's boundary carry
// after row t - 1: a one-way wavefront, a sweep in one launch, every chunk
// a block, chunks drifting a row apart, about H + n_w row steps a sweep.
// - Neighbour sync in one direction, as K4b's (above): the upstream
//   block writes its boundary column's carry of every row (and its parts'
//   minima) to a history buffer, closes the row with __syncthreads and
//   publishes its row count with a release store; the warps of the
//   downstream block's boundary column spin with acquire loads, then read
//   the carry through L2 (__ldcg).  The history keeps every row, so a
//   producer never waits on its consumer and no slot is reused.  (Each
//   boundary part publishing at once, that column first in the row,
//   measured slower at 4K: the release inside the warp's loop waits for
//   its stores; PERF.md.)
// - Forward progress without co-residency: a block takes its chunk from an
//   atomic ticket in the flow's order (left to right for shift_down, else
//   right to left), so it only waits on the chunk of a smaller ticket,
//   which a block already running holds: the dynamic numbering of
//   single-pass decoupled look-back scans (Merrill and Garland, NVIDIA
//   NVR-2016-002).  No cooperative launch, and n_w may pass the SM count.
//   The counters and the ticket are a small int buffer the wrapper zeroes
//   for each launch.
// - K4b's row machinery: D split over warps with each part's minimum taken
//   as the carry is written (no min loop over the previous carry), loads
//   issued ROW_U slices ahead.  No TMA ring: at 4K the two-family carries
//   leave no room for a stage, and without the ring the one-family sweeps
//   ran as fast (PERF.md, PR 11).
// - The chunk width fills the card: ceil(W / SMs) columns, at most what
//   the carries allow (sgm_lane_cuda.chunk_width), so at 2160x3840x384 128
//   chunks of 30 columns, one a SM.  The bits do not depend on it: a
//   carry crossing a chunk edge is the carry a wider chunk keeps on chip.
// It is a kernel of its own, not an instance of fused_rows_kernel: K4b's
// parity edge buffer is race-free only because neighbours wait on each
// other both ways, and a one-way wavefront needs the full history and the
// ticket instead.  What bounds it: the row chain (H + n_w steps) and, at
// 4K, the loads each row step waits on.
// Each lane issues the loads of U (ROW_U in the row kernels) d-slices
// before it computes or stores, so a step pays the global-load latency
// once per U slices.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_COLS_WARPS = 8;   // most warps (parts of D) of a column scan
constexpr int ROW_WARPS = 24;       // most warps of a row-sweep block
constexpr int RING = 8;             // most stages of a ring
constexpr int MAX_KNIGHTS = 8;      // knight volumes a column scan sums
constexpr int U = 8;                // d-slices a lane loads before it computes
constexpr int ROW_U = 4;            // the same in a row-sweep part
constexpr int HALO_U = 12;          // halo slices a lane loads at once
constexpr int SMEM_MAX = 232448;    // 227 KB, the most a block can opt into
constexpr int COLS_SMEM = SMEM_MAX - 1024;  // less the static barriers

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

// ---------------------------------------------------------------------------
// TMA staging (as in csrc/sgm_scan.cu): one bulk copy of the 16-byte-aligned
// cover of a run of floats, completing on an mbarrier that expects its
// bytes.  The cover never leaves the memory pages the run lies on.
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t r16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ const char* down16(const void* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) &
                                       ~static_cast<uintptr_t>(15));
}

// the bytes of the 16-byte-aligned cover of n floats at g
__device__ __forceinline__ unsigned cover(const float* g, size_t n) {
  return static_cast<unsigned>(
      r16(static_cast<size_t>(reinterpret_cast<const char*>(g + n) -
                              down16(g))));
}

// where a run that starts at global address g sits in its stage slot
__device__ __forceinline__ const float* staged(const unsigned char* slot,
                                               const float* g) {
  return reinterpret_cast<const float*>(
      slot + (reinterpret_cast<uintptr_t>(g) & 15));
}

// Copy the cover of n floats at src to dst, on `bar`: the stage was read
// by generic loads, so order them before the async proxy's writes, then
// announce the bytes and issue the copy.
__device__ __forceinline__ void stage_run(void* dst, const float* src,
                                          size_t n, uint64_t* bar) {
  const unsigned bytes = cover(src, n);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(down16(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A pointer the compiler cannot trace to its state space, so that loads
// through it are generic (ld, not ld.global).  K4d reads its row slabs so:
// with ld.global its two-family sweeps at 4K, which stage nothing, ran
// ~13% slower (PERF.md, PR 11; the cause is not measured: no SASS
// profiler runs on the card's machine).
__device__ __forceinline__ const float* opaque(const float* p) {
  asm("mov.b64 %0, %0;" : "+l"(p));
  return p;
}

// the neighbour-sync counters: a release store and an acquire load at GPU
// scope
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
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

// ---------------------------------------------------------------------------
// K4b rows and K4c
// ---------------------------------------------------------------------------

// A row-sweep block's shared memory, in bytes from its start: the carries
// (2 buffers x nc families x ncols x D floats), the halo (n_halo slots, one
// a neighbour carry a block reads: the parts' ranges of its D with one
// float of overlap on each side, D + 2 (G - 1) floats), the parts' minima
// (use_mins: 2 x nc x ncols x G floats), then, with a ring (S > 0), S
// mbarriers and S stages of one cv slab (and one acc slab with
// stage_acc), each in a slot of the 16-byte-aligned cover of ncols * D
// floats.  K4b and K4c take nc = 3 and n_halo = 2 (both diagonal
// families) with the diagonal, nc = 1 and n_halo = 0 without; K4d nc = 1
// or 2 and n_halo = 1 (its one diagonal family).
// ops/sgm_lane_cuda.row_layout and chunk_layout compute the same sizes.
struct RowLayout {
  size_t halo, mins, bars, ring, slot, stage, total;
};

__host__ __device__ inline RowLayout row_layout(int ncols, int D, int G,
                                                int S, int nc, int n_halo,
                                                bool stage_acc,
                                                bool use_mins) {
  RowLayout L;
  L.halo = sizeof(float) * 2 * nc * ncols * (size_t)D;
  L.mins = L.halo + sizeof(float) * n_halo * ((size_t)D + 2 * (G - 1));
  const size_t base =
      L.mins + (use_mins ? sizeof(float) * 2 * nc * ncols * (size_t)G : 0);
  L.slot = r16(sizeof(float) * (size_t)ncols * D + 15);
  L.stage = (stage_acc ? 2 : 1) * L.slot;
  L.bars = r16(base);
  L.ring = L.bars + r16(8 * (size_t)S);
  L.total = S > 0 ? L.ring + S * L.stage : base;
  return L;
}

struct RowArgs {
  const float* cv;
  const float* acc;   // may alias out; null: a fresh sweep
  float* out;
  float* edge;        // (2 parities, 2 families, W, D) edge carries
  float* edge_min;    // (2, 2, W, G) their parts' minima
  int* flags;         // rows done, one counter a block, zero at launch
  const float* cin;
  float* cout;
  int H, W, D, ncols, G, S, stage_acc, use_mins, col0, W_pout;
  float P1, P2, Pout;
  int reverse, i0, H_img;
};

// a previous-row carry (null: a zero carry, the line start) and its min
struct Prev {
  const float* p;
  float m;
};

__device__ __forceinline__ float parts_min(const float* p, int G) {
  float m = p[0];
  for (int q = 1; q < G; ++q) m = fminf(m, p[q]);
  return m;
}

// K4b rows: one sweep (down, or up with `reverse`) over the whole region,
// one block a column range, G warps (parts of D) a column.
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
__global__ void __launch_bounds__(32 * ROW_WARPS, 1)
fused_rows_kernel(const RowArgs a) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  constexpr int NC = DIAG ? 3 : 1;  // vertical, pos (j - i), neg (i + j)
  const int H = a.H, W = a.W, D = a.D, ncols = a.ncols, G = a.G, S = a.S;
  const bool mins_on = a.use_mins != 0;
  const bool stage_acc = a.stage_acc != 0 && a.acc != nullptr;
  const RowLayout L = row_layout(ncols, D, G, S, NC, DIAG ? 2 : 0,
                                 stage_acc, mins_on);
  float* car_s = reinterpret_cast<float*>(row_smem);
  float* halo = reinterpret_cast<float*>(row_smem + L.halo);
  float* mins = reinterpret_cast<float*>(row_smem + L.mins);
  uint64_t* bars = reinterpret_cast<uint64_t*>(row_smem + L.bars);
  unsigned char* ring = row_smem + L.ring;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.x;
  const int c_lo = b * ncols, c_hi = min(W, c_lo + ncols), nc = c_hi - c_lo;
  const int SP = ((D + 31) / 32 + G - 1) / G;  // 32-wide slices a part
  const size_t hslot = (size_t)D + 2 * (G - 1);
  auto car = [&](int buf, int f, int lc) {
    return car_s + ((size_t)(buf * NC + f) * ncols + lc) * D;
  };
  auto pmin = [&](int buf, int f, int lc) {
    return mins + ((size_t)(buf * NC + f) * ncols + lc) * G;
  };
  auto edg = [&](int buf, int f, int c) {
    return a.edge + ((size_t)(buf * 2 + (f - 1)) * W + c) * D;
  };
  auto edg_min = [&](int buf, int f, int c) {
    return a.edge_min + ((size_t)(buf * 2 + (f - 1)) * W + c) * G;
  };
  // the carry family f of column c that the first scan row continues
  auto cin_at = [&](int f, int c) -> const float* {
    if (a.cin == nullptr) return nullptr;
    return a.cin + ((size_t)f * W + c) * D;
  };
  auto row_of = [&](int t) { return a.reverse ? H - 1 - t : t; };
  // the block's columns of scan row t in a volume: one contiguous run
  auto slab = [&](const float* v, int t) {
    return v + ((size_t)row_of(t) * W + c_lo) * D;
  };
  const size_t slab_n = (size_t)nc * D;
  // the thread that stages rows and publishes the block's progress: the
  // first warp of an interior column, which waits on no neighbour (the
  // edge columns' warps set a row's pace)
  const int issuer = nc >= 3 && G * nc <= nwarps ? 32 * G : 0;
  auto stage_row = [&](int t) {  // the issuer
    unsigned char* st = ring + (size_t)(t % S) * L.stage;
    stage_run(st, slab(a.cv, t), slab_n, &bars[t % S]);
    if (stage_acc) stage_run(st + L.slot, slab(a.acc, t), slab_n, &bars[t % S]);
  };
  if (S > 0 && threadIdx.x == issuer) {
    // one arrival a copy: the issuer's expect_tx per slab
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], stage_acc ? 2 : 1);
    mbar_init_fence();
    for (int s = 0; s < S && s < H; ++s) stage_row(s);
  }
  __syncthreads();

  for (int t = 0; t < H; ++t) {
    const int i = row_of(t);
    const int ig = a.i0 + i;  // the global row
    const int wb = t & 1, rb = wb ^ 1;
    const bool last = t == H - 1;
    const float* cvr = slab(a.cv, t);
    const float* acr = a.acc ? slab(a.acc, t) : nullptr;
    if (S > 0) {
      const unsigned char* st = ring + (size_t)(t % S) * L.stage;
      mbar_wait(&bars[t % S], (unsigned)(t / S) & 1u);
      cvr = staged(st, cvr);
      if (stage_acc) acr = staged(st + L.slot, acr);
    }
    for (int u = warp; u < nc * G; u += nwarps) {
      const int lc = u / G, g = u - lc * G, c = c_lo + lc;
      const int d_lo = g * SP * 32, d_hi = min(D, d_lo + SP * 32);
      // the previous row's carry of family f at column cs and its min; a
      // diagonal family may read the neighbour block's edge column
      auto prev_of = [&](int f, int cs) -> Prev {
        if (cs < 0 || cs >= W) return {nullptr, 0.f};
        if (t == 0) {
          const float* p = cin_at(f, cs);
          return {p, carry_min(p, D, lane)};
        }
        if (cs >= c_lo && cs < c_hi) {
          const float* p = car(rb, f, cs - c_lo);
          return {p, mins_on ? parts_min(pmin(rb, f, cs - c_lo), G)
                             : carry_min(p, D, lane)};
        }
        // wait until the neighbour block has finished row t - 1, then copy
        // this part's range (and one float each side) of its edge carry
        const int nb = cs < c_lo ? b - 1 : b + 1;
        while (ld_acquire(a.flags + nb) < t) {
        }
        const int e_lo = max(d_lo - 1, 0), n = min(d_hi + 1, D) - e_lo;
        const float* e = edg(rb, f, cs) + e_lo;
        float* h = halo + (f - 1) * hslot + (g ? d_lo + 2 * g - 1 : 0);
        // every load in flight at once: the parts' minima (lane q, part q)
        // and the range, HALO_U slices at a time, through L2
        float m = (mins_on && lane < G) ? __ldcg(edg_min(rb, f, cs) + lane)
                                        : INFINITY;
        for (int d0 = lane; d0 < n; d0 += 32 * HALO_U) {
          float v[HALO_U];
#pragma unroll
          for (int k = 0; k < HALO_U; ++k)
            v[k] = d0 + 32 * k < n ? __ldcg(e + d0 + 32 * k) : 0.f;
#pragma unroll
          for (int k = 0; k < HALO_U; ++k)
            if (d0 + 32 * k < n) h[d0 + 32 * k] = v[k];
        }
        m = warp_min(m);
        __syncwarp();
        if (!mins_on) m = carry_min(h, D, lane);  // G = 1: the whole carry
        return {h - e_lo, m};
      };
      const Prev v = prev_of(0, c);
      const float* pv = v.p;
      const float mv = v.m;
      const float *pp = nullptr, *pn = nullptr;
      float mp = 0.f, mn = 0.f, mult_p = 1.f, mult_n = 1.f;
      if (DIAG) {
        // pos: forward from column c-1, reverse from c+1; neg mirrored
        const Prev q = prev_of(1, a.reverse ? c + 1 : c - 1);
        const Prev n = prev_of(2, a.reverse ? c - 1 : c + 1);
        pp = q.p;
        mp = q.m;
        pn = n.p;
        mn = n.m;
        if (c == (a.reverse ? W - a.H_img + ig : ig)) mult_p = 2.f;
        if (c == (a.reverse ? a.H_img - 1 - ig : W - 1 - ig)) mult_n = 2.f;
      }
      const bool at_edge = DIAG && (lc == 0 || lc == nc - 1);
      const float* cvc = cvr + (size_t)lc * D;
      const float* acc_c = acr ? acr + (size_t)lc * D : nullptr;
      const size_t pix = ((size_t)i * W + c) * D;
      float* cw_v = car(wb, 0, lc);
      float* co = (last && a.cout) ? a.cout + (size_t)c * D : nullptr;
      const size_t fs = (size_t)W * D;  // cout's family stride
      float lv = INFINITY, lp = INFINITY, ln = INFINITY;
      for (int d0 = d_lo + lane; d0 < d_hi; d0 += 32 * ROW_U) {
        float bs[ROW_U], as[ROW_U];  // issue the slices' loads first
#pragma unroll
        for (int k = 0; k < ROW_U; ++k) {
          const int d = d0 + 32 * k;
          bs[k] = d < d_hi ? cvc[d] : 0.f;
          as[k] = (acc_c && d < d_hi) ? acc_c[d] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < ROW_U; ++k) {
          const int d = d0 + 32 * k;
          if (d >= d_hi) break;
          const float base = bs[k];
          const float pout = a.col0 + c + d >= a.W_pout ? a.Pout : 0.f;
          float total = as[k];
          const float av = step_adj(pv, d, D, mv, a.P1, a.P2, pout);
          const float nv = __fadd_rn(base, av);
          cw_v[d] = nv;
          lv = fminf(lv, nv);
          if (co) co[d] = nv;
          total = __fadd_rn(total, av);
          if (DIAG) {
            const float ap = step_adj(pp, d, D, mp, a.P1, a.P2, pout);
            const float an = step_adj(pn, d, D, mn, a.P1, a.P2, pout);
            const float cp = __fadd_rn(base, ap), cn = __fadd_rn(base, an);
            car(wb, 1, lc)[d] = cp;
            car(wb, 2, lc)[d] = cn;
            lp = fminf(lp, cp);
            ln = fminf(ln, cn);
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
          a.out[pix + d] = total;
        }
      }
      if (mins_on) {
        lv = warp_min(lv);
        if (DIAG) {
          lp = warp_min(lp);
          ln = warp_min(ln);
        }
        if (lane == 0) {
          pmin(wb, 0, lc)[g] = lv;
          if (DIAG) {
            pmin(wb, 1, lc)[g] = lp;
            pmin(wb, 2, lc)[g] = ln;
            if (at_edge) {
              edg_min(wb, 1, c)[g] = lp;
              edg_min(wb, 2, c)[g] = ln;
            }
          }
        }
      }
    }
    __syncthreads();  // row i's carries complete, the stage read
    if (threadIdx.x == issuer) {
      // publish row t to the neighbours: the release store orders the
      // block's writes, which the barrier ordered before the issuer's
      if (DIAG && gridDim.x > 1) st_release(a.flags + b, t + 1);
      if (S > 0 && t + S < H) stage_row(t + S);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b columns
// ---------------------------------------------------------------------------

struct ColArgs {
  const float* cv;
  const float* acc;
  const float* knights;  // (n_knights, H, W, D), summed into acc in order
  float* out;            // may alias acc
  int* idx;
  float* bands;
  unsigned char* spill;  // null: the carries in shared memory; else one
                         // area of `area` bytes a line, in global memory
  size_t area;
  int n_knights, H, W, D, col0, W_pout;
  float P1, P2, Pout;
  int reverse, r, G, S;
};

// A column-scan block (one line, G warps): in shared memory S stages of
// (2 + n_knights) slots (the covers of one pixel's cv, acc and knight
// D-vectors), then its area: the two carries, with WTA two C vectors, then
// the parts' minima (2 x G carry minima; with WTA also G minima of C and G
// indices).  Past a block's shared memory the area lies in global memory
// (`spill`, S = 0).  ops/sgm_lane_cuda.cols_layout sums the same sizes.
__host__ __device__ inline size_t cols_area(int D, int G, bool wta) {
  return r16(sizeof(float) * (wta ? 4 : 2) * (size_t)D) +
         sizeof(float) * (wta ? 4 : 2) * (size_t)G;
}

__host__ __device__ inline size_t cols_vslot(int D) {
  return r16(sizeof(float) * (size_t)D + 15);
}

// K4b columns: one block scans one row (left to right, or right to left
// with `reverse`), G warps a part of D each, adding each column's
// adjustment into acc (out may alias acc), after the knight volumes
// (acc + k_0 + k_1 + ..., in order).  With WTA (reverse only) it writes
// idx and the bands instead.  S > 0: lanes 0 to 1 + n_knights of warp 0
// stage a pixel's vectors S steps ahead of the step, into the stage the
// step's barrier has just released.  SPILL: the area lies in global memory
// (`cols_area`, S = 0), a template argument as in K4d.  Each warp takes
// the min of its part of the new carry as it writes it; a step's barrier
// makes the carry and the parts' minima whole for the next.
template <bool WTA, bool SPILL>
__global__ void __launch_bounds__(32 * MAX_COLS_WARPS)
fused_cols_kernel(const ColArgs a) {
  extern __shared__ __align__(16) unsigned char col_smem[];
  __shared__ __align__(8) uint64_t col_bars[RING];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int i = blockIdx.x;
  const int W = a.W, D = a.D, S = a.S, nk = a.n_knights, G = a.G;
  const int nvec = 2 + nk;
  const size_t vslot = cols_vslot(D);
  const size_t stage = nvec * vslot;
  unsigned char* ring = col_smem;
  unsigned char* area =
      SPILL ? a.spill + (size_t)i * a.area : ring + (size_t)S * stage;
  float* bufs = reinterpret_cast<float*>(area);
  float* Cs = bufs + 2 * D;  // C at the last two pixels (WTA)
  float* cmin = reinterpret_cast<float*>(
      area + r16(sizeof(float) * (WTA ? 4 : 2) * D));
  float* Cmin = cmin + 2 * G;                          // WTA
  int* best_p = reinterpret_cast<int*>(Cmin + G);      // WTA
  const int SP = ((D + 31) / 32 + G - 1) / G;
  const int d_lo = g * SP * 32, d_hi = min(D, d_lo + SP * 32);
  const size_t vol = (size_t)a.H * W * D;
  auto pix_at = [&](int t) {
    return (size_t)i * W + (a.reverse ? W - 1 - t : t);
  };
  // vector q of pixel p: 0 cv, 1 acc, 2 + n knight volume n
  auto vec = [&](int q, size_t p) -> const float* {
    const float* v = q == 0 ? a.cv
                     : q == 1 ? a.acc
                              : a.knights + (size_t)(q - 2) * vol;
    return v + p * D;
  };
  auto stage_pix = [&](int t) {  // warp 0: lane q copies vector q
    if (g == 0 && lane < nvec)
      stage_run(ring + (size_t)(t % S) * stage + lane * vslot,
                vec(lane, pix_at(t)), D, &col_bars[t % S]);
  };
  if (S > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) mbar_init(&col_bars[s], nvec);
      mbar_init_fence();
    }
    __syncthreads();
    for (int s = 0; s < S && s < W; ++s) stage_pix(s);
  }
  const int nb = 2 * a.r + 1;
  for (int t = 0; t < W; ++t) {
    const int j = a.reverse ? W - 1 - t : t;
    const size_t p = pix_at(t);
    const float* prev = t ? bufs + ((t - 1) & 1) * D : nullptr;
    float* cur = bufs + (t & 1) * D;
    float* Ct = Cs + (t & 1) * D;
    // min over d of the previous carry (0: the line start)
    const float m = t ? parts_min(cmin + ((t - 1) & 1) * G, G) : 0.f;
    const unsigned char* st = ring + (size_t)(t % max(S, 1)) * stage;
    if (S > 0) mbar_wait(&col_bars[t % S], (unsigned)(t / S) & 1u);
    auto src = [&](int q) {
      const float* v = vec(q, p);
      return S > 0 ? staged(st + q * vslot, v) : v;
    };
    const float* cs = src(0);
    const float* as = src(1);
    float lm = INFINITY, lc = INFINITY;
    for (int d0 = d_lo + lane; d0 < d_hi; d0 += 32 * U) {
      float bs[U], ac[U];  // issue U slices' loads before any store
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int d = d0 + 32 * k;
        bs[k] = d < d_hi ? cs[d] : 0.f;
        ac[k] = d < d_hi ? as[d] : 0.f;
      }
      for (int q = 0; q < nk; ++q) {  // the knight volumes, in their order
        const float* kq = src(2 + q);
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int d = d0 + 32 * k;
          if (d < d_hi) ac[k] = __fadd_rn(ac[k], kq[d]);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int d = d0 + 32 * k;
        if (d >= d_hi) break;
        const float base = bs[k];
        const float pout = a.col0 + j + d >= a.W_pout ? a.Pout : 0.f;
        const float adj = step_adj(prev, d, D, m, a.P1, a.P2, pout);
        const float nc = __fadd_rn(base, adj);
        cur[d] = nc;
        lc = fminf(lc, nc);
        if (WTA) {
          const float C = __fadd_rn(__fadd_rn(ac[k], adj), base);
          Ct[d] = C;
          lm = fminf(lm, C);
        } else {
          a.out[p * D + d] = __fadd_rn(ac[k], adj);
        }
      }
    }
    lc = warp_min(lc);
    if (WTA) lm = warp_min(lm);
    if (lane == 0) {
      cmin[(t & 1) * G + g] = lc;
      if (WTA) Cmin[g] = lm;
    }
    __syncthreads();  // the carry, C and the parts' minima whole; the stage read
    if (S > 0 && t + S < W) stage_pix(t + S);  // the stage is read
    if (WTA) {
      const float mC = parts_min(Cmin, G);
      int best = -1;
      for (int d = d_lo + lane; d < d_hi; d += 32)  // ascending d: the last hit
        if (Ct[d] == mC) best = d;
      best = warp_max(best);
      if (lane == 0) best_p[g] = best;
      __syncthreads();  // every part's last hit
      if (g == 0) {
        for (int q = 0; q < G; ++q) best = max(best, best_p[q]);  // ties: LAST
        for (int s = lane; s < nb; s += 32) {
          const int qd = best + s - a.r;
          a.bands[p * nb + s] =
              s == a.r ? mC : (qd >= 0 && qd < D ? Ct[qd] : INFINITY);
        }
        if (lane == 0) a.idx[p] = best;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4d
// ---------------------------------------------------------------------------

struct ChunkArgs {
  const float* cv;
  const float* acc;   // may alias out; null: the sweep writes out afresh
  float* out;
  float* hist;        // (n_w, H, D) boundary carries of every row
  float* hist_min;    // (n_w, H, G) their parts' minima
  int* flags;         // rows done, one counter a chunk, then the ticket
  unsigned char* spill;  // null: each block's area in shared memory; else
                         // one area of `area` bytes a block, in global memory
  size_t area;
  int H, W, D, cw, n_w, G, use_mins, col0, W_pout;
  float P1, P2, Pout;
  int reverse, shift_down, corner_c0, corner_slope;
};

// K4d: one sweep (down, or up with `reverse`) of one diagonal family
// (DIAG) and, with VERT, the vertical direction, over a region cut into
// chunks of cw columns, one block a chunk, all chunks in one launch.
// shift_down: the diagonal carry moves to higher columns each row, so a
// chunk's first column continues the left chunk's last column (its
// upstream chunk); otherwise the mirror.  A block takes its chunk from a
// ticket in the flow's order, so it only ever waits on a chunk that a
// block already running holds.  The doubled corner line is at region
// column corner_c0 + corner_slope * i.  The block's area (carries, halo,
// parts' minima: `row_layout` with no ring) is its shared memory or, with
// SPILL (past a block's shared memory), its own slice of a global buffer:
// the row's __syncthreads orders global memory within the block as it
// does shared.  SPILL is a template argument so that the shared instance
// keeps shared-memory instructions (a pointer that may be either is
// generic, and measured slower at 4K).
template <bool VERT, bool DIAG, bool SPILL>
__global__ void __launch_bounds__(32 * ROW_WARPS, 1)
chunked_sweep_kernel(const ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  __shared__ int ticket_s;
  constexpr int NF = (VERT ? 1 : 0) + (DIAG ? 1 : 0);
  constexpr int FD = VERT ? 1 : 0;  // the diagonal family's carries
  const int H = a.H, W = a.W, D = a.D, cw = a.cw, G = a.G;
  const bool mins_on = a.use_mins != 0;
  const RowLayout L =
      row_layout(cw, D, G, 0, NF, DIAG ? 1 : 0, false, mins_on);
  unsigned char* area =
      SPILL ? a.spill + (size_t)blockIdx.x * a.area : chunk_smem;
  float* car_s = reinterpret_cast<float*>(area);
  float* halo = reinterpret_cast<float*>(area + L.halo);
  float* mins = reinterpret_cast<float*>(area + L.mins);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) ticket_s = atomicAdd(a.flags + a.n_w, 1);
  __syncthreads();
  const int ticket = ticket_s;
  const int w = a.shift_down ? ticket : a.n_w - 1 - ticket;
  const int up = a.shift_down ? w - 1 : w + 1;  // the chunk this continues
  const bool has_up = DIAG && up >= 0 && up < a.n_w;
  const bool has_down = DIAG && (a.shift_down ? w + 1 < a.n_w : w > 0);
  const int c_lo = w * cw, nc = min(cw, W - c_lo);
  const int lc_in = a.shift_down ? 0 : nc - 1;   // continues `up`'s carry
  const int lc_out = a.shift_down ? nc - 1 : 0;  // its carry goes downstream
  const int SP = ((D + 31) / 32 + G - 1) / G;    // 32-wide slices a part
  auto car = [&](int buf, int f, int lc) {
    return car_s + ((size_t)(buf * NF + f) * cw + lc) * D;
  };
  auto pmin = [&](int buf, int f, int lc) {
    return mins + ((size_t)(buf * NF + f) * cw + lc) * G;
  };
  auto row_of = [&](int t) { return a.reverse ? H - 1 - t : t; };

  for (int t = 0; t < H; ++t) {  // scan row t, image row i
    const int i = row_of(t);
    const int wb = t & 1, rb = wb ^ 1;
    const int cj = a.corner_c0 + a.corner_slope * i - c_lo;
    // the chunk's columns of row i: one contiguous run in each volume,
    // read through generic loads (`opaque`)
    const size_t row0 = ((size_t)i * W + c_lo) * D;
    const float* cvr = opaque(a.cv + row0);
    const float* acr = a.acc ? opaque(a.acc + row0) : nullptr;
    for (int u = warp; u < nc * G; u += nwarps) {
      const int lc = u / G, g = u - lc * G, c = c_lo + lc;
      const int d_lo = g * SP * 32, d_hi = min(D, d_lo + SP * 32);
      // the previous row's carries and their minima (null: a zero carry,
      // the line start)
      const float *pv = nullptr, *pd = nullptr;
      float mv = 0.f, md = 0.f;
      if (VERT && t > 0) {
        pv = car(rb, 0, lc);
        mv = mins_on ? parts_min(pmin(rb, 0, lc), G) : carry_min(pv, D, lane);
      }
      if (DIAG && t > 0 && lc != lc_in) {
        const int ls = a.shift_down ? lc - 1 : lc + 1;
        pd = car(rb, FD, ls);
        md = mins_on ? parts_min(pmin(rb, FD, ls), G)
                     : carry_min(pd, D, lane);
      } else if (DIAG && t > 0 && has_up) {
        // wait until the upstream chunk has finished row t - 1, then copy
        // this part's range (and one float each side) of its boundary
        // carry, and the parts' minima, through L2
        while (ld_acquire(a.flags + up) < t) {
        }
        const size_t hr = (size_t)up * H + (t - 1);
        const int e_lo = max(d_lo - 1, 0), n = min(d_hi + 1, D) - e_lo;
        const float* e = a.hist + hr * D + e_lo;
        float* h = halo + (g ? d_lo + 2 * g - 1 : 0);
        float m = (mins_on && lane < G) ? __ldcg(a.hist_min + hr * G + lane)
                                        : INFINITY;
        for (int d0 = lane; d0 < n; d0 += 32 * HALO_U) {
          float v[HALO_U];
#pragma unroll
          for (int k = 0; k < HALO_U; ++k)
            v[k] = d0 + 32 * k < n ? __ldcg(e + d0 + 32 * k) : 0.f;
#pragma unroll
          for (int k = 0; k < HALO_U; ++k)
            if (d0 + 32 * k < n) h[d0 + 32 * k] = v[k];
        }
        m = warp_min(m);
        __syncwarp();
        pd = h - e_lo;
        md = mins_on ? m : carry_min(halo, D, lane);  // G = 1: all of D
      }
      const bool feeds = has_down && lc == lc_out;
      const float mult = lc == cj ? 2.f : 1.f;
      const float* cvc = cvr + (size_t)lc * D;
      const float* acc_c = acr ? acr + (size_t)lc * D : nullptr;
      const size_t pix = ((size_t)i * W + c) * D;
      float* hout = feeds ? a.hist + ((size_t)w * H + t) * D : nullptr;
      float lv = INFINITY, ld = INFINITY;
      for (int d0 = d_lo + lane; d0 < d_hi; d0 += 32 * ROW_U) {
        float bs[ROW_U], as[ROW_U];  // issue the slices' loads first
#pragma unroll
        for (int k = 0; k < ROW_U; ++k) {
          const int d = d0 + 32 * k;
          bs[k] = d < d_hi ? cvc[d] : 0.f;
          as[k] = (acc_c && d < d_hi) ? acc_c[d] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < ROW_U; ++k) {
          const int d = d0 + 32 * k;
          if (d >= d_hi) break;
          const float base = bs[k];
          const float pout = a.col0 + c + d >= a.W_pout ? a.Pout : 0.f;
          float total = as[k];
          if (VERT) {
            const float av = step_adj(pv, d, D, mv, a.P1, a.P2, pout);
            const float nv = __fadd_rn(base, av);
            car(wb, 0, lc)[d] = nv;
            lv = fminf(lv, nv);
            total = __fadd_rn(total, av);
          }
          if (DIAG) {
            const float ad = step_adj(pd, d, D, md, a.P1, a.P2, pout);
            const float nd = __fadd_rn(base, ad);
            car(wb, FD, lc)[d] = nd;
            ld = fminf(ld, nd);
            if (hout) hout[d] = nd;
            total = __fadd_rn(total, __fmul_rn(ad, mult));
          }
          a.out[pix + d] = total;
        }
      }
      if (mins_on) {  // each part's minimum of its new carries
        if (VERT) lv = warp_min(lv);
        if (DIAG) ld = warp_min(ld);
        if (lane == 0) {
          if (VERT) pmin(wb, 0, lc)[g] = lv;
          if (DIAG) pmin(wb, FD, lc)[g] = ld;
          if (feeds) a.hist_min[((size_t)w * H + t) * G + g] = ld;
        }
      }
    }
    __syncthreads();  // the chunk's row complete
    // publish row t downstream: the release orders the block's writes,
    // which the barrier ordered before thread 0's
    if (threadIdx.x == 0 && has_down) st_release(a.flags + w, t + 1);
  }
}

template <bool SPILL>
const void* chunked_fn(bool vert, bool diag) {
  return !vert  ? (const void*)chunked_sweep_kernel<false, true, SPILL>
         : diag ? (const void*)chunked_sweep_kernel<true, true, SPILL>
                : (const void*)chunked_sweep_kernel<true, false, SPILL>;
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
// is rows [i0, i0 + H) of an image H_img rows high.  edge: (2, 2, W, D + G)
// floats (the edge carries, then their parts' minima) and flags: one int a
// block, zero, both for diagonal sweeps.  ncols, G (parts a column), S
// (ring stages), stage_acc and use_mins: ops/sgm_lane_cuda.row_layout.
extern "C" int fused_rows_launch(const void* cv, const void* acc, void* out,
                                 void* edge, void* flags, const void* cin,
                                 void* cout, int H, int W, int D, int ncols,
                                 int G, int S, int stage_acc, int use_mins,
                                 int col0, int W_pout, float P1, float P2,
                                 float Pout, int reverse, int diag, int i0,
                                 int H_img, void* stream) {
  const int slices = (D + 31) / 32;
  if (bad_region(H, W, D, col0, W_pout) || ncols < 1 || i0 < 0 ||
      H_img < i0 + H || G < 1 || G > slices ||
      (G > 1 && ncols * G > ROW_WARPS) || S < 0 || S > RING ||
      (stage_acc && acc == nullptr) ||
      (G - 1) * ((slices + G - 1) / G) >= slices ||
      (diag && (edge == nullptr || flags == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (W + ncols - 1) / ncols;
  const int threads = 32 * min(ncols * G, ROW_WARPS);
  const size_t smem = row_layout(ncols, D, G, S, diag ? 3 : 1, diag ? 2 : 0,
                                 stage_acc, use_mins)
                          .total;
  const void* fn = diag ? (const void*)fused_rows_kernel<true>
                        : (const void*)fused_rows_kernel<false>;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  // a block waits on its neighbours: the grid must be resident at once
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
  RowArgs a;
  a.cv = static_cast<const float*>(cv);
  a.acc = static_cast<const float*>(acc);
  a.out = static_cast<float*>(out);
  a.edge = static_cast<float*>(edge);
  a.edge_min = edge ? a.edge + (size_t)4 * W * D : nullptr;
  a.flags = static_cast<int*>(flags);
  a.cin = static_cast<const float*>(cin);
  a.cout = static_cast<float*>(cout);
  a.H = H;
  a.W = W;
  a.D = D;
  a.ncols = ncols;
  a.G = G;
  a.S = S;
  a.stage_acc = stage_acc;
  a.use_mins = use_mins;
  a.col0 = col0;
  a.W_pout = W_pout;
  a.P1 = P1;
  a.P2 = P2;
  a.Pout = Pout;
  a.reverse = reverse;
  a.i0 = i0;
  a.H_img = H_img;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// knights: null, or n_knights (<= 8) volumes (n, H, W, D) added to acc in
// order before the scan.  G (warps a line) and S (ring stages; 0: direct
// loads): ops/sgm_lane_cuda.cols_layout; spill: null, or H areas of
// r16(`cols_area`) bytes in global memory (then S = 0).
extern "C" int fused_cols_launch(const void* cv, const void* acc,
                                 const void* knights, int n_knights,
                                 void* out, void* idx, void* bands,
                                 void* spill, int H, int W, int D, int col0,
                                 int W_pout, float P1, float P2, float Pout,
                                 int reverse, int r, int wta, int G, int S,
                                 void* stream) {
  const int slices = (D + 31) / 32;
  if (bad_region(H, W, D, col0, W_pout) || (wta && (!reverse || r < 0)) ||
      n_knights < 0 || n_knights > MAX_KNIGHTS ||
      (n_knights > 0 && knights == nullptr) || S < 0 || S > RING ||
      (spill != nullptr && S > 0) || G < 1 || G > MAX_COLS_WARPS ||
      G > slices || (G - 1) * ((slices + G - 1) / G) >= slices)
    return (int)cudaErrorInvalidValue;
  const size_t area = cols_area(D, G, wta);
  const size_t smem = (size_t)S * (2 + n_knights) * cols_vslot(D) +
                      (spill ? 0 : area);
  if (smem > (size_t)COLS_SMEM) return (int)cudaErrorInvalidValue;
  const void* fn =
      spill ? (wta ? (const void*)fused_cols_kernel<true, true>
                   : (const void*)fused_cols_kernel<false, true>)
            : (wta ? (const void*)fused_cols_kernel<true, false>
                   : (const void*)fused_cols_kernel<false, false>);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  ColArgs a;
  a.cv = static_cast<const float*>(cv);
  a.acc = static_cast<const float*>(acc);
  a.knights = static_cast<const float*>(knights);
  a.out = static_cast<float*>(out);
  a.idx = static_cast<int*>(idx);
  a.bands = static_cast<float*>(bands);
  a.spill = static_cast<unsigned char*>(spill);
  a.area = r16(area);
  a.n_knights = n_knights;
  a.H = H;
  a.W = W;
  a.D = D;
  a.col0 = col0;
  a.W_pout = W_pout;
  a.P1 = P1;
  a.P2 = P2;
  a.Pout = Pout;
  a.reverse = reverse;
  a.r = r;
  a.G = G;
  a.S = S;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(fn, dim3(H), dim3(32 * G), args, smem,
                               static_cast<cudaStream_t>(stream));
}

// hist: null, or n_w x H x (D + G) floats with the diagonal (every row's
// boundary carries, then their parts' minima); flags: n_w + 1 ints, zero
// (the chunks' row counters, then the ticket); spill: null (each block's
// area in shared memory), or n_w areas of r16(`row_layout`'s total) bytes
// in global memory.  cw, G and use_mins: ops/sgm_lane_cuda.chunk_layout.
extern "C" int chunked_sweep_launch(const void* cv, const void* acc,
                                    void* out, void* hist, void* flags,
                                    void* spill, int H, int W, int D, int cw,
                                    int G, int use_mins, int col0,
                                    int W_pout, float P1, float P2,
                                    float Pout, int reverse, int shift_down,
                                    int corner_c0, int corner_slope,
                                    int with_vertical, int with_diag,
                                    void* stream) {
  const int slices = (D + 31) / 32;
  if (bad_region(H, W, D, col0, W_pout) || cw < 1 || G < 1 || G > slices ||
      G > 32 || (G > 1 && !use_mins) ||
      (G - 1) * ((slices + G - 1) / G) >= slices || flags == nullptr ||
      !(with_vertical || with_diag) || (with_diag && hist == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_w = (W + cw - 1) / cw;
  const int nf = (with_vertical ? 1 : 0) + (with_diag ? 1 : 0);
  const int threads = 32 * min(cw * G, ROW_WARPS);
  const size_t area =
      row_layout(cw, D, G, 0, nf, with_diag ? 1 : 0, false, use_mins).total;
  const size_t smem = spill ? 0 : area;
  const void* fn = spill ? chunked_fn<true>(with_vertical, with_diag)
                        : chunked_fn<false>(with_vertical, with_diag);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  ChunkArgs a;
  a.cv = static_cast<const float*>(cv);
  a.acc = static_cast<const float*>(acc);
  a.out = static_cast<float*>(out);
  a.hist = static_cast<float*>(hist);
  a.hist_min = hist ? a.hist + (size_t)n_w * H * D : nullptr;
  a.flags = static_cast<int*>(flags);
  a.spill = static_cast<unsigned char*>(spill);
  a.area = r16(area);
  a.H = H;
  a.W = W;
  a.D = D;
  a.cw = cw;
  a.n_w = n_w;
  a.G = G;
  a.use_mins = use_mins;
  a.col0 = col0;
  a.W_pout = W_pout;
  a.P1 = P1;
  a.P2 = P2;
  a.Pout = Pout;
  a.reverse = reverse;
  a.shift_down = shift_down;
  a.corner_c0 = corner_c0;
  a.corner_slope = corner_slope;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(fn, dim3(n_w), dim3(threads), args, smem,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
