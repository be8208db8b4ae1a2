"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from ``libstevi_tpu_torch/csrc`` and holds
each kernel against its plain PyTorch version: K1's window statistics and
box cost volume bit for bit (every dot-family cost at the flagship shape,
and on a pair with flat patches, where ZNCC cancels), K2 SGM
pass, K2k knight-direction volumes (all 8 directions in two launches, run
twice, bit for bit against the plain lane form; added in order onto the
7 directions' accumulator, and through the one-direction memory fallback,
bit for bit) and K3 SGM pass + WTA at the flagship shape, at an odd
shape and at D=300 (40x360), in float32 and bfloat16, and at the HD path's
shape (720x1280, D=320) in bfloat16, and at each the WTA path's one-launch
forms (the 7 K2 directions in one launch, a volume each, K3 summing them in
order; SGM-16's 15 volumes, the 8 knight volumes after them) bitwise
against the sequential accumulator and against the plain versions; the
SGM entries with margins against the CPU; K5 feature-volume cost volume at
the WTA path's
shape (480x640, D=120, F=49 and an RGB F=147) and at an odd shape
(LEFT_TO_RIGHT, an offset search, an RGB F=147 input: the register-tiled
instance; a shift list of step 2: the general one); K6 PatchMatch sweep (its three launches) and
K7 probe and search probe, exactly, on the 480x640x120 NCC volume, K6 also
on a flood whose run crosses 2/3 of every line and at edge shapes (one and
two lines, 45 chains, lower < 0, +inf and ties, costs not the volume's
own); the lane-layout SGM kernels past D = 320,
bitwise: K4a shear / unshear (both signs), K4b's row sweeps, column scans
and WTA scan at the wide path's 480x640x384 f32 volume, at 37x101x333 and
(after the HD wide path) at its 720x1280x640 volume, with the
separate-accumulation mode within 1e-4, and K4d's four sweep kinds (one
launch each, all chunks) at 40x300x352 with the card's chunk width and with
150 chunks, more than the SMs; K4d's sweeps, K4b's forward and WTA column
scans and K2k's knights at 6x40x29000, past a block's shared memory (their
carries in global memory); and K1 at D=640, bit for bit.  The
redesigned K4b row sweep, K4c and the column scans (with a stack of 0, 1
and 8 knight volumes) are held bitwise, two runs equal, at 480x640x384,
720x1280x640, 37x101x333, H = 1, W < 132 and in the direct-load instance,
and the ring instance each geometry takes is printed.  Then it runs its
paths,
each with the launch counts set to 0 just before it and read just after:
- the flagship stereo path (`entry.flagship_forward`: 480x640, D=120,
  ZNCC 7x7, bf16 volume, SGM-8, parabola subpixel) on the two committed
  parity fixtures, held to accuracy bars against their ground truth, and a
  random pair;
- SGM-16 (`entry.sgm16_forward`: the same with 16 directions and an f32
  volume; K1, K2x7, K2k's knight volumes and K3 over the 15 volumes), on
  the same three pairs, held to the
  `PARITY_r05` `zncc_sgm16_f32` bars; a bfloat16 request must give the
  float32 result;
- census + SGM-8 (`entry.census_sgm_forward`) on the fixtures, held to the
  `census_sgm8` bars;
- HD (`entry.hd_forward`: 720x1280, D=320, bf16 volume, SGM-8) on a random
  pair;
- PatchMatch (`entry.patchmatch_forward`: NCC 7x7, D=120, 5 iterations, 4
  random candidates) on the fixtures, held to bars;
- the WTA matcher with ZSAD (`entry.wta_forward`), which K5 carries, on the
  fixtures (no bar: the JAX package's parity record has no ZSAD row);
- wide (`entry.wide_forward`: 480x640, D=384, f32 volume, SGM-8), the path
  of K4b, on the fixtures and a random pair, its idx
  held to the plain route's on the card (no bar: no PARITY row at D=384);
- HD wide (`entry.hd_wide_forward`: 720x1280, D=640), K4b again, since its
  carries fit on chip too (155 KiB a block), on a random pair;
- K4d at HD wide size: `sgm_lane_cuda.chunked_adj` called directly on the
  HD D=640 volume (4 launches), then WTA and subpixel, and again ending in
  K4b's WTA scan, held to that chain's indices off near-ties (no public
  entry takes K4d at that size on an H100); it and `fused_adj` are held to
  the plain direction sum on the card at 1e-4;
- the route cross-check: on the fixtures at D=120 f32, `fused_adj` and a
  forced `chunked_adj` equal K2's direction sum and, ending in the WTA
  scan, give the K2/K3 route's idx off near-ties, each held to the
  `zncc_sgm8_f32` bars;
- 4K UHD (`entry.uhd_wide_forward`: 2160x3840, D=384, f32, SGM-8) on a
  random pair: K1 1, K4d 4, K4b's rows 0, column scans 2 launches, the
  parabola held as on the other random pairs, its frame time, peak memory
  and profile; K4d's four sweeps on that volume bitwise against their
  plain version, and timed; K4b's forward, WTA and reverse column scans on
  the K4d sums and K1 on that pair, bitwise;
- the distributed paths (`libstevi_tpu_torch.parallel`) on 8 virtual
  shards of the card, after K2s (on a 60x640x120 row shard and a
  480x80x120 column shard), K4c (on a 120x640x384 row shard), the any-D
  K2k (480x640x384, the 8 knight volumes bitwise, and their ordered sum),
  the any-D K2 (120x160x330, 7 passes, f32 and bf16,
  at 1e-4) and K2s at D=330 (bitwise), and K2 (1e-4) and K2s (bitwise)
  on 12x64 shards at the first D of each instance of `pass_layout` (321,
  1025: registers; 8193, 9641: shared carries; 28545: device carries;
  the layout of each launch as its launcher reports it), and the 7 K2
  passes of 480x640x384 into one accumulator (1e-4), are held to their
  plain versions:
  SGM-8 and SGM-16 over the flagship geometry's row shards (480x640x120,
  tile 8; K2s), SGM-8 at 480x640x384 (tile 4; K4c) and SGM-16 there (K4c
  and the knight relays through K2s), each volume equal to the
  single-device route's bitwise; `distributed_full_step` on a (2, 2, 2)
  mesh and `distributed_dense_stereo_step` on (2, 4) over the two
  fixtures as a batch of 2, indices held to the single-device route's at
  >= 0.999 agreement; `entry.dryrun_multichip(8)`; SGM-4/8/16 at
  48x64x330 (tile 4; K2 and K2s past D = 320) against the CPU at 1e-4;
  SGM-8/16 at 48x64x9641 and 8x16x28545 (tile 4; the any-D K2's shared
  and device instances) through `distributed_sgm_routed`, bitwise against
  the plain passes;
- the distributed 4K UHD step (`distributed_dense_stereo_step`, batch 1,
  tile 4 of the one card: 2160x3840, ZNCC 7x7, D=384, SGM-8): K4c's
  carries do not fit, so K1 and the K2s engine's any-D K2 run it (8
  `sgm_pass` and 24 `sgm_shard_pass` launches, asserted); its disparities
  equal a (1, 1) mesh's and agree with the single-device lane route's on
  >= 0.999 of pixels; its frame time, device items, idle share and peak
  memory; on one 540x3840x384 row shard of its volume, K2 left to right
  within 1e-4 of its plain pass and K2s top to bottom and along a
  diagonal from random carries bitwise (rings of 2 stages);
- SGM-16 at D=384 (`dense_sgm_stereo`: K1, K4b and the any-D K2k) on a
  random pair;
- `aggregate_cost` 'auto' with ZSAD r=5 (F=121) over D=448, past K5's
  tile: the shifted-compare loop on the card, against the CPU.
- the matchers ported last (`matchers`): the hierarchical matcher
  (`entry.hierarchical_forward`: ZNCC 7x7, D=120, depth 2, 480x640) on
  both fixtures, held to the `hierarchical_d2` bars with one K1
  statistics and one K1 volume launch a frame; HD depth 3
  (`entry.hierarchical_hd_forward`: 720x1280, D=320) and ZSAD depth 2
  (one K5 launch) on random pairs against the CPU (disp_estimate equal on
  >= 0.999, the truncated volume within 1e-4 where equal), each frame
  timed with its peak memory and device items; the 2-D volume (240x320,
  (-8..8) x (-8..8)) with its 2-D WTA, band and refinement,
  `patch_match_flow` (CENSUS, one replayed draw stream), `dp_stereo`,
  `fastmatch_from_cv` and `fastmatch` (CENSUS) at 480x640, D=120, and
  guided aggregation of a 480x640x120 volume, each timed and held to the
  CPU; the CLI's `--matcher hierarchical --refine parabola` on both
  fixtures at the same bars;
- the feature-space subpixel refinement (`refine`):
  `entry.stereo_refine_forward` (ZNCC 7x7, D=120) by its three methods
  (barycentric, barycentric-symmetric, cost-symmetric) on both fixtures,
  one K5 launch a frame, held to the JAX package's CPU bars
  (`REFINE_BARS`) and to the CPU run of the same call (within 1e-3 px on
  >= 0.999 of the pixels, < 1 px where the two runs' WTA indices agree,
  which they do on >= 0.999), each frame timed, profiled and its peak
  memory; SAD (the L1 IRLS) and SSD (K5) and MEDAD (no kernel) at
  480x640, MEDAD held to the CPU on the 96x128 fixtures; the arbitrary
  interpolation at n_pixels_cut = 100 (chunks of 16 candidates) with its
  peak memory, held to the CPU on a 96x128 crop; the optical-flow chain
  (240x320 over (-8..8)^2) against the CPU; both refinement CLIs against
  their `--device cpu` runs; and
  `optim` at users' sizes, each against the CPU: L0 of a 480x640x3
  image, Gauss-Newton and RANSAC (30% outliers) over 1M points, the
  distributed Gauss-Newton on 8 virtual shards of 1M residuals against
  the single-device fit (1e-5), the Schur solve at P = 360, k = 200000,
  s = 3 against its block system; and `small_lstsq` against a batched
  `torch.linalg.svd`;
- `geometry` (`geometry`): Gauss-Newton, relaxed and robust ray alignment
  over 1M ray pairs made as `cli/ray_alignment_eval.py` makes them (noise
  0.002, 10% outliers; robust with `draw_index_sets` shared with the CPU
  run), each held to its CPU run (1e-3) and timed with its peak memory,
  and on the unscrambled pairs to the JAX tool's robust medians; one
  minimal fit of the robust solver profiled; the test rig with Brown
  distortion (`RIG`) rectified at 480x640 (maps and resampled images
  against the CPU at 1e-3 px), the pair through the flagship (K1, K2x7,
  K3x7 counted) held to the CPU by the bf16 WTA rule (indices >= 0.999,
  bands at the bf16 bars, refined disparities < 0.1 px where the indices
  agree), the covering share to 1e-5, the maps, resampling and the
  rectified frame timed; the rig at 720x1280 through `hd_forward`; the
  ray-alignment CLI on the card against the JAX tool's report
  (`JAX_RAY_CLI`); and `ImageRectifier` in each ROI mode against the CPU;
- the sparse chain and calibration targets (`sparse`; torch ops, no
  kernel): the `tie_points` CLI on the 480x640 fixture (-n 256 --f 500,
  Harris and FAST) on the card and on the CPU, held to the JAX tool's
  counts (`JAX_TIE_POINTS`) and the card to the CPU (inliers; rotation and
  translation within 1e-4; the same RANSAC draws), and its pipeline timed
  warm with and without the pose; the chain at 4K UHD (`UHD_SPARSE`, a
  smoothed-noise pair shifted by `UHD_SHIFT`: Harris, NMS n = 1024 r = 4,
  the border cut, whitened descriptors, the host assignment) held to the
  shift (>= 0.95 of the matches within 1 px) and to JAX's keypoint counts
  (1%), with FAST, orientation, oriented descriptors and BRIEF on the same
  keypoints, each stage timed, the NMS profiled (idle share) with its peak
  memory; `detect_checkerboard` at 1080x1920 (`BOARD`: the 13x8 grid, 104
  corners within `BOARD_BARS` of the ground truth and 1e-3 px of the CPU
  run; response, candidates, fit and call timed; the CLI on both
  devices); and hex targets, connected components (queen, rook), edges
  and the median filter (r = 1, 2) at 1080x1920, exactly against the CPU,
  with the sweeps each fixed point took;
- the pipelines (`pipelines`): `entry.bg_fg_forward` after
  `entry.bg_fg_background` at 1080x1920, D = 192, ZNCC r = 3 on
  `entry.bg_fg_scene` (K5 launched exactly twice: background and live
  volume, and held to its plain version at that shape), the mask held to
  the pasted rectangle (>= 0.95 inside, <= 0.01 outside), the card to the
  port's CPU run on a crop across the rectangle's edge (mask and
  disparities equal wherever the WTA indices agree within the rule's reach
  and the ratio is off the threshold), the `bg_fg_stereo` CLI on the same
  scene (2 K5 launches, the entry's disparities), and both 480x640
  fixtures with a rectangle pasted at disparity 100 (D = 120) against the
  CPU; `retinex_fft` at 1080x1920 on a rendered dome against the CPU, the
  normal-map chain (`cli/normal_map_estimation.py`'s steps) at 1080x1920,
  each stage timed, held to the dome's true normals (the median angle,
  also with the input one ulp lower) and against the CPU at 68x120; the
  RGB non-local retinex at 96x96 (its O(N^2) clustering on the host)
  against the CPU;
  graph-cut segmentation at 1080x1920 (global and hierarchical, JAX's
  test rule >= 0.97), inpainting of a 200x300 hole and mean shift over
  16384 RGB features, against the CPU on a crop / the first 1024;
- the point clouds (`pointclouds`; torch ops and host C++, no kernel): a
  synthetic airborne LiDAR tile (`lidar_tile`: 1000 m x 1000 m, 2^24
  points, box buildings, a lake with no returns) written as LAS point
  format 1 by the port's `write_las_v2` and read back equal; the
  `points_cloud2depth_map` CLI on the card (a nadir view from 1500 m at
  1080x1920, `--inpaint`) held to the JAX tool's coverage
  (`JAX_POINTCLOUD`), its depth map to the port's CPU run (equal on >=
  0.9999 of pixels before inpainting, within 1e-3 m on >= 0.999 after);
  the `detrend_terrain` CLI (5 m tiles, a 200x200 raster) held to the JAX
  tool's report and its raster to the CPU's bit for bit (terrain within
  1e-5); `split_pt_cloud` (the own points partition the cloud),
  `io_pointcloud` info and a LAS -> PCD -> binary_compressed PCD (LZF) ->
  LAS round trip of 1M points, `stevimg_viewer` on the depth map (gray);
  `utils.profiling` on the projection (`device_time` within 20% of the
  phase's median, the roofline fraction <= 1.05, a trace naming the
  scatter kernel) and `utils.checkpointing` (6 Gauss-Newton steps stopped
  after 3 and resumed: the uninterrupted run's bits); each stage timed.
Each path also runs small against its plain version on the CPU, and the
port's CLI (`python -m libstevi_tpu_torch.cli.stereo_match --matcher sgm
--sgm-dirs 16`) runs as a subprocess on the warp fixture, held to the
SGM-16 bars, and again with ``-d 384``.  P2 < P1 runs small on the card
against the CPU.  It checks that each kernel was launched in its path,
times the frames and each kernel against its plain version (CUDA events,
median of 5), measures the flagship and HD frames' peak device memory,
times K2's two forms with K3 (one launch, or 7 launches into one
accumulator) from 480x640 to 2160x3840 with their peak memory and equal
outputs, and K3's two forms on SGM-16 (over the 15 volumes, or over their
sum), times K6 and K7 as calls and on the device (torch.profiler) beside their
sector floors, the any-D K2 a launch on 12x64 shards at the first D of
each instance, times K1's call, the flagship frame with its device items, the two
SGM-16 frames with theirs, K2k, K3, the distributed SGM-16 frame, the
wide and HD wide frames with their device items, K4b, K4c's relays, K4d's
`chunked_adj` at 480x640x384, the 4K UHD frame, the distributed 4K UHD
step (with its device items and peak memory), the any-D K2 a launch on
12x64xD shards (as a call and on the device) and its 7 passes at
480x640x384, K5 at 480x640x120 (F = 49 and 147, as a call and on the
device), the WTA ZSAD frame, and the PatchMatch frame
with its device items, K6's sweeps (480x640x120 and 720x1280x320), K7
(K = 1, 4) and the random search's probe step as the checkout runs them
(and, with ``--parent DIR``, a checkout of another commit, that one's too,
in turns: parent, change, change, parent; first, while the card is empty),
and
prints one JSON line of kernel records (each with its
least time on the card, ``bound_ms``, from this run's shapes), the card's
name and power limit, the script's wall time, and a last JSON line ``{"ok": true, "device": ...}``.  Any
failed check raises: the exit code is then non-zero and no result line is
printed.  There is no CPU path.  The CPU runs of the full-size refinement
holds and of the point-cloud phase (`CPU_JOBS`) go to a second Python
process, started after the build and ended with the script.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "data" / "parity"
try:
    from libstevi_tpu_torch.utils.profiling import (H100_HBM_BYTES_PER_S,
                                                    H100_PEAK_FLOPS_F32)
except ImportError:
    sys.exit("chip_smoke: libstevi_tpu_torch not found; run the script from "
             "a checkout of the repository")

# PARITY_r05.json, row zncc_sgm8_bf16 (480x640, D=120): prop_good_2.0 minus
# 0.001 and inlier_mae plus about 0.01
BARS = {"warp": ("", 0.9985, 0.14), "occluded": ("_occ", 0.9982, 0.21)}
# PARITY_r05.json, row patchmatch_ncc_5it: prop_good_2.0 minus 0.005 and
# inlier_mae plus 0.03 (the candidate stream differs from JAX's, so the
# match is statistical)
PM_BARS = {"warp": (0.9947, 0.2926), "occluded": (0.9734, 0.4397)}
# PARITY_r05.json, row zncc_sgm16_f32, set as the flagship's
SGM16_BARS = {"warp": (0.9986, 0.1474), "occluded": (0.9983, 0.2085)}
# PARITY_r05.json, row census_sgm8
CENSUS_BARS = {"warp": (0.9967, 0.1915), "occluded": (0.9388, 0.4475)}
# PARITY_r05.json, row zncc_sgm8_f32, set as the flagship's
F32_BARS = {"warp": (0.9985, 0.1392), "occluded": (0.9982, 0.209)}
# PARITY_r05.json, row hierarchical_d2: prop_good_2.0 minus 0.001 and
# inlier_mae plus 0.01
H_BARS = {"warp": (0.9651, 0.2766), "occluded": (0.9529, 0.4715)}
P1, P2, POUT = 0.1, 0.5, 100.0
# an H100 SXM's published peaks (NVIDIA's data sheet), written once in the
# port's `utils.profiling`: memory rate and f32 outside the tensor cores
HBM_BYTES_PER_MS = H100_HBM_BYTES_PER_S / 1e3
F32_FLOPS_PER_MS = H100_PEAK_FLOPS_F32 / 1e3
# f32 operations an SGM DP step spends per element and direction (the min
# reduction, two mins against m + P2 and the d +- 1 neighbours, + P1, the
# min, - m, + Pout, the new carry and the accumulation)
SGM_OPS = 9


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def pair(H, W, seed, dev):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(0, 1, (H, W))
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def median_ms(fn, reps=5, warmup=1):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_bars(tag, disp, gt, bars):
    """Hold a disparity map to (prop_good_2.0, inlier_mae) bars."""
    from libstevi_tpu_torch.statistics import prop_good, inlier_mae
    d = disp.cpu().numpy()
    pg, mae = prop_good(d, gt, 2.0), inlier_mae(d, gt, 2.0)
    pg_bar, mae_bar = bars
    print(f"  {tag}: prop_good_2.0 = {pg:.4f} (bar >= {pg_bar}), "
          f"inlier_mae = {mae:.4f} (bar <= {mae_bar})", flush=True)
    assert pg >= pg_bar and mae <= mae_bar, (tag, pg, mae)


def check_random(tag, disp, idx, D, h=3, v=3):
    """The parabola through a minimum moves it by at most half a pixel;
    inside the valid window and away from d = 0 and d = D-1 (where a band
    slot is NaN by rule) the disparity is finite.  Returns the finite
    share."""
    H, W = disp.shape
    inner = (slice(v, H - v), slice(h, W - h - D))
    mid = (idx[inner] > 0) & (idx[inner] < D - 1)
    dd = (disp[inner] - idx[inner].float())[mid]
    frac = torch.isfinite(dd).float().mean().item()
    assert frac > 0.999, (tag, frac)
    assert (dd[torch.isfinite(dd)].abs() <= 0.5 + 1e-5).all(), tag
    print(f"  {tag}: finite share {frac:.6f} where 0 < idx < D-1 in the "
          f"valid window, |disp - idx| <= 0.5", flush=True)
    return frac


def spilling_instances(report: str):
    """Kernel instances for which ptxas reported spill stores."""
    name, out = None, []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and "0 bytes spill stores" not in line:
            out.append(f"{name}: {line.strip()}")
    return out


def bound(nbytes, flops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 peak."""
    b, f = nbytes / HBM_BYTES_PER_MS, flops / F32_FLOPS_PER_MS
    return (b, "bytes") if b >= f else (f, "operations")


def close(got, want, tol=1e-4):
    """assert_close at rtol = atol = tol; returns the max abs error."""
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    return (got - want).abs().max().item()


def exact(got, want, tag):
    """Hold a kernel's output to its plain version's bit for bit; returns
    the max abs error (0.0)."""
    assert torch.equal(got, want), tag
    return 0.0


def k3_vs_plain(cv, acc, tag):
    """K3 over ``acc`` (one volume or a stack of direction volumes) against
    its plain version: idx equal away from near-ties (gap > 1e-4) and on
    >= 0.999 of the pixels, bands, the truncated volume's NaNs and disp
    within 1e-4 where idx agrees.  Returns the max abs error."""
    from libstevi_tpu_torch.ops.sgm import (SgmDirection, direction_adj,
                                            _tcv_from_bands)
    from libstevi_tpu_torch.ops.sgm_cuda import _acc_sum, sgm_wta, sgm_wta_plain
    H, W, D = cv.shape
    idx, bands, disp = sgm_wta(cv, acc, P1, P2, POUT, 1, 3, 3, True)
    idx_p, bands_p, disp_p = sgm_wta_plain(cv, acc, P1, P2, POUT, 1, 3, 3,
                                           True)
    C = (_acc_sum(acc) + direction_adj(cv.float(), SgmDirection.RIGHT2LEFT,
                                       P1, P2, POUT) + cv.float())
    two = torch.topk(C, 2, dim=-1, largest=False).values
    clear = (two[..., 1] - two[..., 0]) > 1e-4
    del C, two
    torch.cuda.synchronize()
    same = idx == idx_p
    assert torch.equal(idx[clear], idx_p[clear]), tag
    agree = same.float().mean().item()
    assert agree >= 0.999, (tag, agree)
    torch.testing.assert_close(bands[same], bands_p[same], rtol=1e-4,
                               atol=1e-4)
    _, tcv = _tcv_from_bands(idx, bands, H, W, D, 3, 3, 1)
    _, tcv_p = _tcv_from_bands(idx_p, bands_p, H, W, D, 3, 3, 1)
    assert torch.equal(torch.isnan(tcv[same]), torch.isnan(tcv_p[same]))
    assert torch.equal(torch.isnan(disp[same]), torch.isnan(disp_p[same]))
    f = same & torch.isfinite(disp_p)
    torch.testing.assert_close(disp[f], disp_p[f], rtol=1e-4, atol=1e-4)
    fin = same[..., None] & torch.isfinite(bands_p)
    e3 = max((bands - bands_p).abs()[fin].max().item(),
             (disp - disp_p).abs()[f].max().item())
    print(f"{tag}: idx agree {agree:.6f}, max |kernel - plain| = {e3:.3g}",
          flush=True)
    return e3


def shift_rows_gather(x, W_out, base, slope):
    """K4a's function as one `torch.gather` (the library yardstick; the
    port does not call it)."""
    H, W_in, Dp = x.shape
    s = (base + slope * torch.arange(H, device=x.device)).clamp(0, W_in - W_out)
    cols = s[:, None] + torch.arange(W_out, device=x.device)
    return torch.gather(x, 1, cols[..., None].expand(H, W_out, Dp))


def k6_flood(H, W, D, axis, reverse, dev, seed=23):
    """A K6 state over an (H, W, D) cost-oriented volume for the sweep
    (axis, reverse): the first line's value v0 runs across the lines up to
    2/3 of the sweep, whose own values all differ from v0 and from their
    neighbours' (so no run breaks by equality: one run of hundreds of
    lines); the line at 2/3 rejects v0.  Costs are each pixel's own
    volume value.  Returns (cv, disp, cost) as (H, W) images."""
    L, S = (H, W) if axis == 0 else (W, H)
    g = torch.Generator(device=dev).manual_seed(seed)
    v0 = D // 2
    k = ((torch.arange(L, device=dev)[:, None] * 5
          + torch.arange(S, device=dev)[None] * 3) % (D - 1))
    k = k + (k >= v0).long()
    k[0] = v0
    cv = torch.rand((L, S, D), generator=g, device=dev) + 1
    cv[:, :, v0] = 0.5
    cv[2 * L // 3, :, v0] = 3.0
    cost = torch.gather(cv, -1, k[..., None])[..., 0]
    disp = k.int()
    if reverse:
        cv, disp, cost = cv.flip(0), disp.flip(0), cost.flip(0)
    if axis == 1:
        cv, disp, cost = cv.transpose(0, 1), disp.t(), cost.t()
    return cv.contiguous(), disp.contiguous(), cost.contiguous()


def k6_edges(dev):
    """(tag, (cv, disp, cost, lower)) K6 edge states: one line and two
    lines along either axis, 45 chains (not a multiple of K6's 32-chain
    block) over 77 lines, lower = -11, a volume of small integers with
    +inf (ties), and costs that are not the volume's own values."""
    rng = np.random.default_rng(24)
    for tag, (H, W, D), lower, ints, own in (
            ("one line", (1, 45, 13), 0, False, True),
            ("one line", (45, 1, 13), 0, False, True),
            ("two lines", (2, 45, 13), 0, False, True),
            ("two lines", (45, 2, 13), 0, False, True),
            ("45 x 77", (45, 77, 13), 0, False, True),
            ("lower -11", (70, 33, 21), -11, False, True),
            ("+inf and ties", (67, 38, 9), 0, True, True),
            ("costs not the volume's", (65, 70, 30), 0, False, False)):
        cv = (rng.integers(0, 3, (H, W, D)) if ints
              else rng.uniform(0, 1, (H, W, D))).astype(np.float32)
        cv[rng.uniform(size=cv.shape) < (0.15 if ints else 0.05)] = np.inf
        disp = rng.integers(lower - 2, lower + D + 2, (H, W)).astype(
            np.int32)
        if own:
            k = np.clip(disp - lower, 0, D - 1)
            cost = np.take_along_axis(cv, k[..., None], -1)[..., 0]
            cost = np.where((disp >= lower) & (disp < lower + D), cost,
                            np.float32(np.inf)).astype(np.float32)
        else:
            cost = rng.uniform(0, 1, (H, W)).astype(np.float32)
        yield tag, tuple(torch.from_numpy(x).to(dev)
                         for x in (cv, disp, cost)) + (lower,)


def host_us(fn, n=200):
    """The host's µs a call of ``fn``, over ``n`` calls issued back to back
    without a synchronisation (the launches queue on the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def pm_kernel_times(dev, costc, d0, d1, c1, draws, cand, inf_cost, L, R,
                    smi):
    """K6's and K7's times at the PatchMatch path's shapes: each call with
    CUDA events (median of 5) beside its device time under torch.profiler
    (the sum of its kernels' device µs a call, over 20 calls, the L2
    scrubbed before each) and the host's µs a call, the sector
    floors of their scattered volume reads, K6 on a converged state (the
    PatchMatch path's own output) and at 720x1280x320, the search probe
    beside the candidate glue it replaces, and the PatchMatch frame's
    profile.  Returns the device ms of the K6 and K7 records."""
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.core import MatchingFunction
    from libstevi_tpu_torch.ops.box_cuda import box_cv
    from libstevi_tpu_torch.ops.patchmatch import cost_oriented_volume
    from libstevi_tpu_torch.ops.patchmatch_cuda import (
        probe, scaled_candidate, search_probe, sweep)
    from libstevi_tpu_torch.profile_frames import profile_frame

    # device times with a cold L2, as the path meets the volume: a 96 MB
    # fill (past the 50 MB L2) before each call, left out of the sums
    scrub = torch.empty(24 << 20, device=dev)

    def device_us(fn, names):
        _, items = profile_frame(lambda: (scrub.zero_(), fn()), 20)
        got = {k: v[0] for k, v in items.items()
               if any(n in k for n in names)}
        assert got, (names, list(items))
        return sum(got.values()), got

    HW = L.numel()
    # one 32-byte sector a scattered volume value, the state's planes
    floor6 = HW * (32 + 4 * 4) / HBM_BYTES_PER_MS * 1e3
    floor7 = HW * (4 * (32 + 4) + 4 * 4) / HBM_BYTES_PER_MS * 1e3
    print(f"sector floors at 480x640: K6 sweep {floor6:.2f} us (a sector "
          f"and 16 bytes of state a pixel), K7 K=4 {floor7:.2f} us (4 "
          f"sectors and 4 candidates, 16 bytes of state)", flush=True)
    # the converged state: the path's output on (L, R) and its own costs
    gen = torch.Generator(device=dev).manual_seed(0)
    d_pm = entry.patchmatch_forward(L, R, gen)
    cv_pm = cost_oriented_volume(MatchingFunction.NCC,
                                 box_cv(MatchingFunction.NCC, L, R, 3, 3,
                                        120), 0)
    c_pm = probe(cv_pm, d_pm, d_pm, inf_cost, 0)[1]
    g = torch.Generator(device=dev).manual_seed(25)
    Hh, Wh, Dh = 720, 1280, 320
    cv_hd = torch.rand((Hh, Wh, Dh), generator=g, device=dev)
    d_hd = torch.randint(0, Dh, (Hh, Wh), generator=g, device=dev,
                         dtype=torch.int32)
    c_hd = probe(cv_hd, d_hd, d_hd, torch.full((Hh, Wh), float("inf"),
                                                device=dev), 0)[1]
    K6 = ("pm_runs", "pm_chain", "pm_cost")
    jobs = {
        "K6 sweep along W 480x640x120 (random state)": (
            lambda: sweep(costc, d1, c1, 0, 1, False), K6),
        "K6 sweep along H 480x640x120 (random state)": (
            lambda: sweep(costc, d1, c1, 0, 0, False), K6),
        "K6 sweep along W 480x640x120 (converged: the path's output)": (
            lambda: sweep(cv_pm, d_pm, c_pm, 0, 1, False), K6),
        "K6 sweep along H 480x640x120 (converged: the path's output)": (
            lambda: sweep(cv_pm, d_pm, c_pm, 0, 0, False), K6),
        "K6 sweep along W 720x1280x320 (random state)": (
            lambda: sweep(cv_hd, d_hd, c_hd, 0, 1, False), K6),
        "K6 sweep along H 720x1280x320 (random state)": (
            lambda: sweep(cv_hd, d_hd, c_hd, 0, 0, False), K6),
        "K7 probe K=1 (init)": (
            lambda: probe(costc, d0, d0, inf_cost, 0), ("pm_probe",)),
        "K7 probe K=4": (
            lambda: probe(costc, cand, d1, c1, 0), ("pm_probe",)),
        "K7 search probe K=4 (the path's)": (
            lambda: search_probe(costc, draws, d1, c1, 0, 4),
            ("pm_probe",)),
    }
    out = {}
    for name, (fn, names) in jobs.items():
        ms = median_ms(fn)
        us, parts = device_us(fn, names)
        out[name] = (ms, us / 1e3)
        print(f"time: {name}: call {ms:.4f} ms, device {us:.2f} us ("
              + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
              + f"), host {host_us(fn):.1f} us a call ({smi})", flush=True)
    glue_ms = median_ms(lambda: probe(costc, torch.stack(
        [scaled_candidate(draws[k], d1, k, 4) for k in range(4)]), d1, c1,
        0))
    sp_ms = out["K7 search probe K=4 (the path's)"][0]
    print(f"time: the candidate glue it replaces (4 x scaled_candidate, "
          f"stack, probe K=4): {glue_ms:.4f} ms against the search probe's "
          f"{sp_ms:.4f} (median of 5; {smi})", flush=True)
    fn = lambda: entry.patchmatch_forward(L, R, gen.manual_seed(0))
    pm_ms = median_ms(fn)
    busy, items = profile_frame(fn, 5)
    top = sorted(items.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"profile: PatchMatch frame 480x640 D=120 5 it: {pm_ms:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle {1 - busy / 1e3 / pm_ms:.3f}"
          f", {sum(n for _, n in items.values()):.1f} device items a frame;"
          f" top: " + ", ".join(f"{k} {us:.1f} us x{n:.0f}"
                                for k, (us, n) in top) + f" ({smi})",
          flush=True)
    del cv_hd, cv_pm
    return out, {
        "K6": out["K6 sweep along W 480x640x120 (random state)"][1],
        "K7": out["K7 search probe K=4 (the path's)"][1]}


def bf16_ulp(x):
    """One bfloat16 ulp of each f32 value (8 significant bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), (e - 8).int())


def peak_bytes(fn):
    """The peak device memory ``fn()`` allocates above what was allocated
    before it, in bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def k4d_four_sweeps(cv, adj, cw, plain=False):
    """`chunked_adj`'s four 8-direction sweeps into ``adj`` (the first one
    writes) at chunk width ``cw``: K4d (one launch each) or, with
    ``plain``, the sweep-level plain version."""
    from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
    H, W, _ = cv.shape
    fn = lane.chunked_sweep_plain if plain else lane.chunked_sweep
    for k, sweep in enumerate(lane.chunk_sweeps(H, W, 8).values()):
        fn(cv, adj, cw=cw, col0=0, W_pout=W, P1=P1, P2=P2, Pout=POUT,
           accumulate=k > 0, **sweep)
    return adj


# K2's two forms across frame sizes (bf16 volumes): the flagship, HD, full
# HD and 4K, whose directions have 1119 to 5999 lines at most
FORM_SHAPES = ((480, 640, 120), (720, 1280, 320), (1080, 1920, 256),
               (2160, 3840, 128))


def k2_forms(dev, k2_dirs, smi):
    """K2's two forms with K3 after each, at each of FORM_SHAPES: the 7
    directions in one launch, a volume each (`direction_volumes`), and 7
    launches into one accumulator (`sgm_accumulate`).  Holds K3's outputs
    of the two equal bitwise, times K2 and K3 of each (CUDA events, median
    of 5), measures the peak memory of K2 + K3 of each, and prints the form
    `sgm_wta_fused` takes there."""
    from libstevi_tpu_torch.core import MatchingFunction
    from libstevi_tpu_torch.ops.box_cuda import box_cv
    from libstevi_tpu_torch.ops.sgm_cuda import (_one_launch,
                                                 direction_volumes,
                                                 sgm_accumulate, sgm_wta)
    for H, W, D in FORM_SHAPES:
        L, R = pair(H, W, 5, dev)
        cv = box_cv(MatchingFunction.ZNCC, L, R, 3, 3, D, torch.bfloat16,
                    negate=True)
        del L, R
        chosen = ("one launch" if _one_launch(cv, len(k2_dirs))
                  else "in series")
        row, outs = {}, {}
        for form, k2 in (("one launch", direction_volumes),
                         ("in series", sgm_accumulate)):
            def both():
                acc = k2(cv, k2_dirs, P1, P2, POUT)
                outs[form] = sgm_wta(cv, acc, P1, P2, POUT, 1, 3, 3, True)

            torch.cuda.empty_cache()
            peak = peak_bytes(both)
            k2_ms = median_ms(lambda: k2(cv, k2_dirs, P1, P2, POUT))
            acc = k2(cv, k2_dirs, P1, P2, POUT)
            k3_ms = median_ms(lambda: sgm_wta(cv, acc, P1, P2, POUT, 1, 3, 3,
                                              True))
            del acc
            row[form] = f"K2 {k2_ms:.3f} ms + K3 {k3_ms:.3f} ms, peak " \
                        f"{peak / 1e9:.3f} GB"
        for a, b in zip(outs["one launch"], outs["in series"]):
            exact(torch.nan_to_num(a, 9.0), torch.nan_to_num(b, 9.0),
                  ("K2 forms", H, W, D))
        print(f"K2 forms {H}x{W}x{D} bf16: one launch {row['one launch']}; "
              f"in series {row['in series']}; K3's outputs equal bitwise; "
              f"sgm_wta_fused takes {chosen} (median of 5; {smi})",
              flush=True)
        del cv, outs
        torch.cuda.empty_cache()


# The redesigned K4b row sweep, K4c and the column scans at the main paths'
# shapes (480x640x384, 720x1280x640), a ragged width (37x101x333), H = 1,
# W < 132 and the direct-load instance (a budget of the fit rule's bytes)
K4_CASES = {"480x640x384": (480, 640, 384, None),
            "720x1280x640": (720, 1280, 640, None),
            "37x101x333": (37, 101, 333, None),
            "H=1 1x640x384": (1, 640, 384, None),
            "W<132 20x100x333": (20, 100, 333, None),
            "direct loads 37x101x333": (37, 101, 333, (2 * 3 + 2) * 333 * 4)}


def k4_cases(dev):
    """Each redesigned kernel against its plain version with `torch.equal`,
    run twice with equal bits, at every shape of K4_CASES: K4b's rows
    (down and up, fresh and accumulating, column offset 3), K4c (rows
    [3, 3 + H) of H + 9 from random carries, carries out), both column
    scans, and the reverse and WTA scans with a stack of 0, 1 and 8
    knight volumes.  Prints the ring instance each geometry takes."""
    from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def twice(fn, tag):
        a, b = fn(), fn()
        for x, y in zip(a, b):
            assert torch.equal(x, y), ("two runs", tag)
        return a

    for name, (H, W, D, budget) in K4_CASES.items():
        g = torch.Generator(device=dev).manual_seed(H + W + D)
        cv = torch.rand((H, W, D), generator=g, device=dev) * 3
        acc = torch.rand((H, W, D), generator=g, device=dev)
        carries = torch.rand((3, W, D), generator=g, device=dev) * 2
        kw = dict(col0=3, W_pout=W + 5, P1=0.3, P2=1.1, Pout=7.0)
        cap = min(budget or lane.SMEM_BLOCK, lane.SMEM_BLOCK)
        lays = [lane.row_layout(W, D, 8, a, cap, sms) for a in (False, True)]
        cols = [lane.cols_layout(H, D, n, w, sms)._asdict()
                for n, w in ((0, False), (8, True))]
        for rev in (False, True):
            for a in (None, acc):
                tag = (name, "rows", rev, a is None)
                want = lane.fused_rows_pass_plain(
                    cv, None if a is None else a.clone(), rev, True, **kw)
                got = twice(lambda: (lane.fused_rows_pass(
                    cv, None if a is None else a.clone(), rev, True,
                    budget=budget, **kw),), tag)
                exact(got[0], want, tag)
                tag = (name, "K4c", rev, a is None)
                args = (carries, 3, H + 9, rev, True)
                want = lane.fused_rows_shard_pass_plain(
                    cv, None if a is None else a.clone(), *args, **kw)
                got = twice(lambda: lane.fused_rows_shard_pass(
                    cv, None if a is None else a.clone(), *args,
                    budget=budget, **kw), tag)
                exact(got[0], want[0], tag)
                exact(got[1], want[1], tag + ("carries",))
        del want, got
        for n in (0, 1, 8):
            k = (torch.rand((n, H, W, D), generator=g, device=dev)
                 if n else None)
            for rev in ((False, True) if n == 0 else (True,)):
                tag = (name, "cols", n, rev)
                want = lane.fused_cols_pass_plain(cv, acc.clone(), rev,
                                                  knights=k, **kw)
                got = twice(lambda: (lane.fused_cols_pass(
                    cv, acc.clone(), rev, knights=k, **kw),), tag)
                exact(got[0], want, tag)
            tag = (name, "WTA", n)
            want = lane.fused_cols_wta_plain(cv, acc, 1, knights=k, **kw)
            got = twice(lambda: lane.fused_cols_wta(cv, acc, 1, knights=k,
                                                    **kw), tag)
            exact(got[0], want[0], tag)
            exact(got[1], want[1], tag)
            del k, want, got
        print(f"K4b/K4c {name} f32: rows (down and up, fresh and "
              f"accumulating), K4c with carries in and out, both column "
              f"scans and the WTA scan with 0, 1 and 8 knight volumes equal "
              f"their plain versions bitwise, two runs equal; ring "
              f"instance: rows fresh {lays[0]._asdict()}, accumulating "
              f"{lays[1]._asdict()}; column scans {cols[0]}, the WTA "
              f"scan over 8 knights {cols[1]}", flush=True)
        del cv, acc, carries
        torch.cuda.empty_cache()


def hier_vs_cpu(tag, func, L, R, cfg):
    """The hierarchical matcher on the card against the same call on the
    CPU (the plain versions): disp_estimate equal on >= 0.999 of pixels,
    the truncated volume within 1e-4 where the estimates agree.  Returns
    the card's result."""
    from libstevi_tpu_torch.ops.hierarchical import (
        hierarchical_truncated_cost_volume as hier)
    g = hier(func, L, R, **cfg)
    c = hier(func, L.cpu(), R.cpu(), **cfg)
    same = g.disp_estimate.cpu() == c.disp_estimate
    share = same.float().mean().item()
    assert share >= 0.999, (tag, share)
    torch.testing.assert_close(g.truncated_cost_volume.cpu()[same],
                               c.truncated_cost_volume[same], rtol=1e-4,
                               atol=1e-4)
    print(f"  {tag}: CUDA vs CPU disp_estimate agree {share:.6f}, truncated "
          f"volume within 1e-4 where they agree", flush=True)
    return g


def n_items(items):
    """Device items a frame in a `profile_frame` item table."""
    return sum(c for _, c in items.values())


def top_items(items, n=8):
    """The ``n`` largest items, and the port's kernels (K1, K5) wherever
    they rank: [name, us a frame, launches a frame]."""
    ranked = sorted(items.items(), key=lambda kv: -kv[1][0])
    kernels = [kv for kv in ranked[n:] if kv[0].startswith(("box_", "fv_"))]
    return [[k, round(u, 1), round(c, 1)] for k, (u, c) in
            ranked[:n] + kernels]


def matchers(dev, pairs, smi):
    """The matchers ported last, on the card.  The hierarchical matcher:
    depth 2 at 480x640, D = 120, ZNCC 7x7 (`entry.hierarchical_forward`)
    on both fixtures, held to the PARITY_r05 `hierarchical_d2` bars with
    one K1 statistics and one K1 volume launch a frame; HD depth 3 at
    720x1280, D = 320 (`entry.hierarchical_hd_forward`) on a random pair,
    against the CPU, with its peak memory; ZSAD depth 2 on a random
    480x640 pair, K5 launched, against the CPU; each frame timed and
    profiled.  Then one timed run each of the other new paths, each held
    to the CPU at its CPU test's tolerance: the 2-D volume (240x320,
    (-8..8) x (-8..8)) with its 2-D WTA, bidirectional band and 2-D
    refinement; `patch_match_flow` (240x320, CENSUS, replayed draws);
    `dp_stereo` and `fastmatch_from_cv` on a 480x640x120 ZSSD volume and
    `fastmatch` (CENSUS) at 480x640, D = 120; guided aggregation of a
    480x640x120 volume; and the CLI's hierarchical matcher with parabola
    refinement on the fixtures.  K1 (statistics and volume, bit for bit)
    and K5 (at 1e-5) are held to their plain versions at the coarsest
    levels' shapes: 120x160x30, 90x160x40, and ZSAD's 120x160 F = 49 over
    30 shifts.  Returns the K1 and K5 launches of the hierarchical frames
    and K5's largest error against its plain version there."""
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.core import (ExtractionStrategy, MATCH_TRAITS,
                                         MatchingFunction, SearchOffset1,
                                         SearchOffset2)
    from libstevi_tpu_torch.io import read_stevimg
    from libstevi_tpu_torch.ops import (
        InterpolationKernel, extract_selected_2d_index,
        normalize_feature_volume, patch_match_flow,
        refine_disp_2d_cost_interpolation,
        truncated_bidirectional_cost_volume, unfold,
        unfold_based_2d_disparity_cost_volume, unfold_based_cost_volume)
    from libstevi_tpu_torch.interpolation import average_pooling_downsample
    from libstevi_tpu_torch.ops.box_cuda import (_prep_inputs, box_cv,
                                                 box_cv_plain, window_stats)
    from libstevi_tpu_torch.ops.dp_stereo import dp_stereo
    from libstevi_tpu_torch.ops.fastmatch import fastmatch, fastmatch_from_cv
    from libstevi_tpu_torch.ops.fv_backend import (fused_fv_cost_volume,
                                                   fused_fv_cost_volume_plain)
    from libstevi_tpu_torch.ops.guided_filtering import (
        guided_cost_volume_aggregation)
    from libstevi_tpu_torch.profile_frames import profile_frame

    ZNCC, ZSAD = MatchingFunction.ZNCC, MatchingFunction.ZSAD
    CENSUS, ZSSD = MatchingFunction.CENSUS, MatchingFunction.ZSSD
    counters = (window_stats, box_cv, fused_fv_cost_volume)

    def launches():
        return {"K1 stats": window_stats.launches, "K1": box_cv.launches,
                "K5": fused_fv_cost_volume.launches}

    def reset():
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()

    def coarsest(L, R, depth):
        for _ in range(depth):
            L, R = (average_pooling_downsample(x, 2) for x in (L, R))
        return L, R

    def k1_at_coarsest(L, R, depth, D):
        """K1's two kernels at the coarsest level's shape, bit for bit."""
        cl, cr = coarsest(L, R, depth)
        got = window_stats(ZNCC, cl, cr, 3, 3)
        for a, b in zip(got[2:6], _prep_inputs(ZNCC, cl, cr, 3, 3)[2:6]):
            exact(a, b, ("K1 stats coarsest", depth))
        exact(box_cv(ZNCC, cl, cr, 3, 3, D),
              box_cv_plain(ZNCC, cl, cr, 3, 3, D), ("K1 coarsest", depth))
        print(f"K1 at the coarsest level {tuple(cl.shape)}x{D}: statistics "
              f"and volume equal their plain versions bit for bit",
              flush=True)

    # -- hierarchical depth 2, 480x640, D = 120: both fixtures ---------------
    out = {}
    for name in H_BARS:
        reset()
        out[name] = entry.hierarchical_forward(*pairs[name][0])
        torch.cuda.synchronize()
        n = launches()
        print(f"hierarchical depth 2 {name}: launches {n}", flush=True)
        assert n == {"K1 stats": 1, "K1": 1, "K5": 0}, (name, n)
        d = out[name]
        assert d.shape == (480, 640) and d.dtype == torch.int32
        check_bars(f"hierarchical {name}", d.float(), pairs[name][1],
                   H_BARS[name])
    hier_launches = {"K1 stats": 1, "K1": 1}
    Lw, Rw = pairs["warp"][0]
    f2 = lambda: entry.hierarchical_forward(Lw, Rw)  # noqa: E731
    h2_ms = median_ms(f2)
    h2_peak = peak_bytes(f2)
    busy, items = profile_frame(f2, 5)
    print(f"time: hierarchical depth-2 frame 480x640 D=120 ZNCC: {h2_ms:.3f} "
          f"ms (median of 5 after a warm-up; {smi}); memory: peak "
          f"{h2_peak / 1e9:.3f} GB above the inputs; profile (5 frames): "
          f"device busy {busy / 1e3:.3f} ms a frame, idle "
          f"{1 - busy / 1e3 / h2_ms:.3f}, {n_items(items):.0f} "
          f"device items a frame, top (name, us a frame, launches a frame) "
          f"{top_items(items)}", flush=True)
    hier_vs_cpu("hierarchical depth 2 warp", ZNCC, Lw, Rw, dict(
        entry.HIERARCHICAL))
    k1_at_coarsest(Lw, Rw, 2, 30)

    # -- hierarchical HD depth 3, 720x1280, D = 320 --------------------------
    Lh, Rh = pair(entry.HD_HEIGHT, entry.HD_WIDTH, 14, dev)
    reset()
    dh = entry.hierarchical_hd_forward(Lh, Rh)
    torch.cuda.synchronize()
    n = launches()
    print(f"hierarchical HD depth 3 720x1280 D=320: launches {n}", flush=True)
    assert n == {"K1 stats": 1, "K1": 1, "K5": 0}, n
    assert dh.shape == (720, 1280) and dh.dtype == torch.int32
    g = hier_vs_cpu("hierarchical HD depth 3", ZNCC, Lh, Rh,
                    dict(entry.HIERARCHICAL_HD))
    assert torch.equal(g.disp_estimate, dh)
    k1_at_coarsest(Lh, Rh, 3, 40)
    fh = lambda: entry.hierarchical_hd_forward(Lh, Rh)  # noqa: E731
    hd_ms = median_ms(fh)
    hd_peak = peak_bytes(fh)
    busy, items = profile_frame(fh, 5)
    print(f"time: hierarchical HD depth-3 frame 720x1280 D=320 ZNCC: "
          f"{hd_ms:.3f} ms (median of 5 after a warm-up; {smi}); memory: "
          f"peak {hd_peak / 1e9:.3f} GB above the inputs; profile (5 "
          f"frames): device busy {busy / 1e3:.3f} ms a frame, idle "
          f"{1 - busy / 1e3 / hd_ms:.3f}, {n_items(items):.0f} "
          f"device items a frame, top {top_items(items)}", flush=True)
    del Lh, Rh, g

    # -- hierarchical ZSAD depth 2 on a random 480x640 pair (K5) -------------
    Lz, Rz = pair(480, 640, 15, dev)
    zcfg = dict(entry.HIERARCHICAL)
    reset()
    g = hier_vs_cpu("hierarchical ZSAD depth 2 random", ZSAD, Lz, Rz, zcfg)
    torch.cuda.synchronize()
    n = launches()
    print(f"hierarchical ZSAD depth 2: launches {n}", flush=True)
    assert n == {"K1 stats": 0, "K1": 0, "K5": 1}, n
    hier_launches["K5"] = n["K5"]
    # K5 at the coarsest level's shape: the normalized 7x7 unfolds of the
    # 120x160 pair, 30 shifts (RIGHT_TO_LEFT: source = right)
    cl, cr = coarsest(Lz, Rz, 2)
    fs, ft = (normalize_feature_volume(ZSAD, unfold(3, 3, x))
              for x in (cr, cl))
    got = fused_fv_cost_volume("sad", fs, ft, range(30))
    want = fused_fv_cost_volume_plain("sad", fs, ft, range(30))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    k5_err = (got - want).abs().max().item()
    print(f"K5 at the coarsest level 120x160x30 F=49 'sad': within "
          f"{k5_err:.3g} of its plain version", flush=True)
    from libstevi_tpu_torch.ops.hierarchical import (
        hierarchical_truncated_cost_volume as hier)
    z_ms = median_ms(lambda: hier(ZSAD, Lz, Rz, **zcfg))
    print(f"time: hierarchical ZSAD depth-2 frame 480x640 D=120: {z_ms:.3f} "
          f"ms (median of 5; {smi})", flush=True)
    del Lz, Rz, g

    # -- 2-D volume + 2-D WTA + band + 2-D refinement, 240x320 --------------
    full_l = pairs["warp"][0][0]
    src = full_l[100:340, 100:420].contiguous()
    tgt = full_l[97:337, 95:415].contiguous()      # flow (3, 5)
    s2 = SearchOffset2(-8, 8, -8, 8)
    strat = MATCH_TRAITS[ZNCC].strategy

    def flow_chain(a, b):
        cv = unfold_based_2d_disparity_cost_volume(ZNCC, a, b, 3, 3, s2)
        idx = extract_selected_2d_index(cv, strat)
        band = truncated_bidirectional_cost_volume(cv, idx, 1, 1)
        ref = refine_disp_2d_cost_interpolation(
            InterpolationKernel.PARABOLA, -band, idx)
        return cv, idx, band, ref

    # the 2-D volume is direction-free: source = the first image here
    # (RIGHT_TO_LEFT roles: fv_l is the target)
    cv_g, idx_g, band_g, ref_g = flow_chain(tgt, src)
    cv_c = unfold_based_2d_disparity_cost_volume(ZNCC, tgt.cpu(), src.cpu(),
                                                 3, 3, s2)
    torch.testing.assert_close(cv_g.cpu(), cv_c, rtol=1e-5, atol=1e-5)
    # each later stage on the same input on both devices: exact WTA
    cv_h = cv_g.cpu()
    idx_c = extract_selected_2d_index(cv_h, strat)
    assert torch.equal(idx_g.cpu(), idx_c)
    band_c = truncated_bidirectional_cost_volume(cv_h, idx_c, 1, 1)
    torch.testing.assert_close(band_g.cpu(), band_c, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    ref_c = refine_disp_2d_cost_interpolation(InterpolationKernel.PARABOLA,
                                              -band_g.cpu(), idx_c)
    torch.testing.assert_close(ref_g.cpu(), ref_c, rtol=1e-5, atol=1e-5)
    flow = idx_g + torch.tensor([s2.lower0, s2.lower1], device=dev,
                                dtype=idx_g.dtype)
    hit = ((flow[8:-8, 8:-8] == torch.tensor([3, 5], device=dev)).all(-1)
           .float().mean().item())
    assert hit > 0.95, hit
    ms2 = median_ms(lambda: flow_chain(tgt, src))
    print(f"2-D volume 240x320 over (-8..8)^2 ZNCC 7x7 + 2-D WTA + band + "
          f"2-D parabola: CUDA vs CPU volume within 1e-5, WTA equal, band "
          f"and refinement within 1e-5; flow (3, 5) found on {hit:.4f}; "
          f"time {ms2:.3f} ms (median of 5; {smi})", flush=True)
    del cv_g, cv_c, cv_h, band_g, band_c

    # -- patch_match_flow, 240x320, CENSUS, one replayed draw stream ---------
    fs = normalize_feature_volume(CENSUS, unfold(3, 3, src))
    ft = normalize_feature_volume(CENSUS, unfold(3, 3, tgt))

    def pm_flow(a, b, device):
        rng = np.random.default_rng(21)

        def draw(shape, lo, hi):
            return torch.from_numpy(rng.integers(lo, hi, shape).astype(
                np.int32)).to(device)
        return patch_match_flow(CENSUS, a, b, s2, 5, 4, draw=draw)

    fl_g = pm_flow(fs, ft, dev)
    fl_c = pm_flow(fs.cpu(), ft.cpu(), "cpu")
    assert torch.equal(fl_g.cpu(), fl_c)
    # a convergence check, not a parity bar: census ties on this smooth
    # crop leave some pixels on equal-cost flows
    hit = ((fl_g[8:-8, 8:-8] == torch.tensor([3, 5], device=dev)).all(-1)
           .float().mean().item())
    assert hit > 0.5, hit
    pmf_ms = median_ms(lambda: pm_flow(fs, ft, dev), 3)
    print(f"patch_match_flow 240x320 CENSUS 7x7 over (-8..8)^2, 5 it, 4 "
          f"random: CUDA equals CPU with one replayed draw stream; flow "
          f"(3, 5) on {hit:.4f}; time {pmf_ms:.3f} ms (median of 3; {smi})",
          flush=True)

    # -- dp_stereo, fastmatch_from_cv and fastmatch at 480x640, D = 120 ------
    L, R = pairs["warp"][0]
    cvz = unfold_based_cost_volume(ZSSD, L, R, 3, 3, 120)
    cvz_c = cvz.cpu()
    dp_g = dp_stereo(cvz, 0.05, 0.2)
    dp_c = dp_stereo(cvz_c, 0.05, 0.2)
    assert torch.equal(dp_g.disparity.cpu(), dp_c.disparity)
    assert torch.equal(dp_g.occlusion.cpu(), dp_c.occlusion)
    dp_ms = median_ms(lambda: dp_stereo(cvz, 0.05, 0.2), 3)
    fm_g = fastmatch_from_cv(ZSSD, cvz)
    assert torch.equal(fm_g.cpu(), fastmatch_from_cv(ZSSD, cvz_c))
    fmcv_ms = median_ms(lambda: fastmatch_from_cv(ZSSD, cvz), 3)
    cs = normalize_feature_volume(CENSUS, unfold(3, 3, R))
    ct = normalize_feature_volume(CENSUS, unfold(3, 3, L))
    fmc_g = fastmatch(CENSUS, cs, ct, SearchOffset1(0, 119))
    assert torch.equal(fmc_g.cpu(), fastmatch(CENSUS, cs.cpu(), ct.cpu(),
                                              SearchOffset1(0, 119)))
    fm_ms = median_ms(lambda: fastmatch(CENSUS, cs, ct,
                                        SearchOffset1(0, 119)), 3)
    gt = pairs["warp"][1]
    print(f"dp_stereo 480x640x120 ZSSD: path and occlusions equal the CPU's; "
          f"time {dp_ms:.3f} ms; fastmatch_from_cv: equal, {fmcv_ms:.3f} ms; "
          f"fastmatch CENSUS 7x7 D=120: equal, {fm_ms:.3f} ms (medians of 3; "
          f"{smi}); prop_good_2.0 on the warp fixture: dp "
          f"{prop_good_np(dp_g.disparity, gt):.4f}, fastmatch "
          f"{prop_good_np(fmc_g, gt):.4f}", flush=True)
    del cs, ct

    # -- guided aggregation of a 480x640x120 volume ---------------------------
    gd_g = guided_cost_volume_aggregation(cvz, L, 2, 3.0, 0.1)
    gd_c = guided_cost_volume_aggregation(cvz_c, L.cpu(), 2, 3.0, 0.1)
    torch.testing.assert_close(gd_g.cpu(), gd_c, rtol=1e-5, atol=1e-5)
    gd_ms = median_ms(lambda: guided_cost_volume_aggregation(cvz, L, 2, 3.0,
                                                             0.1), 3)
    print(f"guided_cost_volume_aggregation 480x640x120, radius 2: CUDA vs "
          f"CPU within 1e-5; time {gd_ms:.3f} ms (median of 3; {smi})",
          flush=True)
    del cvz, cvz_c, gd_g, gd_c

    # -- the CLI's hierarchical matcher, parabola refinement, both fixtures --
    for name, (suffix, _, _) in BARS.items():
        with tempfile.TemporaryDirectory() as tmp:
            out_path = str(Path(tmp) / "disph.stevimg")
            res = subprocess.run(
                [sys.executable, "-m", "libstevi_tpu_torch.cli.stereo_match",
                 str(FIXTURES / f"left{suffix}.stevimg"),
                 str(FIXTURES / f"right{suffix}.stevimg"), "-o", out_path,
                 "-d", "120", "--matcher", "hierarchical", "--refine",
                 "parabola", "--gt", str(FIXTURES / f"gt{suffix}.stevimg")],
                cwd=ROOT, capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr
            report = json.loads(res.stdout.strip().splitlines()[-1])
            assert read_stevimg(out_path).shape == (480, 640)
        print(f"CLI hierarchical {name}: {json.dumps(report)}", flush=True)
        pg_bar, mae_bar = H_BARS[name]
        assert report["prop_good_2.0"] >= pg_bar, report
        assert report["inlier_mae"] <= mae_bar, report
    torch.cuda.empty_cache()
    return hier_launches, k5_err


# the JAX package's CPU run of `cli/stereo_refine.py -d 120 -r 3 --gt` (ZNCC
# 7x7) on the fixtures: prop_good_1.0 minus 0.001 and inlier_mae plus 0.01
# (the CLI's definitions, `refine_stats`)
REFINE_BARS = {
    "warp": {"barycentric": (0.84226, 0.05221),
             "barycentric-symmetric": (0.84214, 0.05943),
             "cost-symmetric": (0.84233, 0.09162)},
    "occluded": {"barycentric": (0.65561, 0.28754),
                 "barycentric-symmetric": (0.65760, 0.27463),
                 "cost-symmetric": (0.65468, 0.28899)}}


def refine_stats(disp, gt, r=3, D=120):
    """`cli/stereo_refine.py`'s (prop_good_1.0, inlier_mae): the border of
    2r + 2 pixels and the first D columns left out, |err| <= 1 an inlier."""
    b = 2 * r + 2
    inner = np.s_[b:-b, b + D:-b]
    err = np.abs(np.asarray(disp)[inner] - gt[inner])
    return float((err <= 1.0).mean()), float(err[err <= 1.0].mean())


def hold_to_cpu(tag, got, want, tol=1e-3, share=0.999, bound=1.0,
                same=None):
    """A refined field on the card against the CPU run of the same call:
    finite where the CPU's is, |diff| <= ``tol`` on >= ``share`` of the
    values and < ``bound`` where the two runs' WTA indices agree (``same``,
    a pixel mask; every pixel when None: where K5 and the CPU's loop break
    a near-tie apart the refinement starts from another index).  Returns
    (share, max |diff| where the indices agree)."""
    got, want = got.cpu(), torch.as_tensor(want)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin), tag
    d = torch.where(fin, (got - want).abs(), 0.0)
    sh = (d[fin] <= tol).float().mean().item()
    if same is None:
        same = torch.ones(d.shape[:2], dtype=torch.bool)
    same = same.cpu()
    if d.ndim == 3:
        same = same[..., None].expand_as(d)
    mx = d[same].max().item() if same.any() else 0.0
    assert sh >= share and mx < bound, (tag, sh, mx)
    where = (" where the WTA indices agree" if not same.all() else "")
    other = (f", max {d[~same].max().item():.3g} where they differ"
             if (~same).any() else "")
    print(f"  {tag}: CUDA vs CPU within {tol:g} on {sh:.6f} of the values, "
          f"max {mx:.3g}{where}{other}", flush=True)
    return sh, mx


def wta_index(func, a, b, search=120):
    """The WTA index the image-level refinement starts from (7x7 unfolds,
    the trait volumes, `aggregate_cost` 'auto': K5 on the card for the
    dot/SSD/SAD families) on the inputs' device."""
    from libstevi_tpu_torch.core import MATCH_TRAITS
    from libstevi_tpu_torch.ops import image_refinement as ir
    from libstevi_tpu_torch.ops.cost_volume import (
        aggregate_cost, extract_selected_2d_index)
    from libstevi_tpu_torch.ops.unfold import unfold
    (cl, cr), _ = ir._trait_volumes(func, unfold(3, 3, a), unfold(3, 3, b),
                                    False)
    if isinstance(search, int):
        return ir._cv_and_index(func, cl, cr, search,
                                ir.DispDirection.RIGHT_TO_LEFT)
    return extract_selected_2d_index(aggregate_cost(func, cl, cr, search),
                                     MATCH_TRAITS[func].strategy)


def wta_agreement(tag, func, L, R, search=120, cpu=None):
    """`wta_index` on the card and on the CPU (``cpu``: the CPU's index,
    where computed already); asserts agreement on >= 0.999 of the pixels
    and returns the mask where they agree."""
    g = wta_index(func, L, R, search).cpu()
    c = (wta_index(func, L.cpu(), R.cpu(), search) if cpu is None
         else torch.as_tensor(cpu))
    same = (g == c) if g.ndim == 2 else (g == c).all(-1)
    agree = same.float().mean().item()
    assert agree >= 0.999, (tag, agree)
    print(f"  {tag}: WTA index CUDA vs CPU agree on {agree:.6f}", flush=True)
    return same



# -- CPU references computed beside the card ---------------------------------
# The CPU runs that the full-size refinement holds compare with (the SAD
# IRLS and the optical-flow chain) take minutes of the host.  `main` starts
# them in a second Python process (`cpu_worker`; it never touches the card)
# as soon as the kernels are built, so they run while the card works; a
# phase run on its own computes them in place.  Each job returns numpy
# arrays.
FLOW_SEARCH = (-8, 8, -8, 8)


def warp_fixture():
    """The warp fixture's pair as CPU tensors."""
    from libstevi_tpu_torch.io import read_stevimg
    return tuple(torch.from_numpy(read_stevimg(str(
        FIXTURES / f"{side}.stevimg"))) for side in ("left", "right"))


def flow_pair():
    """(source, target): 240x320 crops of the warp fixture's left image,
    the target moved by the flow (3, 5)."""
    L = warp_fixture()[0]
    return L[100:340, 100:420].contiguous(), L[97:337, 95:415].contiguous()


def flow_chain(a, b):
    """The optical-flow chain: ZNCC 7x7 over `FLOW_SEARCH`, the 2-D WTA
    and the 9-point symmetric refinement."""
    from libstevi_tpu_torch.core import MatchingFunction, SearchOffset2
    from libstevi_tpu_torch.ops import image_refinement as ir
    return ir.refined_barycentric_symmetric_2d_disp(
        MatchingFunction.ZNCC, a, b, 3, 3, SearchOffset2(*FLOW_SEARCH))


def refine_cpu(f):
    """The CPU run of the barycentric-symmetric refinement by ``f`` (SAD,
    SSD) on the whole warp fixture, and its WTA index."""
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.core import MatchingFunction
    L, R = warp_fixture()
    func = MatchingFunction[f]
    return (entry.stereo_refine_forward(L, R, "barycentric-symmetric",
                                        func).numpy(),
            wta_index(func, L, R).numpy())


def flow_cpu():
    """The CPU run of the optical-flow chain on `flow_pair`, and its 2-D
    WTA index."""
    from libstevi_tpu_torch.core import MatchingFunction, SearchOffset2
    src, tgt = flow_pair()
    return (flow_chain(tgt, src).numpy(),
            wta_index(MatchingFunction.ZNCC, tgt, src,
                      SearchOffset2(*FLOW_SEARCH)).numpy())


CPU_JOBS = {"refine SAD": (refine_cpu, ("SAD",)),
            "refine SSD": (refine_cpu, ("SSD",)),
            "flow": (flow_cpu, ())}
_cpu_worker = None


def cpu_worker(out_dir, threads):
    """Run every `CPU_JOBS` entry in order on ``threads`` cores, each
    result saved as ``out_dir/<key>.npz`` (written whole, then renamed)."""
    torch.set_num_threads(threads)
    for key, (fn, args) in CPU_JOBS.items():
        part = Path(out_dir) / f"{key}.part.npz"
        np.savez(part, *fn(*args))
        part.rename(Path(out_dir) / f"{key}.npz")


def start_cpu_jobs():
    """Start `cpu_worker` in a second Python process on half the host's
    cores (it never touches the card)."""
    global _cpu_worker
    out = tempfile.TemporaryDirectory()
    threads = max(1, (os.cpu_count() or 2) // 2)
    err = open(Path(out.name) / "stderr.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke;"
         f" chip_smoke.cpu_worker({out.name!r}, {threads})"],
        cwd=ROOT, stdout=err, stderr=subprocess.STDOUT)
    _cpu_worker = (proc, out, err)


def cpu_job(key):
    """``CPU_JOBS[key]``'s result: the second process's where
    `start_cpu_jobs` started it (its failure raises here), else computed
    in place."""
    if _cpu_worker is None:
        fn, args = CPU_JOBS[key]
        return fn(*args)
    proc, out, _ = _cpu_worker
    path = Path(out.name) / f"{key}.npz"
    t0 = time.perf_counter()
    while not path.exists():
        if proc.poll() is not None and not path.exists():
            raise RuntimeError(
                f"the CPU jobs' process ended ({proc.returncode}) without "
                f"{key!r}: "
                + (Path(out.name) / "stderr.txt").read_text()[-3000:])
        time.sleep(0.05)
    with np.load(path) as z:
        res = tuple(z[f"arr_{i}"] for i in range(len(z.files)))
    print(f"  [cpu job] {key}: waited {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def stop_cpu_jobs():
    """End the second process, finished or not."""
    global _cpu_worker
    if _cpu_worker is not None:
        proc, out, err = _cpu_worker
        proc.kill()
        proc.wait()
        err.close()
        out.cleanup()
        _cpu_worker = None


def refine(dev, smi):
    """The feature-space subpixel refinement and the `optim` solvers on
    the card (`refine` phase).  `entry.stereo_refine_forward` (ZNCC 7x7,
    D = 120) by each method on both fixtures: one K5 launch a frame, the
    JAX package's CPU bars (`REFINE_BARS`), held to the CPU run of the same
    call; each method's frame timed, profiled and its peak memory.  Then
    SAD (the L1 IRLS) and SSD at 480x640 (K5), MEDAD (the subpart
    least-median route, no kernel) timed at 480x640 and held to the CPU
    on the 96x128 fixtures, the arbitrary interpolation at n_pixels_cut =
    100 (chunks of 16 candidates) with its peak memory, held to the CPU on
    a 96x128 crop (at one candidate spacing).  The card's and the CPU's
    refinements start from their own WTA indices, which agree on >=
    0.999 of the pixels (`wta_agreement`).  Returns the K5 launches of a
    refine frame."""
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.core import MatchingFunction
    from libstevi_tpu_torch.io import read_stevimg
    from libstevi_tpu_torch.ops import image_refinement as ir
    from libstevi_tpu_torch.ops.fv_backend import fused_fv_cost_volume as k5
    from libstevi_tpu_torch.ops.unfold import unfold
    from libstevi_tpu_torch.profile_frames import profile_frame

    ZNCC = MatchingFunction.ZNCC

    def fixture(suffix, dev_):
        imgs = [torch.from_numpy(read_stevimg(str(
            FIXTURES / f"{side}{suffix}.stevimg"))).to(dev_)
            for side in ("left", "right")]
        return imgs, read_stevimg(str(FIXTURES / f"gt{suffix}.stevimg"))

    def frame_stats(tag, fn, reps=5):
        ms = median_ms(fn, reps)
        peak = peak_bytes(fn)
        busy, items = profile_frame(fn, 3)
        print(f"time: {tag}: {ms:.3f} ms (median of {reps} after a warm-up; "
              f"{smi}); memory: peak {peak / 1e9:.3f} GB above the inputs; "
              f"profile (3 frames): device busy {busy / 1e3:.3f} ms a frame, "
              f"idle {1 - busy / 1e3 / ms:.3f}, {n_items(items):.0f} device "
              f"items a frame, top {top_items(items)}", flush=True)

    # -- stereo_refine's three methods, both fixtures, 480x640, D = 120 ------
    for name, (suffix, _, _) in BARS.items():
        (L, R), gt = fixture(suffix, dev)
        Lc, Rc = L.cpu(), R.cpu()
        same = wta_agreement(f"refine {name} ZNCC", ZNCC, L, R)
        for m in entry.REFINE_METHODS:
            k5.launches = 0
            torch.cuda.synchronize()
            d = entry.stereo_refine_forward(L, R, m)
            torch.cuda.synchronize()
            n = k5.launches
            assert n == 1 and d.shape == (480, 640), (name, m, n)
            pg, mae = refine_stats(d.cpu().numpy(), gt)
            pg_bar, mae_bar = REFINE_BARS[name][m]
            print(f"refine {name} {m}: K5 launches {n}, prop_good_1.0 = "
                  f"{pg:.5f} (bar >= {pg_bar}), inlier_mae = {mae:.5f} (bar "
                  f"<= {mae_bar})", flush=True)
            assert pg >= pg_bar and mae <= mae_bar, (name, m, pg, mae)
            hold_to_cpu(f"refine {name} {m}", d,
                        entry.stereo_refine_forward(Lc, Rc, m), same=same)
    (L, R), gt = fixture("", dev)
    for m in entry.REFINE_METHODS:
        frame_stats(f"refine frame {m} 480x640 D=120 ZNCC 7x7",
                    lambda: entry.stereo_refine_forward(L, R, m))

    # -- SAD (L1 IRLS) and SSD, barycentric-symmetric, 480x640 (K5) ----------
    for f in ("SAD", "SSD"):
        func = MatchingFunction[f]
        k5.launches = 0
        d = entry.stereo_refine_forward(L, R, "barycentric-symmetric", func)
        torch.cuda.synchronize()
        assert k5.launches == 1, (f, k5.launches)
        pg, mae = refine_stats(d.cpu().numpy(), gt)
        print(f"refine warp {f} barycentric-symmetric: K5 launches 1, "
              f"prop_good_1.0 = {pg:.5f}, inlier_mae = {mae:.5f}", flush=True)
        # the CPU run of the same call and its WTA index (`CPU_JOBS`)
        d_cpu, idx_cpu = cpu_job(f"refine {f}")
        hold_to_cpu(f"refine {f} barycentric-symmetric", d, d_cpu,
                    same=wta_agreement(f"refine warp {f}", func, L, R,
                                       cpu=idx_cpu))
        frame_stats(f"refine frame {f} barycentric-symmetric 480x640 D=120",
                    lambda: entry.stereo_refine_forward(
                        L, R, "barycentric-symmetric", func), reps=3)

    # -- MEDAD: the subpart least-median route (no kernel) -------------------
    MEDAD = MatchingFunction.MEDAD
    k5.launches = 0
    d = entry.stereo_refine_forward(L, R, "barycentric-symmetric", MEDAD)
    torch.cuda.synchronize()
    assert k5.launches == 0 and torch.isfinite(d).all()
    pg, mae = refine_stats(d.cpu().numpy(), gt)
    print(f"refine warp MEDAD barycentric-symmetric 480x640: K5 launches 0, "
          f"prop_good_1.0 = {pg:.5f}, inlier_mae = {mae:.5f}", flush=True)
    frame_stats("refine frame MEDAD barycentric-symmetric 480x640 D=120",
                lambda: entry.stereo_refine_forward(
                    L, R, "barycentric-symmetric", MEDAD), reps=3)
    (Ls, Rs), _ = fixture("_small", dev)
    same = wta_agreement("MEDAD 96x128 D=24", MEDAD, Ls, Rs, 24)
    for m in ("barycentric", "barycentric-symmetric"):
        cfg = dict(h_radius=3, v_radius=3, search_range=24)
        fn = (ir.refined_barycentric_disp if m == "barycentric"
              else ir.refined_barycentric_symmetric_disp)
        hold_to_cpu(f"MEDAD {m} 96x128 D=24", fn(MEDAD, Ls, Rs, **cfg),
                    fn(MEDAD, Ls.cpu(), Rs.cpu(), **cfg), same=same)

    # -- refine_arbitrary_interpolation_disp, n_pixels_cut = 100 -------------
    fl, fr = unfold(3, 3, L), unfold(3, 3, R)
    (cl, cr), (rl, rr) = ir._trait_volumes(ZNCC, fl, fr, False)
    idx = ir._cv_and_index(ZNCC, cl, cr, 120, ir.DispDirection.RIGHT_TO_LEFT)
    del cl, cr, fl, fr

    def arbitrary(a, b, i):
        return ir.refine_arbitrary_interpolation_disp(ZNCC, a, b, i, 100)

    da = arbitrary(rl, rr, idx)
    pg, mae = refine_stats(da.cpu().numpy(), gt)
    ms = median_ms(lambda: arbitrary(rl, rr, idx), 3)
    peak = peak_bytes(lambda: arbitrary(rl, rr, idx))
    print(f"time: arbitrary interpolation 480x640 ZNCC pyramid n_pixels_cut="
          f"100 (200 candidates, chunks of 16): {ms:.3f} ms (median of 3; "
          f"{smi}); memory: peak {peak / 1e9:.3f} GB above the inputs; "
          f"prop_good_1.0 = {pg:.5f}, inlier_mae = {mae:.5f}", flush=True)
    # held at one candidate spacing (1 / n_pixels_cut): candidates 0.01 px
    # apart differ in cost by a few ulps, so the two devices' roundings
    # may pick neighbours
    crop = (slice(200, 296), slice(300, 428))
    a, b, i = (x[crop].contiguous() for x in (rl, rr, idx))
    hold_to_cpu("arbitrary interpolation 96x128 crop, n_pixels_cut=100",
                arbitrary(a, b, i), arbitrary(a.cpu(), b.cpu(), i.cpu()),
                tol=0.01 + 1e-5)
    del rl, rr
    torch.cuda.empty_cache()
    return 1


def refine_flow_and_clis(dev, smi):
    """The optical-flow chain (`refined_barycentric_symmetric_2d_disp`,
    240x320 crops of the warp fixture moved by (3, 5), over (-8..8)^2)
    timed and held to the CPU, and both refinement CLIs on the card against
    their ``--device cpu`` runs (the stereo one on the warp fixture at the
    `REFINE_BARS`, the flow one on the 96x128 fixtures)."""
    from libstevi_tpu_torch.core import MatchingFunction, SearchOffset2
    from libstevi_tpu_torch.io import read_flo, read_stevimg
    ZNCC = MatchingFunction.ZNCC

    # -- the optical-flow chain, 240x320 over (-8..8)^2 ----------------------
    src, tgt = (x.to(dev) for x in flow_pair())
    s2 = SearchOffset2(*FLOW_SEARCH)
    fg = flow_chain(tgt, src)
    hit = ((fg[8:-8, 8:-8] - torch.tensor([3.0, 5.0], device=dev)).abs()
           .amax(-1) <= 0.05).float().mean().item()
    assert hit > 0.9, hit
    # the QUEEN neighbourhood's 9-column solves have condition numbers up
    # to ~1e4 on this smooth crop: the devices' float32 roundings of the
    # trait volumes move a flow by up to ~0.015 px
    flow_c, idx_c = cpu_job("flow")
    hold_to_cpu("optical-flow chain 240x320 (-8..8)^2", fg, flow_c, tol=0.02,
                same=wta_agreement("optical-flow chain", ZNCC, tgt, src, s2,
                                   cpu=idx_c))
    ms = median_ms(lambda: flow_chain(tgt, src), 3)
    print(f"time: optical-flow chain 240x320 over (-8..8)^2 ZNCC 7x7 (2-D "
          f"volume, 2-D WTA, 9-point symmetric refinement): {ms:.3f} ms "
          f"(median of 3; {smi}); flow (3, 5) within 0.05 px on {hit:.4f}",
          flush=True)

    # -- both refinement CLIs on the card, against their --device cpu runs --
    def cli(tool, out, *extra, suffix=""):
        res = subprocess.run(
            [sys.executable, "-m", f"libstevi_tpu_torch.cli.{tool}",
             str(FIXTURES / f"left{suffix}.stevimg"),
             str(FIXTURES / f"right{suffix}.stevimg"), "-o", out, *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        return json.loads(res.stdout.strip().splitlines()[-1])

    with tempfile.TemporaryDirectory() as tmp:
        args = ("-d", "120", "-r", "3", "--gt", str(FIXTURES / "gt.stevimg"))
        outs = [str(Path(tmp) / f"r{k}.stevimg") for k in range(2)]
        report = cli("stereo_refine", outs[0], *args)
        cpu = cli("stereo_refine", outs[1], *args, "--device", "cpu")
        print(f"CLI stereo_refine warp: {json.dumps(report)}", flush=True)
        for m, (pg_bar, mae_bar) in REFINE_BARS["warp"].items():
            assert report[m]["prop_good_1.0"] >= pg_bar, report
            assert report[m]["inlier_mae"] <= mae_bar, report
        # the written cost-symmetric field; where the WTA indices differ
        # (6 pixels in 1e6 on this pair) the two runs refine other indices
        got, want = (torch.from_numpy(read_stevimg(o)) for o in outs)
        assert got.shape == (480, 640)
        hold_to_cpu("CLI stereo_refine output (cost-symmetric)", got, want,
                    bound=float("inf"))
        for m in report:
            assert abs(report[m]["prop_good_1.0"]
                       - cpu[m]["prop_good_1.0"]) <= 1e-4, (report, cpu)
        # the flow tool on the 96x128 fixtures (its CPU run at 480x640
        # takes ~2 minutes; the chain above runs at 240x320)
        flos = [str(Path(tmp) / f"f{k}.flo") for k in range(2)]
        report = cli("optical_flow_refine", flos[0], suffix="_small")
        cli("optical_flow_refine", flos[1], "--device", "cpu",
            suffix="_small")
        fw, fc = (torch.from_numpy(read_flo(f)) for f in flos)
        assert fw.shape == (96, 128, 2) and torch.isfinite(fw).all()
        print(f"CLI optical_flow_refine 96x128 (r=2, -s 3): "
              f"{json.dumps(report)}", flush=True)
        hold_to_cpu("CLI optical_flow_refine output", fw, fc, tol=0.02,
                    bound=float("inf"))


def optim_at_scale(dev, smi):
    """`optim` at users' sizes on the card, each held to the CPU: L0
    smoothing of a 480x640x3 image, a Gauss-Newton fit and a RANSAC line
    fit (30% outliers) of 1M points, the distributed Gauss-Newton on 8
    virtual shards of the card (1M residuals a shard) against the
    single-device fit, the Schur solve at P = 360, k = 200000, s = 3
    against its block system; and the small-system solver against a
    batched SVD and cuSOLVER's batched eigh."""
    from libstevi_tpu_torch import optim
    from libstevi_tpu_torch.optim.lsq import gram, small_lstsq
    from libstevi_tpu_torch.optim.ransac import draw_index_sets
    from libstevi_tpu_torch.parallel import MeshSpec, make_stereo_mesh
    from libstevi_tpu_torch.parallel.schur import (
        distributed_multiview_alignment, schur_complement_solve)

    # -- optim at users' sizes -----------------------------------------------
    rng = np.random.default_rng(40)
    img = np.zeros((480, 640, 3), np.float32)
    for _ in range(40):
        y, x = rng.integers(0, 440), rng.integers(0, 600)
        img[y:y + rng.integers(20, 200), x:x + rng.integers(20, 200)] = \
            rng.uniform(0, 1, 3)
    img = torch.from_numpy(img + rng.normal(0, 0.02, img.shape).astype(
        np.float32)).to(dev)
    sm = optim.l0_smoothing(img)
    hold_to_cpu("l0_smoothing 480x640x3", sm, optim.l0_smoothing(img.cpu()),
                share=0.99, bound=float("inf"))
    ms = median_ms(lambda: optim.l0_smoothing(img), 3)
    print(f"time: l0_smoothing 480x640x3 (22 betas): {ms:.3f} ms (median "
          f"of 3; {smi})", flush=True)

    N = 1 << 20
    t = torch.from_numpy(rng.uniform(0, 1, N).astype(np.float32)).to(dev)
    y = 2.0 * torch.exp(-1.3 * t) + 0.01 * torch.from_numpy(
        rng.normal(size=N).astype(np.float32)).to(dev)

    def resid(p, tt, yy):
        return p[0] * torch.exp(p[1] * tt) - yy

    gn = optim.GaussNewton(resid, iters=10)
    x0 = torch.tensor([1.0, 0.0], device=dev)
    xg = gn.solve(x0, t, y).x
    xc = gn.solve(x0.cpu(), t.cpu(), y.cpu()).x
    torch.testing.assert_close(xg.cpu(), xc, rtol=1e-4, atol=1e-4)
    ms = median_ms(lambda: gn.solve(x0, t, y), 3)
    print(f"GaussNewton exp fit, 1M residuals, 10 steps: x {xg.tolist()}, "
          f"CUDA vs CPU within 1e-4; time {ms:.3f} ms (median of 3; {smi})",
          flush=True)

    xs = torch.from_numpy(rng.uniform(-1, 1, N).astype(np.float32)).to(dev)
    ys = 2.5 * xs + 0.7
    out = torch.from_numpy(rng.random(N) < 0.3).to(dev)
    ys = torch.where(out, torch.from_numpy(rng.uniform(-10, 10, N).astype(
        np.float32)).to(dev), ys)
    sets = draw_index_sets(N, 2, 64, torch.Generator(
        device=dev).manual_seed(0))

    def line(sub):
        return optim.least_squares(torch.stack(
            [sub[0], torch.ones_like(sub[0])], -1), sub[1])

    def refit(dd, w):
        return optim.least_squares(torch.stack(
            [dd[0], torch.ones_like(dd[0])], -1) * w[:, None], dd[1] * w)

    def run_ransac(a, b, s):
        return optim.ransac(line, lambda m, dd: m[0] * dd[0] + m[1] - dd[1],
                            (a, b), 2, 64, 0.05, refit_fn=refit,
                            draw=lambda: s)

    rg = run_ransac(xs, ys, sets)
    rc = run_ransac(xs.cpu(), ys.cpu(), sets.cpu())
    torch.testing.assert_close(rg.model.cpu(), rc.model, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(rg.model.cpu(), torch.tensor([2.5, 0.7]),
                               rtol=0, atol=1e-4)
    agree = (rg.inliers.cpu() == rc.inliers).float().mean().item()
    assert agree >= 0.9999, agree
    ms = median_ms(lambda: run_ransac(xs, ys, sets), 3)
    print(f"ransac line fit, 1M points (30% outliers), 64 hypotheses + "
          f"refit: model {rg.model.tolist()}, inliers {int(rg.n_inliers)}, "
          f"CUDA vs CPU model within 1e-4, inlier masks agree on {agree:.6f}; "
          f"time {ms:.3f} ms (median of 3; {smi})", flush=True)

    t8 = torch.from_numpy(rng.uniform(0, 1, 8 * N).astype(np.float32)).to(dev)
    y8 = (2.0 * torch.exp(-1.3 * t8) + 0.01 * torch.from_numpy(
        rng.normal(size=8 * N).astype(np.float32)).to(dev))
    mesh = make_stereo_mesh(MeshSpec(batch=8), [dev] * 8)

    def dist():
        return distributed_multiview_alignment(
            lambda p, dd: resid(p, *dd), x0, (t8, y8), mesh, "batch",
            iters=10)

    xd = dist()
    xs1 = gn.solve(x0, t8, y8).x
    torch.testing.assert_close(xd, xs1, rtol=1e-5, atol=1e-5)
    ms_d = median_ms(dist, 3)
    ms_s = median_ms(lambda: gn.solve(x0, t8, y8), 3)
    print(f"distributed Gauss-Newton, 8 virtual shards of the card x 1M "
          f"residuals, 10 steps: x {xd.tolist()}, within "
          f"{(xd - xs1).abs().max().item():.3g} of the single-device fit "
          f"(<= 1e-5); time {ms_d:.3f} ms, single device {ms_s:.3f} ms "
          f"(medians of 3; {smi})", flush=True)
    del t8, y8

    P, k, s = 360, 200000, 3
    g = torch.Generator(device=dev).manual_seed(5)
    Bm = torch.randn(k, s, s, device=dev, generator=g)
    C = Bm @ Bm.mT + torch.eye(s, device=dev)
    E = 0.01 * torch.randn(P, k, s, device=dev, generator=g)
    Q = torch.randn(P, P, device=dev, generator=g) / P ** 0.5
    App = 200.0 * torch.eye(P, device=dev) + Q @ Q.T
    bp = torch.randn(P, device=dev, generator=g)
    bs = torch.randn(k, s, device=dev, generator=g)
    dp, ds = schur_complement_solve(App, E, C, bp, bs)
    rp = App @ dp + torch.einsum("pks,ks->p", E, ds) - bp
    rs = torch.einsum("pks,p->ks", E, dp) + torch.einsum(
        "kst,kt->ks", C, ds) - bs
    rel = max(rp.norm().item() / bp.norm().item(),
              rs.norm().item() / bs.norm().item())
    assert rel < 1e-4, rel
    dpc, dsc = schur_complement_solve(*(x.cpu() for x in (App, E, C, bp, bs)))
    torch.testing.assert_close(dp.cpu(), dpc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ds.cpu(), dsc, rtol=1e-4, atol=1e-4)
    ms = median_ms(lambda: schur_complement_solve(App, E, C, bp, bs), 3)
    print(f"schur_complement_solve P=360 k=200000 s=3: block-system relative "
          f"residual {rel:.3g}, CUDA vs CPU within 1e-4; time {ms:.3f} ms "
          f"(median of 3; {smi})", flush=True)
    del E, C, Bm

    # -- the small-system solver against a batched SVD -----------------------
    A = torch.randn(307200, 49, 3, device=dev, generator=g)
    bb = torch.randn(307200, 49, device=dev, generator=g)
    ms_h = median_ms(lambda: small_lstsq(A, bb), 3)
    n_svd = 4096
    ms_svd = median_ms(lambda: torch.linalg.svd(A[:n_svd],
                                                full_matrices=False), 1)
    print(f"time: small_lstsq over 307200 (49, 3) systems (the symmetric "
          f"ZNCC refinement's first solve: the Gram matrices through "
          f"batched Jacobi rotations in float64): "
          f"{ms_h:.3f} ms; torch.linalg.svd of {n_svd} of them: "
          f"{ms_svd:.3f} ms, {ms_svd / n_svd * 1e3:.3f} us a matrix, "
          f"{ms_svd / n_svd * 307200:.1f} ms for 307200 at that rate "
          f"({smi})", flush=True)
    # cuSOLVER's batched eigh (torch.linalg.eigh) on the same Gram
    # matrices: its time at a batch of 1024, and whether it takes 32768
    # (the measurement is the library's refusal, not a phase's failure)
    G = gram(A[:32768].double(), A[:32768].double())
    ms_e = median_ms(lambda: torch.linalg.eigh(G[:1024]), 3)
    try:
        torch.linalg.eigh(G)
        takes = "takes"
    except torch.linalg.LinAlgError:
        takes = "refuses"
    print(f"time: torch.linalg.eigh of 1024 of their (3, 3) float64 Gram "
          f"matrices: {ms_e:.3f} ms ({ms_e / 1024 * 307200:.1f} ms for "
          f"307200 at that rate); it {takes} a batch of 32768 ({smi})",
          flush=True)
    del A, bb, G
    torch.cuda.empty_cache()


# the JAX tool's report for `python cli/ray_alignment_eval.py -n 20 --rays
# 60 --noise 0.002 --outliers 0.1` (seed 0, JAX_PLATFORMS=cpu): the port's
# CLI on the card makes the same data; its Gauss-Newton and relaxed medians
# are held to these within 1e-2 relative, its robust medians (torch's
# draws, not JAX's keys) to 3x, the order of JAX's own error
JAX_RAY_CLI = {
    "gauss-newton": {"rot_deg_median": 10.614458084106445,
                     "trans_median": 1.3948586564575345},
    "relaxed": {"rot_deg_median": 15.141662120819092,
                "trans_median": 2.177614197335447},
    "robust": {"rot_deg_median": 0.969141274690628,
               "trans_median": 0.11211040455942417}}
# `tests/test_rig_and_stats.py:19-24`'s rig with Brown distortion added to
# both cameras (`tests/test_torch_statistics.py`'s DIST)
RIG = dict(r_cam2_to_cam1=[0.0, 0.02, 0.01], t_cam2_to_cam1=[1.0, 0.02, 0.01],
           f1=500.0, pp1=(320.0, 240.0), f2=505.0, pp2=(318.0, 242.0),
           k1=[-0.08, 0.02, 0.0], t1=[0.0005, -0.0003],
           k2=[-0.06, 0.015, 0.0], t2=[-0.0004, 0.0002])


def rig(scale, size, dev):
    """`RIG` with focal lengths and principal points scaled, for images of
    ``size`` (width, height)."""
    from libstevi_tpu_torch.geometry.stereorigrectifier import (
        StereoRigRectifier)
    kw = dict(RIG, f1=RIG["f1"] * scale, f2=RIG["f2"] * scale,
              pp1=tuple(p * scale for p in RIG["pp1"]),
              pp2=tuple(p * scale for p in RIG["pp2"]))
    return StereoRigRectifier(**kw, size1=size, size2=size, device=dev)


def ray_pairs(N, seed=16, noise=0.002, outliers=0.1):
    """N ray pairs made as `cli/ray_alignment_eval.py:52-79` makes one
    trial's (numpy, from ``seed``): the true (R, t), the four (N, 3)
    float32 arrays and the mask of the pairs left unscrambled."""
    from libstevi_tpu_torch.geometry.rotations import rodrigues_formula
    rng = np.random.default_rng(seed)
    rvec = rng.normal(0, 0.4, 3)
    t = rng.normal(0, 1.0, 3)
    R = rodrigues_formula(torch.tensor(rvec, dtype=torch.float32)).numpy()
    pts = rng.normal(0, 2.0, (N, 3)) + np.asarray([0, 0, 6.0])
    o2 = rng.normal(0, 0.5, (N, 3))
    v2 = pts - o2
    v2 /= np.linalg.norm(v2, axis=1, keepdims=True)
    o1 = rng.normal(0, 0.5, (N, 3))
    v1 = (pts - t) @ R - o1
    v1 /= np.linalg.norm(v1, axis=1, keepdims=True)
    v1 = v1 + rng.normal(0, noise, v1.shape)
    v1 /= np.linalg.norm(v1, axis=1, keepdims=True)
    idx = rng.choice(N, int(outliers * N), replace=False)
    v1[idx] = rng.normal(0, 1, (len(idx), 3))
    v1[idx] /= np.linalg.norm(v1[idx], axis=1, keepdims=True)
    keep = np.ones(N, bool)
    keep[idx] = False
    return R, t, [a.astype(np.float32) for a in (o1, v1, o2, v2)], keep


def pose_error(T, R, t):
    """(rotation error in degrees, translation error) as the CLI reports
    them."""
    dR = T.R.cpu().numpy() @ R.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    return float(ang), float(np.linalg.norm(T.t.cpu().numpy() - t))


def geometry(dev, smi):
    """The `geometry` phase: ray alignment at 1M pairs, a rectified pair
    through the flagship (and the HD path), the ray-alignment CLI and the
    single-camera rectifier, each held to the CPU.  The CLI (host-bound,
    ~4 minutes) runs as a subprocess beside the checks and the CPU
    references; every timing is taken after it has ended.  Returns the
    rectified frame's launches {K1 stats, K1, K2x7, K3x7}."""
    t_phase = time.perf_counter()

    def stamp(what):
        print(f"  [geometry] {what}: {time.perf_counter() - t_phase:.1f} s "
              f"into the phase", flush=True)

    cli = subprocess.Popen(
        [sys.executable, "-m", "libstevi_tpu_torch.cli.ray_alignment_eval",
         "-n", "20", "--rays", "60", "--noise", "0.002", "--outliers", "0.1"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        state = geometry_checks(dev, stamp)
        # -- (c) the ray-alignment CLI on the card -----------------------------
        out, err = cli.communicate(timeout=900)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    assert cli.returncode == 0, err
    report = json.loads(out.strip().splitlines()[-1])
    print(f"CLI ray_alignment_eval -n 20 --rays 60 --noise 0.002 --outliers "
          f"0.1 on the card (beside the checks; "
          f"{time.perf_counter() - t_phase:.1f} s from its start): "
          f"{json.dumps(report)}", flush=True)
    for s, want in JAX_RAY_CLI.items():
        for k, v in want.items():
            got = report[s][k]
            if s == "robust":
                assert got <= 3 * v, (s, k, got, v)
            else:
                assert abs(got - v) <= 1e-2 * v, (s, k, got, v)
    stamp("the CLI")
    geometry_times(dev, smi, state, stamp)
    torch.cuda.empty_cache()
    return state["launches"]


def geometry_checks(dev, stamp):
    """The `geometry` phase's checks, each against the CPU; returns what
    `geometry_times` times."""
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.core import MatchingFunction
    from libstevi_tpu_torch.geometry import ImageRectifier
    from libstevi_tpu_torch.geometry.raysalignment import (
        align_rays_sets, relaxed_align_rays_sets, robust_align_rays_sets)
    from libstevi_tpu_torch.ops import dense_sgm_stereo
    from libstevi_tpu_torch.ops.box_cuda import box_cv, window_stats
    from libstevi_tpu_torch.ops.sgm_cuda import direction_volumes, sgm_wta
    from libstevi_tpu_torch.optim.ransac import draw_index_sets
    from libstevi_tpu_torch.statistics import compute_covering_proportion

    # -- (a) ray alignment at 1M pairs ---------------------------------------
    N = 1 << 20
    R, t, arrs, keep = ray_pairs(N)
    full, full_c = geometry_rays(arrs, dev), geometry_rays(arrs, "cpu")
    inl = geometry_rays([a[keep] for a in arrs], dev)
    sets = draw_index_sets(N, 6, 64, torch.Generator(device=dev).manual_seed(0))
    sets_in = draw_index_sets(int(keep.sum()), 6, 64,
                              torch.Generator(device=dev).manual_seed(0))
    solvers = {
        "align_rays_sets (GN, 50 steps)": (align_rays_sets, {}),
        "relaxed_align_rays_sets (thin SVD of the (N, 18) matrix)":
            (relaxed_align_rays_sets, {}),
        "robust_align_rays_sets (64 hypotheses, threshold 1e-3)":
            (robust_align_rays_sets, dict(draw=lambda: sets)),
    }
    tol = 1e-3
    for name, (fn, kw) in solvers.items():
        got = fn(*full, **kw)
        kw_c = dict(draw=lambda: sets.cpu()) if kw else {}
        want = fn(*full_c, **kw_c)
        dR = (got.R.cpu() - want.R).abs().max().item()
        dt = (got.t.cpu() - want.t).abs().max().item()
        rot, tr = pose_error(got, R, t)
        print(f"geometry: {name}, {N} ray pairs (noise 0.002, 10% "
              f"outliers): CUDA vs CPU R within {dR:.3g}, t within {dt:.3g} "
              f"(<= {tol:g}); pose error {rot:.4f} deg, {tr:.4f}", flush=True)
        assert dR <= tol and dt <= tol, (name, dR, dt)
        stamp(name.split()[0])
    # recovery on the unscrambled pairs, at the JAX tool's bars (its robust
    # medians on 60 rays: 0.969 deg, 0.112)
    bars = (JAX_RAY_CLI["robust"]["rot_deg_median"],
            JAX_RAY_CLI["robust"]["trans_median"])
    for name, fn, kw in (
            ("align_rays_sets", align_rays_sets, {}),
            ("relaxed_align_rays_sets", relaxed_align_rays_sets, {}),
            ("robust_align_rays_sets", robust_align_rays_sets,
             dict(draw=lambda: sets_in))):
        rot, tr = pose_error(fn(*inl, **kw), R, t)
        print(f"geometry: {name} on the {int(keep.sum())} unscrambled pairs: "
              f"pose error {rot:.4f} deg, {tr:.4f} (bars {bars[0]:.3f} deg, "
              f"{bars[1]:.3f})", flush=True)
        assert rot <= bars[0] and tr <= bars[1], (name, rot, tr)
    del full_c, inl
    stamp("rays")

    # -- (b) a rectified pair through the flagship ---------------------------
    ZNCC = MatchingFunction.ZNCC
    rg, rc = rig(1.0, (640, 480), dev), rig(1.0, (640, 480), "cpu")
    assert rg.compute("minimal") and rc.compute("minimal")
    errs = []
    for a, b in ((rg.backward_cam1, rc.backward_cam1),
                 (rg.backward_cam2, rc.backward_cam2)):
        assert a.shape == (480, 640, 2), a.shape
        errs.append((a.cpu() - b).abs().max().item())
    print(f"geometry: rig maps 480x640x2 (minimal ROI, Brown distortion): "
          f"CUDA vs CPU within {errs[0]:.3g} / {errs[1]:.3g} px (<= 1e-3); "
          f"new focal {rg.reprojection_flen:.3f}, disp delta "
          f"{rg.disp_delta:.3f}", flush=True)
    assert max(errs) <= 1e-3, errs
    L, Rr = pair(480, 640, 16, dev)
    lc, rci = rectify(rc, L.cpu(), Rr.cpu())
    for fn in (window_stats, box_cv, direction_volumes, sgm_wta):
        fn.launches = 0
    torch.cuda.synchronize()
    lg, rgi = rectify(rg, L, Rr)
    disp, idx, tcv = dense_sgm_stereo(ZNCC, lg, rgi, **entry.FLAGSHIP)
    share = compute_covering_proportion(disp, disp)
    torch.cuda.synchronize()
    launches = {"K1 stats": window_stats.launches, "K1": box_cv.launches,
                "K2x7": direction_volumes.launches,
                "K3x7": sgm_wta.launches}
    print(f"geometry: rectified 480x640 pair -> flagship: launches "
          f"{launches}", flush=True)
    assert all(n > 0 for n in launches.values()), launches
    for a, b in ((lg, lc), (rgi, rci)):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-3, err
    disp_c, idx_c, tcv_c = dense_sgm_stereo(ZNCC, lc, rci, **entry.FLAGSHIP)
    stamp("the CPU's flagship")
    same = idx.cpu() == idx_c
    agree = same.float().mean().item()
    # the repo's bf16 rule (`tests/test_torch_stereo.py`, the bars of
    # `tests/test_sgm.py:240-259`): WTA indices agree, and where they do
    # the bands within atol 0.1, rtol 0.02 (K1's bf16 volume, K2's f32 sums
    # in another order); the parabola through them moves a refined
    # disparity by up to a few 1e-2 px where the curvature is small
    # (resampled noise is smooth): < 0.1 px
    fin = torch.isfinite(tcv_c[same])
    band_err = (tcv.cpu() - tcv_c)[same][fin].abs().max().item()
    dd = (disp.cpu() - disp_c)[same & torch.isfinite(disp_c)].abs()
    print(f"  rectified flagship: WTA index CUDA vs CPU agree on "
          f"{agree:.6f}; where they agree the bands within {band_err:.3g}, "
          f"the refined disparities within 1e-3 px on "
          f"{(dd <= 1e-3).float().mean().item():.6f}, 1e-2 px on "
          f"{(dd <= 1e-2).float().mean().item():.6f}, max "
          f"{dd.max().item():.4f} px", flush=True)
    assert agree >= 0.999, agree
    assert torch.equal(torch.isfinite(tcv.cpu())[same], torch.isfinite(
        tcv_c)[same])
    torch.testing.assert_close(tcv.cpu()[same][fin], tcv_c[same][fin],
                               rtol=0.02, atol=0.1)
    assert torch.equal(torch.isfinite(disp.cpu())[same],
                       torch.isfinite(disp_c)[same])
    assert dd.max().item() < 0.1, dd.max().item()
    share_c = compute_covering_proportion(disp.cpu(), disp.cpu())
    print(f"  covering share {share.item():.6f}, CPU on the same disparity "
          f"{share_c.item():.6f} (<= 1e-5); the CPU chain's "
          f"{compute_covering_proportion(disp_c, disp_c).item():.6f}",
          flush=True)
    assert abs(share.item() - share_c.item()) <= 1e-5, (share, share_c)
    del disp_c, idx_c, tcv_c, lc, rci

    # the same rig at 720x1280 (focal lengths and principal points x1.5)
    # through the HD path
    rh, rhc = rig(1.5, (1280, 720), dev), rig(1.5, (1280, 720), "cpu")
    assert rh.compute("minimal") and rhc.compute("minimal")
    err_hd = max(
        (rh.backward_cam1.cpu() - rhc.backward_cam1).abs().max().item(),
        (rh.backward_cam2.cpu() - rhc.backward_cam2).abs().max().item())
    assert rh.backward_cam1.shape == (720, 1280, 2), rh.backward_cam1.shape
    assert err_hd <= 1e-3, err_hd
    Lh, Rh = pair(720, 1280, 17, dev)
    dh, ih, _ = dense_sgm_stereo(ZNCC, *rectify(rh, Lh, Rh),
                                 **entry.HD_BF16)
    print(f"geometry: rig maps 720x1280x2: CUDA vs CPU within {err_hd:.3g} "
          f"px (<= 1e-3)", flush=True)
    check_random("rectified HD", dh, ih, 320)
    del dh, ih
    stamp("rectified frames")

    # -- (d) the single-camera rectifier at 480x640 ---------------------------
    for roi in ("same", "maximal", "minimal"):
        ir = [ImageRectifier(RIG["f1"], RIG["pp1"], (480, 640),
                             k123=RIG["k1"], t12=RIG["t1"], device=d)
              for d in (dev, "cpu")]
        assert all(r.compute(roi) for r in ir), roi
        assert np.array_equal(ir[0].roi_top_left, ir[1].roi_top_left)
        assert np.array_equal(ir[0].roi_bottom_right, ir[1].roi_bottom_right)
        err = (ir[0].backward_map.cpu() - ir[1].backward_map).abs().max().item()
        print(f"geometry: ImageRectifier 480x640 '{roi}': map "
              f"{tuple(ir[0].backward_map.shape)}, ROI "
              f"{ir[0].roi_top_left.tolist()}-"
              f"{ir[0].roi_bottom_right.tolist()}, CUDA vs CPU within "
              f"{err:.3g} px (<= 1e-3)", flush=True)
        assert err <= 1e-3, (roi, err)
    stamp("ImageRectifier")
    return dict(N=N, arrs=arrs, full=full, sets=sets, solvers=solvers,
                rg=rg, L=L, Rr=Rr, disp=disp, rh=rh, Lh=Lh, Rh=Rh,
                launches=launches)


def geometry_rays(arrays, device):
    """(rays1, rays2) of the four (N, 3) arrays on ``device``."""
    from libstevi_tpu_torch.geometry.raysalignment import RayInfos
    o1, v1, o2, v2 = (torch.from_numpy(a).to(device) for a in arrays)
    return RayInfos(o1, v1), RayInfos(o2, v2)


def rectify(r, a, b):
    """A pair resampled through a rig's two backward maps."""
    from libstevi_tpu_torch.interpolation import resample_image
    return (resample_image(a, r.backward_cam1),
            resample_image(b, r.backward_cam2))


def geometry_times(dev, smi, st, stamp):
    """The `geometry` phase's timings (CUDA events), peak memory and
    profiles, on what `geometry_checks` left."""
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.geometry import ImageRectifier
    from libstevi_tpu_torch.geometry.raysalignment import align_rays_sets
    from libstevi_tpu_torch.profile_frames import profile_frame
    from libstevi_tpu_torch.statistics import compute_covering_proportion

    def timed(fn, reps):
        """(median ms of ``reps`` CUDA-event timings after a warm-up, the
        peak bytes above what was allocated before)."""
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(fn, reps, warmup=0)
        return ms, torch.cuda.max_memory_allocated() - base

    full = st["full"]
    for name, (fn, kw) in st["solvers"].items():
        # the robust solver takes seconds a call (host-bound): one timing
        reps = 1 if "robust" in name else 3
        ms, peak = timed(lambda: fn(*full, **kw), reps)
        print(f"time: {name}, {st['N']} ray pairs: {ms:.3f} ms (median of "
              f"{reps} after a warm-up; {smi}); memory: peak "
              f"{peak / 1e9:.3f} GB above the rays (0.050 GB)", flush=True)
    # where the robust solver's time goes: 64 minimal fits of 20 GN steps
    # in series (each step a jacfwd, a solve and a host read), then a
    # weighted refit over all pairs.  One fit is profiled (the whole call
    # issues ~250000 device items, and the profiler's own cost on that
    # many host events is minutes)
    six = geometry_rays([a[:6] for a in st["arrs"]], dev)
    fit = lambda: align_rays_sets(*six, iters=20)  # noqa: E731
    fit_ms = median_ms(fit, 5)
    busy, items = profile_frame(fit, 3)
    print(f"geometry: one minimal fit of robust_align_rays_sets (6 pairs, "
          f"20 GN steps): {fit_ms:.3f} ms (median of 5), x64 = "
          f"{64 * fit_ms:.1f} ms; device busy {busy / 1e3:.3f} ms a fit, "
          f"idle {1 - busy / 1e3 / fit_ms:.3f}, {n_items(items):.0f} device "
          f"items a fit, top {top_items(items, 4)} ({smi})", flush=True)
    del st["full"], full
    stamp("ray timings")

    rg, L, Rr, disp = st["rg"], st["L"], st["Rr"], st["disp"]
    maps_ms = median_ms(lambda: rig(1.0, (640, 480), dev).compute("minimal"))
    res_ms = median_ms(lambda: rectify(rg, L, Rr))
    cov_ms = median_ms(lambda: compute_covering_proportion(disp, disp))

    def frame():
        d = entry.flagship_forward(*rectify(rg, L, Rr))
        return compute_covering_proportion(d, d)

    frame_ms = median_ms(frame)
    peak = peak_bytes(frame)
    busy, items = profile_frame(frame, 3)
    print(f"time: rig maps 480x640 (StereoRigRectifier.compute, both "
          f"cameras): {maps_ms:.3f} ms; resample both images: {res_ms:.3f} "
          f"ms; covering share: {cov_ms:.3f} ms; rectified frame (resample "
          f"+ flagship + covering): {frame_ms:.3f} ms (medians of 5; {smi});"
          f" memory: peak {peak / 1e9:.3f} GB above the inputs; profile (3 "
          f"frames): device busy {busy / 1e3:.3f} ms a frame, idle "
          f"{1 - busy / 1e3 / frame_ms:.3f}, top {top_items(items, 6)}",
          flush=True)
    rh, Lh, Rh = st["rh"], st["Lh"], st["Rh"]
    hd_maps = median_ms(lambda: rig(1.5, (1280, 720), dev).compute(
        "minimal"))
    hd_ms = median_ms(lambda: entry.hd_forward(*rectify(rh, Lh, Rh)))
    print(f"time: rig maps 720x1280: {hd_maps:.3f} ms; rectified HD frame "
          f"(resample + hd_forward, D=320 bf16): {hd_ms:.3f} ms (medians of "
          f"5; {smi})", flush=True)
    for roi in ("same", "maximal", "minimal"):
        ms = median_ms(lambda: ImageRectifier(
            RIG["f1"], RIG["pp1"], (480, 640), k123=RIG["k1"],
            t12=RIG["t1"], device=dev).compute(roi))
        print(f"time: ImageRectifier 480x640 '{roi}' compute: {ms:.3f} ms "
              f"(median of 5; {smi})", flush=True)
    stamp("timings")


# -- the sparse chain and calibration targets (`sparse`) ---------------------

# the JAX tools' reports on the parity fixture (cli/tie_points.py -n 256
# --f 500, JAX_PLATFORMS=cpu)
JAX_TIE_POINTS = {"harris": {"n_left": 244, "n_right": 248, "n_matches": 244},
                  "fast": {"n_left": 0, "n_right": 24, "n_matches": 0}}
# the 4K UHD texture pair: right = T[12:12 + H, 37:37 + W], so a left
# keypoint (x, y) lies at (x - 37, y - 12) on the right; the JAX package's
# chain on the CPU keeps 1006 / 1005 keypoints (0.963 of the matches
# within 1 px of the shift)
UHD_SPARSE = (2160, 3840)
UHD_SHIFT = (12, 37)
JAX_UHD_KEYPOINTS = (1006, 1005)
UHD_GOOD = 0.95
# the rotated-perspective board at 1080x1920: 9x14 squares of 48 px, the
# JAX package's 104 corners (13x8) at 0.0309 px mean and 0.0796 px max
# from the ground truth
BOARD = dict(H=1080, W=1920, n_sq=(9, 14), sq=48.0, origin=(200.0, 150.0),
             theta=0.1, persp=(0.01, 0.005))
BOARD_GRID = (13, 8)
BOARD_BARS = (0.05, 0.1)


def render_board(H=200, W=260, n_sq=(6, 8), theta=0.0, persp=(0.0, 0.0),
                 sharp=2.0, origin=(30.0, 30.0), sq=24.0):
    """A projective checkerboard with its (rows, cols, 2) [x, y] interior
    corners (a numpy copy of `TestCheckerboard._render`,
    `tests/test_imageproc_pipelines.py`): board (u, v) maps to pixels by
    origin + sq * R(theta) (u, v) / w, w = 1 + persp . (u, v), intensity
    0.5 + 0.45 tanh(sharp sin(pi u) sin(pi v)), a white quiet zone."""
    nv, nu = n_sq
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    c, s_ = np.cos(theta), np.sin(theta)
    u = ((xx - origin[0]) * c + (yy - origin[1]) * s_) / sq
    v = (-(xx - origin[0]) * s_ + (yy - origin[1]) * c) / sq
    for _ in range(8):
        w = 1.0 + persp[0] * u + persp[1] * v
        u = ((xx - origin[0]) * c + (yy - origin[1]) * s_) / sq * w
        v = (-(xx - origin[0]) * s_ + (yy - origin[1]) * c) / sq * w
    inside = (u >= 0) & (u <= nu) & (v >= 0) & (v <= nv)
    field = np.sin(np.pi * u) * np.sin(np.pi * v)
    img = np.where(inside, 0.5 + 0.45 * np.tanh(sharp * field), 0.95)
    gt = np.zeros((nv - 1, nu - 1, 2))
    for a in range(1, nv):
        for b in range(1, nu):
            w = 1.0 / (1.0 + persp[0] * b + persp[1] * a)
            bu, bv = b * w, a * w
            gt[a - 1, b - 1] = (origin[0] + sq * (c * bu - s_ * bv),
                                origin[1] + sq * (s_ * bu + c * bv))
    return img.astype(np.float32), gt


HEX_COLORS = {"r": (1.0, 0.08, 0.08), "g": (0.08, 1.0, 0.08),
              "b": (0.08, 0.08, 1.0)}


def render_hex(center=(32.0, 32.0), radius=12.0, phase=0.3, code="bggrgr",
               H=64, W=64, dot_rad=2.6):
    """Six coloured dots on a hexagon on white (a numpy copy of
    `TestHexTargets._render`, `tests/test_imageproc_pipelines.py`)."""
    img = np.ones((H, W, 3), np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    for k, ch in enumerate(code):
        a = phase + k * np.pi / 3
        r = center[0] + radius * np.sin(a)
        c = center[1] + radius * np.cos(a)
        img[(yy - r) ** 2 + (xx - c) ** 2 <= dot_rad ** 2] = HEX_COLORS[ch]
    return img


def run_cli(module, argv):
    """(exit code, the last JSON object printed) of a port CLI's main."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    out = buf.getvalue()
    return rc, json.loads(out[out.index("{"):])


def host_ms(fn, reps=5):
    """Median host wall time of ``fn()`` in ms (work that ends on the
    host, synchronised before and after)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sparse(dev, smi):
    """The `sparse` phase: the port's `tie_points` CLI on the parity
    fixture (card and CPU), the sparse chain at 4K UHD against a known
    shift with each stage timed, `detect_checkerboard` at 1080x1920 (card
    against CPU and the ground truth, the CLI too), and hex targets,
    connected components, edges and the median filter at 1080x1920,
    exactly against the CPU."""
    from libstevi_tpu_torch.cli import detect_checkerboard as dc_cli
    from libstevi_tpu_torch.cli import tie_points as tp_cli
    from libstevi_tpu_torch.imageproc import checkerboard as cb
    from libstevi_tpu_torch.imageproc import median_filter
    from libstevi_tpu_torch.imageproc import connected_components
    from libstevi_tpu_torch.imageproc.edges import detect_edges
    from libstevi_tpu_torch.imageproc.targets import detect_hex_targets
    from libstevi_tpu_torch.io import write_image
    from libstevi_tpu_torch.optim.assignment import match_descriptors
    from libstevi_tpu_torch.profile_frames import profile_frame
    from libstevi_tpu_torch.sparse import descriptors as D
    from libstevi_tpu_torch.sparse.corners import (fast_corner_detection,
                                                   harris_corner_score)
    from libstevi_tpu_torch.sparse.nms import \
        non_local_maximum_point_selection
    from libstevi_tpu_torch.sparse.orientation import \
        intensity_oriented_coordinates
    from scipy.ndimage import gaussian_filter
    cc_mod = sys.modules["libstevi_tpu_torch.imageproc.connected_components"]
    t_phase = time.perf_counter()

    # -- (1) the tie_points CLI on the 480x640 parity fixture ---------------
    pair_args = [str(FIXTURES / "left.stevimg"), str(FIXTURES / "right.stevimg"),
                 "-n", "256", "--f", "500"]
    for det, want in JAX_TIE_POINTS.items():
        argv = pair_args + ["--detector", det]
        t0 = time.perf_counter()
        rc, card_rep = run_cli(tp_cli, argv)
        card_s = time.perf_counter() - t0
        assert rc == 0
        rc, cpu_rep = run_cli(tp_cli, argv + ["--device", "cpu"])
        assert rc == 0
        for rep in (card_rep, cpu_rep):
            assert {k: rep[k] for k in want} == want, (det, rep, want)
        assert list(card_rep) == list(cpu_rep)
        if "n_inliers" in cpu_rep:
            # the same draws (seed 3 on the CPU): the same hypotheses
            assert card_rep["n_inliers"] == cpu_rep["n_inliers"]
            for k in ("rotation", "translation"):
                d = np.abs(np.subtract(card_rep[k], cpu_rep[k])).max()
                assert d <= 1e-4, (k, d)
        print(f"sparse: tie_points CLI 480x640 -n 256 --f 500 --detector "
              f"{det} on the card ({card_s:.2f} s host wall, first call): "
              f"{json.dumps(card_rep)}; the CPU run: {json.dumps(cpu_rep)}",
              flush=True)

    # the pipeline behind the CLI, warm: with the pose (256 RANSAC fits in
    # series) and without it
    from libstevi_tpu_torch.cli.stereo_refine import gray_pair
    fixture = gray_pair(pair_args[:2], dev)
    tp_ms = {f"--f {f}" if f else "no pose": host_ms(
        lambda: tp_cli.tie_points(*fixture, 256, f=f), 3)
        for f in (500.0, None)}
    print(f"time: tie_points 480x640 -n 256 on the card, warm (host clock, "
          f"medians of 3; {smi}): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in tp_ms.items()),
          flush=True)

    # -- (2) the sparse chain at 4K UHD on a textured pair ------------------
    H, W = UHD_SPARSE
    dy, dx = UHD_SHIFT
    rng = np.random.default_rng(0)
    T = gaussian_filter(rng.uniform(0, 1, (H + 64, W + 64)), 2.0)
    T = ((T - T.min()) / (T.max() - T.min())).astype(np.float32)
    L = torch.from_numpy(np.ascontiguousarray(T[:H, :W])).to(dev)
    R = torch.from_numpy(np.ascontiguousarray(T[dy:dy + H, dx:dx + W])).to(
        dev)
    del T
    radius, m = 4, 2 * 4 + 2

    def keypoints(img):
        coords, _, valid = non_local_maximum_point_selection(
            harris_corner_score(img), 4.0, 1024, 0.0)
        c = coords[valid]
        keep = ((c[:, 0] > m) & (c[:, 0] < W - m) & (c[:, 1] > m)
                & (c[:, 1] < H - m))
        return c[keep]

    cl, cr = keypoints(L), keypoints(R)
    assert cl.device.type == dev.type
    dl = D.whitened_pixels_descriptor(cl.flip(-1), L, radius=radius)
    dr = D.whitened_pixels_descriptor(cr.flip(-1), R, radius=radius)
    t0 = time.perf_counter()
    ia, ib = match_descriptors(dl.cpu().numpy(), dr.cpu().numpy())
    assign_first = time.perf_counter() - t0
    off = cl.cpu().numpy()[ia] - cr.cpu().numpy()[ib]
    good = float((np.abs(off - np.array([dx, dy])).max(1) <= 1.0).mean())
    nl, nr = len(cl), len(cr)
    print(f"sparse: 4K UHD chain {H}x{W} (Harris, NMS n=1024 r=4, whitened "
          f"r=4, assignment): n_left {nl}, n_right {nr} (JAX "
          f"{JAX_UHD_KEYPOINTS}), n_matches {len(ia)}, {good:.4f} of the "
          f"matches within 1 px of the shift (JAX on the CPU: 0.963)",
          flush=True)
    assert good >= UHD_GOOD, good
    for n, want in zip((nl, nr), JAX_UHD_KEYPOINTS):
        assert abs(n - want) <= 0.01 * want, (n, want)

    score = harris_corner_score(L)
    rc_l = cl.flip(-1)
    dirs = intensity_oriented_coordinates(rc_l, L, 3)
    pat = D.random_sampling_pattern(256, radius, seed=7)
    words = D.brief_descriptor(rc_l, L, pat, dirs)
    assert words.shape == (nl, 8) and torch.isfinite(dirs).all()
    nms = lambda: non_local_maximum_point_selection(  # noqa: E731
        score, 4.0, 1024, 0.0)
    stages = {
        "Harris": lambda: harris_corner_score(L),
        "FAST (0.05)": lambda: fast_corner_detection(L, 0.05),
        "NMS (n=1024, r=4)": nms,
        "whitened descriptors (r=4)": lambda: D.whitened_pixels_descriptor(
            rc_l, L, radius=radius),
        "orientation (r=3)": lambda: intensity_oriented_coordinates(
            rc_l, L, 3),
        "oriented whitened descriptors (r=4)":
            lambda: D.oriented_whitened_pixels_descriptor(rc_l, L, dirs,
                                                          radius=radius),
        "BRIEF (256 pairs, seed 7, oriented)": lambda: D.brief_descriptor(
            rc_l, L, pat, dirs),
    }
    times = {k: median_ms(fn) for k, fn in stages.items()}
    dl_h, dr_h = dl.cpu().numpy(), dr.cpu().numpy()
    times["assignment (host, scipy)"] = host_ms(
        lambda: match_descriptors(dl_h, dr_h))
    nms_ms = times["NMS (n=1024, r=4)"]
    busy, items = profile_frame(nms, 1)
    nms_peak = peak_bytes(nms)
    print(f"time: sparse chain stages at {H}x{W}, one image (medians of 5 "
          f"after a warm-up, CUDA events; the assignment a host clock, "
          f"first call {assign_first * 1e3:.1f} ms; {smi}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; NMS profile: device busy {busy / 1e3:.3f} ms, idle "
          f"{1 - busy / 1e3 / nms_ms:.3f}, {n_items(items):.0f} device items"
          f", top {top_items(items, 4)}; NMS peak {nms_peak / 1e6:.1f} MB "
          f"above the score map", flush=True)
    del L, R, score, dl, dr, words
    torch.cuda.empty_cache()

    # -- (3) detect_checkerboard at 1080x1920 --------------------------------
    img, gt = render_board(**BOARD)
    img_d = torch.from_numpy(img).to(dev)
    board = cb.detect_checkerboard(img_d)
    board_cpu = cb.detect_checkerboard(torch.from_numpy(img))
    assert board is not None and board_cpu is not None
    assert board.corners.shape[:2] == board_cpu.corners.shape[:2] \
        == BOARD_GRID, (board.corners.shape, board_cpu.corners.shape)
    assert board.n_points_found == gt[..., 0].size
    det = board.corners.reshape(-1, 2)
    d_gt = np.linalg.norm(det[:, None] - gt.reshape(-1, 2)[None],
                          axis=-1).min(1)
    card_cpu = float(np.abs(board.corners - board_cpu.corners).max())
    print(f"sparse: detect_checkerboard {BOARD['H']}x{BOARD['W']} (9x14 "
          f"squares of 48 px, theta 0.1, persp (0.01, 0.005)): "
          f"{board.rows}x{board.cols} grid, {board.n_points_found} corners, "
          f"{d_gt.mean():.4f} px mean and {d_gt.max():.4f} px max from the "
          f"ground truth (JAX: 0.0309 / 0.0796); card vs CPU {card_cpu:.2e} "
          f"px", flush=True)
    assert d_gt.mean() <= BOARD_BARS[0] and d_gt.max() <= BOARD_BARS[1]
    assert card_cpu <= 1e-3
    cands = cb.checkerboard_corner_candidates(img_d)
    thr = 0.05 * float((-cands.lmin).max())
    cands = cb.filter_checkerboard_candidates(
        img_d, cands[(cands.lmin <= -thr) & (cands.lmax >= thr)])
    grid = cb.isolate_checkerboard(cands)
    ks = grid._candidate_idx[grid._candidate_idx >= 0]
    fit_args = (img_d, cands.x[ks], cands.y[ks], cands.main_dir[ks])
    cb_times = {
        "response": median_ms(lambda: cb.checkerboard_response(img_d)),
        "candidates (with the host copy)": median_ms(
            lambda: cb.checkerboard_corner_candidates(img_d)),
        f"corner fit ({len(ks)} corners)": median_ms(
            lambda: cb.fit_checkerboard_corners(*fit_args)),
        "detect_checkerboard": median_ms(lambda: cb.detect_checkerboard(
            img_d)),
    }
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "board.stevimg")
        write_image(path, img)
        reps = [run_cli(dc_cli, [path] + extra)
                for extra in ([], ["--device", "cpu"])]
    assert reps[0] == reps[1] and reps[0][0] == 0 \
        and reps[0][1]["n_points"] == gt[..., 0].size, reps
    print(f"time: checkerboard {BOARD['H']}x{BOARD['W']} (medians of 5; "
          f"{smi}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                  cb_times.items())
          + f"; the CLI on the card and on the CPU: {json.dumps(reps[0][1])}",
          flush=True)

    # -- (4) targets, labels, edges and the median at 1080x1920 --------------
    Hb, Wb = BOARD["H"], BOARD["W"]
    frame = np.ones((Hb, Wb, 3), np.float32)
    codes = ["bggrgr", "grbgrg", "rrbggr", "gbrrgg"]
    spots = [(y, x) for y in (200, 700) for x in (200, 650, 1100, 1550)]
    for i, (y, x) in enumerate(spots):
        frame[y:y + 64, x:x + 64] = render_hex(phase=0.3 + 0.4 * i,
                                               code=codes[i % 4])
    n_targets = len(spots)
    frame_d = torch.from_numpy(frame).to(dev)
    targets = detect_hex_targets(frame_d)
    targets_cpu = detect_hex_targets(torch.from_numpy(frame))
    assert len(targets) == len(targets_cpu) == n_targets, \
        (len(targets), len(targets_cpu), n_targets)
    for a, b in zip(targets, targets_cpu):
        for f in ("pos_ref_dot", "dots_positives", "dots_positions"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    hex_sweeps = cc_mod.connected_components.sweeps

    noise = gaussian_filter(np.random.default_rng(1).uniform(0, 1, (Hb, Wb)),
                            4.0)
    mask = noise > np.quantile(noise, 0.7)
    mask_d = torch.from_numpy(mask).to(dev)
    sweeps = {"hex targets' components": hex_sweeps}
    for contiguity in ("queen", "rook"):
        lab = connected_components(mask_d, contiguity)
        sweeps[f"components ({contiguity})"] = \
            cc_mod.connected_components.sweeps
        exact(lab.cpu(), connected_components(torch.from_numpy(mask),
                                              contiguity),
              f"connected_components {contiguity} {Hb}x{Wb}")
    edges = detect_edges(img_d)
    sweeps["edge hysteresis"] = detect_edges.sweeps
    exact(edges.cpu(), detect_edges(torch.from_numpy(img)),
          f"detect_edges {Hb}x{Wb}")
    noisy = img + np.random.default_rng(2).normal(0, 0.05, img.shape).astype(
        np.float32)
    for r in (1, 2):
        exact(median_filter(torch.from_numpy(noisy).to(dev), r).cpu(),
              median_filter(torch.from_numpy(noisy), r),
              f"median_filter r={r} {Hb}x{Wb}")
    noisy_d = torch.from_numpy(noisy).to(dev)
    im_times = {
        # host-bound (a full-frame mask a dot): 3 timings
        "detect_hex_targets (median of 3)": median_ms(
            lambda: detect_hex_targets(frame_d), 3),
        "connected_components (queen)": median_ms(
            lambda: connected_components(mask_d)),
        "detect_edges": median_ms(lambda: detect_edges(img_d)),
        "median_filter r=1": median_ms(lambda: median_filter(noisy_d, 1)),
        "median_filter r=2": median_ms(lambda: median_filter(noisy_d, 2)),
    }
    print(f"sparse: at {Hb}x{Wb}, {n_targets} hex targets, the labels "
          f"(queen, rook), the edges ({int(edges.sum())} pixels) and the "
          f"median (r = 1, 2) equal the CPU's; sweeps to the fixed point "
          f"(blocks of 16): {sweeps}", flush=True)
    print(f"time: imageproc at {Hb}x{Wb} (medians of 5; {smi}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in im_times.items()),
          flush=True)
    torch.cuda.empty_cache()
    print(f"sparse phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# a rectangle where both fixtures' background disparity is at most 28 (their
# ground truth), pasted at disparity 100
BGFG_FIXTURE = dict(rect=(280, 440, 30, 230), d_fg=100, D=120)
BGFG_BARS = (0.95, 0.01)
NORMAL_CPU = (68, 120)
# the bar on the median angle (degrees) of the chain's normals to the
# dome's true ones where the shading is below 0.999 (at 1 the clip leaves
# only rounding noise): `tests/test_torch_cli_pipelines.py` holds the
# chain under it on a 48x80 dome and the initial estimate above it
NORMAL_TRUTH_BAR = 18.0
MEANSHIFT_N = (16384, 1024)


def render_dome(H, W, light=(0.3, 0.1, 0.95)):
    """A shallow sphere cap (radius 1.2 H) under a Lambertian light,
    shading n.l clipped to [0, 1] (no plateau at 1 away from n = l).
    Returns the float32 shading and the float64 normals."""
    ii, jj = np.mgrid[0:H, 0:W].astype(np.float64)
    R = 1.2 * H
    z = np.sqrt(np.maximum(R * R - (ii - H / 2) ** 2 - (jj - W / 2) ** 2,
                           1e-6))
    n = np.stack([(jj - W / 2) / R, (ii - H / 2) / R, z / R], -1)
    lhat = np.asarray(light, np.float64)
    lhat /= np.linalg.norm(lhat)
    return np.clip(n @ lhat, 0, 1).astype(np.float32), n


def bgfg_occluded(rect, bg_idx, d_fg):
    """Pixels outside ``rect`` (a bool mask in the right image) whose
    background match (column + bg_idx) falls on the object pasted
    ``d_fg`` columns right in the left image: background hidden behind the
    object, which the estimator rightly calls dissimilar."""
    rows, cols = np.nonzero(rect)
    c0, c1 = cols.min(), cols.max() + 1
    jj = np.arange(rect.shape[1])[None, :] + bg_idx
    band = (jj >= c0 + d_fg) & (jj < c1 + d_fg)
    band[:rows.min()] = False
    band[rows.max() + 1:] = False
    return band & ~rect


def dilate_np(mask, radius):
    """A bool mask dilated by a (2 radius + 1)^2 square (the port's
    `morphology.dilation` on the CPU)."""
    from libstevi_tpu_torch.imageproc.morphology import dilation
    return dilation(torch.from_numpy(mask.astype(np.float32)),
                    radius=radius).numpy() > 0.5


def hold_bgfg(tag, mask, rect, excluded=None):
    """The foreground mask against the pasted rectangle: >= BGFG_BARS[0]
    inside, <= BGFG_BARS[1] outside (outside ``excluded`` where given).
    Returns (inside, outside, outside raw)."""
    inside = float(mask[rect].mean())
    outside_raw = float(mask[~rect].mean())
    keep = ~rect if excluded is None else ~(rect | excluded)
    outside = float(mask[keep].mean())
    print(f"  {tag}: foreground share {inside:.5f} inside the rectangle "
          f"(bar >= {BGFG_BARS[0]}), {outside:.5f} outside"
          + ("" if excluded is None else
             f" the rectangle's reach and the occluded band "
             f"({outside_raw:.5f} with them)")
          + f" (bar <= {BGFG_BARS[1]})", flush=True)
    assert inside >= BGFG_BARS[0] and outside <= BGFG_BARS[1], (tag, inside,
                                                                 outside)
    return inside, outside, outside_raw


def bgfg_card_vs_cpu(tag, card, cpu, cpu_ratio, bg_idx, live_idx, thr):
    """Card against the CPU run: the WTA indices' agreement; the mask and
    the disparities equal wherever both runs' indices agree within the
    rule's reach (radius 3: the opening and the dilation) and the CPU's
    cost ratio is not within 1e-4 of the threshold."""
    agree_bg = bg_idx[0] == bg_idx[1]
    agree_live = live_idx[0] == live_idx[1]
    shaky = ~(agree_bg & agree_live) | (np.abs(cpu_ratio - thr) < 1e-4)
    reach = dilate_np(shaky, 3)
    m_eq = card.fg_mask.cpu().numpy() == cpu.fg_mask.numpy()
    d_eq = card.disp.cpu().numpy() == cpu.disp.numpy()
    share = (float(agree_bg.mean()), float(agree_live.mean()))
    print(f"  {tag}: card vs CPU: background / live WTA indices agree on "
          f"{share[0]:.6f} / {share[1]:.6f}; mask and disparities equal on "
          f"{float((m_eq & d_eq).mean()):.6f} of the pixels, on all "
          f"{int((~reach).sum())} where the indices agree within radius 3 "
          f"and the ratio is off the threshold", flush=True)
    assert min(share) >= 0.999, (tag, share)
    assert (m_eq & d_eq)[~reach].all(), tag
    return share


def bgfg_cpu_run(bl, br, ll, lr, D):
    """The estimator's CPU run, keeping its live volume for the ratio."""
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.core import MATCH_TRAITS
    from libstevi_tpu_torch.ops.cost_volume import (
        extract_selected_index, feature_volume_to_cost_volume)
    from libstevi_tpu_torch.ops.unfold import unfold
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (bl, br, ll, lr)]
    est = entry.bg_fg_background(t[0], t[1], disp_width=D)
    r = entry.BGFG["radius"]
    live_cv = feature_volume_to_cost_volume(est.func, unfold(r, r, t[2]),
                                            unfold(r, r, t[3]), est.search)
    res = est.compute_disp_and_foreground_mask(live_cv)
    idx = est.bg_idx[..., None].long()
    c_bg = torch.gather(est.bg_cv, -1, idx)[..., 0]
    c_fg = torch.gather(live_cv, -1, idx)[..., 0]
    lo, hi = torch.minimum(c_bg, c_fg), torch.maximum(c_bg, c_fg)
    ratio = (lo / torch.where(hi.abs() > 1e-12, hi, 1e-12)).numpy()
    live_idx = extract_selected_index(live_cv,
                                      MATCH_TRAITS[est.func].strategy)
    return res, ratio, est.bg_idx.numpy(), live_idx.numpy()


def pipelines(dev, smi):
    """The `pipelines` phase: `entry.bg_fg_forward`
    and the `bg_fg_stereo` CLI at 1080x1920, D = 192 (K5 twice a frame,
    held to its plain version there; the mask to the pasted rectangle; the
    card to the CPU) and on the 480x640 fixtures at D = 120; the FFT
    retinex and the normal-map chain at 1080x1920 on a rendered dome (the
    chain held to the dome's true normals; it is ill-conditioned, so to
    the CPU only at 68x120), the RGB non-local retinex at 96x96;
    graph-cut segmentation at 1080x1920, inpainting and mean shift; each
    stage timed (CUDA events on the card, the host clock for host stages)
    and held to the CPU."""
    import importlib
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.cli import bg_fg_stereo as bgfg_cli
    from libstevi_tpu_torch.cli.normal_map_estimation import normal_map_chain
    from libstevi_tpu_torch.core import MATCH_TRAITS
    from libstevi_tpu_torch.imageproc import (
        diffusion_inpainting, mean_shift_clustering,
        nearest_neighbor_inpainting, retinex_fft)
    from libstevi_tpu_torch.imageproc import foreground_segmentation as fgs
    from libstevi_tpu_torch.io import read_stevimg, write_image
    from libstevi_tpu_torch.ops import normalize_feature_volume, unfold
    from libstevi_tpu_torch.ops.cost_volume import (
        extract_selected_index, feature_volume_to_cost_volume)
    from libstevi_tpu_torch.ops.fv_backend import (fused_fv_cost_volume,
                                                   fused_fv_cost_volume_plain)
    from libstevi_tpu_torch.profile_frames import profile_frame
    ID = importlib.import_module(
        "libstevi_tpu_torch.imageproc.intrinsic_decomposition")
    t_phase = time.perf_counter()
    K5 = fused_fv_cost_volume
    times = {}

    # -- (1) bg/fg at 1080x1920, D = 192 ------------------------------------
    H, W = entry.BGFG_HEIGHT, entry.BGFG_WIDTH
    D, r = entry.BGFG["disp_width"], entry.BGFG["radius"]
    K5.launches = 0
    forward, (ll_d, lr_d, est) = entry.bg_fg_entry(dev, seed=0)
    res = forward(ll_d, lr_d, est)
    torch.cuda.synchronize()
    bgfg_launches = K5.launches
    # the same scene on the host, for the CPU run, the CLI and the timing
    (bl, br, ll, lr), rect = entry.bg_fg_scene(H, W, seed=0)
    bl_d, br_d = (torch.from_numpy(x).to(dev) for x in (bl, br))
    print(f"pipelines: bg/fg {H}x{W} D={D} ZNCC r={r}: K5 launches "
          f"{bgfg_launches} (background + live volume)", flush=True)
    assert bgfg_launches == 2, bgfg_launches
    hold_bgfg(f"bg/fg {H}x{W}", res.fg_mask.cpu().numpy(), rect)
    # K5 at this shape against its plain version (the live volume's inputs)
    func = entry.BGFG["func"]
    kernel = MATCH_TRAITS[func].kernel
    src = normalize_feature_volume(func, unfold(r, r, lr_d))
    tgt = normalize_feature_volume(func, unfold(r, r, ll_d))
    got = K5(kernel, src, tgt, range(D))
    want = fused_fv_cost_volume_plain(kernel, src, tgt, range(D))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    k5_err = (got - want).abs().max().item()
    k5_ms = median_ms(lambda: K5(kernel, src, tgt, range(D)))
    # both feature volumes read once and the volume written once; 'dot'
    # spends one multiply-add (2 operations) an element and feature
    F = src.shape[-1]
    k5_bound = bound((2 * H * W * F + H * W * D) * 4, 2 * F * H * W * D)
    plain_ms = median_ms(lambda: fused_fv_cost_volume_plain(
        kernel, src, tgt, range(D)), 3)
    del got, want, src, tgt
    times[f"background ({H}x{W}, D={D})"] = median_ms(
        lambda: entry.bg_fg_background(bl_d, br_d))
    times["bg_fg_forward (one live frame)"] = median_ms(
        lambda: entry.bg_fg_forward(ll_d, lr_d, est))
    peak = peak_bytes(lambda: entry.bg_fg_forward(ll_d, lr_d, est))
    live_ms = times["bg_fg_forward (one live frame)"]
    busy, items = profile_frame(
        lambda: entry.bg_fg_forward(ll_d, lr_d, est), 3)
    print(f"  K5 {H}x{W}x{D} F={F} '{kernel}': max |kernel - plain| = "
          f"{k5_err:.3g}; {k5_ms:.3f} ms (plain {plain_ms:.3f}, bound "
          f"{k5_bound[0]:.3f} by {k5_bound[1]}); a live "
          f"frame's peak {peak / 1e9:.3f} GB above its inputs; its profile: "
          f"device busy {busy / 1e3:.3f} ms, idle {1 - busy / 1e3 / live_ms:.3f}"
          f", {n_items(items):.0f} device items, top {top_items(items, 6)}",
          flush=True)
    # card vs the port's CPU run, on a crop across the rectangle's top
    # edge (its corners, sides, inside and the occluded band beside it):
    # each output pixel reads rows within 3 + 3 of it and columns up to
    # D + 6 to its right, so the crop's interior equals the full frame's
    rows, cols = np.nonzero(rect)
    y0, y1 = rows.min() - 16, rows.min() + 80
    x0, x1 = cols.min() - 16, cols.max() + 41
    crop = (slice(y0, y1), slice(x0, x1 + D + 8))
    t0 = time.perf_counter()
    cpu, ratio, bg_idx_c, live_idx_c = bgfg_cpu_run(
        *(x[crop] for x in (bl, br, ll, lr)), D)
    times["the CPU run of the crop (host)"] = (time.perf_counter() - t0) * 1e3
    inner = (slice(8, y1 - y0 - 8), slice(8, x1 - x0 - 8))
    full = (slice(y0 + 8, y1 - 8), slice(x0 + 8, x1 - 8))
    live_idx_d = extract_selected_index(
        feature_volume_to_cost_volume(
            func, unfold(r, r, ll_d), unfold(r, r, lr_d), est.search),
        MATCH_TRAITS[func].strategy).cpu().numpy()
    bgfg_card_vs_cpu(
        f"bg/fg {H}x{W} (the CPU on rows {y0}:{y1}, columns {x0}:"
        f"{x1 + D + 8}; compared across the rectangle's top edge)",
        type(res)(res.disp[full], res.fg_mask[full]),
        type(cpu)(cpu.disp[inner], cpu.fg_mask[inner]), ratio[inner],
        (est.bg_idx.cpu().numpy()[full], bg_idx_c[inner]),
        (live_idx_d[full], live_idx_c[inner]), entry.BGFG["rel_threshold"])
    # the CLI on the card: the same mask
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for nm, img in (("bl", bl), ("br", br), ("ll", ll), ("lr", lr)):
            paths.append(str(Path(tmp) / f"{nm}.stevimg"))
            write_image(paths[-1], img)
        out = str(Path(tmp) / "disp.stevimg")
        K5.launches = 0
        t0 = time.perf_counter()
        rc, rep = run_cli(bgfg_cli, paths + ["-d", str(D), "-o", out])
        cli_s = time.perf_counter() - t0
        assert rc == 0 and K5.launches == 2, (rc, K5.launches)
        disp_cli = read_stevimg(out)
    want_frac = round(float(res.fg_mask.float().mean().item()), 4)
    assert rep["fg_fraction"] == want_frac, (rep, want_frac)
    assert np.array_equal(disp_cli, res.disp.cpu().numpy().astype(
        np.float32))
    print(f"  the bg_fg_stereo CLI on the card ({cli_s:.2f} s host wall, "
          f"writes included): {json.dumps(rep)}, K5 launches 2, its "
          f"disparities the entry's", flush=True)
    del bl_d, br_d, ll_d, lr_d, est, res
    torch.cuda.empty_cache()

    # -- the 480x640 fixtures at D = 120 -------------------------------------
    y0, y1, x0, x1 = BGFG_FIXTURE["rect"]
    d_fg, Df = BGFG_FIXTURE["d_fg"], BGFG_FIXTURE["D"]
    for name, suffix in (("warp", ""), ("occluded", "_occ")):
        fl = read_stevimg(str(FIXTURES / f"left{suffix}.stevimg"))
        fr = read_stevimg(str(FIXTURES / f"right{suffix}.stevimg"))
        fl, fr = (np.ascontiguousarray(x, np.float32) for x in (fl, fr))
        obj = np.random.default_rng(3).uniform(
            0.1, 1.0, (y1 - y0, x1 - x0)).astype(np.float32)
        lr_f, ll_f = fr.copy(), fl.copy()
        lr_f[y0:y1, x0:x1] = obj
        ll_f[y0:y1, x0 + d_fg:x1 + d_fg] = obj
        frect = np.zeros(fl.shape, bool)
        frect[y0:y1, x0:x1] = True
        t = [torch.from_numpy(x).to(dev) for x in (fl, fr, ll_f, lr_f)]
        K5.launches = 0
        est = entry.bg_fg_background(t[0], t[1], disp_width=Df)
        res = entry.bg_fg_forward(t[2], t[3], est)
        torch.cuda.synchronize()
        assert K5.launches == 2, K5.launches
        bg_idx = est.bg_idx.cpu().numpy()
        # outside: away from the rectangle's window reach and from the
        # background it hides in the left image
        near = dilate_np(bgfg_occluded(frect, bg_idx, d_fg) | frect, r)
        hold_bgfg(f"bg/fg fixture {name} 480x640 D={Df} (a rectangle at "
                  f"disparity {d_fg})", res.fg_mask.cpu().numpy(), frect,
                  near)
        cpu, ratio, bg_idx_c, live_idx_c = bgfg_cpu_run(fl, fr, ll_f, lr_f,
                                                        Df)
        live_idx_d = extract_selected_index(
            feature_volume_to_cost_volume(
                func, unfold(r, r, t[2]), unfold(r, r, t[3]), est.search),
            MATCH_TRAITS[func].strategy).cpu().numpy()
        bgfg_card_vs_cpu(f"bg/fg fixture {name}", res, cpu, ratio,
                         (bg_idx, bg_idx_c), (live_idx_d, live_idx_c),
                         entry.BGFG["rel_threshold"])
        times[f"bg_fg_forward fixture {name} 480x640 D={Df}"] = median_ms(
            lambda: entry.bg_fg_forward(t[2], t[3], est))
    del t, est, res
    torch.cuda.empty_cache()

    # -- (2) intrinsic: FFT retinex and the normal-map chain at 1080x1920 ----
    dome, n_true = render_dome(H, W)
    dome_d = torch.from_numpy(dome).to(dev)
    dec = retinex_fft(dome_d)
    t0 = time.perf_counter()
    dec_cpu = retinex_fft(torch.from_numpy(dome))
    times["retinex_fft CPU run (host)"] = (time.perf_counter() - t0) * 1e3
    shares = []
    for g, w in ((dec.shading, dec_cpu.shading),
                 (dec.reflectance, dec_cpu.reflectance)):
        shares.append(float(torch.isclose(g.cpu(), w, rtol=0, atol=1e-3)
                            .float().mean()))
    print(f"  retinex_fft {H}x{W} dome: card vs CPU within 1e-3 on "
          f"{shares[0]:.6f} (shading) / {shares[1]:.6f} (reflectance) of "
          f"the pixels (bar >= 0.99, the L0 rule)", flush=True)
    assert min(shares) >= 0.99, shares
    times[f"retinex_fft ({H}x{W})"] = median_ms(lambda: retinex_fft(dome_d))

    def chain(img, marks):
        def on_stage(name, _):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks.append(("start", start))
        return normal_map_chain(img, on_stage=on_stage)

    Hc, Wc = NORMAL_CPU
    small, _ = render_dome(Hc, Wc)
    n_s, h_s, l_s = chain(torch.from_numpy(small).to(dev), [])  # warm-up
    t0 = time.perf_counter()
    n_c, h_c, l_c = normal_map_chain(torch.from_numpy(small))
    times[f"normal-map chain CPU run {Hc}x{Wc} (host)"] = \
        (time.perf_counter() - t0) * 1e3
    n_err = (n_s.cpu() - n_c).abs().max().item()
    h_err = ((h_s.cpu() - h_c).abs().max()
             / (h_c.max() - h_c.min())).item()
    print(f"  normal-map chain {Hc}x{Wc} dome, card vs CPU: light "
          f"{l_s.tolist()} / {l_c.tolist()}, normals within {n_err:.3g} "
          f"(bar 1e-3), the flattened height within {h_err:.3g} of its "
          f"range (bar 1e-2)", flush=True)
    assert np.abs(l_s - l_c).max() <= 1e-5 and n_err <= 1e-3 \
        and h_err <= 1e-2
    marks = []
    normals, flat, light = chain(dome_d, marks)
    torch.cuda.synchronize()
    sfs = importlib.import_module(
        "libstevi_tpu_torch.imageproc.shape_from_shading")
    steps = sfs._solve_normals.steps
    for (_, a), (name, b) in zip(marks, marks[1:]):
        times[f"chain: {name}"] = a.elapsed_time(b)
    # the truth: the dome's normals away from the clip.  The same chain on
    # the dome moved by one float32 ulp toward 0 is held to it too, and
    # the two runs' spread printed: it is why the card is not held to a
    # CPU run here pixel by pixel
    n_true = torch.from_numpy(n_true).to(dev)
    keep = dome_d < 0.999

    def truth_angles(n):
        cos = (n.double() * n_true).sum(-1) / n.double().norm(dim=-1)
        return torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))[keep]

    normals_u, _, _ = normal_map_chain(
        torch.nextafter(dome_d, torch.zeros_like(dome_d)))
    med = [truth_angles(n).median().item() for n in (normals, normals_u)]
    p90 = truth_angles(normals).quantile(0.9).item()
    spread = (normals - normals_u).abs().amax(-1)
    run_angle = torch.rad2deg(torch.arccos(
        (normals.double() * normals_u).sum(-1).clamp(-1, 1)))
    norm = normals.norm(dim=-1)
    assert torch.isfinite(normals).all() and torch.isfinite(flat).all()
    assert (norm - 1).abs().max().item() <= 1e-4
    mean_up = normals[..., 2].mean().item()
    print(f"  normal-map chain {H}x{W} dome (the tool's steps, light "
          f"estimated {light.tolist()}): {steps[0]} Gauss-Newton steps, "
          f"{steps[1]} CG steps, height CG {sfs._cg.steps} steps; mean_up "
          f"{mean_up:.4f}, height range {(flat.max() - flat.min()).item():.3f}"
          f"; to the true normals (shading < 0.999, "
          f"{keep.float().mean().item():.4f} of the pixels): median angle "
          f"{med[0]:.3f} deg (bar <= {NORMAL_TRUTH_BAR}), p90 {p90:.3f}; the "
          f"input one ulp lower: median {med[1]:.3f} deg, the two runs' "
          f"normals within 1e-3 on {(spread <= 1e-3).float().mean().item():.4f}"
          f" of the pixels, max {spread.max().item():.3g}, median angle "
          f"between them {run_angle.median().item():.3f} deg", flush=True)
    assert mean_up > 0.6 and max(med) <= NORMAL_TRUTH_BAR, (mean_up, med)
    del dome_d, dec, normals, flat, normals_u, n_true, keep, spread
    del run_angle
    torch.cuda.empty_cache()

    # the RGB non-local retinex at 96x96 (clustering on the host)
    rng = np.random.default_rng(5)
    rgb = np.kron(rng.uniform(0.2, 1.0, (12, 12, 3)), np.ones((8, 8, 1)))
    rgb = (rgb * np.linspace(0.3, 1.0, 96)[None, :, None]).astype(np.float32)
    log = np.log(np.maximum(rgb, 1e-8))
    t0 = time.perf_counter()
    chains = ID._texture_chains(ID._rg_chromaticity(log), log, 0.01)
    times["texture clustering 96x96 (host, O(N^2))"] = \
        (time.perf_counter() - t0) * 1e3
    rgb_d = torch.from_numpy(rgb).to(dev)
    solve = lambda x: ID.retinex_with_nonlocal_texture_constraint(  # noqa
        x, 2e-3, _chains=chains)
    dec = solve(rgb_d)
    dec_c = solve(torch.from_numpy(rgb))
    s_err = ((dec.shading.cpu() - dec_c.shading).abs()
             / dec_c.shading.abs()).max().item()
    rs_err = (dec.reflectance * dec.shading - rgb_d).abs().max().item()
    print(f"  non-local retinex 96x96 RGB ({len(chains[0])} chain pairs, "
          f"600 CG steps): card vs CPU shading within {s_err:.3g} relative "
          f"(bar 1e-3), R * S = the image within {rs_err:.3g} (bar 1e-4)",
          flush=True)
    assert s_err <= 1e-3 and rs_err <= 1e-4
    times["non-local retinex solve 96x96 (600 CG steps)"] = median_ms(
        lambda: solve(rgb_d), 3)

    # -- (3) segmentation, inpainting, mean shift -----------------------------
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:H, 0:W]
    truth = ((yy - H / 2) / (0.3 * H)) ** 2 + ((xx - W / 2) / (0.3 * W)) ** 2 \
        < 1
    noise = rng.normal(0, 0.3, (H, W))
    cost = np.zeros((H, W, 2), np.float32)
    cost[..., 1] = np.where(truth, 0.2, 1.0) + noise
    cost[..., 0] = np.where(truth, 1.0, 0.2) - noise
    cost_d = torch.from_numpy(cost).to(dev)
    t0 = time.perf_counter()
    mask = fgs.get_global_refined_mask(cost_d, 0.6)
    times[f"graph cut {H}x{W} (host: build + native max-flow)"] = \
        (time.perf_counter() - t0) * 1e3
    acc = float((mask == truth).mean())
    levels = [cost_d[::4, ::4], cost_d[::2, ::2], cost_d]
    t0 = time.perf_counter()
    hmask = fgs.hierarchical_global_refined_mask(levels, 0.6)
    times["hierarchical graph cut, 3 levels (host; band dilations on the "
          "card)"] = (time.perf_counter() - t0) * 1e3
    hacc = float((hmask == truth).mean())
    hmask_c = fgs.hierarchical_global_refined_mask(
        [c.cpu() for c in levels], 0.6)
    print(f"  graph-cut segmentation {H}x{W} (noise 0.3): accuracy "
          f"{acc:.5f} global, {hacc:.5f} hierarchical (bar >= 0.97); the "
          f"hierarchical mask with the dilations on the CPU equal: "
          f"{np.array_equal(hmask, hmask_c)}", flush=True)
    assert acc >= 0.97 and hacc >= 0.97 and np.array_equal(hmask, hmask_c)
    del cost_d, levels

    img = np.random.default_rng(7).uniform(0, 1, (H, W, 3)).astype(np.float32)
    hole = np.zeros((H, W), bool)
    hy, hx = (H - 200) // 2, (W - 300) // 2
    hole[hy:hy + 200, hx:hx + 300] = True
    img_d, hole_d = torch.from_numpy(img).to(dev), torch.from_numpy(hole).to(
        dev)
    nn_d = nearest_neighbor_inpainting(img_d, hole_d)
    df_d = diffusion_inpainting(img_d, hole_d)
    # the CPU on a crop with a margin of 4 around the hole: a hole pixel's
    # nearest valid pixel and the diffusion's fixed boundary lie inside it
    cr = (slice(hy - 4, hy + 204), slice(hx - 4, hx + 304))
    nn_c = nearest_neighbor_inpainting(torch.from_numpy(img[cr]),
                                       torch.from_numpy(hole[cr]))
    df_c = diffusion_inpainting(torch.from_numpy(img[cr]),
                                torch.from_numpy(hole[cr]))
    assert torch.equal(nn_d[cr].cpu(), nn_c)
    df_err = (df_d[cr].cpu() - df_c).abs().max().item()
    assert df_err <= 1e-5, df_err
    times[f"nearest inpainting, a 200x300 hole in {H}x{W}x3"] = median_ms(
        lambda: nearest_neighbor_inpainting(img_d, hole_d))
    times["diffusion inpainting (200 iterations)"] = median_ms(
        lambda: diffusion_inpainting(img_d, hole_d))
    print(f"  inpainting: a 200x300 hole in {H}x{W}x3, the nearest fill "
          f"equal to the CPU's on the hole's crop, diffusion within "
          f"{df_err:.3g} (bar 1e-5)", flush=True)
    del img_d, hole_d, nn_d, df_d

    N, Nc = MEANSHIFT_N
    centers = np.array([[0.2, 0.3, 0.8], [0.7, 0.6, 0.1], [0.5, 0.9, 0.5],
                        [0.9, 0.2, 0.3]])
    which = np.random.default_rng(8).integers(0, 4, N)
    feats = (centers[which] + np.random.default_rng(9).normal(
        0, 0.03, (N, 3))).astype(np.float32)
    f_d = torch.from_numpy(feats).to(dev)
    modes, labels = mean_shift_clustering(f_d, 0.1)
    lab = labels.cpu().numpy()
    groups = {int(k): set(lab[which == k].tolist()) for k in range(4)}
    assert all(len(v) == 1 for v in groups.values()) \
        and len(set(lab.tolist())) == 4, groups
    mc, lc = mean_shift_clustering(torch.from_numpy(feats[:Nc]), 0.1)
    ms_, ls_ = mean_shift_clustering(f_d[:Nc], 0.1)
    ms_err = (ms_.cpu() - mc).abs().max().item()
    assert ms_err <= 1e-4 and torch.equal(ls_.cpu(), lc), ms_err
    times[f"mean shift, {N} RGB features (30 steps + closure)"] = median_ms(
        lambda: mean_shift_clustering(f_d, 0.1), 3)
    print(f"  mean shift {N} RGB features: 4 clusters, one label each; the "
          f"first {Nc} against the CPU: modes within {ms_err:.3g} (bar 1e-4),"
          f" labels equal", flush=True)
    del f_d, modes, labels
    torch.cuda.empty_cache()

    print(f"time: pipelines (CUDA events, medians of 5 unless said; the "
          f"normal-map chain one run after a warm-up at {Hc}x{Wc}; host "
          f"stages and CPU runs on the host clock; {smi}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()),
          flush=True)
    print(f"pipelines phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return bgfg_launches


# a synthetic airborne LiDAR tile: 1000 m x 1000 m, 2^24 points (16.8 a
# square metre, twice USGS 3DEP QL1's 8), boxes of 20 m x 20 m with flat
# roofs 6-25 m up (class 6) on one 50 m cell each of a 20 x 20 lattice,
# ground elsewhere (class 2), a lake of 150 m x 150 m with no returns
LIDAR = dict(n=1 << 24, side=1000.0, cell=50.0, box=20.0, roof=(6.0, 25.0),
             lake=(600.0, 250.0, 150.0), seed=19)
# the depth-map call: a nadir view from 1500 m over the tile's centre
# (~5.6 points a pixel), and the detrend call
DEPTH_CALL = dict(size=(1080, 1920), f=2600.0, rvec=(3.14159265, 0.0, 0.0),
                  t=(-500.0, 500.0, 1500.0))
DETREND_CALL = dict(tile=5.0, smooth=1.0)


def cli_args(call):
    """A call's keywords as the CLI's arguments (``--size 1080 1920 ...``)."""
    return [a for k, v in call.items()
            for a in (f"--{k}", *(str(x) for x in np.atleast_1d(v)))]


# the JAX tools' reports on that tile as `write_las_v2` writes it
# (`python cli/points_cloud2depth_map.py tile.las d.stevimg --size 1080 1920
# --f 2600 --rvec 3.14159265 0 0 --t -500 500 1500 --inpaint` and `python
# cli/detrend_terrain.py tile.las -o flat.las --tile 5 --smooth 1`,
# JAX_PLATFORMS=cpu); the port's CLIs on the card are held to them within
# 1e-4
JAX_POINTCLOUD = {"coverage": 0.8548, "raster": [200, 200],
                  "terrain_range": [-4.209965705871582, 55.49462890625],
                  "z_after": [-13.068951037463076, 23.90541338209259]}
# the points of the io_pointcloud convert round trip (LAS -> PCD ->
# binary_compressed PCD -> LAS)
CONVERT_N = 1 << 20


def lidar_ground(x, y):
    return 0.03 * x + 8.0 * np.sin(x / 90.0) * np.cos(y / 140.0)


def lidar_tile():
    """`LIDAR`'s tile from its seed: (positions (n, 3) float64, the LAS
    point format 1 attributes: intensity, return numbers, classification
    and gps_time, one 2 us pulse apart in point order)."""
    c = LIDAR
    rng = np.random.default_rng(c["seed"])
    n, side, cell, box = c["n"], c["side"], c["cell"], c["box"]
    lx, ly, ls = c["lake"]
    x, y = (rng.uniform(0.0, side, n + n // 16) for _ in range(2))
    dry = ~((x >= lx) & (x < lx + ls) & (y >= ly) & (y < ly + ls))
    x, y = x[dry][:n], y[dry][:n]
    k = int(side // cell)
    corner = rng.uniform(0.0, cell - box, (2, k, k))
    height = rng.uniform(*c["roof"], (k, k))
    edge = np.arange(k) * cell
    bx0 = (edge[:, None] + corner[0]).ravel()
    by0 = (edge[None, :] + corner[1]).ravel()
    roof_z = lidar_ground(bx0 + box / 2, by0 + box / 2) + height.ravel()
    # no box on a cell that touches the lake
    wet = ((edge[:, None] + cell > lx) & (edge[:, None] < lx + ls)
           & (edge[None, :] + cell > ly) & (edge[None, :] < ly + ls)).ravel()
    cid = (np.minimum((x / cell).astype(np.int64), k - 1) * k
           + np.minimum((y / cell).astype(np.int64), k - 1))
    bx, by = bx0[cid], by0[cid]
    roof = (x >= bx) & (x < bx + box) & (y >= by) & (y < by + box) \
        & ~wet[cid]
    z = lidar_ground(x, y)
    z[roof] = roof_z[cid[roof]]
    intensity = rng.integers(50, 400, n, dtype=np.uint16)
    intensity[roof] += 300
    nr = (1 + (rng.random(n) < 0.2)).astype(np.uint8)
    attrs = {
        "intensity": intensity,
        "return_number": (1 + ((nr == 2) & (rng.random(n) < 0.5))
                          ).astype(np.uint8),
        "number_of_returns": nr,
        "classification": np.where(roof, 6, 2).astype(np.uint8),
        "gps_time": 3.0e5 + 2e-6 * np.arange(n, dtype=np.float64),
    }
    return np.column_stack([x, y, z]), attrs


def read_tile(path, n):
    """The tile's LAS file read back whole: (positions (n, 3) float64, the
    chunk of attributes)."""
    from libstevi_tpu_torch.io.las_stream import LasReader
    ch = LasReader(path).read_chunk(0, n)
    return ch.pop("xyz"), ch


def pointcloud_cpu():
    """The `pointclouds` phase's CPU references (a `CPU_JOBS` entry): the
    tile written by `write_las_v2` and read back, as on the card; the
    depth map before and after inpainting and its coverage; the detrend's
    min-z raster and terrain."""
    from libstevi_tpu_torch.cli.detrend_terrain import detrend
    from libstevi_tpu_torch.cli.points_cloud2depth_map import (inpaint_depth,
                                                               project_depth)
    from libstevi_tpu_torch.io.las_stream import write_las_v2
    pos, attrs = lidar_tile()
    with tempfile.TemporaryDirectory() as d:
        write_las_v2(f"{d}/tile.las", pos, attrs)
        xyz, _ = read_tile(f"{d}/tile.las", len(pos))
    depth, cov = project_depth(torch.from_numpy(xyz.astype(np.float32)),
                               **DEPTH_CALL)
    filled = inpaint_depth(depth)
    _, zmap, terrain = detrend(torch.from_numpy(xyz), **DETREND_CALL)
    return (depth.numpy(), filled.numpy(), cov.numpy(), zmap.numpy(),
            terrain.numpy())


CPU_JOBS["pointclouds"] = (pointcloud_cpu, ())


def pointclouds(dev, smi):
    """The `pointclouds` phase: a 16.8M-point airborne LiDAR tile
    (`lidar_tile`) through the point-cloud path, in a temporary directory:
    written and read back as LAS; `points_cloud2depth_map` and
    `detrend_terrain` on the card against the JAX tools' reports and the
    CPU; `split_pt_cloud`, `io_pointcloud` (info, convert through LZF) and
    `stevimg_viewer` on the host; `utils.profiling` and
    `utils.checkpointing` on the card.  Each stage timed (CUDA events on
    the card, the host clock for host work and whole CLI calls)."""
    with tempfile.TemporaryDirectory() as work:
        _pointclouds(dev, smi, Path(work))


def _pointclouds(dev, smi, d):
    import glob
    from libstevi_tpu_torch.cli import detrend_terrain as dt_cli
    from libstevi_tpu_torch.cli import io_pointcloud as io_cli
    from libstevi_tpu_torch.cli import points_cloud2depth_map as pc_cli
    from libstevi_tpu_torch.cli import split_pt_cloud as split_cli
    from libstevi_tpu_torch.cli import stevimg_viewer as view_cli
    from libstevi_tpu_torch.io import open_point_cloud, read_pcd, write_pcd
    from libstevi_tpu_torch.io import read_stevimg
    from libstevi_tpu_torch.io.las_stream import write_las_v2
    from libstevi_tpu_torch.optim.gauss_newton import (damped_step,
                                                       normal_equations)
    from libstevi_tpu_torch.profile_frames import profile_frame
    from libstevi_tpu_torch.utils import checkpointing, profiling
    t_phase = time.perf_counter()
    times = {}

    def host(key, fn):
        """``fn()`` once, its host wall time kept under ``key``."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key] = (time.perf_counter() - t0) * 1e3
        return out

    # -- (1) the tile, written as LAS point format 1 and read back ---------
    pos, attrs = host("tile (numpy)", lidar_tile)
    N = len(pos)
    tile = str(d / "tile.las")
    host("write_las_v2", lambda: write_las_v2(tile, pos, attrs))
    xyz, ch = host("LasReader", lambda: read_tile(tile, N))
    for k, v in attrs.items():
        assert np.array_equal(ch[k], v), k
    q_err = float(np.abs(xyz - pos).max())
    assert q_err <= 0.5e-4 + 1e-9, q_err
    print(f"pointclouds: tile of {N} points ({N / 1e6:.2f} pts/m^2, roofs "
          f"{(attrs['classification'] == 6).mean():.4f}), LAS format 1 "
          f"{os.path.getsize(tile) / 1e6:.1f} MB: attributes read back "
          f"equal, positions within {q_err:.3g} (the 1e-4 LAS unit)",
          flush=True)
    del pos, ch

    # -- (2) points_cloud2depth_map on the card -----------------------------
    depth_file = str(d / "depth.stevimg")
    rc, rep = host("points_cloud2depth_map CLI", lambda: run_cli(
        pc_cli, [tile, depth_file, *cli_args(DEPTH_CALL), "--inpaint"]))
    assert rc == 0 and rep["n_points"] == N, rep
    assert abs(rep["coverage"] - JAX_POINTCLOUD["coverage"]) <= 1e-4, rep
    pts = torch.from_numpy(xyz.astype(np.float32)).to(dev)

    def project(p):
        return pc_cli.project_depth(p, **DEPTH_CALL)

    depth, cov = project(pts)
    filled = pc_cli.inpaint_depth(depth)
    c_depth, c_filled, c_cov, c_zmap, c_terrain = cpu_job("pointclouds")
    same = float((depth.cpu().numpy() == c_depth).mean())
    assert same >= 0.9999, same
    fill_ok = float((np.abs(filled.cpu().numpy() - c_filled)
                     <= 1e-3).mean())
    assert fill_ok >= 0.999, fill_ok
    written = read_stevimg(depth_file)
    want = filled.cpu().numpy()
    want[~np.isfinite(want)] = 0.0
    assert np.array_equal(written, want)
    print(f"  points_cloud2depth_map {DEPTH_CALL['size'][0]}x"
          f"{DEPTH_CALL['size'][1]} on the card: coverage {rep['coverage']}"
          f" (JAX tool {JAX_POINTCLOUD['coverage']}, CPU "
          f"{float(c_cov):.6f}, card {float(cov):.6f}); the depth map "
          f"before inpainting equals the CPU's on {same:.6f} of pixels (bar "
          f">= 0.9999), after inpainting within 1e-3 m on {fill_ok:.6f} "
          f"(bar >= 0.999); the CLI's file is the card's map", flush=True)
    times["projection"] = median_ms(lambda: project(pts))
    times["inpainting"] = median_ms(lambda: pc_cli.inpaint_depth(depth), 3)

    # -- (3) detrend_terrain on the card ------------------------------------
    rc, rep = host("detrend_terrain CLI", lambda: run_cli(
        dt_cli, [tile, "-o", str(d / "flat.las"),
                 *cli_args(DETREND_CALL)]))
    assert rc == 0 and rep["raster"] == JAX_POINTCLOUD["raster"], rep
    for k in ("terrain_range", "z_after"):
        assert np.abs(np.subtract(rep[k], JAX_POINTCLOUD[k])).max() \
            <= 1e-4, (k, rep[k])
    os.remove(d / "flat.las")
    pos_d = torch.from_numpy(xyz).to(dev)
    z, zmap, terrain = dt_cli.detrend(pos_d, **DETREND_CALL)
    assert np.array_equal(zmap.cpu().numpy(), c_zmap)
    t_err = float(np.abs(terrain.cpu().numpy() - c_terrain).max())
    assert t_err <= 1e-5, t_err
    print(f"  detrend_terrain on the card: raster {rep['raster']} "
          f"({int((~torch.isfinite(zmap)).sum())} empty tiles) equal to the "
          f"CPU's bit for bit, terrain within {t_err:.3g} of the CPU's (bar "
          f"1e-5), terrain_range {rep['terrain_range']} and z_after "
          f"{rep['z_after']} within 1e-4 of the JAX tool's", flush=True)
    times["detrend"] = median_ms(lambda: dt_cli.detrend(pos_d,
                                                        **DETREND_CALL))
    del z, zmap, terrain, pos_d

    # -- (4) split_pt_cloud and io_pointcloud on the host -------------------
    rc, rep = host("split_pt_cloud CLI", lambda: run_cli(
        split_cli, [tile, "-o", str(d / "part"), "-n", "2", "2", "-c",
                    "20"]))
    assert rc == 0 and sum(t["n_own"] for t in rep["tiles"]) == N, rep
    own_gps = []
    for t in rep["tiles"]:
        txyz, tch = read_tile(t["path"], t["n_own"] + t["n_context"])
        own = tch["is_context"] == 0
        assert len(txyz) == t["n_own"] + t["n_context"] \
            and own.sum() == t["n_own"], t
        own_gps.append(tch["gps_time"][own])
        os.remove(t["path"])
    # gps_time is one value a point: the own points are the cloud's, once
    assert np.array_equal(np.sort(np.concatenate(own_gps)),
                          attrs["gps_time"])
    print(f"  split_pt_cloud -n 2 2 -c 20: own points "
          f"{[t['n_own'] for t in rep['tiles']]}, context "
          f"{[t['n_context'] for t in rep['tiles']]}; the own points "
          f"partition the cloud", flush=True)
    del own_gps

    rc, info = host("io_pointcloud info", lambda: run_cli(
        io_cli, ["info", tile]))
    assert rc == 0 and info["n_points"] == N and info["point_format"] == 1
    assert np.abs(np.subtract(info["mins"], xyz.min(0))).max() == 0.0
    assert np.abs(np.subtract(info["maxs"], xyz.max(0))).max() == 0.0
    sub = str(d / "sub.las")
    write_las_v2(sub, xyz[:CONVERT_N], {k: v[:CONVERT_N]
                                        for k, v in attrs.items()})
    rc, _ = host("io_pointcloud convert LAS -> PCD", lambda: run_cli(
        io_cli, ["convert", sub, str(d / "sub.pcd")]))
    cloud = read_pcd(str(d / "sub.pcd"))
    host("write_pcd binary_compressed (LZF)", lambda: write_pcd(
        str(d / "subc.pcd"), cloud, compressed=True))
    rc, _ = host("io_pointcloud convert PCD (LZF) -> LAS", lambda: run_cli(
        io_cli, ["convert", str(d / "subc.pcd"), str(d / "back.las")]))
    cloud_c = read_pcd(str(d / "subc.pcd"))
    back = open_point_cloud(str(d / "back.las"))
    assert np.array_equal(cloud_c.positions, cloud.positions)
    assert np.abs(back.positions - cloud.positions).max() <= 0.5e-4 + 1e-9
    for k, v in attrs.items():
        assert np.array_equal(cloud_c.attributes[k], v[:CONVERT_N]), k
        assert np.array_equal(back.attributes[k], v[:CONVERT_N]), k
    ratio = os.path.getsize(d / "subc.pcd") / os.path.getsize(d / "sub.pcd")
    print(f"  io_pointcloud: info over {N} points (streamed, mins / maxs "
          f"exact); convert of {CONVERT_N} points LAS -> PCD -> PCD "
          f"binary_compressed (LZF, {ratio:.3f} of the binary size) -> LAS: "
          f"attributes equal, positions the PCD's float32 within the LAS "
          f"unit", flush=True)
    del cloud, cloud_c, back

    # -- (5) stevimg_viewer on the depth map (gray: no matplotlib) ----------
    rc, rep = host("stevimg_viewer CLI", lambda: run_cli(
        view_cli, [depth_file, "--colormap", "gray", "-o",
                   str(d / "view.stevimg")]))
    fin = written[np.isfinite(written)]
    assert rc == 0 and rep["shape"] == list(written.shape)
    assert (rep["min"], rep["max"], rep["mean"], rep["n_nonfinite"]) == (
        float(fin.min()), float(fin.max()), float(fin.mean()),
        int(written.size - fin.size)), rep
    view = read_stevimg(str(d / "view.stevimg"))
    assert view.shape == (*written.shape, 3) and view.dtype == np.uint8
    print(f"  stevimg_viewer --colormap gray -o: stats equal the depth "
          f"map's (min {rep['min']:.4f}, max {rep['max']:.4f}, mean "
          f"{rep['mean']:.4f}), render {list(view.shape)} uint8", flush=True)

    # -- (6) utils.profiling on the projection ------------------------------
    rl = profiling.roofline(project, pts)
    dev_ms = rl["measured_s"] * 1e3
    assert abs(dev_ms - times["projection"]) <= 0.2 * times["projection"], (
        dev_ms, times["projection"])
    assert rl["fraction_of_roofline"] <= 1.05, rl
    trace_dir = d / "trace"
    with profiling.trace(str(trace_dir)):
        project(pts)
        project(pts)
    files = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        kernels = {e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"}
    scatter = sorted(k for k in kernels if "scatter" in k.lower())
    assert scatter, sorted(kernels)[:20]
    busy, items = profile_frame(lambda: project(pts), 5)
    print(f"  utils.profiling: device_time of the projection "
          f"{dev_ms:.3f} ms (the phase's median {times['projection']:.3f} "
          f"ms); roofline: {rl['bytes_accessed'] / 1e6:.1f} MB, "
          f"{rl['flops']:.0f} matmul flops, bound "
          f"{max(rl['memory_bound_s'], rl['compute_bound_s']) * 1e3:.3f} ms "
          f"by {rl['bound_by']}, fraction {rl['fraction_of_roofline']:.3f} "
          f"(<= 1.05); trace: {len(kernels)} kernels, the scatter kernel "
          f"{scatter[0][:60]!r}; a projection's device items (busy "
          f"{busy / 1e3:.3f} ms, idle "
          f"{1 - busy / 1e3 / times['projection']:.3f}): "
          f"{top_items(items, 6)}", flush=True)

    # -- (7) utils.checkpointing: Gauss-Newton stopped and resumed ----------
    rng = np.random.default_rng(7)
    n = 1 << 20
    tt = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    yy = 2.0 * torch.exp(-1.3 * tt) + 0.01 * torch.from_numpy(
        rng.normal(size=n).astype(np.float32)).to(dev)

    def resid(p, a, b):
        return p[0] * torch.exp(p[1] * a) - b

    def step(s):
        JtJ, Jtr = normal_equations(resid, s["x"], tt, yy)
        return {"x": s["x"] - damped_step(JtJ, Jtr, 1e-8),
                "steps": s["steps"] + 1, "note": None}

    s0 = {"x": torch.tensor([1.0, 0.0], device=dev),
          "steps": torch.tensor(0, device=dev), "note": None}
    whole = host("resumable_iterate 6 GN steps", lambda:
                 checkpointing.resumable_iterate(step, s0, 6, str(d / "a"),
                                                 checkpoint_every=2))
    calls = []

    def stopping(s):
        if len(calls) == 3:
            raise KeyboardInterrupt
        calls.append(1)
        return step(s)

    try:
        checkpointing.resumable_iterate(stopping, s0, 6, str(d / "b"),
                                        checkpoint_every=2)
        raise AssertionError("the run was not stopped")
    except KeyboardInterrupt:
        pass
    assert checkpointing.latest_checkpoint(str(d / "b"))[0] == 2
    resumed = checkpointing.resumable_iterate(step, s0, 6, str(d / "b"),
                                              checkpoint_every=2)
    assert resumed["x"].device == s0["x"].device \
        and resumed["x"].dtype == torch.float32
    assert torch.equal(resumed["x"], whole["x"]), (resumed, whole)
    assert resumed["steps"].item() == 6
    print(f"  utils.checkpointing: Gauss-Newton over {n} residuals, 6 steps "
          f"with a checkpoint every 2, stopped after 3 and resumed from "
          f"step 2: x {resumed['x'].tolist()} equal to the uninterrupted "
          f"run's bit for bit", flush=True)

    print(f"time: pointclouds ({N} points; CUDA events, medians of 5 "
          f"(inpainting 3) for projection, inpainting and detrend, one host "
          f"wall run for the rest; {smi}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()),
          flush=True)
    print(f"pointclouds phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def prop_good_np(disp, gt):
    from libstevi_tpu_torch.statistics import prop_good
    return prop_good(disp.float().cpu().numpy(), gt, 2.0)


def distributed_uhd(dev, L4, R4, lane_idx, smi):
    """The distributed 4K UHD step: `distributed_dense_stereo_step` on a
    (batch 1, tile 4) mesh of the one card, ZNCC 7x7, D = 384, P1 = 0.1,
    P2 = 0.5, SGM-8, on a 2160x3840 pair.  K4c's carries do not fit at
    this width (`fused_fits`), so every SGM pass runs the K2s engine on
    the any-D K2: 2 horizontal `sgm_pass` and 6 relayed `sgm_shard_pass`
    launches a shard, counted from 0 around one frame.  Holds the
    disparities equal to the same step on a (1, 1) mesh (the relays are
    exact) and to the single-device lane route's tie-last WTA over the
    same pair (``lane_idx``, another sum order) on >= 0.999 of pixels;
    times the frame (median of 3 after a warm-up), its device items and
    its peak memory.  Then holds the any-D K2 to its plain versions on one
    of the frame's row shards (rows 540 to 1080 of the pair's volume):
    `sgm_pass` left to right at 1e-4, `sgm_shard_pass` top to bottom and
    along a diagonal from random carries bitwise (some 4000 lines a
    launch: the ring's fewest stages).  Returns the any-D K2's launches in
    the frame and its largest error against the plain passes."""
    from libstevi_tpu_torch.core import DispDirection, MatchingFunction
    from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
    from libstevi_tpu_torch.ops.box_cuda import box_cv
    from libstevi_tpu_torch.ops.sgm import SgmDirection
    from libstevi_tpu_torch.ops.sgm_cuda import (sgm_pass, sgm_pass_plain,
                                                 sgm_shard_pass,
                                                 sgm_shard_pass_plain)
    from libstevi_tpu_torch.parallel import MeshSpec, make_stereo_mesh
    from libstevi_tpu_torch.parallel.stereo import (
        distributed_dense_stereo_step)
    from libstevi_tpu_torch.profile_frames import profile_frame

    UH, UW = L4.shape
    D, n_sms = 384, torch.cuda.get_device_properties(dev).multi_processor_count
    assert not lane.fused_fits(UW, D, 8, n_sm=n_sms)    # the K2s engine

    def step(tile):
        return distributed_dense_stereo_step(
            make_stereo_mesh(MeshSpec(batch=1, tile=tile), [dev] * tile),
            MatchingFunction.ZNCC, 3, 3, D, 0.1, 0.5, n_directions=8)

    step4, step1 = step(4), step(1)
    f4 = lambda: step4(L4[None], R4[None])  # noqa: E731
    counters = (box_cv, sgm_pass, sgm_shard_pass, lane.fused_rows_shard_pass,
                lane.fused_cols_pass)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out4 = f4()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": box_cv.launches, "K2 (sgm_pass)": sgm_pass.launches,
                "K2s (sgm_shard_pass)": sgm_shard_pass.launches,
                "K4c": lane.fused_rows_shard_pass.launches,
                "K4b cols": lane.fused_cols_pass.launches}
    print(f"distributed 4K UHD step {UH}x{UW} D={D} SGM-8 (batch 1, tile "
          f"4; K4c's carries do not fit: the K2s engine; the any-D K2's "
          f"last launch ran {sgm_shard_pass.layout}, as its launcher "
          f"reports): {wall:.3f} s host wall (first call), launches "
          f"{launches}", flush=True)
    assert launches == {"K1": 4, "K2 (sgm_pass)": 8,
                        "K2s (sgm_shard_pass)": 24, "K4c": 0,
                        "K4b cols": 0}, launches
    assert out4.shape == (1, UH, UW) and out4.dtype == torch.int32
    out1 = step1(L4[None], R4[None])
    assert torch.equal(out4, out1), "4 row shards against the (1, 1) mesh"
    del out1
    sign = DispDirection.RIGHT_TO_LEFT.delta_sign
    agree = (out4[0] == (sign * lane_idx).to(out4.dtype)).float().mean().item()
    print(f"  the 4 row shards' disparities equal the (1, 1) mesh's; they "
          f"agree with the single-device lane route's tie-last WTA on "
          f"{agree:.6f} of pixels", flush=True)
    assert agree >= 0.999, agree
    del out4
    torch.cuda.empty_cache()
    ms = median_ms(f4, reps=3, warmup=1)
    busy, items = profile_frame(f4, 1)
    peak = peak_bytes(f4)
    top = sorted(items.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"time: distributed 4K UHD step {UH}x{UW} D={D} SGM-8, 4 row "
          f"shards: {ms:.3f} ms (median of 3 after a warm-up; {smi}); "
          f"memory: peak {peak / 1e9:.3f} GB above the inputs; profile (1 "
          f"frame): device busy {busy / 1e3:.3f} ms, idle "
          f"{1 - busy / 1e3 / ms:.3f}, top items (name, us, launches) "
          f"{[[n, round(u, 1), round(k, 1)] for n, (u, k) in top]}",
          flush=True)
    torch.cuda.empty_cache()
    # the any-D K2 against its plain versions on one 540x3840x384 row shard
    # of the frame's volume (K1's shards with their halos are its slices)
    cv = box_cv(MatchingFunction.ZNCC, L4, R4, 3, 3, D, torch.float32,
                negate=True)
    i0, rows = UH // 4, UH // 4
    x = cv[i0:i0 + rows].contiguous()
    del cv
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(384)
    a = torch.rand(x.shape, generator=g, device=dev)
    c = torch.rand((UW, D), generator=g, device=dev)
    Q = (P1, P2, POUT)
    a_k, a_p = a.clone(), a.clone()
    sgm_pass(x, a_k, SgmDirection.LEFT2RIGHT, *Q)
    sgm_pass_plain(x, a_p, SgmDirection.LEFT2RIGHT, *Q)
    err = close(a_k, a_p)
    print(f"  any-D K2 {tuple(x.shape)} LEFT2RIGHT (launched "
          f"{sgm_pass.layout}): within {err:.3g} of the plain pass "
          f"(bitwise: {torch.equal(a_k, a_p)})", flush=True)
    for d in (SgmDirection.UP2DOWN, SgmDirection.UPLEFT2DOWNRIGHT):
        a_k.copy_(a)
        a_p.copy_(a)
        got = sgm_shard_pass(x, a_k, d, *Q, True, c, i0, UH)
        used = sgm_shard_pass.layout
        exact(got, sgm_shard_pass_plain(x, a_p, d, *Q, True, c, i0, UH),
              ("K2s 4K shard carries", d.name))
        exact(a_k, a_p, ("K2s 4K shard", d.name))
        print(f"  any-D K2s {tuple(x.shape)} {d.name} from random carries "
              f"(launched {used}): equal to the plain pass bitwise, the "
              f"carries out too", flush=True)
    del x, a, c, a_k, a_p, got
    torch.cuda.empty_cache()
    return (launches["K2 (sgm_pass)"] + launches["K2s (sgm_shard_pass)"],
            err)


def distributed(dev, pairs, smi):
    """The distributed paths (`libstevi_tpu_torch.parallel`) on virtual
    shards of the one card, and 16-direction SGM past D = 320.  Holds K2s,
    K4c and the any-D K2k to their plain versions at the shapes these paths
    give them; runs the paths with the launch counts set to 0 just before
    and read just after, holds their SGM volumes to the single-device
    route's with `torch.equal` and their indices to >= 0.999 agreement;
    times them beside the single-device route.  Returns (max abs errors,
    launches, (kernel ms, plain ms), bounds) for the kernel records."""
    from libstevi_tpu_torch import entry
    from libstevi_tpu_torch.core import ExtractionStrategy, MatchingFunction
    from libstevi_tpu_torch.ops import (dense_sgm_stereo,
                                        extract_selected_index,
                                        sgm_cost_volume,
                                        unfold_based_cost_volume)
    from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
    from libstevi_tpu_torch.ops.box_cuda import box_cv
    from libstevi_tpu_torch.ops.sgm import (_KNIGHT_DIRS, SgmDirection,
                                            directions_for)
    from libstevi_tpu_torch.ops.sgm import knight_adj
    from libstevi_tpu_torch.ops.sgm_cuda import (
        MAX_D, add_knight_volumes, knight_volumes, knight_volumes_plain,
        ring_fits, sgm_knight_shard_pass,
        sgm_knight_shard_pass_plain, sgm_pass, sgm_pass_plain,
        sgm_shard_pass, sgm_shard_pass_plain)
    from libstevi_tpu_torch.parallel import MeshSpec, make_stereo_mesh
    from libstevi_tpu_torch.parallel.sgm_dist import (
        _column_split, carry_relay, distributed_sgm, distributed_sgm_fused,
        distributed_sgm_fused_dhw, distributed_sgm_routed)
    from libstevi_tpu_torch.parallel.stereo import (
        distributed_dense_stereo_step, distributed_full_step)

    ZNCC, SCORE = MatchingFunction.ZNCC, ExtractionStrategy.SCORE
    H, W, D, DW = 480, 640, 120, 384
    Q = (0.3, 1.1, 7.0)          # JAX's flagship-geometry test's P1, P2, Pout
    DA = 330                     # past K2's one-warp instance (D <= 320)
    err = {"K2s": 0.0, "K4c": 0.0, "K2k any-D": 0.0, "K2 any-D": 0.0}
    g = torch.Generator(device=dev).manual_seed(21)
    cv = torch.rand((H, W, D), generator=g, device=dev) * 4
    cvw = torch.rand((H, W, DW), generator=g, device=dev) * 4
    devs8, devs4 = [dev] * 8, [dev] * 4
    sh8, sh4 = list(cv.split(H // 8)), list(cvw.split(H // 4))
    i8, i4 = [k * (H // 8) for k in range(8)], [k * (H // 4) for k in range(4)]
    cols = _column_split(W, 8)
    PRINC = [d for d in directions_for(8) if d.step[0] != 0]
    VK = [d for d in _KNIGHT_DIRS if d.steps[0][0] != 0]
    HK = [d for d in _KNIGHT_DIRS if d.steps[0][0] == 0]

    # -- K2s, K4c and the any-D K2k against their plain versions -------------
    # K2s on the flagship geometry's fourth shards (tile 8: rows 180-239 of
    # 480, columns 240-319 of 640 for the left/right knights), from random
    # carries; K4c on the second shard of the 480x640x384 volume (tile 4:
    # rows 120-239)
    r0, (c0, c1) = i8[3], cols[3]
    blk, cblk = sh8[3], cv[:, c0:c1].contiguous()
    for d in PRINC + _KNIGHT_DIRS:
        a = torch.rand(blk.shape if d in PRINC + VK else cblk.shape,
                       generator=g, device=dev)
        a_p = a.clone()
        if d in PRINC:
            c = torch.rand((W, D), generator=g, device=dev)
            out = (sgm_shard_pass(blk, a, d, *Q, True, c, r0, H),
                   sgm_shard_pass_plain(blk, a_p, d, *Q, True, c, r0, H))
        else:
            vert = d in VK
            c = torch.rand((2, W if vert else H, D), generator=g, device=dev)
            kw = (dict(s0=r0, N_img=H) if vert
                  else dict(s0=c0, N_img=W, col0=c0, W_pout=W))
            x = blk if vert else cblk
            out = (sgm_knight_shard_pass(x, a, d, *Q, c, **kw),
                   sgm_knight_shard_pass_plain(x, a_p, d, *Q, c, **kw))
        exact(a, a_p, ("K2s", d.name))
        exact(out[0], out[1], ("K2s carries", d.name))
    print(f"K2s {tuple(blk.shape)} row shard at row {r0} and "
          f"{tuple(cblk.shape)} column shard at column {c0} f32: 6 principal "
          f"and 8 knight directions from random carries, acc and carries "
          f"out equal the plain versions bitwise", flush=True)
    kw4 = dict(col0=0, W_pout=W, P1=Q[0], P2=Q[1], Pout=Q[2])
    for rev in (False, True):
        c = torch.rand((3, W, DW), generator=g, device=dev)
        for acc in (None, torch.rand(sh4[1].shape, generator=g, device=dev)):
            want = lane.fused_rows_shard_pass_plain(
                sh4[1], None if acc is None else acc.clone(), c, i4[1], H,
                rev, True, **kw4)
            got = lane.fused_rows_shard_pass(sh4[1], acc, c, i4[1], H, rev,
                                             True, **kw4)
            exact(got[0], want[0], ("K4c", rev))
            exact(got[1], want[1], ("K4c carries", rev))
    print(f"K4c {tuple(sh4[1].shape)} row shard at row {i4[1]} f32: down "
          f"and up sweeps, "
          f"fresh and accumulating, from random carries: equal to the plain "
          f"version bitwise", flush=True)
    del want, got
    # the any-D K2k: the 8 knight volumes of the 480x640x384 volume in two
    # launches against the plain lane form, and added in order onto a
    # random accumulator against the shard pass's plain version applied
    # direction by direction, bitwise; `knight_adj`'s line form (another
    # sum order where lines overlap) within 1e-4
    vols = knight_volumes(cvw, _KNIGHT_DIRS, *Q)
    err["K2k any-D"] = exact(vols, knight_volumes_plain(cvw, _KNIGHT_DIRS,
                                                        *Q), "K2k any-D")
    a = torch.rand(cvw.shape, generator=g, device=dev)
    a_l = a.clone()
    for d in _KNIGHT_DIRS:
        sgm_knight_shard_pass_plain(cvw, a_l, d, *Q)
    exact(add_knight_volumes(cvw, a, _KNIGHT_DIRS, *Q), a_l,
          "K2k any-D ordered sum")
    e_kd = max(close(v, knight_adj(cvw, d, *Q))
               for d, v in zip(_KNIGHT_DIRS, vols))
    del a, a_l, vols
    print(f"K2k any-D {H}x{W}x{DW} f32, 8 directions in two launches: equal "
          f"to the plain lane form bitwise, the ordered sum equal to the "
          f"shard pass's plain version bitwise, within {e_kd:.3g} of "
          f"`knight_adj`", flush=True)
    # K2 past D = 320 (the registers instance, K = 4, G = 3): 7 passes on a
    # whole 120x160x330 volume in f32 and bf16, then K2s on rows 40-79 of it
    # from random carries, bitwise
    cva = torch.rand((120, 160, DA), generator=g, device=dev) * 4
    for dt in (torch.float32, torch.bfloat16):
        x = cva.to(dt)
        a, a_p = (torch.empty(cva.shape, device=dev) for _ in range(2))
        for k, d in enumerate(PRINC + [SgmDirection.LEFT2RIGHT]):
            sgm_pass(x, a, d, *Q, accumulate=k > 0)
            sgm_pass_plain(x, a_p, d, *Q, accumulate=k > 0)
        err["K2 any-D"] = max(err["K2 any-D"], close(a, a_p))
    blk = cva[40:80].contiguous()
    for d in PRINC:
        a = torch.rand(blk.shape, generator=g, device=dev)
        a_p = a.clone()
        c = torch.rand((160, DA), generator=g, device=dev)
        out = (sgm_shard_pass(blk, a, d, *Q, True, c, 40, 120),
               sgm_shard_pass_plain(blk, a_p, d, *Q, True, c, 40, 120))
        exact(a, a_p, ("K2s D=330", d.name))
        exact(out[0], out[1], ("K2s D=330 carries", d.name))
    print(f"K2 any-D 120x160x{DA} f32 and bf16, 7 passes: within "
          f"{err['K2 any-D']:.3g} of the plain passes; K2s on rows 40-79 from "
          f"random carries: equal to the plain version bitwise", flush=True)
    del a, a_p, blk

    # -- the distributed paths -------------------------------------------------
    ref8 = sgm_cost_volume(cv, *Q[:2], Pout=Q[2], n_directions=8)
    ref16 = sgm_cost_volume(cv, *Q[:2], Pout=Q[2], n_directions=16)
    refw = sgm_cost_volume(cvw, *Q[:2], Pout=Q[2], n_directions=8)
    refw16 = sgm_cost_volume(cvw, *Q[:2], Pout=Q[2], n_directions=16)
    ls = torch.stack([pairs[n][0][0] for n in ("warp", "occluded")])
    rs = torch.stack([pairs[n][0][1] for n in ("warp", "occluded")])
    F = dict(h_radius=3, v_radius=3, disp_width=D, P1=0.1, P2=0.5,
             n_directions=8)

    def single_idx(L, R):
        """The same work on one device: K1, SGM-8 (K2), WTA."""
        c = unfold_based_cost_volume(ZNCC, L, R, 3, 3, D)
        return extract_selected_index(sgm_cost_volume(
            c, 0.1, 0.5, n_directions=8, strategy=SCORE), SCORE)

    ref_idx = torch.stack([single_idx(L, R) for L, R in zip(ls, rs)])
    cv_a = torch.rand((48, 64, DA), generator=g, device=dev) * 4
    sha = list(cv_a.split(12))
    mesh222 = make_stereo_mesh(MeshSpec(batch=2, tile=2, dsh=2), devs8)
    mesh24 = make_stereo_mesh(MeshSpec(batch=2, tile=4), devs8)
    full = distributed_full_step(mesh222, ZNCC, **F)
    dense = distributed_dense_stereo_step(mesh24, ZNCC, **F)
    counters = (box_cv, sgm_pass, sgm_shard_pass, sgm_knight_shard_pass,
                lane.fused_rows_shard_pass, lane.fused_cols_pass)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d8 = torch.cat(distributed_sgm_fused_dhw(sh8, *Q, 8))
    d16 = torch.cat(distributed_sgm_fused_dhw(sh8, *Q, 16))
    dw = torch.cat(distributed_sgm_fused(sh4, *Q, 8))
    dw16 = torch.cat(distributed_sgm_routed(sh4, *Q, 16))
    out_full, out_dense = full(ls, rs), dense(ls, rs)
    dry = entry.dryrun_multichip(8, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": box_cv.launches, "K2": sgm_pass.launches,
                "K2s": sgm_shard_pass.launches
                + sgm_knight_shard_pass.launches,
                "K4c": lane.fused_rows_shard_pass.launches,
                "K4b cols": lane.fused_cols_pass.launches}
    print(f"distributed path (8 virtual shards of the card): flagship "
          f"geometry SGM-8 and SGM-16 (tile 8), K4c at {H}x{W}x{DW} (tile "
          f"4; SGM-16: with the knight relays), the full step (2, 2, 2) and "
          f"the dense step (2, 4) on the two fixtures, dryrun_multichip(8): "
          f"{wall:.3f} s host wall (first calls), launches {launches}",
          flush=True)
    assert launches["K2s"] > 0 and launches["K4c"] > 0, launches
    for tag, got, want in (("SGM-8 tile 8", d8, ref8),
                           ("SGM-16 tile 8", d16, ref16),
                           (f"K4c SGM-8 {H}x{W}x{DW} tile 4", dw, refw),
                           (f"K4c + K2s knights SGM-16 {H}x{W}x{DW} tile 4",
                            dw16, refw16)):
        exact(got, want, tag)
        print(f"  {tag}: the distributed volume equals the single-device "
              f"route's bitwise", flush=True)
    del d8, d16, dw, dw16, ref8, ref16, refw, refw16
    # SGM-4/8/16 past D = 320 over row shards: K2 and K2s take any D (their
    # registers instances at D = 330), against the same engines on the CPU
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    da = [torch.cat(distributed_sgm(sha, *Q))]
    da += [torch.cat(distributed_sgm_fused_dhw(sha, *Q, n))
           for n in (8, 16)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["K2 any-D"] = sgm_pass.launches + sgm_shard_pass.launches
    print(f"distributed SGM-4/8/16 at {tuple(cv_a.shape)} (tile 4): "
          f"{wall:.3f} s host wall (first calls), launches K2 "
          f"{sgm_pass.launches}, K2s {sgm_shard_pass.launches} (principal), "
          f"{sgm_knight_shard_pass.launches} (knights)", flush=True)
    assert sgm_pass.launches > 0 and sgm_shard_pass.launches > 0
    sha_c = [x.cpu() for x in sha]
    want = [torch.cat(distributed_sgm(sha_c, *Q))]
    want += [torch.cat(distributed_sgm_fused_dhw(sha_c, *Q, n))
             for n in (8, 16)]
    for n, got, w in zip((4, 8, 16), da, want):
        e = close(got.cpu(), w)
        print(f"  SGM-{n} {tuple(cv_a.shape)} tile 4 (K2 and K2s past D = "
              f"320): within {e:.3g} of the CPU run", flush=True)
    del da, want, sha_c
    # C6's relays: past the ring of K2's first any-D form (`ring_fits`: the
    # first D is 9641 for an f32 pass that accumulates; now the shared
    # instance of `pass_layout`), and at the first D of the device
    # instance (28545, small H x W): SGM-8 and SGM-16 over 4 row shards
    # through `distributed_sgm_routed` (K4c's carries do not fit: the K2s
    # engine), bitwise against the plain passes in `sgm_accumulate`'s order
    DC = MAX_D + 1
    while ring_fits(DC, 4, 1):
        DC += 1
    cv_6 = torch.rand((48, 64, DC), generator=g, device=dev) * 4
    cv_d = torch.rand((8, 16, 28545), generator=g, device=dev) * 4
    for vol, n in ((cv_6, 8), (cv_6, 16), (cv_d, 8), (cv_d, 16)):
        dirs = directions_for(n)
        acc = torch.empty(vol.shape, device=dev)
        for k, d in enumerate(x for x in dirs if not x.knight):
            sgm_pass_plain(vol, acc, d, *Q, accumulate=k > 0)
        for d in (x for x in dirs if x.knight):
            acc.add_(knight_volumes_plain(vol, [d], *Q)[0])
        for fn in counters:
            fn.launches = 0
        got = torch.cat(distributed_sgm_routed(list(vol.split(
            vol.shape[0] // 4)), *Q, n))
        l6 = {"K2": sgm_pass.launches, "K2s": sgm_shard_pass.launches,
              "K2s knights": sgm_knight_shard_pass.launches,
              "K4c": lane.fused_rows_shard_pass.launches}
        assert l6["K2"] > 0 and l6["K2s"] > 0 and l6["K4c"] == 0, l6
        err["K2 any-D"] = max(err["K2 any-D"],
                              exact(got, vol + acc, ("C6 relay", n)))
        Dv = vol.shape[-1]
        print(f"  C6: SGM-{n} {tuple(vol.shape)} tile 4 (D = {Dv}: the "
              f"any-D K2's {sgm_shard_pass.layout.carries} instance) through "
              f"distributed_sgm_routed, launches {l6}: equal to the plain "
              f"passes bitwise", flush=True)
    del cv_d
    del acc, got
    for tag, got in (("full step (2, 2, 2)", out_full),
                     ("dense step (2, 4)", out_dense)):
        assert got.shape == (2, H, W) and got.dtype == torch.int32
        share = (got == ref_idx).float().mean().item()
        print(f"  {tag} on the fixtures: idx agree with the single-device "
              f"route {share:.6f}", flush=True)
        assert share >= 0.999, (tag, share)
    assert dry.shape == (4, 96, 256)
    print(f"  dryrun_multichip(8): {tuple(dry.shape)} disparities, the "
          f"(2, 2, 2) factoring", flush=True)

    # -- 16-direction SGM past D = 320 (K4b and the any-D K2k) ---------------
    L, R = pair(H, W, 22, dev)
    cfg = dict(entry.SGM16, disp_width=DW)
    for fn in (box_cv, lane.fused_rows_pass, knight_volumes,
               lane.fused_cols_wta):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d384, i384, t384 = dense_sgm_stereo(ZNCC, L, R, **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    l16 = {"K1": box_cv.launches, "K4b rows": lane.fused_rows_pass.launches,
           "K2k any-D": knight_volumes.launches,
           "K4b WTA": lane.fused_cols_wta.launches}
    print(f"SGM-16 path {H}x{W}x{DW} f32: {wall:.3f} s host wall (first "
          f"call), launches {l16}", flush=True)
    assert all(n > 0 for n in l16.values()), l16
    assert d384.shape == (H, W) and t384.shape == (H, W, 3)
    check_random("SGM-16 D=384 random", d384, i384, DW)
    launches["K2k any-D"] = l16["K2k any-D"]
    launches["K4b stack"] = l16["K4b WTA"]

    # -- timing: the distributed frames beside the single-device route -------
    frames = {
        f"full step (2, 2, 2), 2 fixtures {H}x{W} D={D} SGM-8": (
            lambda: full(ls, rs)),
        "dense step (2, 4), 2 fixtures": lambda: dense(ls, rs),
        "single device, the same 2 pairs (K1, SGM-8, WTA)": (
            lambda: [single_idx(a, b) for a, b in zip(ls, rs)]),
        f"distributed SGM-8 {H}x{W}x{D} tile 8": (
            lambda: distributed_sgm_fused_dhw(sh8, *Q, 8)),
        f"single-device SGM-8 {H}x{W}x{D}": (
            lambda: sgm_cost_volume(cv, *Q[:2], Pout=Q[2], n_directions=8)),
        f"distributed SGM-16 {H}x{W}x{D} tile 8": (
            lambda: distributed_sgm_fused_dhw(sh8, *Q, 16)),
        f"single-device SGM-16 {H}x{W}x{D}": (
            lambda: sgm_cost_volume(cv, *Q[:2], Pout=Q[2], n_directions=16)),
        f"distributed K4c SGM-8 {H}x{W}x{DW} tile 4": (
            lambda: distributed_sgm_fused(sh4, *Q, 8)),
        f"single-device lane SGM-8 {H}x{W}x{DW}": (
            lambda: sgm_cost_volume(cvw, *Q[:2], Pout=Q[2], n_directions=8)),
        f"SGM-16 frame {H}x{W} D={DW} f32": (
            lambda: dense_sgm_stereo(ZNCC, L, R, **cfg)),
        "dryrun_multichip(8)": lambda: entry.dryrun_multichip(8, dev),
    }
    for name, fn in frames.items():
        print(f"time: {name}: {median_ms(fn):.3f} ms (median of 5; {smi})",
              flush=True)

    cv_c = [torch.cat([x[:, j0:j1] for x in sh8]) for j0, j1 in cols]

    def k2s_job(shard_fn, knight_fn):
        """The K2s passes of one 16-direction SGM over the tile-8 shards:
        the 6 vertical and diagonal directions and the 4 down/up knights
        relayed over row shards, the 4 left/right knights over column
        shards (176 launches)."""
        accs = [torch.zeros_like(x) for x in sh8]
        acc_c = [torch.zeros_like(x) for x in cv_c]
        for d in PRINC + VK:
            def run(m, c, d=d):
                if d in PRINC:
                    return shard_fn(sh8[m], accs[m], d, *Q, True, c, i8[m], H)
                return knight_fn(sh8[m], accs[m], d, *Q, c, i8[m], H)
            carry_relay(devs8, run, reverse=d.steps[0][0] < 0)
        for d in HK:
            def run(m, c, d=d):
                j0 = cols[m][0]
                return knight_fn(cv_c[m], acc_c[m], d, *Q, c, j0, W, col0=j0,
                                 W_pout=W)
            carry_relay(devs8, run, reverse=d.steps[0][1] < 0)

    def k4c_job(fn):
        """K4c's down and up relays over the tile-4 shards (8 launches)."""
        adj = [None] * 4
        for rev in (False, True):
            def run(m, c, rev=rev):
                adj[m], co = fn(sh4[m], adj[m], c, i4[m], H, rev, True, **kw4)
                return co
            carry_relay(devs4, run, reverse=rev)

    acc_w = torch.zeros_like(cvw)
    kv_p = torch.empty((8,) + tuple(cvw.shape), device=dev)

    kv = torch.empty_like(kv_p)

    def k2k_plain():
        """The lane route's knights in their plain version: the 8 volumes
        of the stack the WTA scan sums."""
        knight_volumes_plain(cvw, _KNIGHT_DIRS, *Q, out=kv_p)

    def k2a_job(fn):
        """7 K2 passes past D = 320 (the registers instance) on the
        480x640x384 volume."""
        for k, d in enumerate(PRINC + [SgmDirection.LEFT2RIGHT]):
            fn(cvw, acc_w, d, *Q, accumulate=k > 0)

    jobs = {
        "K2 any-D": (lambda: k2a_job(sgm_pass),
                     lambda: k2a_job(sgm_pass_plain), 1),
        "K2s": (lambda: k2s_job(sgm_shard_pass, sgm_knight_shard_pass),
                lambda: k2s_job(sgm_shard_pass_plain,
                                sgm_knight_shard_pass_plain), 1),
        "K4c": (lambda: k4c_job(lane.fused_rows_shard_pass),
                lambda: k4c_job(lane.fused_rows_shard_pass_plain), 2),
        # as the lane route runs it: two launches into the stack of 8
        # volumes that K4b's last scan sums (the 8 ordered adds are gone)
        "K2k any-D": (lambda: knight_volumes(cvw, _KNIGHT_DIRS, *Q, out=kv),
                      k2k_plain, 1),
    }
    # the any-D K2 a launch on a 12x64xD shard, in each instance of
    # `pass_layout`: the D = 330 relays' shard (80 launches), C6's D, and
    # the first D of each instance (registers K = 4 and 8, shared carries,
    # device carries); K2 left to right and K2s top to bottom from random
    # carries, against the plain passes (K2 at 1e-4, K2s bitwise; whether
    # K2 is bitwise too is printed), then kernel and plain timed in turns;
    # each launch's layout as its launcher reports it
    LR, DOWN = SgmDirection.LEFT2RIGHT, SgmDirection.UP2DOWN

    def layout_tag(ly):
        return (f"{ly.carries} K={ly.K} G={ly.G} S={ly.stages} "
                f"smem={ly.smem}")

    instances = {}
    for Dk in (321, DA, 1025, 8193, DC, 28545):
        x = torch.rand((12, 64, Dk), generator=g, device=dev) * 4
        a = torch.rand(x.shape, generator=g, device=dev)
        c = torch.rand((x.shape[1], Dk), generator=g, device=dev)
        a_k, a_p = a.clone(), a.clone()
        sgm_pass(x, a_k, LR, *Q)
        ly = sgm_pass.layout
        sgm_pass_plain(x, a_p, LR, *Q)
        err["K2 any-D"] = max(err["K2 any-D"], close(a_k, a_p))
        k2_bitwise = torch.equal(a_k, a_p)
        a_k, a_p = a.clone(), a.clone()
        exact(sgm_shard_pass(x, a_k, DOWN, *Q, True, c, 12, 48),
              sgm_shard_pass_plain(x, a_p, DOWN, *Q, True, c, 12, 48),
              ("K2s any-D carries", Dk))
        exact(a_k, a_p, ("K2s any-D", Dk))
        del a_k, a_p
        tag = (f"K2 {layout_tag(ly)}; K2s "
               f"{layout_tag(sgm_shard_pass.layout)}")
        instances[f"12x64x{Dk}"] = tag
        one = {
            "K2 (left to right)": (
                lambda: sgm_pass(x, a, LR, *Q),
                lambda: sgm_pass_plain(x, a, LR, *Q)),
            "K2s (top to bottom, carries in and out)": (
                lambda: sgm_shard_pass(x, a, DOWN, *Q, True, c, 12, 48),
                lambda: sgm_shard_pass_plain(x, a, DOWN, *Q, True, c, 12,
                                             48)),
        }
        nb = bound(3 * x.numel() * 4, SGM_OPS * x.numel())[0]
        print(f"any-D K2 12x64x{Dk} ({tag}): K2 within 1e-4 of the plain "
              f"pass (bitwise: {k2_bitwise}), K2s equal bitwise",
              flush=True)
        for name, (kern, plain) in one.items():
            p1, k1, k2_, p2 = (median_ms(plain), median_ms(kern),
                               median_ms(kern), median_ms(plain))
            print(f"time: any-D {name}, one launch on a 12x64x{Dk} shard "
                  f"({ly.carries}): kernel {(k1 + k2_) / 2:.4f} ms vs plain "
                  f"{(p1 + p2) / 2:.4f} ms, bound {nb:.4f} ms (median of 5, "
                  f"twice each; {smi})", flush=True)
    del x, a, c
    del cv_6
    # the 7 passes of the K2 any-D job into one accumulator, against the
    # plain passes in the same order
    k2a_job(sgm_pass)
    got = acc_w.clone()
    k2a_job(sgm_pass_plain)
    e = close(got, acc_w)
    err["K2 any-D"] = max(err["K2 any-D"], e)
    print(f"any-D K2, 7 passes into one accumulator {tuple(cvw.shape)} "
          f"(launched {layout_tag(sgm_pass.layout)} last): within {e:.3g} "
          f"of the plain passes (bitwise: {torch.equal(got, acc_w)})",
          flush=True)
    del got
    ms = {}
    for name, (kern, plain, n) in jobs.items():
        w = 1 if n > 1 else 0
        p1, k1, k2_, p2 = (median_ms(plain, n, w), median_ms(kern),
                           median_ms(kern), median_ms(plain, n, w))
        ms[name] = ((k1 + k2_) / 2, (p1 + p2) / 2)
        print(f"time: {name} kernel {ms[name][0]:.3f} ms vs plain "
              f"{ms[name][1]:.3f} ms (kernel median of 5, plain median of "
              f"{n}, twice each; {smi})", flush=True)
    N, NW = H * W * D, H * W * DW
    bounds = {
        # cv read once, acc read and written once; 14 directions' DP ops
        "K2s": bound(3 * N * 4, SGM_OPS * 14 * N),
        # cv read once, the adj volume written once; 6 directions' DP ops
        "K4c": bound(2 * NW * 4, SGM_OPS * 6 * NW),
        # cv read once, acc read and written once; 8 directions' DP ops
        "K2k any-D": bound(3 * NW * 4, SGM_OPS * 8 * NW),
        # cv read once, acc written once; 7 directions' DP ops
        "K2 any-D": bound(2 * NW * 4, SGM_OPS * 7 * NW),
    }
    return err, launches, ms, bounds, instances


# K1's call, the flagship frame and SGM-16 as a checkout's own code runs
# them, in a process started at the checkout's root (so another commit's
# tree is timed the same way): CUDA events, median of 5 after 3 warm-ups;
# the flagship's and the two SGM-16 frames' device items (kernels, copies,
# sets) and busy time under torch.profiler; K2k (the 8 knight directions
# added to an accumulator at 480x640x120 and 480x640x384 f32) and K3 as
# SGM-16 runs them in that tree (this tree: the knight volumes, K3 over
# the 15-volume stack; a tree before them: two launches a direction into
# one accumulator, K3 over it); the distributed SGM-16 frame over the
# 480x640x120 row shards, tile 8, and its K2s relays alone
CHECKOUT_TIMING = r"""
import json, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import MatchingFunction
from libstevi_tpu_torch.ops import dense_sgm_stereo
from libstevi_tpu_torch.ops import sgm_cuda as sc
from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
from libstevi_tpu_torch.ops.box_cuda import box_cv
from libstevi_tpu_torch.ops.sgm import (SgmDirection, _KNIGHT_DIRS,
                                        directions_for)
from libstevi_tpu_torch.parallel.sgm_dist import (
    _column_split, carry_relay, distributed_sgm_fused_dhw)
from libstevi_tpu_torch.profile_frames import profile_frame
rng = np.random.default_rng(3)
L, R = (torch.from_numpy(rng.uniform(0, 1, (480, 640)).astype(np.float32))
        .cuda() for _ in range(2))
ZNCC, Q = MatchingFunction.ZNCC, (0.1, 0.5, 100.0)

def med(fn, warm=3, reps=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)

def frame(fn):
    ms = med(fn)
    busy, items = profile_frame(fn, 5)
    top = sorted(items.items(), key=lambda kv: -kv[1][0])[:5]
    return ms, busy / 1e3, sum(n for _, n in items.values()), [
        [name, round(us, 1), round(n, 1)] for name, (us, n) in top]

out = {}
# the 4K UHD frame first, while the card is empty (a chain that holds the
# SGM volume takes ~64 GB): the tree's entry, or the same configuration
# through dense_sgm_stereo where a tree has none (1 warm-up and 2 frames
# there: its K4d ran the chunks in series, ~7 s a frame)
L4, R4 = (torch.from_numpy(np.random.default_rng(4).uniform(
    0, 1, (2160, 3840)).astype(np.float32)).cuda() for _ in range(2))
if hasattr(entry, "uhd_wide_forward"):
    out["uhd_ms"] = med(lambda: entry.uhd_wide_forward(L4, R4))
else:
    out["uhd_ms"] = med(lambda: dense_sgm_stereo(ZNCC, L4, R4, **entry.WIDE),
                        warm=1, reps=2)
torch.cuda.empty_cache()
# the distributed 4K UHD step: 4 row shards of the one card, ZNCC 7x7,
# D = 384, SGM-8 through the K2s engine (K4c's carries do not fit): median
# of 3 after a warm-up, its device items over one frame, its peak memory
from libstevi_tpu_torch.parallel import MeshSpec, make_stereo_mesh
from libstevi_tpu_torch.parallel.stereo import distributed_dense_stereo_step
step4 = distributed_dense_stereo_step(
    make_stereo_mesh(MeshSpec(batch=1, tile=4), [torch.device("cuda")] * 4),
    ZNCC, 3, 3, 384, 0.1, 0.5, n_directions=8)
f4 = lambda: step4(L4[None], R4[None])
out["dist4k_ms"] = med(f4, warm=1, reps=3)
busy, items = profile_frame(f4, 1)
out["dist4k_busy_ms"] = busy / 1e3
out["dist4k_top"] = [[name, round(us, 1), round(n, 1)] for name, (us, n) in
                     sorted(items.items(), key=lambda kv: -kv[1][0])[:6]]
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
f4()
torch.cuda.synchronize()
out["dist4k_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
del L4, R4, step4, f4
torch.cuda.empty_cache()
# the any-D K2 a launch on 12x64xD shards (the D = 330 relays' shard, C6's
# D = 9641, and the device instance's first D, 28545): left to right (K2),
# top to bottom with carries (K2s); the 7 passes of 480x640x384 f32 into
# one accumulator
g2 = torch.Generator(device="cuda").manual_seed(5)
LR, DOWN = SgmDirection.LEFT2RIGHT, SgmDirection.UP2DOWN
out["k2_launch"], out["k2_launch_dev"] = {}, {}

def dev_ms(fn, reps=10):
    # the device time of the kernels one call launches (torch.profiler)
    fn()
    torch.cuda.synchronize()
    return profile_frame(fn, reps)[0] / 1e3

for D in (330, 9641, 28545):
    x = torch.rand((12, 64, D), generator=g2, device="cuda") * 4
    a = torch.rand(x.shape, generator=g2, device="cuda")
    c = torch.rand((64, D), generator=g2, device="cuda")
    k2 = lambda: sc.sgm_pass(x, a, LR, 0.3, 1.1, 7.0)
    k2s = lambda: sc.sgm_shard_pass(x, a, DOWN, 0.3, 1.1, 7.0, True, c, 12,
                                    48)
    out["k2_launch"][D] = (med(k2), med(k2s))
    out["k2_launch_dev"][D] = (dev_ms(k2), dev_ms(k2s))
del x, a, c
cw7 = torch.rand((480, 640, 384), generator=g2, device="cuda") * 4
acc7 = torch.empty_like(cw7)
k2_dirs7 = [d for d in directions_for(8) if d.step[0] != 0] + [LR]

def k2a():
    for k, d in enumerate(k2_dirs7):
        sc.sgm_pass(cw7, acc7, d, 0.3, 1.1, 7.0, accumulate=k > 0)

out["k2a_ms"] = med(k2a)
del cw7, acc7
# K5 at 480x640, D = 120 (RIGHT_TO_LEFT's shifts), ZSAD's 'sad' with f32
# out: F = 49 (a gray 7x7 window) and 147 (RGB); the WTA ZSAD frame
from libstevi_tpu_torch.ops.fv_backend import fused_fv_cost_volume
for F in (49, 147):
    fs, ft = (torch.rand((480, 640, F), generator=g2, device="cuda") - 0.5
              for _ in range(2))
    k5 = lambda: fused_fv_cost_volume("sad", fs, ft, range(120))
    out[f"k5_f{F}_ms"] = med(k5)
    out[f"k5_f{F}_dev_ms"] = dev_ms(k5)
del fs, ft
out["wta_zsad_ms"] = med(lambda: entry.wta_forward(MatchingFunction.ZSAD, L,
                                                   R))
torch.cuda.empty_cache()
out["k1_ms"] = med(lambda: box_cv(ZNCC, L, R, 3, 3, 120, torch.bfloat16,
                                  True))
# PatchMatch: the frame with its device items; K6 and K7 (the search step
# in this tree's form: `search_probe`, or the candidate glue and `probe`
# of a tree before it) at the frame's shapes, from a random state
from libstevi_tpu_torch.ops import patchmatch as pmm
from libstevi_tpu_torch.ops import patchmatch_cuda as pmc
gen = torch.Generator(device="cuda")
out["pm"] = frame(lambda: entry.patchmatch_forward(L, R, gen.manual_seed(0)))
gp = torch.Generator(device="cuda").manual_seed(7)

def pm_state(cv):
    H, W, D = cv.shape
    d = torch.randint(0, D, (H, W), generator=gp, device="cuda",
                      dtype=torch.int32)
    return d, pmc.probe(cv, d, d, torch.full((H, W), float("inf"),
                                             device="cuda"), 0)[1]

pcv = pmm.cost_oriented_volume(MatchingFunction.NCC, box_cv(
    MatchingFunction.NCC, L, R, 3, 3, 120), 0)
d1, c1 = pm_state(pcv)
draws = torch.randint(0, 120, (4, 480, 640), generator=gp, device="cuda",
                      dtype=torch.int32)
for axis, key in ((1, "k6_w_ms"), (0, "k6_h_ms")):
    out[key] = med(lambda: pmc.sweep(pcv, d1, c1, 0, axis, False))
out["k7_k1_ms"] = med(lambda: pmc.probe(pcv, draws[0], d1, c1, 0))
out["k7_k4_ms"] = med(lambda: pmc.probe(pcv, draws, d1, c1, 0))
if hasattr(pmc, "search_probe"):
    search = lambda: pmc.search_probe(pcv, draws, d1, c1, 0, 4)
else:
    search = lambda: pmc.probe(pcv, torch.stack(
        [pmm._scaled_candidate(draws[k], d1, k, 4) for k in range(4)]), d1,
        c1, 0)
out["search_ms"] = med(search)

def host_us(fn, n=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6

# the wrappers' host cost a call (launches queued, no synchronisation)
out["k6_host_us"] = host_us(lambda: pmc.sweep(pcv, d1, c1, 0, 1, False))
out["k7_host_us"] = host_us(lambda: pmc.probe(pcv, draws[0], d1, c1, 0))
out["search_host_us"] = host_us(search)
hcv = torch.rand((720, 1280, 320), generator=gp, device="cuda")
dh, ch = pm_state(hcv)
for axis, key in ((1, "k6_hd_w_ms"), (0, "k6_hd_h_ms")):
    out[key] = med(lambda: pmc.sweep(hcv, dh, ch, 0, axis, False))
del pcv, hcv
torch.cuda.empty_cache()
(out["frame_ms"], out["busy_ms"], out["device_items"],
 _) = frame(lambda: entry.flagship_forward(L, R))
for key, D in (("sgm16", 120), ("sgm16_d384", 384)):
    cfg = dict(entry.SGM16, disp_width=D)
    out[key] = frame(lambda: dense_sgm_stereo(ZNCC, L, R, **cfg))
out["wide"] = frame(lambda: entry.wide_forward(L, R))
Lh, Rh = (torch.from_numpy(rng.uniform(0, 1, (720, 1280)).astype(np.float32))
          .cuda() for _ in range(2))
out["hd_wide"] = frame(lambda: entry.hd_wide_forward(Lh, Rh))
del Lh, Rh
torch.cuda.empty_cache()
cv = box_cv(ZNCC, L, R, 3, 3, 120, torch.float32, True)
cvw = box_cv(ZNCC, L, R, 3, 3, 384, torch.float32, True)
dirs = [d for d in directions_for(16) if d is not SgmDirection.RIGHT2LEFT]
acc, acc_w = torch.zeros_like(cv), torch.zeros_like(cvw)
if hasattr(sc, "knight_volumes"):
    k2k = lambda: sc.add_knight_volumes(cv, acc, _KNIGHT_DIRS, *Q)
    k2k_any = lambda: sc.add_knight_volumes(cvw, acc_w, _KNIGHT_DIRS, *Q)
    stack = torch.empty((15,) + tuple(cv.shape), device=cv.device)
    sc.direction_volumes(cv, dirs[:7], *Q, out=stack[:7])
    sc.knight_volumes(cv, dirs[7:], *Q, out=stack[7:])
    out["k2k_volumes_ms"] = med(lambda: sc.knight_volumes(
        cv, _KNIGHT_DIRS, *Q, out=stack[7:]))
else:
    k2k = lambda: [sc.sgm_knight_pass(cv, acc, d, *Q) for d in _KNIGHT_DIRS]
    k2k_any = lambda: [sc.sgm_knight_pass(cvw, acc_w, d, *Q)
                       for d in _KNIGHT_DIRS]
    stack = sc.sgm_accumulate(cv, dirs, *Q)
out["k2k_ms"], out["k2k_any_ms"] = med(k2k), med(k2k_any)
out["k3_ms"] = med(lambda: sc.sgm_wta(cv, stack, *Q, 1, 3, 3, True))
del stack, acc, acc_w
# K4b as the wide frame runs it: fused_adj with WTA at 480x640x384
out["k4b_ms"] = med(lambda: lane.fused_adj(cvw, 0, 640, *Q, 8, wta_radius=1))
# K4d: the whole chunked_adj at 480x640x384 (no entry takes it there)
out["k4d_ms"] = med(lambda: lane.chunked_adj(cvw, 0, 640, *Q, 8))
del cvw
g = torch.Generator(device="cuda").manual_seed(21)
sh8 = list((torch.rand((480, 640, 120), generator=g, device="cuda") * 4)
           .split(60))
out["dist16_ms"] = med(lambda: distributed_sgm_fused_dhw(sh8, 0.3, 1.1, 7.0,
                                                         16))
cols = _column_split(640, 8)
cv_c = [torch.cat([x[:, j0:j1] for x in sh8]) for j0, j1 in cols]
princ = [d for d in directions_for(8) if d.step[0] != 0]
vk = [d for d in _KNIGHT_DIRS if d.steps[0][0] != 0]
hk = [d for d in _KNIGHT_DIRS if d.steps[0][0] == 0]

def k2s():
    # the K2s passes of that frame: the vertical and diagonal directions
    # and the down/up knights relayed over the row shards, the left/right
    # knights over column shards
    accs = [torch.zeros_like(x) for x in sh8]
    acc_c = [torch.zeros_like(x) for x in cv_c]
    for d in princ + vk:
        def run(m, c, d=d):
            if d in princ:
                return sc.sgm_shard_pass(sh8[m], accs[m], d, 0.3, 1.1, 7.0,
                                         True, c, 60 * m, 480)
            return sc.sgm_knight_shard_pass(sh8[m], accs[m], d, 0.3, 1.1,
                                            7.0, c, 60 * m, 480)
        carry_relay(["cuda"] * 8, run, reverse=d.steps[0][0] < 0)
    for d in hk:
        def run(m, c, d=d):
            j0 = cols[m][0]
            return sc.sgm_knight_shard_pass(cv_c[m], acc_c[m], d, 0.3, 1.1,
                                            7.0, c, j0, 640, col0=j0,
                                            W_pout=640)
        carry_relay(["cuda"] * 8, run, reverse=d.steps[0][1] < 0)

out["k2s_ms"] = med(k2s)
sh4 = list((torch.rand((480, 640, 384), generator=g, device="cuda") * 4)
           .split(120))

def k4c():
    # K4c's down and up relays over the tile-4 row shards (8 launches)
    adj = [None] * 4
    for rev in (False, True):
        def run(m, c, rev=rev):
            adj[m], co = lane.fused_rows_shard_pass(
                sh4[m], adj[m], c, 120 * m, 480, rev, True, col0=0,
                W_pout=640, P1=0.3, P2=1.1, Pout=7.0)
            return co
        carry_relay(["cuda"] * 4, run, reverse=rev)

out["k4c_ms"] = med(k4c)
print(json.dumps(out))
"""


def time_checkout(root):
    """CHECKOUT_TIMING run from ``root``: its dict."""
    run = subprocess.run([sys.executable, "-c", CHECKOUT_TIMING], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def parent_and_change(parent, smi):
    """CHECKOUT_TIMING of this checkout and, where ``parent`` names another
    commit's checkout, of that one too, in turns (parent, change, change,
    parent); prints each run's numbers and each one's mean."""
    torch.cuda.empty_cache()
    order = ([("parent", parent), ("change", ROOT), ("change", ROOT),
              ("parent", parent)] if parent else [("change", ROOT)])
    runs = {}
    for name, root in order:
        r = time_checkout(root)
        runs.setdefault(name, []).append(r)
        print(f"time run: {name}: {json.dumps(r)} ({smi})", flush=True)
    for name, rs in runs.items():
        mean = {k: statistics.mean(r[k] for r in rs)
                for k in rs[0] if isinstance(rs[0][k], (int, float))}
        for key in ("sgm16", "sgm16_d384", "wide", "hd_wide", "pm"):
            mean[key] = statistics.mean(r[key][0] for r in rs)
            mean[key + "_busy"] = statistics.mean(r[key][1] for r in rs)
        print(f"time: {name} ({len(rs)} run(s)): K1 box_cv 480x640x120 bf16 "
              f"{mean['k1_ms']:.4f} ms, flagship frame {mean['frame_ms']:.3f}"
              f" ms, device busy {mean['busy_ms']:.3f} ms, "
              f"{mean['device_items']:.1f} device items a frame; SGM-16 "
              f"frame D=120 {mean['sgm16']:.3f} ms (busy "
              f"{mean['sgm16_busy']:.3f}), D=384 {mean['sgm16_d384']:.3f} ms "
              f"(busy {mean['sgm16_d384_busy']:.3f}); K2k 8 directions into "
              f"an accumulator 480x640x120 f32 {mean['k2k_ms']:.3f} ms, "
              f"480x640x384 {mean['k2k_any_ms']:.3f} ms; K3 as SGM-16 runs it "
              f"{mean['k3_ms']:.3f} ms; distributed SGM-16 tile 8 "
              f"{mean['dist16_ms']:.3f} ms, its K2s passes "
              f"{mean['k2s_ms']:.3f} ms; wide frame 480x640 D=384 "
              f"{mean['wide']:.3f} ms (busy {mean['wide_busy']:.3f}), HD "
              f"wide 720x1280 D=640 {mean['hd_wide']:.3f} ms (busy "
              f"{mean['hd_wide_busy']:.3f}); K4b fused_adj + WTA "
              f"480x640x384 {mean['k4b_ms']:.3f} ms; K4c relays 4 x "
              f"120x640x384 {mean['k4c_ms']:.3f} ms; K4d chunked_adj "
              f"480x640x384 {mean['k4d_ms']:.3f} ms; 4K UHD frame "
              f"2160x3840 D=384 {mean['uhd_ms']:.3f} ms; PatchMatch frame "
              f"480x640 D=120 {mean['pm']:.3f} ms (busy "
              f"{mean['pm_busy']:.3f}); K6 sweep 480x640x120 along W "
              f"{mean['k6_w_ms']:.4f} ms, along H {mean['k6_h_ms']:.4f} ms, "
              f"720x1280x320 along W {mean['k6_hd_w_ms']:.4f} ms, along H "
              f"{mean['k6_hd_h_ms']:.4f} ms; K7 probe K=1 "
              f"{mean['k7_k1_ms']:.4f} ms, K=4 {mean['k7_k4_ms']:.4f} ms; "
              f"the search step (the tree's form, K=4) "
              f"{mean['search_ms']:.4f} ms; host µs a call: K6 "
              f"{mean['k6_host_us']:.1f}, K7 K=1 {mean['k7_host_us']:.1f}, "
              f"the search step {mean['search_host_us']:.1f} (CUDA events, "
              f"median "
              f"of 5 a run after 3 warm-ups; a tree without "
              f"entry.uhd_wide_forward: its 4K frame median of 2 after 1; "
              f"{smi})", flush=True)
        dist_top = rs[-1]["dist4k_top"]
        k2l = {D: tuple(statistics.mean(r[key][D][i] for r in rs)
                        for key in ("k2_launch", "k2_launch_dev")
                        for i in (0, 1))
               for D in rs[0]["k2_launch"]}
        print(f"time: {name} ({len(rs)} run(s)): distributed 4K UHD step "
              f"2160x3840 D=384 SGM-8, 4 row shards (K2s engine) "
              f"{mean['dist4k_ms']:.3f} ms (median of 3 after a warm-up), "
              f"busy {mean['dist4k_busy_ms']:.3f} ms, idle "
              f"{1 - mean['dist4k_busy_ms'] / mean['dist4k_ms']:.3f}, peak "
              f"{mean['dist4k_peak_gb']:.3f} GB above the inputs, top items "
              f"(name, us, launches a frame) {dist_top}; the any-D K2 a "
              f"launch on 12x64xD, K2 left to right / K2s top to bottom, "
              f"a call (on the device): "
              + ", ".join(f"D={D} {a:.4f} / {b:.4f} ms ({c:.4f} / {d:.4f})"
                          for D, (a, b, c, d) in k2l.items())
              + f"; 7 passes 480x640x384 f32 {mean['k2a_ms']:.3f} ms; K5 "
              f"480x640x120 'sad' f32 F=49 {mean['k5_f49_ms']:.4f} ms (on "
              f"the device {mean['k5_f49_dev_ms']:.4f}), F=147 "
              f"{mean['k5_f147_ms']:.4f} ms ({mean['k5_f147_dev_ms']:.4f}); "
              f"WTA ZSAD frame 480x640 D=120 "
              f"{mean['wta_zsad_ms']:.3f} ms ({smi})", flush=True)
    if not parent:
        print("time: parent not given (--parent DIR, a checkout of the "
              "parent commit)", flush=True)


def main(argv=None) -> int:
    t_script = time.perf_counter()
    args = sys.argv[1:] if argv is None else argv
    parent = None
    if args[:1] == ["--parent"] and len(args) == 2:
        parent = str(Path(args[1]).resolve())
    elif args:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs only "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from libstevi_tpu_torch import _build, entry
    from libstevi_tpu_torch.core import (Margins, MatchingFunction,
                                         SearchOffset1)
    from libstevi_tpu_torch.io import read_stevimg
    from libstevi_tpu_torch.ops import (dense_sgm_stereo,
                                        normalize_feature_volume,
                                        sgm_cost_volume, sgm_wta_truncated,
                                        unfold, unfold_based_cost_volume)
    from libstevi_tpu_torch.ops.box_cuda import (box_cv, box_cv_plain,
                                                 window_stats, _prep_inputs)
    from libstevi_tpu_torch.ops.fv_backend import (fused_fv_cost_volume,
                                                   fused_fv_cost_volume_plain,
                                                   fv_instance)
    from libstevi_tpu_torch.ops.patchmatch import (_patch_match_stereo_cv,
                                                   cost_oriented_volume)
    from libstevi_tpu_torch.ops.patchmatch_cuda import (
        probe, probe_plain, search_probe, search_probe_plain, sweep,
        sweep_plain)
    from libstevi_tpu_torch.ops.sgm import (SgmDirection, directions_for,
                                            direction_adj, _KNIGHT_DIRS,
                                            _tcv_from_bands)
    from libstevi_tpu_torch.ops.sgm_cuda import (add_knight_volumes,
                                                 knight_volumes,
                                                 knight_volumes_plain,
                                                 ring_fits, sgm_pass,
                                                 sgm_pass_plain, sgm_wta,
                                                 sgm_wta_plain)
    from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
    from libstevi_tpu_torch.ops.refinement import (
        InterpolationKernel, refine_disp_cost_interpolation)
    from libstevi_tpu_torch.ops.sgm import _grouped_adj, wta_bands
    from libstevi_tpu_torch.ops.sgm_cuda import (_acc_sum, direction_volumes,
                                                 sgm_accumulate, sgm_wta_fused)
    from libstevi_tpu_torch.statistics import prop_good, inlier_mae

    dev = torch.device("cuda")

    def mark(what):
        """The script's elapsed seconds as the section ``what`` starts."""
        print(f"[script] {what}: {time.perf_counter() - t_script:.1f} s",
              flush=True)

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = card()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- build ---------------------------------------------------------------
    secs = _build.build_all()
    print(f"build: {secs:.2f} s (nvcc, sm_90a)", flush=True)
    for name in _build.SIGNATURES:
        report = _build.ptxas_report(name)
        regs = [line.split("Used ")[1].split(",")[0]
                for line in report.splitlines() if "Used " in line]
        spills = spilling_instances(report)
        print(f"  {name}: {len(regs)} kernel instances, registers "
              f"{sorted(set(regs))}, spilling instances {len(spills)}",
              flush=True)
        for line in spills:
            print(f"    {line}", flush=True)
    # the checkouts' timing first, while this process holds no volume: a
    # parent's 4K frame holds ~64 GB of the card
    parent_and_change(parent, smi)
    # the CPU references of the full-size holds, beside the card's work
    start_cpu_jobs()

    ZNCC = MatchingFunction.ZNCC
    R2L = SgmDirection.RIGHT2LEFT
    k2_dirs = [d for d in directions_for(8) if d is not R2L]
    err = {"K1": 0.0, "K1 stats": 0.0, "K2": 0.0, "K2k": 0.0, "K3": 0.0,
           "K2x7": 0.0, "K3x7": 0.0}
    KD = _KNIGHT_DIRS

    def k1_exact(L, R, D, dts, tag, funcs=(ZNCC,), h=3, v=3):
        """K1's statistics kernel against `_prep_inputs` and its volume
        against `box_cv_plain`, bit for bit: f32 equal, bf16 equal to the
        plain f32 rounded once."""
        for f in funcs:
            got = window_stats(f, L, R, h, v)
            for a, b in zip(got[2:6], _prep_inputs(f, L, R, h, v)[2:6]):
                exact(a, b, ("K1 stats", f, tag))
            want = box_cv_plain(f, L, R, h, v, D, torch.float32, negate=True)
            for dt in dts:
                exact(box_cv(f, L, R, h, v, D, dt, negate=True),
                      want.to(dt), ("K1", f, tag, dt))
            del want
        print(f"K1 {tag} {[f.name for f in funcs]} "
              f"{[str(dt).split('.')[-1] for dt in dts]}: statistics equal "
              f"_prep_inputs and the volume box_cv_plain bit for bit",
              flush=True)

    mark("kernel phases: each kernel against its plain version")
    # -- kernel phases: each kernel against its plain version ----------------
    # D=300 takes K = 10 values a lane in K2, K2k and K3; the HD path's
    # shape (720x1280, D=320, bf16) fills every slice of every lane
    both = (torch.float32, torch.bfloat16)
    # K1 on every kind, and on a pair with flat patches of 200/255 (ZNCC
    # cancels in windows wholly inside one, see ops/box_cuda.py)
    Lf, Rf = pair(480, 640, 2, dev)
    for i in range(0, 480, 96):
        for j in range(0, 640, 128):
            Lf[i:i + 40, j:j + 60] = 200 / 255
            Rf[i + 6:i + 46, j + 9:j + 69] = 200 / 255
    kinds = (MatchingFunction.CC, MatchingFunction.NCC, MatchingFunction.ZCC,
             ZNCC)
    k1_exact(Lf, Rf, 120, both, "480x640x120 flat patches", kinds)
    # the instances other windows take: one row a thread (2v + 1 < 4), and
    # the vertical sums recomputed (h = 0, 2h + 1 > 11)
    for h, v in ((2, 1), (0, 2), (6, 1)):
        k1_exact(Lf[:50, :200], Rf[:50, :200], 37, both,
                 f"50x200x37 h={h} v={v} flat patches", kinds, h, v)
    del Lf, Rf
    for (H, W, D), dts in (((480, 640, 120), both), ((37, 101, 13), both),
                           ((40, 360, 300), both),
                           ((entry.HD_HEIGHT, entry.HD_WIDTH, 320),
                            (torch.bfloat16,))):
        L, R = pair(H, W, 1, dev)
        k1_exact(L, R, D, dts, f"{H}x{W}x{D}",
                 kinds if (H, W) == (480, 640) else (ZNCC,))
        for dt in dts:
            tag = f"{H}x{W}x{D} {str(dt).split('.')[-1]}"
            cv = box_cv(ZNCC, L, R, 3, 3, D, dt, negate=True)
            acc = torch.empty(cv.shape, device=dev)
            acc_p = torch.empty(cv.shape, device=dev)
            for k, d in enumerate(k2_dirs):
                sgm_pass(cv, acc, d, P1, P2, POUT, accumulate=k > 0)
                sgm_pass_plain(cv, acc_p, d, P1, P2, POUT, accumulate=k > 0)
            torch.cuda.synchronize()
            torch.testing.assert_close(acc, acc_p, rtol=1e-4, atol=1e-4)
            e2 = (acc - acc_p).abs().max().item()
            err["K2"] = max(err["K2"], e2)
            print(f"K2 {tag}: 7 passes, max |kernel - plain| = {e2:.3g}",
                  flush=True)
            acc_k2p = acc_p.clone()             # the plain 7-direction sum

            # K2k: the 8 knight directions in one pair of launches, a
            # volume each, run twice, against the plain lane form bitwise;
            # added in order onto the 7 directions' accumulator, the
            # one-launch form and the memory fallback (one direction at a
            # time through one scratch volume) bitwise
            vols = knight_volumes(cv, KD, P1, P2, POUT)
            exact(knight_volumes(cv, KD, P1, P2, POUT), vols,
                  ("K2k two runs", tag))
            vols_p = knight_volumes_plain(cv, KD, P1, P2, POUT)
            err["K2k"] = max(err["K2k"], exact(vols, vols_p, ("K2k", tag)))
            del vols_p
            acc_k = acc.clone()
            for v in vols:
                acc_k.add_(v)
                acc_p.add_(v)
            exact(add_knight_volumes(cv, acc.clone(), KD, P1, P2, POUT,
                                     one_launch=True), acc_k,
                  ("K2k ordered sum", tag))
            exact(add_knight_volumes(cv, acc.clone(), KD, P1, P2, POUT,
                                     one_launch=False), acc_k,
                  ("K2k n = 1 fallback", tag))
            e16 = close(acc_k, acc_p)
            print(f"K2k {tag}: 8 directions in two launches equal the plain "
                  f"lane form bitwise, two runs equal, the ordered sum and "
                  f"the n = 1 fallback equal bitwise; 16-direction sum "
                  f"within {e16:.3g} of the plain passes'", flush=True)
            del acc_p

            e3 = k3_vs_plain(cv, acc_k, f"K3 {tag}")
            err["K3"] = max(err["K3"], e3)
            # the one-launch form: the 7 directions in one K2 launch, a
            # volume each, summed in order by K3: the same bits as the
            # sequence, and K3 over the stack against its plain version
            stack = direction_volumes(cv, k2_dirs, P1, P2, POUT)
            seq = sgm_accumulate(cv, k2_dirs, P1, P2, POUT)
            exact(_acc_sum(stack), seq, ("K2 stack", tag))
            for a, b in zip(sgm_wta(cv, stack, P1, P2, POUT, 1, 3, 3, True),
                            sgm_wta(cv, seq, P1, P2, POUT, 1, 3, 3, True)):
                exact(torch.nan_to_num(a, 9.0), torch.nan_to_num(b, 9.0),
                      ("K3 stack", tag))
            err["K2x7"] = max(err["K2x7"],
                              close(_acc_sum(stack), acc_k2p))
            err["K3x7"] = max(err["K3x7"],
                              k3_vs_plain(cv, stack, f"K3 over 7 {tag}"))
            print(f"K2 {tag}: one launch into 7 volumes sums to the "
                  f"sequential accumulator bitwise; K3 over them equals K3 "
                  f"over it bitwise", flush=True)
            del seq, acc_k2p
            # SGM-16's one-launch form: the 7 K2 volumes and the 8 knight
            # volumes in one stack, which K3 sums in order: the sequential
            # 16-direction accumulator's bits
            stack15 = torch.empty((15,) + tuple(cv.shape), device=dev)
            stack15[:7] = stack
            stack15[7:] = vols
            del stack, vols
            exact(_acc_sum(stack15), acc_k, ("K2 + K2k stack", tag))
            for a, b in zip(sgm_wta(cv, stack15, P1, P2, POUT, 1, 3, 3,
                                    True),
                            sgm_wta(cv, acc_k, P1, P2, POUT, 1, 3, 3, True)):
                exact(torch.nan_to_num(a, 9.0), torch.nan_to_num(b, 9.0),
                      ("K3 over 15", tag))
            err["K3"] = max(err["K3"], k3_vs_plain(cv, stack15,
                                                   f"K3 over 15 {tag}"))
            print(f"K3 {tag}: over the 15 volumes of SGM-16 equal to K3 over "
                  f"the sequential accumulator bitwise", flush=True)
            del stack15, acc_k, acc

    # SGM margins: the region runs contiguous (image column offset and
    # width for Pout) and is padded back; against the plain path on the CPU
    L, R = pair(37, 101, 11, dev)
    cv = box_cv(ZNCC, L, R, 3, 3, 13, torch.float32, negate=True)
    m = Margins(2, 1, 3, 2)
    sgm_pass.launches = knight_volumes.launches = 0
    for nd in (8, 16):
        got = sgm_cost_volume(cv, P1, P2, m, n_directions=nd)
        want = sgm_cost_volume(cv.cpu(), P1, P2, m, n_directions=nd)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        ig, tg = sgm_wta_truncated(cv, P1, P2, m, n_directions=nd,
                                   h_radius=3, v_radius=3)
        ic, tc = sgm_wta_truncated(cv.cpu(), P1, P2, m, n_directions=nd,
                                   h_radius=3, v_radius=3)
        same = ig.cpu() == ic
        assert same.float().mean().item() >= 0.999, nd
        torch.testing.assert_close(tg.cpu()[same], tc[same], rtol=1e-4,
                                   atol=1e-4, equal_nan=True)
        print(f"margins {m} 37x101x13 SGM-{nd}: volume and WTA equal the "
              f"CPU within 1e-4, idx agree {same.float().mean().item():.6f}",
              flush=True)
    # `sgm_cost_volume`'s path (with margins, also `sgm_wta_truncated`'s):
    # K2 a direction a launch into one accumulator, the knight volumes
    margin_launches = {"K2": sgm_pass.launches,
                       "K2k": knight_volumes.launches}
    print(f"margins path SGM-8 and SGM-16: launches {margin_launches}",
          flush=True)
    assert all(n > 0 for n in margin_launches.values()), margin_launches

    # the path glue on a small input: the kernel path against the plain
    # path run on the CPU (f32 volume: a bf16 volume built by two routes
    # may round single entries to neighbouring bf16 values)
    def cuda_vs_cpu(tag, func, H, W, cfg, D):
        Ls, Rs = pair(H, W, 2, dev)
        kw = dict(cfg, disp_width=D, cv_dtype=torch.float32)
        dg, ig, tg = dense_sgm_stereo(func, Ls, Rs, **kw)
        dc, ic, tc = dense_sgm_stereo(func, Ls.cpu(), Rs.cpu(), **kw)
        same = ig.cpu() == ic
        assert same.float().mean().item() >= 0.999, tag
        torch.testing.assert_close(tg.cpu()[same], tc[same], rtol=1e-4,
                                   atol=1e-4, equal_nan=True)
        torch.testing.assert_close(dg.cpu()[same], dc[same], rtol=1e-4,
                                   atol=1e-4, equal_nan=True)
        print(f"path {tag} {H}x{W}x{D} f32: CUDA vs CPU idx agree "
              f"{same.float().mean().item():.6f}", flush=True)

    CENSUS = MatchingFunction.CENSUS
    cuda_vs_cpu("flagship", ZNCC, 64, 96, entry.FLAGSHIP, 24)
    cuda_vs_cpu("SGM-16", ZNCC, 64, 96, entry.SGM16, 24)
    cuda_vs_cpu("census SGM-8", CENSUS, 64, 96, entry.CENSUS_SGM8, 24)
    cuda_vs_cpu("HD settings, D > 256", ZNCC, 24, 330, entry.HD_BF16, 300)
    cuda_vs_cpu("P2 < P1 (plain steps on the card)", ZNCC, 64, 96,
                dict(entry.FLAGSHIP, P1=0.5, P2=0.1), 24)
    cuda_vs_cpu("wide settings, D > 320", ZNCC, 20, 400, entry.WIDE, 330)

    mark("K5 against its plain version")
    # -- K5 against its plain version ----------------------------------------
    NCC, ZSAD = MatchingFunction.NCC, MatchingFunction.ZSAD
    K5_FUNCS = {"dot": MatchingFunction.ZNCC, "ssd": MatchingFunction.SSD,
                "sad": ZSAD}
    err.update(K5=0.0, K6=0.0, K7=0.0)

    def features(func, img):
        """The normalized 7x7 unfold the WTA path aggregates."""
        return normalize_feature_volume(func, unfold(3, 3, img))

    k5_instances = {}

    def check_k5(kernel, src, tgt, shifts, tag):
        k5_instances[tag] = fv_instance(shifts)
        want = fused_fv_cost_volume_plain(kernel, src, tgt, shifts)
        for dt in (torch.float32, torch.bfloat16):
            got = fused_fv_cost_volume(kernel, src, tgt, shifts, dt)
            torch.cuda.synchronize()
            e5 = (got.float() - want).abs()
            if dt == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
                err["K5"] = max(err["K5"], e5.max().item())
            else:
                assert (e5 <= bf16_ulp(want) + 1e-5).all(), tag
            print(f"K5 {tag} {kernel} {str(dt).split('.')[-1]} "
                  f"({k5_instances[tag]} instance): max |kernel - plain| = "
                  f"{e5.max().item():.3g}", flush=True)

    L, R = pair(480, 640, 4, dev)
    rgb4 = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (2, 480, 640, 3)).astype(np.float32)).to(dev)
    for kernel, func in K5_FUNCS.items():
        check_k5(kernel, features(func, R), features(func, L), range(120),
                 "480x640x120 F=49")
        check_k5(kernel, features(func, rgb4[1]), features(func, rgb4[0]),
                 range(120), "480x640x120 F=147 RGB")
    del rgb4
    Lo, Ro = pair(37, 101, 5, dev)
    rgb = np.random.default_rng(6).uniform(0, 1, (2, 37, 101, 3))
    Lc, Rc = torch.from_numpy(rgb.astype(np.float32)).to(dev)
    for kernel, func in K5_FUNCS.items():
        fl, fr = features(func, Lo), features(func, Ro)
        # LEFT_TO_RIGHT: source = left, target = right at j - d
        check_k5(kernel, fl, fr, [-d for d in range(13)],
                 "37x101x13 F=49 left-to-right")
        check_k5(kernel, fr, fl, range(-4, 9), "37x101x13 F=49 offset [-4, 8]")
        check_k5(kernel, features(func, Rc), features(func, Lc), range(13),
                 "37x101x13 F=147 RGB")
        # a list of step 2: the general instance
        check_k5(kernel, fr, fl, range(0, 26, 2), "37x101x13 F=49 step 2")

    mark("K6 and K7 against their plain versions, exactly")
    # -- K6 and K7 against their plain versions, exactly ---------------------
    def state_err(got, want):
        d_eq = torch.equal(got[0], want[0])
        c_eq = torch.equal(got[1], want[1])
        assert d_eq and c_eq, (d_eq, c_eq)
        fin = torch.isfinite(want[1])
        return float(max((got[0] - want[0]).abs().max().item(),
                         (got[1] - want[1])[fin].abs().max().item()))

    costc = cost_oriented_volume(NCC, box_cv(NCC, L, R, 3, 3, 120), 0)
    g = torch.Generator(device=dev).manual_seed(7)
    d0 = torch.randint(0, 120, (480, 640), generator=g, device=dev,
                       dtype=torch.int32)
    inf_cost = torch.full((480, 640), float("inf"), device=dev)
    got, want = (probe(costc, d0, d0, inf_cost, 0),
                 probe_plain(costc, d0, d0, inf_cost, 0))
    err["K7"] = state_err(got, want)
    d1, c1 = got
    cand = torch.randint(-3, 123, (4, 480, 640), generator=g, device=dev,
                         dtype=torch.int32)
    cand[0, ::7] = d1[::7]                          # ties with the current cost
    sel = torch.gather(costc.expand(4, -1, -1, -1), -1,
                       cand.clamp(0, 119).long()[..., None])[..., 0]
    n_oor = ((cand < 0) | (cand > 119)).sum().item()
    n_inf = (torch.isinf(sel) & (cand >= 0) & (cand <= 119)).sum().item()
    assert n_oor > 0 and n_inf > 0, (n_oor, n_inf)
    for K in (1, 4):
        e7 = state_err(probe(costc, cand[:K], d1, c1, 0),
                       probe_plain(costc, cand[:K], d1, c1, 0))
        err["K7"] = max(err["K7"], e7)
    print(f"K7 480x640x120 K=1 (init) and K=1, 4 ({n_oor} out-of-range, "
          f"{n_inf} +inf candidates): equal to plain", flush=True)
    # the random search's probe: the raw draws, scaled in the kernel
    draws = torch.randint(0, 120, (4, 480, 640), generator=g, device=dev,
                          dtype=torch.int32)
    draws[0, ::9] = d1[::9]                   # scaled to the current value
    for K in (1, 4):
        e7 = state_err(search_probe(costc, draws[:K], d1, c1, 0, K),
                       search_probe_plain(costc, draws[:K], d1, c1, 0, K))
        err["K7"] = max(err["K7"], e7)
    print("K7 search probe 480x640x120 K=1, 4 (candidates formed in the "
          "kernel): equal to plain", flush=True)
    for axis in (0, 1):
        for rev in (False, True):
            e6 = state_err(sweep(costc, d1, c1, 0, axis, rev),
                           sweep_plain(costc, d1, c1, 0, axis, rev))
            err["K6"] = max(err["K6"], e6)
    print("K6 480x640x120 sweeps (axis 0, 1; forward, reverse): equal to "
          "plain", flush=True)
    # a flood: one value runs across 2/3 of every line, whose own values
    # all differ: one run of hundreds of lines a chain
    for axis in (0, 1):
        for rev in (False, True):
            fl = k6_flood(480, 640, 120, axis, rev, dev)
            want = sweep_plain(*fl, 0, axis, rev)
            e6 = state_err(sweep(*fl, 0, axis, rev), want)
            err["K6"] = max(err["K6"], e6)
            run = want[0].t() if axis == 1 else want[0]
            run = run.flip(0) if rev else run
            n = 2 * run.shape[0] // 3
            assert bool((run[:n] == run[0]).all()), (axis, rev)
            del fl, want
    print("K6 480x640x120 flood (one run over 2/3 of each line), 4 "
          "directions: equal to plain", flush=True)
    for tag, (cv_e, d_e, c_e, lo) in k6_edges(dev):
        for axis in (0, 1):
            for rev in (False, True):
                e6 = state_err(sweep(cv_e, d_e, c_e, lo, axis, rev),
                               sweep_plain(cv_e, d_e, c_e, lo, axis, rev))
                err["K6"] = max(err["K6"], e6)
    print("K6 edge shapes (one line, two lines, chains not a multiple of "
          "32, lower < 0, +inf and ties, costs not the volume's own), 4 "
          "directions each: equal to plain", flush=True)

    mark("K4a, K4b, K4d against their plain versions")
    # -- K4a, K4b, K4d against their plain versions ---------------------------
    err.update({"K4a": 0.0, "K4b": 0.0, "K4d": 0.0, "K4b stack": 0.0})
    INF = float("inf")
    WH, WW, WD = entry.HEIGHT, entry.WIDTH, entry.WIDE["disp_width"]
    Lw, Rw = pair(WH, WW, 13, dev)
    cvw = box_cv(ZNCC, Lw, Rw, 3, 3, WD, torch.float32, negate=True)

    def shear_args(H, W, neg):
        return (W + H - 1, H - 1, -1) if neg else (W + H - 1, 0, 1)

    for neg in (False, True):
        S = lane.shear(cvw, neg)
        padded = torch.nn.functional.pad(cvw, (0, 0, WH - 1, WH), value=INF)
        assert torch.equal(S, lane.shift_rows_plain(
            padded, *shear_args(WH, WW, neg))), neg
        assert torch.equal(lane.unshear(S, WW, neg), cvw), neg
    del S, padded
    print(f"K4a {WH}x{WW}x{WD} f32: shear and unshear (both signs) equal "
          f"the plain version bitwise and give the volume back", flush=True)

    def k4b_check(cv, tag, col0=0, W_pout=None):
        """Each K4b pass against its plain version, bit for bit, chained as
        `fused_adj` chains them (down, up, forward, reverse or WTA, each on
        the plain version's input); then the separate-accumulation mode,
        which sums in another order, against the alias mode at 1e-4."""
        H, W, D = cv.shape
        kw = dict(col0=col0, W_pout=W + col0 if W_pout is None else W_pout,
                  P1=P1, P2=P2, Pout=POUT)
        acc_p = lane.fused_rows_pass_plain(cv, None, False, True, **kw)
        e = exact(lane.fused_rows_pass(cv, None, False, True, **kw), acc_p,
                  (tag, "down"))
        got = lane.fused_rows_pass(cv, acc_p.clone(), True, True, **kw)
        acc_p = lane.fused_rows_pass_plain(cv, acc_p, True, True, **kw)
        e = max(e, exact(got, acc_p, (tag, "up")))
        got = lane.fused_cols_pass(cv, acc_p.clone(), False, **kw)
        acc_p = lane.fused_cols_pass_plain(cv, acc_p, False, **kw)
        e = max(e, exact(got, acc_p, (tag, "forward")))
        del got
        idx, bands = lane.fused_cols_wta(cv, acc_p, 1, **kw)
        idx_p, bands_p = lane.fused_cols_wta_plain(cv, acc_p, 1, **kw)
        assert torch.equal(idx, idx_p), (tag, "WTA idx")
        e = max(e, exact(bands, bands_p, (tag, "WTA bands")))
        got = lane.fused_cols_pass(cv, acc_p.clone(), True, **kw)
        acc_p = lane.fused_cols_pass_plain(cv, acc_p, True, **kw)
        e = max(e, exact(got, acc_p, (tag, "reverse")))
        del got
        alias = lane.fused_adj(cv, kw["col0"], kw["W_pout"], P1, P2, POUT, 8)
        e = max(e, exact(alias, acc_p, (tag, "fused_adj")))
        del acc_p
        e_sep = close(lane.fused_adj(cv, kw["col0"], kw["W_pout"], P1, P2,
                                     POUT, 8, separate=True), alias)
        err["K4b"] = max(err["K4b"], e)
        print(f"K4b {tag}: down, up, forward, reverse and WTA passes and "
              f"fused_adj equal their plain versions bitwise; the separate "
              f"mode within {e_sep:.3g} of the alias mode", flush=True)

    k4_cases(dev)
    k4b_check(cvw, f"{WH}x{WW}x{WD} f32")
    # 16 directions: the knight volumes as the stack the WTA scan sums (the
    # lane route's form where they fit) against the 8 in-place adds
    for a, b in zip(lane.fused_adj(cvw, 0, WW, P1, P2, POUT, 16,
                                   wta_radius=1, one_launch=True),
                    lane.fused_adj(cvw, 0, WW, P1, P2, POUT, 16,
                                   wta_radius=1, one_launch=False)):
        exact(a, b, "K4b WTA over the knight stack vs in-place adds")
    print(f"K4b {WH}x{WW}x{WD} f32, 16 directions: the WTA scan over the 8 "
          f"knight volumes equals the 8 in-place adds and the scan bitwise",
          flush=True)
    Lo, Ro = pair(37, 101, 15, dev)
    k4b_check(box_cv(ZNCC, Lo, Ro, 3, 3, 333, torch.float32, negate=True),
              "37x101x333 f32, col0 2, W_pout 106", col0=2, W_pout=106)

    # K4d: each of `chunked_adj`'s four sweep kinds in one launch, writing
    # and adding, with the card's chunk width (3 columns, 100 chunks) and
    # with 2 columns (150 chunks, more than the SMs: the ticket order),
    # bitwise against the sweep-level plain version at the widest chunk,
    # twice; then the whole `chunked_adj` (cw 32: 4 launches) against the
    # plain direction sum
    Lo, Ro = pair(40, 300, 16, dev)
    cvo = box_cv(ZNCC, Lo, Ro, 3, 3, 352, torch.float32, negate=True)
    acc_o = torch.rand(cvo.shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(17))
    cws = (lane.chunk_width(352, 8, 300, n_sms), 2)
    for kind, k4d_sweep in lane.chunk_sweeps(40, 300, 8).items():
        for accumulate in (False, True):
            kw = dict(col0=0, W_pout=300, P1=P1, P2=P2, Pout=POUT,
                      accumulate=accumulate, **k4d_sweep)
            want = lane.chunked_sweep_plain(cvo, acc_o.clone(), cw=300, **kw)
            for cw in cws + cws:
                got = lane.chunked_sweep(cvo, acc_o.clone(), cw=cw, **kw)
                err["K4d"] = max(err["K4d"], exact(got, want,
                                                   (kind, accumulate, cw)))
    del got, want, acc_o
    before = lane.chunked_sweep.launches
    e4d = close(lane.chunked_adj(cvo, 0, 300, P1, P2, POUT, 8, cw=32),
                _grouped_adj(cvo, P1, P2, POUT, 8, 0, 300))
    assert lane.chunked_sweep.launches == before + 4
    print(f"K4d 40x300x352 f32: the four sweep kinds, writing and adding, "
          f"at {cws[0]} columns a chunk ({-(-300 // cws[0])} chunks) and at "
          f"2 (150 chunks, more than the {n_sms} SMs), one launch each, "
          f"equal their plain version bitwise, twice; chunked_adj (cw 32, "
          f"4 launches) within {e4d:.3g} of the plain direction sum (the "
          f"XLA grouping)", flush=True)

    # the lane kernels past a block's shared memory, their carries in
    # global memory (the lane route takes any D, as the JAX package's XLA
    # path does): at D = 29000 K4d's four sweeps (one column a chunk), K4b's
    # forward and WTA column scans and K2k's 8 knights, each against its
    # plain version bitwise
    DS = 29000
    gs = torch.Generator(device=dev).manual_seed(18)
    cvs = torch.rand((6, 40, DS), device=dev, generator=gs) * 3
    acc_s = torch.rand(cvs.shape, device=dev, generator=gs)
    cws = lane.chunk_width(DS, 8, 40, n_sms)
    assert lane.chunk_layout(DS, cws, True, True).spill
    assert lane.cols_spills(DS, False) and lane.cols_spills(DS, True)
    assert not ring_fits(DS)
    err["K4d"] = max(err["K4d"], exact(
        k4d_four_sweeps(cvs, torch.empty_like(cvs), cws),
        k4d_four_sweeps(cvs, torch.empty_like(cvs), 40, plain=True),
        "K4d global carries"))
    kw = dict(col0=0, W_pout=40, P1=P1, P2=P2, Pout=POUT)
    err["K4b"] = max(err["K4b"], exact(
        lane.fused_cols_pass(cvs, acc_s.clone(), False, **kw),
        lane.fused_cols_pass_plain(cvs, acc_s.clone(), False, **kw),
        "K4b forward scan, global carries"))
    i_s, b_s = lane.fused_cols_wta(cvs, acc_s, 1, **kw)
    i_p, b_p = lane.fused_cols_wta_plain(cvs, acc_s, 1, **kw)
    assert torch.equal(i_s, i_p), "K4b WTA scan idx, global carries"
    err["K4b"] = max(err["K4b"], exact(b_s, b_p, "K4b WTA bands, global"))
    err["K2k any-D"] = exact(
        knight_volumes(cvs, _KNIGHT_DIRS, P1, P2, POUT),
        knight_volumes_plain(cvs, _KNIGHT_DIRS, P1, P2, POUT),
        "K2k knights, global carries")
    del cvs, acc_s, i_s, b_s, i_p, b_p
    print(f"lane kernels at 6x40x{DS} f32, their carries in global memory "
          f"(past a block's shared memory): K4d's four sweeps ({cws} column "
          f"a chunk), K4b's forward and WTA column scans and K2k's 8 knight "
          f"volumes equal their plain versions bitwise", flush=True)

    mark("the main path: three full-size pairs")
    # -- the main path: three full-size pairs --------------------------------
    pairs = {}
    for name, (suffix, _, _) in BARS.items():
        imgs = [torch.from_numpy(read_stevimg(
            str(FIXTURES / f"{side}{suffix}.stevimg"))).to(dev)
            for side in ("left", "right")]
        gt = read_stevimg(str(FIXTURES / f"gt{suffix}.stevimg"))
        pairs[name] = (imgs, gt)
    _, (Lr, Rr) = entry.entry(dev)
    pairs["random"] = ([Lr, Rr], None)
    K2K_COUNTERS = (window_stats, box_cv, sgm_pass, direction_volumes,
                    knight_volumes, sgm_wta)

    def reset(*fns):
        for fn in fns:
            fn.launches = 0
        torch.cuda.synchronize()

    reset(*K2K_COUNTERS)
    t0 = time.perf_counter()
    out = {name: dense_sgm_stereo(ZNCC, *imgs, **entry.FLAGSHIP)
           for name, (imgs, _) in pairs.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1 stats": window_stats.launches, "K1": box_cv.launches,
                "K2x7": direction_volumes.launches, "K3x7": sgm_wta.launches}
    print(f"main path: 3 pairs in {wall:.3f} s host wall (first calls), "
          f"launches {launches}, K2 one direction {sgm_pass.launches}",
          flush=True)
    # the flagship takes the one-launch form (its 7 volumes, 1.03 GB, fit)
    assert all(n > 0 for n in launches.values()), launches
    for name, (disp, idx, tcv) in out.items():
        assert disp.shape == idx.shape == (480, 640)
        assert disp.dtype == torch.float32 and tcv.shape == (480, 640, 3)
        if name == "random":
            check_random("random", disp, idx, 120)
        else:
            check_bars(name, disp, pairs[name][1], BARS[name][1:])

    mark("the SGM-16 path: both fixtures and the random pair")
    # -- the SGM-16 path: both fixtures and the random pair -------------------
    reset(*K2K_COUNTERS, fused_fv_cost_volume)
    t0 = time.perf_counter()
    out16 = {name: dense_sgm_stereo(ZNCC, *imgs, **entry.SGM16)
             for name, (imgs, _) in pairs.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches16 = {"K1": box_cv.launches, "K2x7": direction_volumes.launches,
                  "K2k": knight_volumes.launches, "K3": sgm_wta.launches}
    print(f"SGM-16 path: 3 pairs in {wall:.3f} s host wall (first calls), "
          f"launches {launches16}, K2 one direction {sgm_pass.launches}, K5 "
          f"{fused_fv_cost_volume.launches}", flush=True)
    assert all(n > 0 for n in launches16.values()), launches16
    for name, (disp, idx, tcv) in out16.items():
        assert disp.shape == idx.shape == (480, 640)
        assert disp.dtype == torch.float32 and tcv.shape == (480, 640, 3)
        if name == "random":
            check_random("random", disp, idx, 120)
        else:
            check_bars(name, disp, pairs[name][1], SGM16_BARS[name])
    # the bf16 rule: a bf16 request with 16 directions runs an f32 volume
    d16 = dense_sgm_stereo(ZNCC, *pairs["warp"][0],
                           **dict(entry.SGM16, cv_dtype=torch.bfloat16))
    for a, b in zip(d16, out16["warp"]):
        assert torch.equal(torch.nan_to_num(a, 9.0), torch.nan_to_num(b, 9.0))
    print("  warp, cv_dtype=bfloat16: equal to the float32 result", flush=True)

    mark("census + SGM-8: both fixtures")
    # -- census + SGM-8: both fixtures ---------------------------------------
    reset(*K2K_COUNTERS, fused_fv_cost_volume)
    t0 = time.perf_counter()
    out_cs = {name: entry.census_sgm_forward(*pairs[name][0])
              for name in CENSUS_BARS}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cs_launches = {"K1": box_cv.launches, "K2": sgm_pass.launches,
                   "K2x7": direction_volumes.launches,
                   "K2k": knight_volumes.launches, "K3": sgm_wta.launches,
                   "K5": fused_fv_cost_volume.launches}
    print(f"census SGM-8 path: 2 pairs in {wall:.3f} s host wall, launches "
          f"{cs_launches} (the census volume runs on the shifted-compare "
          f"loop)", flush=True)
    assert cs_launches["K2x7"] > 0 and cs_launches["K3"] > 0, cs_launches
    for name, disp in out_cs.items():
        assert disp.shape == (480, 640) and disp.dtype == torch.float32
        check_bars(name, disp, pairs[name][1], CENSUS_BARS[name])

    mark("HD 720x1280, D=320, bf16, SGM-8: a random pair")
    # -- HD 720x1280, D=320, bf16, SGM-8: a random pair ----------------------
    Lh, Rh = pair(entry.HD_HEIGHT, entry.HD_WIDTH, 12, dev)
    reset(*K2K_COUNTERS)
    t0 = time.perf_counter()
    dh, ih, th = dense_sgm_stereo(ZNCC, Lh, Rh, **entry.HD_BF16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hd_launches = {"K1": box_cv.launches, "K2x7": direction_volumes.launches,
                   "K3": sgm_wta.launches}
    print(f"HD path 720x1280x320 bf16: {wall:.3f} s host wall (first call), "
          f"launches {hd_launches}, K2 one direction {sgm_pass.launches}",
          flush=True)
    assert all(n > 0 for n in hd_launches.values()), hd_launches
    assert dh.shape == (720, 1280) and th.shape == (720, 1280, 3)
    check_random("HD random", dh, ih, 320)

    mark("the wide path: 480x640, D=384, f32, SGM-8 (K1 x2, K4b)")
    # -- the wide path: 480x640, D=384, f32, SGM-8 (K1 x2, K4b) --------------
    LANE_K4B = (lane.fused_rows_pass, lane.fused_cols_pass,
                lane.fused_cols_wta)
    LANE = LANE_K4B + (lane.chunked_sweep, lane.shift_rows)

    def lane_launches():
        return {"K1": box_cv.launches, "K4a": lane.shift_rows.launches,
                "K4b": sum(fn.launches for fn in LANE_K4B),
                "K4d": lane.chunked_sweep.launches,
                "K2": sgm_pass.launches, "K3": sgm_wta.launches}

    def wide_plain(cv, r=1):
        """The plain route of the wide path on the card: K4b's plain
        passes, chained as `fused_adj` chains its kernels."""
        H, W, _ = cv.shape
        kw = dict(col0=0, W_pout=W, P1=P1, P2=P2, Pout=POUT)
        adj = lane.fused_rows_pass_plain(cv, None, False, True, **kw)
        adj = lane.fused_rows_pass_plain(cv, adj, True, True, **kw)
        adj = lane.fused_cols_pass_plain(cv, adj, False, **kw)
        return lane.fused_cols_wta_plain(cv, adj, r, **kw), adj

    reset(box_cv, *LANE, *K2K_COUNTERS)
    t0 = time.perf_counter()
    out_w = {name: dense_sgm_stereo(ZNCC, *imgs, **entry.WIDE)
             for name, (imgs, _) in pairs.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wide_launches = lane_launches()
    print(f"wide path 480x640x{WD} f32: 3 pairs in {wall:.3f} s host wall "
          f"(first calls), launches {wide_launches}", flush=True)
    assert wide_launches["K1"] > 0 and wide_launches["K4b"] > 0, wide_launches
    for name, (disp, idx, tcv) in out_w.items():
        assert disp.shape == idx.shape == (WH, WW)
        assert disp.dtype == torch.float32 and tcv.shape == (WH, WW, 3)
        # the plain SGM route on K1's volume (K1 is held to its plain
        # version above; on the fixtures' flat windows the two volumes
        # differ by up to ~7e-3, the ZNCC normalization amplifying
        # rounding, which moves idx where costs nearly tie)
        cvk = box_cv(ZNCC, *pairs[name][0], 3, 3, WD, torch.float32,
                     negate=True)
        (idx_p, _), adj_p = wide_plain(cvk)
        adj_p = lane.fused_cols_pass_plain(cvk, adj_p, True, col0=0,
                                           W_pout=WW, P1=P1, P2=P2,
                                           Pout=POUT)
        two = torch.topk(cvk + adj_p, 2, dim=-1, largest=False).values
        clear = (two[..., 1] - two[..., 0]) > 1e-4
        agree = (idx == idx_p).float().mean().item()
        assert torch.equal(idx[clear], idx_p[clear]) and agree >= 0.999, name
        (idx_pp, _), _ = wide_plain(box_cv_plain(
            ZNCC, *pairs[name][0], 3, 3, WD, torch.float32, negate=True))
        agree_pp = (idx == idx_pp).float().mean().item()
        assert agree_pp >= 0.999, (name, agree_pp)
        del cvk, adj_p
        if name == "random":
            check_random("wide random", disp, idx, WD)
        else:
            d = disp.cpu().numpy()
            gt = pairs[name][1]
            print(f"  {name}: prop_good_2.0 = {prop_good(d, gt, 2.0):.4f}, "
                  f"inlier_mae = {inlier_mae(d, gt, 2.0):.4f} (no bar)",
                  flush=True)
        print(f"  {name}: idx agree with the plain route on the card "
              f"{agree:.6f} on K1's volume (equal off near-ties), "
              f"{agree_pp:.6f} with plain K1", flush=True)

    mark("HD wide: 720x1280, D=640, f32, SGM-8 (K1 x2, K4b)")
    # -- HD wide: 720x1280, D=640, f32, SGM-8 (K1 x2, K4b) -------------------
    HH, HW, HD = entry.HD_HEIGHT, entry.HD_WIDTH, entry.HD_WIDE["disp_width"]
    reset(box_cv, *LANE, *K2K_COUNTERS)
    t0 = time.perf_counter()
    dhw, ihw, thw = dense_sgm_stereo(ZNCC, Lh, Rh, **entry.HD_WIDE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hdw_launches = lane_launches()
    print(f"HD wide path {HH}x{HW}x{HD} f32: {wall:.3f} s host wall (first "
          f"call), launches {hdw_launches}", flush=True)
    assert hdw_launches["K1"] > 0 and hdw_launches["K4b"] > 0, hdw_launches
    assert dhw.shape == (HH, HW) and thw.shape == (HH, HW, 3)
    check_random("HD wide random", dhw, ihw, HD)
    del dhw, ihw, thw
    # K4b at this path's shape: 10 columns a block and 155 KiB of shared
    # memory (the opt-in attribute past 48 KiB), on this pair's volume
    k1_exact(Lh, Rh, HD, (torch.float32,), f"{HH}x{HW}x{HD}")
    cv_hd = box_cv(ZNCC, Lh, Rh, 3, 3, HD, torch.float32, negate=True)
    k4b_check(cv_hd, f"{HH}x{HW}x{HD} f32")

    mark("K4d at full size: chunked_adj on the HD D=640 volume")
    # -- K4d at full size: chunked_adj on the HD D=640 volume ----------------
    # K4b's carries fit on chip at this size, so no public entry takes K4d
    # here on an H100; `chunked_adj` is called directly, as the JAX tests call
    # `sgm_chunked_adj`
    reset(box_cv, *LANE, *K2K_COUNTERS)
    t0 = time.perf_counter()
    adj_hd = lane.chunked_adj(cv_hd, 0, HW, P1, P2, POUT, 8)
    C = cv_hd + adj_hd
    idx_hd, bands_hd = wta_bands(C, 1)
    _, tcv_hd = _tcv_from_bands(idx_hd, bands_hd, HH, HW, HD, 3, 3, 1)
    disp_hd = refine_disp_cost_interpolation(InterpolationKernel.PARABOLA,
                                             tcv_hd, idx_hd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4d_launches = lane_launches()
    cw_hd = lane.chunk_width(HD, 8, HW, n_sms)
    print(f"K4d path {HH}x{HW}x{HD} f32 (chunk width {cw_hd}, "
          f"{-(-HW // cw_hd)} chunks): {wall:.3f} s host wall (first call), "
          f"launches {k4d_launches}", flush=True)
    # one launch a sweep (the chunks in series took 236)
    assert k4d_launches["K4d"] == 4, k4d_launches
    check_random("K4d HD random", disp_hd, idx_hd, HD)
    # the route ending in K4b's WTA scan (`sgm_wta_truncated`'s form)
    # against the chain's tie-last argmin on cv + adj, off near-ties
    two = torch.topk(C, 2, dim=-1, largest=False).values
    clear = (two[..., 1] - two[..., 0]) > 1e-4
    del C, two, tcv_hd, disp_hd
    idx_w, bands_w = lane.chunked_adj(cv_hd, 0, HW, P1, P2, POUT, 8,
                                      wta_radius=1)
    same = idx_w == idx_hd
    assert torch.equal(idx_w[clear], idx_hd[clear])
    agree = same.float().mean().item()
    assert agree >= 0.999, agree
    fin = same[..., None] & torch.isfinite(bands_hd)
    e_wta = close(bands_w[fin], bands_hd[fin])
    print(f"  K4d route with the WTA scan: idx equal to the chain's off "
          f"near-ties, agree {agree:.6f}, bands within {e_wta:.3g}",
          flush=True)
    del bands_hd, idx_hd, idx_w, bands_w, same, clear, fin
    # both lane routes against the plain direction sum (the XLA grouping,
    # another sum order) on the card
    ref_hd = _grouped_adj(cv_hd, P1, P2, POUT, 8, 0, HW)
    e_hd = close(adj_hd, ref_hd)
    del adj_hd
    e_hb = close(lane.fused_adj(cv_hd, 0, HW, P1, P2, POUT, 8), ref_hd)
    del ref_hd
    print(f"  at {HH}x{HW}x{HD} against the plain direction sum on the card: "
          f"chunked_adj (K4d) within {e_hd:.3g}, fused_adj (K4b) within "
          f"{e_hb:.3g}", flush=True)

    mark("route cross-check at the flagship geometry (D=120, f32)")
    # -- route cross-check at the flagship geometry (D=120, f32) -------------
    for name in F32_BARS:
        imgs, gt = pairs[name]
        cvf = box_cv(ZNCC, *imgs, 3, 3, 120, torch.float32, negate=True)
        ref = sgm_accumulate(cvf, directions_for(8), P1, P2, POUT)
        idx_k, bands_k, _ = sgm_wta_fused(cvf, P1, P2, POUT, 8, 1, 3, 3,
                                          False)
        two = torch.topk(cvf + ref, 2, dim=-1, largest=False).values
        clear = (two[..., 1] - two[..., 0]) > 1e-4
        e_f = close(lane.fused_adj(cvf, 0, 640, P1, P2, POUT, 8), ref)
        e_c = close(lane.chunked_adj(cvf, 0, 640, P1, P2, POUT, 8, cw=64),
                    ref)
        routes = {"K4b": lane.fused_adj(cvf, 0, 640, P1, P2, POUT, 8,
                                        wta_radius=1),
                  "K4d": lane.chunked_adj(cvf, 0, 640, P1, P2, POUT, 8,
                                          cw=64, wta_radius=1)}
        for route, (idx_r, bands_r) in routes.items():
            agree = (idx_r == idx_k).float().mean().item()
            assert torch.equal(idx_r[clear], idx_k[clear]), (name, route)
            assert agree >= 0.999, (name, route, agree)
            idx_r, tcv_r = _tcv_from_bands(idx_r, bands_r, 480, 640, 120, 3,
                                           3, 1)
            disp_r = refine_disp_cost_interpolation(
                InterpolationKernel.PARABOLA, tcv_r, idx_r)
            print(f"route {route} on {name} (D=120 f32): adj within "
                  f"{e_f if route == 'K4b' else e_c:.3g} of K2's sum, idx "
                  f"agree with K2/K3 {agree:.6f}", flush=True)
            check_bars(f"{name} via {route}", disp_r, gt, F32_BARS[name])

    mark("4K UHD: 2160x3840, D=384, f32, SGM-8 (K1, K4d, K4b's scans)")
    # -- 4K UHD: 2160x3840, D=384, f32, SGM-8 (K1, K4d, K4b's scans) -------
    # K4b's carries do not fit on chip at this width (`fused_fits`), so the
    # entry runs K1 (one launch), K4d's four one-launch sweeps and K4b's two
    # column scans, the last one fused with the WTA
    from libstevi_tpu_torch.profile_frames import profile_frame
    UH, UW = entry.UHD_HEIGHT, entry.UHD_WIDTH
    assert not lane.fused_fits(UW, WD, 8, n_sm=n_sms)
    L4, R4 = pair(UH, UW, 25, dev)
    reset(box_cv, *LANE, *K2K_COUNTERS)
    t0 = time.perf_counter()
    d4 = entry.uhd_wide_forward(L4, R4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    uhd_launches = dict(lane_launches(),
                        rows=lane.fused_rows_pass.launches,
                        cols=lane.fused_cols_pass.launches,
                        wta=lane.fused_cols_wta.launches)
    cw4 = lane.chunk_width(WD, 8, UW, n_sms)
    print(f"4K UHD path {UH}x{UW}x{WD} f32 (entry.uhd_wide_forward; K4d "
          f"chunk width {cw4}, {-(-UW // cw4)} chunks): {wall:.3f} s host "
          f"wall (first call), launches {uhd_launches}", flush=True)
    assert (uhd_launches["K1"], uhd_launches["K4d"], uhd_launches["rows"],
            uhd_launches["cols"], uhd_launches["wta"]) == (1, 4, 0, 1, 1), \
        uhd_launches
    assert d4.shape == (UH, UW) and d4.dtype == torch.float32
    _, i4, t4 = dense_sgm_stereo(ZNCC, L4, R4, **entry.WIDE)
    assert torch.equal(torch.nan_to_num(d4, 9.0), torch.nan_to_num(
        refine_disp_cost_interpolation(InterpolationKernel.PARABOLA, t4, i4),
        9.0))
    check_random("4K UHD random", d4, i4, WD)
    del d4, t4
    uhd = lambda: entry.uhd_wide_forward(L4, R4)  # noqa: E731
    uhd_ms = median_ms(uhd)
    uhd_peak = peak_bytes(uhd)
    busy, items = profile_frame(uhd, 3)
    top = sorted(items.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"time: 4K UHD frame {UH}x{UW} D={WD} f32 SGM-8 (K1, K4d, K4b's "
          f"scans): {uhd_ms:.3f} ms (median of 5 after a warm-up; {smi}); "
          f"memory: peak {uhd_peak / 1e9:.3f} GB above the inputs; profile "
          f"(3 frames): device busy {busy / 1e3:.3f} ms a frame, idle "
          f"{1 - busy / 1e3 / uhd_ms:.3f}, top items (name, us a frame, "
          f"launches a frame) {[[n, round(u, 1), round(k, 1)] for n, (u, k) in top]}",
          flush=True)
    # K4d at the main path's shape: its four sweeps on this pair's volume,
    # kernel against the sweep-level plain version (one chunk of the whole
    # width: the same bits), bitwise; then timed in turns (plain, kernel,
    # kernel, plain; the plain version once a turn, ~2 s)
    cv4 = box_cv(ZNCC, L4, R4, 3, 3, WD, torch.float32, negate=True)
    adj4 = k4d_four_sweeps(cv4, torch.empty_like(cv4), cw4)
    err["K4d"] = max(err["K4d"], exact(
        adj4, k4d_four_sweeps(cv4, torch.empty_like(cv4), UW, plain=True),
        "K4d 4K sweeps"))
    p1_ = median_ms(lambda: k4d_four_sweeps(cv4, adj4, UW, plain=True), 1, 0)
    k1_, k2_ = (median_ms(lambda: k4d_four_sweeps(cv4, adj4, cw4))
                for _ in range(2))
    p2_ = median_ms(lambda: k4d_four_sweeps(cv4, adj4, UW, plain=True), 1, 0)
    k4d_ms = ((k1_ + k2_) / 2, (p1_ + p2_) / 2)
    print(f"K4d {UH}x{UW}x{WD} f32: the four sweeps (4 launches, {cw4} "
          f"columns a chunk) equal the plain version bitwise; time: kernel "
          f"{k4d_ms[0]:.3f} ms vs plain {k4d_ms[1]:.3f} ms (kernel median "
          f"of 5, plain 1, twice each; {smi})", flush=True)
    # K4b's column scans at the main path's shape, on the K4d sums: the
    # forward scan and the WTA scan (the path's two), then the reverse
    # scan, each against its plain version bit for bit
    kw = dict(col0=0, W_pout=UW, P1=P1, P2=P2, Pout=POUT)
    got = lane.fused_cols_pass(cv4, adj4.clone(), False, **kw)
    adj4 = lane.fused_cols_pass_plain(cv4, adj4, False, **kw)
    err["K4b"] = max(err["K4b"], exact(got, adj4, "K4b 4K forward scan"))
    del got
    i_k, b_k = lane.fused_cols_wta(cv4, adj4, 1, **kw)
    i_p, b_p = lane.fused_cols_wta_plain(cv4, adj4, 1, **kw)
    assert torch.equal(i_k, i_p), "K4b 4K WTA idx"
    err["K4b"] = max(err["K4b"], exact(b_k, b_p, "K4b 4K WTA bands"))
    del i_k, b_k, i_p, b_p
    got = lane.fused_cols_pass(cv4, adj4.clone(), True, **kw)
    adj4 = lane.fused_cols_pass_plain(cv4, adj4, True, **kw)
    err["K4b"] = max(err["K4b"], exact(got, adj4, "K4b 4K reverse scan"))
    del got, cv4, adj4
    print(f"K4b {UH}x{UW}x{WD} f32: the forward, WTA and reverse column "
          f"scans on the K4d sums equal their plain versions bitwise",
          flush=True)
    # K1 at the main path's shape: statistics and volume, bit for bit
    k1_exact(L4, R4, WD, (torch.float32,), f"{UH}x{UW}x{WD}")
    del uhd
    torch.cuda.empty_cache()
    mark("the distributed 4K UHD step (K1 and the K2s engine's any-D K2)")
    # -- the distributed 4K UHD step (K1 and the K2s engine's any-D K2) -----
    k2_uhd_launches, e = distributed_uhd(dev, L4, R4, i4, smi)
    err["K2 any-D"] = max(err.get("K2 any-D", 0.0), e)
    del L4, R4, i4
    torch.cuda.empty_cache()

    mark("the CLI, as a subprocess, SGM-16 on the warp fixture")
    # -- the CLI, as a subprocess, SGM-16 on the warp fixture ----------------
    with tempfile.TemporaryDirectory() as tmp:
        out_path = str(Path(tmp) / "disp16.stevimg")
        res = subprocess.run(
            [sys.executable, "-m", "libstevi_tpu_torch.cli.stereo_match",
             str(FIXTURES / "left.stevimg"), str(FIXTURES / "right.stevimg"),
             "-o", out_path, "-d", "120", "--matcher", "sgm", "--sgm-dirs",
             "16", "--refine", "parabola", "--gt",
             str(FIXTURES / "gt.stevimg")],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        report = json.loads(res.stdout.strip().splitlines()[-1])
        disp_cli = read_stevimg(out_path)
    print(f"CLI: {json.dumps(report)}", flush=True)
    assert disp_cli.shape == (480, 640)
    pg_bar, mae_bar = SGM16_BARS["warp"]
    assert report["prop_good_2.0"] >= pg_bar, report
    assert report["inlier_mae"] <= mae_bar, report
    # ... and SGM-8 at D=384 (K4b)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = str(Path(tmp) / "disp384.stevimg")
        res = subprocess.run(
            [sys.executable, "-m", "libstevi_tpu_torch.cli.stereo_match",
             str(FIXTURES / "left.stevimg"), str(FIXTURES / "right.stevimg"),
             "-o", out_path, "-d", str(WD), "--matcher", "sgm",
             "--refine", "parabola", "--gt", str(FIXTURES / "gt.stevimg")],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        report = json.loads(res.stdout.strip().splitlines()[-1])
        assert read_stevimg(out_path).shape == (480, 640)
    print(f"CLI -d {WD}: {json.dumps(report)}", flush=True)
    assert report["disp_width"] == WD, report

    mark("the PatchMatch path: both fixtures")
    # -- the PatchMatch path: both fixtures -----------------------------------
    # a small run against the plain route on the CPU: one volume, one
    # replayed candidate stream, equal disparities
    Ls, Rs = pair(64, 96, 8, dev)
    cv_s = box_cv(NCC, Ls, Rs, 3, 3, 24)

    def pm_small(vol, device):
        rng = np.random.default_rng(9)

        def draw(shape, lo, hi):
            return torch.from_numpy(rng.integers(lo, hi, shape).astype(
                np.int32)).to(device)
        return _patch_match_stereo_cv(NCC, None, None, SearchOffset1(0, 23),
                                      5, 4, cv=vol, draw=draw)

    assert torch.equal(pm_small(cv_s, dev).cpu(), pm_small(cv_s.cpu(), "cpu"))
    print("PatchMatch 64x96x24: CUDA equals CPU with one replayed candidate "
          "stream", flush=True)

    box_cv.launches = sweep.launches = probe.launches = 0
    fused_fv_cost_volume.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_pm = {name: entry.patchmatch_forward(
        *pairs[name][0], torch.Generator(device=dev).manual_seed(0))
        for name in PM_BARS}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update(K6=sweep.launches, K7=probe.launches)
    pm_k1 = box_cv.launches
    print(f"PatchMatch path: 2 pairs in {wall:.3f} s host wall, launches "
          f"K1 {pm_k1}, K5 {fused_fv_cost_volume.launches}, K6 "
          f"{launches['K6']}, K7 {launches['K7']}", flush=True)
    assert pm_k1 > 0 and launches["K6"] > 0 and launches["K7"] > 0
    for name, disp in out_pm.items():
        assert disp.shape == (480, 640) and disp.dtype == torch.int32
        assert 0 <= disp.min().item() and disp.max().item() <= 119
        check_bars(name, disp.float(), pairs[name][1], PM_BARS[name])

    mark("aggregate_cost 'auto' past K5's tile: ZSAD r = 5 (F = 121), D = 448")
    # -- aggregate_cost 'auto' past K5's tile: ZSAD r = 5 (F = 121), D = 448 --
    # K5's block would need 249,600 bytes of shared memory, so 'auto' takes
    # the shifted-compare loop on the card (no K5 launch), as JAX's 'auto'
    # falls back past its VMEM budget; against the CPU
    Lz, Rz = pair(24, 470, 19, dev)
    k5_before = fused_fv_cost_volume.launches
    cv_z = unfold_based_cost_volume(ZSAD, Lz, Rz, 5, 5, 448)
    assert fused_fv_cost_volume.launches == k5_before
    e_z = close(cv_z.cpu(), unfold_based_cost_volume(ZSAD, Lz.cpu(), Rz.cpu(),
                                                     5, 5, 448), 1e-5)
    print(f"aggregate_cost 'auto' ZSAD r=5 (F=121) D=448 24x470: the "
          f"shifted-compare loop on the card, within {e_z:.3g} of the CPU",
          flush=True)
    del cv_z

    mark("the WTA path with ZSAD: both fixtures")
    # -- the WTA path with ZSAD: both fixtures --------------------------------
    # small, against the plain route on the CPU: volumes within float
    # tolerance, indices equal away from near-ties
    Lw, Rw = pair(48, 160, 10, dev)
    cv_g = unfold_based_cost_volume(ZSAD, Lw, Rw, **entry.WTA)
    cv_c = unfold_based_cost_volume(ZSAD, Lw.cpu(), Rw.cpu(), **entry.WTA)
    torch.testing.assert_close(cv_g.cpu(), cv_c, rtol=1e-5, atol=1e-5)
    two = torch.topk(cv_c, 2, dim=-1, largest=False).values
    clear = (two[..., 1] - two[..., 0]) > 1e-4
    idx_g = entry.wta_forward(ZSAD, Lw, Rw).cpu()
    idx_c = entry.wta_forward(ZSAD, Lw.cpu(), Rw.cpu())
    assert torch.equal(idx_g[clear], idx_c[clear])
    print(f"WTA ZSAD 48x160x120: CUDA vs CPU idx agree "
          f"{(idx_g == idx_c).float().mean().item():.6f}, equal on the "
          f"{clear.float().mean().item():.4f} clear of near-ties", flush=True)

    box_cv.launches = sweep.launches = probe.launches = 0
    fused_fv_cost_volume.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_wta = {name: entry.wta_forward(ZSAD, *pairs[name][0])
               for name in PM_BARS}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["K5"] = fused_fv_cost_volume.launches
    print(f"WTA ZSAD path: 2 pairs in {wall:.3f} s host wall, launches K5 "
          f"{launches['K5']}, K1 {box_cv.launches}", flush=True)
    assert launches["K5"] > 0
    for name, idx in out_wta.items():
        assert idx.shape == (480, 640) and idx.dtype == torch.int32
        d = idx.cpu().numpy().astype(np.float32)
        gt = pairs[name][1]
        print(f"  {name}: prop_good_2.0 = {prop_good(d, gt, 2.0):.4f}, "
              f"inlier_mae = {inlier_mae(d, gt, 2.0):.4f} (no bar)",
              flush=True)

    mark("timing (CUDA events, median of 5, flagship shape)")
    # -- timing (CUDA events, median of 5, flagship shape) -------------------
    L, R = pair(480, 640, 3, dev)
    frame_ms = median_ms(lambda: entry.flagship_forward(L, R))
    print(f"time: flagship frame 480x640 D=120 bf16: {frame_ms:.3f} ms "
          f"(median of 5; {smi})", flush=True)
    frames = {
        "SGM-16 frame 480x640 D=120 f32": lambda: entry.sgm16_forward(L, R),
        "census SGM-8 frame 480x640 D=120": (
            lambda: entry.census_sgm_forward(L, R)),
        "HD frame 720x1280 D=320 bf16 SGM-8": lambda: entry.hd_forward(Lh, Rh),
        f"wide frame 480x640 D={WD} f32 SGM-8 (K4b)": (
            lambda: entry.wide_forward(L, R)),
        f"HD wide frame {HH}x{HW} D={HD} f32 SGM-8 (K4b)": (
            lambda: entry.hd_wide_forward(Lh, Rh)),
        f"K4d route {HH}x{HW} D={HD}: chunked_adj alone": (
            lambda: lane.chunked_adj(cv_hd, 0, HW, P1, P2, POUT, 8)),
    }
    frame_times = {}
    for name, fn in frames.items():
        frame_times[name] = median_ms(fn)
        print(f"time: {name}: {frame_times[name]:.3f} ms (median of 5; "
              f"{smi})", flush=True)
    # peak device memory a frame, above what was allocated before it
    for name, fn in (("flagship", lambda: entry.flagship_forward(L, R)),
                     ("HD D=320 bf16", lambda: entry.hd_forward(Lh, Rh))):
        print(f"memory: {name} frame peak {peak_bytes(fn) / 1e9:.3f} GB "
              f"above the inputs ({smi})", flush=True)
    k2_forms(dev, k2_dirs, smi)

    cv = box_cv(ZNCC, L, R, 3, 3, 120, torch.bfloat16, negate=True)
    stack = direction_volumes(cv, k2_dirs, P1, P2, POUT)
    seq = sgm_accumulate(cv, k2_dirs, P1, P2, POUT)
    stack_p, acc_p = torch.empty_like(stack), torch.empty_like(seq)

    def k2_plain():                     # 7 directions into one accumulator
        for k, d in enumerate(k2_dirs):
            sgm_pass_plain(cv, acc_p, d, P1, P2, POUT, accumulate=k > 0)

    def k2x7_plain():                   # 7 directions, a volume each
        for d, a in zip(k2_dirs, stack_p):
            sgm_pass_plain(cv, a, d, P1, P2, POUT, accumulate=False)

    # SGM-16's volume (f32) and its one-launch stack: the 7 K2 volumes,
    # then the 8 knight volumes K2k writes
    cv32 = box_cv(ZNCC, L, R, 3, 3, 120, torch.float32, negate=True)
    stack15 = torch.empty((15,) + tuple(cv32.shape), device=dev)
    direction_volumes(cv32, k2_dirs, P1, P2, POUT, out=stack15[:7])
    knight_volumes(cv32, KD, P1, P2, POUT, out=stack15[7:])
    acc_k = torch.zeros(cv32.shape, device=dev)
    kv_p = torch.empty_like(stack15[7:])
    # K3's two forms on SGM-16: over the 15 volumes (the path's), or over
    # their in-order sum built in torch first; and K2k with the ordered
    # adds (`sgm_cost_volume`'s and the lane route's form)
    k3_forms = {
        "over the 15 volumes": lambda: sgm_wta(cv32, stack15, P1, P2, POUT,
                                               1, 3, 3, True),
        "torch sum, then over one": lambda: sgm_wta(
            cv32, _acc_sum(stack15), P1, P2, POUT, 1, 3, 3, True),
        "K2k with the 8 ordered adds": lambda: add_knight_volumes(
            cv32, acc_k, KD, P1, P2, POUT),
    }
    for name, fn in k3_forms.items():
        print(f"time: SGM-16 480x640x120 f32 {name}: {median_ms(fn):.3f} ms "
              f"(median of 5; {smi})", flush=True)

    jobs = {
        # the whole box_cv call: the statistics launch and the volume's
        "K1": (lambda: box_cv(ZNCC, L, R, 3, 3, 120, torch.bfloat16, True),
               lambda: box_cv_plain(ZNCC, L, R, 3, 3, 120, torch.bfloat16,
                                    True)),
        "K1 stats": (lambda: window_stats(ZNCC, L, R, 3, 3),
                     lambda: _prep_inputs(ZNCC, L, R, 3, 3)),
        # K2 as earlier PRs timed it: 7 launches one after another into one
        # accumulator (SGM-16's form, and SGM-8's where one launch does not
        # fit); K2x7 the main path's form: the 7 in one launch, a volume
        # each
        "K2": (lambda: sgm_accumulate(cv, k2_dirs, P1, P2, POUT), k2_plain),
        "K2x7": (lambda: direction_volumes(cv, k2_dirs, P1, P2, POUT),
                 k2x7_plain),
        # K2k as SGM-16's path runs it: the 8 knight volumes into its
        # stack in two launches; K3 over the 15 volumes
        "K2k": (lambda: knight_volumes(cv32, KD, P1, P2, POUT,
                                       out=stack15[7:]),
                lambda: knight_volumes_plain(cv32, KD, P1, P2, POUT,
                                             out=kv_p)),
        "K3": (lambda: sgm_wta(cv32, stack15, P1, P2, POUT, 1, 3, 3, True),
               lambda: sgm_wta_plain(cv32, stack15, P1, P2, POUT, 1, 3, 3,
                                     True)),
        "K3x7": (lambda: sgm_wta(cv, stack, P1, P2, POUT, 1, 3, 3, True),
                 lambda: sgm_wta_plain(cv, stack, P1, P2, POUT, 1, 3, 3,
                                       True)),
    }
    fs, ft = features(ZSAD, R), features(ZSAD, L)
    jobs.update({
        "K5": (lambda: fused_fv_cost_volume("sad", fs, ft, range(120)),
               lambda: fused_fv_cost_volume_plain("sad", fs, ft, range(120))),
        "K6": (lambda: sweep(costc, d1, c1, 0, 1, False),
               lambda: sweep_plain(costc, d1, c1, 0, 1, False)),
        # K7 as the random search runs it: the search probe, K = 4
        "K7": (lambda: search_probe(costc, draws, d1, c1, 0, 4),
               lambda: search_probe_plain(costc, draws, d1, c1, 0, 4)),
    })
    # the lane kernels at the wide path's volume (480x640x384 f32): K4a the
    # shear's window copy out of the padded volume, K4b the whole
    # `fused_adj` with WTA (K4d is timed at 4K, in its path's phase)
    padded = torch.nn.functional.pad(cvw, (0, 0, WH - 1, WH), value=INF)
    sa = shear_args(WH, WW, False)
    wkw = dict(col0=0, W_pout=WW, P1=P1, P2=P2, Pout=POUT)

    acc_s = torch.rand(cvw.shape, device=dev)
    kv_s = knight_volumes(cvw, KD, P1, P2, POUT)
    jobs.update({
        "K4a": (lambda: lane.shift_rows(padded, *sa),
                lambda: lane.shift_rows_plain(padded, *sa)),
        "K4b": (lambda: lane.fused_adj(cvw, 0, WW, P1, P2, POUT, 8,
                                       wta_radius=1),
                lambda: wide_plain(cvw)),
        # SGM-16's last scan at D = 384: the WTA scan summing the 8 knight
        # volumes as it reads them
        "K4b stack": (lambda: lane.fused_cols_wta(cvw, acc_s, 1,
                                                  knights=kv_s, **wkw),
                      lambda: lane.fused_cols_wta_plain(cvw, acc_s, 1,
                                                        knights=kv_s, **wkw)),
    })
    assert torch.equal(shift_rows_gather(padded, *sa), lane.shear(cvw, False))
    lib_ms = median_ms(lambda: shift_rows_gather(padded, *sa))
    print(f"time: K4a library call (one torch.gather) {lib_ms:.3f} ms "
          f"(median of 5; {smi})", flush=True)
    # the plain knight passes take ~1 s a run
    plain_reps = {"K2x7": 3, "K2k": 2, "K3": 3, "K4b": 2, "K4b stack": 2}
    ms = {"K4d": k4d_ms}
    for name, (kern, plain) in jobs.items():
        # plain, kernel, kernel, plain: the two medians of each averaged
        n = plain_reps.get(name, 5)
        w = 1 if n > 1 else 0
        p1, k1, k2_, p2 = (median_ms(plain, n, w), median_ms(kern),
                           median_ms(kern), median_ms(plain, n, w))
        ms[name] = ((k1 + k2_) / 2, (p1 + p2) / 2)
        print(f"time: {name} kernel {ms[name][0]:.3f} ms vs plain "
              f"{ms[name][1]:.3f} ms (kernel median of 5, plain median of "
              f"{n}, twice each; {smi})", flush=True)

    # the PatchMatch frame and its parts (CUDA events, median of 5)
    gen = torch.Generator(device=dev)
    pm_ms = median_ms(lambda: entry.patchmatch_forward(L, R,
                                                       gen.manual_seed(0)))
    parts = {
        "K1 NCC f32 (incl. glue)": median_ms(
            lambda: box_cv(NCC, L, R, 3, 3, 120)),
        "K6 sweep along W x5": 5 * median_ms(
            lambda: sweep(costc, d1, c1, 0, 1, False)),
        "K6 sweep along H x5": 5 * median_ms(
            lambda: sweep(costc, d1, c1, 0, 0, False)),
        "K7 K=1 x1": median_ms(lambda: probe(costc, d0, d0, inf_cost, 0)),
        "K7 search probe K=4 x5": 5 * median_ms(
            lambda: search_probe(costc, draws, d1, c1, 0, 4)),
    }
    parts["glue (the rest)"] = pm_ms - sum(parts.values())
    print(f"time: PatchMatch frame 480x640 D=120 5 it: {pm_ms:.3f} ms "
          f"(median of 5; {smi}); parts: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    _, device_ms = pm_kernel_times(
        dev, costc, d0, d1, c1, draws, cand, inf_cost, L, R, smi)
    wta_ms = median_ms(lambda: entry.wta_forward(ZSAD, L, R))
    print(f"time: WTA ZSAD frame 480x640 D=120: {wta_ms:.3f} ms (median of "
          f"5; {smi})", flush=True)

    mark("the matchers ported last: hierarchical (K1, K5), 2-D volumes and")
    # -- the matchers ported last: hierarchical (K1, K5), 2-D volumes and
    # refinement, PatchMatch flow, DP, fastmatch, guided filtering, the CLI
    hier_launches, e5 = matchers(dev, pairs, smi)
    err["K5"] = max(err["K5"], e5)

    mark("the feature-space refinement and the optim solvers (K5)")
    # -- the feature-space refinement and the optim solvers (K5) -------------
    refine_launches = {"K5": refine(dev, smi)}
    refine_flow_and_clis(dev, smi)
    optim_at_scale(dev, smi)

    mark("geometry: rays at 1M pairs, a rectified pair through the flagship")
    # -- geometry: rays at 1M pairs, a rectified pair through the flagship --
    rectified_launches = geometry(dev, smi)

    mark("the sparse chain and calibration targets: torch ops, no kernel")
    # -- the sparse chain and calibration targets: torch ops, no kernel ------
    sparse(dev, smi)

    mark("the pipelines: bg/fg (K5 twice a frame), intrinsic, segmentation")
    # -- the pipelines: bg/fg (K5 twice a frame), intrinsic, segmentation ---
    bgfg_launches = {"K5": pipelines(dev, smi)}

    mark("point clouds: a 16.8M-point LiDAR tile projected and detrended")
    # -- point clouds: IO, the depth map and the detrend; no kernel ----------
    pointclouds(dev, smi)

    mark("the distributed paths")
    d_err, d_launches, d_ms, d_bounds, k2_instances = distributed(dev, pairs,
                                                                  smi)
    mark("the kernels line")
    for k, v in d_err.items():
        err[k] = max(err.get(k, 0.0), v)
    ms.update(d_ms)

    records = [
        ("K1 box_cv (statistics + volume launch)",
         "libstevi_tpu_torch/csrc/box_cv.cu",
         "libstevi_tpu/ops/box_pallas.py:99", "K1"),
        ("K1 stats box_stats_kernel (window_stats)",
         "libstevi_tpu_torch/csrc/box_cv.cu",
         "libstevi_tpu/ops/box_pallas.py:378", "K1 stats"),
        ("K2 sgm_pass", "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:164", "K2"),
        ("K2x7 direction_volumes (7 directions in one launch)",
         "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:164", "K2x7"),
        ("K2k knight_volumes (8 directions, two launches)",
         "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:107", "K2k"),
        ("K3 sgm_wta over 15 direction volumes (SGM-16)",
         "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:374", "K3"),
        ("K3x7 sgm_wta over 7 direction volumes",
         "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:374", "K3x7"),
        ("K5 fv_cv", "libstevi_tpu_torch/csrc/fv_cv.cu",
         "libstevi_tpu/ops/fv_backend.py:38", "K5"),
        ("K6 pm_sweep (runs, chains, costs: three launches a sweep)",
         "libstevi_tpu_torch/csrc/patchmatch.cu",
         "libstevi_tpu/ops/patchmatch_pallas.py:47", "K6"),
        ("K7 pm_probe (search_probe, K=4)",
         "libstevi_tpu_torch/csrc/patchmatch.cu",
         "libstevi_tpu/ops/patchmatch_pallas.py:118", "K7"),
        ("K4a shift_rows", "libstevi_tpu_torch/csrc/sgm_lane.cu",
         "libstevi_tpu/ops/sgm_pallas.py:43", "K4a"),
        ("K4b fused_rows/fused_cols", "libstevi_tpu_torch/csrc/sgm_lane.cu",
         "libstevi_tpu/ops/sgm_pallas.py:147", "K4b"),
        ("K4b fused_cols_wta over the 8 knight volumes (SGM-16)",
         "libstevi_tpu_torch/csrc/sgm_lane.cu",
         "libstevi_tpu/ops/sgm_pallas.py:297", "K4b stack"),
        ("K4d chunked_sweep (one launch a sweep, 4K UHD)",
         "libstevi_tpu_torch/csrc/sgm_lane.cu",
         "libstevi_tpu/ops/sgm_pallas.py:586", "K4d"),
        ("K2s sgm_shard_pass/sgm_knight_shard_pass",
         "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:1013", "K2s"),
        ("K4c fused_rows_shard_pass", "libstevi_tpu_torch/csrc/sgm_lane.cu",
         "libstevi_tpu/ops/sgm_pallas.py:496", "K4c"),
        ("K2k any-D sgm_knight_smem_kernel",
         "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:107", "K2k any-D"),
        ("K2 any-D sgm_pass_group_kernel / sgm_pass_buf_kernel",
         "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:164", "K2 any-D"),
    ]
    # the SGM-16 path's run: K2k, and K3 over the 15 volumes (the main path
    # runs K2x7 and K3x7); K2 a direction a launch: the margins path's run
    launches.update({k: launches16[k] for k in ("K2k", "K3")})
    launches["K2"] = margin_launches["K2"]
    # K4a is on no path (the JAX package calls it only in a test): its
    # count is the wide path's, as K4b's; K4d's is the 4K UHD path's
    launches.update(K4a=wide_launches["K4a"], K4b=wide_launches["K4b"],
                    K4d=uhd_launches["K4d"])
    launches.update({k: d_launches[k]
                     for k in ("K2s", "K4c", "K2k any-D", "K4b stack")})
    # the any-D K2's main path: the distributed 4K UHD step (2 + 6 a shard)
    launches["K2 any-D"] = k2_uhd_launches
    # bounds from the timed calls' shapes: each input read once, each
    # output written once, and their f32 operations
    HW1, N1 = 480 * 640, 480 * 640 * 120
    NW = WH * WW * WD
    N4 = UH * UW * WD
    bounds = {
        # K1: the two images read, the bf16 volume written; separable sums
        # (7 products, 6 vertical and 6 horizontal adds an entry at 7x7)
        # and ZNCC's normalization (5 operations)
        "K1": bound(2 * HW1 * 4 + N1 * 2, 24 * N1),
        # the images read, 4 planes written; per image and pixel the
        # square, 2 x 6 vertical and 2 x 6 horizontal adds, the variance,
        # the root and the inverse (5)
        "K1 stats": bound(6 * HW1 * 4, 2 * 30 * HW1),
        # K2's function, in either form: cv read once, the 7 directions'
        # adjustments written as one f32 volume (K2x7's 7 volumes are its
        # form's, not the function's)
        "K2": bound(N1 * 2 + N1 * 4, SGM_OPS * 7 * N1),
        "K2x7": bound(N1 * 2 + N1 * 4, SGM_OPS * 7 * N1),
        # cv read once, acc read and written once (the function's work;
        # the 8 volumes are K2k's form)
        "K2k": bound(N1 * 4 + 2 * N1 * 4, SGM_OPS * 8 * N1),
        # cv (f32 on SGM-16) and one accumulator read once; idx, bands and
        # disp written (the 15 volumes are the form's)
        "K3": bound(N1 * 4 + N1 * 4 + 5 * HW1 * 4, (SGM_OPS + 3 + 6) * N1),
        "K3x7": bound(N1 * 2 + N1 * 4 + 5 * HW1 * 4, (SGM_OPS + 3 + 6) * N1),
        "K5": bound(2 * HW1 * 49 * 4 + N1 * 4, 3 * 49 * N1),
        # the state read and written (disp and cost in, disp and cost
        # out) and one volume value read a pixel; a compare and a select
        "K6": bound(5 * HW1 * 4, 4 * HW1),
        # the state, the 4 draws and the 4 volume values a pixel; the
        # scaling (5 operations) and the accept test a candidate
        "K7": bound(12 * HW1 * 4, 4 * 8 * HW1),
        # K4a reads only the copied window of its padded input
        "K4a": bound(2 * WH * (WW + WH - 1) * WD * 4, 0),
        "K4b": bound(NW * 4 + 4 * WH * WW * 4, (SGM_OPS * 8 + 3) * NW),
        # cv, acc and the 8 knight volumes read once, idx and bands written;
        # the DP step, the 8 knight adds and the C sum and min
        "K4b stack": bound(10 * NW * 4 + 4 * WH * WW * 4,
                           (SGM_OPS + 8 + 3) * NW),
        # the four sweeps at 4K: cv read once, adj written once; the six
        # directions they carry
        "K4d": bound(2 * N4 * 4, SGM_OPS * 6 * N4),
        **d_bounds,
    }
    library = {"K4a": lib_ms}
    # the instance each checked shape took (K2 any-D: the layouts its
    # launcher reported; K5: `fv_instance`)
    instances = {"K2 any-D": k2_instances, "K5": k5_instances}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key], "max_abs_err": err[key],
         "ms": ms[key][0], "plain_ms": ms[key][1],
         "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
         "library_ms": library.get(key),
         **({"hierarchical_launches": hier_launches[key]}
            if key in hier_launches else {}),
         **({"refine_launches": refine_launches[key]}
            if key in refine_launches else {}),
         **({"rectified_launches": rectified_launches[key]}
            if key in rectified_launches else {}),
         **({"bgfg_launches": bgfg_launches[key]}
            if key in bgfg_launches else {}),
         **({"device_ms": device_ms[key]} if key in device_ms else {}),
         **({"instances": instances[key]} if key in instances else {})}
        for name, src, rep, key in records]}), flush=True)
    print(f"script wall time {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_cpu_jobs()
    sys.exit(rc)
