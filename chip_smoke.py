"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``libstevi_tpu_torch/csrc`` and holds
each kernel against its plain PyTorch version: K1 box cost volume, K2 SGM
pass, K2k knight-direction SGM pass (all 8 directions, run twice: the same
acc both times) and K3 SGM pass + WTA at the flagship shape, at an odd
shape and at D=300 (40x360), in float32 and bfloat16, and at the HD path's
shape (720x1280, D=320) in bfloat16; the SGM entries with margins against
the CPU; K5 feature-volume cost volume at the WTA path's
shape (480x640, D=120, F=49) and at an odd shape (LEFT_TO_RIGHT, an offset
search, an RGB F=147 input); K6 PatchMatch sweep and K7 probe, exactly, on
the 480x640x120 NCC volume.  Then it runs six paths, each with the launch
counts set to 0 just before it and read just after:
- the flagship stereo path (`entry.flagship_forward`: 480x640, D=120,
  ZNCC 7x7, bf16 volume, SGM-8, parabola subpixel) on the two committed
  parity fixtures, held to accuracy bars against their ground truth, and a
  random pair;
- SGM-16 (`entry.sgm16_forward`: the same with 16 directions and an f32
  volume), the path of K2k, on the same three pairs, held to the
  `PARITY_r05` `zncc_sgm16_f32` bars; a bfloat16 request must give the
  float32 result;
- census + SGM-8 (`entry.census_sgm_forward`) on the fixtures, held to the
  `census_sgm8` bars;
- HD (`entry.hd_forward`: 720x1280, D=320, bf16 volume, SGM-8) on a random
  pair;
- PatchMatch (`entry.patchmatch_forward`: NCC 7x7, D=120, 5 iterations, 4
  random candidates) on the fixtures, held to bars;
- the WTA matcher with ZSAD (`entry.wta_forward`), which K5 carries, on the
  fixtures (no bar: the JAX package's parity record has no ZSAD row).
Each path also runs small against its plain version on the CPU, and the
port's CLI (`python -m libstevi_tpu_torch.cli.stereo_match --matcher sgm
--sgm-dirs 16`) runs as a subprocess on the warp fixture, held to the
SGM-16 bars.  It checks that each kernel was launched in its path, times
the frames and each kernel against its plain version (CUDA events, median
of 5), and prints one JSON line of kernel records, the card's name and
power limit, and a last JSON line ``{"ok": true, "device": ...}``.  Any
failed check raises: the exit code is then non-zero and no result line is
printed.  There is no CPU path.
"""

import json
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
P1, P2, POUT = 0.1, 0.5, 100.0


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


def bf16_ulp(x):
    """One bfloat16 ulp of each f32 value (8 significant bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), (e - 8).int())


def main() -> int:
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
    from libstevi_tpu_torch.ops.box_cuda import box_cv, box_cv_plain
    from libstevi_tpu_torch.ops.fv_backend import (fused_fv_cost_volume,
                                                   fused_fv_cost_volume_plain)
    from libstevi_tpu_torch.ops.patchmatch import (_patch_match_stereo_cv,
                                                   cost_oriented_volume)
    from libstevi_tpu_torch.ops.patchmatch_cuda import (probe, probe_plain,
                                                        sweep, sweep_plain)
    from libstevi_tpu_torch.ops.sgm import (SgmDirection, directions_for,
                                            direction_adj, _KNIGHT_DIRS,
                                            _tcv_from_bands)
    from libstevi_tpu_torch.ops.sgm_cuda import (sgm_knight_pass,
                                                 sgm_knight_pass_plain,
                                                 sgm_pass, sgm_pass_plain,
                                                 sgm_wta, sgm_wta_plain)
    from libstevi_tpu_torch.statistics import prop_good, inlier_mae

    dev = torch.device("cuda")
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

    ZNCC = MatchingFunction.ZNCC
    R2L = SgmDirection.RIGHT2LEFT
    k2_dirs = [d for d in directions_for(8) if d is not R2L]
    err = {"K1": 0.0, "K2": 0.0, "K2k": 0.0, "K3": 0.0}

    # -- kernel phases: each kernel against its plain version ----------------
    # D=300 takes K = 10 values a lane in K1, K2, K2k and K3; the HD path's
    # shape (720x1280, D=320, bf16) fills every slice of every lane and K1's
    # largest shared tile
    both = (torch.float32, torch.bfloat16)
    for (H, W, D), dts in (((480, 640, 120), both), ((37, 101, 13), both),
                           ((40, 360, 300), both),
                           ((entry.HD_HEIGHT, entry.HD_WIDTH, 320),
                            (torch.bfloat16,))):
        L, R = pair(H, W, 1, dev)
        for dt in dts:
            tag = f"{H}x{W}x{D} {str(dt).split('.')[-1]}"
            cv = box_cv(ZNCC, L, R, 3, 3, D, dt, negate=True)
            want = box_cv_plain(ZNCC, L, R, 3, 3, D, torch.float32,
                                negate=True)
            torch.cuda.synchronize()
            e1 = (cv.float() - want).abs()
            if dt == torch.float32:
                torch.testing.assert_close(cv, want, rtol=1e-4, atol=1e-4)
                if (H, W) == (480, 640):
                    err["K1"] = e1.max().item()
            else:
                # one bf16 ulp of the f32 value, plus 1e-5 for the f32
                # sum-order noise between the two versions
                assert (e1 <= bf16_ulp(want) + 1e-5).all(), tag
            print(f"K1 {tag}: max |kernel - plain| = {e1.max().item():.3g}",
                  flush=True)

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

            # K2k: the 8 knight directions on top, twice from one acc
            acc2 = acc.clone()
            for d in _KNIGHT_DIRS:
                sgm_knight_pass(cv, acc, d, P1, P2, POUT)
                sgm_knight_pass(cv, acc2, d, P1, P2, POUT)
                sgm_knight_pass_plain(cv, acc_p, d, P1, P2, POUT)
            torch.cuda.synchronize()
            assert torch.equal(acc, acc2), f"K2k {tag}: two runs differ"
            torch.testing.assert_close(acc, acc_p, rtol=1e-4, atol=1e-4)
            ek = (acc - acc_p).abs().max().item()
            err["K2k"] = max(err["K2k"], ek)
            print(f"K2k {tag}: 8 directions, two runs equal, max |kernel - "
                  f"plain| = {ek:.3g}", flush=True)

            idx, bands, disp = sgm_wta(cv, acc, P1, P2, POUT, 1, 3, 3, True)
            idx_p, bands_p, disp_p = sgm_wta_plain(cv, acc, P1, P2, POUT, 1,
                                                   3, 3, True)
            C = acc + direction_adj(cv.float(), R2L, P1, P2, POUT) + cv.float()
            two = torch.topk(C, 2, dim=-1, largest=False).values
            clear = (two[..., 1] - two[..., 0]) > 1e-4
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
            assert torch.equal(torch.isnan(disp[same]),
                               torch.isnan(disp_p[same]))
            f = same & torch.isfinite(disp_p)
            torch.testing.assert_close(disp[f], disp_p[f], rtol=1e-4,
                                       atol=1e-4)
            fin = same[..., None] & torch.isfinite(bands_p)
            e3 = max((bands - bands_p).abs()[fin].max().item(),
                     (disp - disp_p).abs()[f].max().item())
            err["K3"] = max(err["K3"], e3)
            print(f"K3 {tag}: idx agree {agree:.6f}, max |kernel - plain| "
                  f"= {e3:.3g}", flush=True)

    # SGM margins: the region runs contiguous (image column offset and
    # width for Pout) and is padded back; against the plain path on the CPU
    L, R = pair(37, 101, 11, dev)
    cv = box_cv(ZNCC, L, R, 3, 3, 13, torch.float32, negate=True)
    m = Margins(2, 1, 3, 2)
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

    # -- K5 against its plain version ----------------------------------------
    NCC, ZSAD = MatchingFunction.NCC, MatchingFunction.ZSAD
    K5_FUNCS = {"dot": MatchingFunction.ZNCC, "ssd": MatchingFunction.SSD,
                "sad": ZSAD}
    err.update(K5=0.0, K6=0.0, K7=0.0)

    def features(func, img):
        """The normalized 7x7 unfold the WTA path aggregates."""
        return normalize_feature_volume(func, unfold(3, 3, img))

    def check_k5(kernel, src, tgt, shifts, tag):
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
            print(f"K5 {tag} {kernel} {str(dt).split('.')[-1]}: max |kernel "
                  f"- plain| = {e5.max().item():.3g}", flush=True)

    L, R = pair(480, 640, 4, dev)
    for kernel, func in K5_FUNCS.items():
        check_k5(kernel, features(func, R), features(func, L), range(120),
                 "480x640x120 F=49")
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
    for axis in (0, 1):
        for rev in (False, True):
            e6 = state_err(sweep(costc, d1, c1, 0, axis, rev),
                           sweep_plain(costc, d1, c1, 0, axis, rev))
            err["K6"] = max(err["K6"], e6)
    print("K6 480x640x120 sweeps (axis 0, 1; forward, reverse): equal to "
          "plain", flush=True)

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
    K2K_COUNTERS = (box_cv, sgm_pass, sgm_knight_pass, sgm_wta)

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
    launches = {"K1": box_cv.launches, "K2": sgm_pass.launches,
                "K3": sgm_wta.launches}
    print(f"main path: 3 pairs in {wall:.3f} s host wall (first calls), "
          f"launches {launches}", flush=True)
    assert all(n > 0 for n in launches.values()), launches
    for name, (disp, idx, tcv) in out.items():
        assert disp.shape == idx.shape == (480, 640)
        assert disp.dtype == torch.float32 and tcv.shape == (480, 640, 3)
        if name == "random":
            check_random("random", disp, idx, 120)
        else:
            check_bars(name, disp, pairs[name][1], BARS[name][1:])

    # -- the SGM-16 path: both fixtures and the random pair -------------------
    reset(*K2K_COUNTERS, fused_fv_cost_volume)
    t0 = time.perf_counter()
    out16 = {name: dense_sgm_stereo(ZNCC, *imgs, **entry.SGM16)
             for name, (imgs, _) in pairs.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches16 = {"K1": box_cv.launches, "K2": sgm_pass.launches,
                  "K2k": sgm_knight_pass.launches, "K3": sgm_wta.launches}
    print(f"SGM-16 path: 3 pairs in {wall:.3f} s host wall (first calls), "
          f"launches {launches16}, K5 {fused_fv_cost_volume.launches}",
          flush=True)
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

    # -- census + SGM-8: both fixtures ---------------------------------------
    reset(*K2K_COUNTERS, fused_fv_cost_volume)
    t0 = time.perf_counter()
    out_cs = {name: entry.census_sgm_forward(*pairs[name][0])
              for name in CENSUS_BARS}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cs_launches = {"K1": box_cv.launches, "K2": sgm_pass.launches,
                   "K2k": sgm_knight_pass.launches, "K3": sgm_wta.launches,
                   "K5": fused_fv_cost_volume.launches}
    print(f"census SGM-8 path: 2 pairs in {wall:.3f} s host wall, launches "
          f"{cs_launches} (the census volume runs on the shifted-compare "
          f"loop)", flush=True)
    assert cs_launches["K2"] > 0 and cs_launches["K3"] > 0, cs_launches
    for name, disp in out_cs.items():
        assert disp.shape == (480, 640) and disp.dtype == torch.float32
        check_bars(name, disp, pairs[name][1], CENSUS_BARS[name])

    # -- HD 720x1280, D=320, bf16, SGM-8: a random pair ----------------------
    Lh, Rh = pair(entry.HD_HEIGHT, entry.HD_WIDTH, 12, dev)
    reset(*K2K_COUNTERS)
    t0 = time.perf_counter()
    dh, ih, th = dense_sgm_stereo(ZNCC, Lh, Rh, **entry.HD_BF16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hd_launches = {"K1": box_cv.launches, "K2": sgm_pass.launches,
                   "K3": sgm_wta.launches}
    print(f"HD path 720x1280x320 bf16: {wall:.3f} s host wall (first call), "
          f"launches {hd_launches}", flush=True)
    assert all(n > 0 for n in hd_launches.values()), hd_launches
    assert dh.shape == (720, 1280) and th.shape == (720, 1280, 3)
    check_random("HD random", dh, ih, 320)

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
    }
    frame_times = {}
    for name, fn in frames.items():
        frame_times[name] = median_ms(fn)
        print(f"time: {name}: {frame_times[name]:.3f} ms (median of 5; "
              f"{smi})", flush=True)
    cv = box_cv(ZNCC, L, R, 3, 3, 120, torch.bfloat16, negate=True)
    acc = torch.empty(cv.shape, device=dev)
    acc_p = torch.empty(cv.shape, device=dev)

    def k2(fn, a):
        for k, d in enumerate(k2_dirs):
            fn(cv, a, d, P1, P2, POUT, accumulate=k > 0)

    for k, d in enumerate(k2_dirs):
        sgm_pass(cv, acc, d, P1, P2, POUT, accumulate=k > 0)
    cv32 = box_cv(ZNCC, L, R, 3, 3, 120, torch.float32, negate=True)
    acc_k = torch.zeros(cv32.shape, device=dev)

    def k2k(fn):
        for d in _KNIGHT_DIRS:
            fn(cv32, acc_k, d, P1, P2, POUT)

    jobs = {
        "K1": (lambda: box_cv(ZNCC, L, R, 3, 3, 120, torch.bfloat16, True),
               lambda: box_cv_plain(ZNCC, L, R, 3, 3, 120, torch.bfloat16,
                                    True)),
        "K2": (lambda: k2(sgm_pass, acc_p), lambda: k2(sgm_pass_plain, acc_p)),
        "K2k": (lambda: k2k(sgm_knight_pass),
                lambda: k2k(sgm_knight_pass_plain)),
        "K3": (lambda: sgm_wta(cv, acc, P1, P2, POUT, 1, 3, 3, True),
               lambda: sgm_wta_plain(cv, acc, P1, P2, POUT, 1, 3, 3, True)),
    }
    fs, ft = features(ZSAD, R), features(ZSAD, L)
    jobs.update({
        "K5": (lambda: fused_fv_cost_volume("sad", fs, ft, range(120)),
               lambda: fused_fv_cost_volume_plain("sad", fs, ft, range(120))),
        "K6": (lambda: sweep(costc, d1, c1, 0, 1, False),
               lambda: sweep_plain(costc, d1, c1, 0, 1, False)),
        "K7": (lambda: probe(costc, cand, d1, c1, 0),
               lambda: probe_plain(costc, cand, d1, c1, 0)),
    })
    plain_reps = {"K2k": 2}      # the plain knight passes take ~1 s a run
    ms = {}
    for name, (kern, plain) in jobs.items():
        # plain, kernel, kernel, plain: the two medians of each averaged
        n = plain_reps.get(name, 5)
        p1, k1, k2_, p2 = (median_ms(plain, n), median_ms(kern),
                           median_ms(kern), median_ms(plain, n))
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
        "K7 K=4 x5": 5 * median_ms(lambda: probe(costc, cand, d1, c1, 0)),
    }
    parts["glue (the rest)"] = pm_ms - sum(parts.values())
    print(f"time: PatchMatch frame 480x640 D=120 5 it: {pm_ms:.3f} ms "
          f"(median of 5; {smi}); parts: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    wta_ms = median_ms(lambda: entry.wta_forward(ZSAD, L, R))
    print(f"time: WTA ZSAD frame 480x640 D=120: {wta_ms:.3f} ms (median of "
          f"5; {smi})", flush=True)

    records = [
        ("K1 box_cv", "libstevi_tpu_torch/csrc/box_cv.cu",
         "libstevi_tpu/ops/box_pallas.py:99", "K1"),
        ("K2 sgm_pass", "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:164", "K2"),
        ("K2k sgm_knight_pass", "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:107", "K2k"),
        ("K3 sgm_wta", "libstevi_tpu_torch/csrc/sgm_scan.cu",
         "libstevi_tpu/ops/sgm_pallas_dhw.py:374", "K3"),
        ("K5 fv_cv", "libstevi_tpu_torch/csrc/fv_cv.cu",
         "libstevi_tpu/ops/fv_backend.py:38", "K5"),
        ("K6 pm_sweep", "libstevi_tpu_torch/csrc/patchmatch.cu",
         "libstevi_tpu/ops/patchmatch_pallas.py:47", "K6"),
        ("K7 pm_probe", "libstevi_tpu_torch/csrc/patchmatch.cu",
         "libstevi_tpu/ops/patchmatch_pallas.py:118", "K7"),
    ]
    launches["K2k"] = launches16["K2k"]     # the SGM-16 path's run
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key], "max_abs_err": err[key],
         "ms": ms[key][0], "plain_ms": ms[key][1]}
        for name, src, rep, key in records]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
