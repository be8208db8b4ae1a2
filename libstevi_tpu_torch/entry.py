"""Entry points of the port, mirroring `__graft_entry__.py` and the
`bench_grid.py` configurations.

`flagship_forward` is the main path: box ZNCC cost volume (7x7 window,
D=120, bf16 volume) -> 8-direction SGM (P1=0.1, P2=0.5, Pout=100) -> tie-last
WTA -> truncated band (r=1) -> parabola subpixel, at the reference benchmark
geometry (480x640; `test/benchmarks/benchmarkCrossCorrelationAlgorithms.cpp:
370-401`); on CUDA replayed as one CUDA graph per input geometry
(`FLAGSHIP_GRAPHS`).  The other entries run eagerly.  `entry(device)`
returns it with a random pair made from seed 0.

`sgm16_forward` is the same path with 16 directions and a float32 volume
(`bench_grid.py:114-126`, "SGM16 ZNCC SD D=120"); `census_sgm_forward` is
census + 8-direction SGM (P1=1, P2=4) + parabola, the `census_sgm8` row of
`PARITY_r05` (`scripts/run_parity_r05.py:67-74`); `kitti_census_forward`
is that matcher over D=192 for KITTI 2015's 375x1242 pairs (`KITTI_HEIGHT`
x `KITTI_WIDTH`): the census kernel, K2x7 and K3x7 with the parabola, on
a float32 volume; `hd_forward` is the
flagship at 720x1280 with D=320 (`bench_grid.py:153-154`, "SGM8 ZNCC bf16
dense HD D=320").  `wide_forward` is the flagship just past K2's reach:
ZNCC 7x7, D=384, SGM-8, a float32 volume (K4b casts to float32,
`libstevi_tpu/ops/sgm_pallas.py:394`), at 480x640; `hd_wide_forward` is
the HD row with its range doubled to D=640, at 720x1280.  Both run K1 and
the lane-layout SGM kernels (K4b).  `uhd_wide_forward` is the wide
configuration at 4K UHD, 2160x3840 (a 12.74 GB f32 volume), the geometry of
3840x2160 stereo rigs: there K4b's carries do not fit on chip, so it runs
K1, K4d's four one-launch sweeps and K4b's column scans, the last one fused
with the WTA.

`distributed_forward` is the flagship configuration (ZNCC 7x7, D=120,
P1=0.1, P2=0.5, SGM-8) through `parallel.stereo.distributed_full_step` on a
mesh; `dryrun_multichip(n)` is `__graft_entry__.dryrun_multichip`: the
(batch, tile, dsh) factoring of n shards at its 96x256x32 shape, the n
shards virtual on one device.

`hierarchical_forward` is the coarse-to-fine matcher of `bench_grid.py:
179-184` ("Hierarchical ZNCC depth-2 D=120", the `hierarchical_d2` row of
`PARITY_r05`): ZNCC 7x7, D=120, depth 2 at 480x640, so its coarsest level
is a full 120x160x30 volume (K1 on the card) and the two guided levels are
gathers; `hierarchical_hd_forward` is the same at 720x1280, D=320, depth 3
(`bench_grid.py:186-191`; coarsest 90x160x40).

`stereo_refine_forward` is the image-level subpixel refinement of
`cli/stereo_refine.py` (the reference's `stereo_refine_test` example):
unfold both images (ZNCC 7x7 by default), the cost volume over D = 120
(K5 on the card for the dot/SSD/SAD families), WTA, then the feature-space
refinement of one method: "barycentric" (two 2-point spherical / L2 / L1
solves a pixel), "barycentric-symmetric" (one 3-point solve) or
"cost-symmetric" (the volume's parabola averaged with a half-pixel one).

`bg_fg_forward` is one live frame of `cli/bg_fg_stereo.py` (the
reference's `bg_fg_stereo` example) after `bg_fg_background` has computed
the background from a background pair: ZNCC over 7x7 windows (r = 3),
D = 192, relative threshold 0.9, meant for 1080x1920 (`BGFG_HEIGHT` x
`BGFG_WIDTH`): the live cost volume (K5 on the card, as is the
background's), the cost ratio at the background disparity, the seed /
opening / dilation / grow rule and the WTA disparities.  `bg_fg_scene`
makes a synthetic scene for it from a seed, `bg_fg_entry(device)` returns
the forward and its arguments at that size.

`patchmatch_forward` is the PatchMatch matcher in the `BENCH_GRID_r05` /
`PARITY_r05` configuration (NCC, 7x7 window, disparities [0, 119], 5
iterations, 4 random candidates); `wta_forward` is the per-matching-function
cost volume + WTA of `bench_grid.py:128-138` (7x7 window, D=120).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import MATCH_TRAITS, MatchingFunction, SearchOffset1
from .ops import (InterpolationKernel, dense_sgm_stereo,
                  extract_selected_index, patch_match,
                  unfold_based_cost_volume)
from .ops.hierarchical import hierarchical_truncated_cost_volume
from .ops.sgm import dense_sgm_buffers
from .utils.frame_graph import FrameGraphs

FLAGSHIP = dict(h_radius=3, v_radius=3, disp_width=120, P1=0.1, P2=0.5,
                n_directions=8, cost_vol_radius=1,
                refine_kernel=InterpolationKernel.PARABOLA,
                cv_dtype=torch.bfloat16)
SGM16 = dict(FLAGSHIP, n_directions=16, cv_dtype=torch.float32)
CENSUS_SGM8 = dict(FLAGSHIP, P1=1.0, P2=4.0, cv_dtype=torch.float32)
KITTI_CENSUS = dict(CENSUS_SGM8, disp_width=192)
HD_BF16 = dict(FLAGSHIP, disp_width=320)
WIDE = dict(FLAGSHIP, disp_width=384, cv_dtype=torch.float32)
HD_WIDE = dict(WIDE, disp_width=640)
PATCHMATCH = dict(search=SearchOffset1(0, 119), h_radius=3, v_radius=3,
                  n_iter=5, n_random=4)
WTA = dict(h_radius=3, v_radius=3, search=120)
HIERARCHICAL = dict(h_radius=3, v_radius=3, disp_width=120, depth=2)
HIERARCHICAL_HD = dict(HIERARCHICAL, disp_width=320, depth=3)
DIST = dict(h_radius=3, v_radius=3, disp_width=120, P1=0.1, P2=0.5,
            n_directions=8)
REFINE = dict(h_radius=3, v_radius=3, search_range=120)
BGFG = dict(func=MatchingFunction.ZNCC, radius=3, disp_width=192,
            rel_threshold=0.9)
HEIGHT, WIDTH = 480, 640
BGFG_HEIGHT, BGFG_WIDTH = 1080, 1920
HD_HEIGHT, HD_WIDTH = 720, 1280
KITTI_HEIGHT, KITTI_WIDTH = 375, 1242
UHD_HEIGHT, UHD_WIDTH = 2160, 3840


def _flagship(img_l, img_r, **buffers):
    return dense_sgm_stereo(MatchingFunction.ZNCC, img_l, img_r, **FLAGSHIP,
                            **buffers)[0]


def _flagship_buffers(img_l, img_r):
    return dense_sgm_buffers(img_l, FLAGSHIP["disp_width"],
                             FLAGSHIP["n_directions"], FLAGSHIP["cv_dtype"])


# the flagship's frames on CUDA, one captured graph per input geometry
FLAGSHIP_GRAPHS = FrameGraphs(_flagship, _flagship_buffers)


def flagship_forward(img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair.  On CUDA a
    geometry's third and later frames replay the frame captured at its
    second (`FLAGSHIP_GRAPHS`, `utils.frame_graph`): K1 stats, K1, K2x7,
    K3x7 and the band in one graph launch, with the bits of the eager
    frame."""
    return FLAGSHIP_GRAPHS(img_l, img_r)


def sgm16_forward(img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair, 16-direction SGM."""
    disp, _, _ = dense_sgm_stereo(MatchingFunction.ZNCC, img_l, img_r,
                                  **SGM16)
    return disp


def census_sgm_forward(img_l: torch.Tensor,
                       img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair, census + SGM-8."""
    disp, _, _ = dense_sgm_stereo(MatchingFunction.CENSUS, img_l, img_r,
                                  **CENSUS_SGM8)
    return disp


def kitti_census_forward(img_l: torch.Tensor,
                         img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair, census + SGM-8 over
    D=192: the KITTI 2015 configuration, meant for 375x1242."""
    disp, _, _ = dense_sgm_stereo(MatchingFunction.CENSUS, img_l, img_r,
                                  **KITTI_CENSUS)
    return disp


def hd_forward(img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair at D=320, bf16."""
    disp, _, _ = dense_sgm_stereo(MatchingFunction.ZNCC, img_l, img_r,
                                  **HD_BF16)
    return disp


def wide_forward(img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair at D=384, f32."""
    disp, _, _ = dense_sgm_stereo(MatchingFunction.ZNCC, img_l, img_r, **WIDE)
    return disp


def hd_wide_forward(img_l: torch.Tensor,
                    img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair at D=640, f32."""
    disp, _, _ = dense_sgm_stereo(MatchingFunction.ZNCC, img_l, img_r,
                                  **HD_WIDE)
    return disp


def uhd_wide_forward(img_l: torch.Tensor,
                     img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair at D=384, f32: the
    wide configuration, meant for 2160x3840 (UHD_HEIGHT x UHD_WIDTH)."""
    disp, _, _ = dense_sgm_stereo(MatchingFunction.ZNCC, img_l, img_r, **WIDE)
    return disp


def patchmatch_forward(img_l: torch.Tensor, img_r: torch.Tensor,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """PatchMatch NCC disparity (H, W) int32 of a gray pair; candidates come
    from ``generator`` (on the images' device)."""
    return patch_match(MatchingFunction.NCC, img_l, img_r,
                       generator=generator, **PATCHMATCH)


def hierarchical_forward(img_l: torch.Tensor,
                         img_r: torch.Tensor) -> torch.Tensor:
    """Hierarchical ZNCC disparity estimate (H, W) int32 of a gray pair,
    depth 2, D=120."""
    return hierarchical_truncated_cost_volume(
        MatchingFunction.ZNCC, img_l, img_r, **HIERARCHICAL).disp_estimate


def hierarchical_hd_forward(img_l: torch.Tensor,
                            img_r: torch.Tensor) -> torch.Tensor:
    """Hierarchical ZNCC disparity estimate (H, W) int32 of a gray pair,
    depth 3, D=320: the configuration meant for 720x1280."""
    return hierarchical_truncated_cost_volume(
        MatchingFunction.ZNCC, img_l, img_r, **HIERARCHICAL_HD).disp_estimate


REFINE_METHODS = ("barycentric", "barycentric-symmetric", "cost-symmetric")


def stereo_refine_forward(img_l: torch.Tensor, img_r: torch.Tensor,
                          method: str,
                          func: MatchingFunction = MatchingFunction.ZNCC
                          ) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair by one of
    `REFINE_METHODS`, in the `REFINE` configuration."""
    from .ops import image_refinement as ir
    run = {"barycentric": ir.refined_barycentric_disp,
           "barycentric-symmetric": ir.refined_barycentric_symmetric_disp,
           "cost-symmetric": ir.refined_cost_symmetric_disp}
    if method not in run:
        raise ValueError(f"method {method!r}: one of {REFINE_METHODS}")
    return run[method](func, img_l, img_r, **REFINE)


def bg_fg_background(bg_l: torch.Tensor, bg_r: torch.Tensor,
                     func: MatchingFunction = BGFG["func"],
                     radius: int = BGFG["radius"],
                     disp_width: int = BGFG["disp_width"],
                     rel_threshold: float = BGFG["rel_threshold"]):
    """A `DisparityEstimatorWithBackgroundRemoval` holding the background
    volume and WTA disparities of a gray background pair (the CLI's
    `compute_background_disp`, the right image as the source)."""
    from .ops.bg_segmentation import DisparityEstimatorWithBackgroundRemoval
    from .ops.unfold import unfold
    est = DisparityEstimatorWithBackgroundRemoval(
        func, relative_threshold=rel_threshold)
    est.compute_background_disp(unfold(radius, radius, bg_r),
                                unfold(radius, radius, bg_l),
                                SearchOffset1(0, disp_width - 1))
    return est


def bg_fg_forward(live_l: torch.Tensor, live_r: torch.Tensor, estimator,
                  radius: int = BGFG["radius"]):
    """The `StereoDispWithBgMask` (int32 disparities, bool foreground) of
    a gray live pair against ``estimator``'s background
    (`bg_fg_background`)."""
    from .ops.cost_volume import feature_volume_to_cost_volume
    from .ops.unfold import unfold
    live_cv = feature_volume_to_cost_volume(
        estimator.func, unfold(radius, radius, live_l),
        unfold(radius, radius, live_r), estimator.search)
    return estimator.compute_disp_and_foreground_mask(live_cv)


def bg_fg_scene(H: int = BGFG_HEIGHT, W: int = BGFG_WIDTH, d_bg: int = 24,
                d_fg: int = 40, seed: int = 0):
    """A synthetic background / live scene: uniform noise in [0.1, 1) as
    the background's right image, its left image that noise shifted by
    ``d_bg`` columns; the live pair is the background pair with a textured
    rectangle (the middle (0.37 H) x (0.31 W), its own noise) pasted into
    the right image and, ``d_fg`` columns to the right, into the left one.
    Returns (bg_l, bg_r, live_l, live_r) float32 numpy arrays and the
    rectangle's (H, W) bool mask in the right (source) image."""
    rng = np.random.default_rng(seed)
    bg_r = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    bg_l = np.roll(bg_r, d_bg, axis=1)
    h, w = int(0.37 * H), int(0.31 * W)
    r0, c0 = (H - h) // 2, (W - w) // 2
    obj = rng.uniform(0.1, 1.0, (h, w)).astype(np.float32)
    live_r, live_l = bg_r.copy(), bg_l.copy()
    live_r[r0:r0 + h, c0:c0 + w] = obj
    live_l[r0:r0 + h, c0 + d_fg:c0 + d_fg + w] = obj
    rect = np.zeros((H, W), bool)
    rect[r0:r0 + h, c0:c0 + w] = True
    return (bg_l, bg_r, live_l, live_r), rect


def bg_fg_entry(device="cuda", seed: int = 0):
    """Returns (fn, example_args): `bg_fg_forward` and a `bg_fg_scene`
    live pair at 1080x1920 on ``device`` with its background estimator
    (the background already computed there)."""
    (bg_l, bg_r, live_l, live_r), _ = bg_fg_scene(BGFG_HEIGHT, BGFG_WIDTH,
                                                  seed=seed)
    t = [torch.from_numpy(x).to(device) for x in (bg_l, bg_r, live_l, live_r)]
    return bg_fg_forward, (t[2], t[3], bg_fg_background(t[0], t[1]))


def wta_forward(func: MatchingFunction, img_l: torch.Tensor,
                img_r: torch.Tensor) -> torch.Tensor:
    """WTA disparity index (H, W) int32 of ``func``'s cost volume."""
    cv = unfold_based_cost_volume(func, img_l, img_r, **WTA)
    return extract_selected_index(cv, MATCH_TRAITS[func].strategy)


def distributed_forward(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                        mesh) -> torch.Tensor:
    """WTA disparities (B, H, W) int32 of gray pairs (B, H, W), the
    flagship configuration over ``mesh`` (`parallel.make_stereo_mesh`)."""
    from .parallel.stereo import distributed_full_step
    return distributed_full_step(mesh, MatchingFunction.ZNCC, **DIST)(
        imgs_l, imgs_r)


def _factor(n: int):
    """`__graft_entry__.dryrun_multichip`'s factoring of n shards into
    (batch, tile, dsh): prefer tile, then batch and dsh."""
    from .parallel import MeshSpec
    if n % 8 == 0:
        return MeshSpec(batch=2, tile=n // 4, dsh=2)
    if n % 4 == 0:
        return MeshSpec(batch=1, tile=n // 2, dsh=2)
    if n % 2 == 0:
        return (MeshSpec(batch=1, tile=n // 2, dsh=2) if n > 2
                else MeshSpec(batch=1, tile=2, dsh=1))
    return MeshSpec(batch=1, tile=n, dsh=1)


def dryrun_multichip(n_devices: int, device="cuda") -> torch.Tensor:
    """One step of the fully sharded pipeline (batch over pairs, row tiles
    with halo rows and the SGM carry relay, the disparity range over dsh)
    on ``n_devices`` virtual shards of ``device``, at
    `__graft_entry__.dryrun_multichip`'s geometry: 2 pairs a batch group,
    96x256, D=32, ZNCC 7x7, SGM-8.  Returns the (B, H, W) disparities."""
    from .parallel import make_stereo_mesh
    from .parallel.stereo import distributed_full_step
    spec = _factor(n_devices)
    mesh = make_stereo_mesh(spec, [torch.device(device)] * spec.n_devices)
    B, H, W, D = 2 * spec.batch, 96, 256, 32
    rng = np.random.default_rng(1)
    ls, rs = (torch.from_numpy(rng.uniform(0, 1, (B, H, W))
                               .astype(np.float32)).to(device)
              for _ in range(2))
    step = distributed_full_step(mesh, MatchingFunction.ZNCC, 3, 3, D,
                                 P1=0.1, P2=0.5, n_directions=8)
    out = step(ls, rs)
    if out.shape != (B, H, W):
        raise AssertionError(out.shape)
    return out


def entry(device="cuda"):
    """Returns (fn, example_args): the flagship forward and a random
    480x640 pair on ``device``."""
    rng = np.random.default_rng(0)
    img_l = torch.from_numpy(
        rng.uniform(0, 1, (HEIGHT, WIDTH)).astype(np.float32)).to(device)
    img_r = torch.from_numpy(
        rng.uniform(0, 1, (HEIGHT, WIDTH)).astype(np.float32)).to(device)
    return flagship_forward, (img_l, img_r)
