"""sgm_lane_roofline.<cells>: K4b and K4d, the lane route's row sweeps and
column scans with the WTA (csrc/sgm_lane.cu), as a % of the SGM stage's
roofline: the (H, W, D) volume read once in its dtype, the float32
disparity written once, and 8 float32 operations an entry and a direction
(as for sgm_scan_roofline)."""

from stevi_bench import roofline

KERNELS = ("fused_rows_kernel", "fused_cols_kernel", "chunked_sweep_kernel")
OPS_PER_ENTRY_DIRECTION = 8


def stage(config):
    """(bytes, float32 operations) of one frame's SGM stage."""
    n_bytes = roofline.volume_bytes(config) + 4 * roofline.pixels(config)
    return n_bytes, (OPS_PER_ENTRY_DIRECTION * config["n_directions"]
                     * roofline.entries(config))


def read(run):
    return roofline.share(run, KERNELS, *stage(run.config))
