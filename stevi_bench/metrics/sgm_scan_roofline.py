"""sgm_scan_roofline.<cells>: K2 and K3, the SGM scans with the WTA
(csrc/sgm_scan.cu), as a % of the SGM stage's roofline.  The stage reads
the (H, W, D) volume once in its dtype and writes the float32 disparity
once; its fewest float32 operations are 8 an entry and a direction (the
two neighbours' P1 adds, the three minima, the previous minimum's
subtraction, the cost's add and the running minimum for the next step)."""

from stevi_bench import roofline

KERNELS = ("sgm_pass_kernel", "sgm_pass_group_kernel", "sgm_pass_buf_kernel",
           "sgm_knight_kernel", "sgm_knight_smem_kernel", "sgm_wta_kernel")
OPS_PER_ENTRY_DIRECTION = 8


def stage(config):
    """(bytes, float32 operations) of one frame's SGM stage."""
    n_bytes = roofline.volume_bytes(config) + 4 * roofline.pixels(config)
    return n_bytes, (OPS_PER_ENTRY_DIRECTION * config["n_directions"]
                     * roofline.entries(config))


def read(run):
    return roofline.share(run, KERNELS, *stage(run.config))
