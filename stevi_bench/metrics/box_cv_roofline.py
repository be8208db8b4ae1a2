"""box_cv_roofline.<cells>: K1, the ZNCC cost volume (csrc/box_cv.cu), as a
% of its stage's roofline.  The stage reads the two float32 images once and
writes the (H, W, D) volume once in its dtype; its fewest float32
operations are 8 an entry (the product, a running window sum's add and
subtract along each axis, the centred product and the two normalising
multiplies, counted low)."""

from stevi_bench import roofline

KERNELS = ("box_stats_kernel", "box_cv_kernel")
OPS_PER_ENTRY = 8


def stage(config):
    """(bytes, float32 operations) of one frame's cost-volume stage."""
    n_bytes = 2 * 4 * roofline.pixels(config) + roofline.volume_bytes(config)
    return n_bytes, OPS_PER_ENTRY * roofline.entries(config)


def read(run):
    return roofline.share(run, KERNELS, *stage(run.config))
