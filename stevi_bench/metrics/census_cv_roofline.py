"""census_cv_roofline.<cells>: the census cost volume (csrc/census_cv.cu:
the words kernel, then the Hamming volume) as a % of its stage's roofline.
The stage reads the two float32 images once and writes the (H, W, D)
volume once in its dtype; its fewest operations are 3 a census word an
entry (the xor, the popcount and the add), ceil(((2h+1)(2v+1) - 1) / 32)
words a pixel, counted at the float32 rate as the other stages' are."""

from stevi_bench import roofline

KERNELS = ("census_words_kernel", "census_cv_kernel")
OPS_PER_WORD = 3


def words(config):
    """Census words a pixel of the configuration's window."""
    n_bits = (2 * config["h_radius"] + 1) * (2 * config["v_radius"] + 1) - 1
    return -(-n_bits // 32)


def stage(config):
    """(bytes, operations) of one frame's census stage."""
    n_bytes = 2 * 4 * roofline.pixels(config) + roofline.volume_bytes(config)
    return n_bytes, OPS_PER_WORD * words(config) * roofline.entries(config)


def read(run):
    return roofline.share(run, KERNELS, *stage(run.config))
