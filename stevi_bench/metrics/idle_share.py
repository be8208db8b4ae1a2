"""idle_share.<cells>: the % of the traced segment's wall time in which no
kernel, memcpy or memset ran on the device (1 - the union of the device
intervals over the segment)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
