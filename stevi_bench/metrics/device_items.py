"""device_items.<cells>: kernels, memcpys and memsets on the device a frame,
in the traced segment."""


def read(run):
    tr = run.trace
    if tr is None or not tr.frames or not tr.device:
        return None
    return len(tr.device) / tr.frames
