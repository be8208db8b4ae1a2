"""host_ms.<cells>: the host's milliseconds inside the entry call (no
synchronisation), the mean over every frame of the untraced window."""


def read(run):
    t = run.window.host_entry
    return 1e3 * sum(t) / len(t) if t else None
