"""setup_s: seconds from the start of the process until the window opens
(the kernel build on a checkout's first run, the imports, the CUDA context,
the pool of pairs and the warm-up frames)."""


def read(run):
    return run.setup_s
