"""pairs_per_s: pairs whose disparity reached host memory, over the whole
window: from its opening to the moment the last pair sent in it was back."""


def read(run):
    return run.window.done / run.window.seconds
