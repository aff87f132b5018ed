"""setup_s (every cell): process start to the window's start: kernels
loaded (built on a checkout's first run), weights, corpus and index made,
the pool sized, and the mix's warm-up traffic served."""


def read(run):
    return run.setup_s
