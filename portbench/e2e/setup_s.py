"""setup_s: process start to the first timed request: imports, the CUDA
context, the kernels' build or load, the URS on the card, the chains
parsed, and each input's warm-up call (graph capture included)."""


def read(w):
    return w.setup_s
