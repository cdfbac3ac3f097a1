"""verify_chains_per_s: chain verifications completed in the window, over
the window's seconds."""


def read(w):
    return w.requests / w.seconds
