"""decide_claims_per_s: claims whose verdict came back in the window, over
the window's seconds (a request decides every claim of its chain)."""


def read(w):
    return w.units / w.seconds
