"""prove_steps_per_s: IVC steps (random_instance, then acc.prover on the
previous accumulator) completed in the window, over its seconds."""


def read(w):
    return w.requests / w.seconds
