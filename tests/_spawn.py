"""One deadline for the ranks a test spawns.

    with join_all(ctxs, seconds):
        ...  # the parent's own work while the ranks run

joins every torch.multiprocessing spawn context in ctxs when the block
ends, against a single deadline counted from the call.  Past the deadline
it terminates every rank still alive and fails the test naming them; if
the block or a rank raises, it terminates the ranks of every context
first, so no rank outlives its test."""

import time

import pytest


class join_all:
    def __init__(self, ctxs, seconds: float):
        self.ctxs = list(ctxs)
        self.seconds = seconds
        self.deadline = time.monotonic() + seconds

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is not None:
            self.terminate()
            return
        try:
            for ctx in self.ctxs:
                while not ctx.join(timeout=max(0.0, self.deadline - time.monotonic())):
                    if time.monotonic() >= self.deadline:
                        alive = [f"world {len(c.processes)} ranks {r}" for c in self.ctxs
                                 if (r := [i for i, p in enumerate(c.processes) if p.is_alive()])]
                        pytest.fail(f"spawned ranks still alive after {self.seconds} s: {'; '.join(alive)}")
        except BaseException:
            self.terminate()
            raise

    def terminate(self) -> None:
        procs = [p for ctx in self.ctxs for p in ctx.processes]
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
