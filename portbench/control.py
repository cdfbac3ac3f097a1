"""The control that `correct` has to fail: the program's place taken by
something that breaks one guarantee the configurations state, the step
that would tempt a faster program.

Chain cells (decide, verify): every verdict is exact.  The control is the
reference's decider without its n-point MSM (U == CM.Commit(ck, h)), most
of a decider's device work.  It accepts the cU tamper (tamper.py), whose
succinct row holds, and so differs from the reference on every cU request.

The prover cell: every step's accumulator passes the verifier and the
decider.  The control is the program's prover without its opening proof
(pcdl.open_, about half a step): the accumulator carries its fresh
instance's proof, which the reference's decider rejects.

    python3 -m portbench.control --workload NAME --seeds 1,2,3 [--seconds S]

runs the cell with the control in the program's place, one run a seed in
this process, and prints each run's result line (`correct` must be false).
"""

from __future__ import annotations

import argparse
import json
import sys
import types

from portbench.reference import chainfile, curve, protocol


class WithoutDeferred(protocol.Reference):
    """The reference, trusting every U."""

    def deferred(self, cl, xis) -> bool:
        return True


def plant(entry) -> None:
    """Answer the entry's requests by the control instead of the program."""
    if not hasattr(entry, "raws"):
        return _plant_prover(entry)
    ctl = WithoutDeferred(entry.urs)

    def call(key: str) -> str:
        return protocol.outcome(entry.reference, ctl, chainfile.parse(entry.raws[key]))

    entry.call = call


def _plant_prover(entry) -> None:
    """After the untimed set-up steps, acc.prover without its open."""
    setup = entry.setup

    def setup_then_plant():
        setup()
        real = entry.acc

        def prover(rng, d, qs, pp):
            h_0 = [int.from_bytes(rng.bytes(40), "little") % curve.R for _ in range(2)]
            w = int.from_bytes(rng.bytes(40), "little") % curve.R
            pi_V = real.AccumulatorHiding(h=h_0, U=real.pcdl.commit(h_0, d, None, pp), w=w)
            C_bar, d, z, hs = real.common_subroutine(d, qs, pi_V, pp)
            return real.Accumulator(C_bar=C_bar, d=d, z=z, v=hs.eval(z), pi=qs[-1].pi, pi_V=pi_V)

        entry.acc = types.SimpleNamespace(prover=prover)

    entry.setup = setup_then_plant


def main(argv=None) -> int:
    from portbench import run

    ap = argparse.ArgumentParser(description="the control of a chain cell, on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    a = ap.parse_args(argv)
    rc = 0
    for seed in a.seeds.split(","):
        res, _ = run.run(a.workload, int(seed), a.seconds, False, plant=plant)
        rc |= int(res["correct"])
        print(json.dumps({"control": "reference without the deferred MSM", "workload": a.workload,
                          "seed": int(seed), **res}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
