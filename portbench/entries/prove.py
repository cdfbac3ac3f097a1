"""prove: one IVC step a request, chain.random_instance(rng, d, pp) and then
acc.prover(rng, d, [prev.to_instance(), q], pp) on the previous step's
accumulator, rng = numpy.random.default_rng(seed).  Set-up runs the first
`warm_steps` steps untimed (step 0 accumulates [q] alone, step 1 [acc, q]),
so both shapes are warm.

Judged after the window: every step, set-up's included, as the program
serialized it (chain.step_records), read by the reference's own parser,
must pass the reference's accumulation verifier and decider, and each
step's first instance must be the previous accumulator.
"""

from __future__ import annotations

import time

import torch

from portbench.reference import chainfile, protocol


class Entry:
    def __init__(self, cell):
        self.cell = cell
        self.units = 1
        self.d = cell.config["urs_n"] - 1
        self.urs = protocol.Urs(cell.config["urs_n"])
        self.steps = []

    def setup(self) -> None:
        import numpy as np

        from halo_accumulation_tpu_torch import acc as acc_mod, chain, pp as pp_mod

        self.acc, self.chain_mod = acc_mod, chain
        self.rng = np.random.default_rng(self.cell.seed)
        t0 = time.perf_counter()
        self.pp = pp_mod.generate(self.cell.config["urs_n"], self.cell.device)
        t1 = time.perf_counter()
        self.prev = None
        for _ in range(self.cell.mix["warm_steps"]):
            _, s = self.request(-1)
            if not isinstance(s, int):
                raise RuntimeError(f"a set-up step failed: {s}")
        self.setup_parts = [("of which the URS on the card (with the card's context)", t1 - t0),
                            ("of which the set-up steps", time.perf_counter() - t1)]

    def request(self, i: int):
        try:
            q = self.chain_mod.random_instance(self.rng, self.d, self.pp)
            qs = [self.prev.to_instance(), q] if self.prev is not None else [q]
            acc = self.acc.prover(self.rng, self.d, qs, self.pp)
        except Exception as e:  # a crash is an answer too, and a wrong one
            return "step", f"error: {type(e).__name__}: {e}"
        if self.cell.device != "cpu":
            torch.cuda.synchronize()
        self.prev = acc
        self.steps.append((qs, acc))
        return "step", len(self.steps) - 1

    def release(self) -> None:
        self.pp = self.rng = None

    def judge(self, records) -> list:
        """[(request index or "set-up step s", what the program gave, the
        reference's outcome)] for every step the reference does not accept
        and every request that raised."""
        recs = self.chain_mod.step_records([qs for qs, _ in self.steps], [a for _, a in self.steps])
        raw = chainfile.MAGIC + self.d.to_bytes(8, "little") + len(recs).to_bytes(8, "little") + b"".join(recs)
        ch = chainfile.parse(raw)
        ref = protocol.Reference(self.urs)
        verdict = []
        for s, (qs, acc) in enumerate(zip(ch.qss, ch.accs)):
            out = protocol.outcome(ref.verifier, self.d, qs, acc, raw)
            if s and out == "accept":
                prev, q0 = ch.accs[s - 1], qs[0]
                n = q0.span[1] - q0.span[0]
                if raw[q0.span[0] : q0.span[1]] != raw[prev.span[0] : prev.span[0] + n]:
                    out = f"reject: step {s}'s first instance is not step {s - 1}'s accumulator"
            verdict.append(out)
        bad = []
        warm = len(self.steps) - sum(isinstance(s, int) for _, s in records)
        for s in range(warm):
            if verdict[s] != "accept":
                bad.append((f"set-up step {s}", "a step", verdict[s]))
        for i, (_, s) in enumerate(records):
            if not isinstance(s, int):
                bad.append((i, s, "accept"))
            elif verdict[s] != "accept":
                bad.append((i, "a step", verdict[s]))
        return bad
