"""What the cells over a committed chain share: the valid chain and its
tampered copies, each one input the program is asked about, and the
reference's outcome for each.

An entry (entries/decide.py, entries/verify.py) names the program's call
and the reference's; this class makes the inputs, warms each up, runs a
request, and judges the outcomes after the window.
"""

from __future__ import annotations

import time

import torch

from portbench import generator, tamper
from portbench.reference import chainfile, protocol


def program_outcome(fn, *args) -> str:
    """The program's answer in the reference's words: "accept", "reject:
    <text>", or "error: ..." for anything else it raised."""
    try:
        fn(*args)
    except ValueError as e:
        return f"reject: {e}"
    except AssertionError:
        return "error: AssertionError"
    except Exception as e:  # a crash is an answer too, and a wrong one
        return f"error: {type(e).__name__}: {e}"
    return "accept"


class ChainCell:
    """Subclasses set `program(accs)` (the program's call on the chain
    with these accumulators: returns, or raises on reject),
    `reference(ref, chain)` (the reference's: returns, or raises Reject)
    and `units`, the work a request completes."""

    def __init__(self, cell):
        self.cell = cell
        self.path = cell.root / cell.config["chains"][cell.mix["chain"]]
        self.chain = chainfile.read(self.path)
        self.stream, rng = generator.stream(cell.mix, cell.seed, len(self.chain.accs))
        self.urs = protocol.Urs(cell.config["urs_n"])
        self.raws = {generator.VALID: self.chain.raw}
        for key in self.stream.inputs:
            kind, position = generator.parse_name(key)
            self.raws[key] = tamper.tamper(self.chain, kind, rng, self.urs, position)
        self.units = 1

    # -- the program's side ---------------------------------------------------

    def setup(self) -> None:
        """The URS on the card, the chain read by the program, one input per
        key (the program's own parser reads each tampered accumulator), and
        the valid input run twice and one input of each kind once, to build,
        load and capture what its path runs (a kind's inputs differ only in
        which accumulator and round they change: the same shapes)."""
        from halo_accumulation_tpu_torch import acc as acc_mod, chain, pp as pp_mod

        t = [time.perf_counter()]
        self.acc = acc_mod
        self.pp = pp_mod.generate(self.cell.config["urs_n"], self.cell.device)
        t.append(time.perf_counter())
        self.d, self.qss, accs = chain.load_chain(self.path)
        self.inputs = {generator.VALID: accs}
        for key in self.stream.inputs:
            position = generator.parse_name(key)[1]
            lo, hi = self.chain.accs[position].span
            self.inputs[key] = accs[:position] + [acc_mod.deserialize_accumulator(self.raws[key][lo:hi])] + accs[position + 1:]
        t.append(time.perf_counter())
        first_of_kind = {generator.parse_name(k)[0]: k for k in reversed(self.stream.inputs)}
        for key in [generator.VALID, generator.VALID] + list(first_of_kind.values()):
            self.call(key)
        t.append(time.perf_counter())
        self.setup_parts = [(f"of which {label}", b - a) for label, a, b in zip(
            ("the URS on the card (with the card's context)", "the program's parse of the chain",
             "the warm-up calls"), t, t[1:])]

    def call(self, key: str) -> str:
        out = program_outcome(self.program, self.inputs[key])
        if self.cell.device != "cpu":
            torch.cuda.synchronize()
        return out

    def request(self, i: int):
        key = self.stream.key(i)
        return key, self.call(key)

    def release(self) -> None:
        self.pp = self.qss = self.inputs = None

    # -- the reference's side -------------------------------------------------

    def expected(self, keys) -> dict:
        ref = protocol.Reference(self.urs)
        out = {}
        for key in keys:
            ch = chainfile.parse(self.raws[key])
            out[key] = protocol.outcome(self.reference, ref, ch)
        return out

    def judge(self, records) -> list:
        """[(request index, the program's outcome, the reference's)] for
        every request whose outcome differs."""
        want = self.expected(sorted({k for k, _ in records}))
        return [(i, got, want[key]) for i, (key, got) in enumerate(records) if got != want[key]]
