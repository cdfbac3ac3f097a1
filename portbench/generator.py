"""The one request generator: a traffic mix (a data file under traffic/)
and a seed give the request stream.

A mix's keys, besides those its entry reads (entry: the file under
entries/ whose call each request makes; chain: which of the
configuration's chains; warm_steps):
  loop           "closed": one client sends its next request when the last
                 one has come back (the only loop this generator makes)
  clients        1
  tamper_every   every tamper_every-th request, at an offset the seed picks,
                 carries a tampered input (0: none); the rest are the valid
                 input
  tamper_kinds   the kinds of tampered input, taken in turn from a point the
                 seed picks, so every window holds each kind in the same
                 share whatever the seed
  tamper_inputs  how many distinct tampered inputs a run makes, a multiple
                 of the kinds (default: one a kind); the tampered requests
                 cycle through them
  tamper_at      which accumulator of the chain a tampered input changes:
                 "last", or "any" (default): a kind's m inputs take one
                 position each from m equal strata of the chain, drawn and
                 put in an order by the seed, so every kind's tampered
                 requests reach across the whole batch in every run

Request i is named by its input: "valid", or "<kind>@<position>".  Each
tampered input's choices (its position, a round of the proof) come from
the seed, once a run, so a run holds a fixed set of distinct inputs.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

VALID = "valid"


def name(kind: str, position: int) -> str:
    return f"{kind}@{position}"


def parse_name(key: str) -> tuple[str, int]:
    """(kind, position) of a tampered input's name."""
    kind, position = key.rsplit("@", 1)
    return kind, int(position)


@dataclass
class Stream:
    tamper_every: int
    offset: int
    inputs: list  # the tampered inputs' names, in the order the stream sends them

    def key(self, i: int) -> str:
        """The input of request i."""
        if not self.tamper_every or i % self.tamper_every != self.offset:
            return VALID
        return self.inputs[(i // self.tamper_every) % len(self.inputs)]


def _positions(at: str, count: int, depth: int, rng: random.Random) -> list:
    if at == "last":
        return [depth - 1] * count
    if at != "any":
        raise ValueError(f"tamper_at is 'any' or 'last', not {at!r}")
    out = []
    for j in range(count):
        lo = j * depth // count
        out.append(rng.randrange(lo, max((j + 1) * depth // count, lo + 1)))
    rng.shuffle(out)
    return out


def stream(mix: dict, seed: int, depth: int = 1) -> tuple[Stream, random.Random]:
    """The request stream of a mix under a seed over a chain of `depth`
    accumulators, and the seeded generator that then picks each tampered
    input's round."""
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError(f"this generator makes a closed loop of one client, not {mix}")
    rng = random.Random(seed)
    every = int(mix.get("tamper_every", 0))
    kinds = list(mix.get("tamper_kinds", [])) if every else []
    if every and not kinds:
        raise ValueError("tamper_every needs tamper_kinds")
    offset = rng.randrange(every) if every else 0
    if not kinds:
        return Stream(every, offset, []), rng
    first = rng.randrange(len(kinds))
    count = int(mix.get("tamper_inputs", len(kinds)))
    if count % len(kinds):
        raise ValueError(f"tamper_inputs ({count}) is not a multiple of the {len(kinds)} kinds")
    per_kind = [_positions(mix.get("tamper_at", "any"), count // len(kinds), depth, rng) for _ in kinds]
    inputs = [name(kinds[(first + j) % len(kinds)], per_kind[j % len(kinds)][j // len(kinds)]) for j in range(count)]
    if len(set(inputs)) != count:
        raise ValueError(f"{count} tampered inputs over {depth} accumulators repeat one: {inputs}")
    return Stream(every, offset, inputs), rng
