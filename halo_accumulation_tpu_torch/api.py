"""Stable user-facing API: the verbs of the JAX package's `api.py` (setup,
commit, open, succinct_check, check, accumulate, verify, decide), with the
same names and signatures, over the port's protocol modules.

`setup` alone takes an optional `device`: without one the URS, and every
call on it after, lives on the card, as `pp.get_pp(n)` does; name "cpu"
to run on the CPU."""

from __future__ import annotations

import numpy as np

from halo_accumulation_tpu_torch import acc as _acc
from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch import pcdl as _pcdl
from halo_accumulation_tpu_torch import pp as _pp

Instance = _acc.Instance
Accumulator = _acc.Accumulator
EvalProof = _pcdl.EvalProof
HPoly = _pcdl.HPoly
PublicParams = _pp.PublicParams


def setup(n: int, device=None) -> PublicParams:
    """The URS supporting degrees d <= n - 1, on `device` (the card by
    default)."""
    return _pp.get_pp(n, device)


def eval_poly(coeffs, z: int) -> int:
    """Host evaluation of a coefficient list at z (low-to-high order)."""
    zp, v = 1, 0
    for c in coeffs:
        v = (v + c * zp) % F.R
        zp = zp * z % F.R
    return v


def commit(coeffs, d: int, w: int | None, pp: PublicParams):
    return _pcdl.commit(coeffs, d, w, pp)


def open(rng: np.random.Generator, coeffs, C, d: int, z: int, w: int | None, pp: PublicParams):
    return _pcdl.open_(rng, coeffs, C, d, z, w, pp)


def succinct_check(C, d: int, z: int, v: int, pi: EvalProof, pp: PublicParams):
    return _pcdl.succinct_check(C, d, z, v, pi, pp)


def check(C, d: int, z: int, v: int, pi: EvalProof, pp: PublicParams):
    return _pcdl.check(C, d, z, v, pi, pp)


def accumulate(rng: np.random.Generator, d: int, qs: list[Instance], pp: PublicParams) -> Accumulator:
    return _acc.prover(rng, d, qs, pp)


def verify(D: int, qs: list[Instance], acc: Accumulator, pp: PublicParams):
    return _acc.verifier(D, qs, acc, pp)


def decide(acc: Accumulator, pp: PublicParams):
    return _acc.decider(acc, pp)


def verify_chain(D: int, qss, accs, pp: PublicParams):
    return _acc.verify_chain(D, qss, accs, pp)
