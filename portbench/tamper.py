"""Tampered copies of a chain: one step's accumulator with one field
changed, in the file's bytes, so the program and the reference read the
same input.

Kinds:
  v   the claimed value v + 1
  L   round i's L negated (i from the seed)
  R   round i's R negated (i from the seed)
  U   the final basis point U negated
  cU  c doubled and U replaced by (U - T) / 2, T = h(z) xi_0 H: the
      succinct check's row still holds (c' (U' + T) = c (U + T)), so only
      the decider's n-point MSM (U == CM.Commit(ck, h)) rejects it
"""

from __future__ import annotations

import random

from portbench.reference import chainfile, curve, protocol

KINDS = ("v", "L", "R", "U", "cU")


def _put(raw: bytearray, at: tuple, data: bytes) -> None:
    off, n = at
    assert len(data) == n
    raw[off : off + n] = data


def tamper(ch: chainfile.Chain, kind: str, rng: random.Random, urs: protocol.Urs, position: int = -1) -> bytes:
    """ch's bytes with the field `kind` of the accumulator at `position`
    (default the last) changed."""
    acc = ch.accs[position]
    pi = acc.pi
    raw = bytearray(ch.raw)
    if kind == "v":
        _put(raw, acc.at["v"], protocol.ser_scalar(acc.v + 1))
    elif kind in ("L", "R"):
        i = rng.randrange(len(pi.Ls))
        old = (pi.Ls if kind == "L" else pi.Rs)[i]
        _put(raw, pi.at[kind][i], curve.compress(curve.neg(chainfile.point(old))))
    elif kind == "U":
        _put(raw, pi.at["U"], curve.compress(curve.neg(chainfile.point(pi.U))))
    elif kind == "cU":
        ok, xis = protocol.Reference(urs).succinct(acc, b"")
        if not ok:
            raise ValueError("the cU tamper starts from a claim whose row holds")
        T = curve.mul(protocol.h_eval(xis, acc.z) * xis[0], urs.H)
        half = pow(2, -1, curve.R)
        U2 = curve.mul(half, curve.add(chainfile.point(pi.U), curve.neg(T)))
        _put(raw, pi.at["U"], curve.compress(U2))
        _put(raw, pi.at["c"], protocol.ser_scalar(2 * pi.c))
    else:
        raise ValueError(f"unknown tamper kind {kind!r}; kinds: {KINDS}")
    return bytes(raw)
