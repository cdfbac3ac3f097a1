"""Host-side single-point group operations.

The protocol layers do a handful of single-point operations per transcript
step (C' = C + a*C_bar - w'*S, C_bar = C + w*S, ...).  They run on the host
through the pure-Python oracle; a native binding is later work.
"""

from __future__ import annotations

from halo_accumulation_tpu_torch import fields as F


def p_add(P, Q):
    return F.p_add(P, Q)


def p_mul(k: int, P):
    return F.p_mul(k, P)


def p_neg(P):
    return F.p_neg(P)


def p_msm(scalars, points):
    return F.p_msm(scalars, points)
