"""Host-side single-point group operations: the native C++ backend where it
builds, the pure-Python oracle otherwise.

The protocol layers do a handful of single-point operations per transcript
step (C' = C + a*C_bar - w'*S, C_bar = C + w*S, H' = xi_0*H, ...).  They
are latency-bound and run on the host, as in the JAX package's hostops.py:
the native backend (Jacobian coordinates) multiplies a point by a 255-bit
scalar with no inversion until the end, where the oracle's affine
double-and-add inverts once per add.
"""

from __future__ import annotations

from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch import native

_use_native = None


def use_native() -> bool:
    global _use_native
    if _use_native is None:
        _use_native = native.available()
    return _use_native


def p_add(P, Q):
    if use_native():
        return native.point_add(P, Q)
    return F.p_add(P, Q)


def p_mul(k: int, P):
    if use_native():
        return native.scalar_mul(k % F.R, P)
    return F.p_mul(k, P)


def p_neg(P):
    return F.p_neg(P)


def p_msm(scalars, points):
    if use_native():
        return native.msm([s % F.R for s in scalars], points)
    return F.p_msm(scalars, points)
