"""Fiat-Shamir oracles rho_0 / rho_1 (host side).

    rho_b(a_1, .., a_n) = Fr::from_le_bytes_mod_order(
        SHA3-256( ser(a_1) || ... || ser(a_n) || (b as u32).to_le_bytes() ))

The domain tag is APPENDED, as in the reference code.
"""

from __future__ import annotations

import hashlib

from halo_accumulation_tpu_torch import fields
from halo_accumulation_tpu_torch.utils import serialize as ser


def from_le_bytes_mod_order(b: bytes) -> int:
    """ark-ff PrimeField::from_le_bytes_mod_order for Fr."""
    return int.from_bytes(b, "little") % fields.R


def _rho(tag: int, parts) -> int:
    h = hashlib.sha3_256()
    for p in parts:
        h.update(p)
    h.update(tag.to_bytes(4, "little"))
    return from_le_bytes_mod_order(h.digest())


def rho_0(*parts: bytes) -> int:
    return _rho(0, parts)


def rho_1(*parts: bytes) -> int:
    return _rho(1, parts)


def rho_0_scalar_point_point(xi: int, L, R) -> int:
    """xi_next = rho_0(xi_i, L_i, R_i), a fold round's challenge."""
    return rho_0(ser.ser_scalar(xi), ser.ser_point(L), ser.ser_point(R))
