"""Fiat-Shamir oracles rho_0 / rho_1 (host side).

    rho_b(a_1, .., a_n) = Fr::from_le_bytes_mod_order(
        SHA3-256( ser(a_1) || ... || ser(a_n) || (b as u32).to_le_bytes() ))

The domain tag is APPENDED, as in the reference code.
"""

from __future__ import annotations

import hashlib

from halo_accumulation_tpu_torch import fields


def _rho(tag: int, parts) -> int:
    h = hashlib.sha3_256()
    for p in parts:
        h.update(p)
    h.update(tag.to_bytes(4, "little"))
    return int.from_bytes(h.digest(), "little") % fields.R


def rho_0(*parts: bytes) -> int:
    return _rho(0, parts)


def rho_1(*parts: bytes) -> int:
    return _rho(1, parts)
