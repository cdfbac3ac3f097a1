"""ark-serialize 0.5 compressed encodings (host side).

Byte-for-byte the layouts of `halo_accumulation_tpu/utils/serialize.py`:

  * Fp/Fr: 32-byte little-endian canonical integer.
  * Compressed affine point: 33 bytes, the x-coordinate's 32 LE bytes plus
    one byte whose top bits are the SWFlags (bit 6 = infinity, x written as
    0; bit 7 = y is the larger root).
  * Vec<T>: u64 LE length + items; Option<T>: tag byte 0/1 + payload.
"""

from __future__ import annotations

import hashlib

from halo_accumulation_tpu_torch import fields

SW_INFINITY = 0x40
SW_Y_NEG = 0x80
POINT_BYTES = 33


def ser_scalar(v: int) -> bytes:
    return (v % fields.R).to_bytes(32, "little")


def ser_base(v: int) -> bytes:
    """Fq canonical 32-byte LE."""
    return (v % fields.Q).to_bytes(32, "little")


def ser_point(P) -> bytes:
    """Compressed affine point; P is None (infinity) or (x, y)."""
    if P is None:
        b = bytearray(POINT_BYTES)
        b[32] |= SW_INFINITY
        return bytes(b)
    x, y = P[0] % fields.Q, P[1] % fields.Q
    b = bytearray(x.to_bytes(POINT_BYTES, "little"))
    if y > fields.Q - y:
        b[32] |= SW_Y_NEG
    return bytes(b)


def deser_point(b: bytes):
    """Inverse of ser_point: None or (x, y).  Raises ValueError off-curve
    and, as the JAX package asserts, AssertionError unless b is 33 bytes."""
    if len(b) != POINT_BYTES:
        raise AssertionError
    flags = b[32] & 0xC0
    if flags & SW_INFINITY:
        return None
    x = int.from_bytes(bytes(b[:32]) + bytes([b[32] & 0x3F]), "little")
    rhs = (pow(x, 3, fields.Q) + fields.B_COEFF) % fields.Q
    y = fields.sqrt_mod(rhs, fields.Q)
    if y is None:
        raise ValueError("x is not on the curve")
    neg = fields.Q - y
    y_big, y_small = max(y, neg), min(y, neg)
    return (x, y_big if flags & SW_Y_NEG else y_small)


def ser_u64(n: int) -> bytes:
    return int(n).to_bytes(8, "little")


def ser_vec(items: list[bytes]) -> bytes:
    return ser_u64(len(items)) + b"".join(items)


def ser_option(item: bytes | None) -> bytes:
    return b"\x00" if item is None else b"\x01" + item


def ser_scalar_vec(vs) -> bytes:
    return ser_vec([ser_scalar(v) for v in vs])


def ser_poly(coeffs) -> bytes:
    """ark-poly DensePolynomial { coeffs: Vec<F> }."""
    return ser_scalar_vec(coeffs)


def sha3_256(data: bytes) -> bytes:
    return hashlib.sha3_256(data).digest()
