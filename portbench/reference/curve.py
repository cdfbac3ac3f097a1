"""The Pallas curve on plain Python ints: the benchmark's own arithmetic.

    y^2 = x^3 + 5 over F_q, generator (q - 1, 2), group order r.

Points are None (the identity) or affine (x, y); the sums work in Jacobian
coordinates (X, Y, Z), x = X / Z^2, y = Y / Z^3, and come back to affine
with one inversion.  Nothing here imports the program under test.
"""

from __future__ import annotations

Q = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
R = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
B = 5
G = (Q - 1, 2)

_ZERO = (1, 1, 0)  # the identity in Jacobian coordinates


def _jac(P):
    return _ZERO if P is None else (P[0], P[1], 1)


def _affine(J):
    X, Y, Z = J
    if Z % Q == 0:
        return None
    zi = pow(Z, -1, Q)
    zi2 = zi * zi % Q
    return (X * zi2 % Q, Y * zi2 * zi % Q)


def _dbl(J):
    X, Y, Z = J
    if Z == 0 or Y == 0:
        return _ZERO
    A = X * X % Q
    Bq = Y * Y % Q
    C = Bq * Bq % Q
    D = 2 * ((X + Bq) * (X + Bq) - A - C) % Q
    E = 3 * A % Q
    X3 = (E * E - 2 * D) % Q
    return (X3, (E * (D - X3) - 8 * C) % Q, 2 * Y * Z % Q)


def _add(J1, J2):
    X1, Y1, Z1 = J1
    X2, Y2, Z2 = J2
    if Z1 == 0:
        return J2
    if Z2 == 0:
        return J1
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    H = (U2 - U1) % Q
    Rr = (S2 - S1) % Q
    if H == 0:
        return _dbl(J1) if Rr == 0 else _ZERO
    H2 = H * H % Q
    H3 = H * H2 % Q
    V = U1 * H2 % Q
    X3 = (Rr * Rr - H3 - 2 * V) % Q
    return (X3, (Rr * (V - X3) - S1 * H3) % Q, H * Z1 * Z2 % Q)


def add(P, Qp):
    return _affine(_add(_jac(P), _jac(Qp)))


def neg(P):
    return None if P is None else (P[0], (-P[1]) % Q)


def msm(scalars, points):
    """sum_i scalars[i] * points[i]: interleaved 4-bit windows over all the
    points (Straus), 64 windows of four doublings."""
    pairs = [(s % R, _jac(P)) for s, P in zip(scalars, points) if s % R and P is not None]
    if not pairs:
        return None
    tables = []
    for _, J in pairs:
        t = [_ZERO, J]
        for _ in range(14):
            t.append(_add(t[-1], J))
        tables.append(t)
    acc = _ZERO
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = _dbl(acc)
        sh = 4 * w
        for (s, _), t in zip(pairs, tables):
            digit = (s >> sh) & 15
            if digit:
                acc = _add(acc, t[digit])
    return _affine(acc)


def mul(k: int, P):
    return msm([k], [P])


def on_curve(P) -> bool:
    return P is None or (P[1] * P[1] - P[0] ** 3 - B) % Q == 0


# -- square roots mod q (q - 1 = 2^32 t, t odd): Tonelli-Shanks ---------------

_S = 32
_T = (Q - 1) >> _S
assert _T & 1 and _T << _S == Q - 1


def _nonresidue() -> int:
    z = 2
    while pow(z, (Q - 1) // 2, Q) != Q - 1:
        z += 1
    return z


_ROOT = pow(_nonresidue(), _T, Q)  # a primitive 2^32-th root of unity


def sqrt(a: int) -> int | None:
    """A square root of a mod q, or None for a non-residue."""
    a %= Q
    if a == 0:
        return 0
    m, c, t, x = _S, _ROOT, pow(a, _T, Q), pow(a, (_T + 1) // 2, Q)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % Q
            i += 1
            if i == m:
                return None
        b = pow(c, 1 << (m - i - 1), Q)
        m, c = i, b * b % Q
        t, x = t * c % Q, x * b % Q
    return x


# -- ark-serialize 0.5 compressed points: x's 32 LE bytes, flags in byte 32 ---

POINT_BYTES = 33
_INFINITY_FLAG = 0x40
_Y_LARGER_FLAG = 0x80


def compress(P) -> bytes:
    if P is None:
        return bytes(32) + bytes([_INFINITY_FLAG])
    x, y = P
    b = bytearray(x.to_bytes(POINT_BYTES, "little"))
    if y > Q - y:
        b[32] |= _Y_LARGER_FLAG
    return bytes(b)


def decompress(b: bytes):
    """The point of a 33-byte encoding; ValueError when x is off the curve."""
    if len(b) != POINT_BYTES:
        raise ValueError(f"a point takes {POINT_BYTES} bytes, got {len(b)}")
    if b[32] & _INFINITY_FLAG:
        return None
    x = int.from_bytes(bytes(b[:32]) + bytes([b[32] & 0x3F]), "little")
    y = sqrt(x * x * x + B)
    if y is None:
        raise ValueError("x is not on the curve")
    lo, hi = min(y, Q - y), max(y, Q - y)
    return (x, hi if b[32] & _Y_LARGER_FLAG else lo)
