"""Host-side Pasta constants and the pure-Python (int) field/curve oracle.

The same constants and the same slow, exact arithmetic as
`halo_accumulation_tpu/fields.py`: the Pasta base/scalar primes, the Pallas
curve y^2 = x^3 + 5 over Fq with the ark-pallas 0.5 generator (-1, 2), and
affine add / double-and-add / MSM on Python ints.  Protocol code uses it for
single-point transcript arithmetic; tests hold the tensor code against it.
"""

from __future__ import annotations

# Base field of the Pallas curve (coordinates live here).
Q = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
# Scalar field of the Pallas curve (= base field of Vesta).
R = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# Both primes are 2^254 + C with C < 2^126: the limb code folds bit 255
# back in as 2^255 = -2C (mod p) (see ops/field.py).
C_Q = Q - (1 << 254)
C_R = R - (1 << 254)
assert C_Q < (1 << 126) and C_R < (1 << 126)

B_COEFF = 5
G_X = Q - 1
G_Y = 2

INF = None  # the point at infinity in affine form


def inv_mod(a: int, p: int) -> int:
    return pow(a, -1, p)


def sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli-Shanks square root mod an odd prime p; None for a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


def on_curve(P) -> bool:
    """Whether P (None or (x, y)) lies on y^2 = x^3 + 5."""
    if P is INF:
        return True
    x, y = P
    return (y * y - (x * x * x + B_COEFF)) % Q == 0


def p_add(P, Qp):
    """Affine addition."""
    if P is INF:
        return Qp
    if Qp is INF:
        return P
    x1, y1 = P
    x2, y2 = Qp
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return INF
        lam = (3 * x1 * x1) * inv_mod(2 * y1, Q) % Q
    else:
        lam = (y2 - y1) * inv_mod(x2 - x1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def p_neg(P):
    if P is INF:
        return INF
    x, y = P
    return (x, (-y) % Q)


def p_mul(k: int, P):
    """Affine scalar multiplication, double-and-add."""
    k %= R
    acc = INF
    while k:
        if k & 1:
            acc = p_add(acc, P)
        P = p_add(P, P)
        k >>= 1
    return acc


def p_msm(scalars, points):
    acc = INF
    for s, P in zip(scalars, points):
        acc = p_add(acc, p_mul(s, P))
    return acc


# arkworks keeps a field element in Montgomery form, a R mod p with R = 2^256
ARK_MONT_R = 1 << 256


def from_ark_montgomery(limbs64, p: int) -> int:
    """An arkworks BigInt([u64; 4]) in Montgomery form (least significant
    word first) -> its value mod p."""
    v = 0
    for i, w in enumerate(limbs64):
        v |= int(w) << (64 * i)
    return v * inv_mod(ARK_MONT_R % p, p) % p
