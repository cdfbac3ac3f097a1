"""A word-level model of the CUDA kernels' Fq arithmetic (csrc/field.cuh).

The kernels hold a field element as 8 x 32-bit words with the value below
2^255 and multiply pseudo-Mersenne style (2^256 == -4c mod q).  The model
below takes field.cuh's steps one for one: the same words, the same rows of
products, the same fold constants, the same signed carries and the same
finish.  It is held to Python's exact `x * y % Q` (and to the sums,
differences and small multiples) on random values and on the edges, to the
port's own limb twins through the int64 boundary (load, operation,
canonical store against FQ.canon), and its constants to literals of
field.cuh.  It also counts the multiply's 32-bit products, the count that
chip_smoke.py reports as IMPL_MULS_FMUL.  The card test of record is
tests/test_torch_cuda.py, which holds the compiled kernels to the twins.
"""

import pathlib
import random
import re

import numpy as np
import pytest
import torch

import chip_smoke
from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
from halo_accumulation_tpu_torch.ops.field import FQ, FR, L, limb_array_to_ints

FIELD_CUH = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc" / "field.cuh"

Q = F.Q
C = Q - (1 << 254)
M32 = 0xFFFFFFFF
NW = 8
C_WORDS = (0x00000001, 0x992D30ED, 0x094CF91B, 0x224698FC)  # c, word 0 first
C4_WORDS = (0x00000004, 0x64B4C3B4, 0x2533E46E, 0x891A63F0)  # 4c
Q_WORDS = C_WORDS + (0, 0, 0, 0x40000000)
TOP_BOUND = 0x80000000  # the invariant: word 7 below it, the value below 2^255


def to_words(v: int, n: int = NW) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(n)]


def value(ws) -> int:
    return sum(w << (32 * i) for i, w in enumerate(ws))


class Model:
    """field.cuh, step for step, for the modulus p (its Fq instance by
    default; R for the Fr instance); `products` counts the 32 x 32-bit
    products (multiplies by the words 1 of c and 4 of 4c are shifts and not
    counted)."""

    def __init__(self, p: int = Q):
        self.products = 0
        self.p = p
        c = p - (1 << 254)
        self.c_words, self.c4_words = tuple(to_words(c, 4)), tuple(to_words(4 * c, 4))
        self.q_words = tuple(to_words(p))

    def finish(self, x, top):
        assert len(x) == NW and -(1 << 24) < top < (1 << 24)
        f = 4 * top + (x[7] >> 30)
        g = 1 - f if f > 0 else -f
        acc = g  # g times c's word 0, which is 1
        m = [acc & M32]
        acc >>= 32
        for i in range(1, 4):
            self.products += 1
            acc += g * self.c_words[i]
            m.append(acc & M32)
            acc >>= 32
        for _ in range(4, NW):
            m.append(acc & M32)
            acc >>= 32
        m[7] = (m[7] + (g << 30)) & M32
        r, carry = [], 0
        for i in range(NW):
            s = x[i] + m[i] + carry
            r.append(s & M32)
            carry = s >> 32
        assert value(r) == (value(x) + top * (1 << 256) + g * self.p)  # exact, no wrap
        assert r[7] < TOP_BOUND
        return r

    def mul_c4(self, h):
        n = len(h)
        out = [0] * (n + 4)
        for k in range(4):
            carry = 0
            for j in range(n):
                if k:
                    self.products += 1
                s = self.c4_words[k] * h[j] + out[k + j] + carry
                assert s < (1 << 64)
                out[k + j] = s & M32
                carry = s >> 32
            out[k + n] = carry
        return out

    def mul(self, a, b):
        t = [0] * (2 * NW)
        for i in range(NW):
            carry = 0
            for j in range(NW):
                self.products += 1
                s = a[i] * b[j] + t[i + j] + carry
                assert s < (1 << 64)
                t[i + j] = s & M32
                carry = s >> 32
            t[i + NW] = carry
        d = self.mul_c4(t[NW:])
        e = self.mul_c4(d[NW:])
        assert value(e) < (1 << 255)
        x, acc = [], 0
        for i in range(NW):
            acc += t[i] - d[i] + e[i]
            x.append(acc & M32)
            acc >>= 32
        assert acc in (-1, 0, 1)
        return self.finish(x, acc)

    def add(self, a, b):
        x, carry = [], 0
        for i in range(NW):
            s = a[i] + b[i] + carry
            x.append(s & M32)
            carry = s >> 32
        return self.finish(x, carry)

    def sub(self, a, b):
        x, acc = [], 0
        for i in range(NW):
            acc += a[i] - b[i]
            x.append(acc & M32)
            acc >>= 32
        assert acc in (-1, 0)
        return self.finish(x, acc)

    def mul_small(self, a, k):
        assert 0 < k < (1 << 16)
        x, carry = [], 0
        for i in range(NW):
            self.products += 1
            s = a[i] * k + carry
            x.append(s & M32)
            carry = s >> 32
        return self.finish(x, carry)

    def from_chunks(self, c, bits):
        assert (bits * (len(c) - 1)) // 32 < NW
        col = [0] * NW
        for i, ci in enumerate(c):
            col[(bits * i) // 32] += ci << ((bits * i) % 32)
        assert max(col) < (1 << 63)
        x, carry = [], 0
        for j in range(NW):
            s = col[j] + carry
            x.append(s & M32)
            carry = s >> 32
        return self.finish(x, carry)

    def load(self, limbs):
        return self.from_chunks(list(limbs), 15)

    def store(self, a):
        """Canonical 15-bit limbs of a (value below 2^255 < 2q)."""
        d, acc = [], 0
        for i in range(NW):
            acc += a[i] - self.q_words[i]
            d.append(acc & M32)
            acc >>= 32
        w = (a if acc < 0 else d) + [0]
        out = []
        for i in range(L):
            j, off = (15 * i) // 32, (15 * i) % 32
            out.append((((w[j + 1] << 32) | w[j]) >> off) & 0x7FFF)
        return out


def lazy_limbs(v: int, rng) -> list[int]:
    """v as 18 nearly clean limbs (each <= 0x8008): borrow 2^15 from a limb
    into the one below it where that keeps every limb in range."""
    limbs = [(v >> (15 * i)) & 0x7FFF for i in range(L - 1)] + [v >> (15 * (L - 1))]
    for i in range(1, L):
        if limbs[i] > 0 and limbs[i - 1] <= 8 and rng.random() < 0.5:
            limbs[i] -= 1
            limbs[i - 1] += 1 << 15
    assert sum(x << (15 * i) for i, x in enumerate(limbs)) == v
    return limbs


# The edges, as the card's fmul edge lanes (chip_smoke.fmul_edge_limbs): 0,
# 1, q - 1, q, q + 1, 2^254, 2q - 1, 2q, the invariant's top 2^255 - 1, and
# the boundary's lazy maxima, 2^257 - 1 in clean limbs and every limb at
# 0x8008 (the nearly clean bound) with limb 17 at 2.  The word-level ops
# take the edges below 2^255, mul also 2^256 - 1.
EDGE_LIMBS = chip_smoke.fmul_edge_limbs()
EDGE_VALUES = [sum(x << (15 * i) for i, x in enumerate(e)) for e in EDGE_LIMBS]
EDGES = [v for v in EDGE_VALUES if v < (1 << 255)]


def test_constants_are_literals_of_field_cuh():
    """q, c, 4c and the invariant's bound are field.cuh's literals, and
    they are what the model says they are."""
    assert value(C_WORDS) == C and value(C4_WORDS) == 4 * C and value(Q_WORDS) == Q
    src = FIELD_CUH.read_text()
    for w in C_WORDS + C4_WORDS + Q_WORDS[4:] + (TOP_BOUND,):
        assert re.search(rf"\b0x0*{w:x}u?\b", src, re.IGNORECASE), hex(w)
    assert f"{C:#x}" in src


def test_mul_random_and_edges():
    """10^4 random pairs below 2^255, and every pair of edges that the
    invariant admits (mul also takes inputs below 2^256)."""
    m = Model()
    rnd = random.Random(6)
    pairs = [(rnd.getrandbits(255), rnd.getrandbits(255)) for _ in range(10_000)]
    ins = [v for v in EDGE_VALUES if v < (1 << 256)] + [(1 << 256) - 1]
    pairs += [(a, b) for a in ins for b in ins]
    for a, b in pairs:
        r = value(m.mul(to_words(a), to_words(b)))
        assert r < (1 << 255) and r % Q == a * b % Q


def test_add_sub_mul_small_random_and_edges():
    m = Model()
    rnd = random.Random(7)
    vals = [rnd.getrandbits(255) for _ in range(2_000)] + EDGES
    for a, b in zip(vals, vals[1:] + vals[:1]):
        for got, want in ((m.add(to_words(a), to_words(b)), a + b), (m.sub(to_words(a), to_words(b)), a - b),
                          (m.sub(to_words(b), to_words(a)), b - a)):
            assert value(got) < (1 << 255) and value(got) % Q == want % Q
        for k in (3, 8, 15, 4095):
            got = value(m.mul_small(to_words(a), k))
            assert got < (1 << 255) and got % Q == a * k % Q


def test_load_and_canonical_store():
    """The int64 boundary: nearly clean limbs (values below 2^257, random
    and at the edges) load to a value of the invariant, and store writes
    the canonical limbs, FQ.canon's."""
    m = Model()
    rng = np.random.default_rng(8)
    vals = [int.from_bytes(rng.bytes(33), "little") >> 7 for _ in range(500)]
    cases = [lazy_limbs(v, rng) for v in vals] + EDGE_LIMBS
    for limbs in cases:
        v = sum(x << (15 * i) for i, x in enumerate(limbs))
        a = m.load(limbs)
        assert value(a) < (1 << 255) and value(a) % Q == v % Q
        want = FQ.canon(torch.tensor(limbs, dtype=torch.int64).reshape(L, 1))[:, 0].tolist()
        assert m.store(a) == want == [((v % Q) >> (15 * i)) & 0x7FFF for i in range(L)]


def test_packed_affine_load():
    """bucket_masked's 18-lane slots: 30-bit pairs of canonical limbs load
    to the coordinate's value."""
    m = Model()
    rnd = random.Random(9)
    for v in [rnd.randrange(Q) for _ in range(200)] + [0, 1, Q - 1]:
        limbs = [(v >> (15 * i)) & 0x7FFF for i in range(L)]
        pairs = [limbs[2 * k] | (limbs[2 * k + 1] << 15) for k in range(L // 2)]
        assert value(m.from_chunks(pairs, 30)) == v


def test_boundary_ops_equal_canonical_twin():
    """load, mul / add / sub / mul_small, canonical store on lazy limb
    tensors equals FQ.canon of the port's limb twins, lane for lane."""
    m = Model()
    rng = np.random.default_rng(10)
    vals = [int.from_bytes(rng.bytes(33), "little") >> 7 for _ in range(64)]
    a_l = [lazy_limbs(v, rng) for v in vals] + EDGE_LIMBS
    b_l = a_l[3:] + a_l[:3]
    A, B = (torch.tensor(x, dtype=torch.int64).T.contiguous() for x in (a_l, b_l))
    twins = {"mul": FQ.mul(A, B), "add": FQ.add(A, B), "sub": FQ.sub(A, B), "mul_small": FQ.mul_small(A, 15)}
    for op, twin in twins.items():
        want = FQ.canon(twin).T.tolist()
        for j, (x, y) in enumerate(zip(a_l, b_l)):
            a, b = m.load(x), m.load(y)
            r = m.mul_small(a, 15) if op == "mul_small" else getattr(m, op)(a, b)
            assert m.store(r) == want[j], (op, j)
    assert limb_array_to_ints(FQ.canon(twins["mul"]).numpy()) == [
        (x * y) % Q for x, y in zip(limb_array_to_ints(A.numpy()), limb_array_to_ints(B.numpy()))
    ]


def test_multiply_counts_match_chip_smoke():
    """The model's products per multiply are chip_smoke's IMPL_MULS_FMUL,
    within 1.25 times the least count (MIN_MULS_FMUL, Montgomery on q's
    words); mul_small and add / sub as IMPL_MULS_PADD counts them."""
    m = Model()
    a, b = to_words(Q - 1), to_words(12345)
    m.mul(a, b)
    assert m.products == chip_smoke.IMPL_MULS_FMUL == 103
    assert chip_smoke.IMPL_MULS_FMUL <= 1.25 * chip_smoke.MIN_MULS_FMUL
    m.products = 0
    m.mul_small(a, 15)
    assert m.products == chip_smoke.IMPL_MULS_SMALL
    m.products = 0
    m.sub(a, b)
    assert m.products == chip_smoke.IMPL_MULS_ADD


def test_least_counts_of_a_double():
    """The bound's least count per doubling prices its two squares at
    s (s + 1) / 2 products plus Montgomery's 24, not as multiplies, and
    stays below what curve.cuh's pdbl issues."""
    assert chip_smoke.MIN_MULS_SQR == 36 + 24 < chip_smoke.MIN_MULS_FMUL == 64 + 24
    assert chip_smoke.MIN_MULS_PDBL == 6 * 88 + 2 * 60 == 648
    assert chip_smoke.MIN_MULS_PDBL < chip_smoke.IMPL_MULS_PDBL


@pytest.mark.parametrize("op", ["padd", "pdbl"])
def test_curve_formulas_on_words_equal_canonical_twin(op):
    """csrc/curve.cuh's padd and pdbl.cu's doubling, run on the model's
    words, store FQ.canon of the twins' limbs."""
    from halo_accumulation_tpu_torch.ops import curve as cv

    m = Model()
    rnd = random.Random(11)
    G = (F.G_X, F.G_Y)
    pts = [F.p_mul(rnd.randrange(1, F.R), G) for _ in range(5)] + [None]
    ps, qs = pts, pts[1:] + pts[:1]
    P, Qv = cv.from_affine_ints(ps), cv.from_affine_ints(qs)
    lam = FQ.from_ints([rnd.randrange(1, Q) for _ in ps])
    P = cv.PointVec(*(FQ.mul(c, lam) for c in P))  # lazy limbs

    def words(X, j):
        return [m.load(c[:, j].tolist()) for c in X]

    if op == "padd":
        want = ck.padd_plain(tuple(P), tuple(Qv))
    else:
        want = ck.pdbl_plain(tuple(P), 2)
    want = [FQ.canon(w).T.tolist() for w in want]
    for j in range(len(ps)):
        x1, y1, z1 = words(P, j)
        if op == "padd":
            x2, y2, z2 = words(Qv, j)
            t0, t1, t2 = m.mul(x1, x2), m.mul(y1, y2), m.mul(z1, z2)
            t3 = m.sub(m.mul(m.add(x1, y1), m.add(x2, y2)), m.add(t0, t1))
            t4 = m.sub(m.mul(m.add(y1, z1), m.add(y2, z2)), m.add(t1, t2))
            w = m.sub(m.mul(m.add(x1, z1), m.add(x2, z2)), m.add(t0, t2))
            t2b, wb = m.mul_small(t2, 15), m.mul_small(w, 15)
            t0b = m.add(m.add(t0, t0), t0)
            z3s, t1b = m.add(t1, t2b), m.sub(t1, t2b)
            out = (m.sub(m.mul(t3, t1b), m.mul(t4, wb)), m.add(m.mul(t1b, z3s), m.mul(wb, t0b)),
                   m.add(m.mul(z3s, t4), m.mul(t0b, t3)))
        else:
            x, y, z = x1, y1, z1
            for _ in range(2):
                t0, t1, zz, xy = m.mul(y, y), m.mul(y, z), m.mul(z, z), m.mul(x, y)
                t2, z38 = m.mul_small(zz, 15), m.mul_small(t0, 8)
                y3s, t0a = m.add(t0, t2), m.sub(t0, m.mul_small(t2, 3))
                x3a, z, y3b, x3b = m.mul(t2, z38), m.mul(t1, z38), m.mul(t0a, y3s), m.mul(t0a, xy)
                y, x = m.add(x3a, y3b), m.add(x3b, x3b)
            out = (x, y, z)
        for c, wc in zip(out, want):
            assert m.store(c) == wc[j]


R_C_WORDS = (0x00000001, 0x8C46EB21, 0x0994A8DD, 0x224698FC)  # the Fr instance's c
R_C4_WORDS = (0x00000004, 0x311BAC84, 0x2652A376, 0x891A63F0)  # its 4c


def test_fr_constants_are_literals_of_field_cuh():
    """The Fr instance's c, 4c and r are field.cuh's literals; c < 2^126
    with word 0 equal to 1, and 4c has Fq's top word, so the header's proof
    holds for it as for Fq."""
    m = Model(F.R)
    assert m.c_words == R_C_WORDS and m.c4_words == R_C4_WORDS and value(m.q_words) == F.R
    c = F.R - (1 << 254)
    assert c < (1 << 126) and R_C_WORDS[0] == 1 and R_C4_WORDS[3] == C4_WORDS[3]
    src = FIELD_CUH.read_text()
    for w in R_C_WORDS + R_C4_WORDS:
        assert re.search(rf"\b0x0*{w:x}u?\b", src, re.IGNORECASE), hex(w)
    assert f"{c:#x}" in src


def test_fr_instance_random_and_edges():
    """The Fr instance: mul, add, sub and mul_small against Python's exact
    arithmetic mod r on random values below 2^255 and on r's edges; load and
    canonical store against FR.canon."""
    m = Model(F.R)
    rnd = random.Random(12)
    r = F.R
    edges = [0, 1, r - 1, r, r + 1, 1 << 254, 2 * r - 1, (1 << 255) - 1]
    vals = [rnd.getrandbits(255) for _ in range(3_000)] + edges
    for a, b in zip(vals, vals[1:] + vals[:1]):
        for got, want in ((m.mul(to_words(a), to_words(b)), a * b), (m.add(to_words(a), to_words(b)), a + b),
                          (m.sub(to_words(a), to_words(b)), a - b), (m.mul_small(to_words(a), 15), 15 * a)):
            assert value(got) < (1 << 255) and value(got) % r == want % r
    rng = np.random.default_rng(13)
    for v in [int.from_bytes(rng.bytes(33), "little") >> 7 for _ in range(200)] + edges:
        limbs = lazy_limbs(v, rng)
        want = FR.canon(torch.tensor(limbs, dtype=torch.int64).reshape(L, 1))[:, 0].tolist()
        assert m.store(m.load(limbs)) == want == [((v % r) >> (15 * i)) & 0x7FFF for i in range(L)]


@pytest.mark.parametrize("p", [Q, F.R], ids=["Fq", "Fr"])
def test_finv_chain_on_words(p):
    """csrc/finv.cu's exponent chain on the model's words: from the top bit
    of p - 2 (bit 254), 254 squarings and a multiply at every set bit,
    words 7 to 0 as exp_word gives them (word 0 all ones, word 1 c's word 1
    less one); equal to pow(a, p - 2, p), 0 for 0."""
    m = Model(p)
    e_words = [0xFFFFFFFF, m.c_words[1] - 1] + list(m.q_words[2:])
    assert value(e_words) == p - 2
    rnd = random.Random(14)
    for v in [0, 1, p - 1, rnd.randrange(p), (1 << 255) - 1]:
        a = to_words(v)
        acc = a
        for j in range(NW - 1, -1, -1):
            for b in range(29 if j == NW - 1 else 31, -1, -1):
                acc = m.mul(acc, acc)
                if (e_words[j] >> b) & 1:
                    acc = m.mul(acc, a)
        assert m.store(acc) == [((pow(v, p - 2, p)) >> (15 * i)) & 0x7FFF for i in range(L)]
