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
chip_smoke.py reports as IMPL_MULS_FMUL.  DivstepModel does the same for
csrc/finv.cu's inversion by divsteps, held to Python's pow and counted
against chip_smoke.FINV_IMPL_OPS32.  The card test of record is
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

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

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


FINV_CU = FIELD_CUH.parent / "finv.cu"
M30 = (1 << 30) - 1


def s32(x: int) -> int:
    """x mod 2^32 as a signed 32-bit value."""
    x &= M32
    return x - (1 << 32) if x >> 31 else x


class DivstepModel:
    """csrc/finv.cu, step for step, for the modulus p: load into words,
    one conditional subtraction of p, nine signed 30-bit limbs, 20 batches
    of 30 divsteps on the low words, each batch's matrix on (f, g) and on
    (d, e) modulo p (p^-1 == 1 mod 2^30), then d sign(f) normalized into
    [0, p) and stored as canonical limbs.  It checks the source's range
    claims as it goes and counts the divsteps' 32-bit operations as written
    (ops2: two-input), with three-input LOP3 and IADD3 (ops3), and the
    matrices' products (products: none for p's limbs 0 and 5 to 8)."""

    BATCH, BATCHES, LIMBS = 30, 20, 9

    def __init__(self, p: int):
        self.p = p
        self.words = Model(p)
        self.p30 = [(p >> (30 * i)) & M30 for i in range(self.LIMBS)]
        assert self.p30[0] == 1 and self.p30[5:] == [0, 0, 0, 1 << 14]  # the header's facts
        self.ops2 = self.ops3 = self.products = 0

    def value(self, limbs) -> int:
        return sum(x << (30 * i) for i, x in enumerate(limbs))

    def divsteps(self, zeta, f, g):
        u, v, q, r = 1, 0, 0, 1
        for _ in range(self.BATCH):
            assert f & 1
            c1 = (zeta >> 31) & M32
            c2 = -(g & 1) & M32
            c3 = c1 & c2
            g = (g + ((f ^ c1) & c2) - c3) & M32
            q = (q + ((u ^ c1) & c2) - c3) & M32
            r = (r + ((v ^ c1) & c2) - c3) & M32
            zeta = s32((zeta ^ s32(c3)) - 1)
            f = (f + (g & c3)) & M32
            u = (u + (q & c3)) & M32
            v = (v + (r & c3)) & M32
            g >>= 1
            u = (u << 1) & M32
            v = (v << 1) & M32
            self.ops2 += 4 + 12 + 2 + 6 + 3
            self.ops3 += 4 + 6 + 2 + 6 + 3
        t = [s32(x) for x in (u, v, q, r)]
        assert abs(t[0]) + abs(t[1]) <= 1 << 30 and abs(t[2]) + abs(t[3]) <= 1 << 30
        return zeta, t

    def apply(self, a, b, t0, t1, m=None):
        """(t0 a + t1 b + m p) / 2^30 on 30-bit limbs, carried in a signed
        64-bit accumulator; the low 30 bits must be 0."""
        c = t0 * a[0] + t1 * b[0] + (m if m is not None else 0)
        assert c & M30 == 0
        c >>= 30
        out = []
        for i in range(1, self.LIMBS):
            c += t0 * a[i] + t1 * b[i]
            self.products += 2
            if m is not None:
                c += self.p30[i] * m
                self.products += self.p30[i] & (self.p30[i] - 1) != 0  # none for 0, 1 or 2^k
            assert -(1 << 63) <= c < (1 << 63)
            out.append(c & M30)
            c >>= 30
        assert -(1 << 31) <= c < (1 << 31)
        self.products += 2  # limb 0's
        return out + [c]

    def update_de(self, d, e, t):
        u, v, q, r = t
        sd, se = -(d[8] < 0), -(e[8] < 0)
        md, me = (u & sd) + (v & se), (q & sd) + (r & se)
        md -= (u * d[0] + v * e[0] + md) & M30
        me -= (q * d[0] + r * e[0] + me) & M30
        assert -(1 << 31) <= md < (1 << 31) and -(1 << 31) <= me < (1 << 31)
        nd, ne = self.apply(d, e, u, v, md), self.apply(d, e, q, r, me)
        for x in (nd, ne):
            assert -2 * self.p < self.value(x) < self.p
        return nd, ne

    def normalize(self, d, fsign):
        add1, neg = -(d[8] < 0), -(fsign < 0)
        d = [((x + (pi & add1)) ^ neg) - neg for x, pi in zip(d, self.p30)]
        d = self.carry(d)
        add2 = -(d[8] < 0)
        return self.carry([x + (pi & add2) for x, pi in zip(d, self.p30)])

    def carry(self, d):
        d = list(d)
        for i in range(1, self.LIMBS):
            d[i] += d[i - 1] >> 30
            d[i - 1] &= M30
        return d

    def inv(self, limbs):
        """Canonical limbs of the inverse, and the final f and g."""
        w = self.words.load(limbs)
        v = value(w)
        v = v - self.p if v >= self.p else v
        g = [(v >> (30 * i)) & M30 for i in range(self.LIMBS)]
        f, d, e, zeta = list(self.p30), [0] * self.LIMBS, [1] + [0] * (self.LIMBS - 1), -1
        for _ in range(self.BATCHES):
            zeta, t = self.divsteps(zeta, f[0], g[0])
            d, e = self.update_de(d, e, t)
            f, g = self.apply(f, g, t[0], t[1]), self.apply(f, g, t[2], t[3])
        d = self.normalize(d, f[8])
        assert all(0 <= x <= M30 for x in d) and self.value(d) < self.p
        return self.words.store(self.words.from_chunks(d, 30)), self.value(f), self.value(g)


@pytest.mark.parametrize("p", [Q, F.R], ids=["Fq", "Fr"])
def test_finv_divsteps_on_words(p):
    """csrc/finv.cu's divsteps on the model's words equal pow(v, p - 2, p)
    (0 for 0) on 200 random values and the edges: 0, 1, 2, p - 1, (p + 1) /
    2, every 2^k for k <= 254, chip_smoke's finv edge lanes (lazy limbs of
    values at or above p, up to 2^257), lazy limbs of random values below
    2^257 and fmul's nearly clean edge lanes.  After the 600 divsteps g is
    0 and f is +-1 (p for 0)."""
    m = DivstepModel(p)
    rnd = random.Random(15)
    rng = np.random.default_rng(16)
    lanes = [lazy_limbs(v, rng) for v in [rnd.randrange(p) for _ in range(200)] + [0, 1, 2, p - 1, (p + 1) // 2]
             + [1 << k for k in range(255)] + [rnd.randrange(1 << 257) for _ in range(20)]]
    lanes += chip_smoke.finv_edge_limbs(p) + EDGE_LIMBS
    for limbs in lanes:
        v = sum(x << (15 * i) for i, x in enumerate(limbs)) % p
        got, f, g = m.inv(limbs)
        assert got == [(pow(v, p - 2, p) >> (15 * i)) & 0x7FFF for i in range(L)], v
        assert g == 0 and f in ((p,) if v == 0 else (1, -1))


def test_finv_op_count_matches_chip_smoke():
    """The model's count of one inversion is chip_smoke's FINV_IMPL_OPS32
    (20 batches: 600 divsteps at 27 operations as written, 80 products a
    batch); a divstep with three-input LOP3 and IADD3 is DIVSTEP_OPS, and
    the bound's least work, 590 divsteps at that count and their 20
    batches' products, is below both Fermat's shortest chain and the
    kernel's count."""
    m = DivstepModel(Q)
    m.inv([5] + [0] * (L - 1))
    assert m.ops2 + m.products == chip_smoke.FINV_IMPL_OPS32 == 20 * (30 * 27 + 80)
    assert m.ops2 == 600 * chip_smoke.DIVSTEP_IMPL_OPS and m.ops3 == 600 * chip_smoke.DIVSTEP_OPS
    assert m.products == 20 * chip_smoke.MATRIX_MULS
    least = chip_smoke.FINV_DIVSTEP_OPS32
    assert least == 590 * 21 + 20 * 80
    for p in (Q, F.R):
        sq, mu = chip_smoke.finv_least_chain(p)
        assert (sq, mu) == (255, 34)
        assert chip_smoke.finv_least_ops(p) == least < sq * chip_smoke.MIN_MULS_SQR + mu * chip_smoke.MIN_MULS_FMUL
    assert least <= chip_smoke.FINV_IMPL_OPS32


def test_finv_constants_are_literals_of_finv_cu():
    """The model's batch and divstep counts are finv.cu's, and its header
    names the bound they meet (590 divsteps)."""
    src = FINV_CU.read_text()
    assert re.search(rf"\bkBatch = {DivstepModel.BATCH};", src)
    assert re.search(rf"\bkBatches = {DivstepModel.BATCHES};", src)
    assert re.search(rf"\bkLimbs = {DivstepModel.LIMBS};", src)
    assert DivstepModel.BATCH * DivstepModel.BATCHES >= chip_smoke.FINV_DIVSTEPS == 590
    assert "590 divsteps" in src and "741" in src
