"""Vectorized 255-bit prime-field arithmetic for the Pasta fields, in PyTorch.

The same number system as `halo_accumulation_tpu/ops/field.py`, limb for
limb, so a value computed here equals its JAX twin's representation:

  * A field element is 18 limbs of 15 bits, limb-major: a tensor of shape
    (18, *batch).  Limbs are int64 at the torch level (torch's CPU uint32
    lacks +, >> and comparisons); every limb this module produces fits in
    31 bits, so the CUDA kernels narrow them to uint32 in registers.
  * Bit 255 falls on the limb-17 boundary and 2^255 = -2c (mod p) with
    c = p - 2^254 < 2^126, so reduction is a limb-aligned fold by 2c.
  * Limbs stay "nearly clean" (<= 2^15 + eps); two vectorized carry passes
    bring column sums back down.  Stored values are < 2^257 ("GOOD"); only
    canon() runs an exact carry ripple and conditional subtractions.
  * Subtraction is borrow-free: a - b = a + (K - b) with K a multiple of p
    whose digits dominate any nearly clean limb.

Schoolbook columns are built as an anti-diagonal sum of the (na, nb) limb
product table in a handful of tensor ops; the column values are exact
integers, identical to the JAX package's padded per-row sums.
"""

from __future__ import annotations

import numpy as np
import torch

from halo_accumulation_tpu_torch import fields as _f

L = 18  # limbs
W = 15  # bits per limb
MASK = 0x7FFF
_DOM = 0x1FFFF  # digit domination constant for borrow-free K - b
I64 = torch.int64
# Lanes a CPU multiply takes at once: wider ones run in slices of this
# many, so each (18, 18, lanes) int64 product table (2.6 MB) stays in
# cache instead of being new memory from DRAM on every call.
_CPU_LANES = 1024


def int_to_limbs(v: int, n: int = L) -> list[int]:
    if not 0 <= v < (1 << (W * n)):
        raise ValueError("value out of limb range")
    return [(v >> (W * i)) & MASK for i in range(n)]


def ints_to_limb_array(vs, n: int = L) -> np.ndarray:
    """Python ints (each < 2^(15n)) -> (n, len) int64 numpy limbs."""
    vs = list(vs)
    out = np.zeros((n, len(vs)), np.int64)
    for j, v in enumerate(vs):
        out[:, j] = int_to_limbs(v, n)
    return out


def limb_array_to_ints(arr) -> list[int]:
    """(n, m) integer limbs (any width) -> m Python ints."""
    a = np.asarray(arr).astype(object)
    n = a.shape[0]
    return [sum(int(a[i, j]) << (W * i) for i in range(n)) for j in range(a.shape[1])]


def _pass(cols, n_out: int | None = None):
    """One carry pass: out_i = (x_i & M) + (x_{i-1} >> 15); len + 1 limbs
    unless n_out trims limbs that the value bound forces to zero."""
    n = cols.shape[0]
    out = cols.new_empty((n + 1,) + tuple(cols.shape[1:]))
    torch.bitwise_and(cols, MASK, out=out[:n])
    out[n].zero_()  # a kernel: `= 0` on a 0-dim CUDA row copies from the host, a sync
    out[1:] += cols >> W
    return out if n_out is None else out[:n_out]


def _pass2(cols, n_out: int | None = None):
    return _pass(_pass(cols), n_out)


def _split_cols(p):
    """Column sums of a limb product table p (na, nb, *B) with each product
    split into (p & M) at column i+j and (p >> 15) at i+j+1: na + nb rows,
    exactly the JAX package's _mul_cols values.  p is a temporary of the
    caller's and is shifted in place.

    Row i of the (na + 1, nb) table lo[i] + hi[i-1] is written into a
    buffer whose rows are w + 1 long and read back as rows w long: that
    shifts row i right by i, so a sum over rows gives the anti-diagonal
    (column) sums."""
    na, nb = p.shape[0], p.shape[1]
    rest = tuple(p.shape[2:])
    w = na + nb
    buf = p.new_empty(((na + 1) * (w + 1),) + rest)
    V = buf.view((na + 1, w + 1) + rest)
    V[:, nb:] = 0
    torch.bitwise_and(p, MASK, out=V[:na, :nb])
    V[na, :nb] = 0
    p >>= W
    V[1:, :nb] += p
    return buf[: (na + 1) * w].view((na + 1, w) + rest).sum(0)


def _mul_cols(a, b):
    a, b = torch.broadcast_tensors(a[:, None], b[None])
    return _split_cols(a * b)


class Field:
    """Limb arithmetic for p = 2^254 + c (c < 2^126) on (18, *batch) int64."""

    def __init__(self, p: int, name: str):
        self.p = p
        self.name = name
        self.c = p - (1 << 254)
        assert 0 < self.c < (1 << 126)
        self.c2_limbs = int_to_limbs(2 * self.c, 9)
        u18 = ((1 << (W * 18)) - 1) // ((1 << W) - 1)
        k18 = p * ((_DOM * u18 + 2 * p) // p)
        self.k18 = self._dom_digits(k18, 18, 20)
        self.k12 = self._dom_digits(p, 12, 18)
        self._consts: dict = {}

    @staticmethod
    def _dom_digits(K: int, m: int, total: int) -> list[int]:
        x = K - _DOM * (((1 << (W * m)) - 1) // ((1 << W) - 1))
        assert x >= 0
        xs = int_to_limbs(x, total)
        return [xs[i] + (_DOM if i < m else 0) for i in range(total)]

    def _const(self, key, digits: list[int], device):
        t = self._consts.get((key, device))
        if t is None:
            t = torch.tensor(digits, dtype=I64, device=device)
            self._consts[(key, device)] = t
        return t

    # -- reduction helpers (bounds as in the JAX package) ----------------------

    def _mul_const_cols(self, b):
        """2c (9 digits) times nearly clean limbs b: 9 + len(b) rows."""
        c = self._const("c2", self.c2_limbs, b.device)
        c = c.reshape((9,) + (1,) * b.dim())
        return _split_cols(c * b[None])

    def _const_minus(self, key: str, kdigits: list[int], b):
        """Borrow-free K - b as len(kdigits) unclean limbs (b shorter)."""
        nk = len(kdigits)
        k = self._const(key, kdigits, b.device).reshape((nk,) + (1,) * (b.dim() - 1))
        out = k.expand((nk,) + tuple(b.shape[1:])).clone()
        out[: b.shape[0]] -= b
        return out

    def _fold_tail(self, x):
        """x: 18..20 nearly clean limbs, value < 2^273 -> GOOD 18 limbs."""
        low = x[:17]
        high = x[17:]
        X = _pass2(self._mul_const_cols(high), 12)
        d = self._const_minus("k12", self.k12, X)
        d[:17] += low
        return _pass(d, 18)

    def _reduce_wide(self, t):
        """Nearly clean product columns (value < 2^527) -> GOOD 18 limbs."""
        low0 = t[:17]
        h0 = t[17:]
        X1 = _pass2(self._mul_const_cols(h0))
        low1 = X1[:17]
        h1 = X1[17:]
        X2 = _pass2(self._mul_const_cols(h1), 20)
        low2 = X2[:17]
        h2 = X2[17:20]
        X3 = _pass2(self._mul_const_cols(h2), 12)
        # value = (low0 + low2) - (low1 + X3), borrow-free through K18
        d = self._const_minus("k18", self.k18, low1)  # 20 limbs
        d[:12] -= X3
        d[:17] += low0
        d[:17] += low2
        return self._fold_tail(_pass(d, 20))

    # -- construction / conversion ---------------------------------------------

    def zeros(self, batch_shape=(), device="cpu"):
        return torch.zeros((L,) + tuple(batch_shape), dtype=I64, device=device)

    def from_int(self, v: int, batch_shape=(), device="cpu"):
        """v broadcast over batch_shape: a read-only view of a constant kept
        on the device per value (one host-to-device copy per value and
        device, so a loop on the card syncs only on its first call); take
        it for constants."""
        t = self._const(("int", v % self.p), int_to_limbs(v % self.p), device)
        return t.reshape((L,) + (1,) * len(batch_shape)).expand((L,) + tuple(batch_shape))

    def from_ints(self, vs, device="cpu"):
        arr = ints_to_limb_array([v % self.p for v in vs])
        return torch.from_numpy(arr).to(device)

    def to_ints(self, a) -> list[int]:
        """Canonical Python ints of a (18, *batch) tensor, flattened."""
        c = self.canon(a).reshape(L, -1).cpu().numpy()
        return limb_array_to_ints(c)

    # -- arithmetic --------------------------------------------------------------

    def add(self, a, b):
        return _pass(a + b, L)

    def fold(self, a):
        """Re-normalize a lazily grown value (< 2^273) back to GOOD."""
        return self._fold_tail(a)

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        d = self._const_minus("k18", self.k18, b)
        d[:L] += a
        return self._fold_tail(_pass(d, 20))

    def neg(self, a):
        d = self._const_minus("k18", self.k18, a)
        return self._fold_tail(_pass(d, 20))

    def mul(self, a, b):
        if not (a.is_cuda or b.is_cuda):
            a, b = torch.broadcast_tensors(a, b)
            n = a[0].numel()
            if n > _CPU_LANES:
                return self._mul_lanes(a.reshape(L, n), b.reshape(L, n)).reshape(a.shape)
        return self._reduce_wide(_pass2(_mul_cols(a, b)))

    def _mul_lanes(self, a, b):
        """mul of (18, n) CPU limbs, _CPU_LANES lanes at a time: the same
        limbs as one call (every step is lane-wise), with each product
        table small enough to stay in cache."""
        out = a.new_empty(a.shape)
        for s in range(0, a.shape[1], _CPU_LANES):
            e = s + _CPU_LANES
            out[:, s:e] = self._reduce_wide(_pass2(_mul_cols(a[:, s:e], b[:, s:e])))
        return out

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k: int):
        """a * k for a small positive int k (k < 2^12)."""
        if not 0 < k < (1 << 12):
            raise ValueError("mul_small takes 0 < k < 4096")
        return self._fold_tail(_pass2(a * k))

    # -- canonical form ------------------------------------------------------------

    @staticmethod
    def _ripple(x, n_out: int):
        """Exact sequential carry: clean 15-bit limbs."""
        out = []
        c = None
        n = x.shape[0]
        for i in range(n_out):
            t = x[i] if i < n else None
            if t is None and c is None:
                out.append(torch.zeros_like(x[0]))
                continue
            if t is None:
                t = c
            elif c is not None:
                t = t + c
            out.append(t & MASK)
            c = t >> W
        return torch.stack(out)

    def _cond_sub(self, v, K: int):
        n = v.shape[0]
        comp = self._const(("cond_sub", K, n), int_to_limbs((1 << (W * n)) - K, n), v.device)
        t = self._ripple(v + comp.reshape((n,) + (1,) * (v.dim() - 1)), n + 1)
        ge = t[n] != 0
        return torch.where(ge[None], t[:n], v)

    def canon(self, a):
        """Exact canonical form: clean 15-bit limbs, value < p."""
        x = self._ripple(self.fold(a), L)
        x = self._cond_sub(x, 2 * self.p)
        x = self._cond_sub(x, 2 * self.p)
        return self._cond_sub(x, self.p)

    # -- predicates / misc -------------------------------------------------------

    @staticmethod
    def select(m, a, b):
        return torch.where(m[None], a, b)

    def eq(self, a, b):
        return (self.canon(a) == self.canon(b)).all(0)

    def is_zero(self, a):
        return (self.canon(a) == 0).all(0)

    def pow_const(self, a, e: int):
        """a^e for a constant e >= 0, square-and-multiply from e's top bit
        down, starting from 1, as the JAX package's pow_const: its multiply
        where a bit is 0 is selected away, so skipping it gives the same
        limbs."""
        acc = self.from_int(1, tuple(a.shape[1:]), a.device)
        for i in reversed(range(max(1, e.bit_length()))):
            acc = self.mul(acc, acc)
            if (e >> i) & 1:
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Batched inversion on the device, 0 -> 0 (exact zero limbs), no
        host copy.  On a CUDA tensor every lane goes through the finv
        kernel (divsteps) in one launch: its lanes run side by
        side, so one launch costs about what the JAX package's product
        tree costs at its root alone, without the tree's 2 lg n levels of
        multiplies (PERF.md).  On the CPU, the JAX package's product tree,
        its root inverted by pow_const."""
        from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

        if a.is_cuda:
            return ck.finv(a.reshape(L, -1), self).reshape(a.shape)
        batch = tuple(a.shape[1:])
        n = int(np.prod(batch)) if batch else 1
        flat = a.reshape(L, n)
        nz = ~self.is_zero(flat)
        one = self.from_int(1, (n,), a.device)
        flat = torch.where(nz[None], flat, one)
        m = 1
        while m < n:
            m *= 2
        if m != n:
            flat = torch.cat([flat, self.from_int(1, (m - n,), a.device)], dim=1)
        levels = [flat]
        cur = flat
        while cur.shape[1] > 1:
            cur = self.mul(cur[:, 0::2], cur[:, 1::2])
            levels.append(cur)
        inv = self.pow_const(cur, self.p - 2)
        for lev in reversed(levels[:-1]):
            left = self.mul(inv, lev[:, 1::2])
            right = self.mul(inv, lev[:, 0::2])
            inv = torch.stack([left, right], dim=2).reshape(L, lev.shape[1])
        inv = inv[:, :n]
        inv = torch.where(nz[None], inv, torch.zeros_like(inv))
        return inv.reshape((L,) + batch)

    def sum_along(self, a, axis: int):
        """Tree-reduce a batch axis with lazy adds, folding every 3 levels."""
        ax = axis + 1
        level = 0
        while a.shape[ax] > 1:
            n = a.shape[ax]
            half = n // 2
            s = self.add(a.narrow(ax, 0, half), a.narrow(ax, half, half))
            level += 1
            if level % 3 == 0:
                s = self.fold(s)
            if n % 2:
                s = torch.cat([s, a.narrow(ax, 2 * half, n - 2 * half)], dim=ax)
            a = s
        return a.squeeze(ax)


FQ = Field(_f.Q, "Fq")
FR = Field(_f.R, "Fr")
