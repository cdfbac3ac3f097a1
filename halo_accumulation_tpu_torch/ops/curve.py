"""Vectorized Pallas-curve group ops (complete projective formulas), in PyTorch.

Counterpart of `halo_accumulation_tpu/ops/curve.py`.  A point vector is a
PointVec of (18, *batch) int64 limb tensors in homogeneous projective
coordinates; the identity is (0 : 1 : 0).  Additions and doublings use the
complete Renes-Costello-Batina 2016 formulas (a = 0, b = 5), which handle
P == Q, P == -Q and the identity without branches.

`padd` and `pdbl` flatten the batch and call the kernel wrappers of
ops/cuda_kernels.py: on a CUDA tensor every add, and every run of k
doublings, is one kernel launch, at any width; on the CPU the wrappers run
the plain twins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
from halo_accumulation_tpu_torch.ops.field import FQ, L, W, limb_array_to_ints

B3 = 3 * F.B_COEFF

class PointVec(NamedTuple):
    """Projective point(s): X, Y, Z limb tensors of shape (18, *batch)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])


def identity(batch_shape=(), device="cpu") -> PointVec:
    z = FQ.zeros(batch_shape, device)
    y = z.clone()
    y[0].fill_(1)  # never a host copy, not even at batch shape ()
    return PointVec(z, y, z.clone())


def from_affine_ints(points, device="cpu") -> PointVec:
    """Host list of (x, y) int pairs or None (infinity) -> PointVec."""
    xs, ys, zs = [], [], []
    for P in points:
        if P is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(P[0]), ys.append(P[1]), zs.append(1)
    return PointVec(FQ.from_ints(xs, device), FQ.from_ints(ys, device), FQ.from_ints(zs, device))


def _flat(P: PointVec, shape):
    return tuple(c.expand((L,) + shape).reshape(L, -1) for c in P)


def padd(P: PointVec, Q: PointVec) -> PointVec:
    """Complete projective addition, RCB16 algorithm 7 (12M + 2m(b3))."""
    shape = tuple(torch.broadcast_shapes(P.x.shape, Q.x.shape)[1:])
    out = ck.padd(_flat(P, shape), _flat(Q, shape))
    return PointVec(*(o.reshape((L,) + shape) for o in out))


def pdbl(P: PointVec, k: int = 1) -> PointVec:
    """k complete projective doublings (2^k P), RCB16 algorithm 9 (6M + 2S)
    each, in one kernel launch on the card."""
    shape = P.batch_shape
    out = ck.pdbl(_flat(P, shape), k)
    return PointVec(*(o.reshape((L,) + shape) for o in out))


def fq_mul(a, b):
    """Fq multiply of limb tensors of any (broadcastable) batch shape through
    the fmul kernel wrapper: a launch on the card, the plain twin on the CPU."""
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape)[1:])
    out = ck.fmul(a.expand((L,) + shape).reshape(L, -1), b.expand((L,) + shape).reshape(L, -1))
    return out.reshape((L,) + shape)


def _stk(*xs):
    return torch.stack(torch.broadcast_tensors(*xs), dim=1)  # (18, k, *batch)


def _unstk(a, k: int):
    return [a[:, i] for i in range(k)]


def padd_mixed(P: PointVec, qx, qy, q_inf=None) -> PointVec:
    """Complete mixed addition P + (qx : qy : 1), RCB16 algorithm 8 (a = 0),
    11M + 2m(b3), the multiplies in two stacked FQ calls (torch glue, no
    kernel, as the JAX package's).  q_inf: a bool mask over the batch whose
    lanes return P unchanged (an affine point cannot be the identity)."""
    f = FQ
    x1, y1, z1 = P
    s1, s4 = _unstk(f.add(_stk(x1, qx), _stk(y1, qy)), 2)
    t0, t1, m3, y2z1, x2z1 = _unstk(f.mul(_stk(x1, y1, s1, z1, z1), _stk(qx, qy, s4, qy, qx)), 5)
    t3 = f.sub(m3, f.add(t0, t1))  # x1 y2 + x2 y1
    t4, w = _unstk(f.add(_stk(y2z1, x2z1), _stk(y1, x1)), 2)  # y1 + y2 z1, x1 + x2 z1
    t2b, wb = _unstk(f.mul_small(_stk(z1, w), B3), 2)
    t0b = f.add(f.add(t0, t0), t0)  # 3 x1 x2
    z3s = f.add(t1, t2b)
    t1b = f.sub(t1, t2b)
    x3a, t2c, y3a, t1c, t0c, z3c = _unstk(f.mul(_stk(t4, t3, wb, t1b, t0b, z3s), _stk(wb, t1b, t0b, z3s, t3, t4)), 6)
    r1, r2 = _unstk(f.add(_stk(t1c, z3c), _stk(y3a, t0c)), 2)
    R = PointVec(f.sub(t2c, x3a), r1, r2)
    return R if q_inf is None else pselect(q_inf, P, R)


def scalar_bits_msb(k_limbs, nbits: int = 255):
    """Fr canonical limbs (18,) -> (nbits,) bool bits, most significant
    first."""
    idx = torch.arange(nbits - 1, -1, -1, device=k_limbs.device)
    return ((k_limbs[idx // W] >> (idx % W)) & 1).bool()


def pmul_shared(k_limbs, P: PointVec, nbits: int = 255) -> PointVec:
    """k P for every point of P with ONE scalar k (Fr canonical limbs,
    (18,)): 2-bit windows over the table {0, P, 2P, 3P}, msb first, each
    window two doublings (one pdbl launch) and one complete add (adding the
    identity for a zero digit is safe).  The digits are read on the device:
    no host copy."""
    nwin = (nbits + 1) // 2
    dev = P.x.device
    P2 = pdbl(P)
    table = [torch.stack([a, b, c, d]) for a, b, c, d in zip(identity(P.batch_shape, dev), P, P2, padd(P2, P))]
    bit = torch.arange(2 * nwin, device=dev)  # 2 nwin <= 256 < 18 limbs x 15 bits
    bits = (k_limbs[bit // W] >> (bit % W)) & 1
    digits = (bits[0::2] + 2 * bits[1::2]).flip(0)  # window i holds bits 2 (nwin - 1 - i) and up
    acc = identity(P.batch_shape, dev)
    for i in range(nwin):
        acc = padd(pdbl(acc, 2), PointVec(*(t.index_select(0, digits[i : i + 1])[0] for t in table)))
    return acc


def gather_points(P: PointVec, idx, axis: int = 0) -> PointVec:
    """Gather along a batch axis (jnp.take's semantics for in-range idx)."""
    ax = axis + 1
    idx = torch.as_tensor(idx, device=P.x.device)

    def take(c):
        out = c.index_select(ax, idx.reshape(-1))
        return out.reshape(tuple(c.shape[:ax]) + tuple(idx.shape) + tuple(c.shape[ax + 1 :]))

    return PointVec(*(take(c) for c in P))


def pneg(P: PointVec) -> PointVec:
    return PointVec(P.x, FQ.neg(P.y), P.z)


def pselect(m, A: PointVec, B: PointVec) -> PointVec:
    """where(m, A, B) with m broadcastable over the batch shape."""
    return PointVec(FQ.select(m, A.x, B.x), FQ.select(m, A.y, B.y), FQ.select(m, A.z, B.z))


def is_identity(P: PointVec):
    return FQ.is_zero(P.z)


def peq(P: PointVec, Q: PointVec):
    """Projective equality: x1 z2 == x2 z1 and y1 z2 == y2 z1."""
    ex = FQ.eq(fq_mul(P.x, Q.z), fq_mul(Q.x, P.z))
    ey = FQ.eq(fq_mul(P.y, Q.z), fq_mul(Q.y, P.z))
    return (ex & ey) | (is_identity(P) & is_identity(Q))


def to_affine(P: PointVec):
    """Batch-normalize: (x, y, inf_mask) with x, y canonical limbs.  inv
    maps z == 0 (mod q), and only it, to all-zero limbs, which marks the
    identity.  On the card the fmul kernel already stores canonical limbs;
    the CPU twin's lazy limbs are made canonical here."""
    zinv = FQ.inv(P.z)
    x, y = fq_mul(P.x, zinv), fq_mul(P.y, zinv)
    if not x.is_cuda:
        x, y = FQ.canon(x), FQ.canon(y)
    return x, y, (zinv == 0).all(0)


def to_host(P: PointVec) -> list:
    """Points of any batch shape -> flat list of host affine ints / None,
    with one device-to-host copy."""
    arr = torch.stack([c.reshape(L, -1) for c in P]).cpu().numpy()  # (3, L, n)
    xs, ys, zs = (limb_array_to_ints(arr[i]) for i in range(3))
    return [affine_int(x, y, z) for x, y, z in zip(xs, ys, zs)]


def affine_int(x: int, y: int, z: int):
    """Projective host ints -> affine (x, y), or None for the identity."""
    z %= F.Q
    if z == 0:
        return None
    zinv = pow(z, -1, F.Q)
    return (x * zinv % F.Q, y * zinv % F.Q)


def sum_points(P: PointVec, axis: int = 0) -> PointVec:
    """Tree-reduce one batch axis with complete adds."""
    ax = axis + 1
    while P.x.shape[ax] > 1:
        n = P.x.shape[ax]
        half = n // 2
        s = padd(
            PointVec(*(c.narrow(ax, 0, half) for c in P)),
            PointVec(*(c.narrow(ax, half, half) for c in P)),
        )
        if n % 2:
            s = PointVec(*(torch.cat([a, c.narrow(ax, 2 * half, 1)], dim=ax) for a, c in zip(s, P)))
        P = s
    return PointVec(*(c.squeeze(ax) for c in P))
