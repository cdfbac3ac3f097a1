"""The port's SHA3 and transcript packing on tensors (ops/keccak.py), the
plain twin of the rho_round kernel.

Held to hashlib, to the host transcript (utils/transcript.py over
utils/serialize.py) and to the JAX package's ops/keccak.py run eagerly on
single lanes.  Every comparison is exact.
"""

import hashlib

import numpy as np
import pytest
import torch

from halo_accumulation_tpu.ops import keccak as jkk
from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck, keccak as kk
from halo_accumulation_tpu_torch.ops.field import FQ, FR, L, limb_array_to_ints
from halo_accumulation_tpu_torch.utils import serialize as ser, transcript as tr

G = (F.G_X, F.G_Y)
HALF = (F.Q - 1) // 2


def words(b: bytes):
    """Little-endian 32-bit words of b, the last zero-padded."""
    b += b"\x00" * (-len(b) % 4)
    return torch.tensor([int.from_bytes(b[i : i + 4], "little") for i in range(0, len(b), 4)] or [0],
                        dtype=torch.int64)


def as_bytes(ws) -> bytes:
    return b"".join(int(w).to_bytes(4, "little") for w in ws)


def limbs(v: int):
    return FR.from_ints([v])[:, 0]


def to_int(t) -> int:
    return limb_array_to_ints(t.numpy().reshape(L, 1))[0]


@pytest.mark.parametrize("nbytes", [0, 1, 135, 136, 1000])
def test_sha3_matches_hashlib(rng, nbytes):
    """One block up to 135 bytes; 136 bytes and more absorb several."""
    msg = rng.bytes(nbytes)
    assert as_bytes(kk.sha3_256_words(words(msg), nbytes)) == hashlib.sha3_256(msg).digest()


def test_keccak_f_matches_jax(rng):
    """One permutation of a random state, against the JAX package's."""
    st = rng.integers(0, 1 << 32, (25, 2), dtype=np.uint64)
    lo, hi = kk.keccak_f(torch.from_numpy(st[:, 0].astype(np.int64)), torch.from_numpy(st[:, 1].astype(np.int64)))
    want = jkk.keccak_f([(np.uint32(a), np.uint32(b)) for a, b in st])
    assert lo.tolist() == [int(a) for a, _ in want] and hi.tolist() == [int(b) for _, b in want]


def test_packing_matches_jax_and_ints(rng):
    """limbs_to_words, words_to_limbs, mod_r_256 and limbs_gt_const on
    single lanes: equal to the JAX functions and to Python ints, at random
    values and at the edges (0, r - 1, r, 2^256 - 1 for the reduction)."""
    for v in [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(4)] + [0, F.R - 1]:
        t = limbs(v)
        w = kk.limbs_to_words(t)
        assert as_bytes(w) == v.to_bytes(32, "little")
        assert [int(x) for x in jkk.limbs_to_words(np.asarray(t.numpy(), np.uint32))] == w.tolist()
    for raw in [rng.bytes(32) for _ in range(4)] + [F.R.to_bytes(32, "little"), b"\xff" * 32]:
        v = int.from_bytes(raw, "little")
        w = words(raw)
        full = kk.words_to_limbs(w)
        assert to_int(full) == v
        assert np.array_equal(np.asarray(jkk.words_to_limbs([np.uint32(x) for x in w.tolist()])), full.numpy())
        red = kk.mod_r_256(full)
        assert to_int(red) == v % F.R
        assert np.array_equal(np.asarray(jkk.mod_r_256(np.asarray(full.numpy(), np.uint32))), red.numpy())
    for y in (HALF - 1, HALF, HALF + 1, 0, F.Q - 1):
        t = FQ.from_ints([y])[:, 0]
        got = bool(kk.limbs_gt_const(t, HALF))
        assert got == (y > HALF) == bool(jkk.limbs_gt_const(np.asarray(t.numpy(), np.uint32), HALF))


@pytest.mark.parametrize("tag", [0, 1])
def test_rho_device_matches_host(rng, tag):
    parts = [ser.ser_scalar(int.from_bytes(rng.bytes(40), "little")) for _ in range(3)]
    blob = b"".join(parts)
    want = (tr.rho_0 if tag == 0 else tr.rho_1)(*parts)
    assert to_int(kk.rho_device(words(blob), len(blob), tag)) == want


def _affine(P):
    """(x, y, infinity) device form of a host point: canonical limbs, any
    coordinates at infinity."""
    x, y = (3, 5) if P is None else P
    return FQ.from_ints([x])[:, 0], FQ.from_ints([y])[:, 0], torch.tensor(P is None)


def _round_cases(rng):
    """(xi, L, R): random, L or R or both the identity, and the flag's
    boundary y = (Q - 1) / 2 (not flagged) and (Q + 1) / 2 (flagged) on
    either side; a boundary point need not lie on the curve, the message
    takes only x and the flag."""
    pts = [F.p_mul(int.from_bytes(rng.bytes(40), "little"), G) for _ in range(4)]
    xis = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(8)]
    return [
        (xis[0], pts[0], pts[1]),
        (xis[1], None, pts[2]),
        (xis[2], pts[3], None),
        (xis[3], None, None),
        (xis[4], (pts[0][0], HALF), (pts[1][0], HALF + 1)),
        (xis[5], (pts[2][0], HALF + 1), (pts[3][0], HALF)),
        (0, pts[1], F.p_neg(pts[1])),
        (F.R - 1, pts[2], pts[2]),
    ]


def test_rho_round_matches_host_transcript(rng):
    """The round challenge, from device limbs, equals the host transcript's
    rho_0(ser_scalar(xi), ser_point(L), ser_point(R)): through the twin
    itself and through ck.rho_round, which the device open calls (the
    kernel's wrapper, which takes the twin on the CPU and counts no
    launch)."""
    ck.reset_launches()
    for xi, P, Q in _round_cases(rng):
        want = tr.rho_0(ser.ser_scalar(xi), ser.ser_point(P), ser.ser_point(Q))
        args = (limbs(xi), *_affine(P), *_affine(Q))
        got = kk.rho_round(*args)
        assert to_int(got) == want
        assert torch.equal(ck.rho_round(*args), got)
    assert ck.launch_counts()["rho_round"] == 0


def test_rho_round_reads_column_views(rng):
    """The device open passes L and R as columns of (18, 2) tensors, views
    with stride 2: the same challenge as from contiguous vectors."""
    P, Q = (F.p_mul(int.from_bytes(rng.bytes(40), "little"), G) for _ in range(2))
    xs, ys = FQ.from_ints([P[0], Q[0]]), FQ.from_ints([P[1], Q[1]])
    inf = torch.tensor([False, False])
    xi = limbs(12345)
    got = kk.rho_round(xi, xs[:, 0], ys[:, 0], inf[0], xs[:, 1], ys[:, 1], inf[1])
    assert to_int(got) == tr.rho_0(ser.ser_scalar(12345), ser.ser_point(P), ser.ser_point(Q))
