"""The port's SHA3 and transcript packing on tensors (ops/keccak.py), the
plain twin of the rho_round kernel.

Held to hashlib, to the host transcript (utils/transcript.py over
utils/serialize.py) and to the JAX package's ops/keccak.py run eagerly on
single lanes.  Every comparison is exact.
"""

import hashlib
import pathlib
import re

import numpy as np
import pytest
import torch

from halo_accumulation_tpu.ops import keccak as jkk
from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck, keccak as kk
from halo_accumulation_tpu_torch.ops.field import FQ, FR, L, limb_array_to_ints
from halo_accumulation_tpu_torch.utils import serialize as ser, transcript as tr

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

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


# csrc/rho_round.cu runs keccak-f on one warp, thread t < 25 holding lane
# t = x + 5 y.  Its per-thread tables, stated here from FIPS 202 and
# ops/keccak.py's rotation and pi tables: theta reads columns x - 1 and
# x + 1 of the state (kXm, kXp), chi the lanes that pi puts at x + 1 and
# x + 2 of the row (kXp, kX2); rho rotates lane x + 5 y by kRho, and pi puts
# lane kPi at x + 5 y.  The source packs the column tables a nibble per x,
# and kRho and kPi a word per row y (6 and 5 bits per x).
RHO_CU = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc" / "rho_round.cu"
COLUMN_TABLES = {"kXm": [(x + 4) % 5 for x in range(5)], "kXp": [(x + 1) % 5 for x in range(5)],
                 "kX2": [(x + 2) % 5 for x in range(5)]}
ROW_TABLES = {"rho_row": (kk._ROT_FLAT, 6), "pi_row": (kk._PI_SRC, 5)}
# The message's staging row: where each input's words go (xi, L.x, L's
# flag as the top byte of its word, R.x, R's flag), where the padding
# starts, its length, and the padding's two nonzero words (0x06 at byte
# 102, 0x80 at byte 135 once shifted by a byte).
STAGING = {"kXi": 0, "kLx": 8, "kLflag": 16, "kRx": 17, "kRflag": 25, "kPad": 26, "kWords": 35}
PAD_WORDS = (0x00000600, 0x00800000)
KECCAK_RC = [0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
             0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
             0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
             0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
             0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
             0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008]
M32_ = 0xFFFFFFFF


def _fsl(lo, hi, s):
    """__funnelshift_l: the high word of (hi:lo) << (s mod 32)."""
    s &= 31
    return ((hi << s) | (lo >> (32 - s))) & M32_


def _packed(values, bits: int) -> int:
    return sum(v << (bits * i) for i, v in enumerate(values))


class Warp:
    """rho_round.cu's warp on Python ints: 32 threads in lockstep, each
    statement of the kernel one list operation, the column-major copy of
    the state in shared memory a list of the 25 lanes; `ops` counts the
    32-bit operations (shared-memory stores and loads and shuffles among
    them) of the threads that hold a lane, as written."""

    def __init__(self):
        self.ops = 0
        tt = [t if t < 25 else t - 25 for t in range(32)]
        x, y = [i % 5 for i in tt], [i // 5 for i in tt]
        C = COLUMN_TABLES
        self.xm, self.xp = [C["kXm"][i] for i in x], [C["kXp"][i] for i in x]
        rho = [(_packed(kk._ROT_FLAT[5 * j : 5 * j + 5], 6) >> (6 * i)) & 63 for i, j in zip(x, y)]
        pi = [_packed(kk._PI_SRC[5 * j : 5 * j + 5], 5) for j in y]
        self.rot = rho
        self.pa = [(row >> (5 * i)) & 31 for row, i in zip(pi, x)]
        self.pb = [(row >> (5 * C["kXp"][i])) & 31 for row, i in zip(pi, x)]
        self.pc = [(row >> (5 * C["kX2"][i])) & 31 for row, i in zip(pi, x)]
        self.y = y

    def op(self, n, fn, *xs):
        self.ops += 25 * n
        return [fn(*a) for a in zip(*xs)]

    def shfl(self, var, src):
        self.ops += 25
        return [var[s] for s in src]

    def column(self, state, cols):
        """The XOR of each thread's column of the shared copy: four xors."""
        return self.op(4, lambda c: state[c] ^ state[c + 5] ^ state[c + 10] ^ state[c + 15] ^ state[c + 20], cols)

    def keccak_f(self, lo, hi):
        for r in range(24):
            # the lane's store, then two columns of three loads (two 16-byte
            # loads and one 8-byte load carry both words)
            self.ops += 25 * (1 + 6)
            slo, shi = lo[:25], hi[:25]
            mlo, mhi = self.column(slo, self.xm), self.column(shi, self.xm)
            plo, phi = self.column(slo, self.xp), self.column(shi, self.xp)
            lo = self.op(3, lambda a, m, pl, ph: a ^ m ^ _fsl(ph, pl, 1), lo, mlo, plo, phi)
            hi = self.op(3, lambda a, m, pl, ph: a ^ m ^ _fsl(pl, ph, 1), hi, mhi, plo, phi)
            a = self.op(1, lambda rot, l, h: h if rot >= 32 else l, self.rot, lo, hi)
            b = self.op(1, lambda rot, l, h: l if rot >= 32 else h, self.rot, lo, hi)
            rhi = self.op(1, lambda x, y, s: _fsl(x, y, s), a, b, self.rot)
            rlo = self.op(1, lambda x, y, s: _fsl(y, x, s), a, b, self.rot)
            on0 = [M32_] + [0] * 31
            ilo = self.op(1, lambda m: KECCAK_RC[r] & M32_ & m, on0)
            ihi = self.op(1, lambda m: (KECCAK_RC[r] >> 32) & m, on0)
            alo, ahi = self.shfl(rlo, self.pa), self.shfl(rhi, self.pa)
            blo, bhi = self.shfl(rlo, self.pb), self.shfl(rhi, self.pb)
            dlo, dhi = self.shfl(rlo, self.pc), self.shfl(rhi, self.pc)
            lo = self.op(4, lambda x, i, y, z: (x ^ i) ^ (~y & M32_ & z), alo, ilo, blo, dlo)
            hi = self.op(4, lambda x, i, y, z: (x ^ i) ^ (~y & M32_ & z), ahi, ihi, bhi, dhi)
        return lo, hi

    def rho_round(self, xi, P, Q) -> int:
        """The challenge from host values (P, Q affine or None): threads 0 to
        4 stage their words and flags, thread t takes message words 2 t and
        2 t + 1, one keccak-f, the digest mod r."""
        S = STAGING
        s = [0] * S["kWords"]
        half = (F.Q - 1) // 2
        s[S["kXi"] : S["kXi"] + 8] = kk_words(xi)
        for at, flag_at, X, shift in ((S["kLx"], S["kLflag"], P, 24), (S["kRx"], S["kRflag"], Q, 0)):
            s[at : at + 8] = [0] * 8 if X is None else kk_words(X[0])
            s[flag_at] = (0x40 if X is None else (0x80 if X[1] > half else 0)) << shift
        s[S["kPad"]], s[S["kWords"] - 1] = PAD_WORDS

        def msg_word(j):
            return s[j] if j < 16 else _fsl(s[j], s[j + 1], 8)

        lo = [msg_word(2 * t) if t < 17 else 0 for t in range(32)]
        hi = [msg_word(2 * t + 1) if t < 17 else 0 for t in range(32)]
        lo, hi = self.keccak_f(lo, hi)
        return sum((lo[k] | (hi[k] << 32)) << (64 * k) for k in range(4)) % F.R


def kk_words(v: int) -> list[int]:
    return [(v >> (32 * j)) & M32_ for j in range(8)]


def test_rho_round_warp_tables_are_literals_of_the_source():
    """Every per-thread table, the staging row's layout, the padding words
    and the round constants of rho_round.cu are the literals stated here;
    the tables name lanes inside the state, and pi is a permutation."""
    src = RHO_CU.read_text()
    for name, table in COLUMN_TABLES.items():
        assert re.search(rf"\b{name} = 0x0*{_packed(table, 4):x}u\b", src), name
    for name, (table, bits) in ROW_TABLES.items():
        rows = ", ".join(f"0x{_packed(table[5 * y : 5 * y + 5], bits):08x}u" for y in range(5))
        assert f"{name} = pick(y, {rows});" in src, name
    assert sorted(kk._PI_SRC) == list(range(25))
    for name, at in STAGING.items():
        assert re.search(rf"\b{name} = {at}\b", src), name
    for w in PAD_WORDS:
        assert re.search(rf"\b0x0*{w:x}u\b", src, re.IGNORECASE), hex(w)
    assert kk._RC == KECCAK_RC
    for c in KECCAK_RC:
        assert re.search(rf"\b0x{c:016x}ull\b", src, re.IGNORECASE), hex(c)


def test_rho_round_warp_keccak_matches_twin(rng):
    """The warp's keccak-f, replayed thread by thread, equals ops/keccak.py's
    keccak_f on random states (threads 25 to 31 holding garbage that no
    thread reads), and its operation count is chip_smoke's
    KECCAK_IMPL_OPS32."""
    import chip_smoke

    for _ in range(3):
        st = rng.integers(0, 1 << 32, (32, 2), dtype=np.int64)
        w = Warp()
        lo, hi = w.keccak_f([int(x) for x in st[:, 0]], [int(x) for x in st[:, 1]])
        want = kk.keccak_f(torch.from_numpy(st[:25, 0]), torch.from_numpy(st[:25, 1]))
        assert lo[:25] == want[0].tolist() and hi[:25] == want[1].tolist()
        assert w.ops == chip_smoke.KECCAK_IMPL_OPS32


def test_rho_round_warp_replay_matches_twin_and_host():
    """The warp's whole dataflow (staging, the message words, keccak-f, mod
    r) on chip_smoke's 70 rho cases, built on the CPU: equal to
    ops/keccak.rho_round, the kernel's twin, and to the host transcript."""
    import chip_smoke

    cases = chip_smoke.rho_cases(np.random.default_rng(chip_smoke.SEED))
    assert len(cases) == 70
    for xi, P, Q in cases:
        got = Warp().rho_round(xi, P, Q)
        assert got == tr.rho_0(ser.ser_scalar(xi), ser.ser_point(P), ser.ser_point(Q))
        assert to_int(kk.rho_round(limbs(xi), *_affine(P), *_affine(Q))) == got
