"""SHA3-256 and the transcript's scalar packing on tensors: the plain
versions of the device-transcript open's round challenge.

Counterpart of `halo_accumulation_tpu/ops/keccak.py`.  The IPA open's
rounds are sequential through their Fiat-Shamir challenges
(xi_{i+1} = rho_0(xi_i, L_i, R_i)); hashing on the device keeps the whole
open free of device-to-host copies (pcdl._open_device).  On the card one
launch of the rho_round kernel (csrc/rho_round.cu) computes `rho_round`
below; these functions are its plain twin, which the CPU path and the
tests run.

Words are 32-bit values held in int64 tensors (torch's CPU uint32 lacks
+, >> and comparisons), so a keccak lane is a (lo, hi) pair of words as in
the JAX package, and a shift right by 32 is simply 0.  Byte layouts are
utils/serialize.py's, bit for bit.
"""

from __future__ import annotations

import torch

from halo_accumulation_tpu_torch import fields as _fields
from halo_accumulation_tpu_torch.ops.field import I64, L, W
from halo_accumulation_tpu_torch.utils import serialize as ser

M32 = 0xFFFFFFFF
RATE_WORDS = 34  # the SHA3-256 rate, 136 bytes

# keccak-f[1600] round constants
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y]
_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
# per-lane rotation in flat order i = x + 5 y, and the pi permutation as a
# gather map: dst[y + 5 ((2 x + 3 y) % 5)] = src[x + 5 y]
_ROT_FLAT = [_ROTC[i % 5][i // 5] for i in range(25)]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_R_LIMBS = [(_fields.R >> (W * i)) & 0x7FFF for i in range(L)]


def _rotl(lo, hi, r):
    """Rotate 64-bit lanes held as (lo, hi) words left by per-lane r."""
    s = r % 32
    swap = r >= 32
    l1 = torch.where(swap, hi, lo)
    h1 = torch.where(swap, lo, hi)
    return ((l1 << s) | (h1 >> (32 - s))) & M32, ((h1 << s) | (l1 >> (32 - s))) & M32


def keccak_f(lo, hi):
    """keccak-f[1600] on a state of 25 lanes, (lo, hi) each (25,) int64
    words in flat order i = x + 5 y (FIPS 202); returns the same."""
    dev = lo.device
    rot = torch.tensor(_ROT_FLAT, dtype=I64, device=dev)
    pi = torch.tensor(_PI_SRC, dtype=torch.long, device=dev)
    rot_pi = rot[pi]
    for r in range(24):
        # theta
        l5, h5 = lo.reshape(5, 5), hi.reshape(5, 5)  # [y, x]
        cl = l5[0] ^ l5[1] ^ l5[2] ^ l5[3] ^ l5[4]
        ch = h5[0] ^ h5[1] ^ h5[2] ^ h5[3] ^ h5[4]
        cl1, ch1 = torch.roll(cl, -1), torch.roll(ch, -1)
        dl = torch.roll(cl, 1) ^ (((cl1 << 1) | (ch1 >> 31)) & M32)
        dh = torch.roll(ch, 1) ^ (((ch1 << 1) | (cl1 >> 31)) & M32)
        lo = (l5 ^ dl[None]).reshape(25)
        hi = (h5 ^ dh[None]).reshape(25)
        # rho and pi: gather each destination's source lane, then rotate
        lo, hi = _rotl(lo[pi], hi[pi], rot_pi)
        # chi along x
        l5, h5 = lo.reshape(5, 5), hi.reshape(5, 5)
        lo = (l5 ^ (~torch.roll(l5, -1, 1) & torch.roll(l5, -2, 1))).reshape(25)
        hi = (h5 ^ (~torch.roll(h5, -1, 1) & torch.roll(h5, -2, 1))).reshape(25)
        # iota
        lo = lo.clone()
        hi = hi.clone()
        lo[0] ^= _RC[r] & M32
        hi[0] ^= _RC[r] >> 32
    return lo, hi


def sha3_256_words(words, nbytes: int):
    """SHA3-256 of an nbytes-byte message held in little-endian int64 words
    (ceil(nbytes / 4) of them, the last zero above its message bytes) ->
    (8,) digest words.  Any length: one keccak-f per 136-byte block."""
    nw = (nbytes + 3) // 4
    nblk = nbytes // 136 + 1
    dev = words.device
    full = torch.zeros(nblk * RATE_WORDS, dtype=I64, device=dev)
    full[:nw] = words[:nw]
    full[nbytes // 4] |= 0x06 << (8 * (nbytes % 4))  # domain padding after the message
    full[-1] |= 0x80 << 24  # and at the rate's last byte
    lo = torch.zeros(25, dtype=I64, device=dev)
    hi = torch.zeros(25, dtype=I64, device=dev)
    for b in range(nblk):
        blk = full[b * RATE_WORDS : (b + 1) * RATE_WORDS]
        lo = torch.cat([lo[:17] ^ blk[0::2], lo[17:]])
        hi = torch.cat([hi[:17] ^ blk[1::2], hi[17:]])
        lo, hi = keccak_f(lo, hi)
    return torch.stack([lo[:4], hi[:4]], dim=1).reshape(8)


def limbs_to_words(v):
    """Canonical (18,) 15-bit limbs -> (8,) little-endian 32-bit words."""
    bits = (v[:, None] >> torch.arange(W, device=v.device)) & 1  # (18, 15)
    bits = bits.reshape(-1)[:256].reshape(8, 32)
    return (bits << torch.arange(32, device=v.device)).sum(1)


def words_to_limbs(words):
    """(8,) words of a 256-bit value -> (18,) 15-bit limbs of the whole
    value (not reduced; limb 17 holds bit 255)."""
    bits = ((words[:, None] >> torch.arange(32, device=words.device)) & 1).reshape(256)
    bits = torch.cat([bits, bits.new_zeros(L * W - 256)]).reshape(L, W)
    return (bits << torch.arange(W, device=words.device)).sum(1)


def mod_r_256(limbs):
    """(18,) limbs of a value below 2^256 -> its canonical limbs mod r
    (r > 2^254, so at most three conditional subtractions)."""
    v = limbs.clone()
    r = torch.tensor(_R_LIMBS, dtype=I64, device=limbs.device)
    for _ in range(3):
        ge = ~limbs_lt(v, r)
        diff, borrow = [], 0
        for k in range(L):
            dk = v[k] - r[k] - borrow
            borrow = (dk < 0).to(I64)
            diff.append(dk + (borrow << W))
        v = torch.where(ge, torch.stack(diff), v)
    return v


def limbs_lt(v, c):
    """Lexicographic v < c of (18,) clean limbs, from the top limb down."""
    d = v - c
    idx = torch.where(d != 0, torch.arange(L, device=v.device), -1).max()
    return (idx >= 0) & (d[idx.clamp(min=0)] < 0)


def limbs_gt_const(v, const: int):
    """Lexicographic (v > const) for canonical (18,) limbs against a
    Python-int constant."""
    c = torch.tensor([(const >> (W * i)) & 0x7FFF for i in range(L)], dtype=I64, device=v.device)
    return limbs_lt(c, v)


def emit_bytes(msgw, byteoff: int, words, nbytes: int):
    """OR nbytes little-endian bytes held in `words` into the word tensor
    msgw from byte offset byteoff (word-misaligned offsets shift across
    word boundaries); returns the new msgw.  Source words must be zero
    above their message bytes but the last, which is masked."""
    sh = (byteoff % 4) * 8
    base = byteoff // 4
    nw = (nbytes + 3) // 4
    w = words[:nw].clone()
    if nbytes % 4:
        w[-1] &= (1 << (8 * (nbytes % 4))) - 1
    out = msgw.clone()
    out[base : base + nw] |= (w << sh) & M32
    if sh:
        out[base + 1 : base + nw + 1] |= w >> (32 - sh)
    return out


def rho_device(parts_words, nbytes: int, tag: int):
    """rho_tag on tensors: SHA3-256(parts || tag as u32 LE) reduced into
    canonical Fr limbs.  parts_words: (nbytes / 4,) words (nbytes % 4 == 0,
    as at every call site)."""
    assert nbytes % 4 == 0
    words = torch.cat([parts_words, torch.tensor([tag], dtype=I64, device=parts_words.device)])
    return mod_r_256(words_to_limbs(sha3_256_words(words, nbytes + 4)))


def ser_point_words(ax, ay, inf):
    """ser_point on tensors: (8 x-words, x = 0 at infinity; the flag byte)
    from canonical affine limbs and the infinity flag."""
    xw = limbs_to_words(torch.where(inf, torch.zeros_like(ax), ax))
    neg = limbs_gt_const(ay, (_fields.Q - 1) // 2)  # y > Q - y  <=>  y > (Q - 1) / 2
    flag = torch.where(inf, ser.SW_INFINITY, torch.where(neg, ser.SW_Y_NEG, 0))
    return xw, flag


RHO_ROUND_BYTES = 102  # xi (32) || ser_point(L) (33) || ser_point(R) (33) || the rho_0 tag (4)


def rho_round(xi, Lax, Lay, Linf, Rax, Ray, Rinf):
    """xi_{i+1} = rho_0(ser(xi), ser_point(L), ser_point(R)) (pcdl.rs:212)
    from canonical (18,) limbs of xi and of L's and R's affine coordinates
    and their infinity flags: the 102-byte message (flag bytes at offsets
    64 and 97, R's x from the unaligned byte 65, the zero tag last), hashed
    and reduced into canonical Fr limbs."""
    msg = torch.zeros(27, dtype=I64, device=xi.device)
    msg = emit_bytes(msg, 0, limbs_to_words(xi), 32)
    Lxw, Lflag = ser_point_words(Lax, Lay, Linf)
    msg = emit_bytes(msg, 32, Lxw, 32)
    msg[16] |= Lflag
    Rxw, Rflag = ser_point_words(Rax, Ray, Rinf)
    msg = emit_bytes(msg, 65, Rxw, 32)
    msg[24] |= Rflag << 8
    return mod_r_256(words_to_limbs(sha3_256_words(msg, RHO_ROUND_BYTES)))
