"""The benchmark's own parser of accumulation-chain files.

Two layouts: the tagged one (b"HALOCHN2" || d u64 || k u64 || steps) and
the older untagged one (d u64 || k u64 || steps).  A step is m u64, m
instances, the accumulator's length u64 and the accumulator:

    instance     C point || d u64 || z scalar || v scalar || proof
    proof        vec<point> L || vec<point> R || U point || c scalar
                 || option<point> C_bar || option<scalar> w'
    accumulator  C_bar point || d u64 || z scalar || v scalar || proof
                 || vec<scalar> h || U point || w scalar

Points are 33-byte compressed encodings, scalars 32 bytes little-endian,
vectors a u64 length and their items, options a 0/1 tag byte.  Every field
keeps its offset in the file, so a copy can be changed in one field.
Points stay bytes here; `point()` decompresses one, memoized.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from portbench.reference import curve

MAGIC = b"HALOCHN2"


@functools.lru_cache(maxsize=1 << 16)
def point(b: bytes):
    return curve.decompress(b)


@dataclass
class Proof:
    Ls: list  # compressed points
    Rs: list
    U: bytes
    c: int
    C_bar: bytes | None
    w_prime: int | None
    at: dict  # field -> (offset, length); "L" and "R" -> lists of them


@dataclass
class Claim:
    """An instance (C, d, z, v, pi); an accumulator adds pi_V = (h, U_0, w)."""

    C: bytes
    d: int
    z: int
    v: int
    pi: Proof
    at: dict
    h: list | None = None
    U0: bytes | None = None
    w: int | None = None
    span: tuple = (0, 0)  # the claim's bytes in the file


@dataclass
class Chain:
    d: int
    qss: list  # per step, its instances
    accs: list  # per step, its accumulator
    raw: bytes


class _Reader:
    def __init__(self, b: bytes, off: int):
        self.b, self.off = b, off

    def take(self, n: int) -> tuple[bytes, int]:
        at = self.off
        chunk = self.b[at : at + n]
        if len(chunk) != n:
            raise ValueError(f"chain file ends at byte {len(self.b)}, expected {n} more at {at}")
        self.off += n
        return chunk, at

    def u64(self) -> int:
        return int.from_bytes(self.take(8)[0], "little")

    def scalar(self) -> tuple[int, int]:
        b, at = self.take(32)
        return int.from_bytes(b, "little"), at

    def point(self) -> tuple[bytes, int]:
        return self.take(curve.POINT_BYTES)


def _proof(rd: _Reader) -> Proof:
    at = {}
    vecs = []
    for key in ("L", "R"):
        pts, offs = [], []
        for _ in range(rd.u64()):
            p, o = rd.point()
            pts.append(p)
            offs.append((o, curve.POINT_BYTES))
        vecs.append(pts)
        at[key] = offs
    U, o = rd.point()
    at["U"] = (o, curve.POINT_BYTES)
    c, o = rd.scalar()
    at["c"] = (o, 32)
    C_bar = w_prime = None
    if rd.take(1)[0] == b"\x01":
        C_bar, o = rd.point()
        at["C_bar"] = (o, curve.POINT_BYTES)
    if rd.take(1)[0] == b"\x01":
        w_prime, o = rd.scalar()
        at["w_prime"] = (o, 32)
    return Proof(vecs[0], vecs[1], U, c, C_bar, w_prime, at)


def _claim(rd: _Reader, accumulator: bool) -> Claim:
    start = rd.off
    C, oC = rd.point()
    d = rd.u64()
    z, oz = rd.scalar()
    v, ov = rd.scalar()
    pi = _proof(rd)
    cl = Claim(C, d, z, v, pi, {"C": (oC, curve.POINT_BYTES), "z": (oz, 32), "v": (ov, 32)})
    if accumulator:
        cl.h = [rd.scalar()[0] for _ in range(rd.u64())]
        cl.U0, o = rd.point()
        cl.at["U0"] = (o, curve.POINT_BYTES)
        cl.w, o = rd.scalar()
        cl.at["w"] = (o, 32)
    cl.span = (start, rd.off)
    return cl


def parse(raw: bytes) -> Chain:
    rd = _Reader(raw, len(MAGIC) if raw[: len(MAGIC)] == MAGIC else 0)
    d = rd.u64()
    qss, accs = [], []
    for _ in range(rd.u64()):
        qss.append([_claim(rd, False) for _ in range(rd.u64())])
        alen = rd.u64()
        start = rd.off
        accs.append(_claim(rd, True))
        if rd.off != start + alen:
            raise ValueError(f"accumulator at byte {start} is {rd.off - start} bytes, its header says {alen}")
    if rd.off != len(raw):
        raise ValueError(f"chain file has {len(raw) - rd.off} bytes after its last step")
    return Chain(d, qss, accs, raw)


def read(path) -> Chain:
    with open(path, "rb") as f:
        return parse(f.read())
