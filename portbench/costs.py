"""The benchmark's yardstick arithmetic, frozen: the least work of each
port kernel's function, the least time the H100 needs for it, and the union
of device intervals.

Copied from chip_smoke.py (MIN_MULS_*, the finv and keccak counts, bound())
and from its _busy_us, which tools/port_graphs_ab.py runs; a test holds each
constant to chip_smoke.py.  The bound counts the least work of the
function, not of the implementation:

  * bytes: each input read once and each output written once, 32 bytes a
    field value, 96 a projective point;
  * operations: 32-bit multiplies, one IMAD each (a lower bound), 88 a
    multiply modulo q or r on eight 32-bit words (64 products and 24 for
    Montgomery's reduction), 60 a square; a complete add 12 multiplies, a
    double 6 multiplies and 2 squares (Renes-Costello-Batina 2016, a = 0);
    an inversion the fewer of Fermat's shortest sliding-window chain and
    Bernstein-Yang's 590 divsteps; a keccak-f[1600] 4,320 32-bit logic
    operations;

and the least time is the larger of the bytes over the HBM rate and the
operations over 132 SMs x 64 IMADs a clock at the SM clock read.
"""

from __future__ import annotations

from portbench.reference import curve

MEM_RATE = 3.35e12  # H100 SXM HBM3, bytes/s
IMAD_PER_CLOCK_SM = 64  # 32-bit integer multiply(-add)s per clock per SM, compute capability 9.0
SMS = 132

FQ_BYTES = 32
MIN_MULS_FMUL = 64 + 8 * 3
MIN_MULS_SQR = 8 * 9 // 2 + 8 * 3
MIN_MULS_PADD = 12 * MIN_MULS_FMUL
MIN_MULS_MADD = 11 * MIN_MULS_FMUL
MIN_MULS_PDBL = 6 * MIN_MULS_FMUL + 2 * MIN_MULS_SQR

FINV_DIVSTEPS = 590
FINV_BATCH = 30
DIVSTEP_OPS = 21
MATRIX_MULS = 36 + 36 + 8
FINV_DIVSTEP_OPS32 = FINV_DIVSTEPS * DIVSTEP_OPS + -(-FINV_DIVSTEPS // FINV_BATCH) * MATRIX_MULS

KECCAK_OPS32 = 24 * (20 + 10 + 50 + 48 + 50 + 2)
RHO_BYTES = 6 * 32 + 2


def sliding_window_chain(e: int, k: int) -> tuple[int, int]:
    """(squarings, multiplies) of the left-to-right sliding-window chain
    for e with windows of at most k bits."""
    sq, mu = (1, (1 << (k - 1)) - 1) if k > 1 else (0, 0)
    bits = bin(e)[2:]
    i, first = 0, True
    while i < len(bits):
        if bits[i] == "0":
            sq, i = sq + 1, i + 1
            continue
        j = min(i + k, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if not first:
            sq, mu = sq + j - i, mu + 1
        first, i = False, j
    return sq, mu


def finv_least_ops(p: int) -> int:
    """The least 32-bit operations of one inversion mod p: divsteps or
    Fermat's cheapest sliding-window chain for p - 2, whichever is fewer."""
    sq, mu = min((sliding_window_chain(p - 2, k) for k in range(1, 9)),
                 key=lambda c: c[0] * MIN_MULS_SQR + c[1] * MIN_MULS_FMUL)
    return min(FINV_DIVSTEP_OPS32, sq * MIN_MULS_SQR + mu * MIN_MULS_FMUL)


def least_seconds(nbytes: float, ops32: float, sm_mhz: float) -> float:
    """The larger of the bytes over the memory rate and the 32-bit
    operations over the IMAD rate at sm_mhz."""
    return max(nbytes / MEM_RATE, ops32 / (SMS * IMAD_PER_CLOCK_SM * sm_mhz * 1e6))


def launch_least_seconds(kernel: str, width: int, sm_mhz: float) -> float | None:
    """The least time of one launch of a port kernel at `width` lanes, for
    the kernels whose least work follows from the width alone: fmul, padd,
    pdbl (one doubling: the counters do not keep k, so this bounds k >= 1
    from below), finv (the cheaper of the two fields) and rho_round (one
    keccak-f whatever the width).  None for the bucket kernels, whose least
    work is their live slots, which no counter reads yet."""
    if kernel == "fmul":
        return least_seconds(3 * FQ_BYTES * width, MIN_MULS_FMUL * width, sm_mhz)
    if kernel == "padd":
        return least_seconds(9 * FQ_BYTES * width, MIN_MULS_PADD * width, sm_mhz)
    if kernel == "pdbl":
        return least_seconds(6 * FQ_BYTES * width, MIN_MULS_PDBL * width, sm_mhz)
    if kernel == "finv":
        ops = min(finv_least_ops(curve.Q), finv_least_ops(curve.R))
        return least_seconds(2 * FQ_BYTES * width, ops * width, sm_mhz)
    if kernel == "rho_round":
        return least_seconds(RHO_BYTES, KECCAK_OPS32, sm_mhz)
    return None


ROOFLINE_KERNELS = ("fmul", "padd", "pdbl", "finv", "rho_round")


def busy_seconds(intervals) -> float:
    """The union of (start, end) intervals sorted by start: the time in
    which at least one ran."""
    busy, hi = 0.0, float("-inf")
    for start, end in intervals:
        busy += max(0.0, end - max(start, hi))
        hi = max(hi, end)
    return busy
