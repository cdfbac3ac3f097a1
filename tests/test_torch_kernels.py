"""Port parity of the plain twins of the five Hopper kernels.

On the CPU each wrapper runs its plain PyTorch twin.  The twins are held to
the JAX package: fmul/padd/pdbl to the list-form limb math that is the body
of the Pallas kernels (ops/limbs.py, run here on numpy) and to the stacked
JAX curve ops, limb for limb; the row-permutation bucket sums to the body
of _bucket_kernel_aff / _bucket_kernel_proj, limb for limb; the masked
bucket reduction, at every split of a column across threads, to per-column
sums on the int oracle, with dead and foreign slots.  The six-threads-per-lane
padd kernel's operand tables are replayed on the plain field ops and held to
the twin, and each kernel's ctypes signature to its C entry point.  The
kernels themselves are held to these twins on a card by
tests/test_torch_cuda.py."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from halo_accumulation_tpu import fields as F
from halo_accumulation_tpu.ops import curve as jcv, limbs
from halo_accumulation_tpu.ops import pallas_kernels as pk
from halo_accumulation_tpu.ops.field import FQ as JFQ
from halo_accumulation_tpu.runtime import cached_jit
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck, curve as cv, msm as msm_mod
from halo_accumulation_tpu_torch.ops.field import FQ, L, ints_to_limb_array

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

PADD_CU = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc" / "padd.cu"


LF = limbs.ListField(JFQ)


def rand_point(rng):
    return F.p_mul(int.from_bytes(rng.bytes(40), "little") % F.R, (F.G_X, F.G_Y))


def point_pairs(rng, n):
    """Host pairs (P, Q) over n lanes: random sums, the identity on either
    side, P == Q and P == -Q."""
    base = [rand_point(rng) for _ in range(8)] + [None]
    ps, qs = [], []
    for i in range(n):
        p = base[rng.integers(0, len(base))]
        kind = i % 5
        q = (base[rng.integers(0, len(base))], None, p, F.p_neg(p), rand_point(rng))[kind]
        ps.append(p)
        qs.append(q)
    return ps, qs


def lazy(P, rng):
    """The same projective points with every coordinate times a random
    nonzero lambda: lazy, non-canonical limbs."""
    n = P.x.shape[1]
    lam = FQ.from_ints([int.from_bytes(rng.bytes(40), "little") % (F.Q - 1) + 1 for _ in range(n)])
    return cv.PointVec(*(FQ.mul(c, lam) for c in P))


def as_list(t):
    a = t.numpy().astype(np.uint32)
    return [a[i] for i in range(L)]


def as_np(limb_list):
    return np.stack(limb_list).astype(np.int64)


@pytest.fixture
def lanes(rng):
    ps, qs = point_pairs(rng, 32)
    P = lazy(cv.from_affine_ints(ps), rng)
    Q = lazy(cv.from_affine_ints(qs), rng)
    return ps, qs, P, Q


def test_fmul_twin_matches_list_form(rng):
    lim = rng.integers(0, 1 << 15, size=(2, L, 96), dtype=np.int64)
    lim[:, 17] &= 3  # raw values below 2^257, the lazy bound
    a, b = torch.from_numpy(lim[0]), torch.from_numpy(lim[1])
    got = ck.fmul(a, b)
    assert np.array_equal(got.numpy(), as_np(LF.mul(as_list(a), as_list(b))))
    assert FQ.to_ints(got) == [x * y % F.Q for x, y in zip(FQ.to_ints(a), FQ.to_ints(b))]


@pytest.mark.parametrize("op", ["padd", "pdbl"])
def test_point_twin_matches_list_form(lanes, op):
    ps, qs, P, Q = lanes
    if op == "padd":
        got = ck.padd(tuple(P), tuple(Q))
        want = limbs.padd_list(LF, tuple(map(as_list, P)), tuple(map(as_list, Q)))
        oracle = [F.p_add(p, q) for p, q in zip(ps, qs)]
    else:
        got = ck.pdbl(tuple(P))
        want = limbs.pdbl_list(LF, tuple(map(as_list, P)))
        oracle = [F.p_add(p, p) for p in ps]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), as_np(w))
    assert cv.to_host(cv.PointVec(*got)) == oracle


@pytest.mark.parametrize("op", ["padd", "pdbl"])
def test_point_ops_match_jax_curve(lanes, op):
    """curve.padd / curve.pdbl of both packages on the same lazy inputs:
    the same limbs (the JAX stacked formulas group the multiplies exactly
    as the twins do)."""
    _, _, P, Q = lanes
    jP = jcv.PointVec(*(np.asarray(c, np.uint32) for c in P))
    jQ = jcv.PointVec(*(np.asarray(c, np.uint32) for c in Q))
    if op == "padd":
        got = cv.padd(P, Q)
        want = cached_jit(jcv.padd, "torch_parity")(jP, jQ)
    else:
        got = cv.pdbl(P)
        want = cached_jit(jcv.pdbl, "torch_parity")(jP)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def _bucket_case(rng, lanes):
    """Sorted-payload matrix M (lanes, padp, cols) and meta for 40 columns:
    each slot holds a point; the slots outside [off, off + len) are foreign
    and must be ignored; some columns are dead (len 0)."""
    pts = [rand_point(rng) for _ in range(12)]
    padp, cols = 24, 40
    src = rng.integers(0, len(pts), (padp, cols))
    P = cv.from_affine_ints(pts)
    if lanes == L:
        planes = msm_mod.planes_from_affine(P.x, P.y)
    else:
        planes = torch.cat(list(lazy(P, rng)))
    M = planes[:, torch.from_numpy(src)]
    off = rng.integers(0, 8, cols)
    ln = rng.integers(0, padp - 7, cols)
    ln[:4] = 0
    meta = torch.from_numpy((off | (ln << 3)).reshape(1, cols))
    want = []
    for c in range(cols):
        acc = None
        for p in range(off[c], off[c] + ln[c]):
            acc = F.p_add(acc, pts[src[p, c]])
        want.append(acc)
    return M, meta, want


@pytest.mark.parametrize("lanes", [18, 54], ids=["affine18", "proj54"])
def test_bucket_masked_twin_vs_oracle(rng, lanes):
    M, meta, want = _bucket_case(rng, lanes)
    got = ck.bucket_masked(M, meta)
    assert all(g.shape == (L, M.shape[2]) for g in got)
    assert cv.to_host(cv.PointVec(*got)) == want
    # dead columns hold exactly the identity (0 : 1 : 0)
    dead = (meta[0] >> 3) == 0
    assert cv.is_identity(cv.PointVec(*got))[dead].all()


def _bucket_masked_one_thread(M, meta):
    """The first port's twin (one ordered sum per column), kept as the
    reference order of a split of one: p = off .. end - 1 from the identity,
    dead slots skipped."""
    lanes, padp, cols = M.shape
    off = meta[0] & 7
    end = torch.clamp(off + (meta[0] >> 3), max=padp)
    ax, ay, az = cv.identity((cols,))
    ax, ay, az = ax.clone(), ay.clone(), az.clone()
    for p in range(int(off.min()), int(end.max())):
        idx = ((off <= p) & (end > p)).nonzero().squeeze(1)
        S = ck.slot_points(M[:, p, idx], lanes)
        ax[:, idx], ay[:, idx], az[:, idx] = ck.padd_plain((ax[:, idx], ay[:, idx], az[:, idx]), S)
    return ax, ay, az


@pytest.mark.parametrize("T", [1, 2, 4, 8])
@pytest.mark.parametrize("lanes", [18, 54], ids=["affine18", "proj54"])
def test_bucket_masked_split_vs_oracle(rng, lanes, T):
    """Any split of a column's live slots across T threads, then the tree
    combine, sums to the int oracle's point; a dead column is exactly
    (0 : 1 : 0), limb for limb."""
    M, meta, want = _bucket_case(rng, lanes)
    got = ck.bucket_masked_plain(M, meta, T)
    assert cv.to_host(cv.PointVec(*got)) == want
    dead = (meta[0] >> 3) == 0
    assert int(dead.sum()) >= 4
    for g, i in zip(got, cv.identity((int(dead.sum()),))):
        assert torch.equal(g[:, dead], i)


@pytest.mark.parametrize("lanes", [18, 54], ids=["affine18", "proj54"])
def test_bucket_masked_split_of_one_is_first_port_order(rng, lanes):
    """T = 1 adds the slots in the first port's order: the same limbs."""
    M, meta, _ = _bucket_case(rng, lanes)
    got = ck.bucket_masked_plain(M, meta, 1)
    for g, w in zip(got, _bucket_masked_one_thread(M, meta)):
        assert torch.equal(g, w)


def test_bucket_split_from_shapes_only(rng):
    """The split is a function of (padp, cols) alone: the n = 16384
    verify_chain decider's main group takes 4 threads per column, the
    prover's dual round 2, decide_many's ten stacked MSMs 2, a pad too
    short for two chunks of 8 slots 1; the wrapper passes it to the twin
    whatever the lanes and the fill."""
    assert ck.bucket_split(136, 31 * 256) == 4
    assert ck.bucket_split(104, 2 * 31 * 256) == 2
    assert ck.bucket_split(136, 10 * 31 * 256) == 2
    assert ck.bucket_split(24, 40) == 2
    assert ck.bucket_split(8, 40) == 1
    assert ck.bucket_split(136, 4096) == 4 and ck.bucket_split(1 << 10, 1) == 16
    for lanes in (18, 54):
        M, meta, _ = _bucket_case(rng, lanes)
        T = ck.bucket_split(*M.shape[1:])
        for m in (meta, meta & 7, meta | (M.shape[1] << 3)):  # as given, all dead, all full
            for g, w in zip(ck.bucket_masked(M, m), ck.bucket_masked_plain(M, m, T)):
                assert torch.equal(g, w)


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__6d721cef_16_bucket_masked_cu_81efb88e20bucket_masked_kernelEPKlS1_PlS2_S2_illi' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__6d721cef_16_bucket_masked_cu_81efb88e20bucket_masked_kernelEPKlS1_PlS2_S2_illi
    64 bytes stack frame, 136 bytes spill stores, 260 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 64 bytes cumulative stack size, 27648 bytes smem
ptxas info    : Function properties for _ZN4halo3mulENS_2FeES0_
    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Compiling entry function '_Z11fmul_kernelPKlS0_Pll' for 'sm_90a'
ptxas info    : Function properties for _Z11fmul_kernelPKlS0_Pll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers
ptxas info    : Function properties for _ZN4halo3mulENS_2FeES0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_parse_ptxas_keys_callees_by_entry():
    """The ptxas report names entries (nested in an anonymous namespace or
    not) and their callees, and keeps each entry's own copy of a callee
    apart."""
    got = ck.parse_ptxas(_PTXAS_LOG)
    assert got == {
        "bucket_masked_kernel": {"stack": 64, "spill_stores": 136, "spill_loads": 260, "registers": 255},
        "bucket_masked_kernel/halo::mul": {"stack": 0, "spill_stores": 12, "spill_loads": 12},
        "fmul_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 72},
        "fmul_kernel/halo::mul": {"stack": 0, "spill_stores": 0, "spill_loads": 0},
    }


@pytest.mark.parametrize("k", [1, 4, 8])
def test_pdbl_k_matches_list_form_and_jax(lanes, k):
    """k doublings in one call equal k applications of the list-form
    pdbl_list and of the JAX curve's pdbl, limb for limb, and 2^k P on the
    int oracle."""
    ps, _, P, _ = lanes
    got = ck.pdbl_plain(tuple(P), k)
    want = tuple(map(as_list, P))
    jwant = jcv.PointVec(*(np.asarray(c, np.uint32) for c in P))
    jdbl = cached_jit(jcv.pdbl, "torch_parity")
    for _ in range(k):
        want = limbs.pdbl_list(LF, want)
        jwant = jdbl(jwant)
    for g, w, j in zip(got, want, jwant):
        assert np.array_equal(g.numpy(), as_np(w))
        assert np.array_equal(g.numpy(), np.asarray(j).astype(np.int64))
    assert all(torch.equal(g, c) for g, c in zip(got, cv.pdbl(P, k)))
    oracle = ps
    for _ in range(k):
        oracle = [F.p_add(p, p) for p in oracle]
    assert cv.to_host(cv.PointVec(*got)) == oracle


@pytest.mark.parametrize("lanes", [40, 64], ids=["affine40", "proj64"])
def test_bucket_accum_twin_matches_pallas_body(rng, lanes):
    """bucket_accum_plain equals the body of _bucket_kernel_aff /
    _bucket_kernel_proj limb for limb: the list-form padd folded over the
    pad axis from the identity (0 : 1 : 0), every slot added, sentinels
    included, run as plain jnp on numpy lanes (the Pallas interpreter is
    too slow here, as in tests/test_pallas.py).  The sums also equal the
    int oracle's."""
    pts = [rand_point(rng) for _ in range(10)]
    P = cv.from_affine_ints(pts)
    rows = msm_mod.rows_from_affine(P.x, P.y) if lanes == 40 else msm_mod.rows_from_points(lazy(P, rng))
    assert rows.shape == (len(pts) + 1, lanes)
    pad, cols = 3, 128
    src = rng.integers(0, len(pts) + 1, (pad, cols))  # len(pts): the sentinel row
    src[:, :4] = len(pts)  # all-sentinel columns: the identity
    got = ck.bucket_accum(rows, torch.from_numpy(src))
    Mt = rows.numpy().astype(np.uint32)[src].transpose(2, 0, 1)  # (lanes, pad, cols), as _bucket_call's input
    zero = np.zeros(cols, np.uint32)
    acc = ([zero] * L, [zero + 1] + [zero] * (L - 1), [zero] * L)
    for p in range(pad):
        xs = [Mt[i, p] for i in range(L)]
        ys = [Mt[L + i, p] for i in range(L)]
        zs = [Mt[2 * L, p]] + [zero] * (L - 1) if lanes == 40 else [Mt[2 * L + i, p] for i in range(L)]
        acc = pk.padd_limbs(acc, (xs, ys, zs))
    for g, w in zip(got, acc):
        assert np.array_equal(g.numpy(), as_np(w))
    want = []
    for c in range(cols):
        s = None
        for p in range(pad):
            s = F.p_add(s, pts[src[p, c]] if src[p, c] < len(pts) else None)
        want.append(s)
    assert cv.to_host(cv.PointVec(*got)) == want


def _bucket_accum_case(rng, lanes, pad, cols):
    """A small row table (ten points, the sentinel last; projective rows
    with lazy limbs), indices with about one slot in five the sentinel, and
    each column's sum on the int oracle."""
    pts = [rand_point(rng) for _ in range(10)]
    P = cv.from_affine_ints(pts)
    rows = msm_mod.rows_from_affine(P.x, P.y) if lanes == 40 else msm_mod.rows_from_points(lazy(P, rng))
    src = rng.integers(0, len(pts) + 1, (pad, cols))
    src[rng.random((pad, cols)) < 0.2] = len(pts)
    want = []
    for c in range(cols):
        s = None
        for p in range(pad):
            s = F.p_add(s, pts[src[p, c]] if src[p, c] < len(pts) else None)
        want.append(s)
    return rows, torch.from_numpy(src), want


@pytest.mark.parametrize("T", [1, 2, 4, 8])
@pytest.mark.parametrize("lanes", [40, 64], ids=["affine40", "proj64"])
def test_bucket_accum_split_vs_oracle(rng, lanes, T):
    """Any split of a column's slots across T threads, then the tree
    combine, sums to the int oracle's point, held as canonical points (13
    slots: at T = 8 chunks of 2 and the last one empty); the wrapper runs
    the twin at the T it is given."""
    rows, src, want = _bucket_accum_case(rng, lanes, 13, 12)
    got = ck.bucket_accum_plain(rows, src, T)
    assert cv.to_host(cv.PointVec(*got)) == want
    for g, w in zip(ck.bucket_accum(rows, src, T), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lanes", [40, 64], ids=["affine40", "proj64"])
def test_bucket_accum_split_from_shapes_only(rng, lanes):
    """The wrapper's default split is accum_split(pad, cols), from the
    shapes alone: 4 threads a column at the n = 16384 main group (128 slots,
    7,936 columns, the fill target), 16 at the folded top window (48 slots,
    1,024 columns: chunks of 3), 1 below 4 slots; an all-sentinel column is
    the identity at every split; other splits are refused."""
    assert ck.accum_split(128, 31 * 256) == 4 and ck.accum_split(48, 1024) == 16
    assert ck.accum_split(3, 128) == 1 and ck.accum_split(16, 6) == 8
    rows, src, want = _bucket_accum_case(rng, lanes, 16, 6)
    src[:, 0] = rows.shape[0] - 1
    got = ck.bucket_accum(rows, src)
    for g, w in zip(got, ck.bucket_accum_plain(rows, src, 8)):
        assert torch.equal(g, w)
    assert cv.to_host(cv.PointVec(*got)) == [None] + want[1:]
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="bucket_accum splits"):
            ck.bucket_accum(rows, src, bad)


def test_affine_planes_roundtrip(rng):
    vs = [rand_point(rng) for _ in range(16)]
    xs = torch.from_numpy(ints_to_limb_array([p[0] for p in vs]))
    ys = torch.from_numpy(ints_to_limb_array([p[1] for p in vs]))
    packed = msm_mod.planes_from_affine(xs, ys)
    assert packed.shape == (L, 16) and int(packed.max()) < (1 << 30)
    ux, uy = msm_mod.unpack_affine_planes(packed)
    assert torch.equal(ux, xs) and torch.equal(uy, ys)


def edge_pairs(rng, n):
    """Host pairs (P, Q) over n lanes cycling through the identity plus a
    point, P == Q, P == -Q, a point plus the identity, the identity twice
    and a random sum."""
    base = [rand_point(rng) for _ in range(6)]
    ps, qs = [], []
    for i in range(n):
        p, q = base[rng.integers(0, 6)], base[rng.integers(0, 6)]
        ps.append((None, p, p, p, None, p)[i % 6])
        qs.append((q, p, F.p_neg(p), None, None, q)[i % 6])
    return ps, qs


@pytest.fixture(scope="module")
def padd_edge_lanes():
    """33 lazy edge-case lanes and the JAX curve's padd of them (one
    compile: the JAX add is lane by lane, so a prefix of its lanes is its
    add of the prefix)."""
    rng = np.random.default_rng(55)
    ps, qs = edge_pairs(rng, 33)
    P, Q = lazy(cv.from_affine_ints(ps), rng), lazy(cv.from_affine_ints(qs), rng)
    jP, jQ = (jcv.PointVec(*(np.asarray(c, np.uint32) for c in X)) for X in (P, Q))
    jwant = cached_jit(jcv.padd, "torch_parity")(jP, jQ)
    return ps, qs, P, Q, [np.asarray(w).astype(np.int64) for w in jwant]


@pytest.mark.parametrize("n", [1, 5, 33])
def test_padd_twin_edge_lanes(padd_edge_lanes, n):
    """padd_plain on the first n edge-case lanes equals the list-form
    padd_list and the JAX curve's padd limb for limb, and the int oracle;
    the wrapper returns the same."""
    ps, qs, P, Q, jwant = padd_edge_lanes
    Pn, Qn = tuple(c[:, :n] for c in P), tuple(c[:, :n] for c in Q)
    got = ck.padd_plain(Pn, Qn)
    want = limbs.padd_list(LF, tuple(map(as_list, Pn)), tuple(map(as_list, Qn)))
    for g, w, j in zip(got, want, jwant):
        assert np.array_equal(g.numpy(), as_np(w))
        assert np.array_equal(g.numpy(), j[:, :n])
    assert all(torch.equal(a, b) for a, b in zip(ck.padd(Pn, Qn), got))
    assert cv.to_host(cv.PointVec(*got)) == [F.p_add(p, q) for p, q in zip(ps[:n], qs[:n])]


# csrc/padd.cu's operand tables, four bits an entry, entry r (thread r of a
# lane) lowest: level A's coordinate and, for threads 3 to 5, the second
# coordinate of the cross sum; the middle section's sum operands and the
# product it subtracts from or adds to; level C's two operands.
PADD_TABLES = {"a_first": 0x010210, "a_second": 0x221000, "mid_p": 0x000010, "mid_q": 0x000221,
               "mid_d": 0x011543, "c_left": 0x542310, "c_right": 0x015423}


def test_padd_split_dataflow_matches_twin(padd_edge_lanes):
    """The six-threads-per-lane add of csrc/padd.cu, thread by thread, on
    the plain field ops: PADD_TABLES pick, for thread r, the level A
    operands, the middle section's inputs and the level C operands, and the
    three output coordinates come from products (0, 1), (2, 3), (4, 5).
    Run so, it equals padd_plain limb for limb: the kernel's every product,
    small multiply, sub and add is the twin's.  Every table is a literal of
    the source.  A development aid: the check of record is the card test
    test_padd_layouts_match_twin, which holds the compiled kernel to the
    twin at the paths' widths."""
    _, _, P, Q, _ = padd_edge_lanes
    src = PADD_CU.read_text()
    for name, t in PADD_TABLES.items():
        assert re.search(rf"\b0x0*{t:x}u?\b", src, re.IGNORECASE), name
    T = PADD_TABLES

    def nib(t, r):
        return (t >> (4 * r)) & 0xF

    f = FQ
    A = []
    for r in range(6):  # level A
        a, b = P[nib(T["a_first"], r)], Q[nib(T["a_first"], r)]
        if r >= 3:
            a, b = f.add(a, P[nib(T["a_second"], r)]), f.add(b, Q[nib(T["a_second"], r)])
        A.append(f.mul(a, b))
    B = []
    for r in range(6):  # middle
        u = f.mul_small(A[2], ck.B3) if r in (3, 4) else f.add(A[nib(T["mid_p"], r)], A[nib(T["mid_q"], r)])
        d = A[nib(T["mid_d"], r)]
        v = f.sub(d, u) if r < 4 else f.add(d, u)
        B.append(f.mul_small(v, ck.B3) if r == 2 else v)
    C = [f.mul(B[nib(T["c_left"], r)], B[nib(T["c_right"], r)]) for r in range(6)]  # level C
    got = (f.sub(C[0], C[1]), f.add(C[2], C[3]), f.add(C[4], C[5]))
    assert all(torch.equal(g, w) for g, w in zip(got, ck.padd_plain(tuple(P), tuple(Q))))


def test_wrappers_record_no_width_for_twins(lanes):
    """Twins launch nothing, so the wrappers record no launch width on the
    CPU."""
    _, _, P, Q = lanes
    ck.reset_launches()
    ck.padd(tuple(P), tuple(Q))
    ck.pdbl(tuple(P), 2)
    ck.fmul(P.x, Q.x)
    M, meta, _ = _bucket_case(np.random.default_rng(3), L)
    ck.bucket_masked(M, meta)
    assert ck.launch_widths() == {k: {} for k in ck.KERNELS}


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int64_t": ctypes.c_int64, "int": ctypes.c_int}


@pytest.mark.parametrize("name", list(ck.KERNELS))
def test_kernel_argtypes_match_c_entry(name):
    """Each kernel's ctypes argtypes are the parameters of the C entry point
    halo_<name> in its source, in order: a mismatch would pass garbage to
    the card without an error."""
    k = ck.KERNELS[name]
    src = (PADD_CU.parent / f"{name}.cu").read_text()
    m = re.search(rf'extern "C" int halo_{name}\(([^)]*)\)', src)
    assert m, f"no C entry halo_{name} in {k.source}"
    params = [re.sub(r"\s+", " ", p.strip()) for p in m.group(1).split(",")]
    assert [_C_TYPES[p.rsplit(" ", 1)[0].replace(" *", "*")] for p in params] == k.argtypes


_PTXAS_LOG_PADD = """\
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__3fd67ec6_7_padd_cu_81efb88e11padd_kernelEPKlS1_S1_S1_S1_S1_PlS2_S2_l' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__3fd67ec6_7_padd_cu_81efb88e11padd_kernelEPKlS1_S1_S1_S1_S1_PlS2_S2_l
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 17280 bytes smem
ptxas info    : Function properties for _ZN4halo3mulENS_2FeES0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN4halo9mul_smallENS_2FeEj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN4halo3subENS_2FeES0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_parse_ptxas_reads_padd_entries():
    """The six-threads-per-lane padd entry (its register line also names
    the shared memory) is read with each of its callees."""
    got = ck.parse_ptxas(_PTXAS_LOG_PADD)
    assert got == {
        "padd_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 80},
        "padd_kernel/halo::mul": {"stack": 0, "spill_stores": 0, "spill_loads": 0},
        "padd_kernel/halo::mul_small": {"stack": 0, "spill_stores": 0, "spill_loads": 0},
        "padd_kernel/halo::sub": {"stack": 0, "spill_stores": 0, "spill_loads": 0},
    }


@pytest.mark.parametrize("threads", [0, 16, 100, 1056])
def test_fmul_refuses_bad_block_size(lanes, threads):
    """fmul's block size must be a multiple of 32 from 32 to 1024, checked
    before the wrapper picks a device, so a bad size fails here too."""
    _, _, P, Q = lanes
    with pytest.raises(ValueError, match="fmul threads"):
        ck.fmul(P.x, Q.x, threads)


def test_wrappers_route_by_device(lanes):
    """CPU tensors take the twin and count no launch; a tensor on any other
    device than the CPU or CUDA is refused, never silently computed."""
    _, _, P, Q = lanes
    ck.reset_launches()
    assert all(torch.equal(a, b) for a, b in zip(ck.padd(tuple(P), tuple(Q)), ck.padd_plain(tuple(P), tuple(Q))))
    assert torch.equal(ck.fmul(P.x, Q.x), ck.fmul_plain(P.x, Q.x))
    assert ck.launch_counts() == {"fmul": 0, "padd": 0, "pdbl": 0, "bucket_masked": 0, "bucket_accum": 0,
                                  "finv": 0, "rho_round": 0, "h_digits": 0}
    meta_dev = torch.empty((L, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ck.fmul(meta_dev, meta_dev)
    with pytest.raises(ValueError):
        ck.pdbl((P.x, P.y, meta_dev))



def test_curve_helpers_vs_oracle(lanes):
    """The curve ops around the kernels: pneg, pselect, peq, is_identity,
    to_affine (batched inversion) and sum_points, on lazy inputs."""
    ps, qs, P, Q = lanes
    S = cv.padd(P, cv.pneg(P))
    assert cv.is_identity(S).all()
    x, y, inf = cv.to_affine(P)
    assert inf.tolist() == [p is None for p in ps]
    assert [None if i else (a, b) for a, b, i in zip(FQ.to_ints(x), FQ.to_ints(y), inf.tolist())] == ps
    assert cv.peq(P, cv.from_affine_ints(ps)).all()
    assert cv.peq(P, Q).tolist() == [p == q for p, q in zip(ps, qs)]
    m = torch.arange(len(ps)) % 3 == 0
    assert cv.to_host(cv.pselect(m, P, Q)) == [p if i % 3 == 0 else q for i, (p, q) in enumerate(zip(ps, qs))]
    acc = None
    for p in ps:
        acc = F.p_add(acc, p)
    assert cv.to_host(cv.sum_points(P, 0)) == [acc]
