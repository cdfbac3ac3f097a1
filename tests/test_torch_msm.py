"""Port parity of the MSM, polynomial and URS layers.

The MSM's host-side planning (window sizes, bucket spaces, pinned pads and
window groups) must equal the JAX package's; the sort-payload MSM (one and
two routes), the batched row MSMs and the K-fold fixed-base MSM must equal
the int oracle; the row-permutation MSM's inverse permutation must equal
the JAX package's, and its result the JAX package's and the int oracle's,
for both row forms; the decider's h(X) expansion must evaluate like the JAX
HPoly; the URS must equal the int oracle (and the JAX package's cached URS
where present)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_accumulation_tpu import fields as F, pcdl as jpcdl
from halo_accumulation_tpu.ops import curve as jcv, msm as jmsm
from halo_accumulation_tpu_torch import pp as pp_mod, runtime
from halo_accumulation_tpu_torch.ops import curve as cv, msm, poly
from halo_accumulation_tpu_torch.ops.field import FR, L
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


URS_512 = pathlib.Path(__file__).resolve().parent.parent / ".urs_cache" / "urs_512.npz"


def rand_scalars(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(n)]


def oracle_msm(scs, pts):
    """F.p_msm with equal points merged first: the same sum, fewer p_mul."""
    merged: dict = {}
    for s, p in zip(scs, pts):
        merged[p] = (merged.get(p, 0) + s) % F.R
    return F.p_msm(list(merged.values()), list(merged))


@pytest.fixture(scope="module")
def base():
    """A few multiples of the generator, reused across MSM inputs to keep the
    int oracle cheap."""
    rng = np.random.default_rng(7)
    return [F.p_mul(s, (F.G_X, F.G_Y)) for s in rand_scalars(rng, 16)]


@pytest.fixture(scope="module")
def urs():
    return pp_mod.get_pp(64, "cpu")


def test_planning_matches_jax():
    for n in (1, 100, 255, 256, 2047, 2048, 16384, 1 << 15, 1 << 18, 1 << 20):
        assert msm.window_size(n) == jmsm.window_size(n)
    for m in list(range(0, 2100)) + [3000, 4097, 10000]:
        assert msm._round_pad(m) == jmsm._round_pad(m)
    for c in (4, 6, 8, 10, 12):
        assert msm.num_windows(c) == jmsm.num_windows(c)
        assert msm._beffs(c) == jmsm._beffs(c)
        for n in (128, 512, 4096, 16384, 1 << 20):
            pads = msm.pinned_pads(n, c)
            assert pads == jmsm.pinned_pads(n, c)
            beffs = msm._beffs(c)
            assert msm._group_windows(pads, beffs) == jmsm._group_windows(pads, beffs)
            assert msm._expand_groups_sorted(pads * 3, beffs * 3) == jmsm._expand_groups_sorted(pads * 3, beffs * 3, 1)
            assert msm._expand_groups_sorted(pads, beffs, 2) == jmsm._expand_groups_sorted(pads, beffs, 2)
            assert msm._expand_groups(pads, beffs) == jmsm._expand_groups(pads, beffs)
    # the n = 16384 decider: c = 8, 32 windows, top window cut to 128 buckets
    assert msm.window_size(16384) == 8 and msm._beffs(8)[:2] == [128, 256]
    assert msm.pinned_pads(16384, 8)[:2] == [384, 128]


@pytest.mark.parametrize("c", [4, 6, 8])
def test_digits_vs_ints(rng, c):
    vs = rand_scalars(rng, 24) + [0, 1, F.R - 1]
    d = msm._digits(FR.from_ints(vs), c).numpy()
    W = msm.num_windows(c)
    for j, v in enumerate(vs):
        assert [int(x) for x in d[:, j]] == [(v >> (c * (W - 1 - w))) & ((1 << c) - 1) for w in range(W)]


@pytest.mark.parametrize("n", [128, 200])
def test_sortrows_msm_vs_oracle(rng, base, n):
    pts = [base[i % len(base)] for i in range(n)]
    pts[3] = None
    scs = rand_scalars(rng, n)
    c = msm.window_size(n)
    pt, ok = msm.msm_flagged(cv.from_affine_ints(pts), FR.from_ints(scs), c=c, pads=msm.pinned_pads(n, c))
    assert bool(ok)
    assert cv.to_host(pt) == [oracle_msm(scs, pts)]


def test_msm_rows_vs_oracle(rng, base):
    B, M = 3, 7
    pts = [base[(3 * i) % len(base)] for i in range(B * M)]
    pts[5] = None
    scs = rand_scalars(rng, B * M)
    scs[4] = 0
    P = cv.from_affine_ints(pts)
    R = msm.msm_rows(cv.PointVec(*(a.reshape(L, B, M) for a in P)), FR.from_ints(scs).reshape(L, B, M))
    assert cv.to_host(R) == [oracle_msm(scs[b * M : (b + 1) * M], pts[b * M : (b + 1) * M]) for b in range(B)]


def test_dump_bucket_takes_zero_digits(rng, base):
    """Mostly-zero scalars: every zero digit lands in bucket 0, which has
    weight 0 and is never gathered, so it may hold far more than any pad."""
    n = 128
    pts = [base[i % len(base)] for i in range(n)]
    scs = [0] * n
    for i in (5, 77, 100):
        scs[i] = rand_scalars(rng, 1)[0]
    c = msm.window_size(n)
    pt, ok = msm.msm_flagged(cv.from_affine_ints(pts), FR.from_ints(scs), c=c, pads=msm.pinned_pads(n, c))
    assert bool(ok)
    assert cv.to_host(pt) == [oracle_msm(scs, pts)]


def test_pad_overflow_flags_and_falls_back(base, monkeypatch):
    """One repeated nonzero scalar overflows every pinned pad: the flag goes
    False, and msm() (pinned pads first, as the JAX msm()) re-runs with pads
    measured from the digits."""
    n = 128
    pts = [base[i % len(base)] for i in range(n)]
    k = 0x1234_5678_9ABC_DEF0_1357_9BDF
    scs = [k] * n
    P, S = cv.from_affine_ints(pts), FR.from_ints(scs)
    c = msm.window_size(n)
    assert msm._measure_pads(msm._digits(S, c), c)[-1] == msm._round_pad(n)
    want = F.p_mul(k, F.p_msm([1] * n, pts))
    flags, measured = [], []
    real_flagged, real_measure = msm.msm_flagged, msm._measure_pads

    def flagged(*args, **kw):
        pt, ok = real_flagged(*args, **kw)
        flags.append((kw["pads"], bool(ok)))
        return pt, ok

    monkeypatch.setattr(msm, "msm_flagged", flagged)
    monkeypatch.setattr(msm, "_measure_pads", lambda d, c: measured.append(c) or real_measure(d, c))
    assert cv.to_host(msm.msm(P, S)) == [want]
    assert flags == [(msm.pinned_pads(n, c), False)]
    assert measured == [c]


def test_sorted_group_block_gather_at_window_end(base):
    """Every point in the top digit of the last window: its bucket starts in
    the last 8-row block, so the pad's blocks run past the window's end.
    The gather clamps them (they are foreign slots) instead of failing."""
    n, beff, pad = 16, 4, 8
    planes = torch.cat(list(cv.from_affine_ints([base[i] for i in range(n)])))
    digits = torch.tensor([[1] * n, [0] * 8 + [3] * 8], dtype=torch.int64)
    V, ok = msm._sorted_group(planes, digits, pad, beff)
    assert not bool(ok)  # window 0 puts 16 points in one bucket of pad 8
    digits[0] = torch.tensor([0, 1, 2, 3] * 4)
    V, ok = msm._sorted_group(planes, digits, pad, beff)
    assert bool(ok)
    w0 = F.p_msm([0, 1, 2, 3] * 4, base[:n])
    w1 = F.p_msm([3] * 8, base[8:n])
    assert cv.to_host(V) == [w0, w1]


def test_msm_many_flagged_vs_oracle(rng, urs):
    n, K = 64, 2
    scs = [rand_scalars(rng, n) for _ in range(K)]
    scs[1][:40] = [0] * 40
    c = msm.window_size(n)
    S = FR.from_ints([x for row in scs for x in row]).reshape(L, K, n)
    R, ok = msm.msm_many_flagged(urs.gs_planes(n), S, c, msm.pinned_pads(n, c), msm._beffs(c))
    assert bool(ok)
    assert cv.to_host(R) == [F.p_msm(row, urs.gs_host(n)) for row in scs]


def test_tensor_h_coeffs_vs_jax_hpoly(rng):
    lg, K = 5, 2
    xis = [rand_scalars(rng, lg + 1) for _ in range(K)]
    z = rand_scalars(rng, 1)[0]
    one = poly.tensor_h_coeffs(FR.from_ints(xis[0]))
    many = poly.tensor_h_coeffs(FR.from_ints([x for row in xis for x in row]).reshape(L, K, lg + 1))
    assert one.shape == (L, 1 << lg) and many.shape == (L, K, 1 << lg)
    assert torch.equal(FR.canon(one), FR.canon(many[:, 0]))
    for k in range(K):
        coeffs = FR.to_ints(many[:, k])
        host = sum(co * pow(z, i, F.R) for i, co in enumerate(coeffs)) % F.R
        assert host == jpcdl.HPoly(xis[k]).eval(z) == poly.h_eval_host(xis[k], z, F.R)


def test_poly_ops_vs_ints(rng):
    a, b = rand_scalars(rng, 9), rand_scalars(rng, 5)
    z, s = rand_scalars(rng, 2)
    A, B = FR.from_ints(a), FR.from_ints(b)
    zl = FR.from_ints([z])[:, 0]
    assert FR.to_ints(poly.powers(zl, 7)) == [pow(z, i, F.R) for i in range(7)]
    assert FR.to_ints(poly.eval_poly(A, zl)) == [sum(co * pow(z, i, F.R) for i, co in enumerate(a)) % F.R]
    assert FR.to_ints(poly.scale(B, FR.from_ints([s])[:, 0])) == [s * x % F.R for x in b]
    assert FR.to_ints(poly.add(A, B)) == [(x + (b[i] if i < 5 else 0)) % F.R for i, x in enumerate(a)]


def test_urs_vs_oracle(urs):
    G = (F.G_X, F.G_Y)
    assert urs.s == F.p_mul(pp_mod.gen_scalar(0), G)
    assert urs.h == F.p_mul(pp_mod.gen_scalar(1), G)
    for i in (0, 1, 31, 63):
        assert urs.gs_host(64)[i] == F.p_mul(pp_mod.gen_scalar(i + 2), G)
    gx, gy, s, h = pp_mod.to_numpy(urs)
    assert gx.dtype == np.uint32 and gx.shape == (L, 64)
    back = pp_mod.from_numpy(gx, gy, s, h, "cpu")
    assert torch.equal(back.gs_x, urs.gs_x) and torch.equal(back.gs_y, urs.gs_y)
    small = pp_mod.get_pp(16, "cpu")  # a prefix of the larger URS
    assert small.gs_host(16) == urs.gs_host(16)


def test_urs_matches_jax_cache():
    if not URS_512.exists():
        pytest.skip("no cached JAX URS (.urs_cache is not committed)")
    z = np.load(URS_512)
    pp = pp_mod.get_pp(512, "cpu")
    gx, gy, s, h = pp_mod.to_numpy(pp)
    assert np.array_equal(gx, z["gs_x"]) and np.array_equal(gy, z["gs_y"])
    assert s == (int(z["s_x"]), int(z["s_y"])) and h == (int(z["h_x"]), int(z["h_y"]))


def test_dual_route_sortrows_vs_oracle(rng, base):
    """Two scalar vectors of disjoint support in one sort (route bits, the
    prover's L and R): each output equals its own MSM."""
    n = 128
    pts = [base[i % len(base)] for i in range(n)]
    scs = rand_scalars(rng, n)
    route = rng.integers(0, 2, n)
    c = msm.window_size(n // 2)
    P = cv.from_affine_ints(pts)
    outs, ok = msm._sortrows_msm(msm.planes_from_points(P), FR.from_ints(scs), c, msm.pinned_pads(n // 2, c),
                                 msm._beffs(c), route=torch.from_numpy(route), nroute=2)
    assert bool(ok)
    want = [oracle_msm([s for s, r in zip(scs, route) if r == k], [p for p, r in zip(pts, route) if r == k])
            for k in (0, 1)]
    assert [cv.to_host(o)[0] for o in outs] == want


def test_msm_impl_selector(monkeypatch, urs):
    """HALO_TPU_MSM_IMPL as the JAX package reads and routes it: sortrows by
    default, rowperm on request, and the staged pipeline for "staged" and
    for any other value (msm.py:881-888, 917-925): msm_flagged runs it with
    its pinned pads and flag, msm() with measured pads; neither bucket
    pipeline runs in its place."""
    monkeypatch.delenv("HALO_TPU_MSM_IMPL", raising=False)
    assert msm._impl() == "sortrows" == jmsm._impl() and not msm._staged()
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "rowperm")
    assert msm._impl() == "rowperm" == jmsm._impl() and not msm._staged()
    n, c = 16, 4
    P, coeffs = urs.gs_points(n), FR.from_ints([1] * n)
    want = None
    for g in urs.gs_host(n):
        want = F.p_add(want, g)

    def refuse(*args, **kwargs):
        raise AssertionError("a bucket pipeline ran under the staged setting")

    monkeypatch.setattr(msm, "_rowperm_msm", refuse)
    monkeypatch.setattr(msm, "_sortrows_msm", refuse)
    staged, measured = [], []
    real_staged, real_measured = msm._staged_msm, msm._msm_measured
    monkeypatch.setattr(msm, "_staged_msm", lambda *a: staged.append(a[3]) or real_staged(*a))
    monkeypatch.setattr(msm, "_msm_measured", lambda *a: measured.append(1) or real_measured(*a))
    for value in ("staged", "sortrow"):
        monkeypatch.setenv("HALO_TPU_MSM_IMPL", value)
        assert msm._impl() == value == jmsm._impl() and msm._staged()
        # every point in bucket 1 of the last window: past a pinned pad of 2
        pt, ok = msm.msm_flagged(P, coeffs, c=c, pads=[2] * msm.num_windows(c))
        assert not bool(ok)
        assert cv.to_host(msm.msm(P, coeffs, c=c)) == [want]
    assert measured == [1, 1] and [p[-1] for p in staged] == [2, n, 2, n]


@pytest.mark.parametrize("top", [False, True], ids=["random", "top_bucket_last_index"])
def test_perm_slots_matches_jax(rng, top):
    """The inverse permutation and its flag equal the JAX package's, with a
    point in the top bucket at the largest index in the second case."""
    Wg, N, beff, pad = 3, 64, 16, 8
    d = rng.integers(0, beff, (Wg, N))
    if top:
        d[:, -1] = beff - 1
        d[1, :12] = 5  # bucket 5 of window 1 overflows pad 8
    src, ok = msm._perm_slots(torch.from_numpy(d), pad, beff)
    jsrc, jok = jmsm._perm_slots(jnp.asarray(d.astype(np.uint32)), pad, beff)
    assert np.array_equal(src.numpy(), np.asarray(jsrc)) and bool(ok) == bool(jok) == (not top)
    if top:
        assert (src.numpy()[:, beff - 1 :: beff] == N - 1).any(axis=0).all()


def test_perm_slots_top_bucket_at_2_pow_32():
    """The JAX package's uint32 edge beff << ibits == 2^32 (c = 12 at
    N = 2^20): the port's int64 key has none, and a point in the top bucket
    still lands in its slot."""
    N, beff = 1 << 20, 4096
    d = torch.zeros((1, N), dtype=torch.int64)
    d[0, 5] = beff - 1
    d[0, 7] = 1
    src, ok = msm._perm_slots(d, 4, beff)
    assert bool(ok)
    assert src[0, beff - 1] == 5 and src[1, beff - 1] == N and src[0, 1] == 7


@pytest.mark.parametrize("form", ["projective", "affine"])
def test_rowperm_msm_matches_jax(rng, monkeypatch, base, form):
    """_rowperm_msm at n = 64, c = 4 from each row form: the same point as
    the JAX package's _rowperm_msm and the int oracle (canonical points:
    sort orders and folds may change the projective representative)."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "rowperm")
    n, c = 64, 4
    pts = [base[i % len(base)] for i in range(n)]
    scs = rand_scalars(rng, n)
    P, S = cv.from_affine_ints(pts), FR.from_ints(scs)
    jP = jcv.PointVec(*(jnp.asarray(a.numpy().astype(np.uint32)) for a in P))
    jS = jnp.asarray(S.numpy().astype(np.uint32))
    rows = msm.rows_from_points(P) if form == "projective" else msm.rows_from_affine(P.x, P.y)
    jrows = jmsm.rows_from_points(jP) if form == "projective" else jmsm.rows_from_affine(jP.x, jP.y)
    assert np.array_equal(rows.numpy(), np.asarray(jrows).astype(np.int64))
    pads, beffs = msm.pinned_pads(n, c), msm._beffs(c)
    R, ok = msm._rowperm_msm(P, S, c, pads, beffs, rows=rows)
    jR, jok = jmsm._rowperm_msm(jP, jS, c, pads, beffs, rows=jrows)
    assert bool(ok) and bool(jok)
    assert cv.to_host(R) == [jpcdl.point_to_host(jR)] == [oracle_msm(scs, pts)]


def test_rowperm_zero_heavy_affine_rows(monkeypatch, urs):
    """Mostly zero scalars over the URS's affine rows: nearly every slot is
    the sentinel, which must decode as (0 : 1 : 0), not (0 : 0 : 0)."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "rowperm")
    n = 64
    scs = [7, 11] + [0] * (n - 2)
    got = msm.msm(urs.gs_points(n), FR.from_ints(scs), c=4, rows=urs.gs_rows(n))
    assert cv.to_host(got) == [F.p_msm(scs[:2], urs.gs_host(2))]


def test_rowperm_overflow_flags_and_reruns(base, monkeypatch):
    """Constant scalars overflow pinned pads of 4: the flag goes False and
    msm() still returns the right point through measured pads."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "rowperm")
    n, k = 64, 12345
    pts = [base[i % len(base)] for i in range(n)]
    P, S = cv.from_affine_ints(pts), FR.from_ints([k] * n)
    _, ok = msm.msm_flagged(P, S, c=4, pads=[4] * msm.num_windows(4))
    assert not bool(ok)
    assert cv.to_host(msm.msm(P, S, c=4)) == [F.p_mul(k, F.p_msm([1] * n, pts))]


def test_default_device_is_the_card():
    """No device means the card: get_pp(n) lands on CUDA, or raises where
    there is none; the CPU is used only when named."""
    if torch.cuda.is_available():
        assert pp_mod.get_pp(16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pp_mod.get_pp(16)
    assert runtime.device("cpu") == torch.device("cpu") and pp_mod.get_pp(16, "cpu").device.type == "cpu"
