"""The port's CUDA kernels on an NVIDIA GPU: each kernel against its plain
twin, the verifier path on a committed chain under both MSM settings, and
the prover rebuilding a committed chain's first step byte for byte.

Every test here needs a card and skips without one.  The file imports no
JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from halo_accumulation_tpu_torch import acc as acc_mod, chain, fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck, curve as cv, msm as msm_mod
from halo_accumulation_tpu_torch.ops.field import FQ, FR, L, limb_array_to_ints

import chip_smoke

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

pytestmark = pytest.mark.cuda

CHAIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, ".chain_cache", "chain_512_10.bin")
LANES = 4096
PADD_WIDTHS = (1, 2, 5, 10, 30, 7936, 65536, 79360)  # padd widths held to the twin
# the kernels each path must launch, by MSM setting
MUST_LAUNCH = {"sortrows": {"fmul", "padd", "pdbl", "bucket_masked"},
               "rowperm": {"fmul", "padd", "pdbl", "bucket_accum"},
               "staged": {"fmul", "padd", "pdbl"}}


def same_canonical(got, want) -> bool:
    """The kernel's coordinates are canonical (FQ.canon leaves them as they
    are) and equal FQ.canon of the twin's, limb for limb: the kernels'
    8-word arithmetic stores canonical limbs, the twins keep lazy ones."""
    return all(torch.equal(FQ.canon(g), g) and torch.equal(g.cpu(), FQ.canon(w).cpu()) for g, w in zip(got, want))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


def _points(rng, n):
    """n lazy projective lanes per side: random sums, the identity, P == Q
    and P == -Q, every coordinate scaled by a random nonzero lambda.  Lane
    0 adds a point to the identity, lane 1 the identity to a point, lane 2
    doubles and lane 3 adds a point to its negation."""
    base = [F.p_mul(int.from_bytes(rng.bytes(40), "little") % F.R, (F.G_X, F.G_Y)) for _ in range(16)]
    base.append(None)
    ip = rng.integers(0, len(base), n)
    ip[0] = len(base) - 1
    ps = [base[i] for i in ip]
    qs = [(base[rng.integers(0, len(base))], None, p, F.p_neg(p))[i % 4] for i, p in enumerate(ps)]

    def lazy(pts):
        lam = FQ.from_ints([int(x) for x in rng.integers(1, 1 << 62, n)])
        return tuple(FQ.mul(c, lam) for c in cv.from_affine_ints(pts))

    return lazy(ps), lazy(qs)


@pytest.mark.parametrize("op", ["fmul", "padd", "pdbl"])
def test_kernel_matches_twin(cuda, rng, op):
    P, Q = _points(rng, LANES)
    Pc, Qc = tuple(c.to(cuda) for c in P), tuple(c.to(cuda) for c in Q)
    before = ck.launch_counts()[op]
    if op == "fmul":
        got, want = (ck.fmul(Pc[0], Qc[0]),), (ck.fmul_plain(P[0], Q[0]),)
    elif op == "padd":
        got, want = ck.padd(Pc, Qc), ck.padd_plain(P, Q)
    else:
        got, want = ck.pdbl(Pc), ck.pdbl_plain(P)
    torch.cuda.synchronize()
    assert ck.launch_counts()[op] == before + 1
    assert same_canonical(got, want)


def test_fmul_edge_lanes(cuda):
    """fmul on every pair of chip_smoke's edge lanes (0, 1, q - 1, q,
    2^255 - 1, the boundary's lazy maxima, ...) equals the canonical twin
    and the int oracle."""
    edges = chip_smoke.fmul_edge_limbs()
    a = torch.tensor([e for e in edges for _ in edges], dtype=torch.int64).T.contiguous()
    b = torch.tensor([e for _ in edges for e in edges], dtype=torch.int64).T.contiguous()
    got = ck.fmul(a.to(cuda), b.to(cuda))
    assert same_canonical([got], [ck.fmul_plain(a, b)])
    assert FQ.to_ints(got) == [x * y % F.Q for x, y in zip(limb_array_to_ints(a.numpy()), limb_array_to_ints(b.numpy()))]


@pytest.mark.parametrize("threads", chip_smoke.FMUL_THREADS_TIMED)
def test_fmul_block_sizes(cuda, rng, threads):
    """fmul at every block size that chip_smoke times, on a width that is
    no multiple of the block, equals the canonical twin."""
    P, Q = _points(rng, 1000)
    got = ck.fmul(P[0].to(cuda), Q[0].to(cuda), threads)
    assert same_canonical([got], [ck.fmul_plain(P[0], Q[0])])


@pytest.fixture(scope="module")
def padd_lanes():
    """The widest padd input on the card, lanes 0 to 3 the edge cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    P, Q = _points(np.random.default_rng(5), max(PADD_WIDTHS))
    return tuple(c.cuda() for c in P), tuple(c.cuda() for c in Q)


@pytest.mark.parametrize("n", PADD_WIDTHS)
def test_padd_layouts_match_twin(padd_lanes, n):
    """The six-threads-per-lane padd equals the canonical twin at the
    paths' widths, the edge lanes first; each launch counts once, at its
    width."""
    P, Q = (tuple(c[:, :n] for c in X) for X in padd_lanes)
    want = ck.padd_plain(P, Q)
    ck.reset_launches()
    got = ck.padd(P, Q)
    torch.cuda.synchronize()
    assert ck.launch_counts()["padd"] == 1 and ck.launch_widths()["padd"] == {n: 1}
    assert same_canonical(got, want)


@pytest.mark.parametrize("shape", [(40, 512), (136, 4096)], ids=["pad40", "pad136"])
@pytest.mark.parametrize("split", [1, None, 16], ids=["one", "chosen", "sixteen"])
@pytest.mark.parametrize("lanes", [18, 54], ids=["affine18", "proj54"])
def test_bucket_masked_matches_twin(cuda, rng, lanes, split, shape):
    """At one thread per column, at the split bucket_split chooses (4
    threads per column at these shapes) and at the widest split, the
    kernel equals the canonical twin run with the same split."""
    P, _ = _points(rng, 64)
    if lanes == L:
        x, y, _ = cv.to_affine(cv.PointVec(*P))
        planes = msm_mod.planes_from_affine(x, y)
    else:
        planes = torch.cat(P)
    padp, cols = shape
    M = planes[:, torch.from_numpy(rng.integers(0, 64, (padp, cols)))].to(cuda)
    off, ln = rng.integers(0, 8, cols), rng.integers(0, padp - 7, cols)
    ln[:16] = 0
    meta = torch.from_numpy((off | (ln << 3)).reshape(1, cols)).to(cuda)
    T = ck.bucket_split(padp, cols) if split is None else split
    before = ck.launch_counts()["bucket_masked"]
    got = ck.bucket_masked(M, meta, T)
    torch.cuda.synchronize()
    assert ck.launch_counts()["bucket_masked"] == before + 1
    assert same_canonical(got, ck.bucket_masked_plain(M, meta, T))


@pytest.mark.parametrize("n", [1, 3, 32, 4096])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_pdbl_k_matches_twin(cuda, rng, k, n):
    """k doublings in one launch (four threads per lane, a partial last
    block at 3 lanes) equal k doublings of the twin, canonically."""
    P, _ = _points(rng, n)
    Pc = tuple(c.to(cuda) for c in P)
    before = ck.launch_counts()["pdbl"]
    got = ck.pdbl(Pc, k)
    torch.cuda.synchronize()
    assert ck.launch_counts()["pdbl"] == before + 1
    assert same_canonical(got, ck.pdbl_plain(Pc, k))


def test_sortrows_msm_launches_one_pdbl_per_window(cuda, monkeypatch, rng):
    """A sort-payload MSM at c = 8 runs its Horner combine as one pdbl
    launch of 8 doublings per window: 32 launches, and the right point."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "sortrows")
    n, c = 256, 8
    pp = pp_mod.get_pp(n, cuda)
    scalars = [int.from_bytes(rng.bytes(32), "little") % F.R for _ in range(n)]
    ck.reset_launches()
    pt, ok = msm_mod.msm_flagged(pp.gs_points(n), FR.from_ints(scalars, cuda), c=c,
                                 pads=msm_mod.pinned_pads(n, c), planes=pp.gs_planes(n))
    assert bool(ok)
    assert ck.launch_counts()["pdbl"] == msm_mod.num_windows(c) == 32
    G = cv.to_host(pp.gs_points(n))
    assert cv.to_host(pt) == [F.p_msm(scalars, G)]


@pytest.mark.parametrize("split", [1, None, 16], ids=["one", "chosen", "sixteen"])
@pytest.mark.parametrize("lanes", [40, 64])
def test_bucket_accum_matches_twin(cuda, rng, lanes, split):
    """Gathered row sums at a small shape: URS rows (projective ones with
    lazy limbs), about 5 % sentinel slots.  At one thread per column, at
    the split accum_split chooses (8 at this shape) and at sixteen (24
    slots: chunks of 2, the last four empty), the kernel equals the
    canonical twin run with the same split."""
    n, pad, cols = 64, 24, 512
    pp = pp_mod.get_pp(n, "cpu")
    if lanes == 40:
        rows = pp.gs_rows(n)
    else:
        lam = FQ.from_ints([int(x) for x in rng.integers(1, 1 << 62, n)])
        rows = msm_mod.rows_from_points(cv.PointVec(*(FQ.mul(c, lam) for c in pp.gs_points(n))))
    src = rng.integers(0, n, (pad, cols))
    src[rng.random((pad, cols)) < 0.05] = n
    src = torch.from_numpy(src)
    T = ck.accum_split(pad, cols) if split is None else split
    before = ck.launch_counts()["bucket_accum"]
    got = ck.bucket_accum(rows.to(cuda), src.to(cuda), T)
    torch.cuda.synchronize()
    assert ck.launch_counts()["bucket_accum"] == before + 1
    assert same_canonical(got, ck.bucket_accum_plain(rows, src, T))


@pytest.mark.parametrize("impl", ["sortrows", "rowperm", "staged"])
def test_chain_verifier_on_card(cuda, monkeypatch, impl):
    """Both verifier paths under one MSM setting, the launch counts zeroed
    just before each path: each must launch its setting's kernels."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", impl)
    d, qss, accs = chain.load_chain(CHAIN)
    pp = pp_mod.get_pp(d + 1, cuda)
    for run in (lambda: chain.verify_chain_fast(d, qss, accs, pp), lambda: chain.verify_chain_slow(accs, pp)):
        ck.reset_launches()
        run()
        counts = ck.launch_counts()
        assert all(counts[k] > 0 for k in MUST_LAUNCH[impl]), counts
    bad = acc_mod.Accumulator(accs[0].C_bar, accs[0].d, accs[0].z, (accs[0].v + 1) % F.R, accs[0].pi, accs[0].pi_V)
    with pytest.raises(ValueError, match=r"^h\(z\) != v at step 0$"):
        chain.verify_chain_fast(d, qss[:1], [bad], pp)
    with pytest.raises(ValueError, match=r"^C_\(log_n\) != CM\.Commit_Sigma\(c \|\| v'\) \(batch index 0\)$"):
        chain.verify_chain_slow([bad, accs[1]], pp)


@pytest.mark.parametrize("impl", ["sortrows", "rowperm", "staged"])
def test_prover_rebuilds_committed_chain(cuda, monkeypatch, impl):
    """build_chain from default_rng(7) (the JAX package's builder seed)
    rebuilds the first step of chain_512_10.bin byte for byte, and the
    verifiers accept what it built."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", impl)
    _, fqss, faccs = chain.load_chain(CHAIN)
    pp = pp_mod.get_pp(512, cuda)
    ck.reset_launches()
    d, qss, accs = chain.build_chain(np.random.default_rng(7), 512, 1, pp)
    counts = ck.launch_counts()
    assert all(counts[k] > 0 for k in MUST_LAUNCH[impl] - {"fmul"}), counts
    assert chain.step_records(qss, accs) == chain.step_records(fqss[:1], faccs[:1])
    chain.verify_chain_fast(d, qss, accs, pp)
    chain.verify_chain_slow(accs, pp)


STAGED_N = 4096  # the card tests' mid width for the staged and sharded MSMs


def test_staged_msm_on_card(cuda, monkeypatch, rng):
    """The staged pipeline on the card: msm under the staged setting
    (measured pads) and msm_flagged's staged branch (pinned pads, flag
    True) equal the sort-payload msm at 4,096 points; a commitment to 4,096
    equal coefficients under every setting takes _msm_measured, its points
    chunked under a budget of 2^18 columns, and equals native.msm."""
    from halo_accumulation_tpu_torch import native

    n = STAGED_N
    pp = pp_mod.get_pp(n, cuda)
    s = FR.from_ints([int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(n)], cuda)
    P = pp.gs_points(n)
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "sortrows")
    ref = msm_mod.msm(P, s)
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "staged")
    ck.reset_launches()
    assert bool(cv.peq(msm_mod.msm(P, s), ref))
    c = msm_mod.window_size(n)
    pt, ok = msm_mod.msm_flagged(P, s, c=c, pads=msm_mod.pinned_pads(n, c))
    assert bool(ok) and bool(cv.peq(pt, ref))
    assert all(ck.launch_counts()[k] > 0 for k in ("padd", "pdbl"))
    k = int.from_bytes(rng.bytes(31), "little")
    want = native.msm([k] * n, pp.gs_host(n))
    monkeypatch.setattr(msm_mod, "_SCATTER_BUDGET_COLS", 1 << 18)
    calls, real = [], msm_mod._msm_measured
    monkeypatch.setattr(msm_mod, "_msm_measured", lambda *a: calls.append(a[0].x.shape[1]) or real(*a))
    for impl in ("sortrows", "rowperm", "staged"):
        monkeypatch.setenv("HALO_TPU_MSM_IMPL", impl)
        assert pcdl.commit(FR.from_int(k, (n,), cuda).contiguous(), n - 1, None, pp) == want
    assert calls == [n] * 3


def test_msm_sharded_one_rank_on_card(cuda, rng):
    """msm_sharded on a one-rank NCCL mesh equals msm at 4,096 points, and
    check_device(mesh=) gives check_device's verdicts on chain_512_10.bin's
    first claim and on a copy whose U is off by one generator."""
    import dataclasses

    import torch.distributed as dist

    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    n = STAGED_N
    pp = pp_mod.get_pp(n, cuda)
    s = FR.from_ints([int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(n)], cuda)
    mesh = sh.make_mesh()
    try:
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        P = pp.gs_points(n)
        assert bool(cv.peq(sh.msm_sharded(sh.shard_points(P, mesh), s, mesh), msm_mod.msm(P, s)))
        _, qss, _ = chain.load_chain(CHAIN)
        q = qss[0][0]
        pp512 = pp_mod.get_pp(q.d + 1, cuda)
        bad = dataclasses.replace(q.pi, U=F.p_add(q.pi.U, pp512.gs_host(1)[0]))
        for pi, verdict in ((q.pi, True), (bad, False)):
            assert bool(pcdl.check_device(q.C, q.d, q.z, q.v, pi, pp512)) is verdict
            assert bool(pcdl.check_device(q.C, q.d, q.z, q.v, pi, pp512, mesh=mesh)) is verdict
    finally:
        dist.destroy_process_group()


def test_mesh_open_one_rank_on_card(cuda):
    """open_(mesh=) on a one-rank NCCL mesh writes the single-device open's
    bytes at n = 512 with hiding (the single device takes the device
    transcript there, the mesh the host transcript), and succinct_check
    accepts the proof."""
    import torch.distributed as dist

    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    n = 512
    pp = pp_mod.get_pp(n, cuda)
    rng = np.random.default_rng(9)
    coeffs = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(n)]
    z, w = (int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(2))
    v = sum(c * pow(z, i, F.R) for i, c in enumerate(coeffs)) % F.R
    cd = FR.from_ints(coeffs, cuda)
    C = pcdl.commit(cd, n - 1, w, pp)
    mesh = sh.make_mesh()
    try:
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        got = pcdl.open_(np.random.default_rng(3), cd, C, n - 1, z, w, pp, mesh=mesh, v=v)
    finally:
        dist.destroy_process_group()
    want = pcdl.open_(np.random.default_rng(3), cd, C, n - 1, z, w, pp, v=v)
    assert got.serialize() == want.serialize()
    pcdl.succinct_check(C, n - 1, z, v, got, pp)


def test_pmul_shared_on_card(cuda, rng):
    """pmul_shared on 1,024 lanes launches padd and pdbl 129 times each (the
    table, then a window's two doublings and one add, 128 windows) and
    equals fields.p_mul on a sample of lanes."""
    pp = pp_mod.get_pp(1024, cuda)
    k = int.from_bytes(rng.bytes(40), "little") % F.R
    ck.reset_launches()
    R = cv.pmul_shared(FR.from_ints([k], cuda)[:, 0], pp.gs_points(1024))
    assert ck.launch_counts()["padd"] == ck.launch_counts()["pdbl"] == 129
    idx = [0, 1, 500, 1023]
    gs = pp.gs_host(1024)
    assert cv.to_host(cv.PointVec(*(a[:, idx] for a in R))) == [F.p_mul(k, gs[i]) for i in idx]


def test_dryrun_one_card(cuda, capfd):
    """parallel/dryrun.dryrun_multichip(1): one NCCL rank on the card runs
    the five phases at n = 16, proving its instances and chain."""
    from halo_accumulation_tpu_torch.parallel import dryrun

    dryrun.dryrun_multichip(1)
    out = capfd.readouterr().out
    assert "on NCCL" in out and "dryrun_multichip OK: 1 ranks, n = 16" in out


def test_default_device_is_cuda(cuda):
    assert pp_mod.get_pp(64).device == pp_mod.get_pp(64, cuda).device == torch.device("cuda", 0)


def test_zero_width_launches_nothing(cuda):
    e = torch.empty((L, 0), dtype=torch.int64, device=cuda)
    before = ck.launch_counts()
    assert ck.fmul(e, e).shape == (L, 0)
    assert all(t.shape == (L, 0) for t in ck.padd((e, e, e), (e, e, e)) + ck.pdbl((e, e, e)))
    assert ck.finv(e, FQ).shape == (L, 0)
    ck.bucket_masked(torch.empty((L, 8, 0), dtype=torch.int64, device=cuda), torch.empty((1, 0), dtype=torch.int64, device=cuda))
    rows = torch.zeros((3, 40), dtype=torch.int64, device=cuda)
    assert all(t.shape == (L, 0) for t in ck.bucket_accum(rows, torch.empty((8, 0), dtype=torch.int64, device=cuda)))
    assert ck.launch_counts() == before
    assert not any(ck.launch_widths()[k].get(0) for k in ck.KERNELS)


@pytest.mark.parametrize("n", [1, 2, 10, 1024, 65536])
@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_finv_matches_twin(cuda, rng, name, n):
    """finv equals its twin, pow_const(a, p - 2), canonically, and the int
    oracle's inverses (0 for 0), with chip_smoke's edge lanes first (0, 1,
    p - 1, 2^254, (p + 1) / 2, and lazy limbs of values at or above p up to
    2^257: a lazy 0 among them); one launch at width n."""
    f = FQ if name == "Fq" else FR
    edges = chip_smoke.finv_edge_limbs(f.p)
    rand = f.from_ints([int.from_bytes(rng.bytes(40), "little") % f.p for _ in range(64 - len(edges))])
    lanes = torch.cat([torch.tensor(edges, dtype=torch.int64).T, rand], 1)
    vals = limb_array_to_ints(lanes.numpy())[:n]
    a = lanes.to(cuda)[:, torch.arange(n, device=cuda) % lanes.shape[1]].contiguous()
    want = f.canon(ck.finv_plain(a, f))  # the twin's torch ops on the card
    ck.reset_launches()
    got = ck.finv(a, f)
    torch.cuda.synchronize()
    assert ck.launch_widths()["finv"] == {n: 1}
    assert torch.equal(f.canon(got), got) and torch.equal(got, want)
    assert f.to_ints(got[:, : len(vals)]) == [pow(v % f.p, f.p - 2, f.p) for v in vals]


def test_rho_round_matches_twin(cuda, rng):
    """rho_round equals ops/keccak.py's twin and the host transcript on 64
    random (xi, L, R) triples and the boundary cases: L, R or both the
    identity, y = (q - 1) / 2 (no flag) and (q + 1) / 2 (flagged), L = -R,
    xi = 0 and r - 1; the limb vectors are column views of (18, 2)
    tensors, as the device open passes them."""
    from halo_accumulation_tpu_torch.utils import serialize as ser, transcript as tr

    half = (F.Q - 1) // 2
    G = (F.G_X, F.G_Y)
    pts = [F.p_mul(int.from_bytes(rng.bytes(40), "little") % F.R, G) for _ in range(128)]
    cases = [(int.from_bytes(rng.bytes(40), "little") % F.R, pts[2 * i], pts[2 * i + 1]) for i in range(64)]
    cases += [(5, None, pts[0]), (6, pts[1], None), (7, None, None), (0, pts[2], F.p_neg(pts[2])),
              (F.R - 1, (pts[3][0], half), (pts[4][0], half + 1)), (8, (pts[5][0], half + 1), (pts[6][0], half))]
    ck.reset_launches()
    for xi, P, Q in cases:
        xs = FQ.from_ints([0 if X is None else X[0] for X in (P, Q)], cuda)
        ys = FQ.from_ints([0 if X is None else X[1] for X in (P, Q)], cuda)
        inf = torch.tensor([P is None, Q is None], device=cuda)
        args = (FR.from_ints([xi], cuda)[:, 0], xs[:, 0], ys[:, 0], inf[0], xs[:, 1], ys[:, 1], inf[1])
        got = ck.rho_round(*args)
        assert torch.equal(got, ck.rho_round_plain(*args))
        assert FR.to_ints(got[:, None]) == [tr.rho_0(ser.ser_scalar(xi), ser.ser_point(P), ser.ser_point(Q))]
    assert ck.launch_counts()["rho_round"] == len(cases)


def test_open_device_collapse_matches_host_on_card(cuda, monkeypatch):
    """The device-transcript open at n = 512 with one collapse segment
    forced (pcdl._COLLAPSE_MIN lowered to 512) writes the host
    transcript's bytes, launches finv and rho_round once per round at
    least, and the proof checks."""
    from halo_accumulation_tpu_torch import pcdl

    pp = pp_mod.get_pp(512, cuda)
    rng = np.random.default_rng(11)
    p = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(450)]
    z = int.from_bytes(rng.bytes(40), "little") % F.R
    v = sum(c * pow(z, i, F.R) for i, c in enumerate(p)) % F.R
    cd = FR.from_ints(p, cuda)
    C = pcdl.commit(cd, 511, None, pp)
    monkeypatch.setenv("HALO_TPU_OPEN_DEVICE", "0")
    host = pcdl.open_(np.random.default_rng(1), cd, C, 511, z, None, pp, v=v)
    monkeypatch.setenv("HALO_TPU_OPEN_DEVICE", "1")
    monkeypatch.setattr(pcdl, "_COLLAPSE_MIN", 512)
    ck.reset_launches()
    dev = pcdl.open_(np.random.default_rng(1), cd, C, 511, z, None, pp, v=v)
    counts = ck.launch_counts()
    assert dev.serialize() == host.serialize()
    assert counts["rho_round"] == 9 and counts["finv"] >= 2 * 9, counts
    pcdl.check(C, 511, z, v, dev, pp)


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_inv_and_to_affine_on_card(cuda, rng, name):
    """Field.inv on the card (every lane through finv, one launch) gives
    the CPU path's values, zeros and a lazy zero (limbs of p) included,
    with exact zero limbs for them; to_affine on the card marks the
    identity and stores canonical coordinates equal to the CPU path's."""
    f = FQ if name == "Fq" else FR
    vs = [int.from_bytes(rng.bytes(40), "little") % f.p for _ in range(29)] + [0, 1, f.p - 1]
    a = f.from_ints(vs)
    a[:, 0] = torch.tensor([(f.p >> (15 * i)) & 0x7FFF for i in range(L)])  # the value p: zero, lazily
    vs[0] = 0
    ck.reset_launches()
    got = f.inv(a.to(cuda))
    assert ck.launch_counts()["finv"] == 1
    assert torch.equal(f.canon(got).cpu(), f.canon(f.inv(a)))
    assert (got == 0).all(0).tolist() == [v == 0 for v in vs]
    if f is FQ:
        P, _ = _points(rng, 64)
        want = cv.to_affine(cv.PointVec(*P))
        got = cv.to_affine(cv.PointVec(*(c.to(cuda) for c in P)))
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


# -- captured CUDA graphs (runtime.graphed) --------------------------------------


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _chain_cases(d, qss, accs, pp):
    """(name, verify_chain call, decide_many call) on the ten-step chain and
    on tampered copies of the same shape (a replay reads them), then on a
    key with generators 2 and 3 swapped (another graph): a proof's c
    changes its row alone, an accumulator's v its decider's row."""
    import dataclasses

    def bumped_c(x):
        return dataclasses.replace(x, pi=dataclasses.replace(x.pi, c=(x.pi.c + 1) % F.R))

    gx, gy = pp.gs_x.clone(), pp.gs_y.clone()
    gx[:, [2, 3]], gy[:, [2, 3]] = gx[:, [3, 2]], gy[:, [3, 2]]
    swapped = pp_mod.PublicParams(pp.n, gx, gy, pp.s, pp.h)
    q_c = [qs if k != 4 else [qs[0], bumped_c(qs[1])] for k, qs in enumerate(qss)]
    last_c = accs[:-1] + [bumped_c(accs[-1])]
    v0 = [dataclasses.replace(accs[0], v=(accs[0].v + 1) % F.R)] + accs[1:]
    return [
        ("good", lambda: chain.verify_chain_fast(d, qss, accs, pp), lambda: chain.verify_chain_slow(accs, pp)),
        ("c", lambda: chain.verify_chain_fast(d, q_c, accs, pp), lambda: chain.verify_chain_slow(last_c, pp)),
        ("v", lambda: chain.verify_chain_fast(d, qss, v0, pp), lambda: chain.verify_chain_slow(v0, pp)),
        ("key", lambda: chain.verify_chain_fast(d, qss, accs, swapped), lambda: chain.verify_chain_slow(accs, swapped)),
    ]


# what each case raises: (verify_chain, decide_many); None accepts
CHAIN_TEXTS = {
    "good": (None, None),
    "c": ("C_(log_n) != CM.Commit_Sigma(c || v') (batch index 8)",
          "C_(log_n) != CM.Commit_Sigma(c || v') (batch index 0)"),
    "v": ("h(z) != v at step 0", "C_(log_n) != CM.Commit_Sigma(c || v') (batch index 0)"),
    "key": ("U != CM.Commit(ck, h_vec)", "U != CM.Commit(ck, h_vec)"),
}


def test_verdict_graphs_match_eager(cuda):
    """verify_chain and decide_many on chain_512_10.bin: each case through
    the graphs (captured at the first good run, replayed on the tampered
    copies of the same shape right after it: the stale-input check) and
    eagerly, with the same outcome and the JAX package's text; the launch
    counts of a replay equal the eager path's."""
    from halo_accumulation_tpu_torch import runtime

    d, qss, accs = chain.load_chain(CHAIN)
    pp = pp_mod.get_pp(d + 1, cuda)
    cases = _chain_cases(d, qss, accs, pp)
    for name, fast, slow in cases + cases[:1]:
        got = (_outcome(fast), _outcome(slow))
        with runtime._eager_graphs():
            want = (_outcome(fast), _outcome(slow))
        assert got == want == CHAIN_TEXTS[name], name
    for run in (cases[0][1], cases[0][2]):
        ck.reset_launches()
        with runtime._eager_graphs():
            run()
        eager = (ck.launch_counts(), ck.launch_widths())
        ck.reset_launches()
        run()
        assert (ck.launch_counts(), ck.launch_widths()) == eager
    n, M, K = d + 1, 2 * 9 + 3, len(accs)
    for shape in ((sum(map(len, qss)) + K + 1, M, 1, n), (K, M, K, n)):  # verify_chain's rows, decide_many's
        assert runtime.graph_key("verdicts", shape, (pp,)) in runtime.graphs, shape


def test_open_replay_matches_chain(cuda):
    """random_instance(default_rng(7), 511) three times: the first captures
    the n = 512 open (its result the warm-up's), the second replays it, the
    third runs eagerly; each equals chain_512_10.bin's first instance byte
    for byte, and the replay launches what the eager open launches."""
    from halo_accumulation_tpu_torch import runtime

    pp = pp_mod.get_pp(512, cuda)
    want = chain.load_chain(CHAIN)[1][0][0].serialize()
    got = []
    for eager in (False, False, True):
        ck.reset_launches()
        with runtime._eager_graphs() if eager else contextlib.nullcontext():
            got.append((chain.random_instance(np.random.default_rng(7), 511, pp).serialize(), ck.launch_counts()))
    assert all(b == want for b, _ in got)
    assert got[1][1] == got[2][1] and got[1][1]["rho_round"] == 9
    assert ("open", (512, pcdl._COLLAPSE_MIN), (id(pp),)) in runtime.graphs


def test_graph_bodies_make_no_sync(cuda):
    """Every captured body (the verdicts of verify_chain and decide_many,
    the n = 512 open) run eagerly on card inputs under
    torch.cuda.set_sync_debug_mode("error") (chip_smoke.strict_bodies):
    nothing synchronizes with the host.  The inputs are moved to the card
    outside the mode, as a replay's static inputs are."""
    d, qss, accs = chain.load_chain(CHAIN)
    pp = pp_mod.get_pp(d + 1, cuda)
    with chip_smoke.strict_bodies([]) as names:
        chain.verify_chain_fast(d, qss, accs, pp)
        chain.verify_chain_slow(accs, pp)
        chain.random_instance(np.random.default_rng(7), 511, pp)
    assert names == ["verdicts", "verdicts", "open"]
