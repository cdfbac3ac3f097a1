"""The h_digits kernel (csrc/h_digits.cu) and the deciders' path through it.

h_digits writes the MSM window digits of the deciders' h(X) coefficients
straight from the challenges.  On the CPU its wrapper runs the glue it
replaces (poly.tensor_h_coeffs, then msm._digits), held here to the int
oracle, and a model of the kernel's tile schedule is held to that twin;
msm.fixed_base_h_flagged, the path pcdl._deferred takes, gives the same
commitments, flags and verdicts as fixed_base_many_flagged of the expanded
coefficients at n = 128 (the sort-payload pipeline's narrowest width).  On
a card (skipped without one) the kernel equals the twin digit for digit
at every window size, and a chunk graph's replay launches it once.

The file imports no JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_h_digits.py --noconftest -q
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from halo_accumulation_tpu_torch import chain, fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck, curve as cv, msm, poly
from halo_accumulation_tpu_torch.ops.field import FR, L

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHAIN_512 = ROOT / ".chain_cache" / "chain_512_10.bin"
H_DIGITS_CU = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc" / "h_digits.cu"


@pytest.fixture(scope="module", autouse=True)
def own_urs_cache(tmp_path_factory):
    """A URS disk cache of the module's own (the JAX package's tests write
    .urs_cache/ in place while other workers run)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HALO_TPU_URS_CACHE", str(tmp_path_factory.mktemp("urs_cache")))
        yield


def challenges(rng, K: int, lg: int, edges=(0, 1, F.R - 1)) -> list[list[int]]:
    """K rows of lg + 1 challenges, random mod r, with the edge values
    spread over the factors (entry 0 of a row is not a factor)."""
    rows = [[int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(lg + 1)] for _ in range(K)]
    for i, e in enumerate(edges):
        if lg:
            rows[i % K][1 + (i * 3) % lg] = e
    return rows


def as_limbs(rows, device="cpu"):
    K, m = len(rows), len(rows[0])
    return FR.from_ints([x for row in rows for x in row], device).reshape(L, K, m)


def oracle_coeffs(row: list[int]) -> list[int]:
    """h's coefficients on ints: coefficient j is the product of
    xi_{lg - i} over the set bits i of j."""
    lg = len(row) - 1
    out = []
    for j in range(1 << lg):
        v = 1
        for i in range(lg):
            if j >> i & 1:
                v = v * row[lg - i] % F.R
        out.append(v)
    return out


def oracle_digits(rows, c: int) -> np.ndarray:
    """(W K, n) digits, window-major and msb window first, on ints."""
    W = msm.num_windows(c)
    coeffs = [oracle_coeffs(row) for row in rows]
    return np.array([[co >> (c * (W - 1 - w)) & ((1 << c) - 1) for co in coeffs[k]]
                     for w in range(W) for k in range(len(rows))], dtype=np.int64)


@pytest.mark.parametrize("lg,K", [(0, 1), (1, 2), (3, 3), (5, 2)])
def test_twin_matches_int_oracle(lg, K):
    """The wrapper's CPU twin is the glue it replaces,
    msm._digits(tensor_h_coeffs(xis), c) reshaped, and equals the int
    oracle's digits at every window size."""
    rows = challenges(np.random.default_rng(lg * 10 + K), K, lg)
    xis = as_limbs(rows)
    for c in ck.H_DIGITS_WINDOWS:
        got = ck.h_digits(xis, c)
        W = msm.num_windows(c)
        assert torch.equal(got, msm._digits(poly.tensor_h_coeffs(xis), c).reshape(W * K, 1 << lg))
        assert np.array_equal(got.numpy(), oracle_digits(rows, c)), c


def test_tile_schedule_model_matches_twin():
    """The kernel's order of factors, modelled on ints: per block of 2^t
    coefficients (t = min(lg, kTileBits) from the source) the low table by
    doubling, the tile's high product on its own, one multiply a
    coefficient; the canonical values cut into digits equal the twin's."""
    tile_bits = int(re.search(r"constexpr int kTileBits = (\d+);", H_DIGITS_CU.read_text()).group(1))
    lg, K, c = tile_bits + 2, 2, 6
    rows = challenges(np.random.default_rng(11), K, lg)
    t = min(lg, tile_bits)
    W = msm.num_windows(c)
    out = np.zeros((W * K, 1 << lg), dtype=np.int64)
    for k, row in enumerate(rows):
        fac = [row[lg - i] for i in range(lg)]  # the factor of bit i of j
        for tile in range((1 << lg) >> t):
            tab = [1]
            for i in range(t):
                tab += [x * fac[i] % F.R for x in tab]
            high = 1
            for i in range(t, lg):
                if tile >> (i - t) & 1:
                    high = high * fac[i] % F.R
            for u in range(1 << t):
                v = tab[u] * high % F.R
                for b in range(W):
                    out[(W - 1 - b) * K + k, (tile << t) | u] = v >> (c * b) & ((1 << c) - 1)
    assert np.array_equal(out, ck.h_digits(as_limbs(rows), c).numpy())


def test_wrapper_refuses_bad_arguments():
    xis = as_limbs(challenges(np.random.default_rng(2), 1, 2))
    for c in (0, 5, 7, 16):
        with pytest.raises(ValueError, match="h_digits cuts windows"):
            ck.h_digits(xis, c)
    with pytest.raises(ValueError, match="h_digits takes"):
        ck.h_digits(xis[:, 0], 8)
    with pytest.raises(ValueError):
        ck.h_digits(torch.empty((L, 1, 3), dtype=torch.int64, device="meta"), 8)
    ck.reset_launches()
    ck.h_digits(xis, 4)
    assert ck.launch_counts()["h_digits"] == 0 and ck.launch_widths()["h_digits"] == {}


@pytest.mark.parametrize("impl,lg,calls", [("sortrows", 7, 1), ("sortrows", 6, 0), ("rowperm", 7, 0),
                                           ("staged", 7, 0)])
def test_deferred_takes_h_digits_under_sortrows_only(monkeypatch, impl, lg, calls):
    """msm.fixed_base_h_flagged follows the setting and the width it sees:
    the h_digits rows under the sort-payload pipeline (n >= 128), else
    fixed_base_many_flagged of tensor_h_coeffs(xis), unchanged."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", impl)
    seen = []
    monkeypatch.setattr(ck, "h_digits", lambda xis, c: seen.append(("digits", c)) or torch.zeros(1))
    monkeypatch.setattr(msm, "_many_digits_flagged", lambda planes, d, K, c, pads, beffs: ("rows", K, c))
    monkeypatch.setattr(msm, "fixed_base_many_flagged", lambda urs, s: ("coeffs", tuple(s.shape)))

    class Urs:
        def gs_planes(self, n):
            return None

    xis = torch.zeros((L, 3, lg + 1), dtype=torch.int64)
    got = msm.fixed_base_h_flagged(Urs(), xis)
    c = msm.window_size(1 << lg)
    assert len(seen) == calls
    assert got == (("rows", 3, c) if calls else ("coeffs", (L, 3, 1 << lg)))


def test_deferred_matches_expanded_path_at_128():
    """At n = 128 under the sort-payload pipeline: fixed_base_h_flagged
    (digits from h_digits' twin) and fixed_base_many_flagged of the
    expanded coefficients give the same commitments, each the int oracle's
    MSM, and the same flag; pcdl._deferred accepts the right U's and
    rejects a tampered one.  Challenges include 0, 1 and r - 1."""
    lg, K = 7, 3
    rows = challenges(np.random.default_rng(128), K, lg)
    xis = as_limbs(rows)
    pp = pp_mod.get_pp(1 << lg, "cpu")
    assert msm._sortrows(1 << lg)
    got, ok = msm.fixed_base_h_flagged(pp, xis)
    want, ok_want = msm.fixed_base_many_flagged(pp, poly.tensor_h_coeffs(xis))
    Us = cv.to_host(got)
    assert Us == cv.to_host(want)
    assert bool(ok) and bool(ok_want)
    gs = pp.gs_host(1 << lg)
    assert Us == [F.p_msm(oracle_coeffs(row), gs) for row in rows]
    tampered = Us[:2] + [F.p_add(Us[2], gs[0])]
    assert pcdl._deferred(xis, cv.from_affine_ints(tampered), pp).tolist() == [True, True, False]


# -- on a card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lg", [1, 7, 11, 14])
@pytest.mark.parametrize("K", [1, 3, 10])
def test_kernel_matches_twin_on_card(cuda, lg, K):
    """The kernel's digits equal the twin's (the torch glue on the card),
    digit for digit, at every window size; challenges include 0, 1, r - 1
    and r itself (non-canonical limbs of 0); one launch of width K 2^lg."""
    rows = challenges(np.random.default_rng(lg * 100 + K), K, lg, edges=(0, 1, F.R - 1, F.R))
    xis = as_limbs(rows, cuda)
    for c in ck.H_DIGITS_WINDOWS:
        ck.reset_launches()
        got = ck.h_digits(xis, c)
        assert ck.launch_widths()["h_digits"] == {K << lg: 1}
        want = ck.h_digits_plain(xis, c)
        assert got.shape == want.shape and torch.equal(got, want), (lg, K, c)
    if lg <= 7:
        assert np.array_equal(ck.h_digits(xis, 4).cpu().numpy(), oracle_digits(rows, 4))


@pytest.mark.cuda
def test_chunk_replay_launches_h_digits_once(cuda):
    """decide_many on chain_512_10.bin (one chunk of ten claims, one graph):
    a replay adds exactly one h_digits launch, of width 10 x 512, and a
    tampered copy of the same shape (replay, then the recheck of its claim)
    adds no other."""
    import dataclasses

    d, _, accs = chain.load_chain(CHAIN_512)
    pp = pp_mod.get_pp(d + 1, cuda)
    chain.verify_chain_slow(accs, pp)  # the capture
    ck.reset_launches()
    chain.verify_chain_slow(accs, pp)
    assert ck.launch_widths()["h_digits"] == {len(accs) * (d + 1): 1}
    v0 = [dataclasses.replace(accs[0], v=(accs[0].v + 1) % F.R)] + accs[1:]
    ck.reset_launches()
    with pytest.raises(ValueError, match="batch index 0"):
        chain.verify_chain_slow(v0, pp)
    assert ck.launch_widths()["h_digits"] == {len(accs) * (d + 1): 1}
