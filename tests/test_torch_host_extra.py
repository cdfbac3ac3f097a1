"""The port's host helpers against the JAX package's (on_curve, C_Q, C_R,
ARK_MONT_R, from_ark_montgomery on random u64 words, ser_base, sha3_256,
from_le_bytes_mod_order, rho_0_scalar_point_point), and the URS disk cache
(pp.get_pp): a file the port writes reads back and loads in the JAX
package, a file in the JAX package's layout loads in the port, the
smallest larger file is sliced, and a file that does not parse raises.
Every cache file lives under the test's tmp_path (HALO_TPU_URS_CACHE)."""

import numpy as np
import pytest
import torch

from halo_accumulation_tpu import fields as JF, pp as jpp
from halo_accumulation_tpu.utils import serialize as jser, transcript as jtr
from halo_accumulation_tpu_torch import fields as F, pp as pp_mod
from halo_accumulation_tpu_torch.utils import serialize as ser, transcript as tr

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


def rand_points(rng, n):
    return [F.p_mul(int.from_bytes(rng.bytes(40), "little") % F.R, (F.G_X, F.G_Y)) for _ in range(n)]


def test_host_helpers_match_jax():
    rng = np.random.default_rng(21)
    pts = rand_points(rng, 4) + [None]
    off = [(x, (y + 1) % F.Q) for x, y in pts[:3]] + [(0, 0), (F.G_X, F.G_Y)]
    for P in pts + off:
        assert F.on_curve(P) == JF.on_curve(P)
    assert [F.on_curve(P) for P in off] == [False] * 4 + [True]
    assert (F.ARK_MONT_R, F.C_Q, F.C_R) == (JF.ARK_MONT_R, JF.C_Q, JF.C_R)
    for _ in range(32):
        words = [int(w) for w in rng.integers(0, 1 << 64, size=4, dtype=np.uint64)]
        for p in (F.Q, F.R):
            got = F.from_ark_montgomery(words, p)
            assert got == JF.from_ark_montgomery(words, p)
            assert got * F.ARK_MONT_R % p == sum(w << (64 * i) for i, w in enumerate(words)) % p
    vals = [0, 1, F.Q - 1, F.Q, F.R, (1 << 256) - 1] + [int.from_bytes(rng.bytes(40), "little") for _ in range(8)]
    for v in vals:
        assert ser.ser_base(v) == jser.ser_base(v)
        b = v.to_bytes(40, "little")
        assert ser.sha3_256(b) == jser.sha3_256(b)
        assert tr.from_le_bytes_mod_order(b) == jtr.from_le_bytes_mod_order(b)
    for xi, L, R in zip(vals, pts + [None] * 3, [None] + pts + pts):
        assert tr.rho_0_scalar_point_point(xi, L, R) == jtr.rho_0_scalar_point_point(xi, L, R)


@pytest.fixture(scope="module", autouse=True)
def own_urs_cache(tmp_path_factory):
    """A port test module's URS disk cache: a directory of its own, which
    its spawned ranks inherit through the environment.  Every port test
    module that reaches pp.get_pp takes this fixture: the JAX package's
    tests write .urs_cache/ in place, not through a rename, while other
    workers run, so a port test reading there could find half a file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HALO_TPU_URS_CACHE", str(tmp_path_factory.mktemp("urs_cache")))
        yield


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty URS cache directory under tmp_path and empty in-memory
    caches in both packages."""
    monkeypatch.setenv("HALO_TPU_URS_CACHE", str(tmp_path))
    monkeypatch.setattr(pp_mod, "_pp_cache", {})
    monkeypatch.setattr(jpp, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(jpp, "_pp_cache", {})
    return tmp_path


def same_urs(a, b) -> bool:
    return (a.n == b.n and np.array_equal(np.asarray(a.gs_x).astype(np.int64), np.asarray(b.gs_x).astype(np.int64))
            and np.array_equal(np.asarray(a.gs_y).astype(np.int64), np.asarray(b.gs_y).astype(np.int64))
            and (a.s, a.h) == (b.s, b.h))


def test_urs_cache_port_written(cache, monkeypatch):
    """A miss generates the URS and writes urs_8.npz in the JAX layout; a
    fresh process's get_pp(8) and get_pp(4) read it (the latter sliced)
    instead of generating, and the JAX package's get_pp loads it too."""
    gen = pp_mod.get_pp(8, "cpu")
    f = cache / "urs_8.npz"
    with np.load(f) as z:
        assert {k: (z[k].dtype.kind, z[k].shape) for k in z.files} == {
            "gs_x": ("u", (18, 8)), "gs_y": ("u", (18, 8)),
            "s_x": ("U", ()), "s_y": ("U", ()), "h_x": ("U", ()), "h_y": ("U", ())}
    monkeypatch.setattr(pp_mod, "_pp_cache", {})
    monkeypatch.setattr(pp_mod, "generate", lambda *a: pytest.fail("generated instead of reading the cache"))
    assert same_urs(pp_mod.get_pp(8, "cpu"), gen)
    four = pp_mod.get_pp(4, "cpu")
    assert four.n == 4 and torch.equal(four.gs_x, gen.gs_x[:, :4]) and (four.s, four.h) == (gen.s, gen.h)
    assert same_urs(jpp.get_pp(8, use_disk_cache=True), gen)
    assert sorted(p.name for p in cache.iterdir()) == ["urs_8.npz"]


def test_urs_cache_jax_layout(cache, monkeypatch):
    """A file written as the JAX package writes it (np.savez of uint32
    planes and decimal strings) loads in the port, urs_<n> before a larger
    file and the smallest larger file sliced; a file that does not parse
    raises, naming it."""
    ref = pp_mod.generate(16, "cpu")
    gx, gy, s, h = pp_mod.to_numpy(ref)
    np.savez(cache / "urs_16.npz", gs_x=gx, gs_y=gy, s_x=str(s[0]), s_y=str(s[1]), h_x=str(h[0]), h_y=str(h[1]))
    (cache / "urs_32.npz").write_bytes(b"not a zip file")
    (cache / "urs_x.npz").write_bytes(b"no size in the name: not a cache file")
    monkeypatch.setattr(pp_mod, "generate", lambda *a: pytest.fail("generated instead of reading the cache"))
    assert same_urs(pp_mod.get_pp(16, "cpu"), ref)
    monkeypatch.setattr(pp_mod, "_pp_cache", {})
    two = pp_mod.get_pp(2, "cpu")
    assert two.n == 2 and torch.equal(two.gs_y, ref.gs_y[:, :2])
    with pytest.raises(ValueError, match="urs_32.npz does not parse"):
        pp_mod.get_pp(32, "cpu")
    np.savez(cache / "urs_64.npz", gs_x=gx, gs_y=gy, s_x="1", s_y="2", h_x="3", h_y="4")
    with pytest.raises(ValueError, match=r"urs_64.npz holds gs_x \(18, 16\)"):
        pp_mod.get_pp(64, "cpu")
