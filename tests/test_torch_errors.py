"""The port raises what the JAX package raises, type and text alike.

Each case calls both packages on the same bad input and compares type(e)
and str(e).  Every JAX check here is an assert that fires before any jit,
so no JAX graph is traced.  The public parameters are a small URS that the
port makes on the CPU, handed to the JAX package's parameters type.  The
rejection texts that chip_smoke.py provokes on the card are held to the
JAX package's sources, read as text.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from halo_accumulation_tpu import acc as jacc, chain as jchain, fields as JF, pcdl as jpcdl, pp as jpp
from halo_accumulation_tpu.utils import serialize as jser
from halo_accumulation_tpu_torch import acc, chain, fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops.field import FR, L
from halo_accumulation_tpu_torch.utils import serialize as ser
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

JAX_SRC = pathlib.Path(jacc.__file__).resolve().parent
PORT_SRC = pathlib.Path(acc.__file__).resolve().parent
CHAIN_512 = PORT_SRC.parent / ".chain_cache" / "chain_512_10.bin"
N = 16


@pytest.fixture(scope="module")
def pps():
    """(port, JAX) public parameters of one 16-generator URS made by the port."""
    pp = pp_mod.get_pp(N, "cpu")
    gx, gy, s, h = pp_mod.to_numpy(pp)
    return pp, jpp.PublicParams(N, gx, gy, s, h)


def raised(fn) -> BaseException:
    with pytest.raises(BaseException) as e:
        fn()
    return e.value


def assert_same(port_fn, jax_fn):
    got, want = raised(port_fn), raised(jax_fn)
    assert (type(got), str(got)) == (type(want), str(want))
    return got


@pytest.mark.parametrize("d", [2, 31, 40], ids=["not_pow2", "beyond_urs", "both"])
def test_commit_degree(pps, d):
    """commit checks d + 1 as the JAX package does: a power of two first,
    then no larger than the URS, each with its own text."""
    pp, jp = pps
    e = assert_same(lambda: pcdl.commit([1, 2, 3], d, None, pp), lambda: jpcdl.commit([1, 2, 3], d, None, jp))
    assert str(e) == ("degree exceeds URS size" if d == 31 else "d+1 must be a power of two")


@pytest.mark.parametrize("d", [2, 31], ids=["not_pow2", "beyond_urs"])
@pytest.mark.parametrize("entry", ["open", "commit_device", "deferred_device"])
def test_device_entries_degree(pps, entry, d):
    """open_ and the device commits assert the degree bare, as the JAX
    package's open_ and commit_device do.  The deciders' deferred MSM
    (pcdl.verdicts_device, eager or graphed) is held to commit_device,
    which JAX's check_device reaches for the same MSM."""
    pp, jp = pps
    coeffs = FR.from_ints([1, 2, 3])
    rng = np.random.default_rng(0)
    if entry == "open":
        port = lambda: pcdl.open_(rng, [1, 2, 3], None, d, 5, None, pp)  # noqa: E731
        jax = lambda: jpcdl.open_(rng, [1, 2, 3], None, d, 5, None, jp)  # noqa: E731
    elif entry == "commit_device":
        port = lambda: pcdl.commit_device(coeffs, d, pp)  # noqa: E731
        jax = lambda: jpcdl.commit_device(None, d, jp)  # noqa: E731
    else:
        port = lambda: pcdl.verdicts_device([], [], [], d, pp, graph=False)  # noqa: E731
        jax = lambda: jpcdl.commit_device(None, d, jp)  # noqa: E731
    e = assert_same(port, jax)
    assert type(e) is AssertionError and str(e) == ""


def test_verify_chain_counts_steps():
    """One accumulator per step: a bare assert in both packages, before
    anything reads the parameters."""
    assert_same(lambda: acc.verify_chain(15, [[], []], [], None), lambda: jacc.verify_chain(15, [[], []], [], None))


@pytest.mark.parametrize("size", [0, 32, 34])
def test_point_encoding_length(size):
    assert_same(lambda: ser.deser_point(bytes(size)), lambda: jser.deser_point(bytes(size)))


def test_urs_size(monkeypatch):
    """A URS of 24 generators: the JAX package asserts before its caches."""
    monkeypatch.setattr(jpp, "_pp_cache", {})
    e = assert_same(lambda: pp_mod.get_pp(24, "cpu"), lambda: jpp.get_pp(24, use_disk_cache=False))
    assert str(e) == "URS size must be a power of two"
    assert_same(lambda: pp_mod.generate(24, "cpu"), lambda: jpp.get_pp(24, use_disk_cache=False))


def test_urs_generator_at_identity(monkeypatch):
    """A generator that hashes to the identity cannot be made from real
    input: both packages' affine conversion is made to report one.  The JAX
    package's generation graphs are replaced by stand-ins of the right
    shapes, so nothing is traced."""
    n = 4

    def to_affine_at_identity(P):
        z = torch.zeros((L, P.x.shape[1]), dtype=torch.int64)
        return z, z, torch.ones(P.x.shape[1], dtype=torch.bool)

    monkeypatch.setattr(pp_mod.cv, "to_affine", to_affine_at_identity)

    def jax_stand_in(fn, *args, **kwargs):
        if fn is jpp._fixed_base_mul_batch:
            return lambda tables, d: tuple(np.zeros((L, d.shape[1]), np.uint32) for _ in range(3))
        z = np.zeros((L, n + 2), np.uint32)
        return lambda P: (z, z, np.ones(n + 2, bool))

    monkeypatch.setattr(jpp, "_pp_cache", {})
    monkeypatch.setattr(jpp, "_window_tables", lambda: None)
    monkeypatch.setattr(jpp, "cached_jit", jax_stand_in)
    e = assert_same(lambda: pp_mod.generate(n, "cpu"), lambda: jpp.get_pp(n, use_disk_cache=False))
    assert str(e) == "URS generator hashed to identity"


@pytest.mark.parametrize("key", sorted(chip_smoke.REJECT_TEXTS))
def test_reject_texts_are_the_jax_packages(key):
    """Every rejection text that chip_smoke.py provokes on the card is a
    string literal (or the f-string that makes it, {k} / {b} for the step)
    of the JAX package's acc.py or pcdl.py, and of the port's."""
    text = chip_smoke.REJECT_TEXTS[key]
    quoted = f'"{text}"'
    for root in (JAX_SRC, PORT_SRC):
        src = (root / "acc.py").read_text() + (root / "pcdl.py").read_text()
        assert quoted in src, (root.name, text)


def test_succinct_check_degree():
    """A degree whose d + 1 is no power of two, checked before the proof is
    read, with the JAX package's text."""
    _, qss, _ = chain.load_chain(CHAIN_512)
    q = qss[0][0]
    e = assert_same(lambda: pcdl.succinct_check_parts(q.C, 6, q.z, q.v, q.pi, None),
                    lambda: jpcdl.succinct_check_parts(q.C, 6, q.z, q.v, q.pi, None))
    assert str(e) == "d+1 is not a power of 2"


def test_point_not_on_curve():
    """A compressed x with no y on the curve: the first such x from 0 up."""
    x = next(x for x in range(100) if F.sqrt_mod(x**3 + F.B_COEFF, F.Q) is None)
    b = x.to_bytes(33, "little")
    e = assert_same(lambda: ser.deser_point(b), lambda: jser.deser_point(b))
    assert type(e) is ValueError and str(e) == "x is not on the curve"


@pytest.fixture(scope="module")
def step_512():
    """The first step of chain_512_10.bin in both packages' types, and the
    (port, JAX) parameters of a 512-generator URS made by the port."""
    pp = pp_mod.get_pp(512, "cpu")
    gx, gy, s, h = pp_mod.to_numpy(pp)
    d, qss, accs = chain.load_chain(CHAIN_512)
    jd, jqss, jaccs = jchain.load_chain(CHAIN_512)
    return (d, qss[0], accs[0], pp), (jd, jqss[0], jaccs[0], jpp.PublicParams(512, gx, gy, s, h))


def _jax_succinct_check_batch(checks, pp, mesh=None, axis=None):
    """The JAX package's succinct_check_batch with its row MSM on the int
    oracle (the same replay, verdicts and text, and no XLA compile)."""
    out = []
    for b, chk in enumerate(checks):
        h, pts, scs = jpcdl.succinct_check_parts(*chk, pp)
        if JF.p_msm(scs, pts) is not None:
            raise ValueError(f"C_(log_n) != CM.Commit_Sigma(c || v') (batch index {b})")
        out.append((h, chk[4].U))
    return out


@pytest.mark.parametrize("field", ["C_bar", "z", "d", "v"])
def test_acc_verifier_texts(step_512, field, monkeypatch):
    """acc.verifier on the first step of chain_512_10.bin with one field of
    the accumulator changed rejects with the JAX package's text: another
    step's C_bar, z + 1, d + 1 or v + 1 (the port's row MSM runs its CPU
    twins; the JAX package's runs on the int oracle)."""
    (d, qs, a, pp), (jd, jqs, ja, jp) = step_512
    other = chain.load_chain(CHAIN_512)[2][1].C_bar
    change = {"C_bar": lambda x: dataclasses.replace(x, C_bar=other),
              "z": lambda x: dataclasses.replace(x, z=(x.z + 1) % F.R),
              "d": lambda x: dataclasses.replace(x, d=x.d + 1),
              "v": lambda x: dataclasses.replace(x, v=(x.v + 1) % F.R)}[field]
    monkeypatch.setattr(jpcdl, "succinct_check_batch", _jax_succinct_check_batch)
    e = assert_same(lambda: acc.verifier(d, qs, change(a), pp), lambda: jacc.verifier(jd, jqs, change(ja), jp))
    assert str(e) == {"C_bar": "C_bar' != C_bar", "z": "z' != z", "d": "d' != d", "v": "h(z) != v"}[field]
