"""Port parity: the PyTorch Fq/Fr limb arithmetic against the JAX package.

Both packages hold a field element as 18 lazy 15-bit limbs and run the same
carry passes and folds, so on the same raw inputs (including lazy values
up to 2^257) the port must return the JAX package's limbs exactly, and
canonical values must equal the pure-Python int oracle."""

import numpy as np
import pytest
import torch

from halo_accumulation_tpu.ops.field import FQ as JFQ, FR as JFR
from halo_accumulation_tpu.runtime import cached_jit
from halo_accumulation_tpu_torch.ops.field import FQ, FR, L, ints_to_limb_array

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


FIELDS = {"Fq": (FQ, JFQ), "Fr": (FR, JFR)}
EDGE = lambda p: [0, 1, 2, p - 1, p - 2, p // 2, 2 * p - 1, p, p + 1, (1 << 254) - 1, 1 << 254, (1 << 255) + 5, (1 << 257) - 1]  # noqa: E731


def rand_ints(rng, n, hi):
    return [int.from_bytes(rng.bytes(40), "little") % hi for _ in range(n)]


def lazy_pair(rng, p):
    """Raw (possibly non-canonical) operands below 2^257, edges included."""
    a = rand_ints(rng, 64, 1 << 257) + EDGE(p)
    b = rand_ints(rng, 64, 1 << 257) + list(reversed(EDGE(p)))
    return a, b


def both(vs):
    """The same raw limbs as a port tensor (int64) and a JAX array (uint32)."""
    arr = ints_to_limb_array(vs)
    return torch.from_numpy(arr), np.asarray(arr, np.uint32)


@pytest.mark.parametrize("name", FIELDS)
def test_roundtrip(rng, name):
    f, jf = FIELDS[name]
    vs = rand_ints(rng, 17, f.p)
    t = f.from_ints(vs)
    assert f.to_ints(t) == vs
    assert np.array_equal(t.numpy(), np.asarray(jf.from_ints(vs)).astype(np.int64))


OPS = {
    "add": (lambda f, a, b: f.add(a, b), lambda x, y, p: (x + y) % p),
    "sub": (lambda f, a, b: f.sub(a, b), lambda x, y, p: (x - y) % p),
    "mul": (lambda f, a, b: f.mul(a, b), lambda x, y, p: x * y % p),
    "neg": (lambda f, a, b: f.neg(a), lambda x, y, p: -x % p),
    "sqr": (lambda f, a, b: f.sqr(a), lambda x, y, p: x * x % p),
    "mul_small": (lambda f, a, b: f.mul_small(a, 4095), lambda x, y, p: 4095 * x % p),
}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", FIELDS)
def test_op_matches_jax_limbs(rng, name, op):
    f, jf = FIELDS[name]
    fn, oracle = OPS[op]
    a_int, b_int = lazy_pair(rng, f.p)
    (a, ja), (b, jb) = both(a_int), both(b_int)
    got = fn(f, a, b)
    want = np.asarray(cached_jit(lambda x, y: fn(jf, x, y), "torch_parity", name, op)(ja, jb))
    assert got.dtype == torch.int64 and got.shape == (L, len(a_int))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert f.to_ints(got) == [oracle(x, y, f.p) for x, y in zip(a_int, b_int)]
    assert int(got.max()) < (1 << 31)  # limbs fit the kernels' uint32 registers


@pytest.mark.parametrize("name", FIELDS)
def test_canon_eq_is_zero(rng, name):
    f, jf = FIELDS[name]
    a_int, _ = lazy_pair(rng, f.p)
    a, ja = both(a_int)
    got = f.canon(a)
    want = np.asarray(cached_jit(jf.canon, "torch_parity", name)(ja)).astype(np.int64)
    assert np.array_equal(got.numpy(), want)
    assert f.eq(a, f.from_ints(a_int)).all()
    assert not f.eq(a, f.add(a, f.from_int(1, a.shape[1:]))).any()
    assert f.is_zero(f.sub(a, a)).all()
    assert f.is_zero(a).tolist() == [x % f.p == 0 for x in a_int]


@pytest.mark.parametrize("name", FIELDS)
def test_inv_select_sum(rng, name):
    f, _ = FIELDS[name]
    vs = rand_ints(rng, 13, f.p) + [1, f.p - 1, 0]
    a = f.from_ints(vs)
    assert f.to_ints(f.inv(a)) == [pow(v, -1, f.p) if v else 0 for v in vs]
    assert f.to_ints(f.sum_along(a, 0)) == [sum(vs) % f.p]
    m = torch.arange(len(vs)) % 2 == 0
    assert f.to_ints(f.select(m, a, f.neg(a))) == [v if i % 2 == 0 else -v % f.p for i, v in enumerate(vs)]


@pytest.mark.parametrize("name", FIELDS)
def test_pow_const_matches_jax_limbs(rng, name):
    """pow_const takes the JAX package's square-and-multiply (JAX selects
    away the multiply where a bit is 0; the port skips it), so on the same
    lazy inputs the limbs are the JAX package's; the values are pow's, and
    the inverse exponent p - 2 gives the inverse (0 for 0).  Exact."""
    f, jf = FIELDS[name]
    a_int = lazy_pair(rng, f.p)[0][:6] + [0, 1, f.p - 1]
    a, ja = both(a_int)
    e = 0xDEADBEEF12345678  # the JAX package's own test exponent (tests/test_field.py)
    got = f.pow_const(a, e)
    want = np.asarray(cached_jit(jf.pow_const, jf.name, e, static_argnums=1)(ja, e)).astype(np.int64)
    assert np.array_equal(got.numpy(), want)
    assert f.to_ints(got) == [pow(x, e, f.p) for x in a_int]
    assert f.to_ints(f.pow_const(a, f.p - 2)) == [pow(x, f.p - 2, f.p) for x in a_int]


@pytest.mark.parametrize("name", FIELDS)
def test_inv_root_stays_on_the_device(rng, name, monkeypatch):
    """On the CPU inv inverts its product tree's root with pow_const (the
    finv kernel's plain twin), never through host ints: with to_ints and
    every copy to the CPU made to fail, a batch holding zeros still gives
    the canonical limbs of the inverses, and exact zero limbs for 0.
    tests/test_torch_cuda.py holds the card's lane-wise finv to this."""
    f, _ = FIELDS[name]
    vs = rand_ints(rng, 5, f.p) + [0, 1, f.p - 1, 0, 2]
    a = f.from_ints(vs)
    want = ints_to_limb_array([pow(v, -1, f.p) if v else 0 for v in vs])

    def refuse(*args, **kwargs):
        raise AssertionError("inv copied to the host")

    monkeypatch.setattr(type(f), "to_ints", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    raw = f.inv(a)
    got = f.canon(raw)
    monkeypatch.undo()
    assert np.array_equal(got.numpy(), want)
    assert ((raw == 0).all(0)).tolist() == [v == 0 for v in vs]
