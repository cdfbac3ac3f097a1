"""Dense univariate polynomial ops over Fr, in PyTorch.

Counterpart of `halo_accumulation_tpu/ops/poly.py`.  Coefficient vectors are
(18, n) Fr limb tensors, low degree first.  The IPA's h(X) is expanded by
its tensor structure

    h(X) = prod_i (1 + xi_{lg n - i} X^(2^i))
      =>  coeffs = (1, xi_lg) (x) (1, xi_{lg-1}) (x) ... (Kronecker),

lg n vectorized scale-and-concatenate steps, O(n) multiplies in all.
"""

from __future__ import annotations

import torch

from halo_accumulation_tpu_torch.ops.field import FR


def powers(z_limbs, n: int):
    """[1, z, ..., z^(n-1)] as (18, n) from an (18,) scalar, by doubling."""
    cur = FR.from_int(1, (1,), z_limbs.device)
    zz = z_limbs[:, None]
    while cur.shape[1] < n:
        cur = torch.cat([cur, FR.mul(zz, cur)], dim=1)
        if cur.shape[1] < n:
            zz = FR.mul(zz, zz)
    return cur[:, :n]


def eval_poly(coeffs, z_limbs):
    """p(z) for coeffs (18, n): <coeffs, powers(z, n)>, shape (18,)."""
    return FR.sum_along(FR.mul(coeffs, powers(z_limbs, coeffs.shape[1])), 0)


def scale(coeffs, s_limbs):
    return FR.mul(s_limbs[:, None], coeffs)


def add(a, b):
    """Polynomial addition, zero-padding the shorter operand."""
    na, nb = a.shape[1], b.shape[1]
    if na < nb:
        a = torch.cat([a, FR.zeros((nb - na,), a.device)], dim=1)
    elif nb < na:
        b = torch.cat([b, FR.zeros((na - nb,), b.device)], dim=1)
    return FR.add(a, b)


def tensor_h_coeffs(xis):
    """Coefficients of h(X) from challenges xis (18, lg_n + 1) or a batch
    (18, K, lg_n + 1); xis[..., 0] is not a factor.  Returns (18, 2^lg_n)
    or (18, K, 2^lg_n)."""
    lg_n = xis.shape[-1] - 1
    c = FR.from_int(1, xis.shape[1:-1] + (1,), xis.device)
    for i in range(lg_n):
        xi = xis[..., lg_n - i : lg_n - i + 1]
        c = torch.cat([c, FR.mul(xi, c)], dim=-1)
    return c


def h_eval_host(xis_ints: list[int], z: int, r: int) -> int:
    """O(lg n) evaluation of h at z on host ints."""
    lg_n = len(xis_ints) - 1
    v = (1 + xis_ints[lg_n] * z) % r
    z_i = z
    for i in range(1, lg_n):
        z_i = z_i * z_i % r
        v = v * (1 + xis_ints[lg_n - i] * z_i) % r
    return v
