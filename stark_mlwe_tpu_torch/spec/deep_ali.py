"""DEEP-ALI constraint merging for the MLWE relation a*s + e = t: golden spec.

Mirrors `the Rust reference, crates/deep_ali/src/lib.rs`:
  - barycentric Lagrange evaluation on the multiplicative subgroup H
    (f(z) = (Z_H(z)/n) * sum_j f(w^j) w^j / (z - w^j), :17-45),
  - Phi = a*s + e - t (+ beta*R) on H, c* = Phi(z)/Z_H(z),
    f0(w^j) = Phi(w^j)/(w^j - z) (:48-105),
  - DomainH cache (:109-215),
  - deterministic (z, beta) test sampler via StdRng::seed_from_u64 (:219-230).

The spec model batch-inverts where the reference does per-element
inversion — same values, just not O(n) modular exponentiations.
"""

from __future__ import annotations

from .field import P, compute_powers, get_root_of_unity, inv
from .rng import StdRng


def is_in_domain(z: int, n: int) -> bool:
    return pow(z, n, P) == 1


def zh_at(z: int, n: int) -> int:
    return (pow(z, n, P) - 1) % P


def batch_inverse(xs: list) -> list:
    """Montgomery's trick; all xs must be nonzero mod P."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        assert x % P != 0
        prefix[i + 1] = prefix[i] * x % P
    acc = inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = acc * prefix[i] % P
        acc = acc * xs[i] % P
    return out


def lagrange_eval_on_h(values: list, z: int, omega: int) -> int:
    """deep_ali/src/lib.rs:17-45."""
    n = len(values)
    assert n > 0
    omega_pows = compute_powers(omega, n)
    if is_in_domain(z, n):
        for j, w in enumerate(omega_pows):
            if z % P == w:
                return values[j]
        raise ValueError("z in domain but not a power of omega")

    zh = zh_at(z, n)
    n_inv = inv(n % P)
    invs = batch_inverse([(z - w) % P for w in omega_pows])
    s = 0
    for j in range(n):
        s += values[j] * omega_pows[j] % P * invs[j]
    return zh * n_inv % P * (s % P) % P


def deep_ali_merge_evals_blinded(a_eval, s_eval, e_eval, t_eval,
                                 r_eval_opt, beta, omega, z):
    """deep_ali/src/lib.rs:60-105.  Returns (f0_eval, z, c_star)."""
    n = len(a_eval)
    assert n > 1
    assert len(s_eval) == len(e_eval) == len(t_eval) == n
    if r_eval_opt is not None:
        assert len(r_eval_opt) == n
    assert not is_in_domain(z, n), "z must be outside H"

    phi = []
    for i in range(n):
        base = (a_eval[i] * s_eval[i] + e_eval[i] - t_eval[i]) % P
        if r_eval_opt is not None:
            base = (base + beta * r_eval_opt[i]) % P
        phi.append(base)

    phi_z = lagrange_eval_on_h(phi, z, omega)
    c_star = phi_z * inv(zh_at(z, n)) % P

    omega_pows = compute_powers(omega, n)
    invs = batch_inverse([(w - z) % P for w in omega_pows])
    f0 = [phi[j] * invs[j] % P for j in range(n)]
    return f0, z, c_star


def deep_ali_merge_evals(a_eval, s_eval, e_eval, t_eval, omega, z):
    return deep_ali_merge_evals_blinded(a_eval, s_eval, e_eval, t_eval,
                                        None, 0, omega, z)


class DomainH:
    """deep_ali/src/lib.rs:109-215."""

    def __init__(self, n: int):
        self.n = n
        self.omega = get_root_of_unity(n)
        self.omega_pows = compute_powers(self.omega, n)

    def eval_lagrange(self, values, z):
        assert len(values) == self.n
        return lagrange_eval_on_h(values, z, self.omega)

    def merge_deep_ali(self, a_eval, s_eval, e_eval, t_eval, z):
        return deep_ali_merge_evals(a_eval, s_eval, e_eval, t_eval,
                                    self.omega, z)

    def merge_deep_ali_blinded(self, a_eval, s_eval, e_eval, t_eval,
                               r_eval_opt, beta, z):
        return deep_ali_merge_evals_blinded(a_eval, s_eval, e_eval, t_eval,
                                            r_eval_opt, beta, self.omega, z)


def sample_z_beta_from_seed(seed: int, n: int):
    """Deterministic simulatable-view sampler (deep_ali/src/lib.rs:219-230)."""
    rng = StdRng.seed_from_u64(seed)
    beta = rng.gen_u64() % P
    while True:
        cand = rng.gen_u64() % P
        if not is_in_domain(cand, n):
            return cand, beta
