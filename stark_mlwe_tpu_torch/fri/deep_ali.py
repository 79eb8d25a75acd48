"""DEEP-ALI constraint merge on the card.

Counterpart of `fri/deep_ali.py` of the JAX package (crates/deep_ali/src/
lib.rs:48-105 of the Rust reference; golden spec in `spec.deep_ali`):

  - Phi = a*s + e - t (+ beta*R) is elementwise over the evaluation vector,
  - the f0 quotient is one batch-inversion kernel (`fr.f0_quotient`, three
    launches, nothing read back) and the barycentric sum uses
    `fr.batch_inv`, the same kernel, where the reference does O(n)
    per-element modular exponentiations,
  - omega power tables come from `fr.powers` (doubling); `DeviceDomainH`
    keeps one per domain, for barycentric evaluations and merges on it.

Returns the f0 evaluation vector in Montgomery form, ready for FRI folding
without leaving device memory.
"""

from __future__ import annotations

from ..device import resolve
from ..ops import fr
from ..spec.field import P, get_root_of_unity


def _consts(device, *values):
    return [fr.to_device(fr.pack_int(v, mont=True), device) for v in values]


def _merge_kernel(a, s, e, t, w, z_m, scale_m, r=None, beta_m=None):
    """phi = a*s+e-t (+ beta*r);  f0 = phi / (w - z);
    phi_z = scale * sum(phi*w/(z-w)).  Returns (f0 [n, 8], phi_z [8])."""
    phi = phi_kernel(a, s, e, t)
    if r is not None:
        phi = fr.add(phi, fr.mont_mul(beta_m, r))
    invs = fr.batch_inv(fr.sub(w, z_m))     # w - z, nonzero: z is outside H
    f0 = fr.mont_mul(phi, invs)
    # sum phi * w / (z - w) = -sum phi * w * invs
    terms = fr.mont_mul(fr.mont_mul(phi, w), invs)
    ssum = fr.neg(fr.reduce_add(terms))
    return f0, fr.mont_mul(scale_m, ssum)


def phi_kernel(a, s, e, t):
    """phi = a*s + e - t: no (z, beta) dependence, so it can be dispatched
    while the Fiat-Shamir column absorb is still running on the host."""
    return fr.sub(fr.add(fr.mont_mul(a, s), e), t)


def _f0_quotient(phi, w, z_m):
    return fr.f0_quotient(phi, w, z_m)


def f0_from_phi(phi0, w, z: int, beta: int = 0, r_eval=None):
    """f0 = (phi0 [+ beta*r]) / (w - z); same op order as `_merge_kernel`,
    so results are bit-identical."""
    z_m, beta_m = _consts(phi0.device, z, beta)
    if r_eval is not None:
        phi0 = fr.add(phi0, fr.mont_mul(beta_m, r_eval))
    return _f0_quotient(phi0, w, z_m)


def omega_powers(omega: int, n: int, device):
    """Device power table [1, w, ..., w^(n-1)] (Montgomery)."""
    return fr.powers(fr.to_device(fr.pack_int(omega, mont=True), device), n)


class DeviceDomainH:
    """Domain cache with an omega-power table on the device
    (deep_ali/src/lib.rs:109-215).  `device=None` is the card."""

    def __init__(self, n: int, device=None):
        self.n = n
        self.omega = get_root_of_unity(n)
        self.omega_pows = omega_powers(self.omega, n, resolve(device))

    def eval_lagrange(self, values_dev, z: int) -> int:
        """Barycentric evaluation at z (outside H) of the interpolant of
        `values_dev` ([n, 8] Montgomery, on the table's device)."""
        if pow(z, self.n, P) == 1:
            raise ValueError("z must be outside H")
        zh = (pow(z, self.n, P) - 1) % P
        scale = zh * pow(self.n % P, P - 2, P) % P
        dev = self.omega_pows.device
        z_m, scale_m = _consts(dev, z, scale)
        invs = fr.batch_inv(fr.sub(self.omega_pows, z_m))
        terms = fr.mont_mul(fr.mont_mul(values_dev, self.omega_pows), invs)
        ssum = fr.neg(fr.reduce_add(terms))
        out = fr.mont_mul(scale_m, ssum)
        return fr.unpack_ints(out[None, :], mont=True)[0]

    def merge_deep_ali(self, a, s, e, t, z: int):
        return merge_evals_device(a, s, e, t, self.omega, z)

    def merge_deep_ali_blinded(self, a, s, e, t, r_eval, beta: int, z: int):
        return merge_evals_device(a, s, e, t, self.omega, z,
                                  r_eval=r_eval, beta=beta)


def merge_evals_device(a, s, e, t, omega: int, z: int,
                       r_eval=None, beta: int = 0, with_c_star: bool = True):
    """Device DEEP-ALI merge (deep_ali/src/lib.rs:60-105).

    a, s, e, t (and optional r_eval): [n, 8] Montgomery tensors on one
    device.  Returns (f0 [n, 8] Montgomery, z, c_star int);
    with_c_star=False skips the device->host sync for c_star (the FRI
    prover only needs f0).
    """
    n = int(a.shape[0])
    assert pow(z, n, P) != 1, "z must be outside H"
    w = omega_powers(omega, n, a.device)
    if not with_c_star:
        # the quotient alone, in the op order of `_merge_kernel`: eager
        # code has no compiler to drop the unused barycentric sum
        return f0_from_phi(phi_kernel(a, s, e, t), w, z, beta=beta,
                           r_eval=r_eval), z, None
    zh = (pow(z, n, P) - 1) % P
    n_inv = pow(n % P, P - 2, P)
    scale = zh * n_inv % P
    z_m, scale_m, beta_m = _consts(a.device, z, scale, beta)
    f0, phi_z = _merge_kernel(a, s, e, t, w, z_m, scale_m,
                              r=r_eval, beta_m=beta_m)
    phi_z_int = fr.unpack_ints(phi_z[None, :], mont=True)[0]
    c_star = phi_z_int * pow(zh, P - 2, P) % P
    return f0, z, c_star
