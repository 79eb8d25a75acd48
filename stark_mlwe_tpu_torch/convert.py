"""Carrying state across from the JAX package, without importing it.

The JAX package stores an Fr element as 16 limbs of 16 bits in uint32
lanes; the port stores it as 8 limbs of 32 bits in int32.  Both use
R = 2^256, so Montgomery-form values are the same integers and the
conversions are pure numpy repacks.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import fr
from .spec.field import P
from .spec.poseidon import PoseidonParams


def from_jax_limbs(arr) -> torch.Tensor:
    """[..., 16] uint32 (16-bit limbs) -> [..., 8] int32 CPU tensor."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    if a.shape[-1] != 16:
        raise ValueError(f"expected [..., 16] limbs, got {a.shape}")
    out = a.astype("<u2").view("<i4").reshape(a.shape[:-1] + (fr.N,))
    return torch.from_numpy(out.copy())


def to_jax_limbs(x) -> np.ndarray:
    """[..., 8] int32 tensor or array -> [..., 16] uint32 (16-bit limbs)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.ascontiguousarray(x, dtype="<i4")
    if a.shape[-1] != fr.N:
        raise ValueError(f"expected [..., 8] limbs, got {a.shape}")
    return a.view("<u2").reshape(a.shape[:-1] + (16,)).astype(np.uint32)


def _ints(limbs16) -> list:
    a = np.asarray(limbs16, dtype=np.uint32).reshape(-1, 16).astype("<u2")
    buf = a.tobytes()
    return [int.from_bytes(buf[32 * i:32 * i + 32], "little")
            for i in range(a.shape[0])]


def params_from_numpy(mds_scaled, rc_full, rc_part, t: int, rate: int,
                      rf: int, rp: int) -> PoseidonParams:
    """Rebuild spec Poseidon parameters from the numpy arrays of a JAX
    `DeviceParams`: `mds_scaled` [t, t, 16] holds M * 2^272 mod P
    (canonical limbs), `rc_full` [rf, t, 16] and `rc_part` [rp, 16] are
    Montgomery form.  The result feeds `ops.poseidon.device_params`."""
    unscale = pow(pow(2, 272, P), P - 2, P)
    mds_flat = [v * unscale % P for v in _ints(mds_scaled)]
    mds = [mds_flat[i * t:(i + 1) * t] for i in range(t)]
    rcf_flat = [v * fr.R_INV % P for v in _ints(rc_full)]
    rcf = [rcf_flat[r * t:(r + 1) * t] for r in range(rf)]
    rcp = [v * fr.R_INV % P for v in _ints(rc_part)]
    return PoseidonParams(t, rate, rf, rp, mds, rcf, rcp)
