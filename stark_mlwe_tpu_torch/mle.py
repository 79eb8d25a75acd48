"""Device multilinear extensions: batched pairwise and strided folds.

Counterpart of `mle.py` of the JAX package (the Rust reference's
crates/mle/src/lib.rs and the channel-internal Mle, channel/src/lib.rs:
252-297), bit-exact against `spec.mle.MLE`.  Values live on the device as
`[2^n, 8]` Montgomery limb tensors.  A fold (`fold_halves`) is
`(1 - r) * v0 + r * v1` on K2: `1 - r` by one `fr.sub` on the device (the
chains of `channel` fold by a challenge that lies on the device, with no
readback), two `fr.mont_mul` and one `fr.add`; the halves `v0`, `v1` are
strided views, which `fr`'s wrappers copy to contiguous tensors before
the launch.
"""

from __future__ import annotations

import torch

from .device import resolve
from .ops import fr


def fold_halves(v0: torch.Tensor, v1: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    """(1 - r) * v0 + r * v1 elementwise; r: [8] Montgomery on the device
    of v0 and v1."""
    om = fr.sub(fr.mont_one(r.device), r)
    return fr.add(fr.mont_mul(om, v0), fr.mont_mul(r, v1))


def _challenge(r_i: int, device) -> torch.Tensor:
    """A host challenge as a device [8] Montgomery tensor."""
    return fr.upload(fr.pack_int(r_i, mont=True), device)


class DeviceMLE:
    """values_dev: [2^n, 8] Montgomery tensor."""

    def __init__(self, values_dev: torch.Tensor):
        n = int(values_dev.shape[0])
        if n < 1 or n & (n - 1):
            raise ValueError(f"DeviceMLE: {n} values, not a power of two")
        self.values_dev = values_dev
        self.n = n.bit_length() - 1
        self._ints = None

    @classmethod
    def from_ints(cls, values, device=None) -> "DeviceMLE":
        return cls(fr.to_device(fr.pack_ints(list(values), mont=True),
                                resolve(device)))

    def values(self) -> list:
        if self._ints is None:
            self._ints = fr.unpack_ints(self.values_dev, mont=True)
        return self._ints

    def value_at(self, indices) -> list:
        if self._ints is not None:
            return [self._ints[i] for i in indices]
        idx = torch.tensor(list(indices), dtype=torch.int64)
        g = self.values_dev.index_select(0, idx.to(self.values_dev.device))
        return fr.unpack_ints(g, mont=True)

    def sum(self) -> int:
        return fr.unpack_ints(fr.reduce_add(self.values_dev), mont=True)[0]

    def fold_last(self, r_i: int) -> "DeviceMLE":
        """Low-bit pairwise fold (mle/src/lib.rs:78-94)."""
        if self.n == 0:
            return self
        v = self.values_dev.reshape(-1, 2, fr.N)
        r = _challenge(r_i, self.values_dev.device)
        return DeviceMLE(fold_halves(v[:, 0], v[:, 1], r))

    def fold(self, var_idx: int, r_i: int) -> "DeviceMLE":
        """Strided fold at variable var_idx (mle/src/lib.rs:133-161)."""
        if not 0 <= var_idx < self.n:
            raise ValueError(f"DeviceMLE.fold: variable {var_idx} of "
                             f"{self.n}")
        v = self.values_dev.reshape(-1, 2, 1 << var_idx, fr.N)
        r = _challenge(r_i, self.values_dev.device)
        return DeviceMLE(fold_halves(v[:, 0], v[:, 1], r).reshape(-1, fr.N))

    def fix(self, var_idx: int, bit: bool) -> "DeviceMLE":
        """Boolean projection (mle/src/lib.rs:100-128)."""
        if not 0 <= var_idx < self.n:
            raise ValueError(f"DeviceMLE.fix: variable {var_idx} of "
                             f"{self.n}")
        v = self.values_dev.reshape(-1, 2, 1 << var_idx, fr.N)
        return DeviceMLE(v[:, 1 if bit else 0].reshape(-1, fr.N))

    def eval(self, r: list) -> int:
        """Multilinear evaluation by repeated low-bit folds
        (mle/src/lib.rs:50-73)."""
        if len(r) != self.n:
            raise ValueError(f"DeviceMLE.eval: {len(r)} coordinates for "
                             f"{self.n} variables")
        cur = self
        for ri in r:
            cur = cur.fold_last(ri)
        return fr.unpack_ints(cur.values_dev, mont=True)[0]
