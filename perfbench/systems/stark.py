"""DEEP-ALI + m-ary FRI proofs of the MLWE relation.

The timed call is the port's entry `fri.deep_fri_prove(
DeviceDeepAliRealBuilder(), a, s, e, t, n0, params)`: with host columns
(`[n, 8] int32` Montgomery limbs in NumPy, traffic `"witness": "host"`)
the Fiat-Shamir absorb runs in the host engine; with columns already on
the card (`"witness": "device"`) it runs in the chain kernel.  The
reference (`perfbench.reference.stark`) proves the same columns again
from their field values.
"""

from __future__ import annotations

from perfbench.harness import witness
from perfbench.reference import stark as reference_stark
from perfbench.reference.field import mont_rows_to_ints


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.n = 1 << int(traffic["k"])
        self.pool = int(traffic["pool"])
        if traffic["witness"] not in ("host", "device"):
            raise ValueError(f"witness placement {traffic['witness']!r}")

    def setup(self) -> None:
        import torch

        from stark_mlwe_tpu_torch.fri import (DeviceDeepAliRealBuilder,
                                              deep_fri_prove)
        from stark_mlwe_tpu_torch.stark import DeepFriParams

        rng = witness.generator(self.seed, "stark-columns")
        self.rows = [[witness.field_rows(rng, self.n) for _ in range(4)]
                     for _ in range(self.pool)]
        cols = [[witness.as_limbs_int32(r) for r in w] for w in self.rows]
        if self.traffic["witness"] == "device":
            dev = "cuda" if self.device is None else self.device
            cols = [[torch.from_numpy(c).to(dev) for c in w] for w in cols]
        self.cols = cols
        self.params = DeepFriParams(schedule=list(self.config["schedule"]),
                                    r=int(self.config["r"]),
                                    seed_z=int(self.config["seed_z"]))
        self._builder = DeviceDeepAliRealBuilder
        self._prove = deep_fri_prove

    def prove(self, j: int):
        return self._prove(self._builder(), *self.cols[j], self.n,
                           self.params, device=self.device)

    def release(self) -> None:
        self.cols = None

    def reference(self, j: int, suite, workers):
        cols = [mont_rows_to_ints(r) for r in self.rows[j]]
        return reference_stark.prove(cols, list(self.config["schedule"]),
                                     int(self.config["r"]),
                                     int(self.config["seed_z"]), suite,
                                     workers)
