"""Merkle-folded sum-check NIZK proofs.

The timed call is the port's entry `channel.prove_mf(vk, witness)` with
the witness as 2^k Python ints (traffic `"witness": "host"`), `vk =
build_vk_mf(k, ds_tag, queries_per_round)`.  The reference
(`perfbench.reference.nizk_mf`) proves the same values again.
"""

from __future__ import annotations

from perfbench.harness import witness
from perfbench.reference import nizk_mf as reference_mf


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.k = int(traffic["k"])
        self.pool = int(traffic["pool"])
        if traffic["witness"] != "host":
            raise ValueError(f"witness placement {traffic['witness']!r}")

    def setup(self) -> None:
        from stark_mlwe_tpu_torch.channel import prove_mf
        from stark_mlwe_tpu_torch.spec.channel import build_vk_mf

        rng = witness.generator(self.seed, "nizk-values")
        self.values = [witness.as_ints(witness.field_rows(rng, 1 << self.k))
                       for _ in range(self.pool)]
        self.vk = build_vk_mf(self.k, ds_tag=int(self.config["ds_tag"]),
                              queries_per_round=int(
                                  self.config["queries_per_round"]))
        self._prove = prove_mf

    def prove(self, j: int):
        return self._prove(self.vk, self.values[j], device=self.device)

    def release(self) -> None:
        pass

    def reference(self, j: int, suite, workers):
        return reference_mf.prove(self.values[j], self.k,
                                  int(self.config["ds_tag"]),
                                  int(self.config["queries_per_round"]),
                                  suite, workers)
