"""Device-resident Fiat-Shamir transcript.

Counterpart of `transcript_dev.py` of the JAX package, bit-exact against
`spec.transcript.Transcript` (the Rust reference's
crates/transcript/src/lib.rs): the t=17 sponge state lives on the device
as a `[17, 8]` Montgomery limb tensor; the rate cursor and every static
absorbed word (DS markers, labels, round indices) are tracked on the host.
Static words accumulate in a pending host vector and land as ONE modular
add right before each permutation; dynamic values (device `[8]` field
elements) are added at their rate slot directly.

A whole prover FS chain (claims, coefficients, challenges, folds) thus runs
as eager device calls with no readback: a permutation is `ops.poseidon.
permute` of one state (K1's warp layout), the pending vector goes up
through pinned memory without a host sync (`fr.upload`), and the proof
values come back in a single bulk read afterwards.
"""

from __future__ import annotations

import torch

from .device import resolve
from .ops import fr
from .ops import poseidon as dpos
from .spec.field import P
from .spec.transcript import (DS_ABSORB_BYTES, DS_CHALLENGE, RATE, T,
                              Transcript, bytes_to_field_words,
                              default_params, domain_tag_to_field)

_DS_ABS = domain_tag_to_field(DS_ABSORB_BYTES)
_DS_CHAL = domain_tag_to_field(DS_CHALLENGE)


def transcript_params() -> dpos.DeviceParams:
    """The transcript's t=17 Poseidon constants (per-device caches)."""
    return dpos.device_params(default_params())


class DeviceTranscript:
    """Transcript with the sponge state on the device (see module doc)."""

    def __init__(self, label: bytes, device=None):
        self.device = resolve(device)
        host = Transcript(label)  # cheap host replay of the init block
        self._state = fr.upload(fr.pack_ints(list(host.state), mont=True),
                                self.device)
        self.pos = host.pos
        self._pend = [0] * T
        self._has_pend = False
        self._params = transcript_params()

    # -- internals ---------------------------------------------------------

    def _flush(self) -> None:
        if not self._has_pend:
            return
        cvec = fr.upload(fr.pack_ints(self._pend, mont=True), self.device)
        self._state = fr.add(self._state, cvec)
        self._pend = [0] * T
        self._has_pend = False

    def _permute(self) -> None:
        self._flush()
        self._state = dpos.permute(self._state[None], self._params)[0]
        self.pos = 0

    def _absorb_one_const(self, x: int) -> None:
        if self.pos == RATE:
            self._permute()
        self._pend[self.pos] = (self._pend[self.pos] + x) % P
        self._has_pend = True
        self.pos += 1

    # -- public, mirroring spec.transcript.Transcript ----------------------

    def absorb_bytes(self, data: bytes) -> None:
        self._absorb_one_const(_DS_ABS)
        for w in bytes_to_field_words(data):
            self._absorb_one_const(w)

    def absorb_field_const(self, x: int) -> None:
        self._absorb_one_const(x % P)

    def absorb_field_dev(self, vec: torch.Tensor) -> None:
        """Absorb a device [8] Montgomery field element."""
        if self.pos == RATE:
            self._permute()
        p = self.pos
        self._state = torch.cat([self._state[:p],
                                 fr.add(self._state[p:p + 1], vec[None]),
                                 self._state[p + 1:]], dim=0)
        self.pos += 1

    def challenge_dev(self, label: bytes) -> torch.Tensor:
        """transcript/src/lib.rs:92-101; returns a device [8] Montgomery
        tensor (no readback)."""
        self._absorb_one_const(_DS_CHAL)
        self.absorb_bytes(label)
        self._permute()
        return self._state[0]
