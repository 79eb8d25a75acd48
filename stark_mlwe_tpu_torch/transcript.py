"""Runtime Fiat-Shamir transcript: spec semantics, native permutations.

`FastTranscript` is bit-identical to `spec.transcript.Transcript`
(crates/transcript/src/lib.rs of the Rust reference) but runs each
sequential t=17 permutation in the native C++ engine.
"""

from __future__ import annotations

from . import native
from .spec.field import P
from .spec.transcript import (DS_CHALLENGE, RATE, Transcript,
                              domain_tag_to_field)


class FastTranscript(Transcript):
    def _permute(self):
        self.state = native.permute_ints(self.state, self.params)

    def absorb_fields(self, xs) -> None:
        for x in xs:
            if self.pos == RATE:
                self._permute()
                self.pos = 0
            self.state[self.pos] = (self.state[self.pos] + x) % P
            self.pos += 1

    def challenge(self, label: bytes) -> int:
        self.absorb_field(domain_tag_to_field(DS_CHALLENGE))
        self.absorb_bytes(label)
        self._permute()
        self.pos = 0
        return self.state[0]


def resume_fast(state_ints, pos: int, params=None) -> FastTranscript:
    """Rebuild a FastTranscript from raw sponge state."""
    from .spec.transcript import default_params

    tr = FastTranscript.__new__(FastTranscript)
    tr.params = params if params is not None else default_params()
    tr.state = list(state_ints)
    tr.pos = pos
    return tr
