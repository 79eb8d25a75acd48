"""Fiat-Shamir sponge transcript over the fixed t=17 Poseidon permutation.

Mirrors `the Rust reference, crates/transcript/src/lib.rs`:
  - DS tags "FSv1-TRANSCRIPT-INIT" / "FSv1-ABSORB-BYTES" / "FSv1-CHALLENGE",
  - byte strings packed into 31-byte little-endian field words (:32-41),
  - lazy absorption (permute only when the rate is full, :79-88),
  - `challenge` absorbs CHALLENGE marker + label, permutes, emits state[0]
    and resets the rate cursor (:92-101),
  - `challenges(label, n)` suffixes the label with i as LE u64 (:103-112),
  - default params seeded with b"POSEIDON-T17-X5-TRANSCRIPT" (:44-46) —
    note this differs from merkle's default seed.
"""

from __future__ import annotations

from .field import P
from .poseidon import PoseidonParams, generate_params_t17, permute

DS_TRANSCRIPT_INIT = b"FSv1-TRANSCRIPT-INIT"
DS_ABSORB_BYTES = b"FSv1-ABSORB-BYTES"
DS_CHALLENGE = b"FSv1-CHALLENGE"

T = 17
RATE = 16


def default_params() -> PoseidonParams:
    return generate_params_t17(b"POSEIDON-T17-X5-TRANSCRIPT")


def domain_tag_to_field(tag: bytes) -> int:
    """transcript/src/lib.rs:13-29."""
    if len(tag) <= 32:
        return int.from_bytes(tag + b"\x00" * (32 - len(tag)), "little") % P
    acc = 0
    for off in range(0, len(tag), 32):
        chunk = tag[off:off + 32]
        acc = (acc + int.from_bytes(chunk + b"\x00" * (32 - len(chunk)),
                                    "little")) % P
    return acc


def bytes_to_field_words(data: bytes) -> list:
    """31-byte little-endian words (transcript/src/lib.rs:32-41)."""
    out = []
    for off in range(0, len(data), 31):
        chunk = data[off:off + 31]
        out.append(int.from_bytes(chunk, "little") % P)
    return out


class Transcript:
    def __init__(self, label: bytes, params: PoseidonParams | None = None):
        self.params = params if params is not None else default_params()
        assert self.params.t == T
        self.state = [0] * T
        self.pos = 0
        self.state[T - 1] = domain_tag_to_field(DS_TRANSCRIPT_INIT)
        self.absorb_bytes(label)

    def absorb_bytes(self, data: bytes) -> None:
        self.absorb_field(domain_tag_to_field(DS_ABSORB_BYTES))
        self.absorb_fields(bytes_to_field_words(data))

    def absorb_field(self, x: int) -> None:
        self.absorb_fields([x])

    def absorb_fields(self, xs: list) -> None:
        for x in xs:
            if self.pos == RATE:
                self.state = permute(self.state, self.params)
                self.pos = 0
            self.state[self.pos] = (self.state[self.pos] + x) % P
            self.pos += 1

    def challenge(self, label: bytes) -> int:
        self.absorb_field(domain_tag_to_field(DS_CHALLENGE))
        self.absorb_bytes(label)
        self.state = permute(self.state, self.params)
        self.pos = 0
        return self.state[0]

    def challenges(self, label: bytes, n: int) -> list:
        return [self.challenge(label + i.to_bytes(8, "little"))
                for i in range(n)]
