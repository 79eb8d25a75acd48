"""The Fiat-Shamir sponge transcript over t = 17 Poseidon
(crates/transcript/src/lib.rs): DS tags "FSv1-TRANSCRIPT-INIT",
"FSv1-ABSORB-BYTES", "FSv1-CHALLENGE"; bytes packed into 31-byte LE
words; a permutation only when the rate is full or at a challenge, which
emits lane 0 and resets the cursor."""

from __future__ import annotations

from .field import P
from .poseidon import Params

T = 17
RATE = 16


def tag_to_field(tag: bytes) -> int:
    if len(tag) <= 32:
        return int.from_bytes(tag.ljust(32, b"\x00"), "little") % P
    acc = 0
    for off in range(0, len(tag), 32):
        acc += int.from_bytes(tag[off:off + 32].ljust(32, b"\x00"), "little")
    return acc % P


def bytes_to_words(data: bytes) -> list:
    return [int.from_bytes(data[off:off + 31], "little") % P
            for off in range(0, len(data), 31)]


DS_INIT = tag_to_field(b"FSv1-TRANSCRIPT-INIT")
DS_ABSORB_BYTES = tag_to_field(b"FSv1-ABSORB-BYTES")
DS_CHALLENGE = tag_to_field(b"FSv1-CHALLENGE")


class Transcript:
    def __init__(self, label: bytes, params: Params):
        if params.t != T:
            raise ValueError("the transcript runs at t = 17")
        self.params = params
        self.state = [0] * T
        self.state[T - 1] = DS_INIT
        self.pos = 0
        self.absorb_bytes(label)

    def absorb_bytes(self, data: bytes) -> None:
        self.absorb_fields([DS_ABSORB_BYTES] + bytes_to_words(data))

    def absorb_field(self, x: int) -> None:
        self.absorb_fields([x])

    def absorb_fields(self, xs) -> None:
        for x in xs:
            if self.pos == RATE:
                self.state = self.params.permute(self.state)
                self.pos = 0
            self.state[self.pos] = (self.state[self.pos] + x) % P
            self.pos += 1

    def challenge(self, label: bytes) -> int:
        self.absorb_field(DS_CHALLENGE)
        self.absorb_bytes(label)
        self.state = self.params.permute(self.state)
        self.pos = 0
        return self.state[0]


def tagged_hash(tag: bytes, fields, params: Params) -> int:
    """fri.rs:28-35: a fresh "FRI/FS" transcript over a tag and fields."""
    tr = Transcript(b"FRI/FS", params)
    tr.absorb_bytes(tag)
    tr.absorb_fields(fields)
    return tr.challenge(b"out")
