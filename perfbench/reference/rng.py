"""Rust `rand::rngs::StdRng` (rand 0.8: ChaCha12 in a 64-word BlockRng),
as far as the proofs draw from it: `from_seed` with 32 canonical field
bytes, then `gen::<u64>()` draws (FRI z per layer, DEEP (z, beta), query
indices)."""

from __future__ import annotations

_MASK32 = 0xFFFFFFFF


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK32


def _chacha_block(key_words, counter: int, rounds: int) -> list:
    st = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574, *key_words,
          counter & _MASK32, (counter >> 32) & _MASK32, 0, 0]
    x = list(st)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(x[i] + st[i]) & _MASK32 for i in range(16)]


class StdRng:
    BUF_WORDS = 64        # rand_chacha makes four blocks at a time
    ROUNDS = 12

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("StdRng seed is 32 bytes")
        self._key = [int.from_bytes(seed[4 * i:4 * i + 4], "little")
                     for i in range(8)]
        self._counter = 0
        self._results: list = []
        self._index = self.BUF_WORDS

    def _generate(self) -> None:
        res = []
        for _ in range(4):
            res.extend(_chacha_block(self._key, self._counter, self.ROUNDS))
            self._counter += 1
        self._results = res

    def gen_u64(self) -> int:
        idx = self._index
        if idx < self.BUF_WORDS - 1:
            lo, hi = self._results[idx], self._results[idx + 1]
            self._index = idx + 2
        elif idx >= self.BUF_WORDS:
            self._generate()
            lo, hi = self._results[0], self._results[1]
            self._index = 2
        else:     # the low word ends this buffer, the high one starts the next
            lo = self._results[idx]
            self._generate()
            hi = self._results[0]
            self._index = 1
        return (hi << 32) | lo
