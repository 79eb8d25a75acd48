"""Bit-exact reproduction of Rust `rand::rngs::StdRng` (rand 0.8 = ChaCha12).

FRI query indices and the DEEP (z, beta) samples flow through
`StdRng::from_seed(<32 canonical Fr bytes>)` followed by `gen::<u64>()`
draws (`the Rust reference, crates/deep_ali/src/fri.rs:59-82,180-191,511-533`).
Bit-exact proofs therefore require a faithful ChaCha12 keystream plus the
rand-core `BlockRng` word-index semantics, which this module provides:

  - ChaCha12 (djb variant: 64-bit block counter at words 12-13, 64-bit
    stream id at words 14-15, both zero for `from_seed`),
  - rand_chacha's 4-block (64 u32 word) results buffer,
  - `BlockRng::{next_u32, next_u64}` index handling, including the
    cross-block read when the index sits on the last word,
  - `SeedableRng::seed_from_u64` (SplitMix64 seed expansion),
  - ark-ff `UniformRand` for Fp (samples Montgomery limbs, masks the top
    bit, rejects >= p).
"""

from __future__ import annotations

from . import field

_MASK32 = 0xFFFFFFFF
_DRAW_CHUNK_BLOCKS = 1 << 16  # ChaCha blocks a chunk: 4 MiB of keystream


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK32


def _chacha_block(key_words, counter: int, rounds: int):
    c = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
    st = [
        c[0], c[1], c[2], c[3],
        *key_words,
        counter & _MASK32, (counter >> 32) & _MASK32,
        0, 0,
    ]
    x = list(st)

    def qr(a, b, cc, d):
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[cc] = (x[cc] + x[d]) & _MASK32
        x[b] = _rotl(x[b] ^ x[cc], 12)
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[cc] = (x[cc] + x[d]) & _MASK32
        x[b] = _rotl(x[b] ^ x[cc], 7)

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


def _chacha_blocks_np(keys, counters, rounds: int = 12):
    """Vectorized ChaCha keystream: keys [B, 8] uint32, counters [B]
    uint64 -> [B, 16] uint32 output blocks.  Bit-identical to
    `_chacha_block` (tests/test_spec_kat.py); numpy uint32 arithmetic
    wraps mod 2^32 like the scalar path."""
    import numpy as np

    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 8)
    counters = np.asarray(counters, dtype=np.uint64).reshape(-1)
    B = keys.shape[0]
    x = np.empty((16, B), np.uint32)
    x[0], x[1], x[2], x[3] = 0x61707865, 0x3320646E, 0x79622D32, 0x6B206574
    x[4:12] = keys.T
    x[12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    x[13] = (counters >> np.uint64(32)).astype(np.uint32)
    x[14] = 0
    x[15] = 0
    st = x.copy()

    def rotl(v, n):
        return (v << np.uint32(n)) | (v >> np.uint32(32 - n))

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] = rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = rotl(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    x += st
    return x.T


def chacha_first_u64_batch(seeds) -> list:
    """First `gen_u64()` of `StdRng::from_seed(seed)` for MANY seeds in
    one vectorized keystream call (the per-(layer, query) FRI index
    draws, fri.rs:180-191, are exactly this shape)."""
    import numpy as np

    keys = np.frombuffer(b"".join(seeds), dtype="<u4").reshape(-1, 8)
    blocks = _chacha_blocks_np(keys, np.zeros(keys.shape[0], np.uint64))
    out = blocks[:, 0].astype(np.uint64) | (
        blocks[:, 1].astype(np.uint64) << np.uint64(32))
    return [int(v) for v in out]


class StdRng:
    """rand 0.8 StdRng == ChaCha12Rng wrapped in BlockRng (64-word buffer)."""

    BUF_WORDS = 64  # rand_chacha generates 4 ChaCha blocks at a time
    ROUNDS = 12

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self._key = [int.from_bytes(seed[4 * i:4 * i + 4], "little") for i in range(8)]
        self._counter = 0  # block counter of the NEXT block to generate
        self._results: list = []
        self._index = self.BUF_WORDS  # forces generation on first use

    @classmethod
    def from_seed(cls, seed: bytes) -> "StdRng":
        return cls(seed)

    @classmethod
    def seed_from_u64(cls, state: int) -> "StdRng":
        """rand_core SeedableRng::seed_from_u64 default impl (SplitMix64)."""
        out = b""
        s = state & 0xFFFFFFFFFFFFFFFF
        for _ in range(4):
            s = (s + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
            z = s
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
            z = z ^ (z >> 31)
            out += z.to_bytes(8, "little")
        return cls(out)

    def _generate(self) -> None:
        res = []
        for _ in range(4):
            res.extend(_chacha_block(self._key, self._counter, self.ROUNDS))
            self._counter += 1
        self._results = res

    def next_u32(self) -> int:
        if self._index >= self.BUF_WORDS:
            self._generate()
            self._index = 0
        v = self._results[self._index]
        self._index += 1
        return v

    def next_u64(self) -> int:
        idx = self._index
        if idx < self.BUF_WORDS - 1:
            lo = self._results[idx]
            hi = self._results[idx + 1]
            self._index = idx + 2
        elif idx >= self.BUF_WORDS:
            self._generate()
            lo, hi = self._results[0], self._results[1]
            self._index = 2
        else:  # idx == BUF_WORDS - 1: low word from this block run, high from next
            lo = self._results[idx]
            self._generate()
            hi = self._results[0]
            self._index = 1
        return (hi << 32) | lo

    # -- rand::Rng::gen::<T>() equivalents ---------------------------------

    def gen_u64(self) -> int:
        return self.next_u64()

    def gen_u32(self) -> int:
        return self.next_u32()

    def ark_fr_rand(self) -> int:
        """ark-ff `F::rand`: sample 4 u64 limbs (low first) as the Montgomery
        representation, mask to 255 bits, reject >= p; canonical value is
        limbs * R^{-1} mod p."""
        while True:
            limbs = [self.next_u64() for _ in range(4)]
            limbs[3] &= (1 << 63) - 1  # shave to MODULUS_BIT_SIZE = 255
            v = sum(l << (64 * i) for i, l in enumerate(limbs))
            if v < field.P:
                return field.from_montgomery_limbs(v)

    def ark_fr_rand_batch(self, n: int) -> list:
        """n sequential `ark_fr_rand()` draws with the keystream generated
        by the vectorized ChaCha12 (same values, same final RNG state);
        an odd entry index, where a u64 straddles two words' blocks, takes
        the scalar loop."""
        if self._index % 2:
            return [self.ark_fr_rand() for _ in range(n)]
        return [field.from_montgomery_limbs(
                    a | b << 64 | c << 128 | d << 192)
                for a, b, c, d in self.ark_fr_rand_mont_limbs(n).tolist()]

    def ark_fr_rand_mont_limbs(self, n: int):
        """n sequential `ark_fr_rand()` draws in Montgomery form, as
        [n, 4] uint64 limbs (low first), leaving the generator where the
        scalar loop would.

        `F::rand` takes the drawn limbs, top bit cleared, AS the Montgomery
        representation and the radix is 2^256, so the Montgomery form of a
        value is its accepted draw: no field arithmetic.  A draw is 4
        aligned u64s (8 words): the rest of the results buffer, then
        chunks of whole 4-block buffers, are read as `next_u64` reads them
        from an even entry index; an odd one raises ValueError."""
        import numpy as np

        if self._index % 2:
            raise ValueError("ark_fr_rand_mont_limbs needs an even entry "
                             "index")
        out = np.empty((n, 4), dtype=np.uint64)
        plimbs = np.array([(field.P >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                           for i in range(4)], dtype=np.uint64)
        key = np.asarray(self._key, np.uint32)
        lead = np.asarray(self._results[self._index:], dtype=np.uint32)
        c0 = self._counter
        carry = lead
        got, used, gen = 0, 0, 0  # draws kept, words read, blocks made
        while got < n:
            # 2 draws a block, ~9 % rejected; whole 4-block buffers
            nb = min(_DRAW_CHUNK_BLOCKS, ((n - got) * 5 // 8 + 8) // 4 * 4)
            blocks = _chacha_blocks_np(
                np.tile(key, (nb, 1)),
                np.arange(c0 + gen, c0 + gen + nb, dtype=np.uint64),
                self.ROUNDS)
            stream = np.concatenate([carry, blocks.reshape(-1)])
            take = len(stream) // 8
            w = stream[:8 * take].reshape(take, 8).astype(np.uint64)
            u = w[:, 0::2] | (w[:, 1::2] << np.uint64(32))
            u[:, 3] &= np.uint64((1 << 63) - 1)
            # accept iff u < p, limbs compared from the top
            lt = np.zeros(take, dtype=bool)
            decided = np.zeros(take, dtype=bool)
            for j in (3, 2, 1, 0):
                lt |= ~decided & (u[:, j] < plimbs[j])
                decided |= u[:, j] != plimbs[j]
            acc = np.flatnonzero(lt)[:n - got]
            out[got:got + len(acc)] = u[acc]
            got += len(acc)
            if got < n:
                used += 8 * take
                carry = stream[8 * take:]
                gen += nb
                continue
            used += 8 * (int(acc[-1]) + 1)
            # BlockRng's state at word `used` of (lead ++ generated)
            if used <= len(lead):
                self._index += used
                break
            full, rem = divmod(used - len(lead), self.BUF_WORDS)
            if rem:  # that buffer ends inside this chunk
                first = 4 * full - gen
                self._results = [int(x) for x in
                                 blocks[first:first + 4].reshape(-1)]
                self._counter = c0 + 4 * (full + 1)
                self._index = rem
            else:
                self._results = []
                self._counter = c0 + 4 * full
                self._index = self.BUF_WORDS
        return out
