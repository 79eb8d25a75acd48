"""Pure-Python BLAKE3 (unkeyed hash mode), for the Poseidon parameter
derivation of the reference (BLAKE3 hash-to-field of every constant).
Inputs on that path are under 1 KiB, but the chunk/parent tree is whole,
so the function is right for any length.
"""

from __future__ import annotations

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024

_MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(state: list, a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 7)


def _compress(cv, block_words, counter: int, block_len: int, flags: int):
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for _ in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    out = [0] * 16
    for i in range(8):
        out[i] = state[i] ^ state[i + 8]
        out[i + 8] = state[i + 8] ^ cv[i]
    return out


def _words_from_block(block: bytes):
    block = block + b"\x00" * (BLOCK_LEN - len(block))
    return [int.from_bytes(block[4 * i:4 * i + 4], "little") for i in range(16)]


def _chunk_cv(chunk: bytes, chunk_counter: int, is_root: bool):
    """Compress one chunk (<= 1024 bytes) down to an 8-word CV.

    When `is_root`, returns the full 16-word output of the final (ROOT)
    compression instead.
    """
    blocks = [chunk[i:i + BLOCK_LEN] for i in range(0, len(chunk), BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    cv = list(IV)
    n = len(blocks)
    for i, blk in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == n - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        out = _compress(cv, _words_from_block(blk), chunk_counter, len(blk), flags)
        if i == n - 1 and is_root:
            return out
        cv = out[:8]
    return cv


def _left_len(total_chunks: int) -> int:
    """Largest power of two strictly less than total_chunks."""
    p = 1
    while p * 2 < total_chunks:
        p *= 2
    return p


def _subtree_cv(data: bytes, chunk_start: int, is_root: bool):
    n_chunks = (len(data) + CHUNK_LEN - 1) // CHUNK_LEN
    if n_chunks <= 1:
        return _chunk_cv(data, chunk_start, is_root)
    left_chunks = _left_len(n_chunks)
    split = left_chunks * CHUNK_LEN
    left = _subtree_cv(data[:split], chunk_start, False)
    right = _subtree_cv(data[split:], chunk_start + left_chunks, False)
    flags = PARENT | (ROOT if is_root else 0)
    out = _compress(IV, list(left) + list(right), 0, BLOCK_LEN, flags)
    return out if is_root else out[:8]


def blake3_digest(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 hash of `data` (unkeyed), first `out_len` bytes (<= 64)."""
    assert out_len <= 64, "extended XOF output not needed / implemented"
    words = _subtree_cv(data, 0, True)
    raw = b"".join(w.to_bytes(4, "little") for w in words)
    return raw[:out_len]
