"""The Pallas scalar field Fr as Python ints in [0, P).

The reference's own statement of the field that both proof systems work
in: the modulus, the two-adic roots of unity (ark-ff's
`get_root_of_unity`), canonical 32-byte little-endian encoding, BLAKE3
hash-to-field (for the Poseidon constants), and the Montgomery radix the
witness limbs are read in.
"""

from __future__ import annotations

from .blake3 import blake3_digest

P = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

GENERATOR = 5
TWO_ADICITY = 32
TWO_ADIC_ROOT_OF_UNITY = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)

R_MONT = (1 << 256) % P                # Montgomery radix 2^256
R_MONT_INV = pow(R_MONT, P - 2, P)


def get_root_of_unity(n: int) -> int:
    """Primitive n-th root of unity, n a power of two up to 2^32."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"not a power of two: {n}")
    log_n = n.bit_length() - 1
    if log_n > TWO_ADICITY:
        raise ValueError(f"no root of unity of order 2^{log_n}")
    return pow(TWO_ADIC_ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), P)


def inv(x: int) -> int:
    if x % P == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(x, P - 2, P)


def fr_to_bytes(x: int) -> bytes:
    return (x % P).to_bytes(32, "little")


def fr_from_hash(tag: str, data: bytes) -> int:
    """BLAKE3(tag || data), zero-padded to 64 bytes, reduced mod P."""
    digest = blake3_digest(tag.encode() + data)
    return int.from_bytes((digest + b"\x00" * 64)[:64], "little") % P


def from_mont(limbs_int: int) -> int:
    """The field value whose Montgomery (2^256) representation is
    `limbs_int`."""
    return limbs_int * R_MONT_INV % P


def mont_rows_to_ints(u64_rows) -> list:
    """Field values of an [n, 4] uint64 array of Montgomery limbs (low
    limb first)."""
    return [from_mont(a | b << 64 | c << 128 | d << 192)
            for a, b, c, d in u64_rows.tolist()]
