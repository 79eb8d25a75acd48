"""Pallas-curve scalar field Fr: the golden (pure Python int) spec.

The reference operates everywhere on `ark_pallas::Fr`, re-exported as `F`
(`the Rust reference, crates/field/src/lib.rs:13`).  This module is the
bit-exactness oracle for the device kernels: field elements are canonical
Python ints in [0, P).

Covers:
  - modulus / generator / two-adic root-of-unity constants,
  - `get_root_of_unity(n)` semantics of ark-ff (field/src/lib.rs:46),
  - radix-2 `Domain` with power tables (field/src/lib.rs:29-133),
  - canonical 32-byte little-endian (de)serialization, matching
    ark-serialize compressed/uncompressed mode for a 255-bit field
    (field/src/lib.rs:206-215),
  - wide-reduction hash-to-field helpers (utils/src/lib.rs:7-39),
  - ark-ff Montgomery representation helpers (needed only to reproduce
    `F::rand`, which samples Montgomery limbs directly).
"""

from __future__ import annotations

from .blake3 import blake3_digest

# Pallas scalar field (== Vesta base field) modulus, 255 bits.
P = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

GENERATOR = 5
TWO_ADICITY = 32
# g^((p-1) / 2^32): generator of the maximal power-of-two subgroup.
TWO_ADIC_ROOT_OF_UNITY = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)

# ark-ff internal Montgomery radix for 4x64-bit limbs.
R_MONT = (1 << 256) % P
R2_MONT = (R_MONT * R_MONT) % P
R_MONT_INV = pow(R_MONT, P - 2, P)


def get_root_of_unity(n: int) -> int:
    """Primitive n-th root of unity for power-of-two n <= 2^32.

    Mirrors ark-ff `FftField::get_root_of_unity` as used at
    field/src/lib.rs:46: omega = TWO_ADIC_ROOT ^ (2^TWO_ADICITY / n).
    """
    assert n > 0 and (n & (n - 1)) == 0, "n must be a power of two"
    log_n = n.bit_length() - 1
    assert log_n <= TWO_ADICITY
    return pow(TWO_ADIC_ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), P)


def inv(x: int) -> int:
    assert x % P != 0, "inverse of zero"
    return pow(x, P - 2, P)


def compute_powers(base: int, n: int) -> list:
    """[1, base, base^2, ..., base^{n-1}] (field/src/lib.rs:125-133)."""
    out = []
    cur = 1
    for _ in range(n):
        out.append(cur)
        cur = cur * base % P
    return out


class Domain:
    """Multiplicative subgroup H of size n = 2^log_n (field/src/lib.rs:29)."""

    def __init__(self, log_n: int):
        self.log_n = log_n
        self.size = 1 << log_n
        self.omega = get_root_of_unity(self.size)
        self.elements: list = []

    def precompute_elements(self) -> None:
        self.elements = compute_powers(self.omega, self.size)

    def element(self, k: int) -> int:
        if k < len(self.elements):
            return self.elements[k]
        return pow(self.omega, k, P)

    def __iter__(self):
        cur = 1
        for _ in range(self.size):
            yield cur
            cur = cur * self.omega % P


def make_domain_2048():
    """(omega, 2048) with exact-order checks (field/src/lib.rs:146-178)."""
    n = 2048
    omega = get_root_of_unity(n)
    assert pow(omega, n, P) == 1
    assert pow(omega, n // 2, P) != 1
    return omega, n


# ---------------------------------------------------------------------------
# Serialization (ark-serialize canonical: 32 bytes little-endian).
# ---------------------------------------------------------------------------

def fr_to_bytes(x: int) -> bytes:
    """Canonical compressed == uncompressed bytes for a 255-bit field."""
    return (x % P).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    assert len(b) == 32
    v = int.from_bytes(b, "little")
    if v >= P:
        raise ValueError("non-canonical field bytes")
    return v


def fr_from_le_bytes_mod_order(b: bytes) -> int:
    """Interpret bytes as little-endian integer, reduce mod P."""
    return int.from_bytes(b, "little") % P


# ---------------------------------------------------------------------------
# Hash-to-field helpers (utils/src/lib.rs).
# ---------------------------------------------------------------------------

def fr_from_le_bytes_mod_p(b: bytes) -> int:
    """512-bit zero-padded wide reduction (utils/src/lib.rs:7-13)."""
    wide = (b[:64] + b"\x00" * 64)[:64]
    return int.from_bytes(wide, "little") % P


def fr_from_hash(tag: str, data: bytes) -> int:
    """BLAKE3(tag || data) -> Fr (utils/src/lib.rs:16-22)."""
    return fr_from_le_bytes_mod_p(blake3_digest(tag.encode() + data))


def salt_for_node(level: int, node_idx: int, seed: bytes) -> int:
    """utils/src/lib.rs:26-34 (unused by the live proving path)."""
    assert len(seed) == 32
    data = (b"MT-SALT" + level.to_bytes(8, "little")
            + node_idx.to_bytes(8, "little") + seed)
    return fr_from_le_bytes_mod_p(blake3_digest(data))


def ds_tag_for_arity(arity: int) -> int:
    """utils/src/lib.rs:37-39 (unused by the live proving path)."""
    return fr_from_hash("MT-DS", f"arity-{arity}".encode())


# ---------------------------------------------------------------------------
# ark-ff Montgomery-representation helpers (for F::rand reproduction only).
# ---------------------------------------------------------------------------

def from_montgomery_limbs(limbs_int: int) -> int:
    """Canonical value of an element whose ark-internal (Montgomery 2^256)
    representation equals `limbs_int`."""
    return limbs_int * R_MONT_INV % P


def fr_tag_to_u64(x: int) -> int:
    """Low 64 bits of the canonical bigint (channel/src/lib.rs:120-124)."""
    return x & 0xFFFFFFFFFFFFFFFF
