"""Vector-commitment abstraction (the Rust reference's crates/commitment).

Counterpart of `commitment.py` of the JAX package: the `CommitmentScheme`
trait (commitment/src/lib.rs:13-27) and the arity-16 `MerkleCommitment`
binding (:60-114).  The device implementation lives in
`channel.DeviceMerkleCommitment`; this module gives the trait-level
surface so schemes are swappable.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from .channel import DeviceMerkleCommitment
from .spec.channel import COMMIT_ARITY


class CommitmentScheme(ABC):
    """commit/open/verify over a committed vector of field elements."""

    @abstractmethod
    def commit(self, leaves):
        """-> (root digest, aux/tree handle)."""

    @abstractmethod
    def open(self, indices, aux):
        """-> opening proof for the given leaf indices."""

    @abstractmethod
    def verify(self, root, indices, values, proof) -> bool:
        """Check an opening against the root."""


class MerkleCommitment(DeviceMerkleCommitment, CommitmentScheme):
    """Arity-16 DS-aware Poseidon Merkle commitment, device-backed."""


__all__ = ["CommitmentScheme", "MerkleCommitment", "COMMIT_ARITY"]
