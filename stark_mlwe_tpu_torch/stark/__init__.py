"""End-to-end MLWE STARK: witness generation, prove/verify, wire format.

Counterpart of `stark/__init__.py` of the JAX package: the application
layer over DEEP-ALI + m-ary FRI on the MLWE relation a*s + e = t over H.

  - `MlweWitness.random` draws a,s,e via StdRng/F::rand and sets
    t = a*s + e pointwise on H (a *satisfying* instance);
    `MlweWitness.random_unstructured` draws all four columns,
  - `prove` / `verify` wrap the device DEEP-ALI+FRI pipeline; both take
    `device=None`, which means the CUDA device and raises where there is
    none (pass `device="cpu"` for the plain PyTorch versions),
  - `serialize_proof` / `deserialize_proof` give the canonical byte wire
    format for DeepFriProof (32-byte LE field encoding and u64-LE
    indices), byte-equal to the JAX package's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..device import resolve
from ..fri import DeviceDeepAliRealBuilder, deep_fri_prove, deep_fri_verify
from ..ops import fr
from ..spec.field import P, fr_from_bytes, fr_to_bytes
from ..spec.fri import (DeepFriParams, DeepFriProof, FriLayerBatches,
                        FriQueryPayload, LayerBatchProof, LayerOpenPayload,
                        LayerQueryRef, MerkleProof,
                        deep_fri_proof_size_bytes)
from ..spec.rng import StdRng


@dataclass
class MlweWitness:
    a: list
    s: list
    e: list
    t: list

    @classmethod
    def random(cls, k: int, seed: int) -> "MlweWitness":
        """Satisfying instance: t = a*s + e on H."""
        n0 = 1 << k
        rng = StdRng.seed_from_u64(seed)
        # the batched draw gives the same values as n0 scalar draws each
        a = rng.ark_fr_rand_batch(n0)
        s = rng.ark_fr_rand_batch(n0)
        e = rng.ark_fr_rand_batch(n0)
        t = [(a[i] * s[i] + e[i]) % P for i in range(n0)]
        return cls(a, s, e, t)

    @classmethod
    def random_unstructured(cls, k: int, seed: int) -> "MlweWitness":
        """All four columns random (the reference bench's inputs,
        end_to_end.rs:249-253)."""
        n0 = 1 << k
        rng = StdRng.seed_from_u64(seed)
        cols = [rng.ark_fr_rand_batch(n0) for _ in range(4)]
        return cls(*cols)

    def to_device(self, device=None):
        dev = resolve(device)
        return tuple(fr.to_device(c, dev) for c in self.to_host_limbs())

    def to_host_limbs(self):
        """Numpy Montgomery limb columns ([n, 8] int32): device-uploadable
        AND, as the same bytes, directly consumable by the native FS absorb
        chains."""
        return tuple(fr.pack_ints(c, mont=True)
                     for c in (self.a, self.s, self.e, self.t))


def prove(witness: MlweWitness, params: DeepFriParams,
          blinding_r=None, device=None) -> DeepFriProof:
    dev = resolve(device)
    builder = DeviceDeepAliRealBuilder(
        r_eval_opt=blinding_r, use_blinding=blinding_r is not None)
    a, s, e, t = witness.to_host_limbs()
    n0 = len(witness.a)
    return deep_fri_prove(builder, a, s, e, t, n0, params, device=dev)


def verify(params: DeepFriParams, proof: DeepFriProof, device=None) -> bool:
    return deep_fri_verify(params, proof, device=resolve(device))


# ---------------------------------------------------------------------------
# Canonical wire format for DeepFriProof.
# ---------------------------------------------------------------------------

def _w_u64(out, v):
    out.append(struct.pack("<Q", v))


def _w_fr(out, v):
    out.append(fr_to_bytes(v))


def _w_vec(out, xs, wfn):
    _w_u64(out, len(xs))
    for x in xs:
        wfn(out, x)


def _w_merkle_proof(out, mp: MerkleProof):
    _w_u64(out, mp.arity)
    _w_vec(out, mp.indices, _w_u64)
    _w_u64(out, len(mp.siblings))
    for lvl in mp.siblings:
        _w_vec(out, lvl, _w_fr)
    _w_u64(out, len(mp.group_sizes))
    for lvl in mp.group_sizes:
        _w_vec(out, lvl, _w_u64)


def serialize_proof(p: DeepFriProof) -> bytes:
    out = []
    _w_u64(out, p.n0)
    _w_fr(out, p.omega0)
    _w_vec(out, p.roots, _w_fr)
    _w_u64(out, len(p.layer_batches.layers))
    for lb in p.layer_batches.layers:
        _w_u64(out, 1 if lb.hashed_leaves else 0)
        _w_vec(out, lb.child_indices, _w_u64)
        _w_merkle_proof(out, lb.child_proof)
        _w_vec(out, lb.parent_indices, _w_u64)
        _w_merkle_proof(out, lb.parent_proof)
    _w_merkle_proof(out, p.layer_batches.final_proof)
    _w_u64(out, len(p.queries))
    for q in p.queries:
        _w_u64(out, len(q.per_layer_refs))
        for r in q.per_layer_refs:
            for v in (r.i, r.child_pos, r.parent_index, r.parent_pos):
                _w_u64(out, v)
        _w_u64(out, len(q.per_layer_payloads))
        for pay in q.per_layer_payloads:
            for v in (pay.f_i, pay.s_i, pay.f_parent_b, pay.s_parent_b):
                _w_fr(out, v)
        _w_u64(out, q.final_index)
        _w_fr(out, q.final_pair[0])
        _w_fr(out, q.final_pair[1])
    return b"".join(out)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.buf, self.off)[0]
        self.off += 8
        return v

    def fr_(self) -> int:
        v = fr_from_bytes(self.buf[self.off:self.off + 32])
        self.off += 32
        return v

    def vec(self, fn):
        return [fn() for _ in range(self.u64())]


def deserialize_proof(buf: bytes) -> DeepFriProof:
    r = _Reader(buf)
    n0 = r.u64()
    omega0 = r.fr_()
    roots = r.vec(r.fr_)

    def merkle_proof():
        arity = r.u64()
        indices = r.vec(r.u64)
        siblings = [r.vec(r.fr_) for _ in range(r.u64())]
        group_sizes = [r.vec(r.u64) for _ in range(r.u64())]
        return MerkleProof(indices, siblings, group_sizes, arity)

    layers = []
    for _ in range(r.u64()):
        hashed = r.u64() == 1
        child_indices = r.vec(r.u64)
        child_proof = merkle_proof()
        parent_indices = r.vec(r.u64)
        parent_proof = merkle_proof()
        layers.append(LayerBatchProof(hashed, child_indices, child_proof,
                                      parent_indices, parent_proof))
    final_proof = merkle_proof()

    queries = []
    for _ in range(r.u64()):
        refs = [LayerQueryRef(r.u64(), r.u64(), r.u64(), r.u64())
                for _ in range(r.u64())]
        pays = [LayerOpenPayload(r.fr_(), r.fr_(), r.fr_(), r.fr_())
                for _ in range(r.u64())]
        final_index = r.u64()
        final_pair = (r.fr_(), r.fr_())
        queries.append(FriQueryPayload(refs, pays, final_index, final_pair))

    assert r.off == len(buf), "trailing bytes in proof"
    return DeepFriProof(roots, FriLayerBatches(layers, final_proof),
                        queries, n0, omega0)


__all__ = ["MlweWitness", "prove", "verify", "serialize_proof",
           "deserialize_proof", "DeepFriParams", "DeepFriProof",
           "deep_fri_proof_size_bytes"]
