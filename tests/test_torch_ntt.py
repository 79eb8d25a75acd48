"""Port NTT / iNTT / LDE / Poly (stark_mlwe_tpu_torch.ops.ntt, .poly) vs the
JAX package.

Same inputs (numpy seed) through `stark_mlwe_tpu.ops.ntt`
and `stark_mlwe_tpu.poly`, and through their counterparts; tolerance: exact
(integer field arithmetic, tolerance 0).  On the CPU the port's tile wrapper
takes the kernel's plain version, so the four-step recursion over views is
what runs here.  The tile transform itself, the Pallas kernel in interpret
mode and the kernel source's host replay are in test_torch_ntt_tiles.py.
"""

import hashlib
import json
import os

import pytest
import torch

import jax.numpy as jnp

from stark_mlwe_tpu.ops import ntt as jntt
from stark_mlwe_tpu.poly import Poly as JPoly
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import ntt as tntt
from stark_mlwe_tpu_torch.poly import Poly
from stark_mlwe_tpu_torch.spec.field import P, get_root_of_unity

from torch_port_util import (jax_limbs, port_tensor, rand_ints, same,
                             seeded_elems as elems)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def naive_ntt(coeffs, n, inverse=False):
    w = get_root_of_unity(n)
    if inverse:
        w = pow(w, P - 2, P)
    out = [sum(c * pow(w, i * j, P) for i, c in enumerate(coeffs)) % P
           for j in range(n)]
    if inverse:
        n_inv = pow(n, P - 2, P)
        out = [v * n_inv % P for v in out]
    return out


@pytest.mark.parametrize("n", [2, 8, 64, 256])
def test_ntt_matches_jax_and_naive(n):
    c = rand_ints(100 + n, n)
    x = port_tensor(c, mont=True)
    got = tntt.ntt(x)
    assert same(got, jntt.ntt(jnp.asarray(jax_limbs(c, mont=True))))
    assert tfr.unpack_ints(got, mont=True) == naive_ntt(c, n)
    # a tile of 2 or 4 forces the recursion at every size; same bytes
    assert torch.equal(tntt.ntt(x, tile_max=4), got)
    assert torch.equal(tntt.ntt_plain(x), got)
    back = tntt.intt(got)
    assert torch.equal(back, x)
    assert torch.equal(tntt.intt(got, tile_max=2), x)


@pytest.mark.parametrize("n", [8, 256])
def test_intt_matches_jax_and_naive(n):
    c = rand_ints(200 + n, n)
    got = tntt.intt(port_tensor(c, mont=True))
    assert same(got, jntt.intt(jnp.asarray(jax_limbs(c, mont=True))))
    assert tfr.unpack_ints(got, mont=True) == naive_ntt(c, n, inverse=True)
    assert torch.equal(tntt.ntt_plain(port_tensor(c, mont=True), True), got)


# Sizes are chosen so that every JAX transform below is one the tests above
# have already compiled in this process (forward 8, 64, 256; inverse 8, 256).
@pytest.mark.parametrize("n,blowup,coset", [(8, 8, None), (8, 32, 5)])
def test_lde_matches_jax(n, blowup, coset):
    vals = rand_ints(400 + n, n)
    got = tntt.lde(port_tensor(vals, mont=True), blowup, coset_shift=coset)
    want = jntt.lde(jnp.asarray(jax_limbs(vals, mont=True)), blowup,
                    coset_shift=coset)
    assert same(got, want)
    if coset is None:
        assert tfr.unpack_ints(got, mont=True)[::blowup] == vals
    # the interpolant, evaluated on the (coset of the) big domain
    coeffs = naive_ntt(vals, n, inverse=True)
    g = 1 if coset is None else coset
    shifted = [c * pow(g, i, P) % P for i, c in enumerate(coeffs)]
    assert tfr.unpack_ints(got, mont=True) == naive_ntt(
        shifted + [0] * (n * (blowup - 1)), n * blowup)


def test_four_step_matches_jax_and_flat():
    n1, n2 = 16, 8
    c = rand_ints(500, n1 * n2)
    x = port_tensor(c, mont=True)
    got = tntt.ntt_four_step(x, n1, n2)
    want = jntt.ntt_four_step(jnp.asarray(jax_limbs(c, mont=True)), n1, n2)
    assert same(got, want)
    assert torch.equal(got, tntt.ntt(x))


def test_split_and_launch_count():
    assert tntt._split(1 << 22, tntt.TILE_MAX) == (2048, 2048)
    assert tntt._split(1 << 12, 16) == (16, 256)
    assert tntt._split(1 << 13, tntt.TILE_MAX) == (128, 64)
    assert tntt._split(1 << 23, tntt.TILE_MAX) == (2048, 4096)
    assert tntt.TILE_MAX <= tntt.TILE_CAP


def test_poly_matches_jax_package():
    a = rand_ints(600, 70)
    b = rand_ints(601, 80)
    x = rand_ints(602, 1)[0]
    pa, pb, ja, jb = Poly(a), Poly(b), JPoly(a), JPoly(b)
    # above 64 coefficients: through the NTT (size 256) in both packages
    prod = pa.mul(pb, device="cpu")
    assert prod.coeffs == ja.mul(jb).coeffs
    assert prod.evaluate(x) == pa.evaluate(x) * pb.evaluate(x) % P
    assert prod.degree() == 148
    # below: schoolbook
    small = Poly(a[:3]).mul(Poly(b[:4]), device="cpu")
    assert small.coeffs == JPoly(a[:3]).mul(JPoly(b[:4])).coeffs
    assert pa.evaluate(x) == ja.evaluate(x)
    assert pa.add(pb).coeffs == ja.add(jb).coeffs
    assert pa.scale(9).coeffs == ja.scale(9).coeffs
    assert Poly([0, 0]).is_zero() and Poly([]).mul(pa, device="cpu").is_zero()
    assert Poly.from_coeffs(a + [0, P]) == pa


def test_entry_points_edge_cases_and_rejections():
    one = port_tensor([7], mont=True)
    assert tntt.ntt(one) is one and tntt.ntt_plain(one) is one
    x = elems(800, 12)
    with pytest.raises(ValueError):
        tntt.ntt(x)                                 # not a power of two
    with pytest.raises(ValueError):
        tntt.ntt(x[:8], tile_max=3)
    with pytest.raises(ValueError):
        tntt.lde(x[:8], 3)
    with pytest.raises(ValueError):
        tntt.ntt_four_step(x, 4, 2)
    with pytest.raises(TypeError):
        tntt.ntt(x[:8].to(torch.int64))
    with pytest.raises(TypeError):
        tntt.ntt_tiles(x[:8], tntt.stage_twiddles(8, False, "cpu"))
    x8 = x[:8].unsqueeze(0)
    with pytest.raises(ValueError):                 # wrong twiddle table
        tntt.ntt_tiles(x8, tntt.stage_twiddles(4, False, "cpu"))
    with pytest.raises(ValueError):                 # epilogue of wrong period
        tntt.ntt_tiles(x8, tntt.stage_twiddles(8, False, "cpu"),
                       elems(801, 2, 8))
    with pytest.raises(ValueError):                 # limbs not whole
        bad = torch.zeros((1, 8, 16), dtype=torch.int32)[:, :, ::2]
        tntt.ntt_tiles(bad, tntt.stage_twiddles(8, False, "cpu"))
    with pytest.raises(ValueError):
        tntt.ntt_tiles(elems(802, 1, 8192),
                       tntt.stage_twiddles(8192, False, "cpu"))


def test_no_card_means_raise_not_cpu():
    """The new entry points follow the device rule: tensors decide for the
    transforms, `device=None` on `Poly.mul` means the card."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    a, b = Poly(rand_ints(900, 40)), Poly(rand_ints(901, 40))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a.mul(b)
    assert a.mul(b, device="cpu").degree() == 78
    assert Poly([1, 2]).mul(Poly([3])).coeffs == [3, 6]   # no device needed


@pytest.mark.parametrize("name", ["lde_2e14_b4", "lde_2e12_b2_coset5"])
def test_golden_ntt_digests(name):
    """The JAX package's recorded digests (tests/data/torch_golden.json,
    written by scripts/make_torch_golden.py) through the port on the CPU;
    the 2^16 entries are held on the card by chip_smoke.py."""
    with open(os.path.join(ROOT, "tests", "data", "torch_golden.json")) as f:
        ent = {e["name"]: e for e in json.load(f)["ntt_entries"]}[name]
    x = tfr.to_device(tfr.seeded_limbs(ent["seed"], ent["n"]), "cpu")
    y = tntt.lde(x, ent["blowup"], ent.get("coset_shift"))
    digest = hashlib.sha256(
        tfr.from_mont(y).contiguous().numpy().tobytes()).hexdigest()
    assert digest == ent["sha256"]
