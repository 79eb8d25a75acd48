"""The port's sharding (`distributed`, `parallel`) at 1, 2 and 4 gloo ranks.

Every rank is its own process (tests/torch_parallel_ranks.py, torch and
the port only); the three worlds are started once for this file and run
beside the JAX side.  Each rank runs the sharded prove step (n = 64*D,
m = arity = 4), the sharded NTT at (D, n1, n2) = (1,16,16), (2,16,16),
(4,16,16), (4,64,64), and the checks of scripts/distributed_smoke.py, and
returns its limbs.  The step is held to the port's single-device path
(`merge_evals_device`, `fold_layer_dev`, `build_tree`) and to the JAX
package's pure-int spec (`lagrange_eval_on_h`), the NTT to `ntt` and
`ntt_four_step`; at 2 ranks both are held to the JAX package's
`build_sharded_prove_step` and `build_ntt_sharded` on 2 of the 8 virtual
CPU devices.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from stark_mlwe_tpu import parallel as jpar
from stark_mlwe_tpu.ops import fr as jfr
from stark_mlwe_tpu.spec.deep_ali import lagrange_eval_on_h

from stark_mlwe_tpu_torch import parallel as tpar
from stark_mlwe_tpu_torch.distributed import initialize_distributed
from stark_mlwe_tpu_torch.fri import deep_ali as tdali
from stark_mlwe_tpu_torch.fri import fold_layer_dev, fs as tfs, s_layer_dev
from stark_mlwe_tpu_torch.merkle import build_tree
from stark_mlwe_tpu_torch.ops import fr
from stark_mlwe_tpu_torch.ops import ntt as tntt
from stark_mlwe_tpu_torch.spec.field import P, get_root_of_unity
from stark_mlwe_tpu_torch.spec.merkle import MerkleChannelCfg
from stark_mlwe_tpu_torch.spec.transcript import Transcript

import torch_parallel_ranks as tpr
from torch_port_util import jax_limbs

WORLDS = (1, 2, 4)
NTT_CASES = [(D, n1, n2) for D in WORLDS for n1, n2 in tpr.NTT_CASES[D]]
M = tpr.STEP_M


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("parallel_ranks")
    started = {D: tpr.World("parallel", D, str(base / f"world{D}"))
               for D in WORLDS}
    yield started
    for w in started.values():
        w.close()


def step_scalars(n):
    omega = get_root_of_unity(n)
    zh = (pow(tpr.STEP_Z, n, P) - 1) % P
    return omega, zh * pow(n % P, P - 2, P) % P


def gathered(worlds, D, case, key):
    """A case's per-rank rows, concatenated in rank order."""
    out = []
    for res in worlds[D].results():
        out += res[case][key]
    return out


def test_step_equals_jax_sharded_step_on_two_devices(worlds):
    """Started first, so the ranks run while the JAX side compiles."""
    D = 2
    n = tpr.STEP_N_PER_RANK * D
    a, s, e, t = tpr.step_inputs(D)
    omega, scale = step_scalars(n)
    mesh = jpar.make_mesh(D)
    step, ds_locals, _ = jpar.build_sharded_prove_step(mesh, n, M, M)
    fold_A = jnp.asarray(jfr.mat_scale([[pow(tpr.STEP_Z_FOLD, j, P)
                                         for j in range(M)]]))
    cols = [jnp.asarray(jax_limbs(c, mont=True)) for c in (a, s, e, t)]
    w = jfr.powers(jnp.asarray(jfr.pack_int(omega, mont=True)), n)
    root, phi_z, f1 = step(*cols, w,
                           jnp.asarray(jfr.pack_int(tpr.STEP_Z, mont=True)),
                           jnp.asarray(jfr.pack_int(scale, mont=True)),
                           fold_A, *ds_locals)
    res = worlds[D].results()
    for r in res:
        assert r["step"]["root"] == jfr.unpack_ints(
            jfr.from_mont(root[None, :]))[0]
        assert r["step"]["phi_z"] == jfr.unpack_ints(phi_z[None, :],
                                                     mont=True)[0]
    assert gathered(worlds, D, "step", "f1") == jfr.unpack_ints(f1,
                                                                mont=True)


def test_ntt_equals_jax_sharded_ntt_on_two_devices(worlds):
    D, n1, n2 = 2, 16, 16
    mesh = jpar.make_mesh(D)
    fn, tw = jpar.build_ntt_sharded(mesh, n1, n2)
    x = tpr.ntt_input(n1, n2)
    want = jfr.unpack_ints(fn(jnp.asarray(jax_limbs(fr.unpack_ints(x))),
                              jnp.asarray(tw)))
    got = np.array(gathered(worlds, D, f"ntt_{n1}x{n2}", "limbs"),
                   dtype=np.int32).reshape(-1, 8)
    assert fr.unpack_ints(got) == want


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_step_equals_single_device(worlds, D):
    n = tpr.STEP_N_PER_RANK * D
    a, s, e, t = tpr.step_inputs(D)
    omega, _ = step_scalars(n)
    cols = [fr.to_device(fr.pack_ints(c, mont=True), "cpu")
            for c in (a, s, e, t)]
    f0, _, _ = tdali.merge_evals_device(*cols, omega, tpr.STEP_Z)
    f1 = fold_layer_dev(f0, tpr.STEP_Z_FOLD, M)
    leaves = tfs.hash_leaf_pairs_dev(f0, s_layer_dev(f0, f1, M))
    root = build_tree(leaves, MerkleChannelCfg.new(M, tree_label=0)).root()
    phi = [(a[i] * s[i] + e[i] - t[i]) % P for i in range(n)]
    res = worlds[D].results()
    for r in res:
        assert r["step"]["root"] == root
        assert r["step"]["phi_z"] == lagrange_eval_on_h(phi, tpr.STEP_Z,
                                                        omega)
        # the D partial sums and the frontier: two all-gathers at any D
        assert r["step"]["collectives"] == {"all_gather": 2,
                                            "all_to_all": 0,
                                            "all_reduce": 0}
    assert gathered(worlds, D, "step", "f1") == fr.unpack_ints(f1,
                                                               mont=True)


@pytest.mark.parametrize("D,n1,n2", NTT_CASES)
def test_sharded_ntt_equals_ntt_and_four_step(worlds, D, n1, n2):
    x = fr.to_device(tpr.ntt_input(n1, n2), "cpu")
    got = torch.tensor(gathered(worlds, D, f"ntt_{n1}x{n2}", "limbs"),
                       dtype=torch.int32).reshape(-1, 8)
    assert torch.equal(got, tntt.ntt(x))
    assert torch.equal(got, tntt.ntt_four_step(x, n1, n2))
    for r in worlds[D].results():
        assert r[f"ntt_{n1}x{n2}"]["collectives"] == {
            "all_gather": 0, "all_to_all": 3, "all_reduce": 0}


@pytest.mark.parametrize("D", WORLDS)
def test_ranks_agree_on_the_fs_challenge(worlds, D):
    """scripts/distributed_smoke.py: every rank replays the same
    transcript and derives the same challenge (checked through an
    all-gather), and a collective sums one a rank to D."""
    tr = Transcript(b"DIST/SMOKE")
    tr.absorb_bytes(b"witness-bytes")
    ch = tr.challenge(b"c") % (1 << 31)
    for r in worlds[D].results():
        assert r["smoke"]["challenge"] == ch
        assert r["smoke"]["gathered"] == [ch] * D
        assert r["smoke"]["sum"] == D


@pytest.mark.parametrize("n,arity,D", [
    (64, 4, 1), (128, 4, 2), (256, 4, 4), (1 << 12, 16, 8), (128, 16, 2),
    (128, 16, 4), (64, 8, 2), (16, 4, 4), (8, 2, 4), (2, 2, 2),
    (1 << 16, 16, 4), (96, 4, 3)])
def test_tree_level_plan_equals_jax(n, arity, D):
    assert tpar._tree_level_plan(n, arity, D) == \
        jpar._tree_level_plan(n, arity, D)


def test_distributed_module_imports_nothing_heavy():
    """A launcher imports `distributed` first: it must not import torch."""
    import subprocess
    import sys

    code = ("import sys, stark_mlwe_tpu_torch.distributed\n"
            "assert 'torch' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tpr.ROOT,
                         env={"PYTHONPATH": tpr.ROOT, "PATH": ""},
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr


def test_make_mesh_raises_without_a_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tpar.make_mesh(device="cpu")


def test_initialize_distributed_raises_without_a_card():
    """`device=None` is NCCL on the card; with no card it raises and sets
    up nothing (no fallback to gloo)."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed()
    assert not dist.is_initialized()


def test_one_rank_group_on_the_cpu():
    """One process needs no address: a one-rank gloo group; the mesh's
    collectives run and are counted, and gloo is refused for CUDA
    tensors."""
    import torch.distributed as dist

    assert initialize_distributed(device="cpu") == torch.device("cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="does not serve cuda"):
            tpar.make_mesh(device="cuda")
        with pytest.raises(ValueError, match="2 devices"):
            tpar.make_mesh(2, device="cpu")
        mesh = tpar.make_mesh(device="cpu")
        x = torch.arange(16, dtype=torch.int32).reshape(1, 2, 8)
        assert torch.equal(mesh.all_gather(x), x)
        assert torch.equal(mesh.all_to_all(x), x)
        assert torch.equal(mesh.all_reduce_sum(x.clone()), x)
        assert mesh.collectives == {"all_gather": 1, "all_to_all": 1,
                                    "all_reduce": 1}
    finally:
        dist.destroy_process_group()
