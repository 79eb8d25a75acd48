"""The port's bench harness (`stark_mlwe_tpu_torch.bench`) against the JAX
package's (`stark_mlwe_tpu.bench`): presets, k windows, the witness seed
chain, the witnesses and their packing, the CSV strings, the drivers'
append re-parse, and one bench proof byte-equal to the JAX spec prover's.
All comparisons are exact."""

import os
import sys

import numpy as np
import pytest
import torch

import stark_mlwe_tpu.bench as jbench
import torch_port_util  # noqa: F401  (one intra-op thread a worker)
from stark_mlwe_tpu.spec import fri as jsfri
from stark_mlwe_tpu.stark import serialize_proof as jax_serialize
from stark_mlwe_tpu_torch import bench as tbench
from stark_mlwe_tpu_torch import convert
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.spec.field import from_montgomery_limbs
from stark_mlwe_tpu_torch.spec.rng import StdRng
from stark_mlwe_tpu_torch.stark import serialize_proof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LABELS = [label for label, _ in jbench.PRESETS]


def test_presets_and_constants_equal():
    assert tbench.PRESETS == jbench.PRESETS
    assert len(tbench.PRESETS) == 13
    assert (tbench.R_QUERIES, tbench.SEED_Z, tbench.K_LO, tbench.K_HI) == (
        jbench.R_QUERIES, jbench.SEED_Z, jbench.K_LO, jbench.K_HI)


@pytest.mark.parametrize("label", LABELS)
def test_k_windows_equal(label):
    schedule = dict(jbench.PRESETS)[label]
    assert (tbench.k_min_for_schedule(schedule)
            == jbench.k_min_for_schedule(schedule))
    for k_hi in (19, 22):
        assert (tbench.ks_for_schedule(schedule, k_hi=k_hi)
                == jbench.ks_for_schedule(schedule, k_hi=k_hi))
    assert tbench.ks_for_schedule(schedule) == jbench.ks_for_schedule(
        schedule)


@pytest.mark.parametrize("label", LABELS)
def test_witness_seed_chain_equal(label):
    """Every (label, k) of the grid, and k = 20-22 outside it."""
    schedule = dict(jbench.PRESETS)[label]
    ks = jbench.ks_for_schedule(schedule) + [20, 21, 22]
    for k in ks:
        assert tbench.witness_seed_for(label, k) == jbench.witness_seed_for(
            label, k), (label, k)
    assert tbench.witness_seed_for(label, 22) == 0x5EED_0000_0000 + 22


@pytest.mark.parametrize("k", [6, 8])
def test_gen_witness_equal(k):
    seed = jbench.witness_seed_for("paper", 11) + k
    assert tbench.gen_witness(k, seed) == jbench.gen_witness(k, seed)


@pytest.mark.parametrize("label,k", [("paper", 6), ("uni128", 8)])
def test_packed_witness_equals_jax_packing(label, k, monkeypatch):
    monkeypatch.delenv("BENCH_WITNESS_CACHE", raising=False)
    seed = jbench.witness_seed_for(label, k)
    port = tbench.packed_witness(label, k, seed)
    jax_cols = jbench.packed_witness(label, k, seed)
    ints = jbench.gen_witness(k, seed)
    for p, j, c in zip(port, jax_cols, ints):
        assert p.dtype == np.int32 and p.shape == (1 << k, 8)
        assert torch.equal(torch.from_numpy(p), convert.from_jax_limbs(j))
        assert np.array_equal(p, tfr.pack_ints(c, mont=True))


@pytest.mark.parametrize("n,pre", [(1, 0), (7, 0), (64, 0), (65, 0),
                                   (300, 0), (7, 2), (64, 6), (129, 30),
                                   (300, 32)])
def test_vector_sampler_equals_scalar_draws(n, pre):
    """The port's `StdRng.ark_fr_rand_mont_limbs` (what `packed_witness`
    draws with) and `ark_fr_rand_batch` (what `gen_witness` draws with, on
    top of it) against the scalar `ark_fr_rand`, with `pre` leading u64s
    moving the entry index (32: a buffer boundary): the same values, and
    the generator left where the scalar loop leaves it.  An odd entry
    index raises in the first and takes the scalar loop in the second."""
    a, b, c = (StdRng.seed_from_u64(0xC0FFEE + n + pre) for _ in range(3))
    for _ in range(pre):
        assert a.next_u64() == b.next_u64() == c.next_u64()
    limbs = a.ark_fr_rand_mont_limbs(n)
    batch = c.ark_fr_rand_batch(n)
    want = [b.ark_fr_rand() for _ in range(n)]
    assert limbs.dtype == np.uint64 and limbs.shape == (n, 4)
    assert [from_montgomery_limbs(sum(int(x) << (64 * i)
                                      for i, x in enumerate(row)))
            for row in limbs] == want == batch
    for _ in range(70):  # across the next buffer
        assert a.next_u64() == b.next_u64() == c.next_u64()
    for rng in (a, b, c):
        rng.next_u32()
    with pytest.raises(ValueError, match="even entry index"):
        a.ark_fr_rand_mont_limbs(1)
    assert c.ark_fr_rand_batch(3) == [b.ark_fr_rand() for _ in range(3)]


def test_witness_cache_keeps_its_own_layout(tmp_path, monkeypatch):
    """A directory shared with the JAX package: its `wit_*.npy` files
    ([4, n, 16] uint32) are never read by the port, whose own file holds
    [4, n, 8] int32 and round-trips; a file of another layout under the
    port's name raises."""
    label, k = "paper", 6
    seed = jbench.witness_seed_for(label, k)
    monkeypatch.setenv("BENCH_WITNESS_CACHE", str(tmp_path))
    jbench.packed_witness(label, k, seed)
    jax_file = tmp_path / f"wit_{label}_{k}_{seed:x}.npy"
    assert jax_file.exists()
    # a JAX-layout file of garbage under the JAX name: not read
    np.save(jax_file, np.zeros((4, 1 << k, 16), np.uint32))
    first = tbench.packed_witness(label, k, seed)
    port_file = tmp_path / f"torch_wit_{label}_{k}_{seed:x}.npy"
    assert port_file.exists() and port_file != jax_file
    cached = np.load(port_file)
    assert cached.dtype == np.int32 and cached.shape == (4, 1 << k, 8)
    again = tbench.packed_witness(label, k, seed)
    want = [tfr.pack_ints(c, mont=True) for c in jbench.gen_witness(k, seed)]
    for a, b, c in zip(first, again, want):
        assert np.array_equal(a, c) and np.array_equal(b, c)
    np.save(port_file, np.zeros((4, 1 << k, 16), np.uint32))
    with pytest.raises(ValueError, match="expected int32"):
        tbench.packed_witness(label, k, seed)


BASE = {"proof_bytes": 101600, "prove_s": 0.911, "verify_ms": 15.4,
        "eps": (1 << 16) / 0.911}


@pytest.mark.parametrize("args,baseline", [
    (("paper", 16, [16, 16, 8], 101600, 0.911, 15.4), None),
    (("mod16", 16, [16, 16, 16, 16], 112392, 1.0, 20.0), BASE),
    (("uni128", 11, [128], 40000, 0.0123456789, 0.5), None),
    (("hi128_32_8", 19, [128, 32, 8], 189648, 12.5, 41.74), BASE),
])
def test_csv_line_equal(args, baseline):
    assert tbench.CSV_HEADER == jbench.CSV_HEADER
    assert (tbench.csv_line(*args, baseline)
            == jbench.csv_line(*args, baseline))


def test_append_baseline_reparse(tmp_path):
    """BENCH_APPEND=1 re-derives the paper delta baseline from the rows
    recorded so far; the card line and the header are skipped, and a
    csv_line round-trips through the parse."""
    from bench_all_torch import paper_baseline_from

    line = tbench.csv_line("paper", 16, [16, 16, 8], 101600, 0.911, 15.4)
    alt0 = tbench.csv_line("mod16", 16, [16, 16, 16, 16], 112392, 1.0, 20.0)
    path = tmp_path / "bench.csv"
    path.write_text("# NVIDIA H100 80GB HBM3, 700.00 W\n"
                    f"{tbench.CSV_HEADER}\n{line}\n{alt0}\n")
    base = paper_baseline_from(str(path))
    assert list(base) == [16]
    base = base[16]
    assert base["proof_bytes"] == 101600
    assert abs(base["eps"] - (1 << 16) / 0.911) < 1e-3
    # a non-paper row against the reparsed baseline carries sane deltas
    alt = tbench.csv_line("mod16", 16, [16, 16, 16, 16], 112392, 1.0, 20.0,
                          base)
    d = alt.split(",")
    assert abs(float(d[8]) - 10.62) < 0.05     # size delta %
    assert float(d[9]) > 0                      # slower than paper


def test_run_mf_fri_equals_jax_spec_prover():
    """The harness's run at `uni128` k=8 (the shape of the golden entry
    `wide128_k8`: one fold by 128, Poseidon t=129) on the CPU: its proof is
    byte-equal to the JAX package's pure-int spec prover on the same
    witness, and `proof_bytes` is that proof's
    `deep_fri_proof_size_bytes`."""
    label, k = "uni128", 8
    res = tbench.run_mf_fri(label, k, warmup=False, reps=1, device="cpu")
    seed = jbench.witness_seed_for(label, k)
    params = jsfri.DeepFriParams(schedule=[128], r=jbench.R_QUERIES,
                                 seed_z=jbench.SEED_Z)
    ref = jsfri.deep_fri_prove(jsfri.DeepAliRealBuilder(),
                               *jbench.gen_witness(k, seed), 1 << k, params)
    assert serialize_proof(res["proof"]) == jax_serialize(ref)
    assert res["proof_bytes"] == jsfri.deep_fri_proof_size_bytes(ref)
    assert res["schedule"] == [128] and (res["label"], res["k"]) == (label, k)
    assert len(res["prove_samples"]) == 1 and len(res["verify_samples"]) == 1
    assert res["prove_s"] == res["prove_median_s"] > 0
    assert res["verify_ms"] == res["verify_median_ms"] > 0


def test_runs_take_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    for run in (lambda: tbench.run_mf_fri("paper", 11, warmup=False),
                lambda: tbench.run_plain_nizk(4, warmup=False),
                lambda: tbench.run_mf_nizk(4, warmup=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


@pytest.mark.parametrize("variant", ["plain", "mf"])
def test_nizk_runs_on_the_cpu(variant):
    """`run_plain_nizk` / `run_mf_nizk` at k=5 on the CPU: the keys of the
    JAX functions, and the size of the JAX package's proof at the same
    settings (`nizk_entries` of tests/data/torch_golden.json)."""
    import json

    run = tbench.run_plain_nizk if variant == "plain" else tbench.run_mf_nizk
    res = run(5, warmup=False, device="cpu")
    assert set(res) == {"k", "prove_s", "verify_ms", "proof_bytes"}
    with open(os.path.join(ROOT, "tests", "data", "torch_golden.json")) as f:
        ent = {e["name"]: e for e in json.load(f)["nizk_entries"]}[
            f"{variant}_k5"]
    assert res["proof_bytes"] == ent["size_bytes"]
    assert res["k"] == 5


@pytest.mark.parametrize("driver", ["bench_torch.py", "bench_all_torch.py",
                                    "bench_micro_torch.py"])
def test_drivers_refuse_to_run_without_a_card(driver, tmp_path):
    """No CPU run and no re-exec: without a card the driver raises, exits
    non-zero and prints no result (and writes no CSV)."""
    import subprocess

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    env = dict(os.environ, PYTHONPATH=ROOT, BENCH_KS="11",
               BENCH_CSV=str(tmp_path / "b.csv"),
               MICRO_OUT=str(tmp_path / "m.json"))
    res = subprocess.run([sys.executable, os.path.join(ROOT, driver)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""
    assert list(tmp_path.iterdir()) == []
