"""The port's `utils`, `utils.profiling` and `utils.roofline` against the
JAX package's: byte sizes, the phase accumulator and its CSV, the logging
gate, the permutation's multiply count; and the port's own rules: device
memory stats only for a card, a `torch.profiler` trace written to disk,
the prover's phases seen by the one accumulator."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import stark_mlwe_tpu.utils as jutils
import torch_port_util  # noqa: F401  (one intra-op thread a worker)
from stark_mlwe_tpu.spec.poseidon import params_for_width as jparams
from stark_mlwe_tpu.utils import profiling as jprof
from stark_mlwe_tpu.utils import roofline as jroof
from stark_mlwe_tpu_torch import utils as tutils
from stark_mlwe_tpu_torch.spec.poseidon import params_for_width as tparams
from stark_mlwe_tpu_torch.utils import profiling as tprof
from stark_mlwe_tpu_torch.utils import roofline as troof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sizes():
    """0 ... 2^50: every power of two and its neighbours, the unit edges,
    and random sizes from a numpy seed."""
    out = {0, 1, 1023, 1024, 1025, (1 << 50)}
    for e in range(51):
        out |= {(1 << e) - 1, 1 << e, (1 << e) + 1}
        out |= {int(1023.995 * (1 << (10 * u))) for u in range(5)}
    g = np.random.default_rng(11)
    out |= {int(x) for x in g.integers(0, 1 << 50, size=200)}
    return sorted(x for x in out if 0 <= x <= (1 << 50))


@pytest.mark.parametrize("chunk", range(4))
def test_byte_size_strings_equal(chunk):
    sizes = _sizes()[chunk::4]
    assert len(sizes) > 50
    for n in sizes:
        assert str(tutils.ByteSize(n)) == str(jutils.ByteSize(n)), n
        assert repr(tutils.ByteSize(n)) == repr(jutils.ByteSize(n)), n


def test_hash_to_field_helpers_are_the_ports():
    from stark_mlwe_tpu_torch.spec import field as tfield
    for name in ("fr_from_hash", "fr_from_le_bytes_mod_p", "salt_for_node",
                 "ds_tag_for_arity"):
        assert getattr(tutils, name) is getattr(tfield, name)
    assert tutils.ds_tag_for_arity(16) == jutils.ds_tag_for_arity(16)
    assert (tutils.fr_from_hash("tag", b"data")
            == jutils.fr_from_hash("tag", b"data"))


SEQUENCE = [("fri/build_f0", 0.25), ("fri/queries", 0.0125),
            ("fri/build_f0", 1.5), ("ali/host_absorb", 1e-7),
            ("a,b", 3.0), ("fri/queries", 2.0)]


def test_phase_accumulator_and_csv_equal():
    """The same records give the same report and CSV in both packages."""
    saved_t = dict(tprof._phase_acc)
    saved_j = dict(jprof._phase_acc)
    try:
        tprof.reset_phases()
        jprof.reset_phases()
        for name, s in SEQUENCE:
            tprof.record_phase(name, s)
            jprof.record_phase(name, s)
        assert tprof.phase_report() == jprof.phase_report()
        assert tprof.phase_report()["fri/build_f0"] == {"calls": 2,
                                                        "total_s": 1.75}
        assert tprof.phase_report_csv() == jprof.phase_report_csv()
        assert tprof.phase_report_csv().splitlines()[0] == \
            "phase,calls,total_s"
        tprof.reset_phases()
        assert tprof.phase_report() == {}
        assert tprof.phase_report_csv() == "phase,calls,total_s"
    finally:
        tprof.reset_phases()
        jprof.reset_phases()
        tprof._phase_acc.update(saved_t)
        jprof._phase_acc.update(saved_j)


def test_phase_timer_feeds_the_accumulator_and_a_dict():
    tprof.reset_phases()
    mine = {}
    with tutils.phase_timer("x/y", mine):
        pass
    with tutils.phase_timer("x/y", mine):
        pass
    with tutils.phase_timer("x/z"):
        pass
    rep = tprof.phase_report()
    assert rep["x/y"]["calls"] == 2 and rep["x/z"]["calls"] == 1
    assert set(mine) == {"x/y"}
    assert mine["x/y"] == pytest.approx(rep["x/y"]["total_s"])
    tprof.reset_phases()


@pytest.mark.parametrize("on", [False, True])
def test_logln_gate(on, monkeypatch, capsys):
    monkeypatch.setattr(tutils, "_LOG", on)
    monkeypatch.setattr(jutils, "_LOG", on)
    tutils.logln("phase: 1.0 ms")
    port = capsys.readouterr()
    jutils.logln("phase: 1.0 ms")
    ref = capsys.readouterr()
    assert (port.out, port.err) == (ref.out, ref.err)
    assert port.out == ""
    assert port.err == ("[stark-mlwe-tpu] phase: 1.0 ms\n" if on else "")


def test_logln_gate_reads_the_environment():
    """STARK_MLWE_LOG: on unless unset, empty, "0" or "false"."""
    code = ("import stark_mlwe_tpu_torch.utils as u\n"
            "u.logln('hello')\n")
    for value, on in (("1", True), ("yes", True), ("0", False),
                      ("false", False), ("", False), (None, False)):
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("STARK_MLWE_LOG", None)
        if value is not None:
            env["STARK_MLWE_LOG"] = value
        res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert ("[stark-mlwe-tpu] hello" in res.stderr) == on, value


@pytest.mark.parametrize("t", [9, 17, 33, 65, 129])
def test_poseidon_field_muls_equal(t):
    assert (troof.poseidon_field_muls(tparams(t))
            == jroof.poseidon_field_muls(jparams(t)))


def test_roofline_counts():
    """The port's work model: the tile NTT's multiply-adds, `bound` picking
    the larger of its two times, and the rates built on them."""
    p = tparams(17)
    assert troof.ntt_tile_macs(2, False) == 0
    assert troof.ntt_tile_macs(4, True) == 36 * (2 + 4)
    assert troof.bound(3.35e9, 0) == (1.0, "bytes")
    ms, by = troof.bound(0, 67e9 // 8)
    assert by == "operations" and ms == pytest.approx(1.0)
    r = troof.poseidon_rates(p, 1e6)
    assert r["mac64_per_perm"] == troof.permute_macs(17, p.rf, p.rp)
    assert r["field_muls_per_s"] == 1e6 * troof.poseidon_field_muls(p)
    assert troof.ntt_rates(1 << 10, 1.0)["field_muls_per_s"] == 512 * 10


def test_device_memory_stats_needs_a_card():
    if torch.cuda.is_available():
        stats = tprof.device_memory_stats()
        assert stats["max_memory_allocated"] >= 0
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.device_memory_stats()
    with pytest.raises(RuntimeError, match="not a CUDA device"):
        tprof.device_memory_stats("cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tprof.trace(str(logdir), device="cpu") as prof:
        x = torch.arange(64, dtype=torch.int64)
        (x * x).sum()
    path = logdir / "trace.json"
    assert path.exists()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mul" in e.get("name", "") for e in events)
    assert any("mul" in ev.key for ev in prof.key_averages())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with tprof.trace(str(tmp_path / "t2")):
                pass


def test_prover_phases_reach_the_accumulator():
    """`fri.phase_seconds` keeps the last prove's phases, and the same
    phases reach `profiling.phase_report()` through `utils.phase_timer`."""
    from stark_mlwe_tpu_torch import fri as tfri
    from stark_mlwe_tpu_torch.stark import DeepFriParams, MlweWitness, prove

    tprof.reset_phases()
    w = MlweWitness.random(k=6, seed=2024)
    prove(w, DeepFriParams(schedule=[8, 4], r=6, seed_z=0xDEEFBAAD),
          device="cpu")
    phases = dict(tfri.phase_seconds)
    assert set(phases) == {"fri/build_f0", "ali/column_hashes+overlap",
                           "ali/host_absorb", "ali/f0_quotient",
                           "fri/fold+commit", "fri/roots_readback",
                           "fri/queries"}
    rep = tprof.phase_report()
    for name, seconds in phases.items():
        assert rep[name]["calls"] == 1
        assert rep[name]["total_s"] == pytest.approx(seconds)
    tprof.reset_phases()
