"""The port stands alone: it imports neither jax nor the JAX package, and
it runs on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "stark_mlwe_tpu_torch", "stark_mlwe_tpu_torch.device",
    "stark_mlwe_tpu_torch.kernels", "stark_mlwe_tpu_torch.convert",
    "stark_mlwe_tpu_torch.native", "stark_mlwe_tpu_torch.transcript",
    "stark_mlwe_tpu_torch.ops.fr", "stark_mlwe_tpu_torch.ops.poseidon",
    "stark_mlwe_tpu_torch.merkle", "stark_mlwe_tpu_torch.fri",
    "stark_mlwe_tpu_torch.fri.fs", "stark_mlwe_tpu_torch.fri.deep_ali",
    "stark_mlwe_tpu_torch.stark", "stark_mlwe_tpu_torch.spec.field",
    "stark_mlwe_tpu_torch.spec.blake3", "stark_mlwe_tpu_torch.spec.rng",
    "stark_mlwe_tpu_torch.spec.poseidon",
    "stark_mlwe_tpu_torch.spec.poseidon_opt",
    "stark_mlwe_tpu_torch.spec.transcript",
    "stark_mlwe_tpu_torch.spec.merkle",
    "stark_mlwe_tpu_torch.spec.deep_ali", "stark_mlwe_tpu_torch.spec.fri",
    "chip_smoke",
]


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['stark_mlwe_tpu'] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('stark_mlwe_tpu.')]\n"
        "assert bad == ['jax'], bad\n"
        "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_port_sources_name_no_jax_import():
    pkg = os.path.join(ROOT, "stark_mlwe_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for line in open(path):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s.split("#")[0], (path, s)
                assert "stark_mlwe_tpu " not in s + " ", (path, s)
                assert "stark_mlwe_tpu." not in s, (path, s)


def test_every_kernel_source_is_in_the_tree():
    """Each registered source and shared header is a file under csrc/, and
    each launch counter names a registered kernel."""
    from stark_mlwe_tpu_torch import kernels
    for name in kernels.SOURCES:
        assert os.path.isfile(kernels.source_path(name)), name
    csrc = os.path.dirname(kernels.source_path("fr_fold"))
    for header in kernels._HEADERS:
        assert os.path.isfile(os.path.join(csrc, header)), header
    assert {"poseidon_absorb_chain", "poseidon_permute_group"} <= set(
        kernels.SOURCES)
    elementwise = {"fr_mont_mul", "fr_add", "fr_sub"}
    assert elementwise <= set(kernels.launches)
    for counter in set(kernels.launches) - elementwise:
        assert any(counter.startswith(src) for src in kernels.SOURCES
                   if src != "fr_elementwise"), counter


def test_default_device_is_the_card():
    """`device=None` means CUDA; where there is no card it raises, and
    nothing falls back to the CPU."""
    from stark_mlwe_tpu_torch.device import resolve
    from stark_mlwe_tpu_torch import stark as tstark
    assert resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve(None).type == "cuda"
        return
    w = tstark.MlweWitness.random(k=4, seed=1)
    params = tstark.DeepFriParams(schedule=[4], r=2, seed_z=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstark.prove(w, params)
    proof = tstark.prove(w, params, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstark.verify(params, proof)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w.to_device()


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    res = subprocess.run([sys.executable, os.path.join(ROOT,
                                                       "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
