"""The port stands on its own: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports jax or the reference package, every module
imports with jax made unimportable, and nothing falls back silently —
the entry points raise without a card, the CUDA wrappers (both bodies of
the fused linear, and the ADC kernel) raise without ``nvcc`` and for any
non-CPU device they have no kernel for, and calibration, which the
wrappers refuse (they have no backward), runs under ``dequant`` whatever
the deployment's backend."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch
from repro_torch.deploy import Deployment
from repro_torch.kernels import build as B
from repro_torch.kernels import crossbar_mvm as C
from repro_torch.kernels import dora_linear as K

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s*$|\s+as\b|\s*,)"
    r"|from\s+repro(\.|\s+import\b))",
    re.MULTILINE,
)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_pattern_separates_port_from_reference():
    assert FORBIDDEN.search("from repro.core import rram")
    assert FORBIDDEN.search("import repro.deploy")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from jax import lax")
    assert not FORBIDDEN.search("from repro_torch.core import rram")
    assert not FORBIDDEN.search("import repro_torch")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "for name in sys.argv[1:]:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, *_modules()],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_program_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Deployment.program(get_arch("qwen3_1_7b").smoke, 0, backend="codes")


def test_serve_cli_without_device_raises_when_no_card(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke", "--backend", "codes"])


def test_paper_entry_points_without_device_raise_when_no_card(monkeypatch):
    from repro_torch.deploy import resnet_cell
    from repro_torch.launch import paper_tables

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet_cell(method="dora")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_tables.main(["--only", "fig2_drift_sweep"])


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(K.LIB, "_lib", None)
    monkeypatch.setattr(B, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build()


def test_adc_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(C.LIB, "_lib", None)
    monkeypatch.setattr(B, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found.*crossbar_mvm.cu"):
        C.build()


def test_sources_are_built_from_the_checkout():
    assert K.LIB.src == ROOT / "src/repro_torch/kernels/csrc/dora_linear.cu"
    assert C.LIB.src == ROOT / "src/repro_torch/kernels/csrc/crossbar_mvm.cu"
    assert K.LIB.src.is_file() and C.LIB.src.is_file()


@pytest.mark.parametrize("launcher", [K.dora_linear, K.dora_linear_gemv])
def test_wrapper_has_no_fallback_for_non_cpu_tensors(launcher):
    ops = [torch.empty((4, 8), device="meta")] + [
        torch.empty(s, dtype=d, device="meta")
        for s, d in (((8, 6), torch.uint8), ((8, 6), torch.uint8),
                     ((1, 6), torch.float32), ((8, 2), torch.float32),
                     ((2, 6), torch.float32), ((1, 6), torch.float32))
    ]
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        launcher(*ops)
    with pytest.raises(ValueError, match="several devices"):
        launcher(torch.zeros((4, 8)), *ops[1:])
    assert set(K.launch_counts().values()) == {0}


def _meta(*shapes):
    return [torch.empty(s, dtype=d, device="meta") for s, d in shapes]


@pytest.mark.parametrize("launcher", [K.dora_linear, K.dora_linear_gemv])
def test_int8_body_has_no_fallback_for_non_cpu_tensors(launcher):
    ops = _meta(((4, 8), torch.float32), ((8, 6), torch.uint8), ((8, 6), torch.uint8),
                ((1, 6), torch.float32), ((8, 2), torch.float32), ((2, 6), torch.float32),
                ((1, 6), torch.float32))
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        launcher(*ops, accum="int8")
    with pytest.raises(ValueError, match="several devices"):
        launcher(torch.zeros((4, 8)), *ops[1:], accum="int8")
    assert set(K.launch_counts().values()) == {0}


def test_adc_wrapper_has_no_fallback_for_non_cpu_tensors():
    ops = _meta(((4, 8), torch.float32), ((8, 6), torch.uint8), ((8, 6), torch.uint8),
                ((1, 6), torch.float32))
    C.reset_launch_counts()
    with pytest.raises(ValueError, match="no crossbar_mvm kernel for device meta"):
        C.crossbar_mvm(*ops)
    with pytest.raises(ValueError, match="several devices"):
        C.crossbar_mvm(torch.zeros((4, 8)), *ops[1:])
    assert C.launch_counts() == {"crossbar_mvm": 0}


@pytest.mark.parametrize("backend", ["codes", "codes_adc"])
def test_calibrating_a_kernel_backed_deployment_does_not_raise(backend):
    """The kernel wrappers refuse autograd; ``calibrate`` runs under the
    ``dequant`` backend, so a ``codes`` or ``codes_adc`` deployment
    calibrates on the CPU as it would on the card, with no kernel counted,
    and its side-cars come back free of autograd."""
    cfg = get_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend=backend, device="cpu").advance(24)
    K.reset_launch_counts()
    C.reset_launch_counts()
    report = dep.calibrate(2, steps=2, seq_len=8)
    assert report.backend == backend and len(report.losses) == 2
    assert set(K.launch_counts().values()) == {0}
    assert C.launch_counts() == {"crossbar_mvm": 0}
    assert not any(t.requires_grad for t in tree_lib.tensors(dep.adapters))
