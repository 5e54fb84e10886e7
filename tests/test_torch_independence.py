"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not the port's plan sweeps (``scripts/torch_*.py``)
imports JAX or the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("torch_*.py")))


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_imports_with_jax_and_repro_blocked():
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail imports every module of the port and chip_smoke.py."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]


def test_module_list_covers_the_quantized_path():
    """The blocked-import check above walks the package, the w8a8 and
    int8-KV modules included."""
    assert {"repro_torch.core.quantization", "repro_torch.core.metrics",
            "repro_torch.kernels.w8a8.ops", "repro_torch.kernels.w8a8.ref",
            "repro_torch.kernels.decode_attn.ops",
            "repro_torch.models.quantize"} <= set(_modules())


def test_module_list_covers_the_dlrm_path():
    """The blocked-import check walks the DLRM slice's modules too."""
    assert {"repro_torch.configs.dlrm_paper", "repro_torch.core.partitioner",
            "repro_torch.core.transfer", "repro_torch.core.pipeline",
            "repro_torch.data.synthetic", "repro_torch.kernels.sls.ops",
            "repro_torch.kernels.sls.ref", "repro_torch.models.dlrm",
            "repro_torch.serving.dlrm_engine"} <= set(_modules())


def test_module_list_covers_the_fleet_path():
    """The blocked-import check walks the fleet layer's modules too."""
    assert {"repro_torch.core.backend", "repro_torch.runtime",
            "repro_torch.runtime.fault_tolerance",
            "repro_torch.serving.router", "repro_torch.serving.perf_model",
            "repro_torch.serving.controller",
            "repro_torch.serving.fleet_sim"} <= set(_modules())


def test_module_list_covers_the_encoder_path():
    """The blocked-import check walks the XLM-R encoder's modules too."""
    assert {"repro_torch.configs.xlmr_paper", "repro_torch.core.bucketing",
            "repro_torch.serving.encoder",
            "repro_torch.launch.serve"} <= set(_modules())


def test_module_list_covers_the_encdec_path():
    """The blocked-import check walks whisper's enc-dec modules too."""
    assert {"repro_torch.configs.whisper_medium",
            "repro_torch.serving.encdec"} <= set(_modules())


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_chip_smoke_refuses_to_run_without_a_card():
    """Here there is no CUDA device: the script exits non-zero and prints
    no result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ,
                                            CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
