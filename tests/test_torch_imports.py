"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

* every module of ``repro_torch`` (and ``chip_smoke.py``) imports in a
  process where importing ``jax`` raises, and no ``repro.`` module loads;
* no import statement anywhere in the port's sources names ``jax`` or
  ``repro`` (lazy imports inside functions included);
* ``chip_smoke.py`` fails without a CUDA device and prints no result line.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {"repro_torch.comms.elastic", "repro_torch.launch.elastic",
        "repro_torch.checkpoint", "repro_torch.launch.roofline",
        "repro_torch.launch.obs", "repro_torch.objectives.lm",
        "repro_torch.launch.steps", "repro_torch.launch.train",
        "repro_torch.models.moe", "repro_torch.models.attention",
        "repro_torch.models.transformer", "repro_torch.launch.serve",
        "repro_torch.serve.kv_cache", "repro_torch.convert",
        "repro_torch.models.ssm", "repro_torch.serve.replica",
        "repro_torch.comms.api", "repro_torch.analysis.contracts",
        "repro_torch.models.xlstm", "repro_torch.analysis.kernel_check",
        "repro_torch.analysis.entrypoints",
        "repro_torch.analysis.__main__",
        "repro_torch.launch.decode_check"} | {
    "repro_torch.configs." + m for m in ("granite_3_2b", "granite_3_8b",
                                         "gemma3_27b", "musicgen_large",
                                         "granite_moe_1b_a400m",
                                         "deepseek_v2_236b",
                                         "llama_3_2_vision_11b",
                                         "zamba2_2p7b", "xlstm_1p3b")} | {
    "repro_torch.obs." + m for m in ("events", "trace", "estimates", "wire",
                                     "telemetry")} <= set(names), names
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jax", "jaxlib"))
assert not bad, bad
print("imported", len(names))
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT)],
                       capture_output=True, text=True, env=_env(),
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20, r.stdout


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_import_statement_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """On a machine without CUDA the smoke run fails and prints no result;
    so does a copy of the script without the repository around it."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, env=_env(), timeout=120,
                           cwd=script.parent)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
