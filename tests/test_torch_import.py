"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the reference package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "repro" or name.startswith("repro."):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro.") or m.startswith("jax."))
print(len(names), loaded)
"""


def test_every_port_module_imports_without_jax_or_repro():
    pytest.importorskip("torch")  # the probe imports every port module, which needs torch
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.strip().split(" ", 1)
    assert int(count) >= 40, res.stdout
    assert loaded == "[]", f"reference or jax modules loaded: {loaded}"


def _imports(path: Path) -> list:
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_no_source_file_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 40
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_the_sweep_covers_every_kernel_and_model_module():
    """The import sweep above walks the whole package; the modules each
    slice added are among the modules it imports."""
    pytest.importorskip("torch")  # walk_packages imports the subpackages, which need torch
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    for mod in ("kernels.flash_attention", "kernels.decode_attention", "kernels.ssd_scan", "kernels.mlstm_chunk",
                "models.attention", "models.ssm", "models.xlstm", "models.lm", "models.convert", "launch.serve",
                "kernels.grad", "optim.adamw", "optim.schedule", "optim.accumulate", "optim.grad_compress",
                "train.steps", "train.loop", "checkpoint.manager", "launch.train", "tree",
                "distributed.sharding", "distributed.collectives", "distributed.elastic", "distributed.per_shard",
                "launch.mesh", "launch.dryrun", "roofline.analysis", "roofline.report"):
        assert f"repro_torch.{mod}" in names, mod
