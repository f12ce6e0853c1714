"""The port's runtime lock-order recorder (``DACP_LOCKCHECK=1``) tracks the
locks created in ``repro_torch`` frames: nesting two port locks records an
edge in the graph it dumps at exit."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
from repro_torch.core import lockcheck

assert lockcheck.install_if_enabled()  # before any lock of the port is created

import numpy as np

from repro_torch.core import backend
from repro_torch.core.batch import RecordBatch
from repro_torch.core.expr import col

bk = backend.TorchBackend("cpu")
batch = RecordBatch.from_pydict({"x": np.ones(8, np.float32), "k": np.arange(8, dtype=np.int32)})
specs = [("filter", (col("x") > 0.0,)), ("select", (["k"],))]
a = backend.plan_fused_chain(specs, batch.schema, backend=bk)
b = backend.plan_fused_chain(specs, batch.schema, backend=bk)
with bk._lock:
    print(a.staged_count)  # FusedChainPlan._stage_lock under TorchBackend._lock
with a._stage_lock:
    with b._stage_lock:  # two instances of one named lock
        pass
a.stage(batch)
print(a.staged_count)
"""


def test_port_lock_nesting_is_recorded(tmp_path):
    pytest.importorskip("torch")  # the probe imports the port, which needs torch
    out = tmp_path / "obs.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), DACP_LOCKCHECK="1", DACP_LOCKCHECK_OUT=str(out))
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["0", "1"]
    obs = json.loads(out.read_text())
    assert ["TorchBackend._lock", "FusedChainPlan._stage_lock"] in obs["edges"], obs
    assert ["FusedChainPlan._stage_lock", "FusedChainPlan._stage_lock"] in obs["cross_instance"], obs
