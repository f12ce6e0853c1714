"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real (1-device) runtime; only launch/dryrun.py forces 512 devices."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# DACP_LOCKCHECK=1: patch the threading factories *before* any repro module
# is imported, so module- and instance-level locks are created tracked.  The
# observed acquisition-order graph is dumped at exit (DACP_LOCKCHECK_OUT)
# and unioned with the static graph by `python -m tools.dacpcheck`.
if os.environ.get("DACP_LOCKCHECK", "").strip().lower() in ("1", "true", "yes", "on"):
    from repro.core import lockcheck

    lockcheck.install_if_enabled()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def tmp_tree(tmp_path):
    """A small mixed dataset tree: structured csv/jsonl + unstructured blobs."""
    root = tmp_path / "data"
    (root / "structured").mkdir(parents=True)
    csv = root / "structured" / "table.csv"
    with open(csv, "w") as f:
        f.write("id,score,tag\n")
        for i in range(500):
            f.write(f"{i},{i * 0.5},t{i % 5}\n")
    jsonl = root / "structured" / "rows.jsonl"
    import json

    with open(jsonl, "w") as f:
        for i in range(200):
            f.write(json.dumps({"review_id": f"r{i}", "stars": i % 5 + 1, "text": f"text {i}"}) + "\n")
    blobs = root / "blobs"
    blobs.mkdir()
    rng = np.random.default_rng(1)
    for i in range(24):
        ext = "png" if i % 3 else "csv"
        with open(blobs / f"f{i:03d}.{ext}", "wb") as f:
            f.write(rng.integers(0, 256, 64 + i, dtype=np.uint8).tobytes())
    return root


@pytest.fixture()
def local_cluster(tmp_tree):
    """Two-domain in-proc cluster + a replica of domain B."""
    from repro.client import LocalNetwork
    from repro.server import FairdServer

    net = LocalNetwork()
    s1 = FairdServer("h1:3101")
    s1.catalog.register_path("structured", str(tmp_tree / "structured"))
    s2 = FairdServer("h2:3101")
    s2.catalog.register_path("blobs", str(tmp_tree / "blobs"))
    s2b = FairdServer("h2b:3101")
    s2b.catalog.register_path("blobs", str(tmp_tree / "blobs"))
    for s in (s1, s2, s2b):
        net.register(s)
    net.add_replica("h2:3101", "h2b:3101")
    return net, s1, s2, s2b


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's kernels); skips without one. On the card: "
        "python -m pytest -m gpu tests/test_torch_gpu.py",
    )
