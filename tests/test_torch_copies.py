"""The port's framework-neutral modules are copies of the reference's with
only the import prefix rewritten (``repro.`` → ``repro_torch.``).  The
ported modules — the compute backend, the executor's device binding, the
env help text, the lock recorder's frame filter and the server's spans of
the COOK path (``server/faird.py``) — are the only exemptions, so every
other difference from the reference shows up here.
``client/torch_adapter.py`` is the port's own counterpart of
``client/jax_adapter.py``; its numpy-only helpers are held to the
reference's.  ``trace.py``, the span recorder, is the port's own.
``configs/base.py`` is ported too: its ``ArchConfig`` and ``SSMCfg`` carry
the keys of zamba2's published layout (B/C groups, conv bias, the gated
norm's groups, ``hybrid_layer_ids``, memory blocks, adapters, the
concatenated input), which the reference has no configuration to use;
``configs/zamba2_7b.py``, ``configs/granite_4_0_h_small.py``,
``models/score.py`` (the in-situ scoring map) and ``kernels/grouped_mm.py``
(the dropless MoE's expert products) are the port's own."""

import inspect
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED_DIRS = ("core", "transport", "server", "client", "configs", "data")
COPIED_FILES = ("distributed/elastic.py",)  # framework-neutral modules outside those directories
PORTED = {"core/backend.py", "core/executor.py", "core/env.py", "core/lockcheck.py", "server/faird.py",
          "configs/base.py"}
PORT_ONLY = {"client/torch_adapter.py", "configs/zamba2_7b.py", "configs/granite_4_0_h_small.py"}
DIR_COPIES = sorted(
    str(p.relative_to(SRC / "repro_torch"))
    for p in (SRC / "repro_torch").rglob("*.py")
    if p.parts[len((SRC / "repro_torch").parts)] in COPIED_DIRS
    and str(p.relative_to(SRC / "repro_torch")) not in PORT_ONLY
)
COPIED = DIR_COPIES + list(COPIED_FILES)
# the reference's modules the port has no counterpart of, and the port's own modules
REFERENCE_ONLY = {"kernels/ref.py", "client/jax_adapter.py"}
PORT_ADDITIONS = {"client/torch_adapter.py", "device.py", "tree.py", "kernels/_build.py", "kernels/grad.py",
                  "models/convert.py", "distributed/per_shard.py", "trace.py", "configs/zamba2_7b.py",
                  "models/score.py", "kernels/gated_norm.py", "kernels/causal_conv.py",
                  "configs/granite_4_0_h_small.py", "kernels/grouped_mm.py", "kernels/rms_norm.py"}


def _rewrite(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


def test_the_data_plane_is_all_there():
    ref = {
        str(p.relative_to(SRC / "repro"))
        for d in COPIED_DIRS
        for p in (SRC / "repro" / d).rglob("*.py")
    }
    assert ref - {"client/jax_adapter.py"} == set(DIR_COPIES)


def _modules(package: str) -> set:
    return {str(p.relative_to(SRC / package)) for p in (SRC / package).rglob("*.py")}


def test_the_port_has_a_counterpart_of_every_reference_module():
    """The two packages' module trees differ only by the reference's
    ``kernels/ref.py`` (the plain versions beside each kernel do its job) and
    ``client/jax_adapter.py`` (``client/torch_adapter.py``), and by the port's
    own additions."""
    ref, port = _modules("repro"), _modules("repro_torch")
    assert ref - port == REFERENCE_ONLY
    assert port - ref == PORT_ADDITIONS


@pytest.mark.parametrize("rel", [r for r in COPIED if r not in PORTED])
def test_copy_differs_only_in_the_prefix(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == _rewrite(ref), f"{rel} differs from the reference beyond the import prefix"


@pytest.mark.parametrize("rel", sorted(PORTED))
def test_ported_modules_carry_no_reference_prefix(rel):
    text = (SRC / "repro_torch" / rel).read_text()
    assert not re.search(r"\brepro\.", text), f"{rel} still names the reference package"


@pytest.mark.parametrize("name", ["batch_to_arrays", "tokens_from_blob_column", "PrefetchIterator"])
def test_torch_adapter_keeps_the_reference_numpy_helpers(name):
    jax_adapter = pytest.importorskip("repro.client.jax_adapter")
    from repro_torch.client import torch_adapter

    ref = inspect.getsource(getattr(jax_adapter, name))
    assert inspect.getsource(getattr(torch_adapter, name)) == _rewrite(ref)
