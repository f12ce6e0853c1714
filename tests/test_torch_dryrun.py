"""The port's dry-run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.roofline``) against the reference's.

The cells trace in a subprocess: ``run_cell`` makes the default process
group a fake one of the mesh's size, which this process must not keep.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import input_axes as ref_input_axes  # noqa: E402
from repro.models import input_specs as ref_input_specs  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.train.steps import opt_axes as ref_opt_axes  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline.analysis import HW, collective_bytes, dominant_term, model_flops, roofline_terms  # noqa: E402

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "granite-3-8b"
MESHES = {"single": (2, 2), "multi": (2, 2, 2)}


def _run(code: str, timeout: int) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


# ---------------------------------------------------------------------------
# the roofline terms on the H100
# ---------------------------------------------------------------------------
def test_hw_is_the_h100():
    assert HW.PEAK_FLOPS == 989e12 and HW.HBM_BW == 3.35e12 and HW.LINK_BW == 450e9
    assert HW.CARD.startswith("NVIDIA H100") and HW.HBM_BYTES > 80e9
    assert HW.CHIPS_PER_POD == ref_analysis.HW.CHIPS_PER_POD


def test_roofline_terms_and_bound():
    t = roofline_terms(989e12, 3.35e12 * 2, 450e9 * 3)
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 2.0) < 1e-9
    assert abs(t["collective_s"] - 3.0) < 1e-9
    assert t["bound"] == "collective" and abs(t["roofline_frac_compute"] - 1 / 3) < 1e-9
    assert dominant_term({"compute_s": 5, "memory_s": 1, "collective_s": 2}) == "compute"
    assert roofline_terms(0.0, 0.0, 0.0)["roofline_frac_compute"] == 0.0


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference(arch):
    for name in SHAPES:
        assert model_flops(get_config(arch), SHAPES[name]) == ref_analysis.model_flops(ref_config(arch), REF_SHAPES[name])


def test_the_cells_are_the_reference_cells():
    code = ("import os; os.environ['JAX_PLATFORMS'] = 'cpu'; from repro.launch import dryrun as d; "
            "print(d.ASSIGNED_ARCHS, d.ALL_SHAPES, sorted(d.LONG_OK), "
            "[d.cell_skip_reason(a, s) for a in d.ASSIGNED_ARCHS for s in d.ALL_SHAPES])")
    want = _run(code, 120).strip()  # in a subprocess: the reference's module sets XLA_FLAGS at import
    skips = [dryrun.cell_skip_reason(a, s) for a in dryrun.ASSIGNED_ARCHS for s in dryrun.ALL_SHAPES]
    assert want == str(dryrun.ASSIGNED_ARCHS) + " " + str(dryrun.ALL_SHAPES) + " " + str(sorted(dryrun.LONG_OK)) + \
        " " + str(skips)


# ---------------------------------------------------------------------------
# collective bytes from CommDebugMode's records
# ---------------------------------------------------------------------------
COLLECTIVES = textwrap.dedent(
    """
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed.sharding import cost_site, shard_tensor
    from repro_torch.launch.dryrun import make_mesh
    from repro_torch.roofline.analysis import CollectiveBytesMode, collective_bytes

    mesh = make_mesh("single", (4, 1))
    x = shard_tensor(torch.ones(16, 8), mesh, (Shard(0), Replicate()))
    with CollectiveBytesMode() as gather:
        x.redistribute(mesh, (Replicate(), Replicate()))
    partial = DTensor.from_local(torch.ones(16, 8), mesh, (Partial(), Replicate()), run_check=False)
    with CollectiveBytesMode() as scatter:
        partial.redistribute(mesh, (Shard(0), Replicate()))
    with CollectiveBytesMode() as reduce:
        dist.all_reduce(torch.ones(3))
    with CollectiveBytesMode() as sited:
        with cost_site("embed_whole"):
            x.redistribute(mesh, (Replicate(), Replicate()))
        dist.all_reduce(torch.ones(3))
    print(json.dumps({"gather": collective_bytes(gather), "scatter": collective_bytes(scatter),
                      "reduce": collective_bytes(reduce), "sited": collective_bytes(sited),
                      "records": [gather.records, scatter.records, sited.records]}))
    """
)


_COLLECTIVES_OUT: dict = {}


def _collectives() -> dict:
    if not _COLLECTIVES_OUT:
        _COLLECTIVES_OUT.update(json.loads(_run(COLLECTIVES, 180).strip().splitlines()[-1]))
    return _COLLECTIVES_OUT


def test_collective_bytes_on_a_known_all_gather_and_reduce_scatter():
    out = _collectives()
    # all-gather of a (4, 8) float32 shard over 4 ranks: result 512 bytes, operand 128
    assert out["records"][0] == [["all-gather", 512, 4, None]]
    assert out["gather"]["all-gather"] == 128 and out["gather"]["_total"] == 128
    assert out["gather"]["_counts"]["all-gather"] == 1
    # reduce-scatter of the (16, 8) partial sums: result (4, 8), operand 512
    assert out["records"][1] == [["reduce-scatter", 128, 4, None]]
    assert out["scatter"]["reduce-scatter"] == 512 and out["scatter"]["_counts"]["reduce-scatter"] == 1
    # an eager all_reduce of 3 float32: its result
    assert out["reduce"]["all-reduce"] == 12 and out["reduce"]["_total"] == 12


def test_collective_bytes_files_a_cost_site_apart():
    """A collective run inside ``cost_site`` is counted in the totals and in
    ``_by_site`` under its name; one outside is in the totals alone."""
    out = _collectives()
    assert out["records"][2] == [["all-gather", 512, 4, "embed_whole"], ["all-reduce", 12, 4, None]]
    assert out["sited"]["_total"] == 128 + 12 and out["sited"]["_by_site"] == {"embed_whole": 128}
    assert out["gather"]["_by_site"] == {}


# ---------------------------------------------------------------------------
# run_cell on a reduced configuration over fake meshes
# ---------------------------------------------------------------------------
CELLS = textwrap.dedent(
    """
    import json
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    out = {}
    for mk, mesh_shape in (("single", (2, 2)), ("multi", (2, 2, 2))):
        for kind in ("train", "prefill", "decode"):
            rec = dryrun.run_cell(%r, kind, mk, cfg=get_config(%r).reduced(), shape=ShapeSpec(kind, 64, 8, kind),
                                  mesh_shape=mesh_shape)
            out[mk + "/" + kind] = rec
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def cells():
    return json.loads(_run(CELLS % (ARCH, ARCH), 900).strip().splitlines()[-1])


def _ref_shard_bytes(axes_tree, shapes_tree, mesh_shape, names) -> int:
    """Per-device bytes of every array leaf as the reference's
    ``tree_pspecs`` lays it out on a mesh of ``mesh_shape``."""

    class RefMesh:
        axis_names = names
        devices = np.empty(mesh_shape)

    sizes = dict(zip(names, mesh_shape))
    specs = ref_sharding.tree_pspecs(axes_tree, shapes_tree, RefMesh())
    total = 0
    for spec, leaf in zip(jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)),
                          jax.tree.leaves(shapes_tree)):
        split = 1
        for entry in spec:
            for ax in (entry,) if isinstance(entry, str) else (entry or ()):
                split *= sizes[ax]
        total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // split
    return total


def _ref_init(cfg):
    cap = {}

    def f(k):
        p, a = ref_build(cfg).init(k)
        cap["a"] = a
        return p

    shapes = jax.eval_shape(f, jax.ShapeDtypeStruct((2,), jnp.uint32))
    return cap["a"], shapes


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_traces_reduced_cells_on_fake_meshes(cells, mesh_kind, kind):
    rec = cells[f"{mesh_kind}/{kind}"]
    assert rec["status"] == "ok" and rec["n_chips"] == int(np.prod(MESHES[mesh_kind]))
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["roofline"]["bound"] in ("compute", "memory", "collective")
    assert rec["memory_analysis"]["temp_size_in_bytes"] is None
    assert rec["memory_analysis"]["peak_memory_in_bytes"] is None
    assert rec["collective_bytes_per_device"] == sum(rec["collectives"].values())


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_files_the_vocab_whole_embedding_under_its_cost_site(cells, mesh_kind, kind):
    """The embedding table's gather to vocab-whole (a layout the reference's
    cells do not run) is recorded apart, within the cell's totals."""
    rec = cells[f"{mesh_kind}/{kind}"]
    site = rec["by_site"]["embed_whole"]
    assert 0 < site["collective_bytes"] <= rec["collective_bytes_per_device"]
    assert site["flops"] <= rec["flops_per_device"] and site["bytes"] <= rec["bytes_per_device"]
    assert "replicated" not in rec["by_site"]  # a dense model runs no replicated dispatch


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_argument_bytes_follow_the_reference_layout(cells, mesh_kind, kind):
    """Per-device argument bytes are the sum of the shard sizes the
    reference's ``tree_pspecs`` gives the step's arguments (the decode
    cache's index is a host int in the port, a 0-d int32 in the reference:
    it is left out)."""
    rcfg = ref_config(ARCH).reduced()
    names = dryrun.MESH_AXES[mesh_kind]
    mesh_shape = MESHES[mesh_kind]
    shape = RefShapeSpec(kind, 64, 8, kind)
    axes, shapes = _ref_init(rcfg)
    want = _ref_shard_bytes(axes, shapes, mesh_shape, names)
    if kind == "train":
        opt = {"m": jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), shapes), "v": None, "step": None}
        opt["v"] = opt["m"]
        opt["step"] = jax.ShapeDtypeStruct((), jnp.int32)
        want += _ref_shard_bytes(ref_opt_axes(axes)["opt"], opt, mesh_shape, names)
    specs, in_axes = ref_input_specs(rcfg, shape), ref_input_axes(rcfg, shape)
    if kind == "decode":
        specs["cache"] = {k: v for k, v in specs["cache"].items() if k != "index"}
        in_axes["cache"] = {k: v for k, v in in_axes["cache"].items() if k != "index"}
    want += _ref_shard_bytes(in_axes, specs, mesh_shape, names)
    assert cells[f"{mesh_kind}/{kind}"]["memory_analysis"]["argument_size_in_bytes"] == want


def test_summary_and_report_read_the_results(tmp_path, monkeypatch, capsys):
    from repro_torch.roofline import report

    rec = {"arch": ARCH, "shape": "train_4k", "mesh": "single", "kind": "train", "tag": "", "status": "ok",
           "n_chips": 256, "trace_s": 1.0, "flops_per_device": 1e12, "bytes_per_device": 1e9,
           "collective_bytes_per_device": 1e6, "collective_counts": {"all-reduce": 1}, "roofline":
           roofline_terms(1e12, 1e9, 1e6), "model_flops_global": 1e14, "useful_flops_ratio": 0.4,
           "memory_analysis": {"argument_size_in_bytes": 10, "peak_memory_in_bytes": None}}
    skip = {"arch": ARCH, "shape": "long_500k", "mesh": "single", "status": "skip",
            "reason": dryrun.cell_skip_reason(ARCH, "long_500k")}
    for r in (rec, skip):
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(json.dumps(r))
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(report, "RESULTS_DIR", str(tmp_path))
    assert dryrun.summary() == 0
    out = capsys.readouterr().out
    assert '"ok": 1' in out and '"skip": 1' in out and "compute" in out
    report.main([])
    out = capsys.readouterr().out
    assert "| granite-3-8b | train_4k | single | ok | 256 |" in out and "SKIP" in out


def test_out_directory_takes_the_records_and_the_summary_reads_it(tmp_path, monkeypatch, capsys):
    """``--out`` moves every record of ``--all`` and ``--summary`` away from
    ``RESULTS_DIR``: with every traced cell already in ``--out``, ``--all``
    launches nothing and writes the skip records there."""
    default = tmp_path / "default"
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(default))
    traced = [(a, s) for a in dryrun.ASSIGNED_ARCHS for s in dryrun.ALL_SHAPES if not dryrun.cell_skip_reason(a, s)]
    for arch, shape in traced:
        (out / f"{arch}__{shape}__single.json").write_text(json.dumps(
            {"arch": arch, "shape": shape, "mesh": "single", "status": "error", "error": "stand-in"}))
    assert dryrun.main(["--all", "--mesh", "single", "--out", str(out)]) == 0
    assert not default.exists()
    skips = [json.loads(p.read_text()) for p in out.glob("*__long_500k__single.json")]
    assert sum(r["status"] == "skip" for r in skips) == len(dryrun.ASSIGNED_ARCHS) - len(dryrun.LONG_OK)
    capsys.readouterr()
    assert dryrun.main(["--summary", "--out", str(out)]) == 0
    counts = json.loads(capsys.readouterr().out.strip().splitlines()[-1].split(": ", 1)[1])
    assert counts == {"error": len(traced), "skip": len(dryrun.ASSIGNED_ARCHS) - len(dryrun.LONG_OK)}
