"""Multi-pod dry-run of the port: trace every (arch × shape × mesh) cell on a
fake process group — the port of ``repro.launch.dryrun``.

Where the reference lowers and compiles each cell on 512 host placeholder
devices, the port traces it in one process on a fake process group of the
mesh's size (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``: collectives return at once and move nothing).  Per cell:
  1. builds the production mesh ((16, 16) single-pod / (2, 16, 16)
     multi-pod) over the fake group (device type ``"cpu"``: host work, as the
     reference's placeholder devices are);
  2. makes the parameters, optimizer state and batch as meta-device
     DTensors (shapes only, no allocation anywhere), each laid out by its
     logical axes (``tree_shardings``);
  3. runs the step (``make_train_step`` / ``make_prefill_step`` /
     ``make_decode_step``) eagerly under ``use_mesh``, so the models'
     ``constrain`` sites redistribute the activations, with
     ``DeviceCostMode`` counting each rank's local flops and bytes and
     ``CollectiveBytesMode`` the collectives DTensor runs;
  4. records per-device argument and output bytes from the local shard
     shapes, the roofline terms on the H100 (``roofline.analysis.HW``) and
     the collectives per kind into ``<cell>.json`` under ``--out``
     (``RESULTS_DIR`` by default), with ``by_site``: the part of the flops,
     bytes and collective bytes run at the port's DTensor workarounds (the
     cost sites of ``distributed.sharding``).  Temp and peak memory have no
     counterpart without a compiler: they are null.

Success is the deliverable: the step traced end to end on the mesh.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both -j 4
    python -m repro_torch.launch.dryrun --summary
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --out /tmp/cells
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")  # git-ignored

ASSIGNED_ARCHS = [
    "chameleon-34b",
    "moonshot-v1-16b-a3b",
    "llama4-scout-17b-a16e",
    "whisper-small",
    "gemma-2b",
    "stablelm-1.6b",
    "granite-3-8b",
    "qwen1.5-0.5b",
    "zamba2-1.2b",
    "xlstm-125m",
]
ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

# long_500k needs sub-quadratic attention: runs only for SSM/hybrid archs
LONG_OK = {"zamba2-1.2b", "xlstm-125m"}

CELL_TIMEOUT_S = 1800  # a cell's subprocess past this is stopped and recorded as an error

MESH_AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}


def cell_skip_reason(arch: str, shape_name: str):
    if shape_name == "long_500k" and arch not in LONG_OK:
        return "long_500k skipped: pure full-attention arch (DESIGN.md §4)"
    return None


def _cell_path(out_dir, arch, shape_name, mesh_kind):
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")


def fake_world(size: int) -> None:
    """Make the default process group a fake one of ``size`` ranks (this
    process is rank 0), replacing any other."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_mesh(mesh_kind: str, mesh_shape: tuple | None = None):
    """The production mesh of ``mesh_kind`` (or ``mesh_shape`` with its axis
    names) over a fake process group of its size, on device type cpu."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_production_mesh

    shape = tuple(mesh_shape or MESH_SHAPES[mesh_kind])
    fake_world(math.prod(shape))
    if mesh_shape is None:
        return make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
    return init_device_mesh("cpu", shape, mesh_dim_names=MESH_AXES[mesh_kind])


def _local_bytes(tree) -> int:
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    return total


def run_cell(arch: str, shape_name: str, mesh_kind: str, sharding_overrides=None, cfg_overrides=None, tag: str = "",
             cfg=None, shape=None, mesh_shape=None) -> dict:
    """Trace one cell and return its record.  ``cfg``, ``shape`` and
    ``mesh_shape`` replace the registered configuration, the named shape
    and the production mesh's sizes (the tests trace reduced cells)."""
    import dataclasses

    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import distribute_tree, tree_shardings, use_mesh
    from repro_torch.models import build, input_axes, input_specs
    from repro_torch.models.model_zoo import param_shapes
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline.analysis import (
        CollectiveBytesMode,
        DeviceCostMode,
        collective_bytes,
        model_flops,
        roofline_terms,
    )
    from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step, opt_axes
    from repro_torch.tree import tree_leaves

    t_start = time.time()
    cfg = cfg if cfg is not None else get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape if shape is not None else SHAPES[shape_name]
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "tag": tag,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.active_params(),
        "cfg_overrides": dict(cfg_overrides or {}),
        "sharding_overrides": {k: list(v) for k, v in (sharding_overrides or {}).items()},
    }
    skip = cell_skip_reason(arch, shape_name)
    if skip:
        record["status"] = "skip"
        record["reason"] = skip
        return record

    mesh = make_mesh(mesh_kind, mesh_shape)
    n_chips = mesh.size()
    params_shapes = param_shapes(cfg)
    param_axes = build(cfg).param_axes()
    record["n_params_exact"] = int(sum(p.numel() for p in tree_leaves(params_shapes)))
    in_ax = input_axes(cfg, shape)
    in_specs_tree = input_specs(cfg, shape)
    batch = distribute_tree(in_specs_tree, tree_shardings(in_ax, in_specs_tree, mesh, sharding_overrides), mesh)
    params = distribute_tree(params_shapes, tree_shardings(param_axes, params_shapes, mesh, sharding_overrides), mesh)

    with use_mesh(mesh, rules=sharding_overrides), implicit_replication(), torch.no_grad():
        if shape.kind == "train":
            opt = {
                "m": _f32_meta(params_shapes),
                "v": _f32_meta(params_shapes),
                "step": torch.empty((), dtype=torch.int32, device="meta"),
            }
            state_axes = opt_axes(param_axes)
            opt = distribute_tree(opt, tree_shardings(state_axes["opt"], opt, mesh, sharding_overrides), mesh)
            state = {"params": params, "opt": opt}
            args = (state, batch)
            step_fn = make_train_step(cfg, AdamWConfig())
        elif shape.kind == "prefill":
            args = (params, batch)
            step_fn = make_prefill_step(cfg, max_seq=shape.seq_len)
        else:  # decode
            args = (params, batch["token"], batch["cache"])
            step_fn = make_decode_step(cfg)
        arg_bytes = _local_bytes(args)
        t_lower = time.time()
        with CollectiveBytesMode() as comm, DeviceCostMode() as cost:
            out = step_fn(*args)
        t_trace = time.time()
        out_bytes = _local_bytes(out)
        coll = collective_bytes(comm)
    by_site = {}
    for site in sorted(set(cost.by_site) | set(coll["_by_site"])):
        part = cost.by_site.get(site, {"flops": 0, "bytes": 0})
        by_site[site] = {"flops": float(part["flops"]), "bytes": float(part["bytes"]),
                         "collective_bytes": coll["_by_site"].get(site, 0)}

    flops_dev = float(cost.flops)
    bytes_dev = float(cost.bytes)
    terms = roofline_terms(flops_dev, bytes_dev, float(coll["_total"]))
    # MODEL_FLOPS from the EXACT param count scaled by the analytic
    # active/total ratio (MoE); dense archs have ratio 1
    active_ratio = cfg.active_params() / max(cfg.n_params(), 1)
    mf = model_flops(cfg, shape) / max(cfg.active_params(), 1) * (record["n_params_exact"] * active_ratio)
    record.update(
        status="ok",
        n_chips=n_chips,
        setup_s=t_lower - t_start,
        trace_s=t_trace - t_lower,
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll["_total"],
        collectives={k: v for k, v in coll.items() if not k.startswith("_")},
        collective_counts=coll["_counts"],
        by_site=by_site,
        roofline=terms,
        model_flops_global=mf,
        model_flops_per_device=mf / n_chips,
        useful_flops_ratio=(mf / n_chips) / flops_dev if flops_dev else None,
        memory_analysis={
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": None,
            "peak_memory_in_bytes": None,
        },
    )
    return record


def _f32_meta(tree):
    """A new meta tensor of each tensor's shape, float32 where it is floating
    (the AdamW moments)."""
    import torch

    from repro_torch.tree import tree_map

    return tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32 if t.is_floating_point() else t.dtype,
                                          device="meta"), tree)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS)
    ap.add_argument("--shape", choices=ALL_SHAPES)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every cell in subprocesses")
    ap.add_argument("-j", "--jobs", type=int, default=2)
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None, help="directory of the cell records (default: RESULTS_DIR)")
    ap.add_argument("--tag", default="", help="perf-experiment tag (separate result file)")
    ap.add_argument("--set", dest="sets", action="append", default=[], help="cfg override key=value (e.g. loss_impl=lse)")
    ap.add_argument("--rule", dest="rules", action="append", default=[], help="sharding rule logical=ax1,ax2 (e.g. head_dim=model)")
    args = ap.parse_args(argv)

    cfg_overrides = {}
    for kv in args.sets:
        k, _, v = kv.partition("=")
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        cfg_overrides[k] = v
    rule_overrides = {}
    for kv in args.rules:
        k, _, v = kv.partition("=")
        rule_overrides[k] = tuple(x for x in v.split(",") if x)

    args.out = args.out or RESULTS_DIR
    if args.summary:
        return summary(args.out)

    if args.all:
        return run_all(args)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    rc = 0
    for mk in meshes:
        cell_key = f"{args.arch}__{args.shape}__{mk}" + (f"__{args.tag}" if args.tag else "")
        path = os.path.join(args.out, f"{cell_key}.json")
        os.makedirs(args.out, exist_ok=True)
        if os.path.exists(path) and not args.force:
            print(f"cached: {path}")
            continue
        try:
            rec = run_cell(args.arch, args.shape, mk, sharding_overrides=rule_overrides or None,
                           cfg_overrides=cfg_overrides or None, tag=args.tag)
        except Exception as e:  # a cell that fails is recorded, as the reference records it
            rec = {
                "arch": args.arch,
                "shape": args.shape,
                "mesh": mk,
                "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            rc = 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(
                f"OK  {args.arch:24s} {args.shape:12s} {mk:6s} chips={rec['n_chips']} "
                f"trace={rec['trace_s']:.1f}s compute={r['compute_s']:.3e}s "
                f"memory={r['memory_s']:.3e}s collective={r['collective_s']:.3e}s bound={r['bound']}"
            )
            print("  memory_analysis:", json.dumps(rec["memory_analysis"]))
            print(f"  traced cost: flops/dev={rec['flops_per_device']:.3e} bytes/dev={rec['bytes_per_device']:.3e}")
        else:
            print(f"{rec['status'].upper()} {args.arch} {args.shape} {mk}: {rec.get('reason', rec.get('error'))}")
    return rc


def run_all(args):
    import subprocess

    cells = []
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch in ASSIGNED_ARCHS:
        for shape in ALL_SHAPES:
            for mk in meshes:
                path = _cell_path(args.out, arch, shape, mk)
                if os.path.exists(path) and not args.force:
                    continue
                if cell_skip_reason(arch, shape):
                    with open(path, "w") as f:
                        json.dump(
                            {"arch": arch, "shape": shape, "mesh": mk, "status": "skip",
                             "reason": cell_skip_reason(arch, shape)}, f, indent=1)
                    continue
                cells.append((arch, shape, mk))
    print(f"{len(cells)} cells to run, {args.jobs} workers")
    procs: list = []
    rc = 0
    env = dict(os.environ, OMP_NUM_THREADS="1")
    while cells or procs:
        while cells and len(procs) < args.jobs:
            arch, shape, mk = cells.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", mk,
                   "--out", args.out]
            if args.force:
                cmd.append("--force")
            p = subprocess.Popen(cmd, env=env)
            procs.append((p, (arch, shape, mk), time.time()))
        for p, cell, t0 in list(procs):
            if p.poll() is None and time.time() - t0 > CELL_TIMEOUT_S:
                p.kill()
                p.wait()
                with open(_cell_path(args.out, *cell), "w") as f:
                    json.dump({"arch": cell[0], "shape": cell[1], "mesh": cell[2], "status": "error",
                               "error": f"TimeoutError: the trace ran past {CELL_TIMEOUT_S} s"}, f, indent=1)
            if p.poll() is not None:
                procs.remove((p, cell, t0))
                if p.returncode != 0:
                    rc = 1
                    print("FAILED:", cell)
        time.sleep(0.5)
    return rc


def summary(out_dir=None):
    out_dir = out_dir or RESULTS_DIR
    rows = []
    for fn in sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []:
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                rows.append(json.load(f))
    print(f"{'arch':24s} {'shape':12s} {'mesh':6s} {'status':6s} {'bound':10s} "
          f"{'compute_s':>11s} {'memory_s':>11s} {'coll_s':>11s} {'useful%':>8s}  at cost sites: coll% / bytes%")
    for r in rows:
        if r["status"] != "ok":
            print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} {r['status']:6s} {r.get('reason', r.get('error', ''))[:60]}")
            continue
        t = r["roofline"]
        useful = r.get("useful_flops_ratio")
        coll, moved = r["collective_bytes_per_device"], r["bytes_per_device"]
        sites = " ".join(f"{name} {100 * part['collective_bytes'] / coll if coll else 0:.1f} / "
                         f"{100 * part['bytes'] / moved if moved else 0:.1f}"
                         for name, part in r.get("by_site", {}).items())
        print(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} {r['status']:6s} {t['bound']:10s} "
            f"{t['compute_s']:11.3e} {t['memory_s']:11.3e} {t['collective_s']:11.3e} "
            f"{100*useful if useful else 0:7.1f}%  {sites}"
        )
    counts = {}
    for r in rows:
        counts[r["status"]] = counts.get(r["status"], 0) + 1
    print("cells by status: " + json.dumps(counts, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
