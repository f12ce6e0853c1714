"""Assemble Markdown tables from the port's dry-run result JSONs — the port
of ``repro.roofline.report``.

    PYTHONPATH=src python -m repro_torch.roofline.report [--json]

Reads ``launch.dryrun.RESULTS_DIR`` and emits the §Dry-run table (traced
per-device bytes, flops and collectives per cell; peak memory has no
counterpart without a compiler, so it prints "-"), the §Roofline table
(3 terms on the H100 + bound + useful-flops ratio, single-pod), and a §Perf
comparison for every tagged experiment vs its baseline cell.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR

ARCH_ORDER = [
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
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load() -> list:
    rows = []
    if not os.path.isdir(RESULTS_DIR):
        return rows
    for fn in sorted(os.listdir(RESULTS_DIR)):
        if fn.endswith(".json"):
            with open(os.path.join(RESULTS_DIR, fn)) as f:
                r = json.load(f)
                r["_file"] = fn
                rows.append(r)
    key = lambda r: (
        ARCH_ORDER.index(r["arch"]) if r["arch"] in ARCH_ORDER else 99,
        SHAPE_ORDER.index(r["shape"]) if r["shape"] in SHAPE_ORDER else 99,
        r["mesh"],
        r.get("tag", ""),
    )
    rows.sort(key=key)
    return rows


def fmt_b(n) -> str:
    if n is None:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(n) >= div:
            return f"{n/div:.2f}{unit}"
    return f"{n:.0f}B"


def fmt_s(x) -> str:
    return f"{x:.3e}" if x is not None else "-"


def dryrun_table(rows) -> str:
    out = [
        "| arch | shape | mesh | status | chips | trace_s | args/dev | peak/dev | flops/dev | bytes/dev | coll bytes/dev | collectives (AR/AG/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("tag"):
            continue
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP | - | - | - | - | - | - | - | {r['reason'][:48]} |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | - | - | - | - | - | - | - | {r.get('error','')[:48]} |")
            continue
        m = r.get("memory_analysis", {})
        cc = r.get("collective_counts", {})
        cnt = "/".join(str(cc.get(k, 0)) for k in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {r['n_chips']} | {r['trace_s']:.0f} | "
            f"{fmt_b(m.get('argument_size_in_bytes'))} | {fmt_b(m.get('peak_memory_in_bytes'))} | "
            f"{r['flops_per_device']:.2e} | {fmt_b(r['bytes_per_device'])} | {fmt_b(r['collective_bytes_per_device'])} | {cnt} |"
        )
    return "\n".join(out)


def roofline_table(rows) -> str:
    out = [
        "| arch | shape | compute_s | memory_s | collective_s | bound | MODEL_FLOPS | useful% | one-line lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("tag") or r["mesh"] != "single":
            continue
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | SKIP | - | - | {r['reason'][:40]} |")
            continue
        if r["status"] != "ok":
            continue
        t = r["roofline"]
        u = r.get("useful_flops_ratio") or 0.0
        lever = _lever(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} | {fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['bound']}** | {r['model_flops_global']:.2e} | {100*u:.0f}% | {lever} |"
        )
    return "\n".join(out)


def _lever(r) -> str:
    t = r["roofline"]
    b = t["bound"]
    if b == "memory":
        if r["kind"] == "decode":
            return "shard the KV cache further (head_dim/seq) to cut per-step reads"
        return "cut materialized fp32 tensors (loss lse, remat=dots)"
    if b == "collective":
        return "replace gathered scatter with all-to-all dispatch / resharding fix"
    return "already compute-bound; raise arithmetic intensity per chip"


def perf_table(rows) -> str:
    base = {}
    for r in rows:
        if not r.get("tag") and r["status"] == "ok":
            base[(r["arch"], r["shape"], r["mesh"])] = r
    out = [
        "| arch | shape | tag | Δcompute | Δmemory | Δcollective | bound | notes |",
        "|---|---|---|---|---|---|---|---|",
    ]
    any_row = False
    for r in rows:
        if not r.get("tag") or r["status"] != "ok":
            continue
        b = base.get((r["arch"], r["shape"], r["mesh"]))
        if b is None:
            continue
        any_row = True
        t, tb = r["roofline"], b["roofline"]

        def delta(k):
            if tb[k] == 0:
                return "-"
            return f"{(t[k]/tb[k]-1)*100:+.1f}%"

        ov = {**r.get("cfg_overrides", {}), **r.get("sharding_overrides", {})}
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['tag']} | {delta('compute_s')} | {delta('memory_s')} | "
            f"{delta('collective_s')} | {t['bound']} | {ov} |"
        )
    return "\n".join(out) if any_row else "(no tagged perf runs yet)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = load()
    if args.json:
        print(json.dumps(rows, indent=1))
        return
    print("## §Dry-run\n")
    print(dryrun_table(rows))
    print("\n## §Roofline (single-pod, 256 ranks, H100 rates)\n")
    print(roofline_table(rows))
    print("\n## §Perf (tagged experiments vs baseline)\n")
    print(perf_table(rows))


if __name__ == "__main__":
    main()
