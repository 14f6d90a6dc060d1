"""Roofline report tables (port of ``repro.analysis.rooflines``):
aggregates the dry run's records, ``results/dryrun_torch/*.json``
(``python -m repro_torch.launch.dryrun``), into the §Dry-run and §Roofline
tables.  The same text as the reference's on the same records.

Usage:  PYTHONPATH=src python -m repro_torch.analysis.rooflines \
            [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname: str) -> list[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def fmt_s(x) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def dryrun_table(recs: list[dict], mesh: str | None = None) -> str:
    rows = ["| arch | shape | mesh | chips | params | param B/dev | peak mem/dev"
            " | HLO lines | compile | status |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for d in recs:
        if mesh and d.get("mesh") != mesh:
            continue
        if d.get("tag"):
            continue
        if not d.get("ok"):
            rows.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | - | - |"
                        f" - | - | - | - | FAIL: {d.get('error','')[:60]} |")
            continue
        mem = d.get("memory_analysis", {})
        peak = mem.get("peak_memory_in_bytes")
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {d['chips']} | "
            f"{d['param_count']/1e9:.2f}B | "
            f"{fmt_bytes(d['param_bytes_per_device'])} | "
            f"{fmt_bytes(peak)} | {d['hlo_lines']} | {d['compile_s']:.0f}s | OK |")
    return "\n".join(rows)


def roofline_table(recs: list[dict]) -> str:
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "step(max) | MODEL/HLO flops | note |",
            "|---|---|---|---|---|---|---|---|---|"]
    for d in recs:
        if d.get("mesh") != "single" or not d.get("ok") or d.get("tag"):
            continue
        r = d["roofline"]
        ratio = d.get("useful_flops_ratio")
        note = _bottleneck_note(d)
        rows.append(
            f"| {d['arch']} | {d['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"**{r['dominant']}** | {fmt_s(r['step_time_s'])} | "
            f"{ratio:.2f} | {note} |")
    return "\n".join(rows)


def _bottleneck_note(d: dict) -> str:
    r = d["roofline"]
    dom = r["dominant"]
    ratio = d.get("useful_flops_ratio") or 0
    if dom == "memory" and d["kind"] == "decode":
        return "decode streams params+cache; batch up or quantize cache"
    if dom == "memory" and ratio < 0.3:
        return "low useful-flop ratio: cut dispatch/replicated compute"
    if dom == "memory":
        return "fuse more / bf16 master weights to cut HBM traffic"
    if dom == "collective":
        return "overlap or shrink collectives (compression, 2D sharding)"
    return "compute-bound: near roofline; tune MXU tiling"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--what", default="both",
                    choices=["dryrun", "roofline", "both"])
    args = ap.parse_args()
    recs = load(args.dir)
    if args.what in ("dryrun", "both"):
        print("### Dry-run (single-pod)\n")
        print(dryrun_table(recs, "single"))
        print("\n### Dry-run (multi-pod 2x16x16)\n")
        print(dryrun_table(recs, "multi"))
    if args.what in ("roofline", "both"):
        print("\n### Roofline (single-pod, 256 chips)\n")
        print(roofline_table(recs))


if __name__ == "__main__":
    main()
