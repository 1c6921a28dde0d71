"""Turn dry-run JSONL records into the EXPERIMENTS.md roofline tables.

Port of ``src/repro/launch/report.py``: pure formatting over the JSONL
lines a dry-run writes (one record per (arch, shape) cell), so the
tables read the same from either package.  It touches no device.

  python -m repro_torch.launch.report cells.jsonl [--kind roofline]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def load(path: str) -> List[Dict]:
    out = []
    with open(path) as f:
        for line in f:
            out.append(json.loads(line))
    return out


def fmt_bytes(n) -> str:
    if n is None:
        return "-"
    return f"{n / 2 ** 30:.2f}"


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    return f"{x:.2e}"


def dryrun_table(records: List[Dict]) -> str:
    lines = [
        "| arch | shape | strategy | lower/compile s | args GiB/dev | "
        "temp GiB/dev | collectives (count) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | - | SKIP | - | - | "
                         f"{r['reason'][:48]} |")
            continue
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r.get('strategy')} "
                         f"| **FAIL** | - | - | {r.get('error', '')[:48]} |")
            continue
        m, rf = r["memory"], r["roofline"]
        coll = rf["collective_breakdown"]
        abbrev = {"all-gather": "ag", "all-reduce": "ar",
                  "reduce-scatter": "rs", "all-to-all": "a2a",
                  "collective-permute": "cp"}
        parts = [f"{abbrev.get(k, k)}:{v // 2 ** 20}M"
                 for k, v in coll.items()
                 if k != "count" and v > 0]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['strategy']} "
            f"| {r['lower_s']:.0f}/{r['compile_s']:.0f} "
            f"| {fmt_bytes(m['argument_bytes'])} "
            f"| {fmt_bytes(m['temp_bytes'])} "
            f"| {' '.join(parts) or '0'} ({coll['count']}) |")
    return "\n".join(lines)


def roofline_table(records: List[Dict]) -> str:
    lines = [
        "| arch | shape | strat | t_compute | t_memory | t_collective | "
        "dominant | useful-FLOPs | roofline-frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if not r.get("ok"):
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['strategy'][:5]} "
            f"| {fmt_s(rf['t_compute'])} | {fmt_s(rf['t_memory'])} "
            f"| {fmt_s(rf['t_collective'])} | **{rf['dominant']}** "
            f"| {rf['useful_flops_ratio'] * 100:.0f}% "
            f"| {rf['roofline_fraction'] * 100:.1f}% |")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    ap.add_argument("--kind", choices=["dryrun", "roofline"],
                    default="dryrun")
    args = ap.parse_args(argv)
    records = load(args.jsonl)
    if args.kind == "dryrun":
        print(dryrun_table(records))
    else:
        print(roofline_table(records))


if __name__ == "__main__":
    main()
