"""Perf hillclimb: baseline + named variants for one cell (port of
``src/repro/launch/perf.py``).

Each variant runs the cell's dry-run (``launch/dryrun.py`` ``run_cell``:
rank 0's step counted on ``meta`` over a stand-in of the production
mesh) with other Strategy/PerfOpts levers, and reports the three roofline
terms on the H100's peaks and the per-device memory; ``--out`` appends
each record as a JSON line.

  python -m repro_torch.launch.perf --cell llama3-405b:train_4k \\
      --variants baseline,seq_parallel,mb32,mb32+sp,compress
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

from repro_torch.launch import dryrun
from repro_torch.sharding.strategies import PerfOpts

VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    "seq_parallel": {"perf": PerfOpts(seq_parallel=True)},
    "compress": {"perf": PerfOpts(compress_grads=True)},
    "sp+compress": {"perf": PerfOpts(seq_parallel=True, compress_grads=True)},
    "mb16": {"perf": PerfOpts(microbatches=16)},
    "mb8": {"perf": PerfOpts(microbatches=8)},
    "mb4": {"perf": PerfOpts(microbatches=4)},
    "mb32": {"perf": PerfOpts(microbatches=32)},
    "mb64": {"perf": PerfOpts(microbatches=64)},
    "mb32+sp": {"perf": PerfOpts(microbatches=32, seq_parallel=True)},
    "mb64+sp": {"perf": PerfOpts(microbatches=64, seq_parallel=True)},
    "mb64+sp+compress": {"perf": PerfOpts(microbatches=64, seq_parallel=True,
                                          compress_grads=True)},
    "monolithic": {"strategy_name": "monolithic"},
    "kv_model": {"perf": PerfOpts(kv_seq_override=("model",))},
    "kv_data_model": {"perf": PerfOpts(kv_seq_override=("data", "model"))},
    "moe_a2a": {"perf": PerfOpts(moe_a2a=True)},
    "kv_f8": {"perf": PerfOpts(kv_dtype="f8")},
    "moe_a2a+kv_f8": {"perf": PerfOpts(moe_a2a=True, kv_dtype="f8")},
    "a2a+mb16": {"perf": PerfOpts(moe_a2a=True, microbatches=16)},
    "a2a+mb16+f8d": {"perf": PerfOpts(moe_a2a=True, microbatches=16,
                                      f8_dispatch=True)},
    "a2a+f8d+kv_f8": {"perf": PerfOpts(moe_a2a=True, f8_dispatch=True,
                                       kv_dtype="f8")},
    "a2a+sp": {"perf": PerfOpts(moe_a2a=True, seq_parallel=True)},
    "a2a+sp+compress": {"perf": PerfOpts(moe_a2a=True, seq_parallel=True,
                                         compress_grads=True)},
}


def run_variant(arch: str, shape: str, name: str, *, multi_pod: bool,
                out: Optional[str]) -> Dict:
    kw = dict(VARIANTS[name])
    try:
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              strategy_name=kw.pop("strategy_name", "auto"),
                              verbose=False, **kw)
    except Exception as e:  # a variant the strategy refuses, or a fault
        rec = {"arch": arch, "shape": shape, "ok": False,
               "error": f"{type(e).__name__}: {e}"}
    rec["variant"] = name
    if rec.get("ok"):
        r = rec["roofline"]
        m = rec["memory"]
        fit = (m["argument_bytes"] or 0) + (m["temp_bytes"] or 0)
        print(f"{arch} x {shape} [{name:>18}]: "
              f"compute {r['t_compute']:.3e}  memory {r['t_memory']:.3e}  "
              f"collective {r['t_collective']:.3e}  -> {r['dominant']:>10} | "
              f"hbm {fit / 2 ** 30:5.1f} GiB/dev | "
              f"frac {r['roofline_fraction'] * 100:5.1f}%")
    else:
        print(f"{arch} x {shape} [{name:>18}]: FAIL "
              f"{rec.get('error', rec.get('reason', ''))[:100]}")
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None,
                    help="append JSON records here (default: none)")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    for name in args.variants.split(","):
        run_variant(arch, shape, name.strip(), multi_pod=args.multi_pod,
                    out=args.out)


if __name__ == "__main__":
    main()
