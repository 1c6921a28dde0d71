"""Deterministic session replay:
``python -m repro_torch.launch.replay flight.json [--device cpu]``.

Port of ``src/repro/launch/replay.py``.  Runs on the card unless
``--device cpu`` is given; replay a record on the device it was made on
(the engine draws its weights on its device, and the card's kernels
round differently from the plain versions).

Reconstructs the engine (models, ``EngineConfig``, pool geometry) from a
flight record (``runtime.flightrec``), re-drives the recorded op stream
with the recorded virtual clock injected, re-records the replay with its
own flight recorder, and diffs the two records:

  * **token streams** — every request's token ids AND virtual emission
    times, bit-exact (JSON round-trips Python floats exactly);
  * **event ring** — ops, clock reads, commits, rebalance decisions,
    cache/swap traffic, SLO breaches: the whole causal + derived stream;
  * **snapshots + final pool accounting** — page holder classes, slab
    residency, refcounts;
  * **failure** — an incident record (sanitizer/accounting error) must
    reproduce the SAME error type and rule at the SAME step.

Determinism argument (DESIGN.md §13): the engine's only nondeterministic
input is ``time.perf_counter`` at its dispatch-duration sites, and those
are injected from the record.  Everything else — params from
``torch.Generator(seed + i)`` in model-dict order, synthetic prompt ids
drawn from the fixed-seed engine rng at batcher selection, planner Monte
Carlo on a fixed seed, telemetry folds — is a pure function of the op
stream, and on a card so are the kernels' results: the replay dispatches
the same shapes in the same order, every kernel's work split depends on
shapes only, and the sampling is greedy.

Exit status: 0 on a bit-exact replay (including a reproduced failure),
1 on any mismatch.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.analysis.sanitizer import PoolSanitizerError
from repro_torch.core.errors import PoolAccountingError
from repro_torch.runtime import flightrec
from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
from repro_torch.runtime.request import Request


class ReplayError(RuntimeError):
    """The record cannot be replayed at all (vs. replaying and
    mismatching): causal events were dropped from the bounded ring, or
    the record is structurally invalid."""


@dataclass
class ReplayReport:
    ok: bool
    mismatches: List[str] = field(default_factory=list)
    ops: int = 0
    steps: int = 0
    tokens: int = 0
    failure_reproduced: Optional[bool] = None   # None: healthy record

    def summary(self) -> str:
        verdict = "BIT-EXACT" if self.ok else "MISMATCH"
        line = (f"replay {verdict}: {self.ops} ops, {self.steps} steps, "
                f"{self.tokens} tokens")
        if self.failure_reproduced is not None:
            line += (", failure reproduced" if self.failure_reproduced
                     else ", failure NOT reproduced")
        return line


def load_record(path: str) -> Dict[str, Any]:
    with open(path) as f:
        record = json.load(f)
    version = record.get("version")
    if version != flightrec.RECORD_VERSION:
        raise ReplayError(f"record version {version!r} != "
                          f"{flightrec.RECORD_VERSION}")
    drops = flightrec.causal_drops(record)
    if drops:
        raise ReplayError(
            f"causal events were dropped from the bounded ring {drops}; "
            f"re-record with a larger FlightRecorderConfig.ring_size")
    return record


def build_engine(record: Dict[str, Any], device="cuda") -> CrossPoolEngine:
    """Engine bit-identical to the recorded one: same model dict order
    (params come from ``torch.Generator(seed + i)`` in that order), same
    pool geometry, same config — recorder ON (for the re-record diff)
    but never auto-dumping."""
    h = record["engine"]
    models = {name: flightrec.model_config_from_dict(d)
              for name, d in h["models"].items()}
    config = flightrec.engine_config_from_header(h, dump_path=None)
    config = config.__class__(
        mode=EngineMode(**h["mode"]), elastic=config.elastic,
        cache=config.cache, sanitize=config.sanitize, slo=config.slo,
        flightrec=config.flightrec)
    return CrossPoolEngine(
        models, page_budget=h["page_budget"], page_bytes=h["page_bytes"],
        slot_budget=h["slot_budget"], slab_bytes=h["slab_bytes"],
        max_batch=h["max_batch"], max_ctx=h["max_ctx"], seed=h["seed"],
        config=config, device=device)


def _request_from_dict(d: Dict[str, Any]) -> Request:
    ids = d["prompt_ids"]
    return Request(
        request_id=d["request_id"], model=d["model"],
        prompt_tokens=d["prompt_tokens"],
        max_new_tokens=d["max_new_tokens"],
        arrival_time=d["arrival_time"],
        prompt_ids=(None if ids is None
                    else np.asarray(ids, dtype=np.int32)),
        eos_id=d["eos_id"], cache=d["cache"])


def _apply_op(engine: CrossPoolEngine, op: Dict[str, Any]) -> None:
    kind = op["op"]
    if kind == "submit":
        # set the clock directly (advance() would record an extra op the
        # original stream does not have); submit re-records the op
        engine.now = max(engine.now, float(op["now"]))
        engine.submit(_request_from_dict(op["request"]))
    elif kind == "step":
        engine.step(op["now"])
    elif kind == "advance":
        engine.advance(op["now"])
    elif kind == "cancel":
        engine.now = max(engine.now, float(op["now"]))
        if op["rid"] in engine.handles:
            engine.cancel(op["rid"])
    elif kind == "reset_stats":
        engine.reset_stats()
    elif kind == "inject":
        flightrec.inject_corruption(engine, op["corruption"])
    else:
        raise ReplayError(f"unknown op kind {kind!r}")


def _normalize(obj: Any) -> Any:
    """JSON round-trip: the loaded record went through it, so the
    re-recorded one must too before a deep-equality diff (tuples become
    lists, dict keys become strings, floats stay bit-exact)."""
    return json.loads(json.dumps(obj))


def _strip_in_step(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Cancel ops lose their ``in_step`` flag before diffing: a cancel
    issued from inside an ``on_token`` callback was DEFERRED to the step
    boundary in the original, and the replayer (which does not re-drive
    user callbacks) applies it just after the step — the end state is
    identical, only this flag differs (DESIGN.md §13)."""
    out = []
    for e in events:
        if e["kind"] == "op" and e.get("op") == "cancel":
            e = {k: v for k, v in e.items() if k != "in_step"}
        out.append(e)
    return out


def _diff(name: str, got: Any, want: Any, mismatches: List[str]) -> None:
    if got == want:
        return
    detail = ""
    if isinstance(got, list) and isinstance(want, list):
        if len(got) != len(want):
            detail = f" (length {len(got)} vs {len(want)})"
        else:
            for i, (g, w) in enumerate(zip(got, want)):
                if g != w:
                    detail = f" (first divergence at [{i}]: {g!r} != {w!r})"
                    break
    elif isinstance(got, dict) and isinstance(want, dict):
        keys = [k for k in set(got) | set(want)
                if got.get(k) != want.get(k)]
        detail = f" (diverging keys: {sorted(keys)[:4]})"
    mismatches.append(f"{name} mismatch{detail}")


def replay(record: Dict[str, Any], device="cuda") -> ReplayReport:
    """Re-drive the record and diff the re-recorded session against it."""
    engine = build_engine(record, device)
    engine.attach_replay_clock(flightrec.record_clock(record))
    ops = flightrec.record_ops(record)
    report = ReplayReport(ok=False, ops=len(ops))
    failure_seen: Optional[Dict[str, Any]] = None
    for op in ops:
        try:
            _apply_op(engine, op)
        except (PoolSanitizerError, PoolAccountingError) as err:
            failure_seen = {
                "step": engine._step_index,
                "type": type(err).__name__,
                "rule": getattr(err, "rule", None),
            }
            break
    replayed = _normalize(engine.recorder.to_record())
    report.steps = engine._step_index
    report.tokens = sum(len(s["tokens"])
                        for s in replayed["streams"].values())

    mism = report.mismatches
    _diff("token streams", replayed["streams"], record["streams"], mism)
    _diff("event ring", _strip_in_step(replayed["events"]),
          _strip_in_step(record["events"]), mism)
    rb = [e for e in replayed["events"] if e["kind"] == "rebalance"]
    rb_want = [e for e in record["events"] if e["kind"] == "rebalance"]
    _diff("rebalance decisions", rb, rb_want, mism)
    _diff("pool snapshots", replayed["snapshots"], record["snapshots"],
          mism)
    _diff("final pool accounting", replayed["final"], record["final"],
          mism)
    want_failure = record.get("failure")
    if want_failure is not None:
        got = (None if failure_seen is None else
               {k: failure_seen[k] for k in ("step", "type", "rule")})
        want = {k: want_failure[k] for k in ("step", "type", "rule")}
        report.failure_reproduced = got == want
        if not report.failure_reproduced:
            mism.append(f"failure mismatch: replay {got!r} vs "
                        f"record {want!r}")
    elif failure_seen is not None:
        mism.append(f"replay failed where the record did not: "
                    f"{failure_seen!r}")
    if engine._replay_dts:
        mism.append(f"{len(engine._replay_dts)} recorded clock entries "
                    f"left unconsumed")
    report.ok = not mism
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="replay a CrossPool flight record and assert the "
                    "session reproduces bit-exactly")
    ap.add_argument("record", help="flight-record JSON "
                    "(serve --flight-record-out / auto-dump)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="summary line only")
    args = ap.parse_args(argv)

    record = load_record(args.record)
    h = record["engine"]
    if not args.quiet:
        print(f"record: {len(record['events'])} events, "
              f"{len(record['streams'])} streams, "
              f"{len(record['snapshots'])} snapshots, "
              f"models={list(h['models'])}")
        if record.get("failure"):
            f = record["failure"]
            print(f"incident record: {f['type']}"
                  f"{' rule ' + f['rule'] if f.get('rule') else ''} "
                  f"at step {f['step']}")
    report = replay(record, args.device)
    print(report.summary())
    for m in report.mismatches:
        print(f"  {m}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
