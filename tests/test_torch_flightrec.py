"""The port's flight recorder and deterministic replay against the JAX
package's.

* one session (elastic rebalancing, the prefix cache, K=4 decode, a
  cancel from an ``on_token`` callback, ``reset_stats``) through a live
  JAX engine and the port's engine, both fed one synthetic dispatch-time
  stream: the flight records' events, snapshots, streams and final
  accounting are EQUAL (header fields aside), in both lowering modes;
* the port's record replays bit-exactly in the port, in both lowering
  modes, and in a fresh process through ``python -m
  repro_torch.launch.replay --device cpu``;
* each ``inject_corruption`` kind trips the same sanitizer rule at the
  same step as in the JAX engine, auto-dumps an incident record, and the
  replay reproduces it;
* record hygiene: causal drops are refused, the version is checked.

Tolerance: equality everywhere — token ids, virtual times folded from
the same dt stream, and integer pool counters.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.analysis.sanitizer import PoolSanitizerError as JSanError
from repro.configs import CacheConfig as JCache
from repro.configs import ElasticConfig as JElastic
from repro.configs import EngineConfig as JConfig
from repro.configs import FlightRecorderConfig as JRec
from repro.configs import SLObjective as JObjective
from repro.configs import SLOConfig as JSLO
from repro.configs import get_smoke_config
from repro.models import build_model
from repro.runtime import flightrec as j_flightrec
from repro.runtime.engine import CrossPoolEngine as JEngine
from repro.runtime.engine import EngineMode as JMode
from repro.runtime.request import Request as JRequest
from repro_torch.analysis.sanitizer import PoolSanitizerError
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import (CacheConfig, ElasticConfig,
                                      EngineConfig, FlightRecorderConfig,
                                      SLObjective, SLOConfig)
from repro_torch.launch import replay as replay_mod
from repro_torch.runtime import flightrec
from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
from repro_torch.runtime.request import Request

MOE, MLA = "qwen3-moe-235b-a22b", "minicpm3-4b"
ROOT = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(page_budget=2048, page_bytes=4096, slab_bytes=4096,
                 max_batch=2, max_ctx=64, seed=0)
#: the record's parts a replay (or the other package) must reproduce
COMPARED = ("events", "snapshots", "streams", "final", "failure", "dropped")


def _config(pkg, lowering, *, slo=False, sanitize=False, dump_path=None):
    """The same EngineConfig in either package (``pkg`` "j" or "t")."""
    Cfg, Mode, Elastic, Cache, Rec, SLO, Obj = (
        (JConfig, JMode, JElastic, JCache, JRec, JSLO, JObjective)
        if pkg == "j" else
        (EngineConfig, EngineMode, ElasticConfig, CacheConfig,
         FlightRecorderConfig, SLOConfig, SLObjective))
    return Cfg(
        mode=Mode(pipeline=True, lowering=lowering,
                  decode_steps_per_dispatch=4),
        elastic=Elastic(interval_steps=2, cooldown_steps=2, window_s=8.0),
        cache=Cache(enabled=True), sanitize=sanitize,
        slo=(SLO(objectives={MOE: Obj(ttft_ms=1e-3, tbt_p99_ms=1e-3)},
                 window_s=4.0, short_window_s=0.5) if slo else None),
        flightrec=Rec(ring_size=65536, snapshot_interval_steps=2,
                      dump_path=dump_path))


@pytest.fixture(scope="module")
def params():
    """The reference's init params (what the JAX engine draws for
    itself), bridged to the port's layout."""
    models = {n: get_smoke_config(n).replace(dtype="float32")
              for n in (MOE, MLA)}
    return {n: params_to_torch(jax.tree.map(
        np.asarray, build_model(c).init(jax.random.PRNGKey(i))))
        for i, (n, c) in enumerate(models.items())}


def _j_engine(lowering, **cfg_kw):
    models = {n: get_smoke_config(n).replace(dtype="float32")
              for n in (MOE, MLA)}
    return JEngine(models, config=_config("j", lowering, **cfg_kw),
                   **ENGINE_KW)


def _t_engine(lowering, params=None, **cfg_kw):
    models = {n: t_smoke(n).replace(dtype="float32") for n in (MOE, MLA)}
    return CrossPoolEngine(models, config=_config("t", lowering, **cfg_kw),
                           device="cpu", params=params, **ENGINE_KW)


def synthetic_clock(engine):
    """Feed ``engine`` a synthetic dispatch-time stream (4-8 ms, in a
    fixed cycle) instead of the host clock; its recorder logs the stream
    with the tags the engine asked for, which the other engine then
    replays.  Test harness only: it stands in for the engine's replay
    clock."""
    count = [0]

    def next_dt(tag):
        count[0] += 1
        return 0.004 + 0.001 * (count[0] % 5)

    engine._replay_dts = ()
    engine._next_replay_dt = next_dt


def _requests(pkg, vocab):
    """Real prompt ids with a shared per-model system prefix (the radix
    cache gets hits), from a fixed seed."""
    Req = JRequest if pkg == "j" else Request
    rng = np.random.default_rng(7)
    system = {n: rng.integers(0, vocab[n], 32).astype(np.int32)
              for n in (MOE, MLA)}

    def mk(rid, model, n_prompt, n_new, t):
        tail = rng.integers(0, vocab[model],
                            max(0, n_prompt - 32)).astype(np.int32)
        ids = np.concatenate([system[model], tail])[:n_prompt]
        return Req(rid, model, n_prompt, n_new, t,
                   prompt_ids=ids.astype(np.int32))

    return [mk(0, MOE, 40, 6, 0.0), mk(1, MLA, 36, 6, 0.0),
            mk(2, MOE, 40, 12, 0.1),       # shares r0's full prompt
            mk(3, MLA, 44, 6, 0.3), mk(4, MOE, 38, 4, 0.5)]


def drive(engine, pkg):
    """Staggered submits, K=4 decode, a cancel landing mid-decode from an
    ``on_token`` callback, a stats reset, a drain to quiescence and a
    terminal cancel (still an op)."""
    vocab = {n: engine.models[n].vocab_size for n in (MOE, MLA)}
    reqs = _requests(pkg, vocab)
    engine.submit(reqs[0])
    engine.submit(reqs[1])
    engine.step(0.05)
    engine.advance(0.1)
    engine.submit(reqs[2])
    victim = engine.submit(reqs[3],
                           on_token=lambda ev: engine.cancel(victim))
    engine.step()
    engine.reset_stats()
    h4 = engine.submit(reqs[4])
    for _ in range(40):
        if not (engine.waiting or engine._any_active()):
            break
        engine.step()
    engine.cancel(h4)
    engine.finalize()
    return reqs


def _normalized(engine) -> dict:
    return json.loads(json.dumps(engine.recorder.to_record()))


@pytest.fixture(scope="module", params=[True, False],
                ids=["lowered", "host"])
def sessions(request, params):
    """(JAX record, port record, JAX requests, port requests) of one
    session under one synthetic dt stream."""
    lowering = request.param
    je = _j_engine(lowering, slo=True, sanitize=True)
    synthetic_clock(je)
    j_reqs = drive(je, "j")
    j_record = _normalized(je)
    te = _t_engine(lowering, params, slo=True, sanitize=True)
    te.attach_replay_clock(flightrec.record_clock(j_record))
    t_reqs = drive(te, "t")
    assert not te._replay_dts, "the port consumed the whole dt stream"
    return j_record, _normalized(te), j_reqs, t_reqs


@pytest.mark.parametrize("part", COMPARED)
def test_record_equals_live_jax_engine(sessions, part):
    """Events (ops, clock, commits, rebalance decisions, cache / swap
    traffic, admissions, SLO breaches), snapshots, streams and final
    accounting: equal to the JAX engine's record."""
    j_record, t_record, _, _ = sessions
    assert t_record[part] == j_record[part]


def test_session_exercises_every_path(sessions):
    """The shared session really hits the cache, breaches an SLO and
    cancels, and the token streams are equal (a session with boundary
    moves: ``test_torch_observe.py``)."""
    j_record, t_record, j_reqs, t_reqs = sessions
    kinds = {e["kind"] for e in t_record["events"]}
    assert {"op", "clock", "commit", "cache_hit", "slo_breach",
            "admission"} <= kinds
    ops = {e["op"] for e in t_record["events"] if e["kind"] == "op"}
    assert {"submit", "step", "advance", "cancel", "reset_stats"} <= ops
    assert t_record["snapshots"] and t_record["streams"]
    assert [r.output_ids for r in t_reqs] == [r.output_ids for r in j_reqs]
    assert t_record["version"] == j_record["version"] == \
        flightrec.RECORD_VERSION


@pytest.mark.parametrize("lowering", [True, False], ids=["lowered", "host"])
def test_record_replay_bit_exact(lowering):
    """A record made by the port (weights from its own seed) replays
    bit-exactly in a fresh port engine."""
    engine = _t_engine(lowering, slo=True)
    drive(engine, "t")
    record = _normalized(engine)
    assert not flightrec.causal_drops(record)
    report = replay_mod.replay(record, device="cpu")
    assert report.ok, report.mismatches
    assert report.tokens > 0 and report.steps > 0
    assert "BIT-EXACT" in report.summary()


def test_replay_fresh_process(tmp_path):
    engine = _t_engine(True)
    drive(engine, "t")
    path = tmp_path / "flight.json"
    engine.recorder.dump(str(path))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replay", str(path),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BIT-EXACT" in proc.stdout


def _corrupt(engine, module, kind, pkg):
    vocab = {n: engine.models[n].vocab_size for n in (MOE, MLA)}
    reqs = _requests(pkg, vocab)
    engine.submit(reqs[0])
    engine.submit(reqs[2])     # 12 new tokens: still decoding at injection
    engine.step(0.05)
    engine.step()
    module.inject_corruption(engine, kind)


@pytest.mark.parametrize("kind", flightrec.INJECTION_KINDS)
def test_corruption_trips_the_jax_rule_and_replays(tmp_path, kind):
    """The same corruption at the same point trips the same rule, with
    the same message, at the same step in both packages (page accounting
    is host state: the weights do not enter it); the port's incident
    record auto-dumps and replays to the same failure, bit-exactly."""
    assert flightrec.INJECTION_KINDS == j_flightrec.INJECTION_KINDS
    je = _j_engine(True, sanitize=True)
    synthetic_clock(je)
    _corrupt(je, j_flightrec, kind, "j")
    with pytest.raises(JSanError) as j_exc:
        je.step()
    path = tmp_path / f"incident_{kind}.json"
    te = _t_engine(True, sanitize=True, dump_path=str(path))
    te.attach_replay_clock(flightrec.record_clock(_normalized(je)))
    _corrupt(te, flightrec, kind, "t")
    with pytest.raises(PoolSanitizerError) as t_exc:
        te.step()
    assert t_exc.value.rule == j_exc.value.rule
    assert te._step_index == je._step_index
    assert str(t_exc.value) == str(j_exc.value)
    assert path.exists(), "the incident auto-dumps the black box"
    record = replay_mod.load_record(str(path))
    assert record["failure"] == _normalized(je)["failure"]
    report = replay_mod.replay(record, device="cpu")
    assert report.failure_reproduced, report.mismatches
    assert report.ok, report.mismatches


def test_replay_refuses_causal_drops(tmp_path):
    engine = _t_engine(True)
    record = engine.recorder.to_record()
    record["dropped"] = {"op": 3, "cache_hit": 5}
    path = tmp_path / "dropped.json"
    path.write_text(json.dumps(record))
    with pytest.raises(replay_mod.ReplayError, match="causal"):
        replay_mod.load_record(str(path))
    # informational drops alone are fine: the causal stream is intact
    record["dropped"] = {"cache_hit": 5}
    path.write_text(json.dumps(record))
    assert replay_mod.load_record(str(path))["dropped"] == {"cache_hit": 5}


def test_record_version_guard(tmp_path):
    engine = _t_engine(True)
    record = engine.recorder.to_record()
    record["version"] = 999
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(record))
    with pytest.raises(replay_mod.ReplayError, match="version"):
        replay_mod.load_record(str(path))


def test_replay_divergence_on_a_short_clock_stream():
    """A stream that runs out before the session does is a divergence,
    not a silent fall back to the host clock."""
    engine = _t_engine(True)
    drive(engine, "t")
    record = _normalized(engine)
    record["events"] = [e for e in record["events"]
                        if e["kind"] != "clock"][:] + [
        e for e in record["events"] if e["kind"] == "clock"][:1]
    with pytest.raises(flightrec.ReplayDivergence):
        replay_mod.replay(record, device="cpu")
