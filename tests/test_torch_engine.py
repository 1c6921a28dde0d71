"""The port's serving engine against a live JAX engine, and the port's
boundaries: what raises without a card, what is not ported yet, and the
rule that the port imports nothing of JAX or of the reference package.
"""
import ast
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import PAPER_COLOC_SET, get_smoke_config
from repro.models import build_model
from repro.runtime.engine import CrossPoolEngine as JEngine
from repro.runtime.engine import EngineMode as JMode
from repro.runtime.request import Request as JRequest
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import (EngineConfig, FlightRecorderConfig,
                                      SLObjective, SLOConfig)
from repro_torch.launch import serve
from repro_torch.runtime.engine import CrossPoolEngine as TEngine
from repro_torch.runtime.engine import EngineMode as TMode
from repro_torch.runtime.observe import EngineObserver
from repro_torch.runtime.request import Request as TRequest
from repro_torch.runtime.session import HandleState

MOE, MLA, MOON = "qwen3-moe-235b-a22b", "minicpm3-4b", "moonshot-v1-16b-a3b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACE = [(0, MOE, 6, 3), (1, MOE, 7, 3), (2, MOE, 9, 4), (3, MLA, 5, 3),
         (4, MLA, 6, 2), (5, MOON, 20, 3), (6, MOON, 40, 9), (7, MLA, 33, 7)]
ENGINE_KW = dict(page_budget=2048, page_bytes=4096, slab_bytes=4096,
                 max_batch=2, max_ctx=64, seed=0)


@pytest.fixture(scope="module")
def coloc():
    """(jax configs, torch configs, the reference's init params as numpy)
    — the very params the JAX engine draws for itself."""
    jm = {n: get_smoke_config(n).replace(dtype="float32")
          for n in PAPER_COLOC_SET}
    tm = {n: t_smoke(n).replace(dtype="float32") for n in PAPER_COLOC_SET}
    params = {n: jax.tree.map(np.asarray,
                              build_model(c).init(jax.random.PRNGKey(i)))
              for i, (n, c) in enumerate(jm.items())}
    return jm, tm, params


def _torch_engine(coloc, k=1, **kw):
    _, tm, params = coloc
    kwargs = dict(ENGINE_KW, **kw)
    return TEngine(tm, config=EngineConfig(mode=TMode(
        decode_steps_per_dispatch=k)), device="cpu",
        params={n: params_to_torch(p) for n, p in params.items()}, **kwargs)


@pytest.mark.parametrize("k", [1, 4])
def test_greedy_streams_equal_live_jax_engine(coloc, k):
    """lowering=True, K in {1, 4}: the same trace through both engines,
    same params and seed, gives the same greedy token streams, and every
    page returns to the pool."""
    jm, _, _ = coloc
    from repro.configs.base import EngineConfig as JConfig
    je = JEngine(jm, config=JConfig(mode=JMode(decode_steps_per_dispatch=k)),
                 **ENGINE_KW)
    te = _torch_engine(coloc, k)
    j_reqs = [JRequest(*t, 0.0) for t in TRACE]
    t_reqs = [TRequest(*t, 0.0) for t in TRACE]
    for r in j_reqs:
        je.submit(r)
    for r in t_reqs:
        te.submit(r)
    je.drain()
    stats = te.drain()
    assert [r.output_ids for r in t_reqs] == [r.output_ids for r in j_reqs]
    assert stats.tokens_out == sum(r.max_new_tokens for r in t_reqs)
    assert te.virt.mapped_pages == 0 == je.virt.mapped_pages
    assert te.virt.peak_mapped == je.virt.peak_mapped
    assert stats.prefill_batch_sizes == je.stats.prefill_batch_sizes


def test_eos_mid_block_freezes_row_and_returns_pages(coloc):
    """An EOS inside a K=4 block stops the row there; the unused reserved
    pages return at commit."""
    probe = _torch_engine(coloc, 4)
    h = probe.submit(TRequest(0, MOE, 6, 8, 0.0))
    probe.drain()
    stream = h.tokens
    eos = stream[2]
    engine = _torch_engine(coloc, 4)
    h = engine.submit(TRequest(0, MOE, 6, 8, 0.0, eos_id=eos))
    engine.drain()
    assert h.tokens == stream[: stream.index(eos) + 1]
    assert h.state is HandleState.FINISHED
    assert engine.virt.mapped_pages == 0


def test_cancel_restores_accounting(coloc):
    engine = _torch_engine(coloc, 2)
    h1 = engine.submit(TRequest(1, MOE, 6, 50, 0.0))
    h2 = engine.submit(TRequest(2, MLA, 5, 3, 0.0))
    engine.step()
    assert h1.state is HandleState.DECODING
    assert engine.cancel(h1)
    assert h1.state is HandleState.CANCELLED
    engine.drain()
    assert h2.state is HandleState.FINISHED
    assert engine.virt.mapped_pages == 0
    assert not engine.arena.pins
    assert not engine.cancel(h1)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--horizon", "3", "--max-new", "3",
                "--decode-steps", "2"])
    out = capsys.readouterr().out
    assert "'mapped_pages': 0" in out


@pytest.mark.parametrize("pipeline", [[], ["--no-pipeline"]])
def test_serve_cli_runs_on_the_cpu_without_lowering(capsys, pipeline):
    """``--no-lowering``: the host-driven step, with and without the
    layer pipeline scheduler, serves the trace and returns every page."""
    serve.main(["--device", "cpu", "--horizon", "3", "--max-new", "3",
                "--no-lowering"] + pipeline)
    out = capsys.readouterr().out
    assert "lowering=False" in out and "'mapped_pages': 0" in out


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_a_card(coloc):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tm, _ = coloc
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tm, page_budget=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--horizon", "1"])


@pytest.mark.parametrize("kw", [
    dict(config=EngineConfig(slo=SLOConfig(objectives={
        MOE: SLObjective(ttft_ms=1.0)}))),
    dict(config=EngineConfig(sanitize=True)),
    dict(config=EngineConfig(flightrec=FlightRecorderConfig())),
    dict(observer=EngineObserver()),
])
def test_parts_not_ported_raise(coloc, kw):
    """SLO monitoring, the sanitizer, the flight recorder and observers
    were the last parts of this list; they are ported now
    (``tests/test_torch_observe.py``, ``tests/test_torch_flightrec.py``)
    and each constructs and serves.  What stays unported raises:
    ``test_fallback_families_raise``."""
    _, tm, _ = coloc
    engine = TEngine(tm, page_budget=256, page_bytes=4096, slab_bytes=4096,
                     max_batch=2, max_ctx=64, device="cpu", **kw)
    req = TRequest(0, MOE, 6, 2, 0.0)
    engine.submit(req)
    engine.drain()
    assert len(req.output_ids) == 2 and engine.virt.mapped_pages == 0


@pytest.mark.parametrize("name", ["whisper-small", "gemma3-12b"])
def test_fallback_families_raise(name):
    """The audio and sliding-window fallback families are not ported."""
    models = {name: t_smoke(name)}
    with pytest.raises(NotImplementedError):
        TEngine(models, page_budget=64, device="cpu")


# ---------------------------------------------------------------------------
# the fused dense-cache fallback path (ssm / hybrid families)
# ---------------------------------------------------------------------------

ZAMBA, MAMBA = "zamba2-1.2b", "mamba2-130m"
FALLBACK_SETS = {"ssm": (ZAMBA, MAMBA), "mixed": (MOE, ZAMBA)}
FALLBACK_KW = dict(page_budget=2048, page_bytes=4096, slab_bytes=4096,
                   max_batch=2, max_ctx=64, seed=3)


def _fallback_trace(names):
    """Three requests per model, all at time 0 (the engine clock is host
    time, so later arrivals would batch differently in the two engines):
    each model's third request waits for a batch slot; prompts span two
    buckets."""
    return [(i, names[i % len(names)], prompt, new, 0.0)
            for i, (prompt, new) in enumerate([(9, 4), (21, 6), (5, 3),
                                               (30, 5), (12, 7), (3, 2)])]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("which", sorted(FALLBACK_SETS))
def test_fallback_streams_equal_live_jax_engine(which, k):
    """{zamba2, mamba2} and {qwen3-moe, zamba2}, smoke f32: the port's
    dense-cache fallback runner (kernel routes, plain versions on the
    CPU) gives the live JAX engine's greedy streams, and every page
    returns to the pool.  An all-fallback engine holds no device pool and
    no arena."""
    from repro.configs.base import EngineConfig as JConfig
    names = FALLBACK_SETS[which]
    jm = {n: get_smoke_config(n).replace(dtype="float32") for n in names}
    tm = {n: t_smoke(n).replace(dtype="float32") for n in names}
    params = {n: params_to_torch(jax.tree.map(
        np.asarray, build_model(c).init(jax.random.PRNGKey(i))))
        for i, (n, c) in enumerate(jm.items())}
    je = JEngine(jm, config=JConfig(mode=JMode(decode_steps_per_dispatch=k)),
                 **FALLBACK_KW)
    te = TEngine(tm, config=EngineConfig(mode=TMode(
        decode_steps_per_dispatch=k)), device="cpu", params=params,
        **FALLBACK_KW)
    trace = _fallback_trace(names)
    j_reqs = [JRequest(*t) for t in trace]
    t_reqs = [TRequest(*t) for t in trace]
    for je_r, te_r in zip(j_reqs, t_reqs):
        je.submit(je_r)
        te.submit(te_r)
    je.drain()
    stats = te.drain()
    assert [r.output_ids for r in t_reqs] == [r.output_ids for r in j_reqs]
    assert stats.tokens_out == sum(r.max_new_tokens for r in t_reqs)
    assert te.virt.mapped_pages == 0 == je.virt.mapped_pages
    assert te.virt.peak_mapped == je.virt.peak_mapped
    assert all(int(r.nonfinite_logits) == 0 for r in te.runners.values())
    if which == "ssm":
        assert te.virt.pool is None and te.arena is None
    else:
        assert not te.runners[ZAMBA].paged and te.runners[MOE].paged
        assert ZAMBA not in te.arena.views


@pytest.mark.parametrize("flag", [["--arch", "qwen3-14b"],
                                  ["--multi-pod"],
                                  ["--dry-run"]])
def test_serve_flags_not_ported_raise(flag):
    """The dry-run surface stays unported (``--slo`` and
    ``--flight-record-out``, once here, are ported:
    ``tests/test_torch_observe.py``)."""
    with pytest.raises(NotImplementedError):
        serve.main(["--device", "cpu"] + flag)


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "serve_ab.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)} imports {name}"


def test_chip_smoke_fails_without_a_card():
    """Run where there is no card, the smoke script prints no result and
    exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import subprocess
    import sys
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
