"""The port's examples (``repro_torch.examples``) against the JAX package
and the repo's own ``examples/``, on the CPU at small settings.

* quickstart, all 10 archs (float32, the reference's init carried over
  by ``repro_torch.bridge``): prefill logits within 1e-5 of the JAX
  Model's (on the scale of the tensor), the 8 greedy tokens equal, and
  for the split archs the session's streamed tokens equal a live JAX
  engine's; then the example's ``main`` runs to its OK line.
* long_context_pooling: the admission counts and the attention output
  (within 2e-5) equal the reference example's on the same numpy inputs.
* serve_multi_model: batch and ``--online --elastic`` runs reach their
  OK line, the planner summary equals the reference example's, and the
  SLO demo's record replays bit for bit.
* train_moe: 60 steps learn (the example's own assert).
"""
import contextlib
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_smoke_config
from repro.core.split_exec import supports_split
from repro.models import build_model
from repro.runtime.engine import CrossPoolEngine as JEngine
from repro.runtime.request import Request as JRequest
from repro.runtime.sampler import sample as j_sample
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.examples import (long_context_pooling, quickstart,
                                  serve_multi_model, train_moe)
from repro_torch.launch import replay
from repro_torch.models.model import build_model as t_build
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_example(name):
    """The repo's ``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _close_scaled(got, want, tol=1e-5):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def _jax_inputs(cfg):
    """The reference example's forward inputs: (tokens, extra inputs)."""
    rng = np.random.default_rng(0)
    kw, seq = {}, quickstart.SEQ
    if cfg.frontend == "vision_patches":
        kw["embeddings"] = jnp.asarray(
            rng.normal(size=(1, cfg.frontend_tokens, cfg.d_model)),
            jnp.float32)
        seq -= cfg.frontend_tokens
    if cfg.family == "audio":
        kw["encoder_frames"] = jnp.asarray(
            rng.normal(size=(1, cfg.encoder_seq, cfg.d_model)), jnp.float32)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, seq)), jnp.int32)
    return tokens, kw


def _jax_quickstart(cfg, params):
    """The reference example's prefill and 8 greedy decode steps."""
    model = build_model(cfg)
    tokens, kw = _jax_inputs(cfg)
    seq = tokens.shape[1]
    cache = model.init_cache(1, seq + 16)
    step_logits, cache = jax.jit(lambda p, t, c: model.prefill(
        p, t, c, **kw))(params, tokens, cache)
    prefill_logits = np.asarray(step_logits)
    decode = jax.jit(model.decode_step)
    out, tok = [], j_sample(step_logits)
    for i in range(quickstart.DECODE_STEPS):
        out.append(int(tok[0]))
        step_logits, cache = decode(params, tok, cache, jnp.int32(seq + i))
        tok = j_sample(step_logits)
    return prefill_logits, out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_quickstart_equals_reference(arch, capsys):
    jcfg = get_smoke_config(arch).replace(dtype="float32")
    tcfg = t_smoke(arch).replace(dtype="float32")
    jparams = jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0))
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams))
    want_logits, want_tokens = _jax_quickstart(jcfg, jparams)

    tokens, kw = quickstart.model_inputs(tcfg, np.random.default_rng(0),
                                         "cpu")
    got = quickstart.run_model(t_build(tcfg), tparams, tokens, kw)
    _close_scaled(got["prefill_logits"].numpy(), want_logits)
    assert got["decoded"] == want_tokens

    assert quickstart.supports_split(tcfg) == supports_split(jcfg)
    if supports_split(jcfg):
        je = JEngine({jcfg.name: jcfg}, page_budget=512, page_bytes=4096,
                     slab_bytes=4096, max_batch=2, max_ctx=64)
        j_stream = []
        h = je.submit(JRequest(0, jcfg.name, 8, 4, 0.0),
                      on_token=lambda e: j_stream.append(e.token))
        while not h.done:
            je.step()
        t_stream, handle = quickstart.session(tcfg, "cpu", params=tparams)
        assert t_stream == j_stream and len(t_stream) == 4
        assert handle.state.value == "finished"

    quickstart.main(["--arch", arch, "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quickstart OK")
    assert ("session streamed" in out) == supports_split(jcfg)


# ---------------------------------------------------------------------------
# long_context_pooling
# ---------------------------------------------------------------------------

def test_long_context_pooling_equals_reference(monkeypatch):
    """The reference example runs with its kernel call recorded; the
    port's admission lines equal its, and the port's attention over the
    same numpy inputs is within 2e-5 of the reference kernel's."""
    ref_mod = _reference_example("long_context_pooling")
    seen = {}
    kernel = ref_mod.paged_decode_attention

    def recording(*args, **kwargs):
        seen["out"] = np.asarray(kernel(*args, **kwargs))
        return seen["out"]
    monkeypatch.setattr(ref_mod, "paged_decode_attention", recording)
    want = _stdout(ref_mod.main).splitlines()
    got = _stdout(long_context_pooling.main, ["--device", "cpu"]
                  ).splitlines()
    assert got[:2] == want[:2]           # the burst and the admission counts
    assert got[-1] == want[-1] == "long_context_pooling OK"
    assert got[-2] == want[-2]           # pool utilization

    cfg = t_smoke(long_context_pooling.MLA_MODEL)
    res = long_context_pooling.pool_attention(
        cfg, device="cpu", n_tokens=48, page_budget=64, page_bytes=2048,
        max_pages=8)
    assert res["out"].shape == seen["out"].shape
    np.testing.assert_allclose(res["out"].numpy(), seen["out"], rtol=2e-5,
                               atol=2e-5)


def test_admission_burst_at_published_widths():
    """Phase 13a's host half: moonshot's published KV (48 layers, 16 kv
    heads of 128: 393,216 B a token), 4 requests of 32768 tokens, a
    48 GiB pool of 16 KiB pages: the shared pool admits all four, a
    static third one."""
    from repro_torch.configs import PAPER_COLOC_SET, get_config
    models = {n: get_config(n) for n in PAPER_COLOC_SET}
    assert models[long_context_pooling.BURST_MODEL].kv_bytes_per_token() \
        == 393_216
    out = long_context_pooling.admission_burst(
        models, total_pages=3 * 2 ** 20, page_bytes=16384, long_ctx=32768)
    assert out["need"] == 48 * 32768 // 2
    assert (out["admitted_shared"], out["admitted_static"]) == (4, 1)


def test_long_context_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 13a rehearsed on the CPU at 100 tokens:
    minicpm3's published geometry (62 layers), the all-layer prompt
    write and layer 0's ``write_tokens`` equal to a plain scatter through
    the page tables, both attention calls against their plain versions
    and the burst at published widths."""
    from repro_torch.kernels import ops, ref
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke_phases.p13_examples")
    monkeypatch.setattr(smoke, "LONG_CTX", 100)
    monkeypatch.setattr(smoke, "LONG_PAGES", 62 * 4 + 10)
    out = smoke.long_context_phase(torch, ops, ref, device="cpu")
    assert out["layers"] == 62 and out["pages"] == 4
    assert out["row1_max_abs_err"] == out["row2_max_abs_err"] == 0.0
    assert (out["burst"]["admitted_shared"],
            out["burst"]["admitted_static"]) == (4, 1)


def test_examples_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (quickstart, long_context_pooling, serve_multi_model,
                train_moe):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mod.main([])


# ---------------------------------------------------------------------------
# serve_multi_model
# ---------------------------------------------------------------------------

class _Planned(Exception):
    """Stops the reference example once its planner has printed."""


def _planner_lines(text):
    lines = text.splitlines()
    return lines[lines.index("=== planner ==="):
                 next(i for i, s in enumerate(lines)
                      if s.startswith("engine budgets")) + 1]


def test_serve_multi_model_planner_equals_reference(monkeypatch, tmp_path):
    ref_mod = _reference_example("serve_multi_model")

    def stop(*args, **kwargs):
        raise _Planned
    monkeypatch.setattr(ref_mod, "CrossPoolEngine", stop)
    monkeypatch.setattr("sys.argv", ["serve_multi_model", "--horizon", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(_Planned):
        ref_mod.main()
    want = _planner_lines(buf.getvalue())
    got = _stdout(serve_multi_model.main,
                  ["--horizon", "2", "--device", "cpu"])
    assert _planner_lines(got) == want
    assert "batch run()" in got
    assert got.rstrip().endswith("serve_multi_model OK")


def test_serve_multi_model_online_elastic_slo_demo(tmp_path, capsys):
    rec = tmp_path / "slo_flight.json"
    serve_multi_model.main([
        "--horizon", "2", "--online", "--elastic", "--slo-demo", str(rec),
        "--metrics-out", str(tmp_path / "metrics.prom"),
        "--trace-out", str(tmp_path / "trace.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "online submit/step" in out and "handles:" in out
    assert f"auto-dumped on first breach -> {rec}" in out
    assert out.rstrip().endswith("serve_multi_model OK")
    assert (tmp_path / "metrics.prom").stat().st_size > 0
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert replay.main([str(rec), "--device", "cpu", "-q"]) == 0
    assert "BIT-EXACT" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# train_moe
# ---------------------------------------------------------------------------

def test_train_moe_learns(tmp_path, capsys):
    out = train_moe.main(["--steps", "60", "--batch", "8", "--device",
                          "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["last_ce"] < out["first_ce"] * 0.8
    assert capsys.readouterr().out.rstrip().endswith("train_moe OK")
