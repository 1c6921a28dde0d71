"""The port's training path against the JAX package's.

Same inputs (numpy, from a seed) and the same params (the reference's own
init, bridged with ``repro_torch.bridge``) go through both packages on
the float32 smoke configs: the grouped-GEMM MoE, the full-sequence
forward of every ported family, the loss and its gradients, the AdamW
step (with and without int8 compression), the data pipeline, and the
checkpoint and launcher round trips.  Tolerances: single modules within
1e-5; through a whole stack within 1e-5 of each tensor's scale (f32
sums in another order); gradients within 1e-4 of each leaf's scale.
"""
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels import ref as jref
from repro.models import build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.training import compression as jcomp
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import SyntheticLM as JSyntheticLM
from repro.training.optimizer import AdamW as JAdamW
from repro.training.train_step import make_loss_fn as j_make_loss_fn
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as t_train
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import build_model as t_build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression as tcomp
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import (TrainState, init_train_state,
                                             make_loss_fn, make_train_step)
from repro_torch.training.tree import leaves, leaves_with_path, map_tree

MOE = "qwen3-moe-235b-a22b"


def _cfgs(name):
    return (get_smoke_config(name).replace(dtype="float32"),
            t_smoke(name).replace(dtype="float32"))


@functools.lru_cache(maxsize=None)
def _np_params(name, seed=0):
    jcfg, _ = _cfgs(name)
    return jax.tree.map(np.asarray, build_model(jcfg).init(
        jax.random.PRNGKey(seed)))


def _params(name):
    """(reference tree of numpy leaves, a fresh torch copy)."""
    jp = _np_params(name)
    return jp, params_to_torch(jp)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close_scaled(got, want, tol):
    """|got - want| <= tol * max(1, max|want|) elementwise (and tol
    relative)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def _leaf_close(got, want, tol):
    """Within ``tol`` of the leaf's own scale (max |want|)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale + 1e-12, (err, scale)


# ---------------------------------------------------------------------------
# grouped expert GEMM: autograd against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,K,M,sizes", [
    (40, 16, 24, [10, 0, 17, 13]),          # an empty expert
    (33, 8, 12, [0, 33, 0]),                # one expert takes every row
])
def test_moe_gemm_backward_matches_jax_grad(N, K, M, sizes):
    rng = np.random.default_rng(N)
    E = len(sizes)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((E, K, M)).astype(np.float32)
    dy = rng.standard_normal((N, M)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)

    def loss(x_, w_):
        return jnp.sum(jref.moe_gemm(x_, w_, jnp.asarray(gs)) * dy)

    want_out = jref.moe_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    before = (kops.moe_gemm.launches, kops.moe_gemm_wgrad.launches)
    out = kops.moe_gemm(tx, tw, torch.from_numpy(gs))
    (out * torch.from_numpy(dy)).sum().backward()
    assert (kops.moe_gemm.launches, kops.moe_gemm_wgrad.launches) == before
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **tol)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), **tol)
    for e in np.flatnonzero(gs == 0):
        assert not tw.grad[e].any()          # an empty expert: zero grad


# ---------------------------------------------------------------------------
# model math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [MOE, "moonshot-v1-16b-a3b"])
def test_apply_moe_grouped_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    x = np.random.default_rng(1).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    want, want_aux = jax.jit(functools.partial(
        jmoe.apply_moe_grouped, cfg=jcfg))(jlayer, jnp.asarray(x))
    tlayer = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    got, aux = tmoe.apply_moe_grouped(tlayer, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,moe_path", [
    ("qwen3-14b", "capacity"), (MOE, "capacity"), (MOE, "grouped"),
    ("moonshot-v1-16b-a3b", "grouped"), ("minicpm3-4b", "capacity"),
    ("mamba2-130m", "capacity"), ("zamba2-1.2b", "capacity"),
])
def test_forward_matches_jax(name, moe_path):
    """Logits and aux of the whole stack, dense (GQA), MoE on both paths,
    MLA, ssm and hybrid."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    tokens = _tokens(jcfg, 2, 16)
    fwd = jax.jit(functools.partial(jtfm.forward, cfg=jcfg,
                                    moe_path=moe_path))
    want, want_aux = fwd(jp, tokens=jnp.asarray(tokens))
    if moe_path == "capacity":          # the facade's default path
        got, aux = t_build_model(tcfg).forward(tp, torch.from_numpy(tokens))
    else:
        got, aux = ttfm.forward(tp, tcfg, torch.from_numpy(tokens),
                                moe_path=moe_path)
    _close_scaled(got.numpy(), want, 1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-5)


def test_forward_refuses_what_is_not_ported():
    _, tcfg = _cfgs("gemma3-12b")
    with pytest.raises(NotImplementedError):
        ttfm.forward({}, tcfg, torch.zeros((1, 4), dtype=torch.int32))
    _, tcfg = _cfgs(MOE)
    _, tp = _params(MOE)
    with pytest.raises(ValueError):
        ttfm.forward(tp, tcfg, torch.zeros((1, 4), dtype=torch.int32),
                     moe_path="dense")


@pytest.mark.parametrize("name,moe_path", [
    (MOE, "capacity"), (MOE, "grouped"), ("minicpm3-4b", "capacity")])
def test_loss_and_grads_match_jax(name, moe_path):
    """``jax.value_and_grad`` of the reference's loss against torch
    autograd of the port's: loss within 1e-5 (relative), every gradient
    leaf within 1e-4 of its scale."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    tokens = _tokens(jcfg, 4, 16, seed=2)
    extra = (lambda b: {"moe_path": moe_path})
    j_loss = j_make_loss_fn(build_model(jcfg), remat=False,
                            extra_inputs=extra)
    (want, _), want_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens)})
    t_loss = make_loss_fn(t_build_model(tcfg), remat=False,
                          extra_inputs=extra)
    flat = leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = t_loss(tp, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_flat = leaves(jax.tree.map(np.asarray, want_g))
    assert len(want_flat) == len(grads)
    for g, w in zip(grads, want_flat):
        _leaf_close(g.numpy(), w, 1e-4)


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_adamw_steps_match_jax(compress):
    """Two AdamW updates on the same gradients (clipped: their global norm
    is above 1; in warm-up; decay on matrices only), with and without
    error-feedback int8 compression: params, moments, count and residual
    equal the reference's within 1e-6."""
    jp, tp = _params("qwen3-14b")
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05)
                          .astype(np.float32), jp) for _ in range(2)]
    jopt, topt = JAdamW(lr=3e-3, warmup_steps=5), AdamW(lr=3e-3,
                                                        warmup_steps=5)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    j_fb, t_fb = jcomp.init_error_feedback(jp), tcomp.init_error_feedback(tp)
    j_params = jp
    for g in grads:
        tg = params_to_torch(g)
        if compress:
            g, j_fb = jcomp.compress_grads(g, j_fb)
            tg, t_fb = tcomp.compress_grads(tg, t_fb)
        j_params, jstate = jax.jit(jopt.update)(g, jstate, j_params)
        tp, tstate = topt.update(tg, tstate, tp)
    assert int(tstate.count) == int(jstate.count) == 2
    for got_tree, want_tree in ((tp, j_params), (tstate.m, jstate.m),
                                (tstate.v, jstate.v)) + (
            ((t_fb, j_fb),) if compress else ()):
        for a, b in zip(leaves(got_tree),
                        leaves(jax.tree.map(np.asarray, want_tree))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


def test_adamw_updates_in_place_and_keeps_bf16_moments():
    opt = AdamW(lr=1.0, warmup_steps=1, moment_dtype="bfloat16")
    params = {"w": torch.ones((3, 4)), "b": torch.ones(4)}
    state = opt.init(params)
    w = params["w"]
    new, state = opt.update({"w": torch.full((3, 4), 0.5),
                             "b": torch.full((4,), -0.5)}, state, params)
    assert new["w"] is w and state.m["w"].dtype == torch.bfloat16
    assert (w < 1.0).all() and (new["b"] > 1.0).all()


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_jax(compress):
    """One whole step on the grouped MoE path: loss and grad norm within
    1e-5, the updated params within 1e-4 of each leaf's scale taken as
    max(1, max|leaf|) (the zero-initialised norm weights move by the
    learning rate, where Adam's g / (|g| + eps) magnifies the f32 noise
    of the tiniest gradient elements)."""
    jcfg, tcfg = _cfgs(MOE)
    jp, tp = _params(MOE)
    tokens = _tokens(jcfg, 4, 16, seed=4)
    extra = (lambda b: {"moe_path": "grouped"})
    jopt = JAdamW(lr=3e-3, warmup_steps=10)
    j_step = jax.jit(j_make_train_step(build_model(jcfg), jopt,
                                       compress=compress, remat=False,
                                       extra_inputs=extra))
    from repro.training.train_step import TrainState as JTrainState
    jstate = JTrainState(jp, jopt.init(jp), jcomp.init_error_feedback(jp)
                         if compress else None)
    jstate, jm = j_step(jstate, {"tokens": jnp.asarray(tokens)})
    topt = AdamW(lr=3e-3, warmup_steps=10)
    tstate = TrainState(tp, topt.init(tp), tcomp.init_error_feedback(tp)
                        if compress else None)
    t_step = make_train_step(t_build_model(tcfg), topt, compress=compress,
                             remat=False, extra_inputs=extra)
    tstate, tm = t_step(tstate, {"tokens": torch.from_numpy(tokens)})
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for a, b in zip(leaves(tstate.params),
                    leaves(jax.tree.map(np.asarray, jstate.params))):
        _close_scaled(a.detach().numpy(), b, 1e-4)


# ---------------------------------------------------------------------------
# the train step on its own (the reference's tests/test_training.py)
# ---------------------------------------------------------------------------

def _setup(name="qwen3-14b", **opt_kw):
    _, tcfg = _cfgs(name)
    model = t_build_model(tcfg)
    optimizer = AdamW(lr=3e-3, warmup_steps=5, **opt_kw)
    state = init_train_state(model, optimizer,
                             torch.Generator().manual_seed(0))
    return tcfg, model, optimizer, state


def _clone(state: TrainState) -> TrainState:
    return map_tree(lambda t: None if t is None else t.detach().clone(),
                    state)


def _batches(cfg, n, seq, batch, seed):
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=seed))
    return [{"tokens": torch.from_numpy(b["tokens"])}
            for b, _ in zip(data.batches(), range(n))]


@pytest.mark.parametrize("name,moe_path", [("qwen3-14b", "capacity"),
                                           (MOE, "grouped")])
def test_loss_decreases_on_structured_data(name, moe_path):
    cfg, model, optimizer, state = _setup(name)
    step = make_train_step(model, optimizer, remat=False,
                           extra_inputs=lambda b: {"moe_path": moe_path})
    losses = []
    for batch in _batches(cfg, 30, 32, 8, seed=1):
        state, metrics = step(state, batch)
        losses.append(float(metrics["ce"]))
    assert losses[-1] < losses[0] * 0.8, losses[::6]


def test_ssm_arch_trains_on_the_cpu():
    cfg, model, optimizer, state = _setup("mamba2-130m")
    step = make_train_step(model, optimizer, remat=False)
    losses = []
    for batch in _batches(cfg, 15, 32, 8, seed=5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["ce"]))
    assert losses[-1] < losses[0]


def test_microbatch_grad_equivalence():
    """G = 4 microbatches give the update of one big batch."""
    cfg, model, optimizer, state = _setup()
    batch = _batches(cfg, 1, 16, 8, seed=3)[0]
    s1, m1 = make_train_step(model, optimizer, num_microbatches=1,
                             remat=False)(_clone(state), batch)
    s4, m4 = make_train_step(model, optimizer, num_microbatches=4,
                             remat=False)(_clone(state), batch)
    np.testing.assert_allclose(float(m1["ce"]), float(m4["ce"]), rtol=1e-5)
    for a, b in zip(leaves(s1.params), leaves(s4.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("name,moe_path", [("qwen3-14b", "capacity"),
                                           (MOE, "grouped"),
                                           ("zamba2-1.2b", "capacity")])
def test_remat_matches_no_remat(name, moe_path):
    """Recomputing activations in the backward changes neither the loss
    nor the gradients."""
    cfg, model, _, state = _setup(name)
    batch = _batches(cfg, 1, 16, 4, seed=4)[0]
    extra = (lambda b: {"moe_path": moe_path})
    flat = leaves(state.params)
    for p in flat:
        p.requires_grad_(True)
    out = []
    for remat in (True, False):
        loss, _ = make_loss_fn(model, remat=remat, extra_inputs=extra)(
            state.params, batch)
        out.append((float(loss.detach()), torch.autograd.grad(loss, flat)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_moe_aux_loss_flows():
    cfg, model, optimizer, state = _setup(MOE)
    step = make_train_step(model, optimizer, remat=False, aux_weight=0.05)
    state, metrics = step(state, _batches(cfg, 1, 16, 8, seed=2)[0])
    assert float(metrics["aux"]) > 0.0
    assert np.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------------------
# data, checkpoints, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structured", [True, False])
def test_synthetic_batches_equal_the_reference(structured):
    cfg = dict(vocab_size=97, seq_len=24, global_batch=5, seed=11,
               structured=structured)
    ours = SyntheticLM(DataConfig(**cfg)).batches(start_step=2)
    theirs = JSyntheticLM(JDataConfig(**cfg)).batches(start_step=2)
    for _ in range(3):
        a, b = next(ours)["tokens"], next(theirs)["tokens"]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_trees_equal(a, b):
    flat_a, flat_b = leaves_with_path(a), leaves_with_path(b)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_tree_walks_namedtuples_tuples_and_none():
    state = TrainState({"a": torch.ones(2), "b": {"c": torch.zeros(3)}},
                       (torch.ones(()), [torch.full((2,), 2.0)]), None)
    paths = [p for p, _ in leaves_with_path(state)]
    assert paths == [("params", "a"), ("params", "b", "c"), ("opt", "0"),
                     ("opt", "1", "0"), ("error_fb",)]
    doubled = map_tree(lambda t, u: None if t is None else t + u, state,
                       state)
    assert isinstance(doubled, TrainState) and doubled.error_fb is None
    assert isinstance(doubled.opt, tuple) and isinstance(doubled.opt[1], list)
    assert [float(t.sum()) for t in leaves(doubled) if t is not None] == \
        [4.0, 0.0, 2.0, 8.0]


def test_checkpoint_roundtrip_exact():
    _, model, optimizer, state = _setup()
    state = state._replace(error_fb=None)
    bf16 = {"w": torch.randn((3, 5)).to(torch.bfloat16), "n": None}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(state, 7, d)
        assert ckpt.latest_step(d) == 7
        restored, step = ckpt.restore(d, target_tree=state)
        assert step == 7
        _assert_trees_equal(restored, state)
        assert isinstance(restored, TrainState) and restored.error_fb is None
        ckpt.save(bf16, 8, d)
        _assert_trees_equal(ckpt.restore(d)[0], bf16)


def test_resume_training_continuity():
    cfg, model, optimizer, state = _setup()
    step = make_train_step(model, optimizer, remat=False)
    batches = _batches(cfg, 6, 16, 4, seed=7)
    s_a = _clone(state)
    for b in batches:
        s_a, _ = step(s_a, b)
    s_b = _clone(state)
    for b in batches[:3]:
        s_b, _ = step(s_b, b)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(s_b, 3, d)
        s_b, _ = ckpt.restore(d, target_tree=s_b)
    for b in batches[3:]:
        s_b, _ = step(s_b, b)
    for a, b in zip(leaves(s_a.params), leaves(s_b.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_async_save_snapshots_before_the_write():
    tree = {"w": torch.ones(4),
            "opt": {"c": torch.zeros((), dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as d:
        t = ckpt.save_async(tree, 1, d)
        tree["w"].add_(5.0)               # training goes on, in place
        t.join(timeout=60)
        restored, _ = ckpt.restore(d)
        torch.testing.assert_close(restored["w"], torch.ones(4))


def test_gc_keeps_last_three():
    with tempfile.TemporaryDirectory() as d:
        for s in range(5):
            ckpt.save({"w": torch.ones(2)}, s, d)
        assert len(os.listdir(d)) == 3
        assert ckpt.latest_step(d) == 4


def test_train_launcher_on_the_cpu_resumes(capsys):
    with tempfile.TemporaryDirectory() as d:
        args = ["--device", "cpu", "--arch", MOE, "--smoke", "--seq", "16",
                "--batch", "4", "--ckpt-dir", d, "--ckpt-every", "2"]
        t_train.main(args + ["--steps", "3"])
        assert ckpt.latest_step(d) == 2
        t_train.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "resumed from step 2" in out
    assert "done: 3 steps" in out.split("resumed from step 2")[1]


def test_train_launcher_refuses_what_it_cannot_run():
    with pytest.raises(NotImplementedError):
        t_train.main(["--arch", MOE, "--dry-run", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_train.main(["--arch", MOE, "--smoke"])
