"""The training the port's examples run, against the JAX package on the
CPU: train_moe's member config, optimizer, two microbatches and remat,
and quickstart's training (its extra inputs over the batch), each from
the reference's init on the same synthetic batches with the grouped MoE
path on both sides: the ce / loss series within 1e-5 on the scale of the
series (the rule ``tests/test_torch_training.py`` holds one step to).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import build_model
from repro.training.optimizer import AdamW as JAdamW
from repro.training.train_step import TrainState as JTrainState
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.examples import quickstart, train_moe
from repro_torch.models.model import build_model as t_build
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train_step import TrainState
from torch_threads import one_torch_thread  # noqa: F401


def _close_scaled(got, want, tol=1e-5):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


#: quickstart's training held against the JAX package: the MoE archs
#: (grouped path) and the two with extra inputs
TRAIN_ARCHS = ("qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b",
               "llava-next-34b", "whisper-small")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_quickstart_training_equals_reference(arch):
    """Three of quickstart's train steps (AdamW, warmup 5, its
    synthetic batches of 8, its extra inputs over the batch, the grouped
    MoE path) from the reference's init: the loss series within 1e-5 of
    the JAX package's same steps."""
    jcfg = get_smoke_config(arch).replace(dtype="float32")
    tcfg = t_smoke(arch).replace(dtype="float32")
    jmodel = build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams))
    tokens, kw = quickstart.model_inputs(tcfg, np.random.default_rng(0),
                                         "cpu")
    seq = tokens.shape[1]
    got = quickstart.train(t_build(tcfg), kw, seq, 3, "cpu",
                           params=tparams)

    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    jopt = JAdamW(lr=3e-3, warmup_steps=5)
    step = jax.jit(j_make_train_step(
        jmodel, jopt, remat=False,
        extra_inputs=lambda b: dict({k: b[k] for k in jkw},
                                    moe_path="grouped")))
    state = JTrainState(jparams, jopt.init(jparams))
    want = []
    data = SyntheticLM(DataConfig(jcfg.vocab_size, seq, 8))
    for _, batch in zip(range(3), data.batches()):
        state, metrics = step(state, {
            "tokens": jnp.asarray(batch["tokens"]),
            **{k: jnp.broadcast_to(v, (8,) + v.shape[1:])
               for k, v in jkw.items()}})
        want.append(float(metrics["loss"]))
    _close_scaled(np.array(got), np.array(want))


def test_train_moe_steps_equal_reference():
    """train_moe's member config, optimizer, two microbatches and remat
    through both packages from the reference's init on the same
    synthetic batches (8 x 32 tokens, its noise), the grouped MoE path on
    both sides: four steps' ce and loss within 1e-5."""
    jcfg = get_config("qwen3-moe-235b-a22b").replace(**train_moe.MEMBER)
    jmodel = build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jopt = JAdamW(lr=train_moe.LR, warmup_steps=train_moe.WARMUP)
    jstep = jax.jit(j_make_train_step(
        jmodel, jopt, num_microbatches=2, remat=True,
        extra_inputs=lambda b: {"moe_path": "grouped"}))
    jstate = JTrainState(jparams, jopt.init(jparams))

    tparams = params_to_torch(jax.tree.map(np.asarray, jparams))
    topt, tstep = train_moe.make_step(t_build(train_moe.member_config()),
                                      microbatches=2, compress=False)
    tstate = TrainState(tparams, topt.init(tparams))

    got, want = [], []
    data = SyntheticLM(DataConfig(jcfg.vocab_size, 32, 8, noise=0.05))
    for _, batch in zip(range(4), data.batches()):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tm = tstep(tstate,
                           {"tokens": torch.from_numpy(batch["tokens"])})
        want.append([float(jm["ce"]), float(jm["loss"])])
        got.append([float(tm["ce"]), float(tm["loss"])])
    _close_scaled(np.array(got), np.array(want))
