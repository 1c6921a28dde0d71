"""Train step: loss, microbatched gradient accumulation, remat,
compression (port of ``src/repro/training/train_step.py``).

``make_train_step`` returns ``step(state, batch)``: cross-entropy (+ the
MoE load-balance aux), gradients by autograd (accumulated in f32 over
microbatches), optional error-feedback int8 compression, then AdamW.
``extra_inputs`` forwards keyword arguments to ``forward``: the grouped
MoE path is ``extra_inputs=lambda b: {"moe_path": "grouped"}``, the route
the reference allows.  The step runs where the params lie; the ssm and
hybrid families train on the CPU only (their SSD kernel has no backward).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm
from repro_torch.training.tree import leaves, map_tree, unflatten


class TrainState(NamedTuple):
    params: Dict
    opt: AdamWState
    error_fb: Optional[Dict] = None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy, logsumexp in f32.  logits [B,S,V],
    labels [B,S]."""
    V = logits.shape[-1]
    nll = F.cross_entropy(logits.float().reshape(-1, V),
                          labels.reshape(-1).long(),
                          reduction="none").reshape(labels.shape)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def make_loss_fn(model: Model, *, aux_weight: float = 0.01,
                 remat: bool = True,
                 extra_inputs: Optional[Callable[[Dict], Dict]] = None):
    def loss_fn(params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        kwargs = extra_inputs(batch) if extra_inputs else {}
        logits, aux = tfm.forward(params, model.cfg, batch["tokens"],
                                  remat=remat, **kwargs)
        S_txt = batch["tokens"].shape[1]
        logits_txt = logits[:, -S_txt:, :]
        ce = cross_entropy(logits_txt[:, :-1], batch["tokens"][:, 1:])
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}
    return loss_fn


def make_train_step(model: Model, optimizer: AdamW, *,
                    num_microbatches: int = 1,
                    compress: bool = False,
                    aux_weight: float = 0.01,
                    remat: bool = True,
                    extra_inputs: Optional[Callable[[Dict], Dict]] = None):
    """Returns step(state, batch) -> (state, metrics).

    batch["tokens"]: [global_batch, S].  With ``num_microbatches`` G > 1
    the batch is split [G, B/G, S] and the gradients accumulate in f32,
    each divided by G.  The state's params and moments are updated in
    place (``AdamW.update``); metrics are detached f32 scalars.
    """
    loss_fn = make_loss_fn(model, aux_weight=aux_weight, remat=remat,
                           extra_inputs=extra_inputs)
    G = num_microbatches

    def grads_of(params: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return ({k: v.detach().float() for k, v in metrics.items()},
                unflatten(params, grads))

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state.params
        if (model.cfg.family in ("ssm", "hybrid")
                and batch["tokens"].device.type == "cuda"):
            raise NotImplementedError(
                f"{model.cfg.name}: training the ssm/hybrid families on a "
                f"card needs SSD scan and flash attention backward kernels "
                f"(ROADMAP Queue 2 item 8); train them on the CPU")
        if G == 1:
            metrics, grads = grads_of(params, batch)
        else:
            mb = {k: v.reshape(G, v.shape[0] // G, *v.shape[1:])
                  for k, v in batch.items()}
            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = {}
            for i in range(G):
                m_i, g_i = grads_of(params, {k: v[i] for k, v in mb.items()})
                for acc, g in zip(leaves(grads), leaves(g_i)):
                    acc.add_(g.float() / G)
                for k, v in m_i.items():
                    metrics[k] = metrics.get(k, 0.0) + v / G
        error_fb = state.error_fb
        if compress:
            grads, error_fb = compression.compress_grads(grads, error_fb)
        new_params, new_opt = optimizer.update(grads, state.opt, params)
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        return TrainState(new_params, new_opt, error_fb), metrics

    return step


def init_train_state(model: Model, optimizer: AdamW, gen: torch.Generator,
                     *, compress: bool = False) -> TrainState:
    """Params drawn from ``gen`` on ``gen.device``, fresh optimizer state."""
    params = model.init(gen)
    return TrainState(
        params=params,
        opt=optimizer.init(params),
        error_fb=compression.init_error_feedback(params) if compress else None,
    )
