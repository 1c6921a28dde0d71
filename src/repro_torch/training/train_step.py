"""Train step: loss, microbatched gradient accumulation, remat,
compression (port of ``src/repro/training/train_step.py``).

``make_train_step`` returns ``step(state, batch)``: cross-entropy (+ the
MoE load-balance aux), gradients by autograd (accumulated in f32 over
microbatches), optional error-feedback int8 compression, then AdamW.
``extra_inputs`` forwards keyword arguments to ``forward``: the grouped
MoE path is ``extra_inputs=lambda b: {"moe_path": "grouped"}``, the route
the reference allows.  The step runs where the params lie, for every
family: on a card the ssm and hybrid families' SSD scan is differentiable
(its backward is a kernel, ``kernels.ops.ssd_scan_bwd``), and attention
trains through its plain version, as the reference's ``"xla"`` route
does.  ``hooks`` (the reference's argument) make it the sharded step of
``launch/dryrun.py`` ``build_train_cell`` for every family: each rank's
local shards and rows, the collectives written out by the hooks.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.hooks import IDENTITY_HOOKS, Hooks
from repro_torch.models.model import Model
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm
from repro_torch.training.tree import leaves, map_tree, unflatten


class TrainState(NamedTuple):
    params: Dict
    opt: AdamWState
    error_fb: Optional[Dict] = None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *, tp=None,
                  vocab: Optional[int] = None,
                  total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy, logsumexp in f32.  logits [B,S,V],
    labels [B,S].  Logits over this rank's part of the vocabulary
    ([B,S,V/tp], ids ``[index * V/tp, ...)``, when ``V`` is below
    ``vocab``) take the split softmax: the max and the sum of
    exponentials are reduced over ``tp`` and the gold logit comes from
    the rank that owns its id.  With ``mask`` the mean is over the masked
    tokens: their sum over ``total`` (default: the mask's own sum)."""
    V = logits.shape[-1]
    if tp is None or vocab is None or V == vocab:
        nll = F.cross_entropy(logits.float().reshape(-1, V),
                              labels.reshape(-1).long(),
                              reduction="none").reshape(labels.shape)
    else:
        lf = logits.float()
        top = tp.max(lf.detach().amax(dim=-1, keepdim=True))
        sumexp = tp.reduce(torch.exp(lf - top).sum(dim=-1))
        ids = labels.long() - tp.index * V
        own = (ids >= 0) & (ids < V)
        gold = lf.gather(-1, ids.clamp(0, V - 1)[..., None])[..., 0]
        gold = tp.reduce(torch.where(own, gold, torch.zeros_like(gold)))
        nll = top[..., 0] + torch.log(sumexp) - gold
    if mask is not None:
        if total is None:
            total = torch.clamp(torch.sum(mask), min=1.0)
        return torch.sum(nll * mask) / total
    return torch.mean(nll)


def make_loss_fn(model: Model, *, hooks: Hooks = IDENTITY_HOOKS,
                 aux_weight: float = 0.01, remat: bool = True,
                 extra_inputs: Optional[Callable[[Dict], Dict]] = None):
    """loss_fn(params, batch) -> (loss, metrics).  Under the sharded
    step's ``hooks`` it is this rank's loss: the mean cross-entropy of its
    rows plus the (global) aux loss.  A batch padded by the train cell
    (``launch/dryrun.py`` ``local_batch``) carries ``row_mask`` and
    ``real_rows`` (the microbatch's real rows over every rank): the
    cross-entropy is then this rank's real tokens' share of the mean over
    every rank's real tokens, times the batch ranks (which
    ``make_grad_fn``'s mean divides by), and ``forward`` keeps the pad
    rows out of the MoE."""
    def loss_fn(params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        kwargs = extra_inputs(batch) if extra_inputs else {}
        mask = batch.get("row_mask")
        if mask is not None:
            kwargs.update(row_mask=mask, real_rows=batch["real_rows"])
        logits, aux = tfm.forward(params, model.cfg, batch["tokens"],
                                  remat=remat, hooks=hooks, **kwargs)
        S_txt = batch["tokens"].shape[1]
        logits_txt = logits[:, -S_txt:, :]
        labels = batch["tokens"][:, 1:]
        real = total = None
        if mask is not None:
            real = mask[:, None].expand(labels.shape).float()
            total = batch["real_rows"] * labels.shape[1] / hooks.dp.size
        ce = cross_entropy(logits_txt[:, :-1], labels, real, tp=hooks.tp,
                           vocab=model.cfg.vocab_size, total=total)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}
    return loss_fn


def make_grad_fn(model: Model, *, hooks: Hooks = IDENTITY_HOOKS,
                 num_microbatches: int = 1, aux_weight: float = 0.01,
                 remat: bool = True,
                 extra_inputs: Optional[Callable[[Dict], Dict]] = None):
    """grad_fn(params, batch) -> (metrics, grads): the loss's gradient
    (accumulated in f32 over ``num_microbatches`` G: the batch split
    [G, B/G, ...], each part's gradient divided by G) and the metrics,
    detached f32 scalars.  Under the sharded step's hooks ``params`` and
    ``grads`` are this rank's shards and ``batch`` its rows (microbatch i
    is rows ``[i * B/G, (i+1) * B/G)`` of them: ``build_train_cell``'s
    ``local_batch`` places each microbatch's rows as the reference
    does, a padded batch with its ``row_mask`` and ``real_rows``); the
    gradients get the data-parallel mean (``hooks.params.grad_mean``)
    and the cross-entropy the batch's mean: the sums of the ranks' losses
    over the batch ranks, which a padded batch's losses are scaled for
    (``make_loss_fn``)."""
    loss_fn = make_loss_fn(model, hooks=hooks, aux_weight=aux_weight,
                           remat=remat, extra_inputs=extra_inputs)
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

    def grad_fn(params: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        if G == 1:
            metrics, grads = grads_of(params, batch)
        else:
            # a padded batch's ``real_rows`` (an int) is each microbatch's
            mb = {k: v.reshape(G, v.shape[0] // G, *v.shape[1:])
                  if isinstance(v, torch.Tensor) else [v] * G
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
        dp = hooks.dp
        if dp.size > 1:
            with torch.no_grad():
                metrics["ce"] = dp.reduce(metrics["ce"]) / dp.size
            metrics["loss"] = metrics["ce"] + aux_weight * metrics["aux"]
        return metrics, hooks.params.grad_mean(grads)

    return grad_fn


def make_train_step(model: Model, optimizer: AdamW, *,
                    hooks: Hooks = IDENTITY_HOOKS,
                    num_microbatches: int = 1,
                    compress: bool = False,
                    aux_weight: float = 0.01,
                    remat: bool = True,
                    extra_inputs: Optional[Callable[[Dict], Dict]] = None):
    """Returns step(state, batch) -> (state, metrics).

    batch["tokens"]: [global_batch, S].  With ``num_microbatches`` G > 1
    the batch is split [G, B/G, S] and the gradients accumulate in f32,
    each divided by G (``make_grad_fn``).  The state's params and moments
    are updated in place (``AdamW.update``); metrics are detached f32
    scalars.  ``hooks``: the sharded step's (``Strategy.hooks()``), with
    ``state`` this rank's shards: the global norm and the compression's
    scales are the whole gradient's.
    """
    grad_fn = make_grad_fn(model, hooks=hooks,
                           num_microbatches=num_microbatches,
                           aux_weight=aux_weight, remat=remat,
                           extra_inputs=extra_inputs)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state.params
        metrics, grads = grad_fn(params, batch)
        error_fb = state.error_fb
        if compress:
            grads, error_fb = compression.compress_grads(grads, error_fb,
                                                         hooks.params)
        gnorm = global_norm(grads, hooks.params)
        new_params, new_opt = optimizer.update(grads, state.opt, params,
                                               gnorm=gnorm)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
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
