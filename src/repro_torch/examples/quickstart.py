"""Quickstart: build any architecture, run forward / prefill / decode,
take a few train steps, and stream tokens through the online serving
session, at smoke scale.

  python -m repro_torch.examples.quickstart --arch qwen3-moe-235b-a22b
  python -m repro_torch.examples.quickstart --device cpu --steps 2

Port of ``examples/quickstart.py``.  On a card the Model path's prefill
takes the flash kernel (float32: the smoke configs' head dims 8 and 16
have an instance) and its decode the contiguous decode kernel, a MoE
model trains through the grouped-GEMM path (``moe_gemm`` and its
weight gradient), the ssm and hybrid families (zamba2, mamba2) train
through the SSD scan kernel and its backward (``ssd_scan_bwd``), and the
session serves through the paged decode kernels.  Every family runs to
the end on either device.

Two differences from the reference's example: the training batch's
``embeddings`` / ``encoder_frames`` are those of the batch (8 rows), not
the single row the reference passes (which fails for llava: its
``forward`` cannot concatenate a [1, ...] prefix to [8, ...] tokens), and
MoE training takes the grouped path.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.split_exec import supports_split
from repro_torch.models.model import Model, build_model
from repro_torch.runtime.engine import CrossPoolEngine, resolve_device
from repro_torch.runtime.request import Request
from repro_torch.runtime.sampler import sample
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import (TrainState, init_train_state,
                                             make_train_step)

SEQ = 32
DECODE_STEPS = 8


def model_inputs(cfg: ModelConfig, rng: np.random.Generator, device
                 ) -> tuple:
    """(tokens [1, S], the forward's extra inputs) drawn from ``rng`` in
    the reference's order: a vlm's stub embeddings, whisper's encoder
    frames, then the token ids."""
    kw = {}
    seq = SEQ
    if cfg.frontend == "vision_patches":
        kw["embeddings"] = torch.from_numpy(rng.normal(
            size=(1, cfg.frontend_tokens, cfg.d_model))).float().to(device)
        seq -= cfg.frontend_tokens
    if cfg.family == "audio":
        kw["encoder_frames"] = torch.from_numpy(rng.normal(
            size=(1, cfg.encoder_seq, cfg.d_model))).float().to(device)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, seq)).astype(np.int32)).to(device)
    return tokens, kw


def run_model(model: Model, params: Dict, tokens: torch.Tensor, kw: Dict
              ) -> Dict:
    """Forward, prefill (through the flash kernel), then
    ``DECODE_STEPS`` greedy decode steps: {"logits", "aux",
    "prefill_logits", "decoded"}."""
    seq = tokens.shape[1]
    with torch.no_grad():
        logits, aux = model.forward(params, tokens, **kw)
        cache = model.init_cache(1, seq + 16, tokens.device)
        step_logits, cache = model.prefill(params, tokens, cache,
                                           impl="flash", **kw)
        prefill_logits = step_logits
        out: List[int] = []
        tok = sample(step_logits)
        for i in range(DECODE_STEPS):
            out.append(int(tok[0]))
            step_logits, cache = model.decode_step(params, tok, cache,
                                                   seq + i, impl="paged")
            tok = sample(step_logits)
    return {"logits": logits, "aux": aux, "prefill_logits": prefill_logits,
            "decoded": out}


def train(model: Model, kw: Dict, seq: int, steps: int, device,
          params: Optional[Dict] = None) -> List[float]:
    """``steps`` AdamW steps on synthetic batches of 8 x ``seq`` tokens
    (with ``kw`` repeated over the batch), from ``params`` or a fresh
    init; the losses."""
    cfg = model.cfg
    optimizer = AdamW(lr=3e-3, warmup_steps=5)
    if params is None:
        state = init_train_state(
            model, optimizer, torch.Generator(device=device).manual_seed(1))
    else:
        state = TrainState(params, optimizer.init(params))
    step = make_train_step(
        model, optimizer, remat=False,
        extra_inputs=lambda b: dict({k: b[k] for k in kw},
                                    moe_path="grouped"))
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, 8))
    losses = []
    for i, batch in zip(range(steps), data.batches()):
        state, metrics = step(state, {
            "tokens": torch.from_numpy(batch["tokens"]).to(device),
            **{k: v.expand((8,) + tuple(v.shape[1:])) for k, v in kw.items()}})
        losses.append(float(metrics["loss"]))
        if i % 5 == 0 or i == steps - 1:
            print(f"train step {i:3d} loss {losses[-1]:.4f}")
    return losses


def session(cfg: ModelConfig, device, params: Optional[Dict] = None):
    """One request through the online session (submit / step / stream):
    (the streamed tokens, the request's handle)."""
    engine = CrossPoolEngine({cfg.name: cfg}, page_budget=512,
                             page_bytes=4096, slab_bytes=4096, max_batch=2,
                             max_ctx=64, device=device,
                             params=None if params is None
                             else {cfg.name: params})
    streamed: List[int] = []
    handle = engine.submit(Request(0, cfg.name, 8, 4, 0.0),
                           on_token=lambda e: streamed.append(e.token))
    while not handle.done:
        engine.step()
    return streamed, handle


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b",
                    choices=list(ARCH_NAMES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    model = build_model(cfg)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_counts()['total'] / 1e6:.2f}M (smoke)")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens, kw = model_inputs(cfg, np.random.default_rng(0), device)

    out = run_model(model, params, tokens, kw)
    print(f"forward: logits {tuple(out['logits'].shape)} aux_loss "
          f"{float(out['aux']):.4f}")
    print(f"decoded {DECODE_STEPS} tokens: {out['decoded']}")

    train(model, kw, tokens.shape[1], args.steps, device)

    if supports_split(cfg):
        streamed, handle = session(cfg, device)
        print(f"session streamed {streamed} "
              f"(admission={handle.admission}, state={handle.state.value})")
    print("quickstart OK")


if __name__ == "__main__":
    main()
