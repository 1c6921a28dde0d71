"""Train a small member of the qwen3-moe family (4 layers, d_model 256,
16 experts, top-2) for a few hundred steps: the training substrate end
to end.

  python -m repro_torch.examples.train_moe --steps 200
  python -m repro_torch.examples.train_moe --device cpu --steps 60

Port of ``examples/train_moe.py``, with the same flags and checks, plus
``--device`` (the card unless ``cpu`` is given; without a card it
raises).  Demonstrates the routed-expert FFN with its load-balance aux
loss, microbatched gradient accumulation, remat, async checkpoints
every 100 steps (``--ckpt-dir``, else a fresh temporary directory) and,
with
``--compress``, error-feedback int8 gradient compression.  The experts
run through the grouped-GEMM path (``moe_gemm`` and its weight
gradient: the CUDA kernels on a card); the reference's example takes the
capacity path, which the port keeps for serving.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, build_model
from repro_torch.runtime.engine import resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import init_train_state, make_train_step

#: the ~100M-param member of the qwen3-moe family: its published config
#: with these fields replaced
MEMBER = dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
              d_ff=256, n_experts=16, experts_per_token=2, vocab_size=2048,
              max_position=2048, dtype="float32")
#: AdamW's learning rate and warmup steps
LR, WARMUP = 3e-3, 20


def member_config() -> ModelConfig:
    return get_config("qwen3-moe-235b-a22b").replace(**MEMBER)


def make_step(model: Model, *, microbatches: int, compress: bool):
    """(optimizer, step): AdamW, remat, ``microbatches`` accumulated per
    step, the experts on the grouped-GEMM path."""
    optimizer = AdamW(lr=LR, warmup_steps=WARMUP)
    step = make_train_step(
        model, optimizer, num_microbatches=microbatches, compress=compress,
        remat=True, extra_inputs=lambda b: {"moe_path": "grouped"})
    return optimizer, step


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the checkpoints go (default: a fresh "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = member_config()
    model = build_model(cfg)
    n_params = cfg.param_counts()["total"]
    print(f"training {n_params / 1e6:.1f}M-param MoE "
          f"({cfg.n_experts} experts, top-{cfg.experts_per_token})")

    optimizer, step = make_step(model, microbatches=args.microbatches,
                                compress=args.compress)
    state = init_train_state(model, optimizer,
                             torch.Generator(device=device).manual_seed(0),
                             compress=args.compress)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  noise=0.05))

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_moe_ckpt_")
    losses = []
    writer = None
    t0 = time.time()
    for i, batch in zip(range(args.steps), data.batches()):
        state, metrics = step(state, {
            "tokens": torch.from_numpy(batch["tokens"]).to(device)})
        losses.append(float(metrics["ce"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} ce {losses[-1]:.4f} "
                  f"aux {float(metrics['aux']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        if (i + 1) % 100 == 0:
            if writer is not None:
                writer.join()
            writer = ckpt.save_async(state, i + 1, ckpt_dir)
    if writer is not None:
        writer.join()                       # the last write lands
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"{args.steps} steps in {dt:.0f}s ({tok_s:.0f} tok/s)")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"ce: {first:.3f} -> {last:.3f}")
    assert last < first * 0.8, "MoE failed to learn"
    print("train_moe OK")
    return {"seconds": dt, "tokens_per_s": tok_s, "first_ce": float(first),
            "last_ce": float(last), "checkpoint_dir": ckpt_dir}


if __name__ == "__main__":
    main()
