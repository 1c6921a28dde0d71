"""Training launcher: real steps on one device.

  python -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 100
  python -m repro_torch.launch.train --device cpu --arch qwen3-14b --smoke

Port of ``src/repro/launch/train.py``: the same flags (float32, AdamW with
10 warm-up steps, periodic async checkpoints, resume from the latest
step, a straggler counter per step), plus ``--device``: the card by
default, ``cpu`` for the plain kernel versions; without a card and
without ``--device cpu`` it raises.  ``--dry-run`` (the reference's
fleet-scale lowering) is not ported and raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config for host-scale real training")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="error-feedback int8 gradient compression")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--dry-run", action="store_true",
                    help="the reference's fleet-scale lowering (not ported)")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    if args.dry_run or args.multi_pod:
        raise NotImplementedError("--dry-run / --multi-pod lower the "
                                  "reference's sharded step; not ported")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to train on the "
                           "CPU")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(dtype="float32")
    model = build_model(cfg)
    optimizer = AdamW(lr=args.lr, warmup_steps=10)
    step_fn = make_train_step(model, optimizer,
                              num_microbatches=args.microbatches,
                              compress=args.compress, remat=False)

    state = init_train_state(model, optimizer,
                             torch.Generator(device=device).manual_seed(0),
                             compress=args.compress)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start = ckpt.restore(args.ckpt_dir, target_tree=state,
                                    device=device)
        print(f"resumed from step {start}")

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    slow = 0
    times = []
    writer = None
    for i, batch in zip(range(start, args.steps), data.batches(start)):
        t0 = time.perf_counter()
        tokens = torch.from_numpy(batch["tokens"]).to(device)
        state, metrics = step_fn(state, {"tokens": tokens})
        loss = float(metrics["loss"])          # waits for the step
        dt = time.perf_counter() - t0
        if len(times) > 5 and dt > np.median(times) * 4:
            slow += 1                       # straggler counter
        times.append(dt)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {loss:.4f} ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = ckpt.save_async(state, i + 1, args.ckpt_dir)
    if writer is not None:
        writer.join()                       # the last write lands
    print(f"done: {args.steps - start} steps, median "
          f"{np.median(times) * 1e3:.0f} ms/step, {slow} straggler steps")


if __name__ == "__main__":
    main()
