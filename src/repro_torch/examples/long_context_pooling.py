"""Long-context burst into the shared KV pool: the paper's Fig. 6
scenario end to end at host scale.

  python -m repro_torch.examples.long_context_pooling [--device cpu]

Port of ``examples/long_context_pooling.py``.  A burst of LongAlign-like
long-context requests arrives for ONE cold model while two other models
idle-hold their weights.  Under a static per-model partition the burst
would be rejected (the per-model KV slice is too small); under the
CrossPool shared pool the planner's budget absorbs it (host bookkeeping
only: no pool tensor is allocated).  Then an MLA request's latent KV is
written into the virtualizer's pool with ``write_tokens``, read back
through ``page_table_array`` and ``typed_pages``, packed as K = V with
one kv head and attended by the paged decode kernel in float32, as the
reference does, and held against the plain version at 2e-5.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.admission import AdmissionController, PendingRequest
from repro_torch.core.virtualizer import KVVirtualizer
from repro_torch.kernels import ops, ref
from repro_torch.runtime.engine import resolve_device

#: the burst's model: the GQA MoE model with the fattest KV per token
#: (MLA's compressed KV is deliberately tiny, its own selling point)
BURST_MODEL = "moonshot-v1-16b-a3b"
MLA_MODEL = "minicpm3-4b"
TOL = 2e-5


def admission_burst(models: Dict[str, ModelConfig], *, total_pages: int,
                    page_bytes: int, long_ctx: int, n: int = 4) -> Dict:
    """``n`` requests of ``long_ctx`` tokens for ``BURST_MODEL`` offered
    to one shared pool of ``total_pages`` pages, against a static
    partition that gives each model a third of them."""
    static_share = total_pages // 3
    virt = KVVirtualizer(models, page_budget=total_pages,
                         page_bytes=page_bytes, allocate_device_pool=False,
                         device="cpu")
    ac = AdmissionController(virt, max_queue_per_model=2)
    need = virt.views[BURST_MODEL].pages_for(long_ctx)
    outcomes = [ac.offer(PendingRequest(i, BURST_MODEL, long_ctx, 0, 0.0),
                         0.0) for i in range(n)]
    return {"need": need, "static_share": static_share,
            "admitted_shared": outcomes.count("admitted"),
            "admitted_static": min(static_share // need, n)}


def packed_latent(typed: torch.Tensor, r: int) -> torch.Tensor:
    """An MLA pool's latent (``typed`` [pages, tpp, r + rope]) packed as
    the GQA kernel's pages [pages, tpp, 2, 1, r] in float32: K = V =
    latent, one kv head (a copy)."""
    lat = typed[..., :r]
    return torch.stack([lat, lat], dim=2)[:, :, :, None, :].float()


def pool_attention(cfg: ModelConfig, *, device, n_tokens: int,
                   page_budget: int, page_bytes: int, max_pages: int,
                   seed: int = 0) -> Dict:
    """Write one request's latent KV (``n_tokens`` tokens of layer 0,
    drawn from ``np.random.default_rng(seed)``) into a bf16 pool, read it
    back through the page table and attend over the latent with the
    paged decode kernel in float32, held against the plain version at
    ``TOL``: {"out", "max_abs_err", "utilization"} (the pool's)."""
    name, r = cfg.name, cfg.mla.kv_lora_rank
    virt = KVVirtualizer({name: cfg}, page_budget=page_budget,
                         page_bytes=page_bytes, device=device)
    virt.register_request(0, name, prompt_tokens=n_tokens)
    view = virt.views[name]
    rng = np.random.default_rng(seed)
    kv = torch.from_numpy(rng.normal(size=(n_tokens, *view.kv_shape))).to(
        torch.bfloat16)
    virt.write_tokens(name, 0, 0, 0, kv)
    table = virt.page_table_array([0], 0, max_pages=max_pages)
    packed = packed_latent(virt.typed_pages(name), r)
    q = torch.from_numpy(rng.normal(size=(1, 1, cfg.n_heads, r))).float().to(
        virt.device)
    lengths = torch.tensor([n_tokens], dtype=torch.int32, device=virt.device)
    scale = r ** -0.5
    out = ops.paged_decode_attention(q, packed.reshape(packed.shape[0], -1),
                                     table, lengths,
                                     tokens_per_page=view.tokens_per_page,
                                     n_kv=1, scale=scale)
    want = ref.paged_decode_attention(q, packed, table, lengths, scale)
    err = (out - want).abs()
    if not bool((err <= TOL + TOL * want.abs()).all()):
        raise AssertionError(f"paged attention over the virtualized pool "
                             f"disagrees with the plain version (max abs "
                             f"err {err.max().item():.3g}, tolerance {TOL})")
    return {"out": out, "max_abs_err": err.max().item(),
            "utilization": virt.utilization()}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    models = {n: get_smoke_config(n) for n in PAPER_COLOC_SET}

    long_ctx = 1024                         # "long" at smoke scale
    burst = admission_burst(models, total_pages=512, page_bytes=4096,
                            long_ctx=long_ctx)
    need, static_share = burst["need"], burst["static_share"]
    print(f"burst: 4 x {long_ctx}-token requests for {BURST_MODEL} "
          f"({need} pages each; static share = {static_share} pages)")
    assert need > static_share // 2, "burst must stress the static share"
    print(f"shared pool admitted {burst['admitted_shared']}/4; a static "
          f"partition would admit {burst['admitted_static']}/4")
    assert burst["admitted_shared"] > burst["admitted_static"]

    # --- paged decode attention through the virtualizer (MLA model) ------
    res = pool_attention(models[MLA_MODEL], device=device, n_tokens=48,
                         page_budget=64, page_bytes=2048, max_pages=8)
    print(f"paged attention over the virtualized pool: out "
          f"{tuple(res['out'].shape)}, matches oracle (max abs err "
          f"{res['max_abs_err']:.3g})")
    print(f"pool util: {res['utilization']}")
    print("long_context_pooling OK")


if __name__ == "__main__":
    main()
