"""Phase 6 of ``chip_smoke.py``: the same engine over zamba2-1.2b and
mamba2-130m at their fallback FULL published configs (no depth cut),
bf16, through the dense-cache fallback path: 8 requests (4 per model),
the same prompts and outputs, K=1. The same checks, and flash prefill (6
per zamba2 prompt), the SSD scan (32 per zamba2 and 24 per mamba2
prompt) and contiguous decode (6 per zamba2 decode step, one graph
replay each) must have launched that many times;
"""
from __future__ import annotations


from chip_smoke_phases.common import FALLBACK_MODELS, log
from chip_smoke_phases.p05_serve import check_fallback, serve_phase


def run(ctx) -> None:
    """Serve the dense-cache fallback path: full published configs."""
    from repro_torch.configs import get_config
    log(f"serve fallback: {', '.join(FALLBACK_MODELS)} at their full "
        f"published configs, K=1")
    f_launches, f_serve = serve_phase(
        ctx.torch, ctx.np, ctx.kops,
        {n: get_config(n) for n in FALLBACK_MODELS}, k=1,
        page_budget=32768, label="serve fallback", check=check_fallback)
    ctx.out[6] = dict(f_launches=f_launches, f_serve=f_serve)
