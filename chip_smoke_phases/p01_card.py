"""Phase 1 of ``chip_smoke.py``: prints the card's name and power limit
(nvidia-smi) and turns TF32 off for float32 matmuls and convolutions."""
from __future__ import annotations

import subprocess

from chip_smoke_phases.common import log


def run(torch) -> str:
    """The card's ``name, power limit`` line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card
