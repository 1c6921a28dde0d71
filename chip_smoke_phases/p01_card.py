"""Phase 1 of ``chip_smoke.py``: prints the card's name and power limit
(nvidia-smi), holds ``launch/mesh.py``'s ``HBM_BYTES`` equal to the
memory an H100 80GB HBM3 reports, and turns TF32 off for float32 matmuls
and convolutions."""
from __future__ import annotations

import subprocess

from chip_smoke_phases.common import log


#: the card ``launch/mesh.py``'s ``HBM_BYTES`` describes
HBM_CARD = "NVIDIA H100 80GB HBM3"


def check_hbm_bytes(torch) -> None:
    """``HBM_BYTES`` against ``total_memory`` of the card, which must
    equal it on the card the constant describes; any other card's figure
    is printed beside it."""
    from repro_torch.launch.mesh import HBM_BYTES
    name = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"{name}: total_memory {total} B; launch/mesh.py HBM_BYTES "
        f"{HBM_BYTES} B")
    if name == HBM_CARD and total != HBM_BYTES:
        raise AssertionError(f"{name} reports {total} B of memory, "
                             f"launch/mesh.py's HBM_BYTES says {HBM_BYTES}")


def run(torch) -> str:
    """The card's ``name, power limit`` line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    check_hbm_bytes(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card
