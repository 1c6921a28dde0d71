"""Architecture registry: 10 assigned archs + the paper's own colocation set.

``get_config(name)`` returns the full literature config;
``get_smoke_config(name)`` returns a reduced same-family config for CPU tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import (  # noqa: F401  (re-export)
    DEFAULT_DECODE_STEPS_PER_DISPATCH,
    CacheConfig,
    ElasticConfig,
    EngineConfig,
    FlightRecorderConfig,
    MLAConfig,
    ModelConfig,
    SHAPES,
    SHAPES_BY_NAME,
    ShapeConfig,
    SLObjective,
    SLOConfig,
    SSMConfig,
    shape_applicable,
)

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-14b": "qwen3_14b",
    "gemma3-12b": "gemma3_12b",
    "llama3-405b": "llama3_405b",
    "minicpm3-4b": "minicpm3_4b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-130m": "mamba2_130m",
    "llava-next-34b": "llava_next_34b",
    "whisper-small": "whisper_small",
}

ARCH_NAMES: Tuple[str, ...] = tuple(_ARCH_MODULES)

# The paper's own evaluated colocation set (§5.1): three cold MoE models.
# We map them onto reduced versions of our MoE/MLA families for the
# engine-level experiments (Fig. 6 / Fig. 7 / Table 3 reproduce at CPU scale).
PAPER_COLOC_SET: Tuple[str, ...] = (
    "qwen3-moe-235b-a22b",   # stands in for Qwen3-30B-A3B (same family)
    "moonshot-v1-16b-a3b",   # stands in for GLM-4.7-Flash (MoE)
    "minicpm3-4b",           # stands in for DeepSeek-V2-Lite (MLA)
)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
