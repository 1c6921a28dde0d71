"""Model facade: config -> init / forward / init_cache / prefill /
decode_step.

Port of ``src/repro/models/model.py``: the full-sequence ``forward`` the
training substrate runs, and the fused dense-cache path (the ssm and
hybrid families) the engine's fallback runner calls.
``impl`` picks the attention route as in the reference: ``"flash"`` for
prefill and ``"paged"`` for decode take the hand-written kernels,
``"xla"`` the masked softmax.  The SSD scan takes its kernel whenever the
tensors lie on a card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tfm


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator) -> Dict:
        return tfm.init_params(gen, self.cfg)

    def forward(self, params: Dict, tokens: torch.Tensor, *,
                impl: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
        return tfm.forward(params, self.cfg, tokens, impl=impl)

    def init_cache(self, batch: int, max_len: int, device) -> Dict:
        return dec.init_cache(self.cfg, batch, max_len, device)

    def prefill(self, params: Dict, tokens: torch.Tensor, cache: Dict, *,
                impl: str = "xla", logit_index: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        return dec.prefill(params, self.cfg, tokens, cache, impl=impl,
                           logit_index=logit_index)

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    lengths: torch.Tensor, *, impl: str = "xla"
                    ) -> Tuple[torch.Tensor, Dict]:
        return dec.decode_step(params, self.cfg, tokens, cache, lengths,
                               impl=impl)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
