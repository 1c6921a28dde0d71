"""Model facade: config -> init / forward / init_cache / prefill /
decode_step.

Port of ``src/repro/models/model.py``: the full-sequence ``forward``
(training; a vlm's stub ``embeddings`` prefix, whisper's
``encoder_frames``), and the dense-cache path of every family (the engine
serves the ssm and hybrid families through it; ``examples``-style
callers run any architecture).  ``impl`` picks the attention route as in
the reference: ``"flash"`` for prefill and ``"paged"`` for decode take
the hand-written kernels, ``"xla"`` the masked softmax.  The SSD scan
takes its kernel whenever the tensors lie on a card.  ``hooks``
(``models/hooks.py``) is the sharding seam, as the reference's
(``model.py:40, 61, 68``); the default is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tfm
from repro_torch.models.hooks import IDENTITY_HOOKS, Hooks


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator) -> Dict:
        return tfm.init_params(gen, self.cfg)

    def param_specs(self) -> Dict:
        """The param tree on ``meta``: ``init``'s shapes and dtypes, no
        storage (the reference's ``jax.eval_shape`` of ``init``)."""
        return tfm.param_shapes(self.cfg)

    def forward(self, params: Dict, tokens: torch.Tensor, *,
                embeddings: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None,
                hooks: Hooks = IDENTITY_HOOKS, impl: str = "xla"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return tfm.forward(params, self.cfg, tokens, embeddings=embeddings,
                           encoder_frames=encoder_frames, impl=impl,
                           hooks=hooks)

    def init_cache(self, batch: int, max_len: int, device,
                   kv_dtype: Optional[str] = None) -> Dict:
        return dec.init_cache(self.cfg, batch, max_len, device, kv_dtype)

    def cache_specs(self, batch: int, max_len: int,
                    kv_dtype: Optional[str] = None) -> Dict:
        """``init_cache``'s tree on ``meta``: shapes and dtypes only."""
        return self.init_cache(batch, max_len, "meta", kv_dtype)

    def prefill(self, params: Dict, tokens: torch.Tensor, cache: Dict, *,
                embeddings: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None,
                hooks: Hooks = IDENTITY_HOOKS, impl: str = "xla",
                logit_index: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        return dec.prefill(params, self.cfg, tokens, cache,
                           embeddings=embeddings,
                           encoder_frames=encoder_frames, impl=impl,
                           logit_index=logit_index, hooks=hooks)

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    lengths, *, hooks: Hooks = IDENTITY_HOOKS,
                    impl: str = "xla") -> Tuple[torch.Tensor, Dict]:
        return dec.decode_step(params, self.cfg, tokens, cache, lengths,
                               hooks=hooks, impl=impl)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
