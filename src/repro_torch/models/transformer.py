"""Model parameters, the full-sequence sub-blocks and the forward, for
every family.

Port of ``src/repro/models/transformer.py``: ``init_params`` (``:106``)
for the dense / MoE / VLM decoders with GQA or MLA attention (gemma3's
sliding-window layers included), the ssm and hybrid (zamba2) families and
the whisper encoder-decoder, ``embed_inputs`` (``:152``, with the stub
modality prefix and sinusoidal positions), ``_logits`` (``:165``),
``_attn_full`` (``:175``), ``_ffn_full`` (``:186``), ``forward``
(``:207``), ``_cross_kv`` / ``encode`` (``:303-332``) and the
sliding-window forward's ``_swa_global_flags`` (``:335``).  The param
tree has the reference's shape: per-layer leaves stacked on a leading
axis under ``"layers"`` (and ``"tail"``, ``"enc_layers"``), the hybrid's
ONE shared attention + MLP block under ``"shared_block"``, so
``repro_torch.bridge`` maps a reference tree onto it leaf for leaf.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe as moe_mod, ssm as ssm_mod
from repro_torch.models.hooks import IDENTITY_HOOKS, Hooks


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    zeros = dict(dtype=dtype, device=gen.device)
    p = {
        "ln1": torch.zeros((cfg.d_model,), **zeros),
        "attn": (attn.init_mla(gen, cfg, dtype) if cfg.attention == "mla"
                 else attn.init_gqa(gen, cfg, dtype)),
        "ln2": torch.zeros((cfg.d_model,), **zeros),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                                   dtype)
    return p


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    return {"ln": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
            "ssm": ssm_mod.init_ssm(gen, cfg, dtype)}


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """A whisper encoder layer (``transformer.py:80``)."""
    zeros = dict(dtype=dtype, device=gen.device)
    return {"ln1": torch.zeros((cfg.d_model,), **zeros),
            "attn": attn.init_gqa(gen, cfg, dtype),
            "ln2": torch.zeros((cfg.d_model,), **zeros),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                                   dtype)}


def _init_encdec_layer(gen: torch.Generator, cfg: ModelConfig, dtype
                       ) -> Dict:
    """A whisper decoder layer: self, cross and MLP (``:90``)."""
    zeros = dict(dtype=dtype, device=gen.device)
    return {"ln1": torch.zeros((cfg.d_model,), **zeros),
            "self": attn.init_gqa(gen, cfg, dtype),
            "ln2": torch.zeros((cfg.d_model,), **zeros),
            "cross": attn.init_gqa(gen, cfg, dtype),
            "ln3": torch.zeros((cfg.d_model,), **zeros),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                                   dtype)}


def _keep(cut, tree, path: str):
    """``cut(path, leaf)`` over a drawn tree's leaves (None: the tree)."""
    if cut is None:
        return tree
    if isinstance(tree, dict):
        return {k: _keep(cut, v, f"{path}/{k}") for k, v in tree.items()}
    return cut(path, tree)


def _stack_draw(n: int, draw, cut, path: str):
    """``n`` layers drawn one at a time by ``draw()`` and stacked on a
    leading axis: each layer is copied into the stacked leaves as it is
    drawn (and ``cut``), so only one layer is ever held beside them."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)

    def put(dst, t, i):
        if isinstance(t, dict):
            for k, v in t.items():
                put(dst[k], v, i)
        else:
            dst[i].copy_(t)

    first = _keep(cut, draw(), path)
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, _keep(cut, draw(), path), i)
    return out


def init_params(gen: torch.Generator, cfg: ModelConfig, cut=None) -> Dict:
    """Random decoder params drawn from ``gen`` on ``gen.device``.

    The reference draws from ``jax.random`` keys, which torch cannot
    reproduce: the same config gives the same SHAPES and scales here, not
    the same numbers (tests bridge the reference's own tree instead).
    ``cut(path, leaf)``, when given, keeps a part of each leaf as it is
    drawn (``path`` the tree's, ``leaf`` one layer's slice of a stacked
    leaf): the draw is the same, and the whole tree is never held
    (``launch/dryrun.py`` ``draw_params``).
    """
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {cfg.family}")
    dtype = dtype_of(cfg)
    zeros = dict(dtype=dtype, device=gen.device)
    p: Dict = {
        "embed": _keep(cut, layers.init_embed(gen, cfg.vocab_size,
                                              cfg.d_model, dtype,
                                              cfg.tie_embeddings), "embed"),
        "final_norm": _keep(cut, torch.zeros((cfg.d_model,), **zeros),
                            "final_norm"),
    }

    def stack(name, n, init):
        return _stack_draw(n, lambda: init(gen, cfg, dtype), cut, name)

    # one layer at a time: the draw's f32 temporaries stay one layer big
    if cfg.family in ("dense", "moe", "vlm"):
        p["layers"] = stack("layers", cfg.n_layers, _init_layer)
    elif cfg.family == "audio":
        p["enc_layers"] = stack("enc_layers", cfg.n_encoder_layers,
                                _init_enc_layer)
        p["enc_norm"] = _keep(cut, torch.zeros((cfg.d_model,), **zeros),
                              "enc_norm")
        p["layers"] = stack("layers", cfg.n_layers, _init_encdec_layer)
    elif cfg.family == "ssm":
        p["layers"] = stack("layers", cfg.n_layers, _init_ssm_layer)
    else:
        n_ssm = cfg.hybrid_groups * cfg.ssm_per_group
        p["layers"] = stack("layers", n_ssm, _init_ssm_layer) if n_ssm \
            else {}
        if cfg.tail_ssm_layers:
            p["tail"] = stack("tail", cfg.tail_ssm_layers, _init_ssm_layer)
        # the zamba2 hallmark: ONE shared attention + MLP block, reused by
        # every group
        p["shared_block"] = _keep(cut, _init_layer(gen, cfg, dtype),
                                  "shared_block")
    return p


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: the model's
    own init then builds a shape-only tree."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg: ModelConfig) -> Dict:
    """The param tree of ``cfg`` as meta tensors (no allocation)."""
    return init_params(_MetaGenerator(), cfg)


def embed_inputs(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                 embeddings: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None,
                 hooks: Hooks = IDENTITY_HOOKS) -> torch.Tensor:
    """tokens [B,S_txt] -> [B,S,D]: the stub modality embeddings
    [B,S_emb,D] (llava's patches) prepended when given, and whisper's
    sinusoidal positions added when ``rope_theta == 0`` and ``positions``
    [B,S] are given (``transformer.py:152-162``).  Under the sharded
    step's hooks the table is gathered over the pool axes and looked up
    over its vocabulary split (``layers.embed_tokens``), and the result
    split over S when the residual stream is (``hooks.tp.seq``); under
    the serve step's ``hooks.rows`` (rows split over ``model``) the ids
    of the rank's ``model`` group are looked up and its own rows kept."""
    rows = hooks.rows
    x = rows.split(layers.embed_tokens(
        _embed_leaf(params, "tok", hooks), rows.gather(tokens, 0),
        cfg.vocab_size, hooks.tp), 0)
    if embeddings is not None:
        x = torch.cat([embeddings.to(x.dtype), x], dim=1)
    if cfg.rope_theta == 0 and positions is not None:
        x = x + layers.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return hooks.tp.split(x, 1) if hooks.tp.seq else x


def positions_of(B: int, S: int, device) -> torch.Tensor:
    """[B,S] positions 0..S-1 of every row."""
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            hooks: Hooks = IDENTITY_HOOKS) -> torch.Tensor:
    """The final norm and the head; under the sharded step's hooks the
    head's vocabulary may split over ``model`` (logits [.., V/tp]).
    Under the serve step's ``hooks.rows`` (monolithic DP attention, whose
    logits keep the vocabulary whole) the rows of the rank's ``model``
    group are projected and this rank's rows returned over every id."""
    tp, rows = hooks.tp, hooks.rows
    norm = hooks.params.gather(params["final_norm"], "final_norm")
    x = tp.seq_in(layers.rms_norm(x, tp.seq_weight(norm), cfg.norm_eps))
    head = "head" if "head" in params["embed"] else "tok"
    logits = layers.unembed(_embed_leaf(params, head, hooks),
                            rows.gather(x, 0), cfg.vocab_size, tp)
    if rows.size > 1:
        if logits.shape[-1] < cfg.vocab_size:
            logits = tp.gather(logits, -1)
        logits = rows.split(logits, 0)
    return hooks.logits(logits)


def _embed_leaf(params: Dict, name: str, hooks: Hooks) -> Dict:
    """``{name: params["embed"][name]}``, gathered over the pool axes
    (only the leaf that is read: the head's gather is the table's
    size)."""
    return {name: hooks.params.gather(params["embed"][name],
                                      f"embed/{name}")}


def _attn_full(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, impl: str = "xla", window: int = 0,
               hooks: Hooks = IDENTITY_HOOKS):
    """Pre-norm full-sequence attention + residual: (x, layer_kv);
    ``window`` > 0 bounds a GQA layer to its sliding window.  Under
    sequence parallelism the block reads the whole sequence
    (``tp.seq_in``) and the attention returns the residual's layout."""
    tp = hooks.tp
    h = tp.seq_in(layers.rms_norm(x, tp.seq_weight(p_l["ln1"]),
                                  cfg.norm_eps))
    if cfg.attention == "mla":
        out, kv = attn.mla_full(p_l["attn"], cfg, h, positions, hooks=hooks)
    else:
        out, kv = attn.gqa_full(p_l["attn"], cfg, h, positions,
                                window=window, impl=impl, hooks=hooks)
    return x + hooks.act(out), kv


def _ffn_full(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
              moe_path: str = "capacity", hooks: Hooks = IDENTITY_HOOKS,
              ln: str = "ln2", row_mask: Optional[torch.Tensor] = None,
              real_rows: Optional[int] = None):
    """Pre-norm (``p_l[ln]``) MLP or routed-expert FFN + residual: (x,
    aux).  MoE layers
    take ``hooks.moe_apply`` when set (the explicit all-to-all dispatch,
    ``transformer.py:191-192``), else the capacity path (``apply_moe``)
    or the grouped-GEMM path (``apply_moe_grouped``); a dense layer's aux
    is 0.  ``hooks.boundary_in`` / ``boundary_out`` bracket the FFN: the
    pool boundary.  Under the sharded training step's hooks the dense
    MLP's hidden splits over ``tp`` (its partial sums reduced back to the
    residual's layout, ``tp.seq_out``), and under sequence parallelism
    the FFN reads the whole sequence (``tp.seq_in``).  ``row_mask``
    ([B] bool, a padded train batch's real rows; ``real_rows`` of them
    over every batch rank) keeps pad rows out of the MoE's batch
    statistics."""
    tp = hooks.tp
    h = tp.seq_in(hooks.boundary_in(
        layers.rms_norm(x, tp.seq_weight(p_l[ln]), cfg.norm_eps)))
    partial = False
    if cfg.is_moe:
        if moe_path not in ("capacity", "grouped"):
            raise ValueError(f"unknown moe_path {moe_path!r}")
        if hooks.moe_apply is not None:
            if row_mask is not None:
                raise NotImplementedError(
                    "the all-to-all expert dispatch takes no padded rows")
            f, aux = hooks.moe_apply(p_l["moe"], h)
        else:
            fn = (moe_mod.apply_moe if moe_path == "capacity"
                  else moe_mod.apply_moe_grouped)
            f, aux = fn(p_l["moe"], h, cfg, hooks=hooks, row_mask=row_mask,
                        real_rows=real_rows)
    else:
        f, partial = layers.apply_mlp_split(
            p_l["mlp"], h, cfg.mlp_kind, cfg.d_ff, tp,
            hook=hooks.ffn_hidden, down=hooks.ffn_down)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + hooks.act(hooks.boundary_out(tp.seq_out(f, partial))), aux


def _unstack(tree, n: int):
    """Stacked per-layer leaves [n, ...] -> n per-layer trees of views
    (one ``unbind`` per leaf, so the backward stacks each leaf's n
    gradients once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return torch.unbind(tree)


def _call(body, remat: bool, *args):
    """``body(*args)``, activations recomputed in the backward when
    ``remat`` (the reference's ``jax.checkpoint`` of the scan body)."""
    if remat:
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeddings: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None,
            impl: str = "xla", moe_path: str = "capacity",
            remat: bool = False, hooks: Hooks = IDENTITY_HOOKS,
            row_mask: Optional[torch.Tensor] = None,
            real_rows: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (training, prefill without a cache):
    (logits [B,S,V], aux scalar f32).

    Port of ``transformer.py:207-300`` for every family: the dense / vlm
    / moe decoders (GQA or MLA attention; gemma3's layers by the masked
    softmax, windowed on the local ones; MoE by ``moe_path``, the aux
    loss averaged over the layers; the vlm's stub ``embeddings``
    prefix), the ssm and hybrid stacks, and the whisper decoder over
    ``encode(encoder_frames)``.
    ``remat=True`` recomputes each layer's (each hybrid group's)
    activations in the backward.  ``row_mask`` ([B] bool): the real rows
    of a batch the sharded train cell padded, ``real_rows`` of them over
    every batch rank; the MoE layers keep the others out of their
    capacity, slots and load-balance loss (no other layer mixes rows).
    """
    fam = cfg.family
    if fam not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {fam}")
    B = tokens.shape[0]
    S = tokens.shape[1] + (embeddings.shape[1] if embeddings is not None
                           else 0)
    positions = positions_of(B, S, tokens.device)
    x = embed_inputs(params, cfg, tokens, embeddings, positions, hooks)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(xc, p_l, is_global=True):
        # the layer's FSDP gather, inside the rematerialised body: the
        # backward gathers again (ZeRO-3)
        p_l = hooks.params.gather(p_l, "layers")
        if cfg.sliding_window:
            # the reference's ``_attn_full_swa`` (:343-364): the masked
            # softmax for every layer, bounded to the window on the local
            # ones
            xc, _ = _attn_full(p_l, cfg, xc, positions, "xla",
                               0 if is_global else cfg.sliding_window, hooks)
        else:
            xc, _ = _attn_full(p_l, cfg, xc, positions, impl, hooks=hooks)
        return _ffn_full(p_l, cfg, xc, moe_path, hooks, row_mask=row_mask,
                         real_rows=real_rows)

    def ssm_block(xc, p_l, top="layers"):
        p_l = hooks.params.gather(p_l, top)
        tp = hooks.tp
        h = tp.seq_in(layers.rms_norm(xc, tp.seq_weight(p_l["ln"]),
                                      cfg.norm_eps))
        out, _ = ssm_mod.ssm_full(p_l["ssm"], cfg, h, hooks=hooks)
        return xc + hooks.act(out)

    if fam in ("dense", "vlm", "moe"):
        flags = _swa_global_flags(cfg)
        for p_l, glob in zip(_unstack(params["layers"], cfg.n_layers),
                             flags):
            x, a = _call(block, remat, x, p_l, glob)
            aux = aux + a
        return _logits(params, cfg, x, hooks), aux / max(cfg.n_layers, 1)
    if fam == "ssm":
        for p_l in _unstack(params["layers"], cfg.n_layers):
            x = _call(ssm_block, remat, x, p_l)
        return _logits(params, cfg, x, hooks), aux
    if fam == "audio":
        enc_out = encode(params, cfg, encoder_frames, hooks)

        def dec_block(xc, p_l):
            return _decoder_layer(hooks.params.gather(p_l, "layers"), cfg,
                                  xc, positions, enc_out, impl, hooks)[0]

        for p_l in _unstack(params["layers"], cfg.n_layers):
            x = _call(dec_block, remat, x, p_l)
        return _logits(params, cfg, x, hooks), aux

    per = cfg.ssm_per_group
    ssm_layers = _unstack(params["layers"], cfg.hybrid_groups * per)

    def group(xc, group_layers):
        for p_l in group_layers:
            xc = ssm_block(xc, p_l)
        shared = hooks.params.gather(params["shared_block"], "shared_block")
        xc, _ = _attn_full(shared, cfg, xc, positions, impl, hooks=hooks)
        xc, _ = _ffn_full(shared, cfg, xc, hooks=hooks)
        return xc

    for g in range(cfg.hybrid_groups):
        x = _call(group, remat, x, ssm_layers[g * per:(g + 1) * per])
    if cfg.tail_ssm_layers:
        for p_l in _unstack(params["tail"], cfg.tail_ssm_layers):
            x = ssm_block(x, p_l, "tail")
    return _logits(params, cfg, x, hooks), aux


# ---------------------------------------------------------------------------
# whisper: the encoder and the decoder layer
# ---------------------------------------------------------------------------

def _cross_kv(p_attn: Dict, cfg: ModelConfig, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K, V [B,T_enc,KV,hd] of the encoder output (the
    heads of ``p_attn``'s columns: every head, or ``rank_heads``')."""
    B, T, _ = enc_out.shape
    hd = cfg.head_dim
    return ((enc_out @ p_attn["wk"]).reshape(B, T, -1, hd),
            (enc_out @ p_attn["wv"]).reshape(B, T, -1, hd))


def encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor,
           hooks: Hooks = IDENTITY_HOOKS) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B,T_enc,D]
    (``transformer.py:311-332``): sinusoidal positions, then pre-norm
    non-causal self-attention + MLP layers and a final norm.  Under the
    sharded step's hooks the layers run as the decoder families' do: the
    attention on this rank's heads, the MLP over its part of the hidden
    across the pool boundary; under sequence parallelism the frames'
    stream stays whole (``tp.whole_seq``): only the decoder's splits."""
    if hooks.tp.seq:
        hooks = replace(hooks, tp=hooks.tp.whole_seq())
    B, T, _ = frames.shape
    pos = positions_of(B, T, frames.device)
    x = frames + layers.sinusoidal_positions(pos, cfg.d_model).to(
        frames.dtype)
    for p_l in _unstack(params["enc_layers"], cfg.n_encoder_layers):
        p_l = hooks.params.gather(p_l, "enc_layers")
        h = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        out, _ = attn.gqa_full(p_l["attn"], cfg, h, pos, causal=False,
                               hooks=hooks)
        x, _ = _ffn_full(p_l, cfg, x + hooks.act(out), hooks=hooks)
    norm = hooks.params.gather(params["enc_norm"], "enc_norm")
    return layers.rms_norm(x, norm, cfg.norm_eps)


def _decoder_layer(p_l: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, enc_out: torch.Tensor,
                   impl: str = "xla", hooks: Hooks = IDENTITY_HOOKS):
    """One whisper decoder layer over the whole sequence: causal self-
    attention (``impl`` routes it), non-causal cross-attention over the
    encoder output, MLP.  Under sequence parallelism each block reads the
    whole sequence (``tp.seq_in``) and returns the residual's layout, as
    ``_attn_full`` / ``_ffn_full``.  Returns (x, (k, v) self, (k, v)
    cross): the heads of the ``self`` / ``cross`` weights (the serve step
    cuts them to a cache's, ``decode._audio_layer``)."""
    tp = hooks.tp
    h = tp.seq_in(layers.rms_norm(x, tp.seq_weight(p_l["ln1"]),
                                  cfg.norm_eps))
    out, self_kv = attn.gqa_full(p_l["self"], cfg, h, positions, impl=impl,
                                 hooks=hooks)
    x = x + hooks.act(out)
    cross_kv = _cross_kv(p_l["cross"], cfg, enc_out)
    h = tp.seq_in(layers.rms_norm(x, tp.seq_weight(p_l["ln2"]),
                                  cfg.norm_eps))
    out, _ = attn.gqa_full(p_l["cross"], cfg, h, positions,
                           kv_override=cross_kv, causal=False, hooks=hooks)
    x, _ = _ffn_full(p_l, cfg, x + hooks.act(out), hooks=hooks, ln="ln3")
    return x, self_kv, cross_kv


# ---------------------------------------------------------------------------
# sliding window (gemma3): per-layer global / local flag
# ---------------------------------------------------------------------------

def _swa_global_flags(cfg: ModelConfig) -> List[bool]:
    """[L] flags, True where the layer attends globally: every
    ``swa_pattern``-th layer, or all of them without a pattern."""
    if cfg.swa_pattern == 0:
        return [True] * max(cfg.n_layers, 1)
    return [(i + 1) % cfg.swa_pattern == 0 for i in range(cfg.n_layers)]

