"""Phase 16 of ``chip_smoke.py``: the serve step (``build_serve_cell``)
with every param leaf placed by the serving rules (heads and vocabulary
over ``model``, experts over ``model`` or ``data``), in phase 14's one-
rank NCCL group and then four rank processes (one job) sharing the card
over gloo: (a) qwen3-14b at its published widths (18 of its 40 layers)
under monolithic over (1, 4), each rank a quarter of every leaf (10
query heads over 2 KV heads, its KV heads' share of the cache); (b)
moonshot-v1-16b-a3b at published widths (12 of its 48 layers) under
crosspool over (2, 2) (8 heads a rank, 32 of 64 experts with 704 of each
expert's 1408 ``f``). Each draws its params leaf by leaf
(``dryrun.draw_params``) and builds its cache at its local shapes: its
resident param and cache bytes must equal the rules' exactly (crosspool
splits the cache's sequence over ``model``, prefill and decode alike: a
rank's bytes of ``k`` / ``v`` must equal the reference table's and be
below its bytes with the sequence whole); 4 prompts of 512 tokens
through the flash prefill (each rank writes its slice of the prompt's K
/ V), ``SERVE_SHARD_SIZES``' decode steps fed the one-rank run's tokens,
``flash_attention`` launched once a layer a prefill and
``decode_attention`` once a layer a step on every rank, under crosspool
each call with its log-sum-exp output (the slices combined by it). The
one-rank reference is the unsharded Model path on the same draw, run
first. In bf16 the greedy agreement (``dryrun.greedy``'s split argmax)
and the logit rows' error are printed; each is run again in float32 at a
depth that fits, where the ids must be equal and every row within 1e-4.
Rows 3-4 are timed at the ranks' head geometries. Under
``"sharded_serve"``; its times are a one-card gloo rehearsal.
"""
from __future__ import annotations

import gc
import json
import time
from pathlib import Path

from chip_smoke_phases.common import (SERVE_SHARD_ROW_RMS, SERVE_SHARD_RUNS,
                                      SERVE_SHARD_SIZES,
                                      _spawn_ranks, check_counts,
                                      close_or_raise, decode_time_row,
                                      flash_time_row, log, open_group,
                                      read_launches, reset_launches, row_error,
                                      row_limit, sync)
from chip_smoke_phases.p03_kernels import fmt_backends
from chip_smoke_phases.p14_sharding import (_cell_shape, _decode_steps,
                                            _seeded_params)


SERVE_SHARD_RANKS = 4
SERVE_SHARD_TIMEOUT = 300


def serve_shard_cfg(run):
    """The config of one ``SERVE_SHARD_RUNS`` entry: the published config
    in the run's dtype, at its depth (None: every layer)."""
    from repro_torch.configs import get_config
    label, arch, strategy, mesh, dtype, depth = run
    cfg = get_config(arch).replace(dtype=dtype)
    return cfg.replace(n_layers=depth or cfg.n_layers)


def serve_launches(cfg, steps, seq_split: bool = False) -> tuple:
    """The serve step's exact launches of a flash prefill and of ``steps``
    paged decode steps: flash and contiguous decode once per GQA self-
    attention layer (zamba2's shared block once per group; whisper's
    cross-attention and encoder take the plain route), the SSD scan once
    per SSM layer a prefill; where the step splits the cache's sequence
    (``Strategy.seq_split``), every decode call of row 3 returns its
    log-sum-exp (the sequence-sharded decode's local body)."""
    n_ssm = n_attn = 0
    if cfg.family == "ssm":
        n_ssm = cfg.n_layers
    elif cfg.family == "hybrid":
        n_ssm = (cfg.hybrid_groups * cfg.ssm_per_group
                 + cfg.tail_ssm_layers)
        n_attn = cfg.hybrid_groups
    else:
        n_attn = cfg.n_layers
    return ({"flash_attention": n_attn, "decode_attention": 0,
             "decode_attention_lse": 0, "ssd_scan": n_ssm},
            {"flash_attention": 0, "decode_attention": n_attn * steps,
             "decode_attention_lse": n_attn * steps if seq_split else 0,
             "ssd_scan": 0})


def _path(launches) -> dict:
    """The counts of the kernels the serve steps' path reaches."""
    return {k: launches[k] for k in ("flash_attention", "decode_attention",
                                     "decode_attention_lse", "ssd_scan")}


def _serve_inputs(torch, cfg, B, S, device) -> dict:
    """The serve runs' seeded prompts, and whisper's stub encoder frames."""
    gen = torch.Generator(device=device).manual_seed(1)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                   device=device, dtype=torch.int32)}
    if cfg.family == "audio":
        from repro_torch.models.transformer import dtype_of
        out["encoder_frames"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=device).to(dtype_of(cfg))
    return out


def _ulp_noise_rows(torch, model, params, inputs, sizes, logits, toks,
                    device) -> float:
    """(17a) How far one float32 ulp moves the Model path: every weight
    matrix times (1 + eps * N(0, 1)) (seeded), the same prefill and
    decode steps fed ``toks``; the largest logit row's relative RMS error
    against ``logits`` (the run on the unperturbed params)."""
    from repro_torch.training.tree import map_tree
    gen = torch.Generator(device=device).manual_seed(2)
    eps = torch.finfo(torch.float32).eps

    def noisy(t):
        if t.dim() < 2 or not t.is_floating_point():
            return t
        return t * (1 + eps * torch.randn(t.shape, generator=gen,
                                          device=t.device, dtype=t.dtype))
    B, S, steps = sizes
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    moved = map_tree(noisy, params)
    cache = model.init_cache(B, S + steps, device)
    first, _ = model.prefill(moved, inputs["tokens"], cache, impl="flash",
                             **extra)

    def unsharded(p, tok, c, lens):
        return model.decode_step(p, tok, c, lens, impl="paged")
    got, _, _ = _decode_steps(
        torch, unsharded, moved, cache, toks[0],
        torch.full((B,), S, dtype=torch.int32, device=device), steps, device,
        forced=toks[1:])
    err = row_error(torch.cat([first.float()[None], got]), logits)
    log(f"sharded serve 17a {model.cfg.name} float32: one ulp of noise on "
        f"every weight matrix moves the Model path's logit rows by "
        f"{err:.3g}")
    del moved, cache
    return err


def _one_rank_cell(torch, kops, cfg, params, inputs, sizes, logits, toks,
                   device) -> dict:
    """(17a) The serve cell monolithic over (1, 1) on ``params`` and a
    fresh local cache: its prefill and its decode steps fed the Model
    path's greedy tokens must give the Model path's ``logits`` and
    ``toks`` bit for bit; on the card each launches as ``serve_launches``
    says.  Needs a one-rank process group."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.strategies import make_strategy
    B, S, steps = sizes
    mesh = Mesh((1, 1), ("data", "model"), live=True)
    st_pre = make_strategy("monolithic", mesh, cfg,
                           _cell_shape("prefill", S + steps, B))
    st_dec = make_strategy("monolithic", mesh, cfg,
                           _cell_shape("decode", S + steps, B))
    cache = dryrun.local_cache(st_pre, B, S + steps, device)
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    reset_launches(kops)
    sync(torch, device)
    t0 = time.perf_counter()
    first, _ = dryrun.build_serve_cell(cfg, st_pre.shape, st_pre,
                                       impl="flash")(
        params, inputs["tokens"], cache, **extra)
    sync(torch, device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = read_launches(kops)
    step = dryrun.build_serve_cell(cfg, st_dec.shape, st_dec, impl="paged")
    reset_launches(kops)
    got, got_toks, ms = _decode_steps(
        torch, step, params, cache, first.argmax(-1).to(torch.int32),
        torch.full((B,), S, dtype=torch.int32, device=device), steps, device,
        forced=toks[1:], greedy=lambda x: dryrun.greedy(st_dec, x))
    dec = read_launches(kops)
    got = torch.cat([first.float()[None], got])
    got_toks = torch.cat([dryrun.greedy(st_pre, first).to(torch.int32)[None],
                          got_toks])
    tag = f"sharded serve 17a {cfg.name} {cfg.dtype} one rank"
    if not (torch.equal(got, logits) and torch.equal(got_toks, toks)):
        raise AssertionError(
            f"{tag}: the cell parts from the Model path by "
            f"{float((got - logits).abs().max()):.3g}, ids equal at "
            f"{int((got_toks == toks).sum())} of {toks.numel()}")
    if torch.device(device).type == "cuda":
        want_pre, want_dec = serve_launches(cfg, steps)
        check_counts(f"{tag} prefill", pre, want_pre)
        check_counts(f"{tag} decode", dec, want_dec)
    log(f"{tag}: logits and ids equal to the Model path's bit for bit; "
        f"prefill {prefill_ms:.1f} ms, decode {ms:.2f} ms/step, launches "
        f"{pre} a prefill, {dec} in {steps} steps")
    del cache
    return dict(prefill_ms=prefill_ms, decode_ms=ms, launches_prefill=pre,
                launches_decode=dec, bit_exact=True)


def _serve_reference(torch, kops, tmp, index, cfg, sizes, device="cuda"):
    """(16, 17a; one rank) The unsharded Model path on the run's seeded
    draw: a flash prefill of ``B`` prompts of ``S`` tokens (whisper's
    over seeded stub frames) and ``steps`` greedy paged decode steps,
    launching exactly ``serve_launches`` on the card; its inputs, logits
    (prefill first) and greedy tokens go to ``tmp/serve_ref{index}.pt``
    for the ranks.  Returns (figures, model, params, inputs, logits,
    toks): the caller frees the tree."""
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import leaves
    B, S, steps = sizes
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = _seeded_params(torch, model, device)
    sync(torch, device)
    draw_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    inputs = _serve_inputs(torch, cfg, B, S, device)
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    cache = model.init_cache(B, S + steps, device)
    reset_launches(kops)
    sync(torch, device)
    t0 = time.perf_counter()
    first, _ = model.prefill(params, inputs["tokens"], cache, impl="flash",
                             **extra)
    sync(torch, device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = read_launches(kops)

    def unsharded(p, tok, c, lens):
        return model.decode_step(p, tok, c, lens, impl="paged")
    reset_launches(kops)
    logits, toks, ms = _decode_steps(
        torch, unsharded, params, cache, first.argmax(-1).to(torch.int32),
        torch.full((B,), S, dtype=torch.int32, device=device), steps, device)
    dec = read_launches(kops)
    logits = torch.cat([first.float()[None], logits])
    toks = torch.cat([first.argmax(-1).to(torch.int32)[None], toks])
    torch.save(dict({k: v.cpu() for k, v in inputs.items()},
                    logits=logits.cpu(), toks=toks.cpu()),
               f"{tmp}/serve_ref{index}.pt")
    if torch.device(device).type == "cuda":
        want_pre, want_dec = serve_launches(cfg, steps)
        check_counts(f"serve reference {cfg.name} {cfg.dtype} prefill",
                     pre, want_pre)
        check_counts(f"serve reference {cfg.name} {cfg.dtype} decode",
                     dec, want_dec)
    out = dict(params=n_params,
               param_bytes=sum(t.numel() * t.element_size()
                               for t in leaves(params)),
               draw_s=draw_s, prefill_ms=prefill_ms, decode_ms=ms,
               tokens_per_s=B * 1e3 / ms, launches_prefill=pre,
               launches_decode=dec)
    del cache, first
    return out, model, params, inputs, logits, toks


def _free(torch, device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _serve_rank_run(torch, kops, tmp, job, sizes, device):
    """One serve job (``_serve_job``) on this rank: its params drawn leaf
    by leaf and cut (``dryrun.draw_params``), its local cache
    (``dryrun.local_cache``), resident bytes equal to the rules' (where
    the step splits the cache's sequence, the bytes of ``k`` / ``v`` /
    ``latent`` / ``rope`` / ``gk`` / ``gv`` equal to the reference
    table's, ``dryrun.seq_leaf_bytes``, and the other leaves' to
    ``step_cache_rules``'), the serve cell's flash prefill and ``steps``
    paged decode steps fed the one-rank run's inputs and tokens
    (``tmp/serve_ref{job['ref']}.pt``), exact launches on the card;
    float32 matmuls in TF32 where the job says so (17b's control).  Saves
    the rank's logit shards and greedy ids beside the figures."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding.spec import tree_bytes
    from repro_torch.sharding.strategies import (SEQ_SPLIT_LEAVES, PerfOpts,
                                                 make_strategy)
    label, _, strategy, mesh_shape, _, _ = job["run"]
    cfg, index = job["cfg"], job["id"]
    B, S, steps = sizes
    T = S + steps
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = job["tf32"]
    ref = torch.load(f"{tmp}/serve_ref{job['ref']}.pt")
    mesh = Mesh(mesh_shape, ("data", "model"), live=True)
    st_pre = make_strategy(strategy, mesh, cfg, _cell_shape("prefill", T, B))
    st_dec = make_strategy(strategy, mesh, cfg, _cell_shape("decode", T, B))
    meta = build_model(cfg).cache_specs(B, T)
    if any(st_pre.step_cache_rules().spec_for(mesh, k, v.shape)
           != st_dec.step_cache_rules().spec_for(mesh, k, v.shape)
           for k, v in meta.items()):
        raise AssertionError(f"sharded serve {label}: the prefill's and "
                             f"the decode's caches are placed apart")
    tag = f"sharded serve {label} rank {mesh.rank}"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync(torch, device)
    t0 = time.perf_counter()
    params = dryrun.draw_params(st_pre, torch.Generator(
        device=device).manual_seed(0))
    cache = dryrun.local_cache(st_pre, B, T, device)
    sync(torch, device)
    draw_s = time.perf_counter() - t0
    param_bytes = dryrun.resident_bytes(params)
    cache_bytes = dryrun.resident_bytes(cache)
    seq = {k for k in meta if k in SEQ_SPLIT_LEAVES and st_dec.seq_split}
    seq_bytes = dryrun.resident_bytes({k: cache[k] for k in seq})
    got = (param_bytes, seq_bytes, cache_bytes - seq_bytes)
    want = (tree_bytes(st_pre.param_rules(), mesh, dryrun.param_shapes(cfg)),
            dryrun.seq_leaf_bytes(st_pre, {k: meta[k] for k in seq}),
            tree_bytes(st_pre.step_cache_rules(), mesh,
                       {k: v for k, v in meta.items() if k not in seq}))
    if got != want:
        raise AssertionError(f"{tag}: resident params / sequence-split "
                             f"cache leaves / other cache leaves {got} "
                             f"bytes, the rules' {want}")
    whole_bytes = cache_bytes
    if seq:     # the same rank's cache with its sequence whole, allocated
        whole = dryrun.local_cache(make_strategy(
            strategy, mesh, cfg, st_dec.shape,
            PerfOpts(kv_seq_override=())), B, T, device)
        whole_bytes = dryrun.resident_bytes(whole)
        del whole
    prefill = dryrun.build_serve_cell(cfg, st_pre.shape, st_pre,
                                      impl="flash")
    step = dryrun.build_serve_cell(cfg, st_dec.shape, st_dec, impl="paged")
    tokens = dryrun.local_rows(st_pre, ref["tokens"].to(device))
    extra = {k: dryrun.local_rows(st_pre, ref[k].to(device))
             for k in ("encoder_frames",) if k in ref}
    inputs = ref["toks"][:steps].to(device)
    reset_launches(kops)
    sync(torch, device)
    t0 = time.perf_counter()
    first, _ = prefill(params, tokens, cache, **extra)
    ids = [dryrun.greedy(st_pre, first)]
    sync(torch, device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = read_launches(kops)
    lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    lengths = dryrun.local_rows(st_dec, lengths)
    shards = [first.float()]
    reset_launches(kops)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, _ = step(params, dryrun.local_rows(st_dec, inputs[i]), cache,
                         lengths)
        shards.append(logits.float())
        ids.append(dryrun.greedy(st_dec, logits))
        lengths = lengths + 1
    sync(torch, device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    dec = read_launches(kops)
    if on_card:
        want_pre, want_dec = serve_launches(cfg, steps, st_dec.seq_split)
        check_counts(f"{tag} prefill", pre, want_pre)
        check_counts(f"{tag} decode", dec, want_dec)
    vocab = first.shape[-1]
    torch.save(dict(logits=torch.stack(shards).cpu(),
                    ids=torch.stack(ids).cpu(),
                    rows=dryrun.local_rows(st_dec, torch.arange(B)),
                    vocab0=0 if vocab == cfg.vocab_size
                    else mesh.index("model") * vocab),
               f"{tmp}/serve_shards{index}_{mesh.rank}.pt")
    out = dict(rank=mesh.rank, coord=list(mesh.coord), draw_s=draw_s,
               param_bytes=param_bytes, cache_bytes=cache_bytes,
               seq_split=st_dec.seq_split, seq_leaf_bytes=seq_bytes,
               whole_seq_cache_bytes=whole_bytes,
               prefill_ms=prefill_ms, decode_ms=decode_ms,
               tokens_per_s=B * 1e3 / decode_ms,
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if on_card else 0.0),
               launches_prefill=pre, launches_decode=dec)
    torch.backends.cuda.matmul.allow_tf32 = False
    del params, cache, first, logits
    _free(torch, device)
    return out


def _serve_job(index, ref, run, cfg, tf32=False) -> dict:
    """A serve job of the ranks: ``run`` (a ``SERVE_SHARD_RUNS``-shaped
    entry) at ``cfg``, its files under ``index``, fed the one-rank run
    ``ref``'s inputs and held against its logits."""
    return dict(id=index, ref=ref, run=run, cfg=cfg, tf32=tf32)


def _serve_rank(rank, tmp, device, jobs, sizes):
    """One of phase 16's (17b-d's) ranks (in its gloo group): runs every
    job in turn: a serve job (``_serve_job``) through
    ``_serve_rank_run``, whose figures go to ``tmp/serve_rank{rank}.json``,
    or a train job (``_train_job``) by its config's family: whisper's
    cell (17c, ``_audio_rank_run``) or an ssm / hybrid cell (17d,
    ``_ssm_rank_run``)."""
    import torch
    from chip_smoke_phases.p17_sharded_families import (_audio_rank_run,
                                                         _ssm_rank_run)
    from repro_torch.kernels import ops as kops
    out = []
    for job in jobs:
        if "train" in job:
            run = (_audio_rank_run if job["train"].family == "audio"
                   else _ssm_rank_run)
            run(torch, kops, tmp, device, job)
        else:
            out.append(_serve_rank_run(torch, kops, tmp, job, sizes,
                                       device))
    with open(f"{tmp}/serve_rank{rank}.json", "w") as f:
        json.dump(out, f)


def _serve_spawn(tmp, device, jobs, sizes, label) -> list:
    """``jobs`` on ``SERVE_SHARD_RANKS`` ranks, spawned once; each rank's
    figures of the serve jobs, in order."""
    _spawn_ranks(_serve_rank, (tmp, device, jobs, sizes), SERVE_SHARD_RANKS,
                 SERVE_SHARD_TIMEOUT, label, device)
    return [json.loads(Path(f"{tmp}/serve_rank{r}.json").read_text())
            for r in range(SERVE_SHARD_RANKS)]


def _serve_agreement(torch, tmp, index, ref) -> dict:
    """The four ranks' logit shards of run ``index`` assembled into whole
    rows (ranks holding the same entries must agree bit for bit), against
    the one-rank run ``ref``'s: the largest row relative RMS error, and
    the greedy ids each rank took (the split argmax) against the one-rank
    run's, prefill first."""
    ref = torch.load(f"{tmp}/serve_ref{ref}.pt")
    whole = torch.full_like(ref["logits"], float("nan"))
    equal = total = 0
    for r in range(SERVE_SHARD_RANKS):
        got = torch.load(f"{tmp}/serve_shards{index}_{r}.pt")
        rows, v0 = got["rows"], got["vocab0"]
        n = got["logits"].shape[-1]
        part = whole[:, rows, v0:v0 + n]
        seen = ~torch.isnan(part)
        if not torch.equal(part[seen], got["logits"][seen]):
            raise AssertionError(f"sharded serve run {index}: ranks part on "
                                 f"the same logits")
        whole[:, rows, v0:v0 + n] = got["logits"]
        equal += int((got["ids"] == ref["toks"][:, rows]).sum())
        total += got["ids"].numel()
    if torch.isnan(whole).any():
        raise AssertionError(f"sharded serve run {index}: the ranks' "
                             f"shards do not cover the logits")
    return dict(max_row_rms=row_error(whole, ref["logits"]),
                ids_equal=equal, ids_total=total,
                finite=bool(torch.isfinite(whole).all()))


def local_heads_kernel_rows(torch, kops, ref, geometries):
    """Rows 3 and 4 at phase 16's geometries ((label, B, S, T, [(H, KV)
    of the prefill, of the decode], D): a rank's heads), in bf16 and in
    float32 (the sharded steps' equality gates run float32): each against
    its plain version (bf16 2e-2 and the row limit, float32 2e-5; float32
    flash also equal bit for bit across two calls), then timed beside its
    bound and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows, errs = [], {}
    for (label, B, S, T, ((H, KV), (H1, KV1)), D), (dtype, tol) in (
            (g, d) for g in geometries
            for d in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5))):
        def randn(*shape):
            return torch.randn(shape, generator=gen,
                               device="cuda").to(dtype)
        scale, name, rms = D ** -0.5, str(dtype)[6:], row_limit(torch, dtype)
        q, k, v = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)
        shape = f"{label} B={B} S=T={S} H={H} KV={KV} D={D} {name}"
        got = kops.flash_attention(q, k, v, scale=scale)
        errs["flash_attention"] = max(errs.get("flash_attention", 0.0),
                                      close_or_raise(
            torch, f"flash {shape}", got,
            ref.flash_attention(q, k, v, scale), tol, rms))
        if dtype == torch.float32 and not torch.equal(
                got, kops.flash_attention(q, k, v, scale=scale)):
            raise AssertionError(f"flash {shape}: two calls differ (the "
                                 f"float32 body merges in a fixed order)")
        rows.append(flash_time_row(torch, kops, ref, shape, q, k, v, scale))
        q, ck, cv = randn(B, 1, H1, D), randn(B, T, KV1, D), randn(B, T, KV1,
                                                                   D)
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        shape = f"{label} B={B} T={T} H={H1} KV={KV1} D={D} {name}"
        errs["decode_attention"] = max(errs.get("decode_attention", 0.0),
                                       close_or_raise(
            torch, f"decode {shape}", kops.decode_attention(
                q, ck, cv, lens, scale=scale),
            ref.decode_attention(q, ck, cv, lens, scale), tol, rms))
        rows.append(decode_time_row(torch, kops, ref, shape, q, ck, cv, lens,
                                    scale))
    for r in rows:
        log(f"time {r['kernel']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['library']} {r['library_ms']:.4f} ms "
            f"(sdpa backends {fmt_backends(r['library_all'])})")
    return errs, rows


def sharded_serve_phase(torch, kops, tmp, card, device="cuda",
                        runs=SERVE_SHARD_RUNS, cfgs=None,
                        sizes=SERVE_SHARD_SIZES) -> dict:
    """Phase 16: every ``runs`` entry's one-rank reference
    (``_serve_reference``, this process), then the four ranks (every run
    in one spawn, gloo on CUDA tensors), then each run's agreement: in
    float32 the greedy ids equal and every logit row within
    ``SERVE_SHARD_ROW_RMS``, in bf16 measured and printed.  ``cfgs``
    (default ``serve_shard_cfg``) and ``sizes`` (B, S, steps) rehearse it
    on the CPU (``device="cpu"``: launch gates and timing are card-only).
    The times are a one-card gloo rehearsal, not a multi-card figure."""
    t0 = time.perf_counter()
    cfgs = cfgs or [serve_shard_cfg(run) for run in runs]
    ones = []
    for index, cfg in enumerate(cfgs):
        ones.append(_serve_reference(torch, kops, tmp, index, cfg, sizes,
                                     device)[0])
        _free(torch, device)
        log(f"sharded serve {runs[index][0]}: {cfg.name} {cfg.n_layers} "
            f"layers {cfg.dtype} ({ones[-1]['params'] / 1e9:.3f} B params, "
            f"{ones[-1]['param_bytes'] / 2**30:.3f} GiB) at one rank: draw "
            f"{ones[-1]['draw_s']:.1f} s, prefill {ones[-1]['prefill_ms']:.1f}"
            f" ms, decode {ones[-1]['decode_ms']:.2f} ms/step")
    t1 = time.perf_counter()
    ranks = _serve_spawn(tmp, device, [
        _serve_job(i, i, run, cfg)
        for i, (run, cfg) in enumerate(zip(runs, cfgs))], sizes,
        "sharded serve 16")
    t2 = time.perf_counter()
    out = {"card": card, "sizes": dict(zip(("batch", "prompt", "steps"),
                                           sizes)), "runs": []}
    for index, (run, cfg, one) in enumerate(zip(runs, cfgs, ones)):
        label, _, strategy, mesh, dtype, _ = run
        agree = _serve_agreement(torch, tmp, index, index)
        tag = f"sharded serve {label}"
        if not agree["finite"]:
            raise AssertionError(f"{tag}: non-finite logits")
        if dtype == "float32" and (
                agree["ids_equal"] != agree["ids_total"]
                or agree["max_row_rms"] > SERVE_SHARD_ROW_RMS):
            raise AssertionError(
                f"{tag}: greedy ids equal at {agree['ids_equal']} of "
                f"{agree['ids_total']}, logit rows within "
                f"{agree['max_row_rms']:.3g} (limit {SERVE_SHARD_ROW_RMS})")
        rs = [r[index] for r in ranks]
        for r in rs:
            log(f"{tag} rank {r['rank']} (coord {r['coord']}): params "
                f"{r['param_bytes'] / 2**30:.3f} GiB "
                f"({r['param_bytes'] / one['param_bytes']:.3f} of one "
                f"rank's), cache {r['cache_bytes'] / 2**30:.4f} GiB"
                + (f" (its slice of the sequence; k / v / latent / rope / "
                   f"gk / gv {r['seq_leaf_bytes'] / 2**30:.4f} GiB = the "
                   f"reference table's; the same rank's cache allocated "
                   f"with the sequence whole "
                   f"{r['whole_seq_cache_bytes'] / 2**30:.4f} GiB)"
                   if r["seq_split"] else "")
                + f", resident = the rules'; draw {r['draw_s']:.1f} s, prefill "
                f"{r['prefill_ms']:.1f} ms, decode {r['decode_ms']:.2f} "
                f"ms/step = {r['tokens_per_s']:.1f} tokens/s, peak "
                f"{r['peak_gib']:.2f} GiB; launches flash "
                f"{r['launches_prefill']['flash_attention']} a prefill, "
                f"decode {r['launches_decode']['decode_attention']} "
                f"({r['launches_decode']['decode_attention_lse']} with lse) "
                f"in {sizes[2]} steps ({card}; a one-card gloo rehearsal)")
        log(f"{tag}: {cfg.name} {cfg.n_layers} layers {dtype}, {strategy} "
            f"over {tuple(mesh)}: greedy ids equal to one rank's at "
            f"{agree['ids_equal']} of {agree['ids_total']}, logit rows "
            f"within {agree['max_row_rms']:.3g}"
            + (" (gated)" if dtype == "float32" else " (reported)"))
        out["runs"].append(dict(label=label, arch=cfg.name, strategy=strategy,
                                mesh=list(mesh), dtype=dtype,
                                layers=cfg.n_layers, one_rank=one, ranks=rs,
                                **agree))
    if device == "cuda":
        from repro_torch.kernels import ref
        geoms = []
        for (_, _, strategy, (data, model), dtype, _), cfg in zip(runs, cfgs):
            if dtype != "bfloat16":
                continue
            # a rank's heads: the prefill's split over model; the decode's
            # too under monolithic Type I, whole under crosspool, whose
            # cache keeps every head of its slice of the sequence
            crosspool = strategy == "crosspool"
            split = (model, 1 if crosspool else model)
            cache_len = sizes[1] + sizes[2]
            geoms.append((f"{cfg.name} {strategy} over ({data}, {model})",
                          sizes[0] // data, sizes[1],
                          cache_len // model if crosspool else cache_len,
                          [(cfg.n_heads // n, cfg.n_kv_heads // n)
                           for n in split], cfg.head_dim))
        out["kernel_errs"], out["kernel_rows"] = local_heads_kernel_rows(
            torch, kops, ref, geoms)
    out["seconds"] = dict(one_rank=t1 - t0, four_ranks=t2 - t1,
                          total=time.perf_counter() - t0)
    log(f"sharded serve: phase 16 took {out['seconds']['total']:.1f} s "
        f"(one rank {t1 - t0:.1f}, four ranks {t2 - t1:.1f}; {card})")
    return out


def run(ctx) -> None:
    """The sharded serve step, in phase 14's one-rank group."""
    ctx.out[16] = dict(sharded_serve=sharded_serve_phase(
        ctx.torch, ctx.kops, open_group(ctx), ctx.card))
