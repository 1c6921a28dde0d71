#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on the card and fails (exit code
other than 0) if any phase fails:

1. card    — prints the card's name and power limit (nvidia-smi) and
             turns TF32 off for float32 matmuls and convolutions;
2. build   — compiles every kernel source of
             ``src/repro_torch/kernels/csrc`` with nvcc (one process
             each, all started together), loads them and prints each
             one's ``-Xptxas -v`` report;
3. kernels — holds each kernel against its plain PyTorch version:
             the paged decode kernels at the head geometries of the three
             colocated models (bf16 within 2e-2, float32 within 2e-5 at
             the same geometries, the float32 split boundary and context
             32768 included, and on a small shape), with ragged lengths,
             unmapped (-1) table
             entries past and inside lengths and NaN garbage beyond every
             length, lengths 0 and 1, on and beside a split boundary,
             ending mid-page and one row at context 32768 (GQA and MLA),
             and the smoke configs' geometries (GQA head dim 8, MLA
             r = 16, rp = 8); the prefix cache's tables (qwen3-moe GQA
             and minicpm3 MLA, bf16 and float32): two rows sharing their
             first 24 pages and ending in different copy-on-write fork
             pages, and the pool write of rows from mid-page at a fork
             (bit for bit, shared and source pages untouched);
             a CUDA-graph replay of the paged GQA and of the paged MLA
             call with new lengths against an eager call, and the GQA and
             MLA wrappers under
             ``set_sync_debug_mode("error")``; flash prefill (S = T up to
             4096, T > S, S and T off the tile, every head dim),
             contiguous decode (ragged lengths with 0 and a split
             boundary, NaN past them; both in bf16 also each row within
             a relative RMS error of 1e-2) and the SSD scan (float32 within
             1e-3, bf16 ``y`` within 2e-2, ``h`` within 1e-3, with and
             without ``h0``) at the zamba2 / mamba2 geometries, and at
             64 chunks (S = 4096, chunk 64), a chunk of 8, G = 2 and
             B = 2 with ``h0``; the SSD scan's backward
             (``ssd_scan_bwd``) against autograd of the chunked form, each
             gradient within 1e-3 (float32) or 2e-2 (bf16) of its scale
             and equal bit for bit across two calls, at both geometries
             (S = 1024, with and without ``h0`` and ``dh``), the train
             shape (8 x 512), chunks of 8 and 64 with 8 chunks, G = 2 and
             a zero ``dh``; the pool write (``paged_kv_write``) bit
             for bit against its plain version (-1 pages, an id past the
             pool, f32 rows into a bf16 pool, an odd row width, 512 rows)
             and under ``set_sync_debug_mode("error")``; contiguous
             decode's log-sum-exp output (the sequence-sharded decode's
             local body) at moonshot's and gemma3's heads in both dtypes,
             lengths 0 / 1 / a split boundary +-1 / T, one split and
             several (lse within the kernel tolerances and -inf at
             length 0, the output equal bit for bit to the call without
             lse), timed at a 16b rank's slice of the cache; then times
             kernel, plain version and, for attention, one
             ``scaled_dot_product_attention`` call on the same data under
             each SDPA backend that takes it (a yardstick only: the port
             never calls it; the fastest is ``library_ms``), beside the
             bound (the paged decode kernels also in float32 over 16 KiB
             f32 pages at B = 4; the SSD scan at S = 1024 and 512 in bf16
             and in float32 at the train shape (8 x 512), its backward
             at the train shape in float32 and at S = 1024 in bf16, one
             call of it split by launch under the profiler);
4. small   — float32 smoke-size models on the card against the CPU
             (plain versions): the colocated set and zamba2 + mamba2;
             prefill and one decode step give the same logits within
             1e-4 (the colocated set's float32 decode step must launch
             the paged GQA and MLA kernels); then the same smoke models in bf16, as the serve CLI
             runs them by default, served through the engine; then the
             decode graphs: for the smoke coloc set in float32 and bf16
             at K = 1 and 4, and zamba2 + mamba2 in both, a block's graph
             replay gives the same tokens and pool (or dense cache) bytes
             as the step body called eagerly from the same state; a
             block dispatch (copy-in to replay) makes no host read under
             ``set_sync_debug_mode("error")``; a model evicted from
             the arena and re-activated on other slabs serves the same
             tokens through its graph; and after the pool, then the
             arena, moved (a resize), a replay raises until the graph is
             captured again, then equals the eager body;
5. serve   — ``CrossPoolEngine(device="cuda")`` over the paper's three
             colocated models at their published widths, bf16, depths
             cut to ``FULL_WIDTH_DEPTHS``: 8 requests, prompts of
             200-900 tokens, 32 new tokens each, K=4.  Every request must
             finish with its token count, every page must return, no
             logit may be NaN, each model's decode graph must have
             replayed exactly once per block, and the paged GQA and MLA
             kernels and the pool write must have launched exactly as
             often as the path runs them (per layer: K per replay, and
             one write per prompt row); (5a) the profiled decode step's
             roofline (``launch/roofline.py`` on the H100's peaks: each
             model's block counted on ``meta`` by
             ``op_analysis.analyze_fused_step``, K x the analytic minimum
             bytes) printed beside its wall and busy times, the bound at
             most the busy time; the graph audit
             (``analysis/graph_audit.py``) of each model's fused step
             clean (no foreign read of 64 KiB or more, the pool updated
             in place, no host read under ``set_sync_debug_mode
             ("error")``, calls per body and per replay = K x layers),
             and two planted bodies (a host read, a pool clone) flagged
             CPA03 and CPA02; then (5h) the same requests under
             ``lowering=False`` with the layer pipeline scheduler and
             without it, with the same checks (one token per host-driven
             step), printing the scheduler's stage count and
             ``overlap_fraction``;
6. serve   — the same engine over zamba2-1.2b and mamba2-130m at their
   fallback  FULL published configs (no depth cut), bf16, through the
             dense-cache fallback path: 8 requests (4 per model), the
             same prompts and outputs, K=1.  The same checks, and flash
             prefill (6 per zamba2 prompt), the SSD scan (32 per zamba2
             and 24 per mamba2 prompt) and contiguous decode (6 per
             zamba2 decode step, one graph replay each) must have
             launched that many times;
7. train   — ``make_train_step`` on moonshot-v1-16b-a3b at its published
             widths, depth cut to ``TRAIN_DEPTH``, float32, through the
             grouped-GEMM MoE path: 5 AdamW steps on one fixed batch of
             8 x 512 ``SyntheticLM`` tokens.  Every loss and grad norm
             must be finite, the last loss below the first, and the
             grouped GEMM must have launched exactly 6 times per layer
             per step (3 forward, 3 input gradients) and its wgrad kernel
             3 times; the router's load of the last step (the group sizes
             of each layer) is recorded; then (7b) mamba2-130m and (7c)
             zamba2-1.2b at their full published configs (24 layers; 38
             with the six shared attention blocks), float32, the same
             optimizer, steps and 8 x 512 batch, no remat: the first
             step's gradients on the kernel route against the plain route
             (``PlainSSD``: the chunked form by autograd) within 1e-3 of
             each leaf's scale, then finite losses and grad norms, a
             falling loss, ``ssd_scan`` and ``ssd_scan_bwd`` launched
             exactly once a SSM layer a step (24; 32) and no other
             kernel; ms a step, tokens/s, peak memory and one profiled
             step;
8. moe gemm — holds the grouped GEMM (forward, input and weight
             gradients) against its plain versions, float32 within 1e-4
             and bf16 within 2e-2, at both shapes phase 7 gives it
             (gate/up: K = d_model, M = d_ff; down: K = d_ff, M = d_model)
             with each layer's recorded load, with that load's 4 least
             loaded experts emptied, with every expert boundary one row
             past a 128-row tile edge, with one expert holding 90% of
             the rows, and on a small shape with empty experts and rows
             off 16 bytes (the float32 weight gradient equal bit for bit
             across two calls at each); then times it at the gate/up
             shape and layer 0's load, and the weight gradient at the
             skewed load too.

9. elastic — the elastic KV<->weights boundary (DESIGN.md §8) on the
             colocated set at published widths, bf16, depths cut to
             ``FULL_WIDTH_DEPTHS``, ``max_ctx`` 4096, K=4: minicpm3 is the
             burst target (dense FFN: its tokens do not depend on batch
             composition), qwen3-moe and moonshot are registered and
             idle, so their slabs are the slack.  An elastic engine
             (``ELASTIC``, 1024 pages of 16 KiB to start) and a frozen one
             with the same budgets each serve 8 minicpm3 requests at time
             0 (prompts of 1500-3000 tokens, 32 new tokens), then 2
             qwen3-moe and 2 moonshot requests after them (130-200
             tokens: each model's pair prefills and decodes together on
             both engines).  Gates: at
             least one KV grow, device bytes conserved on every move,
             every request's token count, no page left mapped, the
             frozen engine's greedy streams, every split model's decode
             graph captured again exactly once per move that moved its
             pool or arena (and nothing replayed over a moved buffer),
             exact launch counts of the paged kernels and the pool write
             (a capture's warm-up runs the body once), and after the
             moves a replay equals the eager body and a block dispatch
             makes no host read.  Then the forced cycle on minicpm3 alone
             (4 requests of 2000 tokens, lowering on and off): a shrink
             that swaps and compacts, a swap-out of the active requests,
             a grow and the fault-in; every step's logits equal the
             unperturbed run's bit for bit, and a replay over the moved
             pool without a new capture raises.  It prints the moves, ms
             per pool grow, pool shrink and arena shrink, ms per
             recapture of each model, swap-out and fault-in ms and GB/s,
             peak device memory and the burst's tokens/s and TTFT p50,
             elastic against frozen;
10. cache  — the radix-tree prefix cache (DESIGN.md §11): each colocated
             model alone at published width, bf16, ``max_ctx`` 1024, K=4,
             the cache on: one warm-up and ``CACHE_CONVERSATIONS``
             measured conversations of 3 turns (a 400-token first prompt,
             4 new tokens a turn, an 8-token delta; one prompt bucket),
             each turn served with the cache and opted out of it.  Gates:
             every warm turn hits the previous turn's prompt, the tree
             holds exactly the mapped pages after the drain, no NaN
             logit, exact launch counts of the paged kernels and the pool
             write (suffix writes counted), one replay per block, a
             warm turn's block dispatch with no host read, layer-0 KV
             rows of the suffix within 2e-2 + 2e-2|x| of cache-off's; two
             requests on one 64-token head in one step (shared pages),
             then the whole tree shed to the pinned tier and the next
             turn's hit faulting it back with its bytes unchanged.  It
             prints per warm turn the first-token logits' and layer-0
             KV's max |d| against cache-off, token agreement, TTFT (wall,
             submit to first token) and prefill ms on and off.  Then the
             same on float32 smoke configs on the card (cache on and
             off) and on the CPU: the streams must be equal;
11. observe — observability and forensics (DESIGN.md §10, §12-13) on
             phase 5's configuration and trace: (a) with an
             ``EngineObserver``, the flight recorder, the sanitizer and an
             SLO whose minicpm3 TTFT objective (``OBSERVE_SLO``) breaches;
             gates: building the engine (graph warm-ups, captures) fires
             no hook, exact launch counts and one replay per block, the
             metrics equal ``EngineStats`` (tokens, TTFT and TBT
             samples), every request's span tree complete, an audit at
             every step, one breach edge and its dump, no causal drop;
             the same trace on a bare engine fed the recorded dt stream
             gives the same streams and virtual timestamps; then, both
             engines warm, four pairs in alternating order, attached
             against bare, for tokens/s (the audits' share of each
             pair's gap beside it), and
             one block dispatch (with its span, an audit and a pool
             snapshot) under ``set_sync_debug_mode("error")``; (b) the
             record replayed in a fresh engine, bit-exact, its breach
             included; (c) a lowering-off record (pipeline on, FFN stages
             on the weights stream) replayed bit-exactly; (d) each
             ``inject_corruption`` kind trips the sanitizer, dumps an
             incident record, and its replay trips the same rule at the
             same step; (e) ``CROSSPOOL_SANITIZE=1`` through phase 9's
             elastic burst and forced cycle and a phase 10 conversation
             with shared pages, a shed and a fault: every audit clean.
             It prints the tokens/s pairs and their median ratio, audit
             ms (median, max), ring events and drops, the record's
             bytes, the trace's events and the replays' wall time.
12. families — the dense-cache Model path (``build_model(cfg)``:
             ``init_cache`` / ``prefill`` / ``decode_step``) of the
             families the engine does not serve: (a) contiguous decode
             and flash prefill at gemma3's head dim 256 against their
             plain versions (bf16 2e-2 and each row's relative RMS
             error within 1e-2, float32 2e-5; decode at B = 4,
             T = 4096 with ragged lengths and NaN past them, and over a
             1024-slot ring with counts below it; flash at S = T = 2048
             and T > S), timed beside their bounds and SDPA; (b) gemma3,
             whisper and llava smoke configs in float32, card against
             CPU: forward, prefill and two decode steps within 1e-4;
             (c) gemma3-12b at its full published config (48 layers,
             bf16, random weights from a seed): a [4, 2048] prefill and
             64 greedy decode steps, a 1000-token prompt whose ring
             crosses the 1024 window during 48 steps, and a 301-token
             prompt in a 512 bucket (the padded-bucket quirk); (d)
             whisper-small at its full config: 4 rows of 1500 encoder
             frames, a 64-token prompt, 64 decode steps.  Gates: no NaN
             logit, flash launched once per global layer a prefill
             (gemma3 8, whisper 12), contiguous decode once per layer a
             step (48, 12), gemma3's ring counts at the end equal to
             min(max(cur + 1, bucket), 1024).  It prints prefill ms,
             decode ms per step, tokens/s, one profiled decode step
             (wall and device busy) and peak memory;
13. examples — (a) one long-context request through the shared pool at
             full width: minicpm3-4b's published config in a bf16
             ``KVVirtualizer`` of 73,728 16 KiB pages, 32768 tokens of
             all 62 layers written from a dense MLA cache with
             ``write_prompt_from_cache`` (one pool write), then layer 0
             anew with ``write_tokens``; the whole pool must equal a
             plain scatter of the same rows through
             ``page_table_array`` bit for bit, and ``typed_pages`` must
             be a view; the long_context_pooling example's float32
             packed-latent call of the paged GQA kernel (head dim 256,
             one kv head for 40 query heads) over layer 0 within 2e-5 of
             its plain version, and the paged MLA kernel in bf16 over
             the last layer's typed pages (2e-2 and the row RMS limit),
             each launched exactly once and timed beside its bound, its
             plain version and SDPA; then the
             admission burst at published widths (moonshot, 4 x 32768
             tokens into 48 GiB of pages: the shared pool must admit
             more than a static third); (b) the four examples
             (``repro_torch.examples``) through their ``main`` at the
             reference's settings: quickstart for qwen3-moe, moonshot,
             minicpm3 and qwen3-14b, serve_multi_model ``--online
             --elastic --slo-demo`` (its flight record must replay
             BIT-EXACT on the card), train_moe's 100 steps and
             long_context_pooling.  Gates: each prints its ``OK`` line;
             each quickstart launches its prefill's and decode's kernels
             (flash, contiguous and paged decode for a GQA arch, paged
             MLA decode for minicpm3) and, for a MoE arch, the grouped
             GEMM with its weight gradient; train_moe launches both.  It
             prints each example's wall time and launches.

14. sharding — the sharding layer on ``torch.distributed``: (a) on a
             one-rank NCCL group, moonshot-v1-16b-a3b at published widths
             (bf16, as many of its 48 layers as 40% of the free memory
             holds): 4 prompts of 1024 tokens prefilled through
             ``build_serve_cell`` under ``make_strategy("auto")``
             (monolithic, flash), then 8 decode steps under crosspool
             with the all-to-all expert dispatch on the contiguous
             kernel route, against the unsharded Model path with the
             same params: greedy tokens equal, logits within the row
             limit, flash launched once per layer a prefill and
             contiguous decode once per layer a step in both runs, ms a
             decode step both ways; (b) minicpm3-4b at its published
             config (62 layers), one request whose 32768-token latent /
             rope cache comes from a seeded generator, split over four
             processes sharing the card over gloo (crosspool on a (1, 4)
             mesh: the sequence-sharded MLA decode, each rank 8192
             tokens of the cache, its heads of the attention, a quarter
             of the vocabulary and of the dense FFN): ``POOL_STEPS``
             decode steps fed the same decode's tokens at one rank on
             the whole cache, in bf16 (every rank exits 0 with finite
             logits and a quarter of the one rank's cache bytes; the
             token and logit agreement printed) and then in float32
             with the gate: tokens equal, logits within the row limit;
             its times are a one-card rehearsal.

15. sharded train — the sharded training step (``build_train_cell``)
             on phase 7's model at published widths (2 layers, float32,
             8 x 512 tokens, the grouped MoE path, remat, 1 microbatch),
             ``SHARDED_STEPS`` steps, plain and with ``seq_parallel`` +
             ``compress_grads``: (a) in phase 14's one-rank NCCL group,
             beside ``make_train_step`` on the same params and batch
             (losses and grad norms within 1e-5 relative, params within
             the AdamW sign bound, ``moe_gemm`` / ``moe_gemm_wgrad``
             launched exactly 9 / 3 times a layer a step in both, the
             cell's peak within ``SHARDED_PEAK_SLACK_GIB`` of the
             reference's); (b) every variant over a (2, 2) mesh of four
             processes (spawned once) sharing the card over gloo, every
             leaf of params, m and v split by the train
             rules: each rank's losses and grad norms within 1e-4
             relative of (a)'s, its shards within the sign bound of the
             same slices of (a)'s params, its resident bytes equal to
             the dry-run's, its launches exact; ms a step, tokens/s and
             peak GiB a rank, a one-card rehearsal.  Under
             ``"sharded_train"`` in ``build/chip_smoke.json``.

16. sharded serve — the serve step (``build_serve_cell``) with every
             param leaf placed by the serving rules (heads and vocabulary
             over ``model``, experts over ``model`` or ``data``), in
             phase 14's one-rank NCCL group and then four processes
             (spawned once) sharing the card over gloo: (a) qwen3-14b at
             its full published config (40 layers, bf16) under
             monolithic over (1, 4), each rank a quarter of every leaf
             (10 query heads over 2 KV heads, its KV heads' share of the
             cache); (b) moonshot-v1-16b-a3b at published widths (14a's
             depth rule) under crosspool over (2, 2) (8 heads a rank, 32
             of 64 experts with 704 of each expert's 1408 ``f``).  Each
             draws its params leaf by leaf (``dryrun.draw_params``) and
             builds its cache at its local shapes: its resident param
             and cache bytes must equal the rules' exactly (crosspool
             splits the cache's sequence over ``model``, prefill and
             decode alike: a rank's bytes of ``k`` / ``v`` must equal
             the reference table's and be below its bytes with the
             sequence whole); 4 prompts of 512 tokens through the flash
             prefill (each rank writes its slice of the prompt's K / V),
             8 paged decode steps fed the one-rank run's tokens,
             ``flash_attention`` launched once a layer a prefill and
             ``decode_attention`` once a layer a step on every rank,
             under crosspool each call with its log-sum-exp output (the
             slices combined by it).  The one-rank reference is the
             unsharded Model path on the same draw, run first.  In bf16
             the greedy agreement (``dryrun.greedy``'s split argmax) and
             the logit rows' error are printed; each is run again in
             float32 at a depth that fits, where the ids must be equal
             and every row within 1e-4.  Rows 3-4 are timed at the ranks'
             head geometries.  Under ``"sharded_serve"``; its times are a
             one-card gloo rehearsal.

17. sharded families — the ssm, hybrid and audio archs (zamba2-1.2b,
             mamba2-130m, whisper-small) at their full published configs
             through the same steps, in bf16 and float32, phase 16's
             sizes (whisper over seeded stub encoder frames): (a) the
             Model path, then the serve cell over (1, 1) on the same
             params, bit for bit, and the Model path once more on every
             weight matrix moved by one float32 ulp (its row error);
             (b) four processes (spawned once) under monolithic (1, 4)
             and crosspool (2, 2), every arch in float32 and zamba2 in
             bf16 too: each rank's param and cache bytes the rules'
             exactly (the SSM's projections over the weights pool, its
             state's heads over ``model``), ``ssd_scan`` once a SSM
             layer a prefill and flash / contiguous decode once a GQA
             self-attention layer on every rank, in float32 every greedy
             id equal and every row within the larger of 1e-4 and 2.5x
             (a)'s ulp row error (the SSD scan's decays amplify one ulp),
             bf16 printed; a control, zamba2 and mamba2 over (2, 2) with
             TF32 matmuls, must fail that row limit; (c) whisper's train
             cell (float32, 2 steps, 2 + 2 layers) at one rank bit for
             bit against ``make_train_step``, then over (2, 2) on (b)'s
             ranks, plain and under ``seq_parallel`` (the decoder's
             stream split over ``model``, the encoder's frames whole)
             (losses within 1e-5 relative, shards within the sign
             bound, resident bytes the dry-run's); (d) (7d) zamba2's
             train cell at published widths cut to 2 + 1 SSM layers and
             the shared block, and mamba2's cut to 2 layers, float32,
             8 x 512, each at one rank against ``make_train_step`` bit
             for bit, ``ssd_scan`` twice a grouped SSM layer and once
             the tail's (remat recomputes the groups) and
             ``ssd_scan_bwd`` once a SSM layer a step in both; then on
             (b)'s ranks zamba2's over (2, 2) and mamba2's over (1, 4),
             gated as (c), the SSD kernels launched as at one rank, ms a
             step and peak GiB a rank printed.  Rows 3, 4 and 6 are
             timed at a (1, 4) rank's heads.  Under
             ``"sharded_families"``.  Every phase's seconds are printed
             and kept under ``"phase_seconds"``.

Phases 3 and 13 hold the paged GQA and MLA kernels in bf16 to the same
row limit as rows 3-4: each output row's relative RMS error within 1e-2
(``BF16_ROW_RMS``) on top of the elementwise 2e-2.

Phase 4 also runs one float32 smoke train step of qwen3-moe (both MoE
paths) and minicpm3 on the card against the CPU (loss, grad norm and
updated params within 1e-4 of each leaf's scale, max(1, max|leaf|)).

The profile of phase 6's prefill step prints the SSD scan's share of
the device time, the profiles of phase 5 paged MLA's.  Launch counts
are set to 0 just before each serve, train or cache run and read just
after it; the engine captures its decode graphs when it is built, before that,
and each replay adds the kernel launches its capture recorded.  It prints a JSON line with every kernel's numbers,
then, as its last line, ``{"ok": true, "device": {...}}``.  The full
kernel table, the serve and train figures and the profiles go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's published peaks, kept in one place with their sources
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOPS,
    PEAK_FLOPS_F32 as FP32_FLOPS, PEAK_FLOPS_TF32 as TF32_FLOPS)
#: the attention kernels (rows 1-4) in bf16: the limit on each output
#: row's relative RMS error against the plain version (a correct kernel
#: differs by the rounding of its bf16 probabilities and output, ~3e-3)
BF16_ROW_RMS = 1e-2
CONTEXTS = (1024, 8192)
BATCHES = (1, 4)
#: ~1 ms of spin (torch.cuda._sleep cycles) ahead of each timed call
SPIN_CYCLES = 2_000_000
#: the __global__ functions of ``csrc/``, as the profiler names them
PORT_KERNELS = ("flash_prefill", "split_decode_kernel", "merge_splits_kernel",
                "mla_split_decode_kernel", "mla_merge_splits_kernel",
                "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                "ssd_chunk_output_kernel", "ssd_bwd_state_kernel",
                "ssd_bwd_pass_kernel", "ssd_bwd_pair_kernel",
                "ssd_bwd_reduce_kernel", "moe_gemm")
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
SERVE_K = 4
SERVE_MAX_NEW = 32
FALLBACK_MODELS = ("zamba2-1.2b", "mamba2-130m")
#: every kernel entry point, by the name its launch counter is read under
KERNELS = ("paged_decode_attention", "paged_mla_decode_attention",
           "flash_attention", "decode_attention", "ssd_scan", "ssd_scan_bwd",
           "moe_gemm", "moe_gemm_wgrad", "paged_kv_write")
#: phase 7: moonshot at published widths, this many layers, float32
TRAIN_MODEL = "moonshot-v1-16b-a3b"
TRAIN_DEPTH = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 5
#: phases 7b / 7c: the ssm and hybrid archs at their full published
#: configs, float32, phase 7's optimizer, sequence and steps, this many
#: rows a batch; 7d: zamba2's sharded train cell at one rank, at
#: published widths cut to one group of SSM_CELL_DEPTH SSM layers, the
#: shared attention block and one tail SSM layer
SSM_TRAIN_BATCH = {"mamba2-130m": 8, "zamba2-1.2b": 8}
SSM_CELL_DEPTH = 2
#: phase 3: the SSD backward's timed shapes (label, B, S, chunk, dtype),
#: at each of the zamba2 and mamba2 geometries; the first is the train
#: path's call (phases 7b / 7c), the kernel line's row
SSD_BWD_TIMED = (("train shape", TRAIN_BATCH, TRAIN_SEQ, 256, "float32"),
                 ("S=1024", 1, 1024, 256, "bfloat16"))
#: phase 9: the elastic engine's knobs, its starting page budget (16 KiB
#: pages) and context
ELASTIC = dict(interval_steps=1, cooldown_steps=1, hysteresis=0.05,
               window_s=60.0, min_page_budget=256)
ELASTIC_PAGES, ELASTIC_CTX = 1024, 4096
BURST_MODEL = "minicpm3-4b"
#: phase 10: the multi-turn conversation's shape (first prompt, new
#: tokens a turn, delta a turn, turns), measured conversations after one
#: warm-up, and the shared head of the shared-page pair
CACHE_PROMPT, CACHE_NEW, CACHE_DELTA, CACHE_TURNS = 400, 4, 8, 3
CACHE_CONVERSATIONS = 3
CACHE_HEAD = 64
#: phase 11: the TTFT objective (ms) that must breach; the other models'
#: objectives never do
OBSERVE_SLO = {"minicpm3-4b": 1.0}
#: phase 12: the families' models, gemma3's runs (label, batch, prompt
#: bucket, decode steps, logit index: None = the bucket's last) and
#: context, whisper's batch, prompt and steps
GEMMA, WHISPER = "gemma3-12b", "whisper-small"
FAMILY_SMOKES = (GEMMA, WHISPER, "llava-next-34b")
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_CTX = 4, 2048, 4096
GEMMA_RUNS = (("batch", GEMMA_BATCH, GEMMA_PROMPT, 64, None),
              ("crossing", 1, 1000, 48, None),
              ("pad quirk", 1, 512, 16, 300))
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS = 4, 64, 64
#: phase 13: the long-context request (model, tokens, pool pages of 16
#: KiB), the archs quickstart runs on the card and train_moe's steps (its
#: loss falls below 0.8x the first ten steps' by step ~50; one
#: checkpoint lands at step 100)
LONG_MODEL, LONG_CTX, LONG_PAGES = "minicpm3-4b", 32768, 73728
TRAIN_MOE_STEPS = 100
#: phase 13a's admission burst at published widths: 4 requests of 32768
#: tokens (a LongAlign-like length, one of Fig. 6's bins) against a 48
#: GiB pool of 16 KiB pages, host bookkeeping only
FULL_WIDTH_BURST = dict(total_pages=3 * 2 ** 20, page_bytes=16384,
                        long_ctx=32768)
#: phase 14a: moonshot at published widths through the sharded step on a
#: one-rank NCCL group; the decode's capacity factor gives the capacity
#: route 8 slots an expert for 4 tokens (4 x 6 x 20 / 64 = 7.5), the same
#: as the all-to-all's local dispatch (``C3``), so neither drops a pair
SHARD_MODEL, SHARD_BATCH, SHARD_PROMPT, SHARD_STEPS = (
    "moonshot-v1-16b-a3b", 4, 1024, 8)
SHARD_DECODE_CAPACITY = 20.0
#: the share of the card's free memory phase 14a's weights may take: the
#: init stacks the per-layer leaves, so it holds them twice at its peak
SHARD_MEMORY_SHARE = 0.4
#: phase 14b: minicpm3-4b at its published config, one request's cache of
#: POOL_CTX tokens split over POOL_RANKS processes sharing the card (gloo)
POOL_MODEL, POOL_CTX, POOL_RANKS, POOL_STEPS = "minicpm3-4b", 32768, 4, 4
#: seconds phase 14b's ranks may take, start to end
POOL_TIMEOUT = 300
#: phase 14b's equality gate runs the model in float32: in bf16 the
#: four-rank and one-rank decodes round their partial sums in another
#: order, and a one-ulp difference in one layer's output grows, layer by
#: layer, past the row limit and into other greedy tokens (the bf16 run
#: beside it measures how far; PERF.md, PR 23)
POOL_GATE_DTYPE = "float32"
#: phase 15: the sharded training step (``build_train_cell``) on phase 7's
#: model, depth, batch and sequence (float32, the grouped MoE path), this
#: many steps a run (the second is past the first step's warm-up, and each
#: of 15b's steps stages ~10 GB through the host); 15b's mesh (data,
#: model), four processes sharing the
#: card over gloo; the microbatches of every phase-15 run:
#: TRAIN_MICROBATCHES gives moonshot 4, and each one repeats 15b's FSDP
#: gathers and reduce-scatters through gloo's host staging
SHARDED_STEPS = 2
SHARDED_MESH = (2, 2)
SHARDED_MICROBATCHES = 1
#: at one rank the cell's step runs make_train_step's ops: its peak may
#: exceed the reference's by this much at most
SHARDED_PEAK_SLACK_GIB = 0.25
#: 15a's and 15b's runs: (label, PerfOpts levers)
SHARDED_VARIANTS = (("plain", {}),
                    ("seq_parallel+compress_grads",
                     {"seq_parallel": True, "compress_grads": True}))
#: seconds phase 15b's ranks may take, start to end, for every variant
SHARDED_TIMEOUT = 400
#: phase 16: the sharded serve step with every param leaf placed by the
#: serving rules, (label, arch, strategy, (data, model), dtype, depth:
#: None = the published depth, "fit" = phase 14a's rule at the dtype);
#: each float32 run is the equality gate of the bf16 run above it (in
#: bf16 the four ranks' partial sums round in another order than one
#: rank's: PERF.md on phase 14b)
SERVE_SHARD_RUNS = (
    ("16a bf16", "qwen3-14b", "monolithic", (1, 4), "bfloat16", None),
    ("16a float32", "qwen3-14b", "monolithic", (1, 4), "float32", "fit"),
    ("16b bf16", "moonshot-v1-16b-a3b", "crosspool", (2, 2), "bfloat16",
     "fit"),
    ("16b float32", "moonshot-v1-16b-a3b", "crosspool", (2, 2), "float32",
     "fit"))
#: phase 16's (prompts, prompt tokens, decode steps), its processes, the
#: seconds they may take start to end, and its float32 gate's limit on a
#: logit row's relative RMS error against the one-rank run
SERVE_SHARD_SIZES = (4, 512, 8)
SERVE_SHARD_RANKS = 4
SERVE_SHARD_TIMEOUT = 300
SERVE_SHARD_ROW_RMS = 1e-4
#: phase 17: the ssm, hybrid and audio archs at their full published
#: configs, phase 16's sizes: (a) the serve cell at one rank beside the
#: Model path, in each dtype; (b) four ranks on each (strategy, (data,
#: model)), every run in one spawn: float32 for every arch (the gate),
#: bf16 (measured, not gated) for FAMILY_BF16_ARCH alone, which keeps
#: the phase inside its 150 s
FAMILY_SHARD_ARCHS = ("zamba2-1.2b", "mamba2-130m", "whisper-small")
FAMILY_SHARD_MESHES = (("monolithic", (1, 4)), ("crosspool", (2, 2)))
FAMILY_SHARD_DTYPES = ("bfloat16", "float32")
FAMILY_BF16_ARCH = "zamba2-1.2b"
#: 17c: whisper's train cell, float32, at one rank and over (2, 2):
#: batch, tokens, the encoder and decoder depth (None: the published 12
#: each; 2: phase 17's 150 s, as phase 15's moonshot); SHARDED_STEPS
#: steps
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ, AUDIO_TRAIN_DEPTH = 4, 128, 2
AUDIO_TRAIN_MESH = (2, 2)
#: 17c's four-rank runs of whisper's cell: (label, PerfOpts levers); the
#: decoder's stream split over model under seq_parallel
AUDIO_TRAIN_VARIANTS = (("plain", {}), ("seq_parallel", {"seq_parallel": True}))
#: 17d: the ssm and hybrid train cells over four ranks, (label, the cell's
#: config by ``ssm_cell_cfg``'s arch, (data, model)), each held against its
#: one-rank run (7d's for zamba2)
SSM_SHARD_CELLS = (("zamba2 (2, 2)", "zamba2-1.2b", (2, 2)),
                   ("mamba2 (1, 4)", "mamba2-130m", (1, 4)))
#: 17b's float32 row limit: SERVE_SHARD_ROW_RMS, or this many times the
#: row error one float32 ulp of noise on every weight matrix gives the
#: one-rank Model path (17a measures it), whichever is larger.  The SSD
#: scan's decays are exp(La_i - La_j) of cumulative sums in the hundreds
#: over 512 tokens, so a one-ulp change of dt moves them ~1e-4 relative
#: (the JAX package's chunked form and the kernel alike): a reordered f32
#: sum anywhere upstream does the same.  Sound four-rank runs have read
#: up to 1.2x this witness (mamba2 over (2, 2); PERF.md)
FAMILY_NOISE_FACTOR = 2.5
#: 17b's control: these archs once more in float32 over crosspool (2, 2)
#: with TF32 matmuls (10 mantissa bits); each must FAIL the row limit
#: above, or the limit could not tell a lower-precision split from the
#: float32 rounding it allows
FAMILY_CONTROL_ARCHS = ("zamba2-1.2b", "mamba2-130m")
EXAMPLE_ARCHS = ("qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b", "minicpm3-4b",
                 "qwen3-14b")
#: phase 3: row 3's log-sum-exp output checked at moonshot's heads (16b's
#: Type I cache) and gemma3's (head dim 256), (label, H, KV, D), over
#: LSE_BATCH rows and caches of each of LSE_CONTEXTS tokens (several
#: splits; one tile: one split)
LSE_GEOMETRIES = (("moonshot", 16, 16, 128), ("gemma3", 16, 8, 256))
LSE_BATCH = 6
LSE_CONTEXTS = (1024, 64)
#: phase 8 times these kernels at these of its shapes and loads
TIMED_LOADS = {"gate/up layer 0": ("moe_gemm", "moe_gemm_dgrad",
                                   "moe_gemm_wgrad"),
               "gate/up skewed load": ("moe_gemm_wgrad",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches(kops) -> None:
    for name in KERNELS:
        getattr(kops, name).launches = 0
    kops.decode_attention.lse_launches = 0


def read_launches(kops) -> dict:
    """Every kernel's launches, and under ``decode_attention_lse`` row 3's
    calls with the log-sum-exp output (counted in ``decode_attention``
    too: one kernel)."""
    return dict({name: getattr(kops, name).launches for name in KERNELS},
                decode_attention_lse=kops.decode_attention.lse_launches)


def bound_ms(nbytes: float, flops: float, fp32: bool = False):
    """(least time in ms, what bounds it): bytes over the HBM rate vs
    flops over the peak of the work's type: the bf16 tensor-core peak, or
    the float32 peak for float32 work (``fp32``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP32_FLOPS if fp32 else BF16_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def ssd_bound(B, S, H, P, G, N, L, itemsize=2):
    """Row 6's least time for one call: x and y, B and C in the input
    type, dt f32 and the final f32 state moved once; the chunked form's
    products, at the bf16 peak, or for f32 (``itemsize`` 4) the lesser of
    the f32 peak and three TF32 passes (as ``ssd_bwd_bound``)."""
    nbytes = ((2 * B * S * H * P + 2 * B * S * G * N) * itemsize
              + B * S * H * 4 + H * 4 + B * H * P * N * 4)
    flops = B * H * (S // L) * (L * L * (N + P) + 4 * L * N * P)
    if itemsize != 4:
        return bound_ms(nbytes, flops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(flops / FP32_FLOPS, 3 * flops / TF32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def ssd_bwd_bound(B, S, H, P, G, N, L, itemsize):
    """Row 6b's least time for one call without h0 or dh (the train
    path's): x, dy, dx and B, C, dB, dC in the input type, dt and ddt, A
    and dA f32, dh0 f32, each moved once; the gradient's products over
    the lower triangle (C.B, dy.x, dx, dB, dC: L^2 (3N + 2P) flops a
    chunk) and its five P x N state products (the recomputed states, the
    reverse pass, dS.B, x.dS, dy.h: 10 L P N).  For f32 the least time of
    the two routes to f32-accurate products: the CUDA cores' f32 peak, or
    three TF32 passes at the tensor cores' TF32 peak (3 x flops / 495
    TF/s, the lesser); bf16 at the bf16 peak.  Never under the bytes'
    time."""
    nbytes = ((3 * B * S * H * P + 4 * B * S * G * N) * itemsize
              + 2 * B * S * H * 4 + 2 * H * 4 + B * H * P * N * 4)
    flops = B * H * (S // L) * (L * L * (3 * N + 2 * P) + 10 * L * N * P)
    if itemsize != 4:
        return bound_ms(nbytes, flops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(flops / FP32_FLOPS, 3 * flops / TF32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of one call, L2 flushed before each call (the
    decode step finds a layer's KV cold).  A spin kernel after the flush
    keeps the card busy while the host enqueues the timed call, so the
    two events bracket the call's device time, not the host's enqueue
    time (a call that takes microseconds on the card takes longer than
    that to enqueue)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def launch_split(torch, fn) -> dict:
    """{kernel: ms} of one call of ``fn`` under ``torch.profiler``: where
    a call of several launches spends its device time, each kernel of the
    port by its name in ``PORT_KERNELS`` (a warm call, L2 not flushed)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if not e.self_device_time_total:
            continue
        name = next((n for n in PORT_KERNELS if n in e.key), e.key[:40])
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out


def library_sdpa(torch, call):
    """(fastest ms, its backend, every backend's ms or why it refused) of
    ``call`` — one ``scaled_dot_product_attention`` call — under each SDPA
    backend that accepts its inputs: the library yardstick, never called
    by the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            times[name] = f"torch {torch.__version__} has no {name}"
            continue

        def run(backend=backend):
            with sdpa_kernel(backend):
                return call()
        try:                          # a yardstick, not a kernel of the port
            run()
            torch.cuda.synchronize()
        except RuntimeError as err:
            times[name] = f"refused: {str(err).splitlines()[0][:100]}"
            continue
        times[name] = time_ms(torch, run)
    ok = {k: v for k, v in times.items() if isinstance(v, float)}
    best = min(ok, key=ok.get)
    return ok[best], f"sdpa {best.lower()}", times


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

class Case:
    """One kernel geometry: GQA (H, KV, D) or MLA (H, r, rp) over pages of
    ``tpp`` tokens in a flat pool of ``page_elems``-element pages."""

    def __init__(self, name, kind, tpp, page_elems, H, KV=0, D=0, r=0, rp=0):
        self.name, self.kind, self.tpp, self.page_elems = \
            name, kind, tpp, page_elems
        self.H, self.KV, self.D, self.r, self.rp = H, KV, D, r, rp
        self.per_tok = 2 * KV * D if kind == "gqa" else r + rp
        self.q_dim = D if kind == "gqa" else r + rp
        self.out_dim = D if kind == "gqa" else r
        self.scale = (D ** -0.5 if kind == "gqa" else (r + rp) ** -0.5)


def make_inputs(torch, case, lengths, max_pages, dtype, gen, garbage,
                holes=()):
    """(q, pool, table, lengths) with every valid token random and, when
    ``garbage``, NaN everywhere else: slots past a length, mapped pages
    past it, unmapped pages and page slack.  ``holes``: (row, page index)
    pairs unmapped (-1) inside the row's length, their pages NaN."""
    B = len(lengths)
    need = [math.ceil(n / case.tpp) for n in lengths]
    n_pages = B * max_pages + 4
    if garbage:
        pool = torch.full((n_pages, case.page_elems), float("nan"),
                          dtype=dtype, device="cuda")
    else:
        pool = torch.randn((n_pages, case.page_elems), generator=gen,
                           device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    table = torch.full((B, max_pages), -1, dtype=torch.int32)
    for b in range(B):
        ids = perm[b * max_pages:(b + 1) * max_pages]
        # row 0 keeps mapped pages past its length (they hold garbage and
        # must be skipped); the other rows leave them unmapped (-1)
        n_map = max_pages if b == 0 else need[b]
        table[b, :n_map] = torch.tensor(ids[:n_map], dtype=torch.int32)
        for p in range(need[b] if garbage else 0):
            if (b, p) in holes:
                continue
            n_tok = min(case.tpp, lengths[b] - p * case.tpp)
            vals = torch.randn((n_tok * case.per_tok,), generator=gen,
                               device="cuda").to(dtype)
            pool[ids[p], :n_tok * case.per_tok] = vals
    for b, p in holes:
        table[b, p] = -1
    q = torch.randn((B, 1, case.H, case.q_dim), generator=gen,
                    device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pool, table.cuda(), lens


def without_holes(case, table, lengths, holes):
    """What the plain version must see to compute what the kernel does:
    each hole (a whole page unmapped inside a length, which the kernel
    skips) taken out of its row, the row's later pages moved up and its
    length cut by one page."""
    table, lengths = table.clone(), lengths.clone()
    for b in {b for b, _ in holes}:
        gone = sorted(p for r, p in holes if r == b)
        assert all((p + 1) * case.tpp < int(lengths[b]) for p in gone)
        keep = [p for p in range(table.shape[1]) if p not in gone]
        row = table[b, keep]
        table[b] = -1
        table[b, :len(keep)] = row
        lengths[b] -= len(gone) * case.tpp
    return table, lengths


def run_kernel(kops, case, q, pool, table, lens):
    if case.kind == "gqa":
        return kops.paged_decode_attention(
            q, pool, table, lens, tokens_per_page=case.tpp, n_kv=case.KV,
            scale=case.scale)
    return kops.paged_mla_decode_attention(
        q, pool, table, lens, tokens_per_page=case.tpp, latent_dim=case.r,
        scale=case.scale)


def run_plain(ref, case, q, pool, table, lens):
    n = pool.shape[0]
    typed = pool[:, :case.tpp * case.per_tok]
    if case.kind == "gqa":
        typed = typed.reshape(n, case.tpp, 2, case.KV, case.D)
        return ref.paged_decode_attention(q, typed, table, lens, case.scale)
    typed = typed.reshape(n, case.tpp, case.per_tok)
    return ref.paged_mla_decode_attention(q, typed, table, lens, case.r,
                                          case.scale)


def row_error(got, want) -> float:
    """The largest relative RMS error of an output row (the last axis),
    ``|got - want|_2 / |want|_2`` (a row of zeros counts 0 when both are
    zero)."""
    err = (got.float() - want.float()).norm(dim=-1)
    return (err / want.float().norm(dim=-1).clamp_min(1e-30)).max().item()


def rows_close_or_raise(what, got, want, limit=BF16_ROW_RMS) -> float:
    """``row_error``; raises past ``limit``."""
    rel = row_error(got, want)
    if rel > limit:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version (row relative RMS error {rel:.3g}, "
                             f"limit {limit})")
    return rel


def check(torch, kops, ref, case, lengths, max_pages, dtype, tol, gen,
          holes=()):
    """(max abs err, worst row's relative RMS error or None in float32)
    of the kernel against its plain version; raises past ``tol + tol *
    |plain|`` anywhere or, in bf16, past ``BF16_ROW_RMS`` in any row."""
    q, pool, table, lens = make_inputs(torch, case, lengths, max_pages,
                                       dtype, gen, garbage=True, holes=holes)
    got = run_kernel(kops, case, q, pool, table, lens).float()
    want = run_plain(ref, case, q, pool,
                     *without_holes(case, table, lens, holes)).float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{case.name}: kernel output is not finite")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{case.name} {dtype}: kernel disagrees with the plain version "
            f"(max abs err {err.max().item():.3g}, tolerance {tol})")
    rel = (rows_close_or_raise(f"{case.name} {dtype}", got, want)
           if dtype == torch.bfloat16 else None)
    return err.max().item(), rel


def sdpa_call(torch, case, q, pool, table, lens):
    """One ``scaled_dot_product_attention`` over KV gathered beforehand
    (full lengths): the library yardstick."""
    B, ctx = q.shape[0], int(lens[0])
    n = pool.shape[0]
    rows = pool[:, :case.tpp * case.per_tok].reshape(
        n, case.tpp, case.per_tok)[table.long()].reshape(
        B, -1, case.per_tok)[:, :ctx]
    qh = q.transpose(1, 2)                                   # [B,H,1,dq]
    if case.kind == "gqa":
        kv = rows.reshape(B, ctx, 2, case.KV, case.D)
        k = kv[:, :, 0].transpose(1, 2).contiguous()          # [B,KV,T,D]
        v = kv[:, :, 1].transpose(1, 2).contiguous()
    else:
        k = rows[:, None].contiguous()                        # [B,1,T,E]
        v = rows[:, None, :, :case.r].contiguous()            # [B,1,T,r]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, k, v, scale=case.scale, enable_gqa=True)


def bound(case, B, ctx, max_pages, itemsize):
    """Least time for the work: bytes (KV read once, q/table/lengths
    read, out written) over HBM rate vs flops over the peak of the type
    (bf16 tensor cores, or float32 for 4-byte items)."""
    nbytes = (B * ctx * case.per_tok * itemsize
              + B * case.H * (case.q_dim + case.out_dim) * itemsize
              + B * max_pages * 4 + B * 4)
    flops = 2 * B * case.H * ctx * (case.q_dim + case.out_dim)
    return bound_ms(nbytes, flops, fp32=itemsize == 4)


def split_boundary(torch, case, B, max_pages, dtype=None) -> int:
    """First token of the second split of the GQA or MLA kernel in
    ``dtype`` (bf16 by default) for B rows over this table: a length
    equal to it ends exactly on a boundary."""
    from repro_torch.kernels import paged_attention as pa
    dtype = dtype or torch.bfloat16
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    tokens = max_pages * case.tpp
    if case.kind == "gqa":
        _, splits = pa.split_plan(B, case.H, case.KV, tokens, sm, dtype)
    elif dtype == torch.bfloat16:
        _, splits = pa.mla_split_plan(B, case.H, tokens, sm)
    else:
        _, splits = pa.split_plan(B, case.H, 1, tokens, sm, dtype)
    return pa.split_start(1, splits, tokens)


def kernel_phase(torch, kops, ref, cases):
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {}

    def run_check(case, lengths, max_pages, dtype, tol, holes=(), note=""):
        e, rel = check(torch, kops, ref, case, lengths, max_pages, dtype,
                       tol, gen, holes)
        errs[case.kind] = max(errs.get(case.kind, 0.0), e)
        key = f"{case.kind}_{str(dtype)[6:]}"
        errs[key] = max(errs.get(key, 0.0), e)
        rule = f"tolerance {tol}"
        if rel is not None:
            key = f"{case.kind}_row_rms"
            errs[key] = max(errs.get(key, 0.0), rel)
            rule += f"; row relative RMS err {rel:.3g} <= {BF16_ROW_RMS}"
        log(f"kernel check {case.name} {str(dtype)[6:]} lengths {lengths}"
            f"{note}: max abs err {e:.3g} ({rule})")

    for case in cases:
        tpp = case.tpp
        whole = tpp * 37                      # ends exactly on a page
        mid = tpp * 20 + max(tpp // 2, 1) if tpp > 1 else 41
        max_pages = math.ceil(1024 / tpp)
        run_check(case, [1000, whole, mid, 1], max_pages, torch.bfloat16,
                  2e-2)
        # the split kernel's edges: length 0 and 1, on a split boundary
        # and one token either side of it, ending mid-page
        edge = split_boundary(torch, case, 6, max_pages)
        lengths = [0, 1, edge, edge - 1, edge + 1,
                   tpp * min(50, max_pages - 3) + max(1, tpp // 2)]
        run_check(case, lengths, max_pages, torch.bfloat16, 2e-2,
                  note=f" (split boundary {edge})")
        # unmapped (-1) pages inside a length are skipped
        holes = ((0, 3), (1, 10), (1, 11))
        run_check(case, [1000, 700], max_pages, torch.bfloat16, 2e-2,
                  holes=holes, note=f" (-1 pages at (row, page) {holes})")
        # one row at a long context: many tiles per split
        run_check(case, [32768 - 3], math.ceil(32768 / tpp), torch.bfloat16,
                  2e-2)
    # float32 at the path's geometries: the f32 body's split edges, -1
    # pages inside a length, one row at context 32768
    for case in cases:
        tpp = case.tpp
        max_pages = math.ceil(1024 / tpp)
        edge = split_boundary(torch, case, 6, max_pages, torch.float32)
        lengths = [0, 1, edge, edge - 1, edge + 1,
                   tpp * min(50, max_pages - 3) + max(1, tpp // 2)]
        run_check(case, lengths, max_pages, torch.float32, 2e-5,
                  note=f" (f32 split boundary {edge})")
        run_check(case, [1000, 700], max_pages, torch.float32, 2e-5,
                  holes=((0, 3), (1, 10), (1, 11)),
                  note=" (-1 pages inside the lengths)")
        run_check(case, [32768 - 3], math.ceil(32768 / tpp), torch.float32,
                  2e-5)
    # float32 on one small shape per kernel
    small = [Case("gqa-small", "gqa", 8, 8 * 2 * 4 * 64, H=16, KV=4, D=64),
             Case("mla-small", "mla", 8, 8 * 80 + 16, H=8, r=64, rp=16)]
    for case in small:
        run_check(case, [37, 16, 1], 8, torch.float32, 2e-5)
    run_check(small[0], [0, 37, 30], 8, torch.float32, 2e-5,
              holes=((1, 1),), note=" (-1 page at (row, page) (1, 1))")
    # the smoke configs' GQA geometry (head dim 8, CUDA cores), bf16: what
    # the serve CLI runs by default
    d8 = Case("gqa-smoke-d8", "gqa", 8, 8 * 2 * 2 * 8, H=8, KV=2, D=8)
    run_check(d8, [0, 1, 37, 64], 8, torch.bfloat16, 2e-2)
    # ... and its MLA geometry (r + rp = 24: the score's k padded to 32)
    mla_smoke = Case("mla-smoke", "mla", 8, 8 * 24 + 8, H=4, r=16, rp=8)
    run_check(mla_smoke, [0, 1, 37, 64], 8, torch.bfloat16, 2e-2)
    run_check(mla_smoke, [300, 65, 64, 63], 40, torch.bfloat16, 2e-2,
              note=" (several splits)")
    rows = []
    # bf16 at both batches; float32 at B = 4 over f32 pages of 16 KiB
    timed = [(case, torch.bfloat16, BATCHES) for case in cases]
    f32_elems = DEFAULT_PAGE_BYTES // 4
    timed += [(Case(c.name, c.kind, f32_elems // c.per_tok, f32_elems, H=c.H,
                    KV=c.KV, D=c.D, r=c.r, rp=c.rp), torch.float32, (4,))
              for c in cases]
    for case, dtype, batches in timed:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        for ctx in CONTEXTS:
            max_pages = math.ceil(ctx / case.tpp)
            for B in batches:
                q, pool, table, lens = make_inputs(
                    torch, case, [ctx] * B, max_pages, dtype, gen,
                    garbage=False)
                ms = time_ms(torch, lambda: run_kernel(kops, case, q, pool,
                                                       table, lens))
                plain = time_ms(torch, lambda: run_plain(ref, case, q, pool,
                                                         table, lens))
                lib, lib_name, lib_all = library_sdpa(
                    torch, sdpa_call(torch, case, q, pool, table, lens))
                b_ms, b_by = bound(case, B, ctx, max_pages, itemsize)
                rows.append(dict(case=case.name, kind=case.kind, ctx=ctx,
                                 B=B, dtype=str(dtype)[6:], ms=ms,
                                 plain_ms=plain, library_ms=lib,
                                 library=lib_name, library_all=lib_all,
                                 bound_ms=b_ms, bound_by=b_by))
                log(f"time {case.name} {str(dtype)[6:]} ctx {ctx} B {B}: "
                    f"kernel {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, {lib_name} {lib:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}); sdpa backends "
                    f"{fmt_backends(lib_all)}")
                del q, pool, table, lens
    return errs, rows


def shared_page_phase(torch, kops, ref, cases):
    """The prefix cache's page tables (phase 3): two batch rows whose
    tables share their first pages (refcount > 1 in the engine) and then
    end in different copy-on-write fork pages — each a copy of the first
    ``fork`` token rows of one tree page, then the row's own tokens — and
    fresh pages.  Paged GQA (qwen3-moe) and paged MLA (minicpm3) against
    their plain versions, bf16 within 2e-2 and float32 within 2e-5; then
    the pool write of rows starting mid-page at a fork, bit for bit,
    with every page outside the row's own left as it was (the shared and
    the copied-from pages are never written).  Returns the max errors."""
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    errs = {}
    geoms = [c for c in cases
             if c.name in ("qwen3-moe-235b-a22b", "minicpm3-4b")]
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        elems = DEFAULT_PAGE_BYTES // (2 if dtype == torch.bfloat16 else 4)
        for g in geoms:
            case = Case(g.name, g.kind, elems // g.per_tok, elems, H=g.H,
                        KV=g.KV, D=g.D, r=g.r, rp=g.rp)
            tpp, n_shared = case.tpp, 24
            forks = (max(1, tpp // 3), tpp - 1)
            extra = (37, 3 * tpp + 2)
            lengths = [n_shared * tpp + f + e for f, e in zip(forks, extra)]
            own = [math.ceil((f + e) / tpp) for f, e in zip(forks, extra)]
            n_pages = n_shared + 1 + sum(own) + 8
            ids = torch.randperm(n_pages, generator=gen,
                                 device="cuda").tolist()
            shared, src = ids[:n_shared], ids[n_shared]
            pool = torch.full((n_pages, elems), float("nan"), dtype=dtype,
                              device="cuda")

            def fill(page, lo, hi):
                n = (hi - lo) * case.per_tok
                pool[page, lo * case.per_tok:hi * case.per_tok] = torch.randn(
                    (n,), generator=gen, device="cuda").to(dtype)
            for p in shared + [src]:
                fill(p, 0, tpp)
            max_pages = n_shared + max(own)
            table = torch.full((2, max_pages), -1, dtype=torch.int32)
            nxt = n_shared + 1
            for b in range(2):
                mine = ids[nxt:nxt + own[b]]
                nxt += own[b]
                table[b, :n_shared] = torch.tensor(shared)
                table[b, n_shared:n_shared + own[b]] = torch.tensor(mine)
                pool[mine[0], :forks[b] * case.per_tok] = \
                    pool[src, :forks[b] * case.per_tok]        # the copy
                left = forks[b] + extra[b]
                for i, p in enumerate(mine):
                    lo = forks[b] if i == 0 else 0
                    fill(p, lo, min(tpp, left - i * tpp))
            table = table.cuda()
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            q = torch.randn((2, 1, case.H, case.q_dim), generator=gen,
                            device="cuda").to(dtype)
            got = run_kernel(kops, case, q, pool, table, lens).float()
            want = run_plain(ref, case, q, pool, table, lens).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            if not torch.isfinite(got).all() or \
                    (err > tol + tol * want.abs()).any():
                raise AssertionError(
                    f"shared pages {case.name} {dtype}: kernel disagrees "
                    f"with the plain version (max abs err "
                    f"{err.max().item():.3g}, tolerance {tol})")
            rule = f"tolerance {tol}"
            if dtype == torch.bfloat16:
                rel = rows_close_or_raise(f"shared pages {case.name} {dtype}",
                                          got, want)
                rule += f"; row relative RMS err {rel:.3g} <= {BF16_ROW_RMS}"
            errs[(case.kind, str(dtype))] = err.max().item()
            log(f"kernel check {case.name} {str(dtype)[6:]} shared pages: "
                f"{n_shared} pages shared by 2 rows, copy-on-write forks at "
                f"slots {forks} of {tpp}, lengths {lengths}: max abs err "
                f"{err.max().item():.3g} ({rule})")
            # the pool write of row 0's suffix, from the fork on
            pos = torch.arange(n_shared * tpp + forks[0], lengths[0],
                               device="cuda")
            pages = table[0].long()[pos // tpp].to(torch.int32)
            slots = (pos % tpp).to(torch.int32)
            rows = torch.randn((len(pos), case.per_tok), generator=gen,
                               device="cuda").to(dtype)
            before = torch.nan_to_num(pool.float(), nan=7.0)
            want = ref.paged_kv_write(pool.clone(), rows, pages, slots)
            got = kops.paged_kv_write(pool.clone(), rows, pages, slots)
            torch.cuda.synchronize()
            if not torch.equal(torch.nan_to_num(got.float(), nan=7.0),
                               torch.nan_to_num(want.float(), nan=7.0)):
                raise AssertionError(f"pool write at a fork {case.name} "
                                     f"{dtype}: kernel differs from the "
                                     f"plain version")
            written = set(table[0, n_shared:n_shared + own[0]].tolist())
            others = [p for p in range(n_pages) if p not in written]
            if not torch.equal(torch.nan_to_num(got.float(), nan=7.0)[others],
                               before[others]):
                raise AssertionError(f"pool write at a fork {case.name}: a "
                                     f"shared or source page was written")
            log(f"kernel check paged_kv_write {case.name} {str(dtype)[6:]}: "
                f"{len(pos)} rows from slot {forks[0]} of a fork page, equal "
                f"to the plain version; shared and source pages untouched")
    return errs


def fmt_backends(times) -> str:
    return ", ".join(f"{k.lower()} {v:.4f}" if isinstance(v, float)
                     else f"{k.lower()} {v}" for k, v in times.items())


def capture_check(torch, kops, cases):
    """The bf16 GQA and MLA decode wrappers read nothing back to the host
    (they run under ``set_sync_debug_mode("error")``), and a paged GQA
    call and a paged MLA call, each captured in a CUDA graph and replayed
    after new lengths are written in place, equal an eager call on those
    lengths."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    gqa = next(c for c in cases if c.kind == "gqa")
    mla = next(c for c in cases if c.kind == "mla")
    paged = []
    for case in (gqa, mla):
        max_pages = math.ceil(1024 / case.tpp)
        paged.append((case, make_inputs(torch, case, [1000, 1024, 333, 64],
                                        max_pages, torch.bfloat16, gen,
                                        garbage=True)))
    ck = torch.randn((2, 512, 2, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    qc = torch.randn((2, 1, 8, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    clens = torch.tensor([512, 77], dtype=torch.int32, device="cuda")

    def calls():
        return ([run_kernel(kops, case, *inputs) for case, inputs in paged]
                + [kops.decode_attention(qc, ck, ck, clens, scale=0.125)])
    calls()                                  # built, attributes set
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    for case, inputs in paged:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run_kernel(kops, case, *inputs)
        inputs[3].copy_(torch.tensor([700, 1, 0, 64], dtype=torch.int32))
        graph.replay()
        want = run_kernel(kops, case, *inputs)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"graph replay of the {case.name} decode "
                                 f"call after new lengths differs from an "
                                 f"eager call")
    log(f"kernel check {gqa.name} and {mla.name}: no host sync under "
        f"set_sync_debug_mode('error') (paged GQA, paged MLA, contiguous); "
        f"a CUDA-graph replay of each paged call with new lengths "
        f"[700, 1, 0, 64] equals eager")


def row_limit(torch, dtype):
    """``close_or_raise``'s ``row_rms`` for rows 3 and 4 in ``dtype``."""
    return BF16_ROW_RMS if dtype == torch.bfloat16 else None


def close_or_raise(torch, what, got, want, tol, row_rms=None) -> float:
    """Max abs error of ``got`` against ``want``; raises past
    ``tol + tol * |want|`` or on a non-finite output.  With ``row_rms``
    also past a relative RMS error of ``row_rms`` in any output row (the
    last axis): ``|got - want|_2 <= row_rms * |want|_2``.  That bounds a
    bf16 output's rounding where the elementwise ``tol`` cannot: an
    attention row over T keys is ~sqrt(e / T), about ``tol`` itself at
    T = 4096."""
    got, want = got.float(), want.float()
    sync(torch, got.device)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    if (err > tol + tol * want.abs()).any():
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version (max abs err {err.max().item():.3g},"
                             f" tolerance {tol})")
    rule = f"|err| <= {tol} + {tol} * |plain|"
    if row_rms is not None:
        rel = rows_close_or_raise(what, got, want, row_rms)
        rule += f"; row relative RMS err {rel:.3g} <= {row_rms}"
    log(f"kernel check {what}: max abs err {err.max().item():.3g} "
        f"(passes {rule})")
    return err.max().item()


def fallback_kernel_phase(torch, kops, ref, ssd_scan_chunked):
    """Flash prefill, contiguous decode and the SSD scan at the fallback
    path's geometries: checks, then times (bf16, the path's dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    zamba = get_config("zamba2-1.2b")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    H, KV, D = zamba.n_heads, zamba.n_kv_heads, zamba.head_dim
    errs, rows = {}, []

    # flash prefill: zamba2 heads, S = T in {256, 1024, 4096}, B = 1
    for S in (256, 1024, 4096):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            if dtype == torch.float32 and S > 1024:
                continue
            q, k, v = (randn(1, S, n, D, dtype=dtype) for n in (H, KV, KV))
            e = close_or_raise(
                torch, f"flash zamba2 S={S} {dtype}",
                kops.flash_attention(q, k, v, scale=D ** -0.5),
                ref.flash_attention(q, k, v, D ** -0.5), tol,
                row_limit(torch, dtype))
            errs["flash_attention"] = max(errs.get("flash_attention", 0), e)
        q, k, v = (randn(1, S, n, D) for n in (H, KV, KV))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2
        b_ms, b_by = bound_ms(4 * S * H * D * 2, 4 * H * D * pairs)
        lib, lib_name, lib_all = library_sdpa(torch, lambda: sdpa(
            qt, kt, vt, is_causal=True, scale=D ** -0.5, enable_gqa=True))
        rows.append(dict(
            kernel="flash_attention", shape=f"zamba2 B=1 S={S} bf16",
            ms=time_ms(torch, lambda: kops.flash_attention(
                q, k, v, scale=D ** -0.5)),
            plain_ms=time_ms(torch, lambda: ref.flash_attention(
                q, k, v, D ** -0.5)),
            library_ms=lib, library=lib_name, library_all=lib_all,
            bound_ms=b_ms, bound_by=b_by))
    # the wgmma body's edges: T > S (an offset that is no multiple
    # of the tile), S and T off the tile, every head dim, GQA groups
    for B, S, T, Hh, Kh, Dh in ((1, 100, 1000, 8, 2, 64),
                                (2, 77, 77, 4, 4, 16),
                                (1, 190, 250, 8, 2, 16),
                                (1, 190, 250, 8, 2, 32),
                                (1, 190, 250, 8, 2, 64),
                                (1, 190, 250, 8, 2, 128)):
        q, k, v = (randn(B, n, h, Dh) for n, h in ((S, Hh), (T, Kh), (T, Kh)))
        e = close_or_raise(
            torch, f"flash B={B} S={S} T={T} H={Hh} KV={Kh} D={Dh} bf16",
            kops.flash_attention(q, k, v, scale=Dh ** -0.5),
            ref.flash_attention(q, k, v, Dh ** -0.5), 2e-2, BF16_ROW_RMS)
        errs["flash_attention"] = max(errs["flash_attention"], e)

    # contiguous decode: zamba2 heads, T = 1024, B in {1, 4}
    T = 1024
    for B in (1, 4):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            q = randn(B, 1, H, D, dtype=dtype)
            ck, cv = randn(B, T, KV, D, dtype=dtype), randn(B, T, KV, D,
                                                            dtype=dtype)
            lengths = [T, 517, 1, 300][:B]
            for b, n in enumerate(lengths):
                ck[b, n:] = float("nan")
                cv[b, n:] = float("nan")
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            e = close_or_raise(
                torch, f"decode zamba2 B={B} T={T} lengths {lengths} {dtype}",
                kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5),
                ref.decode_attention(q, ck, cv, lens, D ** -0.5), tol,
                row_limit(torch, dtype))
            errs["decode_attention"] = max(errs.get("decode_attention", 0), e)
        q, ck, cv = randn(B, 1, H, D), randn(B, T, KV, D), randn(B, T, KV, D)
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
        b_ms, b_by = bound_ms(2 * B * T * KV * D * 2 + 2 * B * H * D * 2
                              + 4 * B, 4 * B * H * T * D)
        lib, lib_name, lib_all = library_sdpa(torch, lambda: sdpa(
            qt, kt, vt, scale=D ** -0.5, enable_gqa=True))
        rows.append(dict(
            kernel="decode_attention", shape=f"zamba2 B={B} T={T} bf16",
            ms=time_ms(torch, lambda: kops.decode_attention(
                q, ck, cv, lens, scale=D ** -0.5)),
            plain_ms=time_ms(torch, lambda: ref.decode_attention(
                q, ck, cv, lens, D ** -0.5)),
            library_ms=lib, library=lib_name, library_all=lib_all,
            bound_ms=b_ms, bound_by=b_by))
    # the split kernel's edges on the contiguous cache: length 0 and 1,
    # on a split boundary and one past it, and past T (clamped)
    B = 6
    _, splits = pa.split_plan(
        B, H, KV, T, torch.cuda.get_device_properties(0).multi_processor_count)
    edge = pa.split_start(1, splits, T)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        lengths = [0, 1, edge, edge + 1, 700, T + 5]
        q = randn(B, 1, H, D, dtype=dtype)
        ck, cv = randn(B, T, KV, D, dtype=dtype), randn(B, T, KV, D,
                                                        dtype=dtype)
        for b, n in enumerate(lengths):
            ck[b, n:] = float("nan")
            cv[b, n:] = float("nan")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        e = close_or_raise(
            torch, f"decode zamba2 B={B} T={T} lengths {lengths} {dtype}",
            kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5),
            ref.decode_attention(q, ck, cv, lens, D ** -0.5), tol,
            row_limit(torch, dtype))
        errs["decode_attention"] = max(errs["decode_attention"], e)

    # SSD scan: zamba2 and mamba2 at S = 1024, chunk 256
    def ssd_inputs(B, S, Hs, P, G, N, dtype, with_h0, shift=2.0):
        x = randn(B, S, Hs, P, dtype=dtype)
        dt = torch.nn.functional.softplus(
            randn(B, S, Hs, dtype=torch.float32) - shift)
        A = -torch.exp(torch.linspace(0.0, 2.77, Hs, device="cuda"))
        Bm, Cm = randn(B, S, G, N, dtype=dtype), randn(B, S, G, N,
                                                       dtype=dtype)
        h0 = randn(B, Hs, P, N, dtype=torch.float32) if with_h0 else None
        return x, dt, A, Bm, Cm, h0

    def ssd_check(what, L, x, dt, A, Bm, Cm, h0, tol):
        y, h = kops.ssd_scan(x, dt, A, Bm, Cm, chunk=L, h0=h0)
        wy, wh = ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=L, h0=h0)
        e = close_or_raise(torch, what + " y", y, wy, tol)
        close_or_raise(torch, what + " h", h, wh, 1e-3)
        errs["ssd_scan"] = max(errs.get("ssd_scan", 0), e)

    geoms = ssd_geometries()
    S, L = 1024, 256
    for label, (Hs, P, G, N) in geoms.items():
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            for with_h0 in (False, True):
                ssd_check(f"ssd {label} S={S} chunk {L} {dtype} h0={with_h0}",
                          L, *ssd_inputs(1, S, Hs, P, G, N, dtype, with_h0),
                          tol)
    # the chunk-parallel design's edges: 64 chunks, a chunk off the mma
    # tile, two groups, two batch rows with h0
    Hz, Pz, _, Nz = geoms["zamba2"]
    Hm, Pm, _, Nm = geoms["mamba2"]
    for B, S_, Hs, P, G, N, L_, with_h0, note in (
            (1, 4096, Hm, Pm, 1, Nm, 64, True, "64 chunks"),
            (1, 40, 4, Pz, 1, Nz, 8, True, "chunk 8"),
            (1, 512, 8, Pz, 2, Nz, 128, False, "G=2"),
            (2, 512, Hz, Pz, 1, Nz, 256, True, "B=2 with h0")):
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            ssd_check(f"ssd {note}: B={B} S={S_} H={Hs} P={P} G={G} N={N} "
                      f"chunk {L_} {dtype} h0={with_h0}", L_,
                      *ssd_inputs(B, S_, Hs, P, G, N, dtype, with_h0), tol)
    # timed at the path's two prompt sizes: 200-900-token prompts mostly
    # run the 512 bucket, the profiled 1024 bucket is the largest
    for S in (1024, 512):
        for label, (Hs, P, G, N) in geoms.items():
            x, dt, A, Bm, Cm, _ = ssd_inputs(1, S, Hs, P, G, N,
                                             torch.bfloat16, False, 0.0)
            b_ms, b_by = ssd_bound(1, S, Hs, P, G, N, L)
            rows.append(dict(
                kernel="ssd_scan", shape=f"{label} H={Hs} P={P} N={N} "
                                         f"S={S} chunk {L} bf16",
                ms=time_ms(torch, lambda: kops.ssd_scan(x, dt, A, Bm, Cm,
                                                        chunk=L)),
                plain_ms=time_ms(torch, lambda: ssd_scan_chunked(
                    x, dt, A, Bm, Cm, chunk=L)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by))
    # and in float32 at the train path's shape (phases 7b-7d)
    for label, (Hs, P, G, N) in geoms.items():
        x, dt, A, Bm, Cm, _ = ssd_inputs(TRAIN_BATCH, TRAIN_SEQ, Hs, P, G, N,
                                         torch.float32, False, 0.0)
        b_ms, b_by = ssd_bound(TRAIN_BATCH, TRAIN_SEQ, Hs, P, G, N, L, 4)
        rows.append(dict(
            kernel="ssd_scan", shape=f"{label} H={Hs} P={P} N={N} "
                                     f"B={TRAIN_BATCH} S={TRAIN_SEQ} chunk "
                                     f"{L} f32 (train shape)",
            ms=time_ms(torch, lambda: kops.ssd_scan(x, dt, A, Bm, Cm,
                                                    chunk=L)),
            plain_ms=time_ms(torch, lambda: ssd_scan_chunked(
                x, dt, A, Bm, Cm, chunk=L)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del x, dt, A, Bm, Cm
    for r in rows:
        lib = ("library none (no single PyTorch call computes it)"
               if r["library_ms"] is None else
               f"{r['library']} {r['library_ms']:.4f} ms (sdpa backends "
               f"{fmt_backends(r['library_all'])})")
        log(f"time {r['kernel']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {lib}")
    return errs, rows


def ssd_geometries():
    """{label: (H, P, G, N)} of the zamba2 and mamba2 SSD blocks."""
    from repro_torch.configs import get_config
    out = {}
    for label, name in (("zamba2", "zamba2-1.2b"), ("mamba2", "mamba2-130m")):
        cfg = get_config(name)
        s = cfg.ssm
        out[label] = (s.n_heads(cfg.d_model), s.head_dim, s.n_groups,
                      s.d_state)
    return out


def ssd_backward_phase(torch, kops, ssd_scan_chunked_bwd):
    """Row 6b, the SSD scan's backward, against autograd of the chunked
    form on the card: each of dx, ddt, dA, dB, dC, dh0 within 1e-3 (f32)
    or 2e-2 (bf16) of its scale, max(1, max|plain|) (the decays are exp of
    log-decay sums taken in another order, as in the forward's check);
    two calls equal bit for bit.  At the zamba2 and mamba2 geometries at
    S = 1024, chunk 256 (without h0 and dh, and with both), the train
    shape, chunks of 8 and 64 with nc >= 8, and G = 2; dh zero, given and
    absent.  Then times it (``SSD_BWD_TIMED``) beside its bound and the
    plain version, and splits one call's device time by launch
    (``launch_split``).  Returns (the worst error against scale, the
    largest absolute error, timed rows)."""
    geoms = ssd_geometries()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16

    def inputs(B, S, H, P, G, N, dtype, with_h0, dh, shift=2.0):
        def randn(*shape, dtype=f32):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        x = randn(B, S, H, P, dtype=dtype)
        dt = torch.nn.functional.softplus(randn(B, S, H) - shift)
        A = -torch.exp(torch.linspace(0.0, 2.77, H, device="cuda"))
        Bm, Cm = randn(B, S, G, N, dtype=dtype), randn(B, S, G, N, dtype=dtype)
        h0 = randn(B, H, P, N) if with_h0 else None
        dy = randn(B, S, H, P, dtype=dtype)
        dhv = {None: None, "zero": torch.zeros((B, H, P, N), device="cuda"),
               "given": randn(B, H, P, N)}[dh]
        return x, dt, A, Bm, Cm, h0, dy, dhv

    Hz, Pz, _, Nz = geoms["zamba2"]
    Hm, Pm, _, Nm = geoms["mamba2"]
    cases = []
    for label, (H, P, G, N) in geoms.items():
        for dtype in (f32, bf16):
            cases.append((f"{label} S=1024", 1, 1024, H, P, G, N, 256, dtype,
                          False, None))
            cases.append((f"{label} S=1024", 1, 1024, H, P, G, N, 256, dtype,
                          True, "given"))
        cases.append((f"{label} train shape", TRAIN_BATCH, TRAIN_SEQ, H, P,
                      G, N, 256, f32, False, None))
    for dtype in (f32, bf16):
        cases += [("chunk 8", 1, 64, 4, Pz, 1, Nz, 8, dtype, True, "zero"),
                  ("chunk 64", 1, 512, 8, Pm, 1, Nm, 64, dtype, True,
                   "given"),
                  ("G=2", 2, 512, 8, Pz, 2, Nz, 128, dtype, True, "given")]
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    worst, abs_err = 0.0, 0.0
    for label, B, S, H, P, G, N, L, dtype, with_h0, dh in cases:
        what = (f"ssd backward {label}: B={B} S={S} H={H} P={P} G={G} N={N} "
                f"chunk {L} {dtype} h0={with_h0} dh={dh}")
        tol = 1e-3 if dtype == f32 else 2e-2
        ins = inputs(B, S, H, P, G, N, dtype, with_h0, dh)
        got = kops.ssd_scan_bwd(*ins, chunk=L)
        again = kops.ssd_scan_bwd(*ins, chunk=L)
        want = ssd_scan_chunked_bwd(*ins, chunk=L)
        sync(torch, "cuda")
        errs = []
        for name, g, a, w in zip(names, got, again, want):
            if not torch.equal(g, a):
                raise AssertionError(f"{what}: {name} differs between two "
                                     f"calls")
            g, w = g.float(), w.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{what}: {name} is not finite")
            scale = max(1.0, float(w.abs().max()))
            err = float((g - w).abs().max())
            if not err <= tol * scale:
                raise AssertionError(f"{what}: {name} disagrees with the "
                                     f"plain version ({err:.3g} > {tol} x "
                                     f"scale {scale:.3g})")
            errs.append(f"{name} {err / scale:.2g}")
            worst = max(worst, err / scale)
            abs_err = max(abs_err, err)
        log(f"kernel check {what}: max abs err / scale {', '.join(errs)} "
            f"(passes {tol} x max(1, max|plain|)); equal bit for bit across "
            f"two calls")
        del ins, got, again, want
    rows = []
    for label, B, S, L, dtype in SSD_BWD_TIMED:
        dtype = getattr(torch, dtype)
        for geom, (H, P, G, N) in geoms.items():
            ins = inputs(B, S, H, P, G, N, dtype, False, None, 0.0)
            b_ms, b_by = ssd_bwd_bound(B, S, H, P, G, N, L,
                                       ins[0].element_size())
            rows.append(dict(
                kernel="ssd_scan_bwd", label=label,
                shape=f"{geom} H={H} P={P} N={N} B={B} S={S} chunk {L} "
                      f"{str(dtype).split('.')[-1]}",
                ms=time_ms(torch, lambda: kops.ssd_scan_bwd(*ins, chunk=L)),
                plain_ms=time_ms(torch, lambda: ssd_scan_chunked_bwd(
                    *ins, chunk=L)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                split=launch_split(torch, lambda: kops.ssd_scan_bwd(
                    *ins, chunk=L))))
            del ins
    for r in rows:
        log(f"time ssd_scan_bwd {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (autograd of the chunked form, its "
            f"forward included), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library none (no single PyTorch call "
            f"computes it); one call by launch: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in r["split"].items()))
    return worst, abs_err, rows


def with_empty_experts(np, sizes, n_empty: int = 4):
    """``sizes`` with the rows of its ``n_empty`` least loaded experts
    moved onto the most loaded one: the same rows, some experts empty."""
    out = sizes.copy()
    idle = np.argsort(out, kind="stable")[:n_empty]
    busiest = int(np.argmax(out))
    out[busiest] += out[idle].sum()
    out[idle] = 0
    return out


def off_tile_edges(np, n, experts, tile=128):
    """``n`` rows over ``experts`` whose every boundary falls one row past
    a ``tile``-row edge (the grouped GEMM's row tile)."""
    per = n // experts // tile * tile
    sizes = np.full(experts, per, np.int32)
    sizes[0] += 1
    sizes[-1] = n - int(sizes[:-1].sum())
    return sizes


def skewed(np, n, experts, share=0.9):
    """``n`` rows with one expert holding at least ``share`` of them."""
    rest = int(n * (1 - share)) // (experts - 1)
    sizes = np.full(experts, rest, np.int32)
    sizes[experts // 2] = n - rest * (experts - 1)
    return sizes


def library_grouped_mm(torch, a, b, offs):
    """(``torch._grouped_mm`` call, None) on these operands, or (None, the
    reason it cannot run them): the library yardstick, never called by the
    port."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    try:
        fn(a, b, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as err:
        return None, f"torch._grouped_mm refuses {a.dtype}: " \
                     f"{str(err).splitlines()[0][:120]}"
    return (lambda: fn(a, b, offs=offs)), None


def bf16_gemm_report(mgk, D, F, E):
    """Lines on the bf16 grouped GEMM bodies as built: each instance's
    registers and spills from the build's ``-Xptxas -v`` report, and the
    plan (tile, stages, dynamic shared memory) each of phase 8's calls is
    launched with, from the library."""
    from repro_torch.kernels import build
    text = build.library_path(build.CSRC / "moe_gemm.cu").with_suffix(
        ".so.log").read_text()
    out, name, spill = [], None, ""
    for line in text.splitlines():
        found = re.search(r"grouped_gemm_bf16_kernelILi(\d)ELi(\d+)ELi(\d+)"
                          r"ELb(\d)", line)
        if found:
            op, bm, bn, tma = found.groups()
            name = (f"{mgk.OPS[int(op)]} {bm}x{bn} "
                    f"{mgk.ROUTES[int(tma)]}")
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"bf16 body {name}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
            name = None
    for op, k, m in (("forward", D, F), ("dgrad", F, D), ("wgrad", D, F),
                     ("forward", F, D), ("dgrad", D, F), ("wgrad", F, D)):
        cols = k if op == "dgrad" else m
        plan = mgk.kernel_plan(op, "tma", cols, E, kdim=k)
        out.append(f"bf16 plan {op} K={k} M={m}: {plan}")
    return out


def moe_kernel_phase(torch, np, kops, ref, loads):
    """Phase 8: the grouped GEMM at the shapes phase 7 gives it (x
    [8*512*top-6, K], w [E, K, M] with (K, M) = (d_model, d_ff) for gate
    and up, (d_ff, d_model) for down) with the router's ``loads`` (one
    [E] array per layer), the first of them with 4 experts emptied, and a
    small ragged shape with empty experts: forward, input gradient and
    weight gradient against the plain versions (float32 within 1e-4, bf16
    within 2e-2; the weight gradient in both types also equal bit for bit
    across two calls; each bf16 call's route logged, and the bf16 bodies'
    registers, spills and plans, ``bf16_gemm_report``).  Then timed in both types at the gate/up shape and
    ``loads[0]`` (the weight gradient at the skewed load too,
    ``TIMED_LOADS``), beside the bound and one ``torch._grouped_mm`` call
    where the card's torch takes the type.  Inputs at the model's scales:
    x unit normal, w LeCun normal (as ``init_moe``), dy unit normal over
    sqrt(rows per expert), so that every sum is O(1) as in training (with
    unit weights a K = 2048 sum carries f32 rounding of ~1e-4 in any
    order)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gemm as mgk
    cfg = get_config(TRAIN_MODEL)
    N = TRAIN_BATCH * TRAIN_SEQ * cfg.experts_per_token
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    errs, rows = {"moe_gemm": 0.0, "moe_gemm_wgrad": 0.0}, []
    shapes = [(f"{proj} layer {i}", N, k, m, sizes)
              for i, sizes in enumerate(loads)
              for proj, k, m in (("gate/up", D, F), ("down", F, D))]
    shapes += [(f"{proj} layer 0, 4 experts emptied", N, k, m,
                with_empty_experts(np, loads[0]))
               for proj, k, m in (("gate/up", D, F), ("down", F, D))]
    shapes += [(f"{proj} {name} load", N, k, m, sizes)
               for name, sizes in (("off-tile-edge", off_tile_edges(np, N, E)),
                                   ("skewed", skewed(np, N, E)))
               for proj, k, m in (("gate/up", D, F), ("down", F, D))]
    shapes.append(("small", 77, 48, 130, np.array([30, 0, 0, 40, 0],
                                                  np.int32)))
    for label, n, k, m, sizes in shapes:
        gs = torch.from_numpy(sizes).cuda()
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = torch.randn((n, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((len(sizes), k, m), generator=gen,
                             device="cuda") * k ** -0.5).to(dtype)
            dy = (torch.randn((n, m), generator=gen, device="cuda")
                  * (len(sizes) / n) ** 0.5).to(dtype)
            what = f"moe_gemm {label} N={n} K={k} M={m} E={len(sizes)} " \
                   f"{dtype}"
            out = kops.moe_gemm(x, w, gs)
            e1 = close_or_raise(torch, what + " forward", out,
                                ref.moe_gemm(x, w, gs), tol)
            dx = kops.moe_gemm_dgrad(dy, w, gs)
            e2 = close_or_raise(torch, what + " dgrad", dx,
                                ref.moe_gemm(dy, w.transpose(1, 2), gs), tol)
            dw = kops.moe_gemm_wgrad(x, dy, gs)
            e3 = close_or_raise(torch, what + " wgrad", dw,
                                ref.moe_gemm_wgrad(x, dy, gs), tol)
            # float32: the chunks of an expert add into dw in a fixed
            # order; bf16: one block sums each dw tile
            if not torch.equal(dw, kops.moe_gemm_wgrad(x, dy, gs)):
                raise AssertionError(f"{what} wgrad: two calls on the "
                                     f"same inputs differ")
            log(f"kernel check {what} wgrad: two calls equal bit for bit")
            if dtype == torch.bfloat16:
                log(f"kernel route {what}: forward "
                    f"{mgk.kernel_route(x, w, out)}, dgrad "
                    f"{mgk.kernel_route(dy, w, dx)}, wgrad "
                    f"{mgk.kernel_route(x, dy, dw)}")
            del out, dx, dw
            if dtype == torch.float32:
                errs["moe_gemm"] = max(errs["moe_gemm"], e1, e2)
                errs["moe_gemm_wgrad"] = max(errs["moe_gemm_wgrad"], e3)
            timed = TIMED_LOADS.get(label)
            if timed is None:
                continue
            itemsize = x.element_size()
            fp32 = dtype == torch.float32
            offs = torch.cumsum(gs, 0, dtype=torch.int32)
            flops = 2.0 * int(sizes.sum()) * k * m
            # forward and dgrad read only the experts that have rows; wgrad
            # writes every expert's gradient
            busy = int((sizes > 0).sum())
            for kernel, call, plain, lib_args, nbytes in (
                    ("moe_gemm",
                     lambda: kops.moe_gemm(x, w, gs),
                     lambda: ref.moe_gemm(x, w, gs), (x, w),
                     (n * k + busy * k * m + n * m) * itemsize + (E + 1) * 4),
                    ("moe_gemm_dgrad",
                     lambda: kops.moe_gemm_dgrad(dy, w, gs),
                     lambda: ref.moe_gemm(dy, w.transpose(1, 2), gs),
                     (dy, w.transpose(1, 2)),
                     (n * m + busy * k * m + n * k) * itemsize + (E + 1) * 4),
                    ("moe_gemm_wgrad",
                     lambda: kops.moe_gemm_wgrad(x, dy, gs),
                     lambda: ref.moe_gemm_wgrad(x, dy, gs), (x.T, dy),
                     (n * k + n * m + E * k * m) * itemsize + (E + 1) * 4)):
                if kernel not in timed:
                    continue
                lib, why = library_grouped_mm(torch, *lib_args, offs)
                b_ms, b_by = bound_ms(nbytes, flops, fp32=fp32)
                rows.append(dict(
                    kernel=kernel, shape=f"N={n} K={k} M={m} E={E} "
                                         f"{str(dtype)[6:]}",
                    load=label, dtype=str(dtype)[6:], ms=time_ms(torch, call),
                    plain_ms=time_ms(torch, plain),
                    library_ms=None if lib is None else time_ms(torch, lib),
                    library_note=why, bound_ms=b_ms, bound_by=b_by))
            del x, w, dy
    for line in bf16_gemm_report(mgk, D, F, E):
        log(line)
    for r in rows:
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"none ({r['library_note']})")
        log(f"time {r['kernel']} {r['shape']} ({r['load']}): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, _grouped_mm "
            f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return errs, rows


# ---------------------------------------------------------------------------
# engine phases
# ---------------------------------------------------------------------------

def small_phase(torch, kops):
    """Float32 smoke models on the card against the CPU (plain versions):
    the same params, prompt and one decode step give the same logits.
    Returns the card pass's launches (the float32 decode kernels must
    have run)."""
    from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
    from repro_torch.core.control import StreamingPrefill
    from repro_torch.core.pools import build_pools
    from repro_torch.models.transformer import init_params

    models = {n: get_smoke_config(n).replace(dtype="float32")
              for n in PAPER_COLOC_SET}
    params = {}
    for i, (n, c) in enumerate(models.items()):
        gen = torch.Generator()
        gen.manual_seed(i)
        params[n] = init_params(gen, c)
    prompt = torch.randint(0, 256, (1, 37), generator=torch.Generator()
                           .manual_seed(7), dtype=torch.int32)
    logits, launches = {}, {}
    for device in ("cuda", "cpu"):
        reset_launches(kops)
        kv_pool, _, pooled = build_pools(
            models, dict(params), device=device, page_budget=128,
            page_bytes=4096, pool_dtype=torch.float32, slab_bytes=4096)
        virt = kv_pool.virtualizer
        for rid, name in enumerate(models):
            fns, p_kv = pooled[name].stage_fns, pooled[name].kv_params
            virt.register_request(rid, name, prompt.shape[1])

            def writer(layer, kv, pool, name=name, rid=rid):
                return virt.write_prompt_layer(pool, name, rid, layer, kv,
                                               prompt.shape[1])

            first, virt.pool = StreamingPrefill(pooled[name])(
                prompt.to(device), prompt.shape[1], virt.pool, writer)
            virt.reserve_decode_block(rid, 1)
            tables = virt.batch_tables(name, [rid], 4)
            arena, slots = pooled[name].arena.acquire(name)
            x = fns.embed(p_kv, first.argmax(-1).to(torch.int32))
            lens = torch.tensor([prompt.shape[1]], dtype=torch.int32,
                                device=device)
            for layer in range(fns.n_layers):
                x, ffn_in, virt.pool = fns.attn_stage(p_kv, x, virt.pool,
                                                      tables, lens, layer)
                x = fns.combine(x, fns.ffn_stage(arena, slots, ffn_in, layer))
            logits[(device, name)] = (first.cpu(), fns.logits(p_kv, x).cpu())
        if device == "cuda":
            launches = read_launches(kops)
    for kernel in ("paged_decode_attention", "paged_mla_decode_attention"):
        if not launches[kernel]:
            raise AssertionError(f"small: the float32 decode step never "
                                 f"launched {kernel}")
    log(f"small: float32 decode launches on the card: "
        f"paged_decode_attention {launches['paged_decode_attention']}, "
        f"paged_mla_decode_attention "
        f"{launches['paged_mla_decode_attention']}")
    for name in models:
        for phase, got, want in zip(("prefill", "decode"),
                                    logits[("cuda", name)],
                                    logits[("cpu", name)]):
            err = (got - want).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"{name} {phase} logits: card vs CPU "
                                     f"max abs err {err:.3g} > 1e-4")
            log(f"small {name} {phase}: card vs CPU logits max abs err "
                f"{err:.3g} (tolerance 1e-4)")
    return launches


def smoke_serve_phase(torch):
    """The serve CLI's default models, the smoke colocated set in bf16
    (head dim 8), and zamba2 + mamba2 smoke in bf16 through the engine
    on the card: every request gets its tokens, every page comes back, no
    logit is NaN, and the path's kernels launched."""
    from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
    from repro_torch.configs.base import EngineConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.request import Request

    for names, k, kernels in (
            (PAPER_COLOC_SET, SERVE_K, ("paged_decode_attention",
                                        "paged_mla_decode_attention")),
            (FALLBACK_MODELS, 1, ("flash_attention", "decode_attention",
                                  "ssd_scan"))):
        models = {n: get_smoke_config(n) for n in names}
        engine = CrossPoolEngine(
            models, page_budget=512, page_bytes=4096, slab_bytes=4096,
            max_batch=2, max_ctx=64, device="cuda",
            config=EngineConfig(mode=EngineMode(decode_steps_per_dispatch=k)))
        counts = {f: getattr(kops, f).launches for f in kernels}
        reqs = [Request(i, names[i % len(names)], 5 + 7 * i, 6, 0.0)
                for i in range(6)]
        for r in reqs:
            engine.submit(r)
        engine.drain()
        got = [len(r.output_ids) for r in reqs]
        bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
        idle = [f for f, n in counts.items() if getattr(kops, f).launches <= n]
        if got != [6] * 6 or engine.virt.mapped_pages or bad or idle:
            raise AssertionError(
                f"bf16 smoke serve of {names}: tokens {got}, "
                f"{engine.virt.mapped_pages} pages mapped, {bad} non-finite "
                f"logits, never launched: {idle}")
        log(f"small bf16 serve {', '.join(names)}: {len(reqs)} requests "
            f"of 6 tokens, dtypes "
            f"{sorted({c.dtype for c in models.values()})}, pages returned")


def fallback_small_phase(torch):
    """Float32 smoke zamba2 and mamba2 through the dense-cache path on the
    card (flash prefill, SSD scan, contiguous decode) against the CPU
    (plain versions): prefill and one decode step, logits within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import map_tree

    prompt = torch.randint(0, 256, (2, 48), generator=torch.Generator()
                           .manual_seed(7), dtype=torch.int32)
    nxt = torch.tensor([3, 250], dtype=torch.int32)
    lengths = torch.tensor([48, 30], dtype=torch.int32)
    for i, name in enumerate(FALLBACK_MODELS):
        model = build_model(get_smoke_config(name).replace(dtype="float32"))
        params = model.init(torch.Generator().manual_seed(i))
        out = {}
        for device in ("cuda", "cpu"):
            p = map_tree(lambda t: t.to(device, copy=True), params)
            cache = model.init_cache(2, 64, device)
            first, _ = model.prefill(p, prompt.to(device), cache,
                                     impl="flash", logit_index=40)
            step, _ = model.decode_step(p, nxt.to(device), cache,
                                        lengths.to(device), impl="paged")
            out[device] = (first.cpu(), step.cpu())
        for phase, got, want in zip(("prefill", "decode"), out["cuda"],
                                    out["cpu"]):
            err = (got - want).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"{name} {phase} logits: card vs CPU "
                                     f"max abs err {err:.3g} > 1e-4")
            log(f"small {name} {phase}: card vs CPU logits max abs err "
                f"{err:.3g} (tolerance 1e-4)")


def train_small_phase(torch):
    """One float32 smoke train step on the card against the CPU (plain
    versions): qwen3-moe on both MoE paths (the grouped one through the
    three grouped-GEMM kernels) and minicpm3 (MLA).  Loss, grad norm and
    updated params within 1e-4 of each leaf's scale, max(1, max|leaf|)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import TrainState, make_train_step
    from repro_torch.training.tree import leaves, map_tree

    for i, (name, moe_path) in enumerate((
            ("qwen3-moe-235b-a22b", "capacity"),
            ("qwen3-moe-235b-a22b", "grouped"), ("minicpm3-4b", "capacity"))):
        cfg = get_smoke_config(name).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(i))
        tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                               generator=torch.Generator().manual_seed(9))
        out = {}
        for device in ("cuda", "cpu"):
            # a copy each: the step updates the params in place
            p = map_tree(lambda t: t.to(device, copy=True), params)
            opt = AdamW(lr=3e-3, warmup_steps=10)
            step = make_train_step(model, opt, remat=False,
                                   extra_inputs=lambda b, m=moe_path: {
                                       "moe_path": m})
            state, metrics = step(TrainState(p, opt.init(p)),
                                  {"tokens": tokens.to(device)})
            out[device] = ([metrics["loss"], metrics["grad_norm"]]
                           + leaves(state.params))
        worst = 0.0
        for got, want in zip(out["cuda"], out["cpu"]):
            got, want = got.detach().cpu(), want.detach()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            if not err <= 1e-4 * scale:
                raise AssertionError(f"train {name} {moe_path}: card vs CPU "
                                     f"max abs err {err:.3g} > 1e-4 x scale "
                                     f"{scale:.3g}")
            worst = max(worst, err / scale)
        log(f"small train {name} {moe_path}: loss {float(out['cpu'][0]):.5f},"
            f" card vs CPU (loss, grad norm, {len(out['cpu']) - 2} updated "
            f"leaves) within {worst:.3g} of each leaf's scale "
            f"(tolerance 1e-4)")


class LoadRecorder:
    """Stands in for the kernel ops inside ``models.moe``: records the
    group sizes (the router's load) of every grouped-GEMM call and passes
    each call on unchanged, so the launch counts stay the kernels' own."""

    def __init__(self, kops):
        self.kops, self.sizes = kops, []

    def __getattr__(self, name):
        return getattr(self.kops, name)

    def moe_gemm(self, x, w, group_sizes):
        self.sizes.append(group_sizes)
        return self.kops.moe_gemm(x, w, group_sizes)


def train_phase(torch, np, kops):
    """Phase 7: moonshot at published widths, ``TRAIN_DEPTH`` layers,
    float32, ``AdamW(lr=3e-3, warmup_steps=10)`` as ``launch/train.py``,
    no remat, the grouped MoE path; ``TRAIN_STEPS`` steps on one fixed
    batch.  Returns (launches, figures, the last step's router load: one
    [E] int32 array per layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    from repro_torch.training.tree import leaves

    cfg = get_config(TRAIN_MODEL).replace(n_layers=TRAIN_DEPTH,
                                          dtype="float32")
    model = build_model(cfg)
    opt = AdamW(lr=3e-3, warmup_steps=10)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, opt,
                             torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in leaves(state.params))
    step = make_train_step(model, opt, remat=False,
                           extra_inputs=lambda b: {"moe_path": "grouped"})
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    batch = {"tokens": torch.from_numpy(next(data.batches())["tokens"])
             .cuda()}
    torch.cuda.synchronize()
    log(f"train: {TRAIN_MODEL} at published widths, {TRAIN_DEPTH} layers, "
        f"float32, {n_params / 1e9:.3f} B params, state built in "
        f"{time.perf_counter() - t0:.1f} s")
    # the main path's run: launch counts start at 0 here
    reset_launches(kops)
    losses, gnorms, times = [], [], []
    moe.kops = recorder = LoadRecorder(kops)
    try:
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))     # waits for the step
            gnorms.append(float(metrics["grad_norm"]))
            times.append(time.perf_counter() - t0)
            log(f"train step {i}: loss {losses[-1]:.5f} ce "
                f"{float(metrics['ce']):.5f} aux "
                f"{float(metrics['aux']):.5f} grad norm {gnorms[-1]:.4f}, "
                f"{times[-1] * 1e3:.1f} ms")
    finally:
        moe.kops = kops
    torch.cuda.synchronize()
    launches = read_launches(kops)
    # three grouped GEMMs per layer share one load; the last step's
    loads = [g.cpu().numpy() for g in
             recorder.sizes[-3 * TRAIN_DEPTH::3]]
    for i, sizes in enumerate(loads):
        log(f"train: router load of layer {i} in the last step (rows per "
            f"expert): {sizes.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"train: non-finite loss or grad norm "
                             f"{losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall on the fixed batch "
                             f"{losses}")
    want = {"moe_gemm": 6 * TRAIN_DEPTH * TRAIN_STEPS,
            "moe_gemm_wgrad": 3 * TRAIN_DEPTH * TRAIN_STEPS}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"train: {name} launched {launches[name]} "
                                 f"times, expected {n}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"train: launches {launches} (expected {want}); median step "
        f"after the first {steady * 1e3:.1f} ms = {tokens / steady:.0f} "
        f"tokens/s; max memory allocated {peak:.2f} GiB")
    figures = dict(model=TRAIN_MODEL, layers=TRAIN_DEPTH, params=n_params,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses,
                   grad_norms=gnorms, step_ms=[t * 1e3 for t in times],
                   median_step_ms=steady * 1e3, tokens_per_s=tokens / steady,
                   max_memory_gib=peak, loads=[s.tolist() for s in loads])
    figures["profile"] = profile_train_step(torch, step, state, batch)
    return launches, figures, loads


class PlainSSD:
    """Stands in for the kernel ops inside ``models.ssm``: the SSD scan's
    plain version (the chunked form, differentiated by autograd) on the
    same card, every other op passed on."""

    def __init__(self, kops):
        self.kops = kops

    def __getattr__(self, name):
        return getattr(self.kops, name)

    @staticmethod
    def ssd_scan(x, dt, A, B_, C_, *, chunk=64, h0=None):
        from repro_torch.kernels.ssd_chunked import ssd_scan_chunked
        return ssd_scan_chunked(x, dt, A, B_, C_, chunk=chunk, h0=h0)


def ssm_forwards(cfg, remat: bool) -> int:
    """``ssd_scan`` launches a train step: one a SSD block, and under
    remat one more for each block the checkpoint recomputes (every layer
    of the ssm family, the hybrid's grouped layers: its tail layers run
    outside a checkpoint, ``models/transformer.py`` ``forward``)."""
    if not remat:
        return cfg.n_ssm_layers
    recomputed = (cfg.n_layers if cfg.family == "ssm"
                  else cfg.hybrid_groups * cfg.ssm_per_group)
    return cfg.n_ssm_layers + recomputed


def ssm_train_phase(torch, kops, name, device="cuda", cfg=None):
    """Phases 7b / 7c: ``name`` at its full published config, float32,
    ``AdamW(lr=3e-3, warmup_steps=10)``, no remat, as ``launch/train.py``;
    ``TRAIN_STEPS`` steps on one fixed ``SSM_TRAIN_BATCH[name]`` x
    ``TRAIN_SEQ`` batch.  First the step's gradients on the kernel route
    against the plain route (``PlainSSD``, with remat to bound its
    memory) from the same params: each leaf within 1e-3 of its scale,
    max(1, max|plain|).  Then the steps: finite losses and grad norms,
    the last loss below the first, ``ssd_scan`` and ``ssd_scan_bwd``
    launched exactly once a SSM layer a step and no other kernel
    (attention trains through its plain version).  Returns figures.
    ``device="cpu"`` with a smoke ``cfg`` rehearses it (launch gates and
    memory are card-only)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.model import build_model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import (init_train_state,
                                                 make_grad_fn,
                                                 make_train_step)
    from repro_torch.training.tree import leaves, leaves_with_path

    cfg = cfg or get_config(name).replace(dtype="float32")
    card = torch.device(device).type == "cuda"
    model = build_model(cfg)
    opt = AdamW(lr=3e-3, warmup_steps=10)
    rows = SSM_TRAIN_BATCH[name]
    n_ssm = cfg.n_ssm_layers
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, opt,
                             torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in leaves(state.params))
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ, rows))
    batch = {"tokens": torch.from_numpy(next(data.batches())["tokens"])
             .to(device)}
    tag = f"train {name}"
    log(f"{tag}: full published config ({cfg.n_layers} layers, {n_ssm} SSM "
        f"blocks, d_model {cfg.d_model}), float32, {n_params / 1e9:.3f} B "
        f"params, batch {rows} x {TRAIN_SEQ}; state built in "
        f"{time.perf_counter() - t0:.1f} s")

    # the first step's gradients: kernel route, then the plain route
    t0 = time.perf_counter()
    _, g_kernel = make_grad_fn(model, remat=False)(state.params, batch)
    ssm.kops = PlainSSD(kops)
    try:
        _, g_plain = make_grad_fn(model, remat=True)(state.params, batch)
    finally:
        ssm.kops = kops
    worst, worst_leaf = 0.0, ""
    for (path, a), b in zip(leaves_with_path(g_kernel), leaves(g_plain)):
        leaf = "/".join(map(str, path))
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        if not (math.isfinite(err) and err <= 1e-3 * scale):
            raise AssertionError(f"{tag}: gradient {leaf} on the kernel "
                                 f"route parts from the plain route "
                                 f"({err:.3g} > 1e-3 x scale {scale:.3g})")
        if err / scale >= worst:
            worst, worst_leaf = err / scale, leaf
    log(f"{tag}: first step's gradients, kernel route against the plain "
        f"route, every leaf within {worst:.3g} of its scale ({worst_leaf}; "
        f"tolerance 1e-3) in {time.perf_counter() - t0:.1f} s")
    del g_kernel, g_plain
    gc.collect()
    if card:
        torch.cuda.empty_cache()

    step = make_train_step(model, opt, remat=False)
    # the main path's run: launch counts start at 0 here
    reset_launches(kops)
    losses, gnorms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        gnorms.append(float(metrics["grad_norm"]))
        times.append(time.perf_counter() - t0)
        log(f"{tag} step {i}: loss {losses[-1]:.5f} grad norm "
            f"{gnorms[-1]:.4f}, {times[-1] * 1e3:.1f} ms")
    sync(torch, device)
    launches = read_launches(kops)
    peak = torch.cuda.max_memory_allocated() / 2**30 if card else 0.0
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"{tag}: non-finite loss or grad norm {losses} "
                             f"{gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall on the fixed batch "
                             f"{losses}")
    want = {k: 0 for k in read_launches(kops)}
    want["ssd_scan"] = want["ssd_scan_bwd"] = n_ssm * TRAIN_STEPS
    if card and launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    tokens = rows * TRAIN_SEQ
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"{tag}: launches {launches} (expected: ssd_scan and ssd_scan_bwd "
        f"{n_ssm} a step); median step after the first {steady * 1e3:.1f} "
        f"ms = {tokens / steady:.0f} tokens/s; max memory allocated "
        f"{peak:.2f} GiB")
    figures = dict(model=name, layers=cfg.n_layers, ssm_layers=n_ssm,
                   params=n_params, batch=rows, seq=TRAIN_SEQ, losses=losses,
                   grad_norms=gnorms, step_ms=[t * 1e3 for t in times],
                   median_step_ms=steady * 1e3, tokens_per_s=tokens / steady,
                   max_memory_gib=peak, launches=launches,
                   grad_vs_plain=worst, grad_vs_plain_leaf=worst_leaf)
    if card:
        figures["profile"] = profile_train_step(torch, step, state, batch)
    return figures


def serve_phase(torch, np, kops, models, *, k, page_budget, label, check,
                lowering=True, pipeline=True, audit=False):
    """``CrossPoolEngine(device="cuda")`` over ``models`` (bf16): 8
    requests at time 0, prompts of 200-900 tokens, 32 new tokens each,
    ``max_batch=4``, ``max_ctx=1024``, ``k`` tokens per dispatch, in the
    given engine mode.  Launch counts are 0 just before the run and read
    just after it; each model's decode graph must have replayed once per
    block; ``check(launches, stats, engine)`` adds the phase's own checks.
    With ``audit`` (5a) the profiled decode step's roofline is held
    against its busy time (``decode_roofline``) and the engine's fused
    steps go through the graph audit (``graph_audit_phase``).  Returns
    (launches, figures)."""
    from repro_torch.configs.base import EngineConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import percentile
    from repro_torch.runtime.request import Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = CrossPoolEngine(
        models, page_budget=page_budget, max_batch=4, max_ctx=1024, seed=0,
        device="cuda",
        config=EngineConfig(mode=EngineMode(
            lowering=lowering, pipeline=pipeline,
            decode_steps_per_dispatch=k)))
    torch.cuda.synchronize()
    arena = (f"arena {engine.arena.device_bytes() / 2**30:.2f} GiB"
             if engine.arena is not None else "no arena")
    pool_mib = engine.virt.page_budget * engine.virt.page_bytes / 2**20
    pool = (f"pool {pool_mib:.0f} MiB" if engine.virt.pool is not None
            else "no device page pool")
    log(f"{label}: engine built in {time.perf_counter() - t0:.1f} s "
        f"(weights drawn on the card, {arena}, {pool})")
    rng = np.random.default_rng(0)
    names = list(models)
    reqs = [Request(i, names[i % len(names)], int(rng.integers(200, 901)),
                    SERVE_MAX_NEW, 0.0) for i in range(8)]
    # the main path's run: launch counts start at 0 here
    reset_launches(kops)
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    stats = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kops)
    for r in reqs:
        if r.generated != r.max_new_tokens or \
                len(r.output_ids) != r.max_new_tokens:
            raise AssertionError(f"request {r.request_id} ({r.model}) "
                                 f"emitted {len(r.output_ids)} of "
                                 f"{r.max_new_tokens} tokens")
    if engine.virt.mapped_pages != 0:
        raise AssertionError(f"{engine.virt.mapped_pages} pages still mapped")
    bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
    if bad:
        raise AssertionError(f"{bad} non-finite logits")
    graphs = graph_report(engine, stats, label)
    check(launches, stats, engine)
    schedule = {}
    if engine.scheduler is not None:
        schedule = dict(stages=len(engine.scheduler.stage_log),
                        overlap_fraction=engine.scheduler.overlap_fraction())
        log(f"{label}: the scheduler issued {schedule['stages']} stages, "
            f"overlap_fraction {schedule['overlap_fraction']:.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: {len(reqs)} requests, prompts "
        f"{[r.prompt_tokens for r in reqs]}, {stats.tokens_out} tokens in "
        f"{wall:.2f} s wall = {stats.tokens_out / wall:.1f} tokens/s")
    log(f"{label}: TBT p50 {percentile(stats.tbt, 50) * 1e3:.2f} ms, "
        f"p99 {percentile(stats.tbt, 99) * 1e3:.2f} ms; TTFT p50 "
        f"{percentile(stats.ttft, 50) * 1e3:.1f} ms")
    for model, B, bucket, dt in stats.prefill_times:
        log(f"{label}: prefill {model} B={B} bucket {bucket}: "
            f"{dt * 1e3:.1f} ms")
    log(f"{label}: launches {launches}; max memory allocated {peak:.2f} GiB")
    # read before the profiled step, which adds requests to the same stats
    figures = dict(
        tokens=stats.tokens_out, wall_s=wall,
        tokens_per_s=stats.tokens_out / wall,
        tbt_p50_ms=percentile(stats.tbt, 50) * 1e3,
        tbt_p99_ms=percentile(stats.tbt, 99) * 1e3,
        ttft_p50_ms=percentile(stats.ttft, 50) * 1e3,
        prefill=[dict(model=m, B=B, bucket=b, ms=dt * 1e3)
                 for m, B, b, dt in stats.prefill_times],
        max_memory_gib=peak, graphs=graphs, **schedule)
    t0 = time.perf_counter()
    figures["profile"] = profile_decode_step(torch, engine, names,
                                             engine.runners[names[0]]
                                             .decode_steps, roofline=audit)
    if audit:
        t1 = time.perf_counter()
        figures["audit"] = graph_audit_phase(torch, engine)
        figures["audit"]["seconds"] = time.perf_counter() - t1
        figures["phase_5a_s"] = (figures["profile"]["roofline"]["seconds"]
                                 + figures["audit"]["seconds"])
        log(f"{label}: profile, roofline and audit took "
            f"{time.perf_counter() - t0:.1f} s")
    return launches, figures


def replays_and_captures(runner):
    """(replays, captures) of a model's decode graphs, over every capture
    (an elastic move captures a split model's graph again)."""
    if runner.fused is not None:
        return runner.fused.replays, runner.fused.captures
    graph = runner.decode_graph
    return (graph.replays, 1) if graph is not None else (0, 0)


def graph_report(engine, stats, label) -> dict:
    """Per model: graph captures, replays, decode blocks and host
    dispatches per block; a model with a decode graph must have replayed
    it exactly once per block."""
    from repro_torch.core.control import dispatch_count
    out = {}
    for name, runner in engine.runners.items():
        blocks = len(stats.step_times[name])
        graph = runner.graph
        if graph is not None:
            replays, captures = replays_and_captures(runner)
            if replays != blocks:
                raise AssertionError(f"{name}: {replays} graph replays "
                                     f"for {blocks} decode blocks")
            row = dict(captures=captures, replays=replays, blocks=blocks,
                       host_dispatches_per_block=dispatch_count(
                           runner.cfg.n_layers, True),
                       launches_per_replay=graph.launches_per_replay)
        else:
            row = dict(captures=0, replays=0, blocks=blocks,
                       host_dispatches_per_block=dispatch_count(
                           runner.cfg.n_layers, False))
        out[name] = row
        log(f"{label}: {name}: {row['captures']} graph captures, "
            f"{row['replays']} replays for {blocks} decode blocks, "
            f"{row['host_dispatches_per_block']} host dispatches per block"
            + (f", kernel launches per replay {row['launches_per_replay']}"
               if graph is not None else ""))
    return out


def expected_split_launches(stats, engine, captures_before=None) -> dict:
    """What the split path must have launched: per layer of a model, one
    paged attention call (GQA or MLA) and one pool write per decoded token
    (K per replay, or one per host-driven step), and one pool write per
    prompt row of each prefill pass (a prefix-cache suffix pass writes
    its rows with one call too).  ``captures_before`` (model -> captures
    when the counts were set to 0): each capture since ran the body once
    eagerly, K more tokens' launches."""
    want = {"paged_decode_attention": 0, "paged_mla_decode_attention": 0,
            "paged_kv_write": 0}
    for name, runner in engine.runners.items():
        n_layers = runner.cfg.n_layers
        kernel = ("paged_mla_decode_attention" if runner.cfg.attention == "mla"
                  else "paged_decode_attention")
        if runner.graph is not None:
            replays, captures = replays_and_captures(runner)
            warm_ups = captures - (captures_before or {}).get(name, captures)
            tokens = (replays + warm_ups) * runner.decode_steps
        else:
            tokens = len(stats.step_times[name])
        rows = sum(B for m, B, *_ in stats.prefill_times if m == name)
        want[kernel] += n_layers * tokens
        want["paged_kv_write"] += n_layers * (tokens + rows)
    return want


def check_coloc(launches, stats, engine, captures_before=None) -> None:
    """Exact launch counts of the split path (``expected_split_launches``)
    over the three colocated models."""
    want = expected_split_launches(stats, engine, captures_before)
    for name, n in want.items():
        if launches[name] != n or n <= 0:
            raise AssertionError(f"{name} launched {launches[name]} times on "
                                 f"the split path, expected {n}")
    log(f"split path: launches exactly as expected: {want}")


def check_fallback(launches, stats, engine) -> None:
    """Each fallback kernel launched exactly as often as the path runs
    it: per zamba2 prompt one flash prefill per shared-attention group
    and one SSD scan per SSM layer (mamba2: per layer), per zamba2 decode
    step one contiguous decode per group."""
    cfgs = {r.cfg.name: r.cfg for r in engine.runners.values()}
    zamba, mamba = cfgs["zamba2-1.2b"], cfgs["mamba2-130m"]
    rows = {n: sum(B for m, B, *_ in stats.prefill_times if m == n)
            for n in cfgs}
    steps = len(stats.step_times["zamba2-1.2b"])
    want = {
        "flash_attention": zamba.hybrid_groups * rows["zamba2-1.2b"],
        "ssd_scan": (zamba.n_ssm_layers * rows["zamba2-1.2b"]
                     + mamba.n_layers * rows["mamba2-130m"]),
        "decode_attention": zamba.hybrid_groups * steps,
    }
    for name, n in want.items():
        if launches[name] != n or n <= 0:
            raise AssertionError(f"{name} launched {launches[name]} times on "
                                 f"the fallback path, expected {n}")
    log(f"serve fallback: launches as expected for {rows} prompt rows and "
        f"{steps} zamba2 decode steps: {want}")


def device_summary(prof, wall, label):
    """Device busy time, the 10 largest kernels and every kernel of the
    port (``csrc/``) of one profiled window."""
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: {label}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / (wall * 1e3):.1%})")

    def row(e):
        ms = e.self_device_time_total / 1e3
        return dict(kernel=e.key[:90], calls=e.count, ms=ms)
    top = [row(e) for e in sorted(kernels,
                                  key=lambda e: -e.self_device_time_total)]
    port = [r for r in top if any(n in r["kernel"] for n in PORT_KERNELS)]
    for r in top[:10]:
        log(f"profile: {r['ms']:9.3f} ms {r['calls']:5d}x  {r['kernel']}")
    for r in port:
        log(f"profile:   port {r['ms']:9.3f} ms {r['calls']:5d}x  "
            f"{r['kernel']}")
    shares = {}
    for what, tag in (("SSD scan", "ssd_"), ("paged MLA", "mla_")):
        ms = sum(r["ms"] for r in port if tag in r["kernel"])
        shares[what] = ms
        if ms:
            log(f"profile: {label}: {what} kernels {ms:.3f} ms = "
                f"{ms / busy_ms:.1%} of device busy time")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms, top=top[:10],
                port=port, ssd_ms=shares["SSD scan"],
                mla_ms=shares["paged MLA"])


def profile_decode_step(torch, engine, names, k, roofline=False):
    """Where the device time goes: 4 fresh requests (500 prompt tokens
    each) are submitted, then one engine step that prefills them (and
    decodes a first block) and one engine step that decodes a K-token
    block for every model run under ``torch.profiler``; with
    ``roofline`` the decode step's bound beside its times
    (``decode_roofline``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.request import Request

    reqs = [Request(100 + i, names[i % len(names)], 500, 2 * k + 1,
                    0.0) for i in range(4)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    out = {}
    for label in ("prefill step", "decode step"):
        if roofline:
            # the rows each model decodes in the profiled block, and their
            # context lengths as it starts
            active = {n: r.lengths[r._active_slots()].copy()
                      for n, r in engine.runners.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[label] = device_summary(
            prof, wall, f"one {label} (K={k}, {len(names)} models)")
    if roofline:
        out["roofline"] = decode_roofline(torch, engine, active, k,
                                          out["decode step"])
    engine.drain()
    if engine.virt.mapped_pages != 0:
        raise AssertionError("pages still mapped after the profiled run")
    return out


def decode_token_bytes(cfg, shape) -> float:
    """The least bytes one decode token of ``shape``'s rows reads and
    writes on one card: ``analytic_bytes_estimate`` (every active weight,
    the KV of the context, the state), less the input embedding table,
    of which a step reads only its rows' own (a tied table is the head
    too, and is read whole)."""
    from repro_torch.launch import roofline as rf

    out = rf.analytic_bytes_estimate(cfg, shape, 1)
    if not cfg.tie_embeddings:
        out += (shape.global_batch - cfg.vocab_size) * cfg.d_model * 2
    return out


def decode_roofline(torch, engine, active, k, summary) -> dict:
    """(5a) The roofline of the profiled decode step on the H100's peaks
    (``launch/roofline.py``, ``launch/mesh.py``).  For each model: its
    block's FLOPs counted on ``meta`` (``op_analysis.analyze_fused_step``
    at the captured graph's shapes: K tokens, every layer, the plain
    paged attention over the whole table) and K times one token's
    minimum bytes (``decode_token_bytes``; the weights, far larger than
    the L2, are read again at every inner step).  The models' blocks
    run one after another on one card, so the step's bound is the larger
    of the summed compute and memory terms.  Gated: the bound is at most
    the step's device busy time (a bound above a measured time means the
    count is wrong)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.op_analysis import analyze_fused_step

    t0 = time.perf_counter()
    rows, t_compute, t_memory = {}, 0.0, 0.0
    for name, lens in active.items():
        if not len(lens):
            continue
        runner = engine.runners[name]
        stats = analyze_fused_step(runner.fused, engine.virt.pool,
                                   batch=runner.max_batch,
                                   max_pages=runner.max_pages)
        shape = ShapeConfig(f"decode block K={k}", int(lens.mean()),
                            len(lens), "decode")
        report = rf.RooflineReport(
            arch=name, shape=shape.name, mesh="one card",
            strategy="split engine", chips=1, flops_per_device=stats.flops,
            bytes_per_device=stats.bytes_accessed,
            bytes_model=k * decode_token_bytes(runner.cfg, shape),
            collective_per_device=0.0, collective_breakdown={},
            model_flops=k * rf.model_flops_estimate(runner.cfg, shape))
        rows[name] = dict(report.to_dict(), rows=len(lens),
                          mean_context=float(lens.mean()),
                          bound_ms=report.bound_time * 1e3,
                          temp_bytes=stats.temp_bytes)
        t_compute += report.t_compute
        t_memory += report.t_memory
        log(f"roofline: {name} block of {k} x {len(lens)} rows at context "
            f"{float(lens.mean()):.1f}: {stats.flops:.4e} FLOPs, "
            f"{report.bytes_model:.4e} B minimum ({stats.bytes_accessed:.4e}"
            f" B accessed unfused): compute {report.t_compute * 1e3:.4f} ms"
            f", memory {report.t_memory * 1e3:.4f} ms (unfused "
            f"{report.t_memory_hlo * 1e3:.4f}) -> {report.dominant}")
    bound = max(t_compute, t_memory) * 1e3
    busy, wall = summary["device_busy_ms"], summary["wall_ms"]
    log(f"roofline: the decode step's bound {bound:.4f} ms (compute "
        f"{t_compute * 1e3:.4f}, memory {t_memory * 1e3:.4f}) against "
        f"device busy {busy:.3f} ms and wall {wall:.3f} ms: "
        f"{bound / busy:.2%} of busy, {bound / wall:.2%} of wall")
    if not 0 < bound <= busy:
        raise AssertionError(f"the decode step's bound {bound:.4f} ms is "
                             f"not within its busy time {busy:.3f} ms: "
                             f"the count is wrong")
    return dict(models=rows, bound_ms=bound,
                t_compute_ms=t_compute * 1e3, t_memory_ms=t_memory * 1e3,
                busy_ms=busy, wall_ms=wall, share_of_busy=bound / busy,
                share_of_wall=bound / wall,
                seconds=time.perf_counter() - t0)


def graph_audit_phase(torch, engine) -> dict:
    """(5a) The graph audit (``analysis/graph_audit.py``) over phase 5's
    engine: each model's fused step, at its captured graph's batch and
    table width on inactive inputs, under
    ``set_sync_debug_mode("error")``, must give no finding; its figures
    are printed.  Then two planted bodies on the first model, one that
    reads a token to the host (CPA03) and one that clones the pool
    (CPA02), must each be flagged on the card."""
    from repro_torch.analysis import graph_audit as ga

    pool, out = engine.virt.pool, {}
    for name, runner in engine.runners.items():
        found, fig = ga.audit_fused_step(
            runner.fused, pool, batch=runner.max_batch,
            max_pages=runner.max_pages, target=name)
        log(f"audit: {name}: largest foreign read {fig['largest_foreign_read']}"
            f" B ({fig['foreign_reads']} foreign storages); the body's "
            f"largest allocation {fig['largest_allocation'] / 2**20:.1f} MiB"
            f", its own peak {fig['own_peak_bytes'] / 2**20:.1f} MiB, beside"
            f" the pool's {fig['pool_bytes'] / 2**20:.1f} MiB and the "
            f"arena's {fig['arena_bytes'] / 2**20:.1f} MiB; host reads "
            f"{fig['host_reads']}; {fig['dispatches_per_block']} dispatch a"
            f" block; calls per body {fig['calls_per_body']}, per replay "
            f"{fig['calls_per_replay']}, claim {fig['claim']}")
        if found:
            raise AssertionError(f"audit: {name}: "
                                 + "; ".join(str(f) for f in found))
        out[name] = fig
    name, runner = next(iter(engine.runners.items()))
    step, batch, max_pages = runner.fused, runner.max_batch, runner.max_pages
    if step.graph is not None:
        _, batch, max_pages = step.graph.static["page_tables"].shape
    planted = {}
    for check in ("CPA03", "CPA02"):
        found, _ = ga.audit_fused_step(
            ga.planted(step, check), pool, batch=batch, max_pages=max_pages,
            target=f"{name} planted {check}")
        got = sorted({f.check for f in found})
        if check not in got:
            raise AssertionError(f"audit: the planted {check} body was not "
                                 f"flagged ({got})")
        planted[check] = [str(f) for f in found]
        log(f"audit: planted {check} flagged: {planted[check]}")
    return dict(models=out, planted=planted)


def profile_train_step(torch, step, state, batch):
    """Where one train step's device time goes, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_summary(prof, wall, "one train step")


# ---------------------------------------------------------------------------
# the pool write and the decode graphs
# ---------------------------------------------------------------------------

def kv_write_phase(torch, kops, ref):
    """The pool write kernel against its plain version (bit for bit: it
    moves bytes), on rows with page ids below 0 and past the pool, rows
    cast from float32 to a bf16 pool, an odd row width (2-byte stores) and
    a prefill-sized batch; sync-free under ``set_sync_debug_mode("error")``;
    timed at the serve decode block's shape (qwen3-moe: 4 rows of 2 x 4 x
    128 bf16 into 16 KiB pages) and at a 512-token prompt's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def inputs(n_pages, page_elems, n, e, dtype, row_dtype, drop=()):
        pool = torch.randn((n_pages, page_elems), generator=gen,
                           device="cuda").to(dtype)
        rows = torch.randn((n, e), generator=gen, device="cuda").to(row_dtype)
        # distinct (page, slot) targets: two rows on one slot would race
        # in the kernel and in the plain version's scatter alike
        tpp = page_elems // e
        flat = torch.randperm(n_pages * tpp, generator=gen,
                              device="cuda")[:n].to(torch.int32)
        pages, slots = flat // tpp, flat % tpp
        for i, p in drop:
            pages[i] = p
        return pool, rows, pages, slots

    def same(what, pool, rows, pages, slots, plain_pages=None):
        want = ref.paged_kv_write(pool.clone(), rows, plain_pages
                                  if plain_pages is not None else pages,
                                  slots)
        got = kops.paged_kv_write(pool.clone(), rows, pages, slots)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"pool write {what}: kernel differs from "
                                 f"the plain version")
        log(f"kernel check paged_kv_write {what}: equal to the plain version")

    same("qwen3-moe decode B=4, -1 pages", *inputs(
        64, 8192, 4, 1024, torch.bfloat16, torch.bfloat16,
        drop=((1, -1), (3, -1))))
    same("minicpm3 decode B=4, f32 rows into bf16", *inputs(
        64, 8192, 4, 288, torch.bfloat16, torch.float32, drop=((0, -1),)))
    pool, rows, pages, slots = inputs(64, 8192, 6, 21, torch.float32,
                                      torch.float32, drop=((2, -3),))
    dropped = pages.clone()
    pages[4] = 64                  # past the pool: dropped, as mode="drop"
    dropped[4] = -1
    same("odd width, an id past the pool", pool, rows, pages, slots,
         plain_pages=dropped)
    same("prefill 512 rows", *inputs(4096, 8192, 512, 1024, torch.bfloat16,
                                     torch.bfloat16))
    pool, rows, pages, slots = inputs(64, 8192, 4, 1024, torch.bfloat16,
                                      torch.bfloat16, drop=((1, -1),))
    kops.paged_kv_write(pool, rows, pages, slots)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kops.paged_kv_write(pool, rows, pages, slots)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("kernel check paged_kv_write: no host read under "
        "set_sync_debug_mode('error') at a batch with -1 pages")
    rows_out = []
    for label, n in (("qwen3-moe decode B=4", 4), ("prefill 512 rows", 512)):
        pool, rows, pages, slots = inputs(16384, 8192, n, 1024,
                                          torch.bfloat16, torch.bfloat16)
        ms = time_ms(torch, lambda: kops.paged_kv_write(pool, rows, pages,
                                                        slots))
        plain = time_ms(torch, lambda: ref.paged_kv_write(pool, rows, pages,
                                                          slots))
        b_ms, b_by = bound_ms(2 * n * 1024 * 2 + 8 * n, 0)
        rows_out.append(dict(kernel="paged_kv_write", shape=label, ms=ms,
                             plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))
        log(f"time paged_kv_write {label}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}); no one PyTorch "
            f"call drops rows")
    return rows_out


def smoke_engine(torch, names, dtype, k=1, lowering=True, pipeline=True,
                 steps=1):
    """Smoke configs of ``names`` in ``dtype`` served on the card: 4
    requests at time 0 (prompts 5-26 tokens, 6 new tokens each, given
    ids), ``steps`` engine steps taken (prefill and first blocks)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import EngineConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.request import Request

    models = {n: get_smoke_config(n).replace(dtype=dtype) for n in names}
    params = {n: init_params(torch.Generator().manual_seed(i), c)
              for i, (n, c) in enumerate(models.items())}
    engine = CrossPoolEngine(
        models, page_budget=512, page_bytes=4096, slab_bytes=4096,
        max_batch=2, max_ctx=64, params=params, device="cuda",
        config=EngineConfig(mode=EngineMode(
            lowering=lowering, pipeline=pipeline,
            decode_steps_per_dispatch=k)))
    reqs = [Request(i, names[i % len(names)], 5 + 7 * i, 6, 0.0,
                    prompt_ids=list(range(3 + i, 8 + 8 * i)))
            for i in range(4)]
    for r in reqs:
        engine.submit(r)
    for _ in range(steps):
        engine.step()
    return engine, reqs


def replay_matches_eager(torch, engine) -> None:
    """For every model with requests in flight: its next decode block as
    one graph replay, then the decode body called eagerly from the same
    state (the pool, or the dense cache, put back first): the same tokens
    and the same pool or cache bytes.  Leaves the engine mid-block: build
    another to serve on."""
    import numpy as np

    def dev(a):
        return torch.tensor(a, device="cuda")

    for name, runner in engine.runners.items():
        if not runner.active:
            continue
        if runner.paged:
            act, steps = runner._reserve_decode_block()
            tables = engine.virt.batch_tables_host(
                name, runner._rids(), runner.max_pages).copy()
            args = (runner.next_tokens.copy(), tables, runner.lengths.copy(),
                    steps, runner._eos_ids())
            state = {"pool": engine.virt.pool}
            before = {"pool": engine.virt.pool.clone()}
            toks, _ = runner.fused(args[0], engine.virt.pool, *args[1:])
        else:
            active = np.zeros(runner.max_batch, bool)
            active[runner._active_slots()] = True
            args = (runner.next_tokens.copy(), runner.lengths.copy(), active)
            state = runner.cache
            before = {k: v.clone() for k, v in state.items()}
            toks = runner.decode_graph(tokens=args[0], lengths=args[1],
                                       active=args[2])
        got = toks.clone()
        got_state = {k: v.clone() for k, v in state.items()}
        for k, v in state.items():
            v.copy_(before[k])
        if runner.paged:
            arena, table = runner.fused.pooled.arena.acquire(name)
            want = runner.fused.body(engine.virt.pool, arena, table,
                                     *[dev(a) for a in args])
        else:
            want = runner.decode_body(*[dev(a) for a in args])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the graph replay's tokens "
                                 f"{got.tolist()} differ from the eager "
                                 f"body's {want.tolist()}")
        bad = [k for k, v in state.items() if not torch.equal(got_state[k],
                                                              v)]
        if bad:
            raise AssertionError(f"{name}: the graph replay and the eager "
                                 f"body leave different {bad} bytes")


def block_is_sync_free(torch, engine) -> None:
    """One decode block of every model with requests in flight, from the
    copy-in to the replay, under ``set_sync_debug_mode("error")``; the
    read-back comes after.  Leaves the engine mid-block."""
    pending = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for runner in engine.runners.values():
            if runner.active:
                pending.append(runner.issue_decode())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not pending:
        raise AssertionError("no model had a block to dispatch")


def graph_phase(torch):
    """The decode graphs on the smoke models: a replay equals the eager
    body (coloc set in float32 and bf16 at K = 1 and 4; zamba2 + mamba2 in
    both dtypes), a block dispatch makes no host read (coloc bf16 at K = 4
    and the fallback pair), and a graph survives an evict and re-activate
    of its model."""
    from repro_torch.configs import PAPER_COLOC_SET
    for names, ks in ((PAPER_COLOC_SET, (1, 4)), (FALLBACK_MODELS, (1,))):
        for dtype in ("float32", "bfloat16"):
            for k in ks:
                engine, _ = smoke_engine(torch, names, dtype, k)
                replay_matches_eager(torch, engine)
                state = "pool" if names == PAPER_COLOC_SET else "dense cache"
                log(f"graph check {', '.join(names)} {dtype} K={k}: the "
                    f"replay equals the eager body (tokens, {state} bytes)")
                del engine
        engine, _ = smoke_engine(torch, names, "bfloat16", max(ks))
        block_is_sync_free(torch, engine)
        log(f"graph check {', '.join(names)} bf16 K={max(ks)}: a block "
            f"dispatch makes no host read under "
            f"set_sync_debug_mode('error')")
        del engine
    evict_check(torch)
    moved_graph_check(torch)


def moved_graph_check(torch) -> None:
    """A decode graph over a pool or an arena that a resize moved: its
    replay raises until ``recapture`` captures it anew, and then a replay
    equals the eager body (smoke coloc set, float32, K = 4).  First, at
    the captured address: a pool of another size there (a view one page
    shorter) raises too, and the captured buffer under another tensor
    object (a view of equal shape) replays and equals the eager body."""
    from repro_torch.configs import PAPER_COLOC_SET
    engine, _ = smoke_engine(torch, PAPER_COLOC_SET, "float32", 4)

    def refused(what):
        runner = next(r for r in engine.runners.values() if r.active)
        try:
            runner.issue_decode()
        except RuntimeError as e:
            if "moved or changed shape" not in str(e):
                raise
        else:
            raise AssertionError(f"a replay over {what} did not raise")

    pool = engine.virt.pool
    engine.virt.pool = pool[:-1]
    refused("a shorter pool at the captured address")
    engine.virt.pool = pool.view(pool.shape)
    if any(r.fused.recapture(engine.virt.pool)
           for r in engine.runners.values()):
        raise AssertionError("an equal view of the captured pool was "
                             "captured again")
    replay_matches_eager(torch, engine)
    log("graph check: at the captured address a shorter pool raises, and "
        "an equal view of the captured pool replays and equals the eager "
        "body")
    for what, resize in (
            ("pool", lambda: engine.virt.resize(engine.virt.page_budget + 64)),
            ("arena", lambda: engine.arena.resize(
                engine.arena.slot_budget + 4))):
        resize()
        refused(f"the moved {what}")
        for r in engine.runners.values():
            if not r.fused.recapture(engine.virt.pool):
                raise AssertionError(f"{r.name}: no new capture after the "
                                     f"{what} moved")
        replay_matches_eager(torch, engine)
        log(f"graph check: after the {what} moved a replay raises, and once "
            f"captured again it equals the eager body")


def evict_check(torch) -> list:
    """A graph survives its model's evict and re-activate: the same request
    served again after the model came back on other slabs gives the same
    tokens, and a replay there still equals the eager body."""
    import numpy as np
    from repro_torch.configs import PAPER_COLOC_SET
    from repro_torch.runtime.request import Request
    name = PAPER_COLOC_SET[0]
    engine, reqs = smoke_engine(torch, PAPER_COLOC_SET, "float32", 4,
                                steps=0)
    engine.drain()
    first = [r.output_ids for r in reqs]
    arena = engine.arena
    old = arena.residency[name].slots.copy()
    arena.evict(name)
    again = [Request(10 + r.request_id, r.model, r.prompt_tokens,
                     r.max_new_tokens, 0.0, prompt_ids=r.prompt_ids)
             for r in reqs]
    for r in again:
        engine.submit(r)
    engine.drain()
    new = arena.residency[name].slots
    if np.array_equal(old, new):
        raise AssertionError(f"{name} came back on the same slabs")
    if [r.output_ids for r in again] != first:
        raise AssertionError(f"{name}: after evict and re-activate the "
                             f"graph serves other tokens")
    for r in again[:2]:
        engine.submit(Request(20 + r.request_id, r.model, r.prompt_tokens,
                              r.max_new_tokens, 0.0, prompt_ids=r.prompt_ids))
    engine.step()
    replay_matches_eager(torch, engine)
    log(f"graph check {name}: evicted and re-activated on other slabs, the "
        f"same tokens {first[0]}, and a replay equals the eager body")
    return first


# ---------------------------------------------------------------------------
# phase 9: the elastic boundary
# ---------------------------------------------------------------------------

def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_resizes(torch, engine, moves: list) -> dict:
    """Wrap the engine's pool and arena ``resize`` (what the rebalancer
    calls) to log (pool, grow or shrink, old, new, ms, result) of each,
    the device synchronised around it; wrap the rebalancer's ``step`` to
    count the steps after which the pool or the arena had moved, in the
    returned dict's ``moved_steps``."""
    def wrap(owner, attr, pool_name):
        fn = getattr(owner, pool_name)

        def call(new_budget, **kw):
            old = getattr(owner, attr)
            sync(torch, engine.device)
            t0 = time.perf_counter()
            out = fn(new_budget, **kw)
            sync(torch, engine.device)
            moves.append(dict(pool=attr, kind="grow" if new_budget > old
                              else "shrink", old=old, new=int(new_budget),
                              ms=(time.perf_counter() - t0) * 1e3,
                              result=out))
            return out
        setattr(owner, pool_name, call)

    wrap(engine.virt, "page_budget", "resize")
    wrap(engine.arena, "slot_budget", "resize")
    step = engine.rebalancer.step

    state = dict(moved_steps=0)

    def counted(*args, **kw):
        before = (engine.virt.pool.data_ptr(), engine.arena.arena.data_ptr())
        out = step(*args, **kw)
        if (engine.virt.pool.data_ptr(),
                engine.arena.arena.data_ptr()) != before:
            state["moved_steps"] += 1
        return out
    engine.rebalancer.step = counted
    return state


def elastic_requests(np, models):
    """The burst (8 minicpm3 requests, prompts of 1500-3000 tokens) and
    the tail (2 qwen3-moe, 2 moonshot, 130-200 tokens), 32 new tokens
    each, every prompt's ids given (an engine draws synthetic ids in the
    order it plans prefills, which differs between the two engines).
    The tail fits the frozen engine's 1024 pages at once (a moonshot
    page holds 2 tokens of a layer: ~370 pages a request) and one prompt
    bucket, so on both engines each MoE model prefills and decodes its
    two requests together: an MoE model's tokens depend on what else is
    in its batch (expert capacity)."""
    from repro_torch.runtime.request import Request
    rng = np.random.default_rng(9)
    others = [n for n in models if n != BURST_MODEL]

    def req(i, name, lo, hi):
        n = int(rng.integers(lo, hi + 1))
        return Request(i, name, n, SERVE_MAX_NEW, 0.0, prompt_ids=rng.integers(
            0, models[name].vocab_size, n).astype(np.int32))
    burst = [req(i, BURST_MODEL, 1500, 3000) for i in range(8)]
    tail = [req(100 + i, others[i // 2], 130, 200) for i in range(4)]
    return burst, tail


def serve_elastic(torch, np, kops, models, elastic, device):
    """One engine (``elastic`` or frozen) serves the burst, then the tail;
    returns its figures, the requests and the engine."""
    from repro_torch.configs.base import ElasticConfig, EngineConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import percentile
    label = "elastic" if elastic else "frozen"
    engine = CrossPoolEngine(
        models, page_budget=ELASTIC_PAGES, max_batch=4, max_ctx=ELASTIC_CTX,
        seed=0, device=device, config=EngineConfig(
            mode=EngineMode(decode_steps_per_dispatch=SERVE_K),
            elastic=ElasticConfig(**ELASTIC) if elastic else None))
    moves: list = []
    state = timed_resizes(torch, engine, moves) if elastic else None
    burst, tail = elastic_requests(np, models)
    captures = {n: replays_and_captures(r)[1]
                for n, r in engine.runners.items()}
    sync(torch, device)
    reset_launches(kops)
    t0 = time.perf_counter()
    for r in burst:
        engine.submit(r)
    stats = engine.drain()
    sync(torch, device)
    wall = time.perf_counter() - t0
    ttft = percentile(stats.ttft, 50) * 1e3
    burst_tokens = stats.tokens_out
    for r in tail:
        engine.submit(r)
    stats = engine.drain()
    sync(torch, device)
    launches = read_launches(kops)
    for r in burst + tail:
        if r.generated != r.max_new_tokens or \
                len(r.output_ids) != r.max_new_tokens:
            raise AssertionError(f"{label}: request {r.request_id} "
                                 f"({r.model}) emitted {len(r.output_ids)} "
                                 f"of {r.max_new_tokens} tokens")
    if engine.virt.mapped_pages or engine.virt.swapped_now:
        raise AssertionError(f"{label}: {engine.virt.mapped_pages} pages "
                             f"still mapped, {engine.virt.swapped_now} "
                             f"swapped")
    bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
    if bad:
        raise AssertionError(f"{label}: {bad} non-finite logits")
    figures = dict(burst_tokens=burst_tokens, burst_wall_s=wall,
                   burst_tokens_per_s=burst_tokens / wall,
                   burst_ttft_p50_ms=ttft, page_budget=engine.virt.page_budget,
                   slot_budget=engine.arena.slot_budget)
    if engine.device.type == "cuda":
        graph_report(engine, stats, f"elastic {label}")
        check_coloc(launches, stats, engine, captures)
        figures["launches"] = launches
    log(f"elastic {label}: burst of {len(burst)} {BURST_MODEL} requests "
        f"(prompts {[r.prompt_tokens for r in burst]}): {burst_tokens} "
        f"tokens in {wall:.2f} s = {burst_tokens / wall:.1f} tokens/s, "
        f"TTFT p50 {ttft:.1f} ms; then {len(tail)} requests of "
        f"{', '.join(sorted({r.model for r in tail}))}; pages "
        f"{ELASTIC_PAGES} -> {engine.virt.page_budget}")
    if elastic:
        figures.update(elastic_moves(engine, stats, moves, captures,
                                     state["moved_steps"]))
        # what a capture pays before it starts: one full collection
        # (``DecodeGraph``) on the heap the serving process has here
        t1 = time.perf_counter()
        gc.collect()
        figures["gc_collect_ms"] = (time.perf_counter() - t1) * 1e3
        log(f"elastic: one gc.collect() here takes "
            f"{figures['gc_collect_ms']:.1f} ms")
    return figures, burst + tail, engine


def elastic_moves(engine, stats, moves, captures, moved_steps) -> dict:
    """The elastic engine's gates: a KV grow, bytes conserved on every
    move, one new capture of every split model's graph per step that
    moved the pool or the arena (``captures``: before the run)."""
    events = stats.rebalance_events
    if not any(e.kv_delta_bytes > 0 for e in events):
        raise AssertionError("elastic: the burst never grew the KV pool")
    total = engine.rebalancer.total_bytes
    for e in events:
        got = (e.page_budget[1] * engine.virt.page_bytes
               + e.slot_budget[1] * engine.arena.slab_bytes)
        if got > total:
            raise AssertionError(f"elastic: move at step {e.step} holds "
                                 f"{got} B of a {total} B budget")
    recaptures = {}
    for name, runner in engine.runners.items():
        if runner.fused is None:
            continue
        new = runner.fused.captures - captures[name]
        if engine.device.type == "cuda" and new != moved_steps:
            raise AssertionError(f"elastic: {name} captured {new} times for "
                                 f"{moved_steps} moves")
        recaptures[name] = [t * 1e3 for t in runner.fused.capture_s[-new:]] \
            if new else []
    out = dict(moves=len(events), moved_steps=moved_steps,
               aborted=engine.rebalancer.aborted,
               events=[dict(step=e.step, page_budget=e.page_budget,
                            slot_budget=e.slot_budget,
                            swapped_out=e.swapped_out,
                            evicted_models=e.evicted_models, reason=e.reason)
                       for e in events],
               resizes=[{k: v for k, v in m.items() if k != "result"}
                        for m in moves], recapture_ms=recaptures)
    for pool, kind in (("page_budget", "grow"), ("page_budget", "shrink"),
                       ("slot_budget", "shrink"), ("slot_budget", "grow")):
        ms = [m["ms"] for m in moves if m["pool"] == pool
              and m["kind"] == kind]
        what = ("pool " if pool == "page_budget" else "arena ") + kind
        out[what.replace(" ", "_") + "_ms"] = ms
        if ms:
            log(f"elastic: {len(ms)} {what}s, ms each "
                f"{[round(t, 3) for t in ms]}")
    log(f"elastic: {len(events)} moves applied ({moved_steps} steps "
        f"moved a buffer, {engine.rebalancer.aborted} aborted); "
        f"{[(e.page_budget, e.slot_budget, e.reason) for e in events]}")
    for name, ms in recaptures.items():
        log(f"elastic: {name} decode graph captured again {len(ms)} times, "
            f"ms each {[round(t, 1) for t in ms]}")
    return out


def after_moves_check(torch, np, engine) -> None:
    """On the elastic engine, after its moves: two more minicpm3 requests
    take a step, a block dispatch makes no host read, and a replay
    equals the eager body."""
    from repro_torch.runtime.request import Request
    rng = np.random.default_rng(4)
    vocab = engine.models[BURST_MODEL].vocab_size
    for i in range(2):
        engine.submit(Request(200 + i, BURST_MODEL, 300 + 50 * i,
                              SERVE_MAX_NEW, 0.0, prompt_ids=rng.integers(
                                  0, vocab, 300 + 50 * i).astype(np.int32)))
    engine.step()
    block_is_sync_free(torch, engine)
    replay_matches_eager(torch, engine)
    log("elastic: after the moves a block dispatch makes no host read and a "
        "replay equals the eager body")


def forced_cycle(torch, np, cfg, lowering: bool, device,
                 sanitize: bool = False) -> dict:
    """minicpm3 alone: 4 requests of 2000 tokens prefilled, 6 greedy decode
    steps of ``PagedFusedStep`` (lowering on: one replay each on a card)
    or ``HostDrivenStep`` (off: FFN stages on a second stream).  The
    perturbed run, before step 2: a shrink to half the mapped pages
    (swapping the longest-idle requests' coldest pages, compacting the
    rest), a swap-out of everything left, a grow back and the fault-in.
    Every step's logits must equal the unperturbed run's bit for bit, and
    with lowering on a replay over the moved pool must raise until the
    graph is released.  With ``sanitize`` a ``PoolSanitizer`` rides the
    virtualizer's hooks and audits after every step and every move.
    Returns the cycle's times."""
    from repro_torch.core.control import (HostDrivenStep, PagedFusedStep,
                                          StreamingPrefill)
    from repro_torch.core.pools import build_pools
    from repro_torch.core.virtualizer import KVVirtualizer
    from repro_torch.models.transformer import init_params
    name, B, S, steps, cycle_at, budget = cfg.name, 4, 2000, 6, 2, 4096
    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(7)
    _, _, pooled = build_pools({name: cfg}, {name: init_params(gen, cfg)},
                               device=device, page_budget=8,
                               pool_dtype=torch.bfloat16)
    w_stream = torch.cuda.Stream() if on_card and not lowering else None
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device, dtype=torch.int32)
    times: dict = {}
    audited: dict = {}

    def timed(what, fn, nbytes=None):
        sync(torch, device)
        t0 = time.perf_counter()
        out = fn()
        sync(torch, device)
        ms = (time.perf_counter() - t0) * 1e3
        times[what] = dict(ms=ms)
        if nbytes is not None:
            times[what].update(bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
        return out

    def run(perturb):
        virt = KVVirtualizer({name: cfg}, page_budget=budget, device=device)
        audit = None
        if sanitize:
            from repro_torch.analysis.sanitizer import PoolSanitizer
            virt.hooks = PoolSanitizer(virt)
            audit = virt.hooks.audit
        view = virt.views[name]
        max_pages = -(-(S + steps) // view.tokens_per_page)
        for b in range(B):
            virt.register_request(b, name, S)

        def writer(layer, layer_kv, pool):
            for b in range(B):
                pool = virt.write_prompt_layer(pool, name, b, layer,
                                               layer_kv, S, batch_index=b)
            return pool
        logits, virt.pool = StreamingPrefill(pooled[name], w_stream)(
            prompts, S, virt.pool, writer)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        step = (PagedFusedStep(pooled[name]) if lowering
                else HostDrivenStep(pooled[name], w_stream))
        out = []
        for t in range(steps):
            if perturb and t == cycle_at:
                page = virt.page_bytes
                # the captured pool stays allocated through the cycle:
                # freed, the caching allocator may hand its address back
                # to the regrown pool, of the captured size, and a replay
                # there is valid, not stale (``moved_graph_check`` holds
                # both cases at one address)
                captured = virt.pool
                r = timed("pool shrink with compaction", lambda: virt.resize(
                    virt.mapped_pages // 2))
                times["pool shrink with compaction"].update(
                    moved_pages=r["moved"], swapped_pages=r["swapped_out"])
                n = sum(1 for b in range(B)
                        for _ in virt.requests[b].device_entries())
                timed("swap-out", lambda: [virt.swap_out(b)
                                           for b in range(B)], n * page)
                timed("pool grow", lambda: virt.resize(budget))
                n = virt.swapped_now
                if audit is not None:
                    audit()
                timed("fault-in", lambda: [virt.ensure_resident(b)
                                           for b in range(B)], n * page)
                if lowering and on_card:
                    try:
                        step(tok, virt.pool, virt.batch_tables(
                            name, list(range(B)), max_pages),
                            torch.full((B,), S, dtype=torch.int32))
                    except RuntimeError as e:
                        if "moved or changed shape" not in str(e):
                            raise
                    else:
                        raise AssertionError("a replay over the moved pool "
                                             "did not raise")
                    step.release()
                del captured
            for b in range(B):
                virt.ensure_resident(b)
                virt.extend_request(b, 1)
            tables = virt.batch_tables(name, list(range(B)), max_pages)
            lengths = torch.full((B,), S + t, dtype=torch.int32,
                                 device=device)
            got, virt.pool = step(tok, virt.pool, tables, lengths)
            if audit is not None:
                audit()
            out.append(got.clone())
            tok = torch.argmax(got, dim=-1).to(torch.int32)
        if lowering and on_card:
            times["recapture"] = dict(ms=step.capture_s[-1] * 1e3,
                                      captures=step.captures)
        if audit is not None:
            audited.update(audits=virt.hooks.audits,
                           events=virt.hooks.events)
        return out

    want = run(False)
    got = run(True)
    for t, (a, b) in enumerate(zip(want, got)):
        if not torch.equal(a, b):
            raise AssertionError(f"forced cycle lowering={lowering}: step "
                                 f"{t} differs from the unperturbed run")
    log(f"elastic forced cycle {name} lowering={lowering}: {steps} steps "
        f"equal the unperturbed run bit for bit; "
        + "; ".join(f"{k} {v['ms']:.3f} ms"
                    + (f" ({v['bytes'] / 2**20:.1f} MiB, "
                       f"{v['gb_per_s']:.2f} GB/s)" if "bytes" in v else "")
                    for k, v in times.items()))
    if audited:
        log(f"elastic forced cycle {name} lowering={lowering}: sanitizer "
            f"clean over {audited['audits']} audits and "
            f"{audited['events']} hook events")
        times["sanitizer"] = audited
    return times


def elastic_phase(torch, np, kops, models, device="cuda",
                  card: str = "") -> dict:
    """Phase 9: the elastic engine against the frozen one, the checks
    after the moves, and the forced cycle in both lowering modes; the
    summary lines carry ``card`` (nvidia-smi's name and power limit)."""
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {}
    streams = {}
    for elastic in (True, False):
        label = "elastic" if elastic else "frozen"
        figures, reqs, engine = serve_elastic(torch, np, kops, models,
                                              elastic, device)
        streams[label] = [r.output_ids for r in reqs]
        if elastic and engine.device.type == "cuda":
            after_moves_check(torch, np, engine)
        out[label] = figures
        del engine, reqs
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if streams["elastic"] != streams["frozen"]:
        bad = [i for i, (a, b) in enumerate(zip(streams["elastic"],
                                                streams["frozen"])) if a != b]
        raise AssertionError(f"elastic: requests {bad} emit other tokens "
                             f"than on the frozen engine")
    log("elastic: every request's greedy stream equals the frozen engine's")
    out["cycle"] = {f"lowering={lo}": forced_cycle(
        torch, np, models[BURST_MODEL], lo, device) for lo in (True, False)}
    tag = f"elastic [{card}]"
    if torch.device(device).type == "cuda":
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"{tag}: max memory allocated {out['max_memory_gib']:.2f} GiB")
    e, f = out["elastic"], out["frozen"]
    log(f"{tag}: {e['moves']} moves applied; pool grow ms "
        f"{e['pool_grow_ms']}; pool shrink ms {e['pool_shrink_ms']}; arena "
        f"shrink ms {e['arena_shrink_ms']}; arena grow ms "
        f"{e['arena_grow_ms']}")
    for name, ms in e["recapture_ms"].items():
        log(f"{tag}: recapture {name} ms {ms}")
    for mode, times in out["cycle"].items():
        log(f"{tag}: forced cycle {mode}: {times}")
    log(f"{tag}: burst {e['burst_tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{e['burst_ttft_p50_ms']:.1f} ms; frozen "
        f"{f['burst_tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{f['burst_ttft_p50_ms']:.1f} ms")
    out["card"] = card
    out["wall_s"] = time.perf_counter() - t0
    log(f"{tag}: phase wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the prefix cache
# ---------------------------------------------------------------------------

def cache_engine(torch, models, device, *, params=None, page_budget=16384,
                 page_bytes=None, max_ctx=1024):
    """An engine with the prefix cache on (K = ``SERVE_K``, lowering on),
    its runners' prefill commit wrapped to keep each request's first-token
    logits and layer-0 prompt KV rows (``engine.probe``) for the
    comparisons below."""
    from repro_torch.configs.base import CacheConfig, EngineConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    kw = {} if page_bytes is None else dict(page_bytes=page_bytes,
                                            slab_bytes=4096)
    engine = CrossPoolEngine(
        models, page_budget=page_budget, max_batch=4, max_ctx=max_ctx,
        seed=0, device=device, params=params,
        config=EngineConfig(
            mode=EngineMode(decode_steps_per_dispatch=SERVE_K),
            cache=CacheConfig(enabled=True)), **kw)
    engine.probe = {}
    for name, runner in engine.runners.items():
        def commit(group, logits, runner=runner, name=name,
                   inner=runner._commit_group):
            for i, req in enumerate(group.requests):
                rows = engine.virt.gather_prompt_rows(
                    name, req.request_id, req.prompt_tokens)[0]
                engine.probe[req.request_id] = (logits[i].float().cpu(),
                                                rows.float().cpu())
            return inner(group, logits)
        runner._commit_group = commit
    return engine


def serve_together(engine, specs):
    """Submit ``specs`` [(request id, model, ids, cache?, new tokens)] at
    once and step until all finish.  Returns one dict per request: the
    stream, the cache outcome, wall TTFT (submit to first token, ms) and
    the prefill passes' ms."""
    from repro_torch.runtime.request import Request
    first, handles = {}, []

    def on_token(ev):
        if ev.first:
            first[ev.request_id] = time.perf_counter()
    n_pass = len(engine.stats.prefill_times)
    t0 = time.perf_counter()
    for rid, model, ids, cache, new in specs:
        req = Request(rid, model, len(ids), new, 0.0, prompt_ids=ids,
                      cache=cache)
        handles.append((engine.submit(req, on_token=on_token), req))
    for _ in range(64):
        engine.step()
        if all(h.done for h, _ in handles):
            break
    prefill_ms = [dt * 1e3 for *_, dt in engine.stats.prefill_times[n_pass:]]
    out = []
    for h, req in handles:
        if not h.done or len(req.output_ids) != req.max_new_tokens:
            raise AssertionError(f"cache: request {req.request_id} emitted "
                                 f"{len(req.output_ids)} of "
                                 f"{req.max_new_tokens} tokens")
        out.append(dict(stream=list(req.output_ids), cached=h.cached_tokens,
                        hit=h.cache_hit, prompt=req.prompt_tokens,
                        ttft_ms=(first[req.request_id] - t0) * 1e3,
                        prefill_ms=prefill_ms))
    return out


def conversations(np, engine, model, n_conv, rng, *, first_rid=0,
                  prompt=None, new=None, delta=None, turns=None):
    """``n_conv`` conversations of ``turns`` turns on one model, each
    turn served with the cache (``on``) and then opted out of it
    (``off``, a full prefill) on the same prompt; the next prompt is this
    one, the cache-off turn's tokens and a random delta (the shape of
    ``benchmarks/multiturn_cache.py``).  Returns one record per turn."""
    prompt = prompt or CACHE_PROMPT
    new, delta, turns = new or CACHE_NEW, delta or CACHE_DELTA, \
        turns or CACHE_TURNS
    vocab = engine.models[model].vocab_size
    rid, out = first_rid, []
    for c in range(n_conv):
        ids = rng.integers(0, vocab, prompt).astype(np.int32)
        for t in range(turns):
            on = serve_together(engine, [(rid, model, ids, True,
                                                 new)])[0]
            off = serve_together(engine, [(rid + 1, model, ids, False,
                                                  new)])[0]
            out.append(dict(conv=c, turn=t, on=on, off=off, rid_on=rid,
                            rid_off=rid + 1, fork=on["cached"], ids=ids,
                            prev=out[-1]["on"]["prompt"] if t else 0))
            rid += 2
            ids = next_turn(np, out[-1], rng.integers(0, vocab, delta))
    return out


def check_hits(records, label) -> None:
    """Every warm turn hits the previous turn's prompt (the tree indexes
    committed prompt KV, not output); every first turn misses."""
    for r in records:
        want = r["prev"]
        if r["on"]["cached"] != want or r["on"]["hit"] != (want > 0) \
                or r["off"]["cached"] != 0:
            raise AssertionError(
                f"{label}: conversation {r['conv']} turn {r['turn']} cached "
                f"{r['on']['cached']} tokens, expected {want} (cache-off "
                f"{r['off']['cached']})")


def turn_numbers(engine, r) -> dict:
    """One warm turn against its cache-off twin: max |d| of the first-token
    logits and of the layer-0 KV rows past the fork (which must lie within
    the bf16 kernel tolerance, 2e-2 + 2e-2 |x|), token agreement, TTFT and
    prefill ms on and off."""
    lo, ro = engine.probe[r["rid_on"]]
    lf, rf = engine.probe[r["rid_off"]]
    fork = r["fork"]
    d_kv = (ro[fork:] - rf[fork:]).abs()
    if (d_kv > 2e-2 + 2e-2 * rf[fork:].abs()).any():
        raise AssertionError(f"cache: layer-0 KV rows the suffix wrote are "
                             f"off by {d_kv.max().item():.3g} (tolerance "
                             f"2e-2 + 2e-2|x|)")
    a, b = r["on"]["stream"], r["off"]["stream"]
    return dict(turn=r["turn"], fork=fork, prompt=r["on"]["prompt"],
                logits_max_abs=(lo - lf).abs().max().item(),
                kv0_max_abs=d_kv.max().item(),
                token_agreement=sum(x == y for x, y in zip(a, b)) / len(a),
                ttft_on_ms=r["on"]["ttft_ms"], ttft_off_ms=r["off"]["ttft_ms"],
                prefill_on_ms=sum(r["on"]["prefill_ms"]),
                prefill_off_ms=sum(r["off"]["prefill_ms"]))


def shared_and_swapped(torch, np, engine, model, rng, first_rid) -> dict:
    """A producer puts a 64-token head into the tree; two requests with
    that head are admitted in one step (their decode reads shared pages)
    and served beside their cache-off twins; then the whole tree is shed
    to the pinned tier and the next turn's hit faults it back: the pages
    must hold their bytes from before the shed, bit for bit.  Returns the
    pair's streams and the fault figures."""
    vocab = engine.models[model].vocab_size
    head = rng.integers(0, vocab, CACHE_HEAD).astype(np.int32)
    rid = first_rid

    def prompt(n):
        return np.concatenate([head, rng.integers(0, vocab, n)
                               .astype(np.int32)])
    serve_together(engine, [(rid, model, prompt(56), True, 4)])
    pa, pb = prompt(40), prompt(50)      # all in the 128 bucket
    on = serve_together(engine, [(rid + 1, model, pa, True, 8),
                                        (rid + 2, model, pb, True, 8)])
    off = serve_together(engine, [(rid + 3, model, pa, False, 8),
                                         (rid + 4, model, pb, False, 8)])
    if [o["cached"] for o in on] != [CACHE_HEAD, CACHE_HEAD]:
        raise AssertionError(f"cache: the pair cached "
                             f"{[o['cached'] for o in on]} tokens, expected "
                             f"{CACHE_HEAD} each")
    cache, virt = engine.cache, engine.virt
    nodes = [n for n in cache._walk() if n.pages and not n.swapped]
    before = {id(n): virt.pool[n.pages].clone() for n in nodes}
    held = cache.device_pages_held
    shed = cache.shed(held)
    if shed != held or cache.device_pages_held != 0:
        raise AssertionError(f"cache: shed {shed} of {held} tree pages")
    nxt = np.concatenate([pa, np.asarray(on[0]["stream"], np.int32),
                          rng.integers(0, vocab, 8).astype(np.int32)])
    faulted0 = cache.faulted_pages
    from repro_torch.runtime.request import Request
    t0 = time.perf_counter()
    h = engine.submit(Request(rid + 5, model, len(nxt), 4, 0.0,
                              prompt_ids=nxt))
    sync(torch, engine.device)
    fault_ms = (time.perf_counter() - t0) * 1e3
    faulted = cache.faulted_pages - faulted0
    back = [n for n in nodes if not n.swapped]
    if h.cached_tokens != len(pa) or not back or faulted == 0:
        raise AssertionError(f"cache: the turn after the shed cached "
                             f"{h.cached_tokens} tokens (expected {len(pa)}),"
                             f" {faulted} pages faulted")
    for n in back:
        if not torch.equal(virt.pool[n.pages], before[id(n)]):
            raise AssertionError("cache: a faulted tree page differs from "
                                 "its bytes before the shed")
    for _ in range(16):
        engine.step()
        if h.done:
            break
    if not h.done:
        raise AssertionError("cache: the refaulted turn did not finish")
    log(f"cache {model}: two requests on one {CACHE_HEAD}-token head "
        f"(shared pages) streams {[o['stream'] for o in on]} (cache-off "
        f"{[o['stream'] for o in off]}); {shed} tree pages shed to the "
        f"pinned tier, {faulted} faulted back bit for bit "
        f"({fault_ms:.1f} ms admission with the fault)")
    return dict(pair_on=[o["stream"] for o in on],
                pair_off=[o["stream"] for o in off], shed_pages=shed,
                faulted_pages=faulted, admission_with_fault_ms=fault_ms,
                next_rid=rid + 6)


def next_turn(np, record, delta):
    """The turn after ``record``: its prompt, its cache-off tokens and
    ``delta``."""
    return np.concatenate([record["ids"], np.asarray(record["off"]["stream"],
                                                     np.int32),
                           np.asarray(delta, np.int32)])


def profile_warm_prefill(torch, np, engine, model, record, rid) -> dict:
    """Where a warm turn's prefill time goes: the turn after ``record``,
    served with the cache (a suffix pass) and opted out of it (a full
    pass), its ``prefill_group`` call alone under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.request import Request
    ids = next_turn(np, record, np.arange(100, 100 + CACHE_DELTA))
    runner = engine.runners[model]
    out = {}
    for label, cache, r in (("cache on", True, rid), ("cache off", False,
                                                      rid + 1)):
        h = engine.submit(Request(r, model, len(ids), 1, 0.0, prompt_ids=ids,
                                  cache=cache))
        what = (f"{model} warm-turn prefill, {label} ({h.cached_tokens} of "
                f"{len(ids)} tokens cached)")

        def profiled(group, inner=runner.prefill_group, what=what,
                     label=label):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                slots = inner(group)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out[label] = device_summary(prof, wall, what)
            return slots
        runner.prefill_group = profiled
        try:
            engine.step()
        finally:
            del runner.prefill_group          # the class's method again
        if not h.done or label not in out:
            raise AssertionError(f"cache {model}: the profiled turn did not "
                                 f"finish in its prefill step")
    return out


def cache_accounting(engine, label) -> None:
    """After a drain: the tree holds exactly the mapped pages, and every
    page is free or mapped."""
    held, mapped = engine.cache.device_pages_held, engine.virt.mapped_pages
    if held != mapped or engine.virt.free_pages + mapped \
            != engine.virt.page_budget:
        raise AssertionError(f"{label}: tree holds {held} pages, {mapped} "
                             f"mapped, {engine.virt.free_pages} free of "
                             f"{engine.virt.page_budget}")


def cache_full_width(torch, np, kops, models) -> dict:
    """Each colocated model alone at published width (bf16, ``max_ctx``
    1024, K = 4, lowering on, the cache on): one warm-up conversation,
    then ``CACHE_CONVERSATIONS`` measured ones, each turn cache-on and
    cache-off; the shared-page pair and the shed-and-refault turn.  Hard
    gates: hits, page accounting, no NaN logit, exact launch counts
    summed over the three runs, one replay per block, a sync-free block
    dispatch; per warm turn the logit and layer-0 KV differences, token
    agreement, TTFT and prefill ms, on and off."""
    out, total, want = {}, {}, {}
    for name, cfg in models.items():
        t0 = time.perf_counter()
        engine = cache_engine(torch, {name: cfg}, "cuda")
        torch.cuda.synchronize()
        log(f"cache {name}: engine built in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(10)
        captures = {n: replays_and_captures(r)[1]
                    for n, r in engine.runners.items()}
        reset_launches(kops)
        t_phase = time.perf_counter()
        records = conversations(np, engine, name, 1 + CACHE_CONVERSATIONS,
                                rng)
        check_hits(records, f"cache {name}")
        shared = shared_and_swapped(torch, np, engine, name, rng,
                                    records[-1]["rid_off"] + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_phase
        profiles = profile_warm_prefill(torch, np, engine, name, records[-1],
                                        shared["next_rid"])
        launches = read_launches(kops)
        stats = engine.finalize()
        graph_report(engine, stats, f"cache {name}")
        for k, v in expected_split_launches(stats, engine, captures).items():
            want[k] = want.get(k, 0) + v
        for k in want:
            total[k] = total.get(k, 0) + launches[k]
        cache_accounting(engine, f"cache {name}")
        bad = sum(int(r.nonfinite_logits) for r in engine.runners.values())
        if bad:
            raise AssertionError(f"cache {name}: {bad} non-finite logits")
        warm = [turn_numbers(engine, r) for r in records
                if r["conv"] > 0 and r["turn"] > 0]
        for w in warm:
            log(f"cache {name} turn {w['turn']} (fork {w['fork']} of "
                f"{w['prompt']}): logits max|d| {w['logits_max_abs']:.4g}, "
                f"layer-0 KV max|d| {w['kv0_max_abs']:.4g}, token agreement "
                f"{w['token_agreement']:.2f}; TTFT {w['ttft_on_ms']:.2f} ms "
                f"on / {w['ttft_off_ms']:.2f} off, prefill "
                f"{w['prefill_on_ms']:.2f} / {w['prefill_off_ms']:.2f} ms")
        # a warm turn (a hit) mid-decode: one block dispatch, no host read
        last = records[-1]
        ids = next_turn(np, last, np.arange(CACHE_DELTA))
        from repro_torch.runtime.request import Request
        h = engine.submit(Request(shared["next_rid"] + 2, name, len(ids), 16,
                                  0.0, prompt_ids=ids))
        engine.step()
        if h.cached_tokens < last["on"]["prompt"] or h.done:
            raise AssertionError(f"cache {name}: the sync-free check's turn "
                                 f"cached {h.cached_tokens} tokens")
        block_is_sync_free(torch, engine)
        out[name] = dict(warm_turns=warm, shared=shared, wall_s=wall,
                         profiles=profiles,
                         snapshot=engine.cache.snapshot(),
                         hits=[r["on"]["cached"] for r in records])
        log(f"cache {name}: {len(records)} turns on and off in {wall:.1f} s; "
            f"{engine.cache.snapshot()}")
        del engine, records
        gc.collect()
        torch.cuda.empty_cache()
    for k, n in want.items():
        if total[k] != n or n <= 0:
            raise AssertionError(f"cache: {k} launched {total[k]} times, "
                                 f"expected {n}")
    log(f"cache: launches exactly as expected, suffix writes counted: {want}")
    out["launches"] = total
    return out


def cache_exact(torch, np) -> dict:
    """Float32 smoke configs of the colocated set: the same conversations
    and the shared-page pair on the card (cache on and off) and on the
    CPU (cache on) give equal streams."""
    from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
    from repro_torch.models.transformer import init_params
    models = {n: get_smoke_config(n).replace(dtype="float32")
              for n in PAPER_COLOC_SET}
    streams = {}
    for device in ("cuda", "cpu"):
        params = {n: init_params(torch.Generator().manual_seed(i), c)
                  for i, (n, c) in enumerate(models.items())}
        engine = cache_engine(torch, models, device, params=params,
                              page_budget=4096, page_bytes=4096)
        rng = np.random.default_rng(12)
        got, rid = {}, 0
        for name in models:
            recs = conversations(np, engine, name, 1, rng, first_rid=rid)
            check_hits(recs, f"cache f32 {device} {name}")
            rid = recs[-1]["rid_off"] + 1
            shared = shared_and_swapped(torch, np, engine, name, rng, rid)
            rid = shared["next_rid"] + 1
            got[name] = dict(
                on=[r["on"]["stream"] for r in recs] + shared["pair_on"],
                off=[r["off"]["stream"] for r in recs] + shared["pair_off"])
        cache_accounting(engine, f"cache f32 {device}")
        streams[device] = got
        del engine
        gc.collect()
    for name in models:
        card, cpu = streams["cuda"][name], streams["cpu"][name]
        if not card["on"] == card["off"] == cpu["on"]:
            raise AssertionError(f"cache f32 {name}: card cache-on "
                                 f"{card['on']}, cache-off {card['off']}, "
                                 f"CPU {cpu['on']}")
    log("cache f32 smoke: card cache-on streams equal card cache-off and the "
        "CPU's, shared-page pair included")
    return streams


def cache_phase(torch, np, kops, models) -> dict:
    t0 = time.perf_counter()
    out = cache_full_width(torch, np, kops, models)
    out["exact"] = cache_exact(torch, np)
    out["wall_s"] = time.perf_counter() - t0
    log(f"cache: phase wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: observability and forensics
# ---------------------------------------------------------------------------

def audit_timer(store: list):
    """Time every ``PoolSanitizer.audit`` of any engine into ``store``
    (ms); returns the function that puts the method back."""
    from repro_torch.analysis.sanitizer import PoolSanitizer
    inner = PoolSanitizer.audit

    def timed(self):
        t0 = time.perf_counter()
        inner(self)
        store.append((time.perf_counter() - t0) * 1e3)
    PoolSanitizer.audit = timed

    def restore():
        PoolSanitizer.audit = inner
    return restore


def observe_engine(torch, models, *, observed, dump_path=None):
    """Phase 5's engine (16384 pages, ``max_batch`` 4, ``max_ctx`` 1024,
    K = ``SERVE_K``, seed 0) with,
    when ``observed``, an ``EngineObserver``, the flight recorder (its
    breach dump to ``dump_path``), the sanitizer and ``OBSERVE_SLO``;
    bare otherwise.  Returns (engine, observer)."""
    from repro_torch.configs.base import (EngineConfig, FlightRecorderConfig,
                                          SLObjective, SLOConfig)
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    from repro_torch.runtime.observe import EngineObserver
    mode = EngineMode(decode_steps_per_dispatch=SERVE_K)
    observer = EngineObserver() if observed else None
    config = EngineConfig(mode=mode)
    if observed:
        config = EngineConfig(
            mode=mode, sanitize=True,
            slo=SLOConfig(objectives={
                n: SLObjective(ttft_ms=OBSERVE_SLO.get(n, 1e9))
                for n in models}),
            flightrec=FlightRecorderConfig(ring_size=1 << 20,
                                           snapshot_interval_steps=4,
                                           dump_path=dump_path))
    engine = CrossPoolEngine(models, page_budget=16384, max_batch=4,
                             max_ctx=1024, seed=0, device="cuda",
                             config=config, observer=observer)
    return engine, observer


def observe_requests(np, models, first_id=0, n=8, new=SERVE_MAX_NEW):
    """Phase 5's trace: ``n`` requests at time 0 round-robin over the
    models, prompts of 200-900 tokens (the same draws for every
    ``first_id``)."""
    from repro_torch.runtime.request import Request
    rng = np.random.default_rng(0)
    names = list(models)
    return [Request(first_id + i, names[i % len(names)],
                    int(rng.integers(200, 901)), new, 0.0)
            for i in range(n)]


def observe_run(torch, engine, reqs) -> float:
    """Submit ``reqs`` at once, drain, and return the wall seconds (the
    card synchronised at both ends); every request must finish."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if len(r.output_ids) != r.max_new_tokens:
            raise AssertionError(f"observe: request {r.request_id} emitted "
                                 f"{len(r.output_ids)} of "
                                 f"{r.max_new_tokens} tokens")
    return wall


def span_trees(observer, reqs) -> None:
    """Every request's track in the Chrome trace: submit, (queued,)
    admitted, decode with its K-block slices, finished; the step track
    balanced with every phase."""
    from repro_torch.runtime.observe import EngineObserver
    for r in reqs:
        names = observer.tracer.span_names(f"req/{r.model}#{r.request_id}")
        seq = [x for x in names if x[0] != "X"]
        head = [("i", "submit")] + ([("B", "queued"), ("E", "queued")]
                                    if ("B", "queued") in seq else [])
        if seq != head + [("B", "admitted"), ("E", "admitted"),
                          ("B", "decode"), ("E", "decode"),
                          ("i", "finished")] \
                or ("X", "decode_block") not in names:
            raise AssertionError(f"observe: request {r.request_id}'s span "
                                 f"tree is incomplete: {names}")
    steps = observer.tracer.span_names(EngineObserver.ENGINE_TRACK)
    for phase in ("step", "admission_drain", "batcher", "prefill",
                  "dispatch", "commit", "completions", "rebalance"):
        if steps.count(("B", phase)) != steps.count(("E", phase)) \
                or ("B", phase) not in steps:
            raise AssertionError(f"observe: phase {phase} unbalanced or "
                                 f"missing on the step track")


def observed_dispatch_is_sync_free(torch, engine) -> None:
    """With the observer, recorder and sanitizer attached: one decode
    block of every model in flight, its ``dispatch`` span around it, then
    an audit and a pool snapshot, all under
    ``set_sync_debug_mode("error")``.  Leaves the engine mid-block."""
    from repro_torch.runtime.flightrec import pool_snapshot
    obs = engine.observer
    pending = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for runner in engine.runners.values():
            if runner.active:
                obs.phase_begin("dispatch")
                pending.append(runner.issue_decode())
                obs.phase_end("dispatch")
        engine.sanitizer.audit()
        obs.pool_counters(pool_snapshot(engine.virt, engine.arena,
                                        engine.cache))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not pending:
        raise AssertionError("observe: no model had a block to dispatch")


def observe_replay(torch, record, label) -> dict:
    """Replay ``record`` in a fresh engine on the card; it must be
    bit-exact.  Returns the report's figures and the wall seconds (the
    engine's build included)."""
    from repro_torch.launch import replay as replay_mod
    t0 = time.perf_counter()
    report = replay_mod.replay(record, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not report.ok:
        raise AssertionError(f"{label}: replay not bit-exact: "
                             f"{report.mismatches}")
    log(f"{label}: {report.summary()} in {wall:.1f} s (engine build "
        f"included)")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ok=report.ok, steps=report.steps, tokens=report.tokens,
                ops=report.ops, failure_reproduced=report.failure_reproduced,
                wall_s=wall)


def observe_instrumented(torch, np, kops, models, card) -> dict:
    """11a-b: phase 5's trace with everything attached, then bare on the
    recorded dt stream, then alternating pairs for tokens/s, the
    sync-free dispatch, and the record's replay."""
    from repro_torch.runtime import flightrec
    out = {}
    dump = ROOT / "build" / "observe_breach.json"
    dump.unlink(missing_ok=True)
    audits: list = []
    restore = audit_timer(audits)
    try:
        t0 = time.perf_counter()
        engine, obs = observe_engine(torch, models, observed=True,
                                     dump_path=str(dump))
        bare, _ = observe_engine(torch, models, observed=False)
        torch.cuda.synchronize()
        log(f"observe: two engines built in {time.perf_counter() - t0:.1f} "
            f"s (instrumented and bare)")
        if engine.sanitizer.events:
            raise AssertionError(f"observe: building the engine (graph "
                                 f"warm-ups and captures) fired "
                                 f"{engine.sanitizer.events} hooks")
        # (a) everything attached: the main path's launch counts from 0
        reqs = observe_requests(np, models)
        del audits[:]
        reset_launches(kops)
        wall_obs = observe_run(torch, engine, reqs)
        launches = read_launches(kops)
        stats = engine.finalize()
        record = json.loads(json.dumps(engine.recorder.to_record()))
        graph_report(engine, stats, "observe")
        check_coloc(launches, stats, engine)
        if obs.tokens_total.value != stats.tokens_out \
                or sorted(obs.ttft.all_samples()) != sorted(stats.ttft) \
                or sorted(obs.tbt.all_samples()) != sorted(stats.tbt):
            raise AssertionError("observe: the metrics disagree with "
                                 "EngineStats")
        span_trees(obs, reqs)
        steps = record["events"][-1]["step"]
        if engine.sanitizer.audits < steps or not audits:
            raise AssertionError(f"observe: {engine.sanitizer.audits} "
                                 f"audits for {steps} steps")
        breaches = [e for e in record["events"] if e["kind"] == "slo_breach"]
        if not breaches or not dump.exists() or any(
                e["model"] not in OBSERVE_SLO for e in breaches):
            raise AssertionError(f"observe: breaches {breaches}, dump "
                                 f"written: {dump.exists()}")
        if flightrec.causal_drops(record):
            raise AssertionError("observe: the ring dropped causal events")
        # the same trace bare, on the recorded dt stream
        b_reqs = observe_requests(np, models)
        bare.attach_replay_clock(flightrec.record_clock(record))
        wall_bare = observe_run(torch, bare, b_reqs)
        if [(r.output_ids, r.token_times) for r in b_reqs] != \
                [(r.output_ids, r.token_times) for r in reqs]:
            raise AssertionError("observe: the bare engine's streams or "
                                 "virtual times differ on the same dt "
                                 "stream")
        bare._replay_dts = None
        log(f"observe: streams and virtual timestamps equal bare "
            f"(instrumented {wall_obs:.2f} s, bare {wall_bare:.2f} s); "
            f"metrics equal EngineStats; {len(reqs)} span trees complete; "
            f"{len(breaches)} SLO breach edge(s) "
            f"({', '.join(sorted({e['model'] for e in breaches}))}), dump "
            f"{dump.stat().st_size} bytes")
        # tokens/s, everything attached against bare: the gate runs above
        # warmed both engines; four timed pairs on the same two engines
        # (new request ids each), the order alternating, attached first
        # and bare first twice each; each pair's wall gap beside the
        # attached run's summed audit time
        tokens = sum(r.max_new_tokens for r in reqs)
        pairs, audit_ms = [], []
        for i in range(1, 5):
            walls = {}
            order = ("obs", "bare") if i % 2 else ("bare", "obs")
            for which in order:
                n_audits = len(audits)
                walls[which] = observe_run(
                    torch, bare if which == "bare" else engine,
                    observe_requests(np, models, 100 * i))
                if which == "obs":
                    audit_ms.append(sum(audits[n_audits:]))
            pairs.append((walls["obs"], walls["bare"]))
        ratios = [b / o for o, b in pairs]
        mid = sorted(ratios)
        med = (mid[1] + mid[2]) / 2
        for i, (o, b) in enumerate(pairs):
            first = "attached" if i % 2 == 0 else "bare"
            log(f"observe [{card}]: pair {i} ({first} first): "
                f"{tokens / o:.1f} tokens/s everything attached, "
                f"{tokens / b:.1f} bare, ratio {ratios[i]:.4f}; wall gap "
                f"{(o - b) * 1e3:.1f} ms, audits {audit_ms[i]:.1f} ms")
        log(f"observe [{card}]: median tokens/s ratio attached / bare "
            f"{med:.4f} (4 pairs)")
        a_sorted = sorted(audits)
        audit_med, audit_max = a_sorted[len(a_sorted) // 2], a_sorted[-1]
        log(f"observe [{card}]: sanitizer audit at page_budget "
            f"{engine.virt.page_budget}: median {audit_med:.3f} ms, max "
            f"{audit_max:.3f} ms over {len(a_sorted)} audits")
        size = len(json.dumps(record))
        n_trace = len(obs.tracer.events)
        log(f"observe: ring {len(record['events'])} events, drops "
            f"{record['dropped']}; record {size} bytes; trace "
            f"{n_trace} events (the attached engine's five runs)")
        # a block dispatch with everything attached makes no host read
        for r in observe_requests(np, models, 900, n=3, new=16):
            engine.submit(r)
        engine.step()
        engine.step()
        observed_dispatch_is_sync_free(torch, engine)
        log("observe: a block dispatch with the observer, recorder and "
            "sanitizer attached makes no host read")
        out.update(tokens_per_s_pairs=[(tokens / o, tokens / b)
                                       for o, b in pairs],
                   pair_audit_ms=audit_ms, ratios=ratios, ratio_median=med,
                   audit_ms_median=audit_med,
                   audit_ms_max=audit_max, audits=len(a_sorted),
                   ring_events=len(record["events"]),
                   ring_drops=record["dropped"], record_bytes=size,
                   trace_events=n_trace, breaches=len(breaches),
                   launches=launches)
    finally:
        restore()
    del engine, bare, obs
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the record replayed in a fresh engine: the breach with it
    out["replay"] = observe_replay(torch, record, "observe replay (b)")
    return out


def observe_host_record(torch, np, models) -> dict:
    """11c: a short lowering-off record (pipeline on, K=1: FFN stages on
    the weights stream) and its replay."""
    from repro_torch.configs.base import EngineConfig, FlightRecorderConfig
    from repro_torch.runtime.engine import CrossPoolEngine, EngineMode
    engine = CrossPoolEngine(
        models, page_budget=16384, max_batch=4, max_ctx=1024, seed=0,
        device="cuda", config=EngineConfig(
            mode=EngineMode(lowering=False, pipeline=True),
            flightrec=FlightRecorderConfig(ring_size=1 << 20)))
    wall = observe_run(torch, engine, observe_requests(np, models, n=4,
                                                       new=8))
    record = json.loads(json.dumps(engine.recorder.to_record()))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"observe host (c): 4 requests served in {wall:.2f} s")
    return observe_replay(torch, record, "observe host replay (c)")


def observe_incidents(torch, np, models) -> dict:
    """11d: each corruption kind injected mid-decode: the step raises
    ``PoolSanitizerError``, the incident dump is written, and its replay
    trips the same rule at the same step."""
    from repro_torch.analysis.sanitizer import PoolSanitizerError
    from repro_torch.launch import replay as replay_mod
    from repro_torch.runtime import flightrec
    out = {}
    for kind in flightrec.INJECTION_KINDS:
        path = ROOT / "build" / f"incident_{kind}.json"
        path.unlink(missing_ok=True)
        engine, _ = observe_engine(torch, models, observed=True,
                                   dump_path=str(path))
        for r in observe_requests(np, models, n=2, new=16):
            engine.submit(r)
        engine.step()
        engine.step()
        flightrec.inject_corruption(engine, kind)
        try:
            engine.step()
        except PoolSanitizerError as err:
            rule, step = err.rule, engine._step_index
        else:
            raise AssertionError(f"observe: {kind} did not trip the "
                                 f"sanitizer")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if not path.exists():
            raise AssertionError(f"observe: {kind}: no incident dump")
        record = replay_mod.load_record(str(path))
        if (record["failure"]["rule"], record["failure"]["step"]) != \
                (rule, step):
            raise AssertionError(f"observe: {kind}: the dump says "
                                 f"{record['failure']}")
        rep = observe_replay(torch, record, f"observe incident {kind} (d)")
        if not rep["failure_reproduced"]:
            raise AssertionError(f"observe: {kind}: failure not reproduced")
        log(f"observe: {kind} trips {rule} at step {step}; the dump "
            f"({path.stat().st_size} bytes) replays to the same rule and "
            f"step")
        out[kind] = dict(rule=rule, step=step, replay=rep)
    return out


def observe_sanitized_paths(torch, np, kops, models) -> dict:
    """11e: the sanitizer on (``CROSSPOOL_SANITIZE=1``) through phase 9's
    elastic burst and forced cycle and phase 10's multi-turn conversation
    with its shared pages, shed and fault; every audit clean."""
    import os
    audits: list = []
    restore = audit_timer(audits)
    os.environ["CROSSPOOL_SANITIZE"] = "1"
    out = {}
    try:
        figures, _, engine = serve_elastic(torch, np, kops, models, True,
                                           "cuda")
        if engine.sanitizer is None or not engine.sanitizer.audits:
            raise AssertionError("observe: the elastic engine ran without "
                                 "the sanitizer")
        out["elastic"] = dict(moves=figures["moves"],
                              audits=engine.sanitizer.audits,
                              events=engine.sanitizer.events)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        out["cycle"] = forced_cycle(torch, np, models[BURST_MODEL], True,
                                    "cuda", sanitize=True)
        engine = cache_engine(torch, {BURST_MODEL: models[BURST_MODEL]},
                              "cuda")
        rng = np.random.default_rng(10)
        records = conversations(np, engine, BURST_MODEL, 1, rng, turns=2)
        check_hits(records, "observe cache")
        shared = shared_and_swapped(torch, np, engine, BURST_MODEL, rng,
                                    records[-1]["rid_off"] + 1)
        cache_accounting(engine, "observe cache")
        out["cache"] = dict(audits=engine.sanitizer.audits,
                            events=engine.sanitizer.events,
                            shed_pages=shared["shed_pages"],
                            faulted_pages=shared["faulted_pages"])
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        del os.environ["CROSSPOOL_SANITIZE"]
        restore()
    out["audits"] = len(audits)
    log(f"observe (e): sanitizer clean through the elastic burst "
        f"({out['elastic']['moves']} moves, {out['elastic']['audits']} "
        f"audits), the forced cycle and the cache conversation "
        f"({out['cache']['shed_pages']} pages shed, "
        f"{out['cache']['faulted_pages']} faulted; "
        f"{out['cache']['audits']} audits); {len(audits)} audits in all")
    return out


def observe_phase(torch, np, kops, models, card) -> dict:
    """Phase 11: observability and forensics on the serve configuration."""
    t0 = time.perf_counter()
    out = dict(card=card)
    out.update(observe_instrumented(torch, np, kops, models, card))
    out["host"] = observe_host_record(torch, np, models)
    out["incidents"] = observe_incidents(torch, np, models)
    out["sanitized"] = observe_sanitized_paths(torch, np, kops, models)
    out["wall_s"] = time.perf_counter() - t0
    log(f"observe [{card}]: replay wall {out['replay']['wall_s']:.1f} s "
        f"(b), {out['host']['wall_s']:.1f} s (c); phase wall "
        f"{out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the dense-cache Model path of the remaining families
# ---------------------------------------------------------------------------

def flash_time_row(torch, kops, ref, shape, q, k, v, scale) -> dict:
    """Row 4 on causal ``q`` [B,S,H,D], ``k`` / ``v`` [B,S,KV,D] (bf16 or
    float32): kernel, plain version and the fastest SDPA backend timed
    beside the bound."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    b_ms, b_by = bound_ms((2 * B * S * H * D + 2 * B * S * KV * D)
                          * q.element_size(),
                          4 * B * H * D * (S * (S + 1) // 2),
                          fp32=q.dtype == torch.float32)
    lib, lib_name, lib_all = library_sdpa(torch, lambda: sdpa(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True))
    return dict(
        kernel="flash_attention", shape=shape,
        ms=time_ms(torch, lambda: kops.flash_attention(q, k, v,
                                                       scale=scale)),
        plain_ms=time_ms(torch, lambda: ref.flash_attention(q, k, v, scale)),
        library_ms=lib, library=lib_name, library_all=lib_all,
        bound_ms=b_ms, bound_by=b_by)


def decode_time_row(torch, kops, ref, shape, q, ck, cv, lens, scale,
                    lse: bool = False) -> dict:
    """Row 3 on ``q`` [B,1,H,D] over a full cache [B,T,KV,D] (bf16 or
    float32), with its float32 log-sum-exp output [B,H] where ``lse``:
    kernel, plain version and the fastest SDPA backend (which returns no
    log-sum-exp: the yardstick of the other rows) timed beside the
    bound."""
    B, _, H, D = q.shape
    T, KV = ck.shape[1], ck.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
    b_ms, b_by = bound_ms((2 * B * T * KV * D + 2 * B * H * D)
                          * q.element_size() + 4 * B
                          + (4 * B * H if lse else 0), 4 * B * H * T * D,
                          fp32=q.dtype == torch.float32)
    lib, lib_name, lib_all = library_sdpa(torch, lambda: sdpa(
        qt, kt, vt, scale=scale, enable_gqa=True))
    return dict(
        kernel="decode_attention", shape=shape, lse=lse,
        ms=time_ms(torch, lambda: kops.decode_attention(
            q, ck, cv, lens, scale=scale, return_lse=lse)),
        plain_ms=time_ms(torch, lambda: ref.decode_attention(
            q, ck, cv, lens, scale, return_lse=lse)),
        library_ms=lib, library=lib_name, library_all=lib_all,
        bound_ms=b_ms, bound_by=b_by)


def lse_phase(torch, kops, ref) -> tuple:
    """(3) Row 3's log-sum-exp output, the local body of the crosspool
    decode over a sequence-sharded cache, against the plain version's at
    ``LSE_GEOMETRIES`` in both dtypes: ``LSE_BATCH`` rows of lengths 0, 1,
    one before a split boundary, on it, one past it and T, NaN past each,
    over a cache of each of ``LSE_CONTEXTS`` (several splits: the merge
    writes lse; one tile: the split kernel does).  Gates: lse within
    2e-5 (float32) or 2e-2 (bf16) of the plain version's and -inf at
    length 0, the output within the kernel tolerances (bf16 also the row
    limit) and equal bit for bit to the call without lse.  Then timed at
    a 16b rank's shard (``SERVE_SHARD_SIZES`` over 16b's (2, 2): its rows
    over ``data``, its slice of the sequence over ``model``) beside its
    bound and SDPA.  Returns ({"out": err, "lse": err}, rows)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(32)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"out": 0.0, "lse": 0.0}
    B = LSE_BATCH
    for (label, H, KV, D), T, (dtype, tol) in (
            (g, t, d) for g in LSE_GEOMETRIES for t in LSE_CONTEXTS
            for d in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))):
        _, splits = pa.split_plan(B, H, KV, T, sm, dtype)
        edge = pa.split_start(1, splits, T) if splits > 1 else T // 2
        lengths = [0, 1, edge - 1, edge, edge + 1, T]
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
        ck, cv = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        for b, n in enumerate(lengths):
            ck[b, n:] = float("nan")
            cv[b, n:] = float("nan")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        shape = (f"{label} B={B} T={T} H={H} KV={KV} D={D} {splits} "
                 f"split{'s' if splits > 1 else ''} lengths {lengths} "
                 f"{str(dtype)[6:]}")
        got, lse = kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5,
                                         return_lse=True)
        want, want_lse = ref.decode_attention(q, ck, cv, lens, D ** -0.5,
                                              return_lse=True)
        sync(torch, "cuda")
        if not (torch.isneginf(lse[0]).all() and not got[0].any()):
            raise AssertionError(f"decode lse {shape}: a row of length 0 "
                                 f"must give lse -inf and output 0")
        errs["lse"] = max(errs["lse"], close_or_raise(
            torch, f"decode lse {shape} lse", lse[1:], want_lse[1:], tol))
        errs["out"] = max(errs["out"], close_or_raise(
            torch, f"decode lse {shape} output", got, want, tol,
            row_limit(torch, dtype)))
        if not torch.equal(got, kops.decode_attention(q, ck, cv, lens,
                                                      scale=D ** -0.5)):
            raise AssertionError(f"decode lse {shape}: the output differs "
                                 f"from the call without lse")
    # a 16b rank's shard: its rows and its slice of the cache, full
    cfg = get_config(SERVE_SHARD_RUNS[2][1])
    (data, model), (batch, prompt, steps) = SERVE_SHARD_RUNS[2][3], \
        SERVE_SHARD_SIZES
    B, T = batch // data, (prompt + steps) // model
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
        ck, cv = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        rows.append(decode_time_row(
            torch, kops, ref, f"16b rank's slice B={B} T={T} H={H} KV={KV} "
            f"D={D} with lse {str(dtype)[6:]}", q, ck, cv, lens, D ** -0.5,
            lse=True))
    for r in rows:
        log(f"time decode_attention+lse {r['shape']}: kernel {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['library']} {r['library_ms']:.4f} ms "
            f"(no lse; sdpa backends {fmt_backends(r['library_all'])})")
    return errs, rows


def families_kernel_phase(torch, kops, ref):
    """(12a) Rows 3 and 4 at gemma3's head geometry (H 16 over KV 8, head
    dim 256) against their plain versions (bf16 2e-2 and a row relative
    RMS error of ``BF16_ROW_RMS``, float32 2e-5):
    contiguous decode over the global cache (B = 4, T = 4096, ragged
    lengths, NaN past them) and over a local ring (W = 1024, counts
    below W), flash prefill at S = T = 2048 and at T > S; then each is
    timed in bf16 beside its bound and the fastest SDPA backend."""
    from repro_torch.configs import get_config
    cfg = get_config(GEMMA)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    W = cfg.sliding_window
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def decode_case(B, T, lengths, dtype):
        q = randn(B, 1, H, D, dtype=dtype)
        ck, cv = randn(B, T, KV, D, dtype=dtype), randn(B, T, KV, D,
                                                        dtype=dtype)
        for b, n in enumerate(lengths):
            ck[b, n:] = float("nan")
            cv[b, n:] = float("nan")
        return q, ck, cv, torch.tensor(lengths, dtype=torch.int32,
                                       device="cuda")

    errs, rows = {}, []
    cases = (("global", GEMMA_BATCH, GEMMA_CTX, [GEMMA_CTX, 2049, 1, 3000]),
             ("ring", GEMMA_BATCH, W, [W, 1000, 17, 1]))
    for label, B, T, lengths in cases:
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            q, ck, cv, lens = decode_case(B, T, lengths, dtype)
            e = close_or_raise(
                torch, f"decode gemma3 {label} B={B} T={T} lengths "
                       f"{lengths} {dtype}",
                kops.decode_attention(q, ck, cv, lens, scale=D ** -0.5),
                ref.decode_attention(q, ck, cv, lens, D ** -0.5), tol,
                row_limit(torch, dtype))
            errs["decode_attention"] = max(errs.get("decode_attention", 0), e)
        q, ck, cv, lens = decode_case(B, T, [T] * B, torch.bfloat16)
        rows.append(decode_time_row(
            torch, kops, ref, f"gemma3 {label} B={B} T={T} H={H} KV={KV} "
                              f"D={D} bf16", q, ck, cv, lens, D ** -0.5))

    for B, S, T, dtype, tol in ((GEMMA_BATCH, GEMMA_PROMPT, GEMMA_PROMPT,
                                 torch.bfloat16, 2e-2),
                                (1, GEMMA_PROMPT, GEMMA_PROMPT,
                                 torch.float32, 2e-5),
                                (1, 190, 250, torch.bfloat16, 2e-2),
                                (2, 100, 130, torch.float32, 2e-5)):
        q, k, v = (randn(B, n, h, D, dtype=dtype)
                   for n, h in ((S, H), (T, KV), (T, KV)))
        e = close_or_raise(
            torch, f"flash gemma3 B={B} S={S} T={T} {dtype}",
            kops.flash_attention(q, k, v, scale=D ** -0.5),
            ref.flash_attention(q, k, v, D ** -0.5), tol,
            row_limit(torch, dtype))
        errs["flash_attention"] = max(errs.get("flash_attention", 0), e)
    B, S = GEMMA_BATCH, GEMMA_PROMPT
    q, k, v = (randn(B, S, h, D) for h in (H, KV, KV))
    rows.append(flash_time_row(torch, kops, ref, f"gemma3 B={B} S=T={S} "
                               f"H={H} KV={KV} D={D} bf16", q, k, v,
                               D ** -0.5))
    for r in rows:
        log(f"time {r['kernel']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['library']} {r['library_ms']:.4f} ms "
            f"(sdpa backends {fmt_backends(r['library_all'])})")
    return errs, rows


def family_inputs(torch, cfg, B, S_txt, gen, device):
    """tokens [B,S_txt] and the modality inputs (a vlm's stub patch
    embeddings, whisper's encoder frames), drawn from ``gen``."""
    kw = {}
    if cfg.frontend == "vision_patches":
        kw["embeddings"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.d_model), generator=gen,
            device=gen.device).to(device)
    if cfg.family == "audio":
        kw["encoder_frames"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=gen.device).to(device)
    tokens = torch.randint(0, cfg.vocab_size, (B, S_txt), generator=gen,
                           device=gen.device, dtype=torch.int32).to(device)
    return tokens, kw


def families_small_phase(torch, device="cuda"):
    """(12b) gemma3, whisper and llava smoke configs in float32 on the card
    against the CPU (plain versions): forward, prefill (flash; logits read
    5 tokens before the end) and two paged decode steps (one row inside
    the prompt), logits within 1e-4.  gemma3's prompt (40) outruns its window (16)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import map_tree

    for i, name in enumerate(FAMILY_SMOKES):
        cfg = get_smoke_config(name).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(i))
        tokens, kw = family_inputs(torch, cfg, 2, 40,
                                   torch.Generator().manual_seed(7), "cpu")
        S = tokens.shape[1] + (kw["embeddings"].shape[1]
                               if "embeddings" in kw else 0)
        out = {}
        for dev in (device, "cpu"):
            p = map_tree(lambda t: t.to(dev, copy=True), params)
            dkw = {k: v.to(dev) for k, v in kw.items()}
            fwd, _ = model.forward(p, tokens.to(dev), **dkw)
            cache = model.init_cache(2, S + 8, dev)
            first, _ = model.prefill(p, tokens.to(dev), cache,
                                     impl="flash", logit_index=S - 5, **dkw)
            lengths = torch.tensor([S - 4, S], dtype=torch.int32, device=dev)
            steps, tok = [], first.argmax(-1).to(torch.int32)
            for _ in range(2):
                logits, _ = model.decode_step(p, tok, cache, lengths,
                                              impl="paged")
                steps.append(logits.cpu())
                tok, lengths = logits.argmax(-1).to(torch.int32), lengths + 1
            out[dev] = [fwd.cpu(), first.cpu()] + steps
        for phase, got, want in zip(("forward", "prefill", "decode 1",
                                     "decode 2"), out[device], out["cpu"]):
            err = (got - want).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"{name} {phase} logits: card vs CPU "
                                     f"max abs err {err:.3g} > 1e-4")
            log(f"small {name} {phase} (prefill flash, decode paged): card "
                f"vs CPU logits max abs err {err:.3g} (tolerance 1e-4)")


def decode_run(torch, kops, model, params, cache, tokens, *, steps,
               logit_index=None, device="cuda", **kw):
    """One flash prefill of ``tokens`` (and a modality input ``kw``) and
    ``steps`` greedy paged decode steps from the real lengths
    (``logit_index + 1``, default the bucket), the card synchronised
    around each part; the lengths stay on the card and nothing is read
    back until the end.  Returns (figures, the prefill's launch counts,
    the decode's, the last step's lengths)."""
    B, S = tokens.shape[0], tokens.shape[1]
    S += kw["embeddings"].shape[1] if "embeddings" in kw else 0
    at = S - 1 if logit_index is None else logit_index
    sync(torch, device)
    reset_launches(kops)
    t0 = time.perf_counter()
    logits, _ = model.prefill(params, tokens, cache, impl="flash",
                              logit_index=logit_index, **kw)
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    pre = read_launches(kops)
    bad = (~torch.isfinite(logits)).sum()
    lengths = torch.full((B,), at + 1, dtype=torch.int32, device=device)
    tok = logits.argmax(-1).to(torch.int32)
    reset_launches(kops)
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, _ = model.decode_step(params, tok, cache, lengths,
                                      impl="paged")
        bad += (~torch.isfinite(logits)).sum()
        tok = logits.argmax(-1).to(torch.int32)
        lengths += 1
    sync(torch, device)
    decode_s = time.perf_counter() - t0
    dec = read_launches(kops)
    figures = dict(batch=B, prompt=S, logit_index=at, steps=steps,
                   prefill_ms=prefill_s * 1e3,
                   decode_ms_per_step=decode_s * 1e3 / steps,
                   tokens_per_s=B * steps / decode_s,
                   nonfinite_logits=int(bad))
    return figures, pre, dec, lengths - 1


def check_counts(label, got, want) -> None:
    for name, n in want.items():
        if got[name] != n:
            raise AssertionError(f"{label}: {name} launched {got[name]} "
                                 f"times, expected {n}")


def profile_model_step(torch, fn, label) -> dict:
    """Device busy time and the largest kernels of one ``fn()`` call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_summary(prof, wall, label)


def gemma3_full(torch, kops, cfg, device="cuda") -> dict:
    """(12c) gemma3-12b at its full published config, bf16, random weights
    from a seed, ``GEMMA_RUNS``: a [4, 2048] prefill (twice the window;
    flash on the 8 global layers) and 64 greedy paged decode steps; a
    1000-token prompt decoded 48 steps (its ring crosses W = 1024); a
    301-token prompt in a 512 bucket (the pad quirk: the ring keeps the
    pad positions).  Gates: no NaN logit, flash launched 8 times a
    prefill and contiguous decode 48 times a step (8 global + 40 local
    layers), the ring count ``n`` read back at the end equal to
    ``min(max(cur + 1, S), W)``."""
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model
    from repro_torch.training.tree import leaves

    model = build_model(cfg)
    W, G = cfg.sliding_window, cfg.n_layers // cfg.swa_pattern
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sync(torch, device)
    n_params = sum(t.numel() for t in leaves(params))
    log(f"families: {GEMMA} full config ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, head dim {cfg.head_dim}, window {W}, {cfg.dtype}),"
        f" {n_params / 1e9:.3f} B params drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(1)
    out = {"params": n_params}
    for label, B, S, steps, logit_index in GEMMA_RUNS:
        cache = model.init_cache(B, GEMMA_CTX, device)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=device, dtype=torch.int32)
        fig, pre, dec, cur = decode_run(torch, kops, model, params, cache,
                                        tokens, steps=steps,
                                        logit_index=logit_index,
                                        device=device)
        check_counts(f"{GEMMA} {label} prefill", pre,
                     {"flash_attention": G, "decode_attention": 0})
        check_counts(f"{GEMMA} {label} decode", dec,
                     {"flash_attention": 0,
                      "decode_attention": cfg.n_layers * steps})
        n = attn.ring_count(cache["lpos"][0, 0])
        want = torch.clamp(torch.clamp(cur + 1, min=S), max=W)
        if fig["nonfinite_logits"] or not torch.equal(n, want):
            raise AssertionError(
                f"{GEMMA} {label}: {fig['nonfinite_logits']} non-finite "
                f"logits; ring counts {n.tolist()}, expected "
                f"{want.tolist()} (cur {cur.tolist()}, bucket {S})")
        fig.update(ring_counts=n.tolist(), launches_prefill=pre,
                   launches_decode=dec)
        log(f"families: {GEMMA} {label}: B={B} prompt {S} (logits at "
            f"{fig['logit_index']}), {steps} steps: prefill "
            f"{fig['prefill_ms']:.1f} ms, decode "
            f"{fig['decode_ms_per_step']:.2f} ms/step = "
            f"{fig['tokens_per_s']:.1f} tokens/s; launches prefill "
            f"{pre['flash_attention']} flash, decode "
            f"{dec['decode_attention']} contiguous; ring counts "
            f"{n.tolist()}")
        if label == "batch" and on_card:
            # one more step, profiled (its cache row writes land at cur + 1)
            fig["profile_decode"] = profile_model_step(
                torch, lambda: model.decode_step(params, cur.new_zeros(B),
                                                 cache, cur + 1,
                                                 impl="paged"),
                f"one {GEMMA} decode step (B={B}, context "
                f"{int(cur[0]) + 2})")
        out[label] = fig
        del cache
    if on_card:
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"families: {GEMMA}: max memory allocated "
            f"{out['max_memory_gib']:.2f} GiB")
    return out


def whisper_full(torch, kops, cfg, device="cuda") -> dict:
    """(12d) whisper-small at its full config, bf16: ``WHISPER_BATCH`` rows
    of 1500 encoder frames from a seed, a ``WHISPER_PROMPT``-token prompt,
    ``WHISPER_STEPS`` greedy paged decode steps.  Gates: no NaN logit,
    flash 12 times a prefill (the decoder's self-attention), contiguous
    decode 12 times a step."""
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import dtype_of

    model = build_model(cfg)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    B, S, steps = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS
    tokens, kw = family_inputs(
        torch, cfg, B, S, torch.Generator(device=device).manual_seed(1),
        device)
    kw = {k: v.to(dtype_of(cfg)) for k, v in kw.items()}
    cache = model.init_cache(B, S + steps + 1, device)
    fig, pre, dec, cur = decode_run(torch, kops, model, params, cache,
                                    tokens, steps=steps, device=device, **kw)
    check_counts(f"{WHISPER} prefill", pre,
                 {"flash_attention": cfg.n_layers, "decode_attention": 0})
    check_counts(f"{WHISPER} decode", dec,
                 {"flash_attention": 0,
                  "decode_attention": cfg.n_layers * steps})
    if fig["nonfinite_logits"]:
        raise AssertionError(f"{WHISPER}: {fig['nonfinite_logits']} "
                             f"non-finite logits")
    fig.update(launches_prefill=pre, launches_decode=dec)
    log(f"families: {WHISPER} full config: B={B}, {cfg.encoder_seq} frames, "
        f"prompt {S}, {steps} steps: prefill {fig['prefill_ms']:.1f} ms, "
        f"decode {fig['decode_ms_per_step']:.2f} ms/step = "
        f"{fig['tokens_per_s']:.1f} tokens/s; launches prefill "
        f"{pre['flash_attention']} flash, decode {dec['decode_attention']} "
        f"contiguous")
    if on_card:
        fig["profile_decode"] = profile_model_step(
            torch, lambda: model.decode_step(params, cur.new_zeros(B), cache,
                                             cur + 1, impl="paged"),
            f"one {WHISPER} decode step (B={B}, context {int(cur[0]) + 2})")
        fig["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"families: {WHISPER}: max memory allocated "
            f"{fig['max_memory_gib']:.2f} GiB")
    return fig


def families_phase(torch, kops, ref) -> dict:
    """Phase 12: (a) kernels at head dim 256, (b) smoke families card vs
    CPU, (c) gemma3-12b and (d) whisper-small at full configs."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    errs, rows = families_kernel_phase(torch, kops, ref)
    families_small_phase(torch)
    out = dict(kernel_errs=errs, kernel_rows=rows)
    out["gemma3"] = gemma3_full(torch, kops, get_config(GEMMA))
    gc.collect()
    torch.cuda.empty_cache()
    out["whisper"] = whisper_full(torch, kops, get_config(WHISPER))
    out["seconds"] = time.perf_counter() - t0
    log(f"families: phase 12 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: the examples and the long-context pool
# ---------------------------------------------------------------------------

def long_context_phase(torch, kops, ref, device="cuda") -> dict:
    """(13a) One long-context request through the shared pool at full
    width: minicpm3 at its published config (62 layers, 40 heads,
    latent 256 + rope 32: 288 bf16 scalars a token a layer), a bf16
    ``KVVirtualizer`` of ``LONG_PAGES`` 16 KiB pages, one request of
    ``LONG_CTX`` tokens.  Every layer's KV goes in from a dense MLA cache
    with ``write_prompt_from_cache`` (one pool write), then layer 0's
    anew with ``write_tokens``; the whole pool must equal a plain scatter
    of the same rows through ``page_table_array`` bit for bit.  The
    long_context_pooling example's float32 packed-latent call of row 1
    (head dim 256, one kv head for 40 query heads) over layer 0 within
    2e-5 of its plain version, and row 2 in bf16 over the last layer's
    ``typed_pages`` (2e-2 and the row RMS limit), each launched exactly
    once and timed beside its bound.  Then the admission burst at
    published widths (moonshot, ``FULL_WIDTH_BURST``): the shared pool
    admits more than a static third.  ``device="cpu"`` with ``LONG_*``
    made small rehearses it (launch counts stay 0 there)."""
    import numpy as np
    from repro_torch.configs import PAPER_COLOC_SET, get_config
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES, KVVirtualizer
    from repro_torch.examples import long_context_pooling as lcp
    on_card = device == "cuda"
    cfg = get_config(LONG_MODEL)
    r, rp, H, L = (cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim,
                   cfg.n_heads, cfg.n_layers)
    e = r + rp
    page_elems = DEFAULT_PAGE_BYTES // 2
    tpp = page_elems // e
    max_pages = math.ceil(LONG_CTX / tpp)
    out = dict(model=LONG_MODEL, context=LONG_CTX, page_budget=LONG_PAGES,
               tokens_per_page=tpp, pages=max_pages, layers=L)
    log(f"long context: {LONG_MODEL} published config ({L} layers, H={H}, "
        f"r={r}, rope {rp}), one request of {LONG_CTX} tokens = {L} x "
        f"{max_pages} = {L * max_pages} pages of {tpp} tokens, pool "
        f"{LONG_PAGES} pages ({LONG_PAGES * DEFAULT_PAGE_BYTES / 1e9:.2f} "
        f"GB bf16)")
    if on_card:
        torch.cuda.reset_peak_memory_stats()      # 13a's own peak
    virt = KVVirtualizer({LONG_MODEL: cfg}, page_budget=LONG_PAGES,
                         page_bytes=DEFAULT_PAGE_BYTES, device=device)
    virt.register_request(0, LONG_MODEL, prompt_tokens=LONG_CTX)
    gen = torch.Generator(device=device).manual_seed(13)
    cache = {name: torch.randn((L, 1, LONG_CTX, dim), generator=gen,
                               device=device).to(torch.bfloat16)
             for name, dim in (("latent", r), ("rope", rp))}
    rng = np.random.default_rng(0)
    kv0 = torch.from_numpy(rng.normal(size=(LONG_CTX, e))).to(torch.bfloat16)

    reset_launches(kops)
    t0 = time.perf_counter()
    virt.write_prompt_from_cache(LONG_MODEL, 0, cache, LONG_CTX)
    sync(torch, device)
    out["prompt_write_s"] = time.perf_counter() - t0
    virt.write_tokens(LONG_MODEL, 0, 0, 0, kv0)
    writes = read_launches(kops)["paged_kv_write"]
    if on_card and writes != 2:
        raise AssertionError(f"long context: {writes} pool writes, want 2 "
                             f"(one for all layers, one for layer 0)")
    out["launches_write"] = writes

    # the plain scatter: each layer's rows at (its page table, slot)
    tables = [virt.page_table_array([0], layer, max_pages=max_pages)
              for layer in range(L)]
    want_pool = torch.zeros_like(virt.pool)
    want_typed = want_pool[:, :tpp * e].view(-1, tpp, e)
    t = torch.arange(LONG_CTX, device=virt.device)
    for layer in range(L):
        rows = kv0.to(virt.device) if layer == 0 else torch.cat(
            [cache["latent"][layer, 0], cache["rope"][layer, 0]], dim=-1)
        want_typed[tables[layer][0, t // tpp].long(), t % tpp] = rows
    if not torch.equal(virt.pool, want_pool):
        bad = (virt.pool != want_pool).any(dim=1).sum().item()
        raise AssertionError(f"long context: {bad} pool pages differ from a "
                             f"plain scatter of the {L} layers' rows")
    log(f"long context: write_prompt_from_cache ({L} layers x {LONG_CTX} "
        f"tokens, one pool write) in {out['prompt_write_s']:.2f} s wall, "
        f"then write_tokens of layer 0: the pool equals a plain scatter "
        f"through page_table_array bit for bit")
    del want_pool, want_typed, cache

    typed = virt.typed_pages(LONG_MODEL)
    if typed.data_ptr() != virt.pool.data_ptr():
        raise AssertionError("typed_pages is not a view of the pool")
    lengths = torch.tensor([LONG_CTX], dtype=torch.int32, device=virt.device)

    # row 1: the example's float32 packed-latent call, over layer 0
    packed = lcp.packed_latent(typed, r)
    flat = packed.reshape(packed.shape[0], -1)
    q = torch.from_numpy(rng.normal(size=(1, 1, H, r))).float().to(
        virt.device)
    scale = r ** -0.5
    table1 = tables[0]

    def row1():
        return kops.paged_decode_attention(
            q, flat, table1, lengths, tokens_per_page=tpp, n_kv=1,
            scale=scale)
    before = kops.paged_decode_attention.launches
    got1 = row1()
    out["launches_row1"] = kops.paged_decode_attention.launches - before
    if on_card and out["launches_row1"] != 1:
        raise AssertionError("long context row 1: not launched exactly once")
    out["row1_max_abs_err"] = close_or_raise(
        torch, f"long context row 1 f32 (D={r}, G={H}, {LONG_CTX} tokens)",
        got1, ref.paged_decode_attention(q, packed, table1, lengths, scale),
        2e-5)

    # row 2 in bf16 over the last layer's typed pages
    q2 = torch.randn((1, 1, H, e), generator=gen, device=device).to(
        torch.bfloat16)
    case = Case(LONG_MODEL, "mla", tpp, page_elems, H=H, r=r, rp=rp)
    table2 = tables[L - 1]

    def row2():
        return kops.paged_mla_decode_attention(
            q2, virt.pool, table2, lengths, tokens_per_page=tpp,
            latent_dim=r, scale=case.scale)
    before = kops.paged_mla_decode_attention.launches
    got2 = row2()
    out["launches_row2"] = kops.paged_mla_decode_attention.launches - before
    if on_card and out["launches_row2"] != 1:
        raise AssertionError("long context row 2: not launched exactly once")
    want2 = ref.paged_mla_decode_attention(q2, typed, table2, lengths, r,
                                           case.scale)
    what = f"long context row 2 bf16 (layer {L - 1}, {LONG_CTX} tokens)"
    out["row2_max_abs_err"] = close_or_raise(torch, what, got2, want2, 2e-2,
                                             row_rms=BF16_ROW_RMS)
    out["row2_row_rms"] = rows_close_or_raise(what, got2, want2)

    if on_card:
        nbytes = (2 * LONG_CTX * r * 4 + q.numel() * 4 * 2
                  + max_pages * 4 + 4)
        b1, by1 = bound_ms(nbytes, 2 * H * LONG_CTX * 2 * r, fp32=True)
        rows = {"row1": dict(
            kernel="paged_decode_attention", dtype="float32",
            shape=f"{LONG_MODEL} packed latent B=1 ctx {LONG_CTX} H={H} "
                  f"KV=1 D={r} f32",
            ms=time_ms(torch, row1),
            plain_ms=time_ms(torch, lambda: ref.paged_decode_attention(
                q, packed, table1, lengths, scale)),
            bound_ms=b1, bound_by=by1)}
        k1 = packed[table1[0].long()][:, :, 0, 0].reshape(
            1, 1, -1, r)[:, :, :LONG_CTX].contiguous()
        lib1, name1, all1 = library_sdpa(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k1, k1, scale=scale, enable_gqa=True))
        rows["row1"].update(library_ms=lib1, library=name1,
                            library_all=all1)
        b2, by2 = bound(case, 1, LONG_CTX, max_pages, 2)
        lib2, name2, all2 = library_sdpa(
            torch, sdpa_call(torch, case, q2, virt.pool, table2, lengths))
        rows["row2"] = dict(
            kernel="paged_mla_decode_attention", dtype="bfloat16",
            shape=f"{LONG_MODEL} B=1 ctx {LONG_CTX} H={H} r={r} rp={rp} "
                  f"bf16",
            ms=time_ms(torch, row2),
            plain_ms=time_ms(torch, lambda: ref.paged_mla_decode_attention(
                q2, typed, table2, lengths, r, case.scale)),
            bound_ms=b2, bound_by=by2, library_ms=lib2, library=name2,
            library_all=all2)
        for key, row in rows.items():
            log(f"time long context {key} {row['shape']}: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"{row['library']} {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}); sdpa "
                f"backends {fmt_backends(row['library_all'])}")
        out["rows"] = rows
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del virt, typed, packed, flat
    gc.collect()

    models = {n: get_config(n) for n in PAPER_COLOC_SET}
    burst = lcp.admission_burst(models, **FULL_WIDTH_BURST)
    if not burst["admitted_shared"] > burst["admitted_static"]:
        raise AssertionError(f"long context burst: shared pool admitted "
                             f"{burst['admitted_shared']}, a static third "
                             f"{burst['admitted_static']}")
    kappa = models[lcp.BURST_MODEL].kv_bytes_per_token()
    log(f"long context burst at published widths: 4 x "
        f"{FULL_WIDTH_BURST['long_ctx']} tokens of {lcp.BURST_MODEL} "
        f"({kappa} B a token, {burst['need']} pages each) into "
        f"{FULL_WIDTH_BURST['total_pages']} pages: the shared pool "
        f"admits {burst['admitted_shared']}/4, a static third "
        f"({burst['static_share']} pages) {burst['admitted_static']}/4")
    out["burst"] = burst
    return out


def run_example(torch, kops, label, main, argv) -> dict:
    """One example's ``main(argv)`` on the card with every launch counter
    set to 0 just before and read just after: its wall time, launches,
    result, and its output (which must end with its ``OK`` line)."""
    import contextlib
    import io
    reset_launches(kops)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    lines = text.rstrip().splitlines()
    if not lines or not lines[-1].endswith(" OK"):
        raise AssertionError(f"example {label}: no OK line; output ends "
                             f"{lines[-5:]}")
    launches = read_launches(kops)
    log(f"example {label}: {lines[-1]} in {wall:.1f} s wall; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    for line in lines[-6:-1]:
        log(f"  {label} | {line}")
    return dict(argv=argv, wall_s=wall, launches=launches, output=text,
                result=result if isinstance(result, dict) else None,
                max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)


def examples_phase(torch, kops) -> dict:
    """(13b) The four examples on the card through their ``main`` at the
    reference's settings: quickstart for ``EXAMPLE_ARCHS``,
    serve_multi_model online + elastic with the SLO demo (its record
    replays bit for bit on the card), train_moe's 100 steps, and
    long_context_pooling.  Each quickstart must launch its prefill's and
    decode's kernels (flash, contiguous decode and paged decode for a GQA
    arch, paged MLA decode for an MLA one) and, for a MoE arch, row 5
    and its weight gradient; rows 1, 2 and 5 must each be launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import (long_context_pooling, quickstart,
                                      serve_multi_model, train_moe)
    from repro_torch.launch import replay
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    record = build / "slo_flight.json"
    record.unlink(missing_ok=True)
    out = {}
    for arch in EXAMPLE_ARCHS:
        got = run_example(torch, kops, f"quickstart {arch}", quickstart.main,
                          ["--arch", arch])
        cfg = get_smoke_config(arch)
        want = (["paged_mla_decode_attention"] if cfg.mla is not None else
                ["flash_attention", "decode_attention",
                 "paged_decode_attention"])
        if cfg.family == "moe":
            want += ["moe_gemm", "moe_gemm_wgrad"]
        missing = [n for n in want if not got["launches"][n]]
        if missing:
            raise AssertionError(f"quickstart {arch}: {missing} never "
                                 f"launched")
        out[f"quickstart {arch}"] = got
    out["serve_multi_model"] = run_example(
        torch, kops, "serve_multi_model", serve_multi_model.main,
        ["--online", "--elastic", "--slo-demo", str(record),
         "--metrics-out", str(build / "metrics.prom"),
         "--trace-out", str(build / "trace.json")])
    if not record.exists():
        raise AssertionError("serve_multi_model: the SLO demo wrote no "
                             "flight record")
    t0 = time.perf_counter()
    rc = replay.main([str(record), "-q"])
    if rc != 0:
        raise AssertionError("serve_multi_model: the SLO demo's record did "
                             "not replay bit for bit on the card")
    log(f"example serve_multi_model: flight record {record.name} "
        f"({record.stat().st_size} B) replayed BIT-EXACT on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    ckpt = build / "train_moe_ckpt"
    out["train_moe"] = run_example(torch, kops, "train_moe", train_moe.main,
                                   ["--steps", str(TRAIN_MOE_STEPS),
                                    "--ckpt-dir", str(ckpt)])
    out["long_context_pooling"] = run_example(
        torch, kops, "long_context_pooling", long_context_pooling.main, [])
    total = {k: sum(r["launches"][k] for r in out.values())
             for k in KERNELS}
    for name in ("paged_decode_attention", "paged_mla_decode_attention",
                 "moe_gemm", "moe_gemm_wgrad"):
        if not total[name]:
            raise AssertionError(f"examples: {name} was never launched")
    for name in ("moe_gemm", "moe_gemm_wgrad"):
        if not out["train_moe"]["launches"][name]:
            raise AssertionError(f"train_moe: {name} was never launched")
    if out["long_context_pooling"]["launches"]["paged_decode_attention"] \
            != 1:
        raise AssertionError("long_context_pooling: paged decode not "
                             "launched exactly once")
    out["launches"] = total
    return out


def examples_long_phase(torch, kops, ref) -> dict:
    """Phase 13: (a) the long-context pool at full width, (b) the four
    examples on the card."""
    t0 = time.perf_counter()
    out = {"long_context": long_context_phase(torch, kops, ref)}
    torch.cuda.empty_cache()
    out["examples"] = examples_phase(torch, kops)
    out["seconds"] = time.perf_counter() - t0
    log(f"examples: phase 13 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: the sharding layer (torch.distributed)
# ---------------------------------------------------------------------------

def _seeded_params(torch, model, device, seed=0):
    return model.init(torch.Generator(device=device).manual_seed(seed))


def _cell_shape(kind, seq_len, batch):
    from dataclasses import replace
    from repro_torch.configs import SHAPES_BY_NAME
    name = {"prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    return replace(SHAPES_BY_NAME[name], seq_len=seq_len, global_batch=batch)


def _decode_steps(torch, step, params, cache, tokens, lengths, steps,
                  device, forced=None, greedy=None):
    """``steps`` decode steps of ``step(params, tok, cache, lengths)``:
    greedy (``greedy(logits)``, default the argmax), or fed ``forced[i]``
    at step i (the other run's tokens).  Returns (logits per step [steps,
    B, V] float32, greedy tokens [steps, B], ms a step); the card is
    synchronised around the run."""
    logits_all, toks = [], []
    tok = tokens
    sync(torch, device)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, _ = step(params, tok, cache, lengths)
        logits_all.append(logits.float())
        toks.append((logits.argmax(-1) if greedy is None
                     else greedy(logits)).to(torch.int32))
        tok = toks[-1] if forced is None else forced[i]
        lengths = lengths + 1
    sync(torch, device)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.stack(logits_all), torch.stack(toks), ms


def _agree(torch, what, got_logits, got_toks, want_logits, want_toks):
    """Greedy tokens equal and every logit row within ``BF16_ROW_RMS``;
    returns the largest row error."""
    if not torch.equal(got_toks, want_toks):
        raise AssertionError(f"{what}: greedy tokens differ: "
                             f"{got_toks.tolist()} vs {want_toks.tolist()}")
    return rows_close_or_raise(what, got_logits, want_logits)


def sharding_one_rank(torch, kops, device="cuda", cfg=None, depth=None):
    """(14a) The sharded step on a one-rank group at published widths:
    moonshot (bf16, as many layers as ``SHARD_MEMORY_SHARE`` of the free
    memory holds), ``SHARD_BATCH`` prompts of ``SHARD_PROMPT`` tokens.
    The prefill goes through ``build_serve_cell`` under
    ``make_strategy("auto")`` (monolithic) with ``impl="flash"``, then
    ``SHARD_STEPS`` decode steps under crosspool with
    ``PerfOpts(moe_a2a=True)`` on the contiguous kernel route; the same
    params through the unsharded Model path (identity hooks) give the
    reference: greedy tokens equal (the sharded decode is fed the
    reference's tokens), logits within ``BF16_ROW_RMS``, and rows 3-4
    launched once per layer a prefill / a step in both runs.  Needs an
    initialized one-rank process group."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding.strategies import PerfOpts, make_strategy
    from repro_torch.training.tree import leaves

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or get_config(SHARD_MODEL)
    if depth is None:
        depth = _fit_depth(torch, cfg)
    cfg = cfg.replace(n_layers=depth)
    cfg_dec = cfg.replace(capacity_factor=SHARD_DECODE_CAPACITY)
    B, S, steps = SHARD_BATCH, SHARD_PROMPT, SHARD_STEPS
    T = S + steps
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = _seeded_params(torch, model, device)
    sync(torch, device)
    n_params = sum(t.numel() for t in leaves(params))
    log(f"sharding 14a: {SHARD_MODEL} published widths, {depth} of "
        f"{get_config(SHARD_MODEL).n_layers} layers ({cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params drawn in "
        f"{time.perf_counter() - t0:.1f} s), B={B} prompts of {S} tokens, "
        f"{steps} decode steps; decode capacity factor "
        f"{SHARD_DECODE_CAPACITY}")
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device, dtype=torch.int32)
    lengths = torch.full((B,), S, dtype=torch.int32, device=device)

    # the reference: the unsharded Model path, identity hooks
    cache = model.init_cache(B, T, device)
    reset_launches(kops)
    ref0, _ = model.prefill(params, tokens, cache, impl="flash")
    sync(torch, device)
    pre_ref = read_launches(kops)
    model_dec = build_model(cfg_dec)

    def unsharded(p, tok, c, lens):
        return model_dec.decode_step(p, tok, c, lens, impl="paged")
    reset_launches(kops)
    ref_logits, ref_toks, ref_ms = _decode_steps(
        torch, unsharded, params, cache, ref0.argmax(-1).to(torch.int32),
        lengths, steps, device)
    dec_ref = read_launches(kops)
    del cache

    # the sharded step on a (1, 1) mesh over the live group
    mesh = Mesh((1, 1), ("data", "model"), live=True)
    st_pre = make_strategy("auto", mesh, cfg, _cell_shape("prefill", T, B))
    st_dec = make_strategy("auto", mesh, cfg_dec,
                           _cell_shape("decode", T, B),
                           PerfOpts(moe_a2a=True))
    if (st_pre.name, st_dec.name, st_dec.a2a) != \
            ("monolithic", "crosspool", True):
        raise AssertionError(f"sharding 14a: strategies {st_pre.name} / "
                             f"{st_dec.name}, a2a {st_dec.a2a}")
    prefill = dryrun.build_serve_cell(cfg, st_pre.shape, st_pre,
                                      impl="flash")
    cache = dryrun.shard_cache(st_pre, model.init_cache(B, T, device))
    reset_launches(kops)
    got0, cache = prefill(dryrun.shard_params(st_pre, params),
                          dryrun.local_rows(st_pre, tokens), cache)
    sync(torch, device)
    pre = read_launches(kops)
    step = dryrun.build_serve_cell(cfg_dec, st_dec.shape, st_dec,
                                   impl="paged")
    reset_launches(kops)
    logits, toks, ms = _decode_steps(
        torch, step, dryrun.shard_params(st_dec, params),
        dryrun.shard_cache(st_dec, cache), got0.argmax(-1).to(torch.int32),
        dryrun.local_rows(st_dec, lengths), steps, device,
        forced=ref_toks)
    dec = read_launches(kops)
    err_pre = _agree(torch, "sharding 14a prefill", got0.float()[None],
                     got0.argmax(-1)[None], ref0.float()[None],
                     ref0.argmax(-1)[None])
    err_dec = _agree(torch, "sharding 14a decode", logits, toks, ref_logits,
                     ref_toks)
    if on_card:
        for label, got in (("unsharded prefill", pre_ref),
                           ("sharded prefill", pre)):
            check_counts(f"sharding 14a {label}", got,
                         {"flash_attention": depth, "decode_attention": 0})
        for label, got in (("unsharded decode", dec_ref),
                           ("sharded decode", dec)):
            check_counts(f"sharding 14a {label}", got,
                         {"flash_attention": 0,
                          "decode_attention": depth * steps})
    out = dict(model=SHARD_MODEL, depth=depth, params=n_params, batch=B,
               prompt=S, steps=steps, decode_capacity=SHARD_DECODE_CAPACITY,
               strategies=[st_pre.name, st_dec.name],
               decode_ms_sharded=ms, decode_ms_unsharded=ref_ms,
               max_row_rms_prefill=err_pre, max_row_rms_decode=err_dec,
               tokens=ref_toks.tolist(),
               launches_prefill_unsharded=pre_ref, launches_prefill=pre,
               launches_decode_unsharded=dec_ref, launches_decode=dec)
    log(f"sharding 14a: tokens equal over {steps} steps, logit rows within "
        f"{max(err_pre, err_dec):.3g} (limit {BF16_ROW_RMS}); decode "
        f"{ms:.2f} ms/step sharded, {ref_ms:.2f} unsharded; launches: "
        f"prefill flash {pre['flash_attention']} (unsharded "
        f"{pre_ref['flash_attention']}), decode contiguous "
        f"{dec['decode_attention']} ({dec_ref['decode_attention']})")
    return out


def _pool_shards(torch, mesh, cfg, ctx, device):
    """minicpm3's params (seed 0) and a ``ctx``-token latent / rope cache
    (seed 1) for B = 1, drawn whole on ``device`` (the same numbers in
    every process), then cut to this rank's shards under crosspool on
    ``mesh``.  Returns (strategy, params, cache)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.sharding.strategies import make_strategy
    model = build_model(cfg)
    params = _seeded_params(torch, model, device)
    gen = torch.Generator(device=device).manual_seed(1)
    cache = model.init_cache(1, ctx, device)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=device,
                               dtype=torch.float32))
    st = make_strategy("auto", mesh, cfg, _cell_shape("decode", ctx, 1))
    return st, dryrun.shard_params(st, params), dryrun.shard_cache(st, cache)


def _pool_decode(torch, st, params, cache, cfg, tok0, device, forced=None):
    """``POOL_STEPS`` decode steps of the request from ``ctx -
    POOL_STEPS`` tokens: the cache ends full."""
    from repro_torch.launch import dryrun
    step = dryrun.build_serve_cell(cfg, st.shape, st)
    lengths = torch.full((1,), st.shape.seq_len - POOL_STEPS,
                         dtype=torch.int32, device=device)
    return _decode_steps(torch, step, params, cache, tok0, lengths,
                         POOL_STEPS, device, forced=forced,
                         greedy=lambda logits: dryrun.greedy(st, logits))


def _pool_rank(rank, tmp, device, cfg, gate):
    """One of phase 14b's ranks: joins the gloo group, draws the model
    and the cache (one rank at a time, so one whole tree is alive on the
    card at once), keeps its shards, then decodes fed the one-rank run's
    tokens and writes what it measured (its logits gathered over the
    vocabulary split); with ``gate`` its greedy tokens and logit rows
    must agree with the one-rank run's."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pool_pg",
                            rank=rank, world_size=POOL_RANKS)
    ref = torch.load(f"{tmp}/pool_ref.pt")
    mesh = Mesh((1, POOL_RANKS), ("data", "model"), live=True)
    for r in range(POOL_RANKS):
        if r == rank:
            st, params, cache = _pool_shards(torch, mesh, cfg, ref["ctx"],
                                             device)
            gc.collect()                 # the whole trees go here
            if device == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    logits, toks, ms = _pool_decode(
        torch, st, params, cache, cfg, ref["tok0"].to(device), device,
        forced=ref["tokens"].to(device))
    # the whole rows from the ranks' vocabulary shards (gloo, host)
    logits = mesh.all_gather(logits.cpu(), "model", -1)
    toks = toks.cpu()
    if gate:
        _agree(torch, f"sharding 14b {cfg.dtype} rank {rank}", logits, toks,
               ref["logits"], ref["tokens"])
    out = dict(rank=rank, coord=list(mesh.coord), ms=ms,
               max_row_rms=row_error(logits, ref["logits"]),
               tokens_equal=int((toks == ref["tokens"]).sum()),
               finite=bool(torch.isfinite(logits).all()),
               seq_split=st.seq_split, kv_offset=st.hooks().kv_offset,
               param_bytes=dryrun.resident_bytes(params),
               cache_bytes=dryrun.resident_bytes(cache))
    with open(f"{tmp}/pool_rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_ranks(fn, args, n, timeout, label):
    """``fn(rank, *args)`` in ``n`` spawned processes, all of which must
    exit 0 within ``timeout`` seconds; any still alive then is killed."""
    import torch.multiprocessing as mp
    procs = mp.start_processes(fn, args=args, nprocs=n, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not procs.join(timeout=max(0.1,
                                         deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError(f"{label}: the ranks did not finish "
                                     f"in {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()


def sharding_pool(torch, tmp, cfg, device="cuda", ctx=POOL_CTX,
                  gate=True) -> dict:
    """(14b) One request's KV over the pool: minicpm3-4b at its published
    config (62 layers) in ``cfg.dtype``, one request (B = 1) whose
    ``ctx``-token latent / rope cache comes from a seeded generator,
    crosspool on a (1, ``POOL_RANKS``) mesh (Type II: the
    sequence-sharded MLA decode), ``POOL_RANKS`` processes sharing the
    card over gloo on CUDA tensors.  Each rank holds its ``ctx /
    POOL_RANKS``-token slice of the cache and its share of every param
    leaf (the serve rules: heads, vocabulary, the dense FFN).  The
    reference is the same decode at one rank on the whole
    cache (this process, its one-rank group): ``POOL_STEPS`` greedy
    steps, fed to the ranks.  Every rank must exit 0 with finite logits
    and a quarter of the one-rank run's cache bytes; with ``gate`` its
    tokens must equal the one-rank run's and its logit rows stay within
    ``BF16_ROW_RMS``, else the agreement is measured and printed.  Times
    are a one-card gloo rehearsal, not a multi-card figure.  Needs an
    initialized one-rank process group (the reference's)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    t0 = time.perf_counter()
    mesh = Mesh((1, 1), ("data", "model"), live=True)
    st, params, cache = _pool_shards(torch, mesh, cfg, ctx, device)
    tok0 = torch.randint(0, cfg.vocab_size, (1,), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(2), dtype=torch.int32)
    logits, toks, ms = _pool_decode(torch, st, params, cache, cfg, tok0,
                                    device)
    one = dict(ms=ms, param_bytes=dryrun.resident_bytes(params),
               cache_bytes=dryrun.resident_bytes(cache),
               seq_split=st.seq_split)
    torch.save(dict(ctx=ctx, tok0=tok0.cpu(), tokens=toks.cpu(),
                    logits=logits.cpu()), f"{tmp}/pool_ref.pt")
    del params, cache, logits
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    label = f"sharding 14b {cfg.dtype}"
    log(f"{label}: {POOL_MODEL} ({cfg.n_layers} layers), one request of "
        f"{ctx} tokens; one rank: {ms:.2f} ms/step, params "
        f"{one['param_bytes'] / 2**30:.3f} GiB, cache "
        f"{one['cache_bytes'] / 2**30:.3f} GiB; tokens {toks[:, 0].tolist()}")
    _spawn_ranks(_pool_rank, (tmp, device, cfg, gate), POOL_RANKS,
                 POOL_TIMEOUT, label)
    ranks = [json.loads(Path(f"{tmp}/pool_rank{r}.json").read_text())
             for r in range(POOL_RANKS)]
    for r in ranks:
        if r["cache_bytes"] * POOL_RANKS != one["cache_bytes"] \
                or not (r["seq_split"] and r["finite"]):
            raise AssertionError(f"{label} rank {r['rank']}: cache "
                                 f"{r['cache_bytes']} bytes against "
                                 f"{one['cache_bytes']} at one rank, "
                                 f"finite logits {r['finite']}")
        log(f"{label} rank {r['rank']} (coord {r['coord']}, tokens from "
            f"{r['kv_offset']}): params {r['param_bytes'] / 2**30:.3f} GiB "
            f"({r['param_bytes'] / one['param_bytes']:.3f} of one rank's),"
            f" cache {r['cache_bytes'] / 2**30:.3f} GiB (1/{POOL_RANKS}); "
            f"{r['ms']:.2f} ms/step (one-card gloo rehearsal); greedy "
            f"tokens equal to one rank's at {r['tokens_equal']} of "
            f"{POOL_STEPS} steps, logit rows within {r['max_row_rms']:.3g}")
    out = dict(model=POOL_MODEL, dtype=cfg.dtype, layers=cfg.n_layers,
               context=ctx, gate=gate, ranks=ranks, one_rank=one,
               tokens=toks[:, 0].tolist(),
               seconds=time.perf_counter() - t0)
    log(f"{label}: {POOL_RANKS} ranks exited 0 in {out['seconds']:.1f} s"
        + (", tokens equal to one rank's" if gate else ""))
    return out


# ---------------------------------------------------------------------------
# phase 15: the sharded training step
# ---------------------------------------------------------------------------

def _sharded_cfg():
    from repro_torch.configs import get_config
    return get_config(TRAIN_MODEL).replace(n_layers=TRAIN_DEPTH,
                                           dtype="float32")


def _train_cell(mesh, cfg, levers):
    """(strategy, ``build_train_cell``) for phase 15 on ``mesh``."""
    from dataclasses import replace
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch import dryrun
    from repro_torch.sharding.strategies import PerfOpts, make_strategy
    shape = replace(SHAPES_BY_NAME["train_4k"], seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH)
    st = make_strategy("train", mesh, cfg, shape, PerfOpts(
        microbatches=SHARDED_MICROBATCHES, **levers))
    return st, dryrun.build_train_cell(cfg, shape, st, moe_path="grouped")


def _train_batch(torch, cfg, device):
    gen = torch.Generator(device=device).manual_seed(3)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                                    device=device, dtype=torch.int32)}


def _fresh_state(opt, params, compress):
    from repro_torch.training.compression import init_error_feedback
    from repro_torch.training.train_step import TrainState
    return TrainState(params, opt.init(params),
                      init_error_feedback(params) if compress else None)


def _train_steps(torch, kops, step, box, batch, device):
    """``SHARDED_STEPS`` steps from the state in the one-element list
    ``box``, which is emptied: the step replaces the error-feedback tree
    (the params and moments are updated in place), and a caller that kept
    the first state would hold its tree through the run.  Launch counts
    from 0.  Returns (state, losses, grad norms, ms a step, launches)."""
    state = box.pop()
    if torch.device(device).type == "cuda":
        log(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            f"before the steps")
    reset_launches(kops)
    losses, gnorms, ms = [], [], []
    for _ in range(SHARDED_STEPS):
        sync(torch, device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))        # waits for the step
        gnorms.append(float(metrics["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    sync(torch, device)
    return state, losses, gnorms, ms, read_launches(kops)


def _train_launches(cell) -> dict:
    """Each layer's three grouped GEMMs a microbatch: forward, the
    rematerialised forward, the input gradient; and their weight
    gradients."""
    n = TRAIN_DEPTH * cell.microbatches * SHARDED_STEPS
    return {"moe_gemm": 9 * n, "moe_gemm_wgrad": 3 * n}


def _lr_bound(opt) -> float:
    """Twice the learning rate summed over the steps, + 1e-5: how far an
    element whose gradient changes sign between two runs can part in
    AdamW's first steps."""
    return 2 * sum(opt.lr * min(t / max(opt.warmup_steps, 1), 1.0)
                   for t in range(1, SHARDED_STEPS + 1)) + 1e-5


def _close_rel(what, got, want, rtol) -> float:
    worst = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
    if not worst <= rtol:
        raise AssertionError(f"{what}: {got} vs {want} (rel {worst:.3g} > "
                             f"{rtol})")
    return worst


def _median_after_first(ms):
    rest = sorted(ms[1:])
    return rest[len(rest) // 2]


def sharded_train_one_rank(torch, kops, tmp, index, device="cuda",
                           cfg=None) -> dict:
    """(15a) ``build_train_cell``'s step for ``SHARDED_VARIANTS[index]``
    on a one-rank group beside ``make_train_step``'s, from the same
    seeded params and batch: per-step loss and grad norm within 1e-5
    relative, params within the AdamW sign bound, ``moe_gemm`` /
    ``moe_gemm_wgrad`` launched exactly as ``_train_launches`` says in
    both, and the cell's peak within ``SHARDED_PEAK_SLACK_GIB`` of the
    reference's (at one rank every collective is the identity: a higher
    peak is a tree the step keeps).  The reference run's params go to
    the host before the cell's run draws its own (one state on the card
    at a time); the cell's final params and metrics are saved under
    ``tmp`` for 15b.  Needs an initialized one-rank process group."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves, leaves_with_path

    label, levers = SHARDED_VARIANTS[index]
    on_card = torch.device(device).type == "cuda"
    cfg = cfg or _sharded_cfg()
    compress = bool(levers.get("compress_grads"))
    st, cell = _train_cell(Mesh((1, 1), ("data", "model"), live=True), cfg,
                           levers)
    model = build_model(cfg)
    batch = _train_batch(torch, cfg, device)
    opt = cell.optimizer
    ref_step = make_train_step(
        model, opt, num_microbatches=cell.microbatches, compress=compress,
        remat=True, extra_inputs=lambda b: {"moe_path": "grouped"})
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state, ref_losses, ref_gnorms, ref_ms, ref_launches = _train_steps(
        torch, kops, ref_step,
        [_fresh_state(opt, _seeded_params(torch, model, device), compress)],
        batch, device)
    ref_peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    # detached: a copy of a param that requires grad keeps an autograd
    # edge to the card's tensor, and with it the whole reference run
    ref_params = [t.detach().cpu() for t in leaves(state.params)]
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    # the same draw again, cut by the train rules
    state, losses, gnorms, ms, launches = _train_steps(
        torch, kops, cell.step,
        [cell.shard_state(_fresh_state(
            opt, _seeded_params(torch, model, device), compress))],
        batch, device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    t2 = time.perf_counter()
    tag = f"sharded train 15a {label}"
    loss_rel = _close_rel(f"{tag} loss", losses, ref_losses, 1e-5)
    gnorm_rel = _close_rel(f"{tag} grad norm", gnorms, ref_gnorms, 1e-5)
    final = {"/".join(p): t.detach().cpu()
             for p, t in leaves_with_path(state.params)}
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(final.values(), ref_params))
    if not param_err <= _lr_bound(opt):
        raise AssertionError(f"{tag}: params part from make_train_step's by "
                             f"{param_err:.3g} > {_lr_bound(opt):.3g}")
    if not peak <= ref_peak + SHARDED_PEAK_SLACK_GIB:
        raise AssertionError(f"{tag}: the cell's step peaked at {peak:.2f} "
                             f"GiB, make_train_step's at {ref_peak:.2f}")
    want = _train_launches(cell)
    if on_card:
        for run, got in (("make_train_step", ref_launches),
                         ("build_train_cell", launches)):
            check_counts(f"{tag} {run}", got, want)
    torch.save(dict(losses=losses, gnorms=gnorms, params=final),
               f"{tmp}/train_ref{index}.pt")
    del state, final, ref_params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    steady = _median_after_first(ms)
    out = dict(label=label, levers=levers, microbatches=cell.microbatches,
               steps=SHARDED_STEPS, losses=losses, grad_norms=gnorms,
               ref_losses=ref_losses, ref_grad_norms=ref_gnorms,
               loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
               max_param_diff=param_err, param_bound=_lr_bound(opt),
               step_ms=ms, ref_step_ms=ref_ms, median_step_ms=steady,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
               peak_gib=peak, ref_peak_gib=ref_peak, launches=launches,
               ref_launches=ref_launches,
               argument_bytes=dryrun.argument_bytes(st),
               seconds={"reference": t1 - t0, "cell": t2 - t1,
                        "check_and_save": time.perf_counter() - t2})
    log(f"{tag}: losses {losses} (make_train_step {ref_losses}, rel "
        f"{loss_rel:.3g}), grad norms rel {gnorm_rel:.3g}, params within "
        f"{param_err:.3g}; {steady:.1f} ms/step after the first = "
        f"{out['tokens_per_s']:.0f} tokens/s (make_train_step "
        f"{_median_after_first(ref_ms):.1f}), peak {peak:.2f} GiB "
        f"({ref_peak:.2f}); launches {launches}; seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items()))
    return out


def _train_rank_run(torch, kops, tmp, mesh, cfg, index, device) -> dict:
    """One variant on one of phase 15b's ranks: draws the params (one
    rank at a time: one whole tree on the card at once) and keeps its
    shards under the train rules, runs the steps, and holds its losses,
    grad norms, shards, resident bytes and launches against 15a's."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.sharding.spec import local_slices
    from repro_torch.training.train_step import TrainState
    from repro_torch.training.tree import leaves_with_path
    label, levers = SHARDED_VARIANTS[index]
    on_card = device == "cuda"
    rank = dist.get_rank()
    t0 = time.perf_counter()
    st, cell = _train_cell(mesh, cfg, levers)
    for r in range(mesh.size):
        if r == rank:
            params = cell.shard_state(TrainState(
                _seeded_params(torch, build_model(cfg), device), None)
                ).params
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        dist.barrier()
    box = [_fresh_state(cell.optimizer, params,
                        bool(levers.get("compress_grads")))]
    del params
    batch = cell.local_batch(_train_batch(torch, cfg, device))
    resident = dryrun.resident_bytes(box[0]) + dryrun.resident_bytes(batch)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    state, losses, gnorms, ms, launches = _train_steps(
        torch, kops, cell.step, box, batch, device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    t2 = time.perf_counter()
    ref = torch.load(f"{tmp}/train_ref{index}.pt", mmap=True)
    tag = f"sharded train 15b {label} rank {rank}"
    loss_rel = _close_rel(f"{tag} loss", losses, ref["losses"], 1e-4)
    gnorm_rel = _close_rel(f"{tag} grad norm", gnorms, ref["gnorms"], 1e-4)
    specs = st.param_specs()
    param_err = 0.0
    for path, local in leaves_with_path(state.params):
        path = "/".join(path)
        whole = ref["params"][path]
        want = whole[local_slices(mesh, whole.shape, specs[path])]
        param_err = max(param_err,
                        float((local.detach().cpu() - want).abs().max()))
    bound = _lr_bound(cell.optimizer)
    if not param_err <= bound:
        raise AssertionError(f"{tag}: shards part from 15a's by "
                             f"{param_err:.3g} > {bound:.3g}")
    if resident != dryrun.argument_bytes(st):
        raise AssertionError(f"{tag}: {resident} resident bytes, the dry-run "
                             f"says {dryrun.argument_bytes(st)}")
    if on_card:
        check_counts(tag, launches, _train_launches(cell))
    del state, ref
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    steady = _median_after_first(ms)
    return dict(rank=rank, coord=list(mesh.coord), losses=losses,
                grad_norms=gnorms, loss_rel=loss_rel,
                grad_norm_rel=gnorm_rel, max_param_diff=param_err,
                param_bound=bound, step_ms=ms, median_step_ms=steady,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
                peak_gib=peak, resident_bytes=resident,
                argument_bytes=dryrun.argument_bytes(st), launches=launches,
                seconds={"setup": t1 - t0, "steps": t2 - t1,
                         "check": time.perf_counter() - t2})


def _train_rank(rank, tmp, device, cfg):
    """One of phase 15b's ranks: joins the gloo group and runs every
    variant (``_train_rank_run``) in turn."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import Mesh
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/train_pg",
                            rank=rank, world_size=math.prod(SHARDED_MESH))
    mesh = Mesh(SHARDED_MESH, ("data", "model"), live=True)
    runs = [_train_rank_run(torch, kops, tmp, mesh, cfg, i, device)
            for i in range(len(SHARDED_VARIANTS))]
    with open(f"{tmp}/train_rank{rank}.json", "w") as f:
        json.dump(runs, f)
    dist.barrier()
    dist.destroy_process_group()


def sharded_train_pool(torch, tmp, device="cuda", cfg=None) -> list:
    """(15b) Every variant's steps over ``SHARDED_MESH``, four processes
    sharing the card over gloo on CUDA tensors (spawned once for all
    variants), every leaf of params, m and v split by the train rules.
    Each rank's per-step losses and grad norms within 1e-4 relative of
    15a's, its shards within ``_lr_bound`` of the same slices of 15a's
    params, its resident bytes equal to the dry-run's per-device argument
    bytes, its launch counts exact.  The times are a one-card gloo
    rehearsal, not a multi-card figure.  Returns one entry a variant."""
    cfg = cfg or _sharded_cfg()
    n = math.prod(SHARDED_MESH)
    _spawn_ranks(_train_rank, (tmp, device, cfg), n, SHARDED_TIMEOUT,
                 "sharded train 15b")
    ranks = [json.loads(Path(f"{tmp}/train_rank{r}.json").read_text())
             for r in range(n)]
    out = []
    for index, (label, levers) in enumerate(SHARDED_VARIANTS):
        runs = [runs_r[index] for runs_r in ranks]
        for r in runs:
            log(f"sharded train 15b {label} rank {r['rank']} (coord "
                f"{r['coord']}): losses rel {r['loss_rel']:.3g}, grad norms "
                f"rel {r['grad_norm_rel']:.3g}, shards within "
                f"{r['max_param_diff']:.3g} (bound {r['param_bound']:.3g});"
                f" {r['median_step_ms']:.1f} ms/step = "
                f"{r['tokens_per_s']:.0f} tokens/s (one-card gloo "
                f"rehearsal), peak {r['peak_gib']:.2f} GiB; resident "
                f"{r['resident_bytes'] / 2**30:.3f} GiB, dry-run "
                f"{r['argument_bytes'] / 2**30:.3f} GiB; launches "
                f"{r['launches']}; seconds "
                + ", ".join(f"{k} {v:.1f}" for k, v in r["seconds"].items()))
        out.append(dict(label=label, levers=levers, mesh=list(SHARDED_MESH),
                        ranks=runs))
    return out


def sharded_train_phase(torch, kops, tmp, card) -> dict:
    """Phase 15: every variant's 15a (one rank), then 15b (four ranks,
    every variant in one spawn)."""
    t0 = time.perf_counter()
    out = {"card": card, "model": TRAIN_MODEL, "layers": TRAIN_DEPTH,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": SHARDED_STEPS,
           "microbatches": SHARDED_MICROBATCHES}
    ones = []
    for index in range(len(SHARDED_VARIANTS)):
        ones.append(sharded_train_one_rank(torch, kops, tmp, index))
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    pools = sharded_train_pool(torch, tmp)
    out["runs"] = [{"one_rank": one, "four_ranks": pool}
                   for one, pool in zip(ones, pools)]
    out["seconds_one_rank"] = t1 - t0
    out["seconds_four_ranks"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    log(f"sharded train: phase 15 took {out['seconds']:.1f} s (15a "
        f"{out['seconds_one_rank']:.1f}, 15b {out['seconds_four_ranks']:.1f};"
        f" {card})")
    return out


# ---------------------------------------------------------------------------
# phase 16: the sharded serve step
# ---------------------------------------------------------------------------

def _fit_depth(torch, cfg) -> int:
    """The most layers of ``cfg`` whose whole tree fits
    ``SHARD_MEMORY_SHARE`` of the card's free memory (phase 14a's rule)."""
    from repro_torch.launch import dryrun
    from repro_torch.training.tree import leaves
    one = dryrun.param_shapes(cfg.replace(n_layers=1))
    two = dryrun.param_shapes(cfg.replace(n_layers=2))
    nbytes = [sum(t.numel() * t.element_size() for t in leaves(p))
              for p in (one, two)]
    layer, rest = nbytes[1] - nbytes[0], 2 * nbytes[0] - nbytes[1]
    free = torch.cuda.mem_get_info()[0]
    return min(cfg.n_layers, int((free * SHARD_MEMORY_SHARE - rest) // layer))


def serve_shard_cfg(torch, run):
    """The config of one ``SERVE_SHARD_RUNS`` entry: the published config
    in the run's dtype, at its depth (None: every layer; "fit":
    ``_fit_depth`` of the run's dtype)."""
    from repro_torch.configs import get_config
    label, arch, strategy, mesh, dtype, depth = run
    cfg = get_config(arch).replace(dtype=dtype)
    if depth == "fit":
        depth = _fit_depth(torch, cfg)
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
    meta = dryrun.cache_shapes(cfg, B, T)
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
    """One of phase 16's (17b-d's) ranks: joins the gloo group and runs
    every job in turn: a serve job (``_serve_job``) through
    ``_serve_rank_run``, whose figures go to ``tmp/serve_rank{rank}.json``,
    or a train job (``_train_job``) by its config's family: whisper's
    cell (17c, ``_audio_rank_run``) or an ssm / hybrid cell (17d,
    ``_ssm_rank_run``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops as kops
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/serve_pg",
                            rank=rank, world_size=SERVE_SHARD_RANKS)
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
    dist.barrier()
    dist.destroy_process_group()


def _serve_spawn(tmp, device, jobs, sizes, label) -> list:
    """``jobs`` on ``SERVE_SHARD_RANKS`` ranks, spawned once; each rank's
    figures of the serve jobs, in order."""
    Path(f"{tmp}/serve_pg").unlink(missing_ok=True)    # an earlier spawn's
    _spawn_ranks(_serve_rank, (tmp, device, jobs, sizes), SERVE_SHARD_RANKS,
                 SERVE_SHARD_TIMEOUT, label)
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
    cfgs = cfgs or [serve_shard_cfg(torch, run) for run in runs]
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


# ---------------------------------------------------------------------------
# phase 17: the ssm, hybrid and audio archs through the sharded steps
# ---------------------------------------------------------------------------

def ssd_rank_rows(torch, kops, ssd_scan_chunked, geometries):
    """Row 6 at a rank's heads ((label, B, S, H, P, G, N, chunk)): the
    kernel against its plain version (bf16 2e-2 and the row limit), then
    both timed beside the bound (no single PyTorch call computes it)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows, err = [], 0.0

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    for label, B, S, H, P, G, N, L in geometries:
        x = randn(B, S, H, P)
        dt = torch.nn.functional.softplus(randn(B, S, H, dtype=torch.float32))
        A = -torch.exp(torch.linspace(0.0, 2.77, H, device="cuda"))
        Bm, Cm = randn(B, S, G, N), randn(B, S, G, N)
        shape = f"{label} B={B} H={H} P={P} N={N} S={S} chunk {L} bf16"
        y, _ = kops.ssd_scan(x, dt, A, Bm, Cm, chunk=L)
        wy, _ = ssd_scan_chunked(x, dt, A, Bm, Cm, chunk=L)
        err = max(err, close_or_raise(torch, f"ssd {shape}", y, wy, 2e-2,
                                      BF16_ROW_RMS))
        b_ms, b_by = ssd_bound(B, S, H, P, G, N, L)
        rows.append(dict(
            kernel="ssd_scan", shape=shape,
            ms=time_ms(torch, lambda: kops.ssd_scan(x, dt, A, Bm, Cm,
                                                    chunk=L)),
            plain_ms=time_ms(torch, lambda: ssd_scan_chunked(
                x, dt, A, Bm, Cm, chunk=L)),
            library_ms=None, library=None, bound_ms=b_ms, bound_by=b_by))
        r = rows[-1]
        log(f"time ssd_scan {shape}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
            f"none (no single PyTorch call computes it)")
    return err, rows


def audio_train_cfg():
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER).replace(dtype="float32")
    if AUDIO_TRAIN_DEPTH:
        cfg = cfg.replace(n_layers=AUDIO_TRAIN_DEPTH,
                          n_encoder_layers=AUDIO_TRAIN_DEPTH)
    return cfg


def _train_cell_of(mesh, cfg, seq, batch, levers=None):
    """(strategy, ``build_train_cell``) of a 17c / 17d / 7d cell on
    ``mesh``: ``batch`` x ``seq`` tokens, one microbatch, ``levers``."""
    from dataclasses import replace
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch import dryrun
    from repro_torch.sharding.strategies import PerfOpts, make_strategy
    shape = replace(SHAPES_BY_NAME["train_4k"], seq_len=seq,
                    global_batch=batch)
    st = make_strategy("train", mesh, cfg, shape,
                       PerfOpts(microbatches=1, **(levers or {})))
    return st, dryrun.build_train_cell(cfg, shape, st)


def _audio_cell(mesh, cfg, levers=None):
    """(strategy, ``build_train_cell``) of 17c on ``mesh``."""
    return _train_cell_of(mesh, cfg, AUDIO_TRAIN_SEQ, AUDIO_TRAIN_BATCH,
                          levers)


def _audio_batch(torch, cfg, device):
    gen = torch.Generator(device=device).manual_seed(3)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ),
                                    generator=gen, device=device,
                                    dtype=torch.int32),
            "encoder_frames": torch.randn(
                (AUDIO_TRAIN_BATCH, cfg.encoder_seq, cfg.d_model),
                generator=gen, device=device)}


def audio_train_one_rank(torch, kops, tmp, device="cuda", cfg=None) -> dict:
    """(17c, one rank) whisper's train cell over (1, 1) beside
    ``make_train_step`` from the same seeded params and batch, each
    ``SHARDED_STEPS`` steps: losses, grad norms and final params equal bit
    for bit.  The cell's final params and metrics go to
    ``tmp/audio_ref.pt`` for the ranks.  Needs a one-rank process group."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves, leaves_with_path
    cfg = cfg or audio_train_cfg()
    st, cell = _audio_cell(Mesh((1, 1), ("data", "model"), live=True), cfg)
    model = build_model(cfg)
    batch = _audio_batch(torch, cfg, device)
    opt = cell.optimizer
    ref_step = make_train_step(
        model, opt, num_microbatches=1, remat=True,
        extra_inputs=lambda b: {"encoder_frames": b["encoder_frames"]})
    t0 = time.perf_counter()
    state, ref_losses, ref_gnorms, ref_ms, _ = _train_steps(
        torch, kops, ref_step,
        [_fresh_state(opt, _seeded_params(torch, model, device), False)],
        batch, device)
    ref_params = [t.detach().cpu() for t in leaves(state.params)]
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    state, losses, gnorms, ms, launches = _train_steps(
        torch, kops, cell.step,
        [cell.shard_state(_fresh_state(
            opt, _seeded_params(torch, model, device), False))],
        batch, device)
    final = {"/".join(p): t.detach().cpu()
             for p, t in leaves_with_path(state.params)}
    tag = "sharded train 17c whisper one rank"
    equal = (losses == ref_losses and gnorms == ref_gnorms
             and all(torch.equal(a, b) for a, b in zip(final.values(),
                                                       ref_params)))
    if not equal:
        diff = max(float((a - b).abs().max())
                   for a, b in zip(final.values(), ref_params))
        raise AssertionError(f"{tag}: the cell parts from make_train_step: "
                             f"losses {losses} vs {ref_losses}, params by "
                             f"{diff:.3g}")
    torch.save(dict(losses=losses, gnorms=gnorms, params=final),
               f"{tmp}/audio_ref.pt")
    del state, final, ref_params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = dict(layers=[cfg.n_encoder_layers, cfg.n_layers],
               batch=AUDIO_TRAIN_BATCH, seq=AUDIO_TRAIN_SEQ,
               steps=SHARDED_STEPS, losses=losses, grad_norms=gnorms,
               step_ms=ms, ref_step_ms=ref_ms, launches=launches,
               seconds=time.perf_counter() - t0)
    log(f"{tag}: {cfg.n_encoder_layers} + {cfg.n_layers} layers float32, "
        f"batch {AUDIO_TRAIN_BATCH} x {AUDIO_TRAIN_SEQ} tokens over "
        f"{cfg.encoder_seq} frames: losses {losses}, grad norms {gnorms}, "
        f"params equal to make_train_step's bit for bit; step ms {ms} "
        f"(make_train_step {ref_ms})")
    return out


def ssm_cell_cfg(arch="zamba2-1.2b"):
    """7d's and 17d's configs at published widths, float32: zamba2-1.2b
    as one group of ``SSM_CELL_DEPTH`` SSM layers and the shared
    attention block, then one tail SSM layer; mamba2-130m cut to
    ``SSM_CELL_DEPTH`` layers."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(dtype="float32")
    if cfg.family == "ssm":
        return cfg.replace(n_layers=SSM_CELL_DEPTH)
    return cfg.replace(n_layers=SSM_CELL_DEPTH + 2, hybrid_groups=1,
                       ssm_per_group=SSM_CELL_DEPTH, tail_ssm_layers=1)


def _ssm_cell(mesh, cfg):
    """(strategy, ``build_train_cell``) of 7d / 17d on ``mesh``."""
    return _train_cell_of(mesh, cfg, TRAIN_SEQ, TRAIN_BATCH)


def _ssm_want(cfg) -> dict:
    """7d's and 17d's launches of the SSD kernels in ``SHARDED_STEPS``
    steps of the cell (remat)."""
    return {"ssd_scan": ssm_forwards(cfg, True) * SHARDED_STEPS,
            "ssd_scan_bwd": cfg.n_ssm_layers * SHARDED_STEPS}


def ssm_train_one_rank(torch, kops, device="cuda", cfg=None,
                       tmp=None) -> dict:
    """(7d; 17d's references) an ssm / hybrid train cell
    (``build_train_cell`` over (1, 1), remat as the cell runs it; default
    zamba2's ``ssm_cell_cfg``) beside ``make_train_step`` with remat from
    the same seeded params and ``TRAIN_BATCH`` x ``TRAIN_SEQ`` batch,
    ``SHARDED_STEPS`` steps each: losses, grad norms and final params
    equal bit for bit, and in both ``ssd_scan`` launched as
    ``ssm_forwards`` says with remat (the grouped layers twice: the
    forward and its recompute), ``ssd_scan_bwd`` once a SSM layer a
    step.  With ``tmp``, the cell's final params and metrics go to
    ``tmp/ssm_ref_<arch>.pt`` for 17d's ranks.  Needs a one-rank process
    group."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves, leaves_with_path
    cfg = cfg or ssm_cell_cfg()
    st, cell = _ssm_cell(Mesh((1, 1), ("data", "model"), live=True), cfg)
    model = build_model(cfg)
    batch = _train_batch(torch, cfg, device)
    opt = cell.optimizer
    tag = f"train 7d {cfg.name} cell one rank"
    t0 = time.perf_counter()
    runs = {}
    for label, step, shard in (
            ("make_train_step", make_train_step(model, opt, remat=True),
             lambda s: s),
            ("cell", cell.step, cell.shard_state)):
        state, losses, gnorms, ms, launches = _train_steps(
            torch, kops, step,
            [shard(_fresh_state(opt, _seeded_params(torch, model, device),
                                False))], batch, device)
        runs[label] = dict(losses=losses, gnorms=gnorms, ms=ms,
                           launches=launches,
                           params=[t.detach().cpu()
                                   for t in leaves(state.params)])
        if label == "cell" and tmp is not None:
            torch.save(dict(losses=losses, gnorms=gnorms, params={
                "/".join(p): t.detach().cpu()
                for p, t in leaves_with_path(state.params)}),
                f"{tmp}/ssm_ref_{cfg.name}.pt")
        del state
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    ref, got = runs["make_train_step"], runs["cell"]
    equal = (got["losses"] == ref["losses"] and got["gnorms"] == ref["gnorms"]
             and all(torch.equal(a, b)
                     for a, b in zip(got["params"], ref["params"])))
    if not equal:
        diff = max(float((a - b).abs().max())
                   for a, b in zip(got["params"], ref["params"]))
        raise AssertionError(f"{tag}: the cell parts from make_train_step: "
                             f"losses {got['losses']} vs {ref['losses']}, "
                             f"params by {diff:.3g}")
    want = _ssm_want(cfg)
    if torch.device(device).type == "cuda":
        for label, run in runs.items():
            seen = {k: run["launches"][k] for k in want}
            if seen != want:
                raise AssertionError(f"{tag}: {label} launched {seen}, "
                                     f"expected {want}")
    out = dict(layers=cfg.n_layers, ssm_layers=cfg.n_ssm_layers,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=SHARDED_STEPS,
               losses=got["losses"], grad_norms=got["gnorms"],
               step_ms=got["ms"], ref_step_ms=ref["ms"],
               launches=got["launches"], ref_launches=ref["launches"],
               seconds=time.perf_counter() - t0)
    log(f"{tag}: {cfg.n_layers} layers ({cfg.n_ssm_layers} SSM) float32, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses {got['losses']}, grad "
        f"norms {got['gnorms']}, params equal to make_train_step's bit for "
        f"bit; launches {got['launches']} (expected {want}); step ms "
        f"{got['ms']} (make_train_step {ref['ms']})")
    return out


def _train_job(label, cfg, mesh, ref, levers=None) -> dict:
    """A train job of 17c / 17d's ranks: ``cfg``'s cell over ``mesh``
    with ``levers``, held against the one-rank run saved as
    ``tmp/<ref>.pt``; its figures under ``label``."""
    return dict(train=cfg, label=label, mesh=mesh, ref=ref,
                levers=levers or {})


def _cell_rank_run(torch, kops, tmp, device, job, st, cell, batch,
                   want=None) -> None:
    """A train job's cell (``st``, ``cell``) on this rank: its steps on
    the rank's rows of ``batch`` from the seeded params, held against the
    one-rank run: losses and grad norms within 1e-5 relative, the shards
    within ``_lr_bound``, resident bytes equal to the dry-run's, and on
    the card the launches ``want``.  Its figures (ms a step, peak GiB,
    launches) go to ``tmp/train_rank_<label>_<rank>.json``."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.sharding.spec import local_slices
    from repro_torch.training.train_step import TrainState
    from repro_torch.training.tree import leaves_with_path
    cfg, mesh = job["train"], st.mesh
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = cell.shard_state(TrainState(
        _seeded_params(torch, build_model(cfg), device), None)).params
    gc.collect()
    box = [_fresh_state(cell.optimizer, params, False)]
    del params
    batch = cell.local_batch(batch)
    resident = dryrun.resident_bytes(box[0]) + dryrun.resident_bytes(batch)
    state, losses, gnorms, ms, launches = _train_steps(
        torch, kops, cell.step, box, batch, device)
    ref = torch.load(f"{tmp}/{job['ref']}.pt", mmap=True)
    tag = f"sharded train {job['label']} rank {mesh.rank}"
    loss_rel = _close_rel(f"{tag} loss", losses, ref["losses"], 1e-5)
    gnorm_rel = _close_rel(f"{tag} grad norm", gnorms, ref["gnorms"], 1e-5)
    specs = st.param_specs()
    err = 0.0
    for path, local in leaves_with_path(state.params):
        path = "/".join(path)
        whole = ref["params"][path]
        want_leaf = whole[local_slices(mesh, whole.shape, specs[path])]
        err = max(err, float((local.detach().cpu() - want_leaf).abs().max()))
    if not err <= _lr_bound(cell.optimizer):
        raise AssertionError(f"{tag}: shards part from the one rank's by "
                             f"{err:.3g}")
    if resident != dryrun.argument_bytes(st):
        raise AssertionError(f"{tag}: {resident} resident bytes, the dry-run "
                             f"says {dryrun.argument_bytes(st)}")
    if on_card and want is not None:
        check_counts(tag, launches, want)
    with open(f"{tmp}/train_rank_{job['label']}_{mesh.rank}.json", "w") as f:
        json.dump(dict(label=job["label"], rank=mesh.rank,
                       coord=list(mesh.coord), losses=losses,
                       loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
                       max_param_diff=err, step_ms=ms,
                       resident_bytes=resident,
                       peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                                 if on_card else 0.0),
                       launches=launches), f)
    del state, ref
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def _audio_rank_run(torch, kops, tmp, device, job) -> None:
    """17c on one of 17b's ranks (after its serve runs, in the same gloo
    group): whisper's cell over the job's mesh with its levers
    (``seq_parallel`` splits the decoder's stream), held against the
    one-rank run (``_cell_rank_run``)."""
    from repro_torch.launch.mesh import Mesh
    st, cell = _audio_cell(Mesh(job["mesh"], ("data", "model"), live=True),
                           job["train"], job["levers"])
    _cell_rank_run(torch, kops, tmp, device, job, st, cell,
                   _audio_batch(torch, job["train"], device))


def _ssm_rank_run(torch, kops, tmp, device, job) -> None:
    """17d on one of the ranks: an ssm / hybrid cell (``ssm_cell_cfg``)
    over the job's mesh, held against its one-rank run
    (``_cell_rank_run``), ``ssd_scan`` / ``ssd_scan_bwd`` launched as at
    one rank (``_ssm_want``)."""
    from repro_torch.launch.mesh import Mesh
    cfg = job["train"]
    st, cell = _ssm_cell(Mesh(job["mesh"], ("data", "model"), live=True),
                         cfg)
    _cell_rank_run(torch, kops, tmp, device, job, st, cell,
                   _train_batch(torch, cfg, device), _ssm_want(cfg))


def _family_row_limit(one) -> float:
    """17b's float32 row limit for an arch whose 17a figures are ``one``:
    the larger of ``SERVE_SHARD_ROW_RMS`` and ``FAMILY_NOISE_FACTOR``
    times its one-ulp row error."""
    return max(SERVE_SHARD_ROW_RMS,
               FAMILY_NOISE_FACTOR * one.get("ulp_noise_rows", 0.0))


def family_shard_phase(torch, kops, tmp, card, device="cuda", cfgs=None,
                       sizes=SERVE_SHARD_SIZES, train_cfg=None,
                       ssm_cfgs=None) -> dict:
    """Phase 17: the ssm, hybrid and audio archs through the sharded steps
    with every leaf placed by the rules.  (a) For each arch and dtype of
    ``cfgs`` ({(arch, dtype): config}; default the published configs) the
    Model path's prefill and decode steps (``_serve_reference``), the
    serve cell at one rank beside them, bit for bit (``_one_rank_cell``),
    and in float32 the one-ulp row error (``_ulp_noise_rows``); (b) four
    ranks (one spawn, gloo on CUDA tensors) for each of
    ``FAMILY_SHARD_MESHES``: each rank's param and cache bytes the
    rules', exact launches, in float32 every greedy id equal to (a)'s and
    every logit row within ``_family_row_limit``, in bf16
    (``FAMILY_BF16_ARCH`` only) measured; on the card, the TF32 control
    runs of ``FAMILY_CONTROL_ARCHS``, each of which must fail that limit;
    (c) whisper's train cell at one rank (bit for bit), then over
    ``AUDIO_TRAIN_MESH`` on (b)'s ranks after their serve runs, once per
    ``AUDIO_TRAIN_VARIANTS`` (plain, ``seq_parallel``); (d) the ssm and
    hybrid train cells (``ssm_cell_cfg``) at one rank (7d: bit for bit
    against ``make_train_step``), then over ``SSM_SHARD_CELLS``' meshes
    on the same ranks; each four-rank cell within 1e-5 of its one-rank
    run (``_cell_rank_run``); then the ranks' kernel geometries.
    ``cfgs``, ``sizes``, ``train_cfg`` and ``ssm_cfgs`` ({arch: config})
    rehearse it on the CPU (``device="cpu"``: launch gates, the control
    and timing are card-only).  The four-rank times are a one-card gloo
    rehearsal."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfgs = cfgs or {(a, d): get_config(a).replace(dtype=d)
                    for a in FAMILY_SHARD_ARCHS for d in FAMILY_SHARD_DTYPES}
    out = {"card": card, "sizes": dict(zip(("batch", "prompt", "steps"),
                                           sizes)), "one_rank": {},
           "runs": [], "controls": []}
    for (arch, dtype), cfg in cfgs.items():
        one, model, params, inputs, logits, toks = _serve_reference(
            torch, kops, tmp, f"17-{arch}-{dtype}", cfg, sizes, device)
        one["cell"] = _one_rank_cell(torch, kops, cfg, params, inputs, sizes,
                                     logits, toks, device)
        if dtype == "float32":
            one["ulp_noise_rows"] = _ulp_noise_rows(
                torch, model, params, inputs, sizes, logits, toks, device)
        del model, params, inputs, logits, toks
        _free(torch, device)
        out["one_rank"][f"{arch} {dtype}"] = one
        log(f"sharded serve 17a {arch} {cfg.n_layers} layers {dtype} "
            f"({one['params'] / 1e9:.4f} B params, "
            f"{one['param_bytes'] / 2**30:.4f} GiB) at one rank: draw "
            f"{one['draw_s']:.1f} s, Model path prefill "
            f"{one['prefill_ms']:.1f} ms, decode {one['decode_ms']:.2f} "
            f"ms/step; launches {_path(one['launches_prefill'])} a prefill, "
            f"{_path(one['launches_decode'])} in {sizes[2]} steps ({card})")
    train_cfg = train_cfg or audio_train_cfg()
    out["audio_train"] = dict(one_rank=audio_train_one_rank(
        torch, kops, tmp, device, train_cfg))
    # 7d and 17d's other reference: the ssm / hybrid cells at one rank
    ssm_cfgs = ssm_cfgs or {arch: ssm_cell_cfg(arch)
                            for _, arch, _ in SSM_SHARD_CELLS}
    out["ssm_cells"] = {}
    for arch, cfg in ssm_cfgs.items():
        out["ssm_cells"][arch] = dict(one_rank=ssm_train_one_rank(
            torch, kops, device, cfg, tmp))
        _free(torch, device)
    train_jobs = [
        _train_job(f"17c whisper {label}", train_cfg, AUDIO_TRAIN_MESH,
                   "audio_ref", levers)
        for label, levers in AUDIO_TRAIN_VARIANTS] + [
        _train_job(f"17d {label}", ssm_cfgs[arch], mesh,
                   f"ssm_ref_{ssm_cfgs[arch].name}")
        for label, arch, mesh in SSM_SHARD_CELLS]
    jobs = []
    for (arch, dtype), cfg in cfgs.items():
        if dtype == "float32" or arch == FAMILY_BF16_ARCH:
            for strategy, mesh in FAMILY_SHARD_MESHES:
                jobs.append(_serve_job(
                    f"17-{len(jobs)}", f"17-{arch}-{dtype}",
                    (f"17b {arch} {strategy} {dtype}", arch, strategy, mesh,
                     dtype, None), cfg))
    if torch.device(device).type == "cuda":
        strategy, mesh = FAMILY_SHARD_MESHES[1]
        for arch in FAMILY_CONTROL_ARCHS:
            jobs.append(_serve_job(
                f"17-{len(jobs)}", f"17-{arch}-float32",
                (f"17b control {arch} {strategy} float32 with TF32 matmuls",
                 arch, strategy, mesh, "float32", None),
                cfgs[arch, "float32"], tf32=True))
    t1 = time.perf_counter()
    # 17b's runs, then 17c's and 17d's cells, in one spawn
    ranks = _serve_spawn(tmp, device, jobs + train_jobs, sizes,
                         "sharded 17b-d")
    t2 = time.perf_counter()
    for i, job in enumerate(jobs):
        label, arch, strategy, mesh, dtype, _ = job["run"]
        agree = _serve_agreement(torch, tmp, job["id"], job["ref"])
        limit = _family_row_limit(out["one_rank"][f"{arch} {dtype}"])
        agree["row_limit"] = limit
        if job["tf32"]:
            # the control: a lower precision the gate must refuse
            if not agree["max_row_rms"] > limit:
                raise AssertionError(
                    f"sharded serve {label}: logit rows within "
                    f"{agree['max_row_rms']:.3g}, inside the float32 limit "
                    f"{limit:.3g}: the limit cannot tell TF32 from float32")
            log(f"sharded serve {label}: greedy ids equal to one rank's at "
                f"{agree['ids_equal']} of {agree['ids_total']}, logit rows "
                f"within {agree['max_row_rms']:.3g}: fails the float32 "
                f"limit {limit:.3g}, as it must ({card})")
            out["controls"].append(dict(label=label, arch=arch,
                                        strategy=strategy, mesh=list(mesh),
                                        **agree))
            continue
        if not agree["finite"]:
            raise AssertionError(f"sharded serve {label}: non-finite logits")
        if dtype == "float32" and (
                agree["ids_equal"] != agree["ids_total"]
                or agree["max_row_rms"] > limit):
            raise AssertionError(
                f"sharded serve {label}: greedy ids equal at "
                f"{agree['ids_equal']} of {agree['ids_total']}, logit rows "
                f"within {agree['max_row_rms']:.3g} (limit {limit:.3g})")
        rs = [r[i] for r in ranks]
        whole = out["one_rank"][f"{arch} {dtype}"]["param_bytes"]
        for r in rs:
            log(f"sharded serve {label} rank {r['rank']} (coord "
                f"{r['coord']}): params {r['param_bytes'] / 2**30:.4f} GiB "
                f"({r['param_bytes'] / whole:.3f} of the whole), cache "
                f"{r['cache_bytes'] / 2**30:.4f} GiB"
                + (f" (its slice of the sequence; k / v "
                   f"{r['seq_leaf_bytes'] / 2**30:.4f} GiB = the reference "
                   f"table's; the same rank's cache allocated with the "
                   f"sequence whole "
                   f"{r['whole_seq_cache_bytes'] / 2**30:.4f} GiB)"
                   if r["seq_split"] else "")
                + f", resident = the "
                f"rules'; prefill {r['prefill_ms']:.1f} ms, decode "
                f"{r['decode_ms']:.2f} ms/step, peak {r['peak_gib']:.2f} "
                f"GiB; launches {_path(r['launches_prefill'])} a prefill, "
                f"{_path(r['launches_decode'])} in {sizes[2]} steps ({card}; "
                f"a one-card gloo rehearsal)")
        log(f"sharded serve {label}: {job['cfg'].n_layers} layers, over "
            f"{tuple(mesh)}: greedy ids equal to one rank's at "
            f"{agree['ids_equal']} of {agree['ids_total']}, logit rows "
            f"within {agree['max_row_rms']:.3g}"
            + (f" (gated at {limit:.3g})" if dtype == "float32"
               else " (reported)"))
        out["runs"].append(dict(label=label, arch=arch, strategy=strategy,
                                mesh=list(mesh), dtype=dtype,
                                layers=job["cfg"].n_layers, ranks=rs,
                                **agree))
    for job in train_jobs:
        rs = [json.loads(Path(f"{tmp}/train_rank_{job['label']}_{r}.json")
                         .read_text())
              for r in range(math.prod(job["mesh"]))]
        if job["train"].family == "audio":
            out["audio_train"].setdefault("four_ranks", {})[
                job["label"]] = rs
        else:
            arch = job["train"].name
            out["ssm_cells"][arch].update(label=job["label"],
                                          mesh=list(job["mesh"]),
                                          four_ranks=rs)
        for r in rs:
            log(f"sharded train {job['label']} rank {r['rank']} (coord "
                f"{r['coord']}): losses {r['losses']} (rel "
                f"{r['loss_rel']:.3g} of one rank's), grad norms rel "
                f"{r['grad_norm_rel']:.3g}, shards within "
                f"{r['max_param_diff']:.3g}; resident "
                f"{r['resident_bytes'] / 2**30:.4f} GiB = the dry-run's, "
                f"peak {r['peak_gib']:.2f} GiB; step ms {r['step_ms']}; "
                f"launches ssd_scan {r['launches']['ssd_scan']}, "
                f"ssd_scan_bwd {r['launches']['ssd_scan_bwd']} ({card}; a "
                f"one-card gloo rehearsal)")
    t3 = time.perf_counter()
    if device == "cuda":
        from repro_torch.kernels import ref
        from repro_torch.kernels.ssd_chunked import ssd_scan_chunked
        from repro_torch.models.ssm import scan_chunk
        B, S, steps = sizes
        n = FAMILY_SHARD_MESHES[0][1][1]          # monolithic (1, model)
        geoms, ssd = [], []
        for (arch, dtype), cfg in cfgs.items():
            if dtype != "bfloat16":
                continue
            label = f"{arch} rank of {n}"
            if cfg.n_heads:
                H, KV = cfg.n_heads // n, cfg.n_kv_heads // n
                geoms.append((label, B, S, S + steps, [(H, KV), (H, KV)],
                              cfg.head_dim))
            if cfg.ssm is not None:
                s = cfg.ssm
                ssd.append((label, B, S, s.n_heads(cfg.d_model) // n,
                            s.head_dim, s.n_groups, s.d_state,
                            scan_chunk(S, s.chunk_size)))
        out["kernel_errs"], out["kernel_rows"] = local_heads_kernel_rows(
            torch, kops, ref, geoms)
        out["kernel_errs"]["ssd_scan"], ssd_rows = ssd_rank_rows(
            torch, kops, ssd_scan_chunked, ssd)
        out["kernel_rows"] += ssd_rows
    out["seconds"] = dict(one_rank=t1 - t0, four_ranks=t2 - t1,
                          kernels=time.perf_counter() - t3,
                          total=time.perf_counter() - t0)
    log(f"sharded families: phase 17 took {out['seconds']['total']:.1f} s "
        f"(17a, 17c and 17d's one rank {t1 - t0:.1f}, 17b-d's four ranks "
        f"{t2 - t1:.1f}, kernel rows {out['seconds']['kernels']:.1f}; "
        f"{card})")
    return out


def sharding_phase(torch, kops, card) -> dict:
    """Phase 14: (a) the sharded step at one rank over NCCL, at published
    widths; (b) one 32768-token request's KV over four ranks sharing the
    card over gloo.  Then phase 15 (the sharded training step) in the same
    one-rank NCCL group, under ``"sharded_train"``.  The kernels are built
    already (phase 2): no rank builds."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:            # a failure propagates; the group must not outlive it
            out = {"one_rank": sharding_one_rank(torch, kops)}
            gc.collect()
            torch.cuda.empty_cache()
            # the published bf16 config, measured; then the equality gate
            # in float32 (see POOL_GATE_DTYPE)
            cfg = get_config(POOL_MODEL)
            out["pool"] = sharding_pool(torch, tmp, cfg, gate=False)
            gc.collect()
            torch.cuda.empty_cache()
            out["pool_gate"] = sharding_pool(
                torch, tmp, cfg.replace(dtype=POOL_GATE_DTYPE))
            out["seconds_14"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            out["sharded_train"] = sharded_train_phase(torch, kops, tmp,
                                                       card)
            gc.collect()
            torch.cuda.empty_cache()
            out["sharded_serve"] = sharded_serve_phase(torch, kops, tmp,
                                                       card)
            gc.collect()
            torch.cuda.empty_cache()
            out["sharded_families"] = family_shard_phase(torch, kops, tmp,
                                                         card)
            gc.collect()
            torch.cuda.empty_cache()
            out["ssm_cell"] = out["sharded_families"]["ssm_cells"][
                "zamba2-1.2b"]["one_rank"]
        finally:
            dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(f"sharding: phase 14 took {out['seconds_14']:.1f} s ({card})")
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.virtualizer import DEFAULT_PAGE_BYTES, make_view
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunked import (ssd_scan_chunked,
                                                 ssd_scan_chunked_bwd)
    from repro_torch.launch.serve import FULL_WIDTH_DEPTHS, coloc_models

    t_start = time.perf_counter()
    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    seconds, last = {}, [t_start]

    def mark(phase: str) -> None:
        """Print and keep the seconds since the previous mark."""
        now = time.perf_counter()
        seconds[phase] = now - last[0]
        last[0] = now
        log(f"phase {phase}: {seconds[phase]:.1f} s ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build: every source at once
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, lib in libs.items():
        log(f"build log {src}:")
        log(lib.with_suffix(".so.log").read_text().strip())
    mark("1-2 card and build")

    # 3. kernels, at the main paths' geometries (bf16 pages of 16 KiB)
    page_elems = DEFAULT_PAGE_BYTES // 2
    cases = []
    for name, cfg in coloc_models(full_width=True).items():
        tpp = make_view(cfg, page_elems).tokens_per_page
        if cfg.attention == "mla":
            cases.append(Case(name, "mla", tpp, page_elems, H=cfg.n_heads,
                              r=cfg.mla.kv_lora_rank,
                              rp=cfg.mla.qk_rope_head_dim))
        else:
            cases.append(Case(name, "gqa", tpp, page_elems, H=cfg.n_heads,
                              KV=cfg.n_kv_heads, D=cfg.head_dim))
    errs, rows = kernel_phase(torch, kops, ref, cases)
    shared_page_phase(torch, kops, ref, cases)
    capture_check(torch, kops, cases)
    f_errs, f_rows = fallback_kernel_phase(torch, kops, ref,
                                           ssd_scan_chunked)
    b_worst, b_err, b_rows = ssd_backward_phase(torch, kops,
                                                ssd_scan_chunked_bwd)
    w_rows = kv_write_phase(torch, kops, ref)
    lse_errs, lse_rows = lse_phase(torch, kops, ref)
    mark("3 kernels")

    # 4. small models, card against CPU
    small_launches = small_phase(torch, kops)
    fallback_small_phase(torch)
    smoke_serve_phase(torch)
    train_small_phase(torch)
    graph_phase(torch)
    mark("4 small")

    # 5. serve the colocated split path
    log("serve: published widths, depths cut to "
        + ", ".join(f"{n} {d} layers" for n, d in FULL_WIDTH_DEPTHS.items()))
    launches, serve = serve_phase(
        torch, np, kops, coloc_models(full_width=True), k=SERVE_K,
        page_budget=16384, label="serve", check=check_coloc, audit=True)
    seconds["5a audit and roofline"] = serve["phase_5a_s"]
    log(f"phase 5a audit and roofline: {serve['phase_5a_s']:.1f} s, within "
        f"phase 5 ({card})")
    gc.collect()                 # request handles point back at the engine
    torch.cuda.empty_cache()

    # 5h. the same requests under the host-driven lowering, with and
    # without the layer pipeline scheduler
    host = {}
    for pipeline in (True, False):
        label = f"serve host pipeline={pipeline}"
        log(f"{label}: lowering=False, K=1")
        _, host[label] = serve_phase(
            torch, np, kops, coloc_models(full_width=True), k=1,
            page_budget=16384, label=label, check=check_coloc,
            lowering=False, pipeline=pipeline)
        gc.collect()
        torch.cuda.empty_cache()
    mark("5 serve")

    # 6. serve the dense-cache fallback path: full published configs
    log(f"serve fallback: {', '.join(FALLBACK_MODELS)} at their full "
        f"published configs, K=1")
    f_launches, f_serve = serve_phase(
        torch, np, kops, {n: get_config(n) for n in FALLBACK_MODELS}, k=1,
        page_budget=32768, label="serve fallback", check=check_fallback)
    gc.collect()
    torch.cuda.empty_cache()
    mark("6 serve fallback")

    # 7. train moonshot at published widths through the grouped MoE path
    t_launches, train, loads = train_phase(torch, np, kops)
    gc.collect()
    torch.cuda.empty_cache()

    # 7b-7c. train mamba2-130m and zamba2-1.2b at their full published
    # configs through the SSD scan kernel and its backward
    ssm_train = {}
    for name in SSM_TRAIN_BATCH:
        ssm_train[name] = ssm_train_phase(torch, kops, name)
        gc.collect()
        torch.cuda.empty_cache()
    mark("7 train")

    # 8. the grouped GEMM at phase 7's shapes and router load
    m_errs, m_rows = moe_kernel_phase(torch, np, kops, ref, loads)
    gc.collect()
    torch.cuda.empty_cache()
    mark("8 moe gemm")

    # 9. the elastic boundary: burst, moves, recaptures, forced cycle
    log(f"elastic: published widths, depths cut to FULL_WIDTH_DEPTHS, "
        f"max_ctx {ELASTIC_CTX}, K={SERVE_K}, {ELASTIC_PAGES} pages to start")
    elastic = elastic_phase(torch, np, kops, coloc_models(full_width=True),
                            card=card)
    e_launches = elastic["elastic"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    mark("9 elastic")

    # 10. the prefix cache: multi-turn conversations, cache on and off
    log(f"cache: each colocated model alone at published width, bf16, "
        f"max_ctx 1024, K={SERVE_K}: {CACHE_CONVERSATIONS} conversations "
        f"after a warm-up, {CACHE_TURNS} turns of {CACHE_PROMPT} + "
        f"{CACHE_NEW} new + {CACHE_DELTA} delta tokens")
    cache = cache_phase(torch, np, kops, coloc_models(full_width=True))
    c_launches = cache["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    mark("10 cache")

    # 11. observability and forensics on the serve configuration
    log(f"observe: phase 5's trace with the observer, recorder, sanitizer "
        f"and SLO {OBSERVE_SLO} attached, K={SERVE_K}")
    observe = observe_phase(torch, np, kops, coloc_models(full_width=True),
                            card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("11 observe")

    # 12. the dense-cache Model path: gemma3 and whisper at full configs
    families = families_phase(torch, kops, ref)
    gc.collect()
    torch.cuda.empty_cache()
    mark("12 families")

    # 13. the long-context pool at full width, then the four examples
    examples = examples_long_phase(torch, kops, ref)
    ex_launches = examples["examples"]["launches"]
    long_rows = examples["long_context"]["rows"]
    gc.collect()
    torch.cuda.empty_cache()
    mark("13 examples")

    # 14-15. the sharding layer: one rank over NCCL, then four over gloo;
    # then the sharded training step the same way
    sharding = sharding_phase(torch, kops, card)
    sh = sharding["one_rank"]
    sharded_train = sharding.pop("sharded_train")
    sharded_serve = sharding.pop("sharded_serve")
    sharded_families = sharding.pop("sharded_families")
    ssm_cell = sharding.pop("ssm_cell")
    seconds.update({
        "14 sharding": sharding["seconds_14"],
        "15 sharded train": sharded_train["seconds"],
        "16 sharded serve": sharded_serve["seconds"]["total"],
        "17 sharded families": sharded_families["seconds"]["total"]})
    for phase in ("14 sharding", "15 sharded train", "16 sharded serve",
                  "17 sharded families"):
        log(f"phase {phase}: {seconds[phase]:.1f} s ({card})")
    last[0] = time.perf_counter()

    csrc = "src/repro_torch/kernels/csrc/"
    main_shape = {"gqa": ("qwen3-moe-235b-a22b", 1024, 4),
                  "mla": ("minicpm3-4b", 1024, 4)}
    kernels = []
    for kind, name, replaces in (
            ("gqa", "paged_decode_attention",
             "src/repro/kernels/paged_attention.py:121"),
            ("mla", "paged_mla_decode_attention",
             "src/repro/kernels/paged_attention.py:225")):
        geom, ctx, B = main_shape[kind]
        row = next(r for r in rows if r["case"] == geom
                   and r["ctx"] == ctx and r["B"] == B
                   and r["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda",
            "source": csrc + "paged_attention.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_elastic": e_launches[name],
            "launches_cache": c_launches[name],
            "launches_examples": ex_launches[name],
            "max_abs_err": errs[kind], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"],
            "max_row_rms_bf16": errs[f"{kind}_row_rms"],
            "shape": f"{geom} B={B} context {ctx} bf16"})
        # phase 13a's long-context call of this kernel
        lc = examples["long_context"]
        long_row = long_rows["row1" if kind == "gqa" else "row2"]
        kernels[-1]["long_context"] = dict(
            {k: long_row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "library")},
            max_abs_err=lc["row1_max_abs_err" if kind == "gqa"
                           else "row2_max_abs_err"],
            launches=lc["launches_row1" if kind == "gqa"
                        else "launches_row2"])
        # the float32 body at the same geometry (16 KiB f32 pages), both
        # contexts, and the float32 decode step of phase 4 that runs it
        kernels[-1]["f32"] = dict(
            rows=[{k: r[k] for k in ("ctx", "B", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "library")}
                  for r in rows if r["case"] == geom
                  and r["dtype"] == "float32"],
            max_abs_err=errs[f"{kind}_float32"],
            launches_small=small_launches[name])
    for name, source, replaces, shape in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:29",
             "zamba2 B=1 S=1024 bf16"),
            ("decode_attention", "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:35",
             "zamba2 B=4 T=1024 bf16"),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:27",
             "zamba2 H=64 P=64 N=64 S=1024 chunk 256 bf16")):
        row = next(r for r in f_rows if r["kernel"] == name
                   and r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces, "launches": f_launches[name],
            "launches_examples": ex_launches[name],
            "max_abs_err": f_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row.get("library"), "shape": shape})
        if name in ("flash_attention", "decode_attention"):
            # phase 14a's runs, unsharded and sharded
            part = "prefill" if name == "flash_attention" else "decode"
            kernels[-1]["launches_sharding"] = {
                "unsharded": sh[f"launches_{part}_unsharded"][name],
                "sharded": sh[f"launches_{part}"][name]}
            # phase 16's runs: one rank, then each of the four ranks
            kernels[-1]["launches_sharded_serve"] = {
                run["label"]: {
                    "one rank": run["one_rank"][f"launches_{part}"][name],
                    "four ranks": [r[f"launches_{part}"][name]
                                   for r in run["ranks"]]}
                for run in sharded_serve["runs"]}
            kernels[-1]["local_heads"] = [
                dict(r, max_abs_err=sharded_serve["kernel_errs"][name])
                for r in sharded_serve["kernel_rows"]
                if r["kernel"] == name]
            # the float32 body: the ranks' geometries and the float32
            # serve runs' launches at one rank
            kernels[-1]["f32"] = dict(
                rows=[r for r in sharded_serve["kernel_rows"]
                      + sharded_families["kernel_rows"]
                      if r["kernel"] == name
                      and r["shape"].endswith("float32")],
                launches={run["label"]:
                          run["one_rank"][f"launches_{part}"][name]
                          for run in sharded_serve["runs"]
                          if "float32" in run["label"]})
        # phase 17's runs: each arch and dtype at one rank (the Model
        # path, the cell), then each of the four ranks; and the ranks'
        # geometries
        part = "decode" if name == "decode_attention" else "prefill"
        kernels[-1]["launches_sharded_families"] = {
            **{f"17a {key}": {"model path": one[f"launches_{part}"][name],
                              "cell": one["cell"][f"launches_{part}"][name]}
               for key, one in sharded_families["one_rank"].items()},
            **{run["label"]: [r[f"launches_{part}"][name]
                              for r in run["ranks"]]
               for run in sharded_families["runs"]}}
        kernels[-1]["rank_heads"] = [
            dict(r, max_abs_err=sharded_families["kernel_errs"][name])
            for r in sharded_families["kernel_rows"] if r["kernel"] == name]
        if name == "decode_attention":
            # the log-sum-exp output: phase 3's check and a 16b rank's
            # slice timed; its launches on every rank of each run that
            # splits the cache's sequence (phases 16-17)
            row = lse_rows[0]
            kernels[-1]["lse"] = dict(
                {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "library")},
                max_abs_err=lse_errs["lse"], max_abs_err_out=lse_errs["out"],
                rows=lse_rows, launches={
                    run["label"]: [r["launches_decode"]["decode_attention_lse"]
                                   for r in run["ranks"]]
                    for run in sharded_serve["runs"]
                    + sharded_families["runs"]
                    if run["ranks"][0]["seq_split"]})
        if name in families["kernel_errs"]:
            # phase 12's shapes at head dim 256 and its launches
            g, w = families["gemma3"], families["whisper"]
            kernels[-1]["head_dim_256"] = [
                dict(shape=r["shape"], ms=r["ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=r["library_ms"], library=r["library"],
                     max_abs_err=families["kernel_errs"][name])
                for r in families["kernel_rows"] if r["kernel"] == name]
            kernels[-1]["launches_families"] = {
                f"{GEMMA} {label} {part}": g[label][f"launches_{part}"][name]
                for label, *_ in GEMMA_RUNS
                for part in ("prefill", "decode")}
            kernels[-1]["launches_families"].update({
                f"{WHISPER} {part}": w[f"launches_{part}"][name]
                for part in ("prefill", "decode")})
        if name == "ssd_scan":
            # phases 7b-7d: the train path's forwards, timed in float32
            kernels[-1]["train_rows"] = [
                r for r in f_rows if r["kernel"] == name
                and r["shape"].endswith("(train shape)")]
            kernels[-1]["launches_train"] = {
                **{f"7b-7c {m}": t["launches"][name]
                   for m, t in ssm_train.items()},
                "7d cell": ssm_cell["launches"][name]}
    # row 6b: the SSD scan's backward, at the train path's shape
    row = b_rows[0]
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": csrc + "ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_chunked.py:41 (jax.vjp of the "
                    "XLA route's chunked form, the reference's training "
                    "path; the Pallas _ssd_kernel at ssd_scan.py:27 has no "
                    "backward)",
        "launches": sum(t["launches"]["ssd_scan_bwd"]
                        for t in ssm_train.values()),
        "launches_train": {
            **{f"7b-7c {m}": t["launches"]["ssd_scan_bwd"]
               for m, t in ssm_train.items()},
            "7d cell": ssm_cell["launches"]["ssd_scan_bwd"]},
        "max_abs_err": b_err, "max_err_over_scale": b_worst,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "library": None, "shape": row["shape"],
        "rows": b_rows})
    w_row = next(r for r in w_rows if r["shape"] == "qwen3-moe decode B=4")
    kernels.append({
        "name": "paged_kv_write", "route": "cuda",
        "source": csrc + "kv_write.cu",
        "replaces": "src/repro/kernels/ops.py:79 (an XLA scatter, no "
                    "Pallas kernel)",
        "launches": launches["paged_kv_write"],
        "launches_elastic": e_launches["paged_kv_write"],
        "launches_cache": c_launches["paged_kv_write"],
        "launches_examples": ex_launches["paged_kv_write"],
        "max_abs_err": 0.0,
        "ms": w_row["ms"], "plain_ms": w_row["plain_ms"],
        "bound_ms": w_row["bound_ms"], "bound_by": w_row["bound_by"],
        "library_ms": None, "library": None,
        "shape": "qwen3-moe decode B=4 rows of 2 x 4 x 128 bf16"})
    train_shape = next(r["shape"] for r in m_rows
                       if r["dtype"] == "float32")
    for name in ("moe_gemm", "moe_gemm_wgrad"):       # wgrad: its gradient
        row = next(r for r in m_rows if r["kernel"] == name
                   and r["shape"] == train_shape
                   and r["load"] == "gate/up layer 0")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "moe_gemm.cu",
            "replaces": "src/repro/kernels/moe_gemm.py:23",
            "launches": t_launches[name],
            "launches_examples": ex_launches[name],
            "launches_sharded_train": {
                f"{run['one_rank']['label']} {part}": counts
                for run in sharded_train["runs"]
                for part, counts in (
                    ("one rank", run["one_rank"]["launches"][name]),
                    ("four ranks", [r["launches"][name] for r in
                                    run["four_ranks"]["ranks"]]))},
            "max_abs_err": m_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": "torch._grouped_mm" if row["library_ms"] else None,
            "shape": train_shape})
        if name == "moe_gemm_wgrad":
            sk = next(r for r in m_rows if r["kernel"] == name
                      and r["shape"] == train_shape
                      and r["load"] == "gate/up skewed load")
            kernels[-1]["skewed_load"] = {k: sk[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card,
         "kernel_times": rows + f_rows + b_rows + m_rows + w_rows
         + lse_rows, "phase_seconds": seconds,
         "kernels": kernels, "serve": serve, "serve_host": host,
         "serve_fallback": f_serve, "train": train, "train_ssm": ssm_train,
         "ssm_cell": ssm_cell, "elastic": elastic,
         "cache": cache, "observe": observe, "families": families,
         "examples": examples, "sharding": sharding,
         "sharded_train": sharded_train, "sharded_serve": sharded_serve,
         "sharded_families": sharded_families},
        indent=1, default=str))
    mark("json")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in seconds.items()))
    log(f"chip_smoke: all 17 phases in {time.perf_counter() - t_start:.1f} "
        f"s ({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
