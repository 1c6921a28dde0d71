"""What the phases of ``chip_smoke.py`` share: the card's peaks, the run's
state (``Run``), launch counts, bounds, timing and the row checks."""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's published peaks, kept in one place with their sources
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOPS,
    PEAK_FLOPS_F32 as FP32_FLOPS, PEAK_FLOPS_TF32 as TF32_FLOPS)


class Run:
    """What the phases share in one run: the modules they take, the
    card's name and power limit, each phase's results (``out[n]``), the
    seconds printed beside the phases' own and, once phase 14, 15, 16 or
    17 opens it, the one-rank NCCL group's directory (``open_group``)."""

    def __init__(self, torch, np, kops, ref, card: str):
        self.torch, self.np, self.kops, self.ref = torch, np, kops, ref
        self.card = card
        self.out: dict = {}
        self.seconds: dict = {}
        self.group = None


#: the run's pool of four rank processes (``RankPool``) under "ranks",
#: from ``open_group`` to ``close_group``
POOL: dict = {}


def open_group(run: Run) -> str:
    """The directory of the one-rank NCCL group phases 14-17 run in,
    made and joined at the first call, and the four rank processes their
    four-rank runs share (``RankPool``, started at its first job; the
    kernels are built already: no rank builds); ``close_group`` ends
    both."""
    if run.group is None:
        import tempfile
        import torch.distributed as dist
        run.group = tempfile.mkdtemp(prefix="chip_smoke_pg")
        dist.init_process_group("nccl", init_method=f"file://{run.group}/pg",
                                rank=0, world_size=1)
        POOL["ranks"] = RankPool(4, run.group, "cuda")
    return run.group


def close_group(run: Run) -> None:
    if run.group is not None:
        import shutil
        import torch.distributed as dist
        t0 = time.perf_counter()
        POOL.pop("ranks").close()
        t1 = time.perf_counter()
        dist.destroy_process_group()
        shutil.rmtree(run.group, ignore_errors=True)
        run.group = None
        log(f"close: the rank processes in {t1 - t0:.1f} s, the one-rank "
            f"group in {time.perf_counter() - t1:.1f} s")


#: the attention kernels (rows 1-4) in bf16: the limit on each output
#: row's relative RMS error against the plain version (a correct kernel
#: differs by the rounding of its bf16 probabilities and output, ~3e-3)
BF16_ROW_RMS = 1e-2
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
BURST_MODEL = "minicpm3-4b"
#: phase 12: the families' models, gemma3's runs (label, batch, prompt
#: bucket, decode steps, logit index: None = the bucket's last) and
#: context, whisper's batch, prompt and steps
GEMMA, WHISPER = "gemma3-12b", "whisper-small"
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_CTX = 4, 2048, 4096
GEMMA_RUNS = (("batch", GEMMA_BATCH, GEMMA_PROMPT, 64, None),
              ("crossing", 1, 1000, 48, None),
              ("pad quirk", 1, 512, 16, 300))
#: the steps of every train cell of phases 15 and 17 (one rank and four):
#: a four-rank step stages its FSDP gathers through gloo's host memory
#: (~16 s a step of phase 15's cell on one card), and
#: the first step's losses, gradient norms and updated shards carry every
#: gate
SHARDED_STEPS = 1
#: phase 16: the sharded serve step with every param leaf placed by the
#: serving rules, (label, arch, strategy, (data, model), dtype, depth:
#: None = the published depth, or a number of layers: each float32 run at
#: the depth phase 14a's rule fits on an 80 GB card with nothing else on
#: it, qwen3-14b 18 of 40 layers, moonshot 12 of 48 (the rule read at run
#: time would also count the rank processes kept for phases 14-17), and
#: the bf16 run above it, which measures only, at the same depth);
#: each float32 run is the equality gate of the bf16 run above it (in
#: bf16 the four ranks' partial sums round in another order than one
#: rank's: PERF.md on phase 14b)
SERVE_SHARD_RUNS = (
    ("16a bf16", "qwen3-14b", "monolithic", (1, 4), "bfloat16", 18),
    ("16a float32", "qwen3-14b", "monolithic", (1, 4), "float32", 18),
    ("16b bf16", "moonshot-v1-16b-a3b", "crosspool", (2, 2), "bfloat16",
     12),
    ("16b float32", "moonshot-v1-16b-a3b", "crosspool", (2, 2), "float32",
     12))
#: phases 16's and 17's (prompts, prompt tokens, decode steps: each
#: four-rank step is a gloo round trip a layer), and the float32
#: gate's limit on a logit row's relative RMS error against the one-rank
#: run
SERVE_SHARD_SIZES = (4, 512, 4)
SERVE_SHARD_ROW_RMS = 1e-4


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


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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


def check_counts(label, got, want) -> None:
    for name, n in want.items():
        if got[name] != n:
            raise AssertionError(f"{label}: {name} launched {got[name]} "
                                 f"times, expected {n}")


def _rank_loop(rank, n, rendezvous, device, jobs, done):
    """A rank of ``RankPool``: joins the ``n``-rank gloo group at
    ``rendezvous`` once (on the card every rank shares, or the CPU; one
    host thread), then runs each job ``(fn, args)`` it is sent as
    ``fn(rank, *args)`` until it is sent None, and reports each job's
    end (a traceback if it raised)."""
    import traceback
    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=n)
    for fn, args in iter(jobs.get, None):
        try:
            fn(rank, *args)
            dist.barrier()
        except BaseException:
            done.put((rank, traceback.format_exc()))
            raise
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        done.put((rank, None))
    dist.destroy_process_group()


class RankPool:
    """``n`` rank processes sharing the card over one gloo group, started
    at the first job and kept for every job of phases 14-17 (each start of
    four processes costs their imports, CUDA contexts and first launches:
    ~13 s on the card).  ``run`` sends a job to every rank and waits for
    all of them; a failure or a timeout kills them all."""

    def __init__(self, n: int, tmp: str, device: str):
        self.n, self.tmp, self.device = n, tmp, device
        self.procs: list = []

    def _start(self) -> None:
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.jobs = [ctx.SimpleQueue() for _ in range(self.n)]
        self.done = ctx.SimpleQueue()
        rendezvous = f"{self.tmp}/ranks_pg{time.monotonic_ns()}"
        self.procs = [ctx.Process(target=_rank_loop, args=(
            r, self.n, rendezvous, self.device, self.jobs[r], self.done))
            for r in range(self.n)]
        for p in self.procs:
            p.start()

    def run(self, fn, args, timeout: float, label: str) -> None:
        if not self.procs:
            self._start()
        for q in self.jobs:
            q.put((fn, args))
        deadline = time.monotonic() + timeout
        left = self.n
        while left:
            if not self.done.empty():
                rank, err = self.done.get()
                if err is not None:
                    self.kill()
                    raise AssertionError(f"{label}: rank {rank} raised\n"
                                         f"{err}")
                left -= 1
            elif not all(p.is_alive() for p in self.procs):
                self.kill()
                raise AssertionError(f"{label}: a rank process died")
            elif time.monotonic() > deadline:
                self.kill()
                raise AssertionError(f"{label}: the ranks did not finish "
                                     f"in {timeout} s")
            else:
                time.sleep(0.05)

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        self.procs = []

    def close(self, timeout: float = 60) -> None:
        if not self.procs:
            return
        for q in self.jobs:
            q.put(None)
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.1, deadline - time.monotonic()))
        self.kill()


def _spawn_ranks(fn, args, n, timeout, label, device="cuda"):
    """``fn(rank, *args)`` on ``n`` ranks of a gloo group on ``device``
    (``args[0]``: a directory for its rendezvous), all of which must end
    within ``timeout`` seconds: on the run's ``RankPool`` where
    ``open_group`` made one of ``n`` ranks, else on a pool started for
    this job and closed after it."""
    pool = POOL.get("ranks")
    if pool is not None and (pool.n, pool.device) == (n, device):
        return pool.run(fn, args, timeout, label)
    pool = RankPool(n, args[0], device)
    try:
        pool.run(fn, args, timeout, label)
    finally:
        pool.close()

