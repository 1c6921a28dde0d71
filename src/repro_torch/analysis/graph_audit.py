"""Structural audit of the fused decode bodies and their CUDA graphs.

Port of ``src/repro/analysis/jaxpr_audit.py``.  The lint
(``repro_torch.analysis.lint``) checks what the source says; this audit
checks what a fused step's body does when it runs.  The reference traces
the step to a jaxpr and reads the compiled HLO; the port runs the body
once, eagerly, under a ``TorchDispatchMode`` that sees every tensor op,
with a recorder attached to the kernel wrappers (``kernels/build.py``
``recorded``): a dispatch mode does not see the ctypes launches, and the
wrappers count ``launches`` only on the card, so the recorder sees each
wrapper call and its tensor arguments on both routes.

Checks (each finding carries its CPAxx id):

  CPA01  a tensor of at least ``max_const_bytes`` that the body reads but
         was not given: the body may read the pool, the arena, the slot
         table, its static inputs and the leaves of ``pooled.kv_params``;
         anything else is a weight or pool copy held by closure, which a
         captured graph bakes in by address.
  CPA02  the pool is not updated in place: a pool write
         (``paged_kv_write``) or a paged attention read lands on a tensor
         that is not the pool given, or the body makes a tensor of the
         pool's shape and dtype (a second pool: an out-of-place update or
         a copy).  Size alone cannot tell: at published widths one
         layer's arena gather is larger than the pool.
  CPA03  a host read inside the body: on the CPU the ops that read a
         device value to the host on a card (``aten._local_scalar_dense``,
         ``nonzero``, boolean-mask indexing, ``unique`` and the like;
         inside a kernel wrapper's plain route they are the yardstick's,
         not the body's, and so are those made while ``F.one_hot`` runs
         on a CPU tensor (its value check reads a minimum and a maximum
         there, and on the CPU only); on the card also
         any synchronisation, caught by
         ``torch.cuda.set_sync_debug_mode("error")``.
  CPA04  the dispatch claim fails: ``control.dispatch_count(...,
         fused=True)`` must be one replay per K-token block, and one body
         must call the paged GQA (or MLA) wrapper K x attention layers
         and ``paged_kv_write`` K x layers times (a captured graph's
         ``launches_per_replay`` too, on the card).

The audit runs the body on inactive inputs by default (every table
entry -1, lengths 0: the capture's warm-up inputs), so the pool and the
model's state are left as they were.

CLI (the smoke MoE model of ``PAPER_COLOC_SET``, float32, the one-token
and the K-token step, as the reference's fixture)::

    python -m repro_torch.analysis.graph_audit [--k 4] [-v]
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import build
from repro_torch.launch.op_analysis import _Counter, _nbytes
from repro_torch.training.tree import leaves

CHECKS = {
    "CPA01": "pool/arena/weight-sized tensor read by closure",
    "CPA02": "pool not updated in place (a copy or a second pool)",
    "CPA03": "host read inside a fused body",
    "CPA04": "calls per replay contradict the dispatch-count claim",
}

#: Tensors this large can only be pool/arena/weight data; what a body
#: legitimately holds by closure (a counter, a small constant) stays well
#: under it.
DEFAULT_MAX_CONST_BYTES = 64 * 1024

#: aten ops that read a device value back to the host on a card
_HOST_READ_OPS = {"_local_scalar_dense", "nonzero", "masked_select",
                  "unique", "_unique", "_unique2", "unique_dim",
                  "unique_consecutive", "unique_dim_consecutive", "equal",
                  "is_nonzero", "bincount", "repeat_interleave", "item"}
_POOL_READERS = ("paged_decode_attention", "paged_mla_decode_attention")


@dataclass(frozen=True)
class AuditFinding:
    check: str                 # CPAxx
    target: str                # which step
    message: str

    def __str__(self) -> str:
        return f"{self.target}: {self.check} {self.message}"


def _key(t: torch.Tensor) -> Tuple:
    """One storage: its device and address (an empty storage: none)."""
    s = t.untyped_storage()
    return (t.device, s.data_ptr()) if s.nbytes() else None


class _OneHotChecks(TorchFunctionMode):
    """Marks the run of ``F.one_hot`` on a CPU tensor: there it reads its
    input's minimum and maximum to the host (its value check); on a card
    it does not (the scatter's device asserts check instead), so those
    reads are not the body's."""

    def __init__(self, watch: "_Watch"):
        super().__init__()
        self.watch = watch

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.one_hot or args[0].device.type != "cpu":
            return func(*args, **kwargs)
        self.watch._in_one_hot += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.watch._in_one_hot -= 1


def _bool_index(func, args) -> bool:
    """``x[mask]`` reaches the dispatcher as ``aten.index`` with a boolean
    index: its output's size is data, read on the host."""
    if func.__name__.split(".")[0] not in ("index", "index_put",
                                            "index_put_"):
        return False
    return any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in tree_leaves(args[1:2]))


class _Watch(_Counter):
    """What one body run reads, makes and syncs on, and the wrapper calls
    (the recorder); the op analysis's counter keeps the body's own bytes
    (``peak``).  An op's output on a storage none of its inputs is on the
    body made; a storage read that the body did not make existed before
    it (given, or held by closure: ``foreign`` when not ``allowed``)."""

    def __init__(self, allowed, pool: torch.Tensor):
        super().__init__()
        self.allowed = allowed
        self.pool_shape = (tuple(pool.shape), pool.dtype)
        self.made = set()
        self.foreign: Dict[Tuple, int] = {}        # storage -> bytes
        self.largest = 0                            # one allocation
        self.host_reads: List[str] = []
        self.pool_like: List[str] = []
        self.calls: Dict[str, int] = {}
        self.call_args: List[Tuple[str, List[torch.Tensor]]] = []
        self._in_kernel = 0
        self._in_one_hot = 0

    def _read(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key is None or key in self.made:
            return
        if key not in self.allowed:
            self.foreign[key] = t.untyped_storage().nbytes()

    @contextlib.contextmanager
    def kernel(self, name, args, kwargs):
        tensors = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        for t in tensors:
            self._read(t)
        self.calls[name] = self.calls.get(name, 0) + 1
        self.call_args.append((name, tensors))
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if not (self._in_kernel or self._in_one_hot) \
                and (name in _HOST_READ_OPS or _bool_index(func, args)):
            self.host_reads.append(func.__name__)
        ins = [t for t in tree_leaves((args, kwargs or {}))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            self._read(t)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        aliased = {_key(t) for t in ins}
        for t in tree_leaves(out):
            key = _key(t) if isinstance(t, torch.Tensor) else None
            if key is None or key in aliased or key in self.made:
                continue
            self.made.add(key)
            self.largest = max(self.largest, _nbytes(t))
            if (tuple(t.shape), t.dtype) == self.pool_shape:
                self.pool_like.append(func.__name__)
        return out


def _steps_of(step) -> int:
    return getattr(step, "k", 1)


def audit_fused_step(step, pool: torch.Tensor, *,
                     inputs: Optional[Dict[str, torch.Tensor]] = None,
                     batch: Optional[int] = None,
                     max_pages: Optional[int] = None, target: str = "step",
                     max_const_bytes: int = DEFAULT_MAX_CONST_BYTES
                     ) -> Tuple[List[AuditFinding], Dict]:
    """Audit one fused step (``PagedFusedStep`` / ``MultiStepFusedStep``)
    over ``pool``: run its body once under the watch (on the card also
    under ``set_sync_debug_mode("error")``) and check CPA01-CPA04.
    ``inputs`` are the body's static inputs; by default the inactive ones
    of ``batch`` rows and ``max_pages`` table columns (the captured
    graph's, when the step has one).  Returns (findings, figures): the
    largest foreign read, the body's largest allocation and its peak of
    its own bytes beside the pool's and the arena's bytes, the host
    reads, and the calls per body (and per replay) against the claim."""
    from repro_torch.core.control import dispatch_count

    pooled = step.pooled
    cfg, name = pooled.cfg, pooled.cfg.name
    abuf, table = pooled.arena.acquire(name)
    if inputs is None:
        if step.graph is not None:
            _, batch, max_pages = step.graph.static["page_tables"].shape
        inputs = step.inactive_inputs(batch, max_pages, pool.device)
    given = [pool, abuf, table, *inputs.values(), *leaves(pooled.kv_params)]
    if step.nonfinite_logits is not None:
        given.append(step.nonfinite_logits)
    saved = (None if step.nonfinite_logits is None
             else step.nonfinite_logits.clone())
    watch = _Watch({_key(t) for t in given} - {None}, pool)
    findings: List[AuditFinding] = []
    on_card = pool.device.type == "cuda"
    sync_error = None
    try:
        if on_card:
            torch.cuda.synchronize(pool.device)
            torch.cuda.set_sync_debug_mode("error")
        with build.recording(watch), watch, _OneHotChecks(watch):
            step.body(pool, abuf, table, **inputs)
    except RuntimeError as e:
        if not (on_card and "synchroniz" in str(e)):
            raise
        sync_error = str(e).splitlines()[0]
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    if on_card:
        torch.cuda.synchronize(pool.device)
    if saved is not None:
        step.nonfinite_logits.copy_(saved)

    # CPA01: what the body reads that it was not given and did not make
    foreign = watch.foreign
    worst = max(foreign.values(), default=0)
    big = sorted(n for n in foreign.values() if n >= max_const_bytes)
    if big:
        findings.append(AuditFinding(
            "CPA01", target,
            f"{len(big)} tensor(s) of {big[-1]} bytes at most read by "
            f"closure (limit {max_const_bytes}): a captured graph bakes "
            f"them in by address; pass them in"))

    # CPA02: writes and paged reads on the pool itself, no second pool
    pool_key = _key(pool)
    astray = [n for n, ts in watch.call_args
              if n in _POOL_READERS + ("paged_kv_write",)
              and _key(ts[0] if n == "paged_kv_write" else ts[1])
              != pool_key]
    if astray or watch.pool_like:
        what = []
        if astray:
            what.append(f"{len(astray)} pool call(s) on another tensor "
                        f"({sorted(set(astray))})")
        if watch.pool_like:
            what.append(f"{len(watch.pool_like)} tensor(s) of the pool's "
                        f"shape made ({sorted(set(watch.pool_like))})")
        findings.append(AuditFinding(
            "CPA02", target,
            "the pool is not updated in place: " + "; ".join(what)))

    # CPA03: host reads
    host = list(watch.host_reads)
    if sync_error is not None:
        host.append(f"sync: {sync_error}")
    if host:
        findings.append(AuditFinding(
            "CPA03", target,
            f"{len(host)} host read(s) inside the body: "
            f"{sorted(set(host))[:4]} — a decode body never reads the "
            f"device"))

    # CPA04: one replay a block, the wrapper calls of its structure
    k = _steps_of(step)
    attn = ("paged_mla_decode_attention" if cfg.attention == "mla"
            else "paged_decode_attention")
    claim = {attn: k * pooled.view.n_kv_layers,
             "paged_kv_write": k * cfg.n_layers}
    got = {n: watch.calls.get(n, 0) for n in claim}
    replay = (None if step.graph is None else
              {n: step.graph.launches_per_replay.get(n, 0) for n in claim})
    dispatches = dispatch_count(cfg.n_layers, True, k)
    if sync_error is None and (dispatches != 1 or got != claim
                               or replay not in (None, claim)):
        findings.append(AuditFinding(
            "CPA04", target,
            f"{dispatches} dispatch(es) a block; calls per body {got}"
            + ("" if replay is None else f", per replay {replay}")
            + f" against the claim {claim}"))

    figures = dict(
        largest_foreign_read=worst, foreign_reads=len(foreign),
        largest_allocation=watch.largest, own_peak_bytes=watch.peak,
        pool_bytes=_nbytes(pool), arena_bytes=_nbytes(abuf),
        host_reads=len(host), dispatches_per_block=dispatches,
        calls_per_body=dict(watch.calls), calls_per_replay=replay,
        claim=claim)
    return findings, figures


def planted(step, check: str):
    """A copy of ``step`` whose body breaks ``check`` (the audit's own
    test): CPA01 reads a 64 KiB tensor held by closure, CPA02 clones the
    pool and writes the clone, CPA03 reads a token to the host, CPA04
    runs the body twice (two blocks' calls in one replay)."""
    base = type(step)
    extra = torch.ones(DEFAULT_MAX_CONST_BYTES // 4, dtype=torch.float32,
                       device=step.pooled.arena.arena.device)

    class Planted(base):
        def body(self, pool, arena, slot_table, **inputs):
            if check == "CPA01":
                extra.sum()
            elif check == "CPA02":
                pool = pool.clone()
            elif check == "CPA03":
                inputs["tokens"].sum().item()
            elif check == "CPA04":
                super().body(pool, arena, slot_table, **inputs)
            return super().body(pool, arena, slot_table, **inputs)

    out = copy.copy(step)
    out.__class__ = Planted
    out.graph = None
    return out


# ---------------------------------------------------------------------------
# CLI fixture: the smoke-scale MoE colocation cell
# ---------------------------------------------------------------------------

def smoke_fixture(k: int = 4, *, batch: int = 2, seq: int = 8,
                  device="cpu"):
    """The reference's fixture (``jaxpr_audit.py:185``): the smoke MoE
    model of ``PAPER_COLOC_SET`` in float32, pools of 256 pages of 4 KiB,
    ``batch`` requests of ``seq`` tokens with a decode block of ``k``
    reserved.  Returns (the virtualizer, {step name: (step, inputs)})."""
    import math

    from repro_torch.configs import PAPER_COLOC_SET, get_smoke_config
    from repro_torch.core.control import MultiStepFusedStep, PagedFusedStep
    from repro_torch.core.pools import build_pools
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.sampler import sample

    name = next(n for n in PAPER_COLOC_SET if get_smoke_config(n).is_moe)
    cfg = get_smoke_config(name).replace(dtype="float32")
    params = {name: init_params(torch.Generator().manual_seed(0), cfg)}
    kv_pool, _, pooled = build_pools({name: cfg}, params, device=device,
                                     page_budget=256, page_bytes=4096,
                                     pool_dtype=torch.float32)
    virt = kv_pool.virtualizer
    for b in range(batch):
        virt.register_request(b, name, seq)
        virt.reserve_decode_block(b, max(k, 1))
    max_pages = max(1, math.ceil((seq + k) / virt.views[name].tokens_per_page))
    i32 = dict(dtype=torch.int32, device=device)
    inputs = dict(tokens=torch.zeros(batch, **i32),
                  page_tables=virt.batch_tables(name, list(range(batch)),
                                                max_pages).to(device),
                  lengths=torch.full((batch,), seq, **i32))
    steps = {"PagedFusedStep": (PagedFusedStep(pooled[name],
                                               postprocess=sample), inputs)}
    if k > 1:
        steps[f"MultiStepFusedStep(k={k})"] = (
            MultiStepFusedStep(pooled[name], k=k),
            dict(inputs, steps_left=torch.full((batch,), k, **i32),
                 eos_ids=torch.full((batch,), -1, **i32)))
    return virt, steps


def build_and_audit(k: int = 4, *, batch: int = 2, seq: int = 8,
                    verbose: bool = False) -> List[AuditFinding]:
    """Build the smoke MoE model's fused steps and audit both: the
    one-token step and the K-token step."""
    virt, steps = smoke_fixture(k, batch=batch, seq=seq)
    findings: List[AuditFinding] = []
    for target, (step, inputs) in steps.items():
        found, figures = audit_fused_step(step, virt.pool, inputs=inputs,
                                          target=target)
        findings += found
        if verbose:
            print(f"{target}: {figures}")
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.graph_audit",
        description="Structural audit of the fused decode bodies "
                    "(CPA01..CPA04).")
    ap.add_argument("--k", type=int, default=4,
                    help="decode steps per dispatch for the multi-step "
                         "body (default 4)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    findings = build_and_audit(args.k, verbose=args.verbose)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"repro_torch.analysis.graph_audit: {n} finding"
          f"{'s' if n != 1 else ''} (single-step + k={args.k} bodies)")
    if args.verbose and not n:
        for cid, desc in CHECKS.items():
            print(f"  {cid}: clean — {desc}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
