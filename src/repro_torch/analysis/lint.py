"""Invariant lint: AST rules codifying the DESIGN.md pool contracts.

Port of ``src/repro/analysis/lint.py``.  The pool contracts live as prose
(DESIGN.md §§2-11): "hooks fire one-for-one adjacent to counters",
"sampling only in ``runtime/sampler.py``", "EngineConfig is the only
constructor surface".  These rules check them over the port's own
source tree (no third-party linter; the rules are repo-specific):

  CP001  no host synchronization (``.item()`` / ``.tolist()`` /
         ``.cpu()`` / ``.numpy()`` / ``np.asarray`` / ``np.array`` /
         ``torch.cuda.synchronize`` / ``.synchronize()``) inside a body
         that is captured into a CUDA graph: a ``body`` method of a
         ``_FusedStep`` subclass, the first argument of
         ``DecodeGraph(...)``, or a function called inside ``with
         torch.cuda.graph(...)`` (and that block itself).  A host sync
         in a captured body fails the capture on a card, and on the CPU,
         where the same body runs eagerly, it passes unseen (the graph
         audit's CPA03 twin).
  CP002  no ``torch.argmax`` / ``Tensor.argmax`` / ``torch.multinomial``
         / ``torch.distributions.Categorical`` outside
         ``runtime/sampler.py``: one sampling surface keeps greedy and
         temperature semantics identical across the engine, the dry-run
         and the examples.  Any ``.argmax(...)`` call counts (the AST
         does not know the receiver's type).
  CP003  every pool-accounting mutation fires its ``core.hooks`` call in
         the same function (counter/hook one-for-one, DESIGN.md §10).
  CP004  no deprecated loose-kwarg ``CrossPoolEngine(mode=..., ...)``
         construction: ``config=EngineConfig(...)`` is the one surface.
  CP005  no ad-hoc percentile math outside ``runtime/observe.py`` (and
         ``benchmarks/_stats.py``): one quantile definition.  The
         reference's table, plus ``torch.quantile`` / ``torch.nanquantile``.
  CP006  no wall-clock reads (``time.time`` / ``perf_counter`` / ...) in
         engine latency paths (``runtime/engine.py``,
         ``runtime/session.py``, ``core/``): engine time is virtual; the
         real dispatch-duration sites carry pragmas.
  CP007  no bare ``assert`` in pool-accounting modules: asserts vanish
         under ``python -O``; use ``core.errors.check``.

CP003-CP007 keep the reference's tables (its counter names are the
port's).  A finding is silenced ONLY by an explicit pragma on the
offending line or on a comment line just above it::

    t0 = time.perf_counter()   # cp: allow(CP006) dispatch wall-duration

CLI: ``python -m repro_torch.analysis.lint [paths...]`` (``--list-rules``)
lints ``src/repro_torch`` by default (tests and the root scripts are
exempt: they use argmax for expected values, wall clocks for timeouts
and asserts everywhere) and exits non-zero on any finding.
"""
from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "CP001": "host sync inside a body captured into a CUDA graph",
    "CP002": "sampling primitive outside runtime/sampler.py",
    "CP003": "pool-accounting mutation without its adjacent hook call",
    "CP004": "deprecated loose-kwarg engine construction",
    "CP005": "ad-hoc percentile outside the canonical quantile modules",
    "CP006": "wall-clock read in an engine latency path",
    "CP007": "bare assert in a pool-accounting module",
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for an Attribute/Name chain ('' if other)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _pragma_allows(lines: Sequence[str], lineno: int, rule: str) -> bool:
    """True when the line carries ``cp: allow(<rule>)``, or the line above
    is a standalone ``# cp: allow(...)`` comment (a trailing pragma only
    covers its own line: it must not leak onto the next one)."""
    def has(text: str) -> bool:
        return f"cp: allow({rule})" in text or "cp: allow(all)" in text

    if 1 <= lineno <= len(lines) and has(lines[lineno - 1]):
        return True
    if lineno >= 2:
        above = lines[lineno - 2]
        if above.lstrip().startswith("#") and has(above):
            return True
    return False


def _walk_funcs(tree: ast.AST):
    """Yield every function/lambda definition node in the module."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            yield node


def _callee_name(node: ast.AST) -> str:
    """The last name of a callee: 'body' for ``self.body`` or ``body``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


# ---------------------------------------------------------------------------
# CP001 — host sync inside captured bodies
# ---------------------------------------------------------------------------

_HOST_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                    "torch.cuda.synchronize"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_FUSED_BASE = "_FusedStep"


def _is_graph_ctx(item: ast.withitem) -> bool:
    call = item.context_expr
    return isinstance(call, ast.Call) \
        and _dotted(call.func) in ("torch.cuda.graph", "cuda.graph")


def _captured(tree: ast.AST) -> Tuple[Set[str], List[ast.AST]]:
    """(names of module-local functions that are captured, bodies given
    inline): ``body`` methods of ``_FusedStep`` subclasses (transitively
    within the module), the first argument of ``DecodeGraph(...)`` (a
    name, an attribute's last name, or a lambda together with what it
    calls), and the functions called inside ``with torch.cuda.graph(...)``
    (the block itself is a body too)."""
    names: Set[str] = set()
    inline: List[ast.AST] = []
    fused = {_FUSED_BASE}
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    grew = True
    while grew:
        grew = False
        for cls in classes:
            if cls.name not in fused and any(
                    _callee_name(b) in fused for b in cls.bases):
                fused.add(cls.name)
                grew = True
    for cls in classes:
        if cls.name in fused and cls.name != _FUSED_BASE:
            inline.extend(f for f in cls.body
                          if isinstance(f, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and f.name == "body")
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _callee_name(node.func) \
                == "DecodeGraph" and node.args:
            first = node.args[0]
            if isinstance(first, ast.Lambda):
                inline.append(first)
                names.update(_callee_name(c.func) for c in ast.walk(first)
                             if isinstance(c, ast.Call))
            else:
                names.add(_callee_name(first))
        elif isinstance(node, (ast.With, ast.AsyncWith)) \
                and any(_is_graph_ctx(i) for i in node.items):
            inline.extend(node.body)
            names.update(_callee_name(c.func) for s in node.body
                         for c in ast.walk(s) if isinstance(c, ast.Call))
    names.discard("")
    return names, inline


def _check_host_sync(tree: ast.AST, path: str, lines: Sequence[str]
                     ) -> List[Finding]:
    names, bodies = _captured(tree)
    bodies = bodies + [f for f in _walk_funcs(tree)
                       if isinstance(f, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and f.name in names]
    out: List[Finding] = []
    seen: Set[int] = set()
    for body in bodies:
        for node in ast.walk(body):
            if not isinstance(node, ast.Call) or node.lineno in seen:
                continue
            callee = _dotted(node.func)
            hit = callee in _HOST_SYNC_CALLS or (
                callee not in _HOST_SYNC_CALLS
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_SYNC_METHODS)
            if hit and not _pragma_allows(lines, node.lineno, "CP001"):
                seen.add(node.lineno)
                label = callee if callee in _HOST_SYNC_CALLS \
                    else f".{node.func.attr}()"
                out.append(Finding(
                    "CP001", path, node.lineno,
                    f"host sync `{label}` inside a body captured into a "
                    f"CUDA graph: it fails the capture on a card and "
                    f"passes unseen on the CPU"))
    return out


# ---------------------------------------------------------------------------
# CP002 — sampling outside runtime/sampler.py
# ---------------------------------------------------------------------------

_SAMPLING_CALLS = {"torch.argmax", "torch.multinomial",
                   "torch.distributions.Categorical",
                   "distributions.Categorical"}
_SAMPLING_METHODS = {"argmax", "multinomial"}


def _check_sampling(tree: ast.AST, path: str, lines: Sequence[str]
                    ) -> List[Finding]:
    if path.replace("\\", "/").endswith("runtime/sampler.py"):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func)
        if callee in _SAMPLING_CALLS:
            label = callee
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SAMPLING_METHODS:
            label = f"Tensor.{node.func.attr}"
        else:
            continue
        if not _pragma_allows(lines, node.lineno, "CP002"):
            out.append(Finding(
                "CP002", path, node.lineno,
                f"`{label}` outside runtime/sampler.py — route token "
                f"selection through runtime.sampler"))
    return out


# ---------------------------------------------------------------------------
# CP003 — counter mutations must sit next to their hook call
# ---------------------------------------------------------------------------

#: per accounting module: self.<counter> mutation -> required hook name
_COUNTER_HOOKS: Dict[str, Dict[str, str]] = {
    "core/virtualizer.py": {
        "swap_out_pages": "kv_swap_out",
        "swap_in_pages": "kv_swap_in",
        "resizes": "kv_resize",
    },
    "core/weight_pool.py": {
        "activations": "arena_activate",
        "evictions": "arena_evict",
        "layer_uploads": "arena_upload",
        "resizes": "arena_resize",
    },
    "core/prefix_cache.py": {
        "evicted_pages": "cache_evict",
        "shed_pages": "cache_evict",
        "faulted_pages": "cache_fault",
        "hits": "cache_hit",
        "misses": "cache_miss",
    },
}

#: method-call mutations (not counter attributes) -> required hook name
_CALL_HOOKS: Dict[str, Dict[str, str]] = {
    "core/admission.py": {"stats.bump": "admission"},
    "core/elastic.py": {"events.append": "rebalance"},
}


def _self_attr_target(node: ast.AST) -> str:
    """'stats.bump' for ``self.stats.bump`` / 'resizes' for
    ``self.resizes`` ('' when the chain is not rooted at ``self``)."""
    dotted = _dotted(node)
    if dotted.startswith("self."):
        return dotted[len("self."):]
    return ""


def _check_hook_adjacency(tree: ast.AST, path: str, lines: Sequence[str]
                          ) -> List[Finding]:
    norm = path.replace("\\", "/")
    counter_map = next((m for suffix, m in _COUNTER_HOOKS.items()
                        if norm.endswith(suffix)), None)
    call_map = next((m for suffix, m in _CALL_HOOKS.items()
                     if norm.endswith(suffix)), None)
    if counter_map is None and call_map is None:
        return []
    out: List[Finding] = []
    for fn in _walk_funcs(tree):
        if isinstance(fn, ast.Lambda):
            continue
        hooks_called: Set[str] = set()
        mutations: List[Tuple[int, str, str]] = []   # (line, what, hook)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = _dotted(node.func)
                if ".hooks." in callee or callee.startswith("hooks."):
                    hooks_called.add(callee.rsplit(".", 1)[-1])
                if call_map is not None:
                    tgt = _self_attr_target(node.func)
                    if tgt in call_map:
                        mutations.append(
                            (node.lineno, f"self.{tgt}(...)", call_map[tgt]))
            if counter_map is not None and isinstance(node, ast.AugAssign):
                tgt = _self_attr_target(node.target)
                # only increments count as "the event happened":
                # decrements are bookkeeping inside another event
                if tgt in counter_map and isinstance(node.op, ast.Add):
                    mutations.append(
                        (node.lineno, f"self.{tgt} +=", counter_map[tgt]))
        for lineno, what, hook in mutations:
            if hook in hooks_called:
                continue
            if _pragma_allows(lines, lineno, "CP003"):
                continue
            out.append(Finding(
                "CP003", path, lineno,
                f"`{what}` without an adjacent `hooks.{hook}(...)` call in "
                f"the same function (counter/hook one-for-one, "
                f"DESIGN.md §10)"))
    return out


# ---------------------------------------------------------------------------
# CP004 — deprecated loose-kwarg engine construction
# ---------------------------------------------------------------------------

_ENGINE_NAMES = {"CrossPoolEngine", "ServingSession"}
_LOOSE_KWARGS = {"mode", "elastic"}


def _check_engine_ctor(tree: ast.AST, path: str, lines: Sequence[str]
                       ) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func).rsplit(".", 1)[-1]
        if name not in _ENGINE_NAMES:
            continue
        loose = sorted(k.arg for k in node.keywords
                       if k.arg in _LOOSE_KWARGS)
        if loose and not _pragma_allows(lines, node.lineno, "CP004"):
            out.append(Finding(
                "CP004", path, node.lineno,
                f"{name}({', '.join(k + '=...' for k in loose)}) is the "
                f"deprecated loose-kwarg surface — pass "
                f"config=EngineConfig(...)"))
    return out


# ---------------------------------------------------------------------------
# CP005 — ad-hoc percentiles
# ---------------------------------------------------------------------------

_PERCENTILE_CALLS = {"np.percentile", "np.quantile", "numpy.percentile",
                     "numpy.quantile", "jnp.percentile", "jnp.quantile",
                     "statistics.quantiles", "torch.quantile",
                     "torch.nanquantile"}
_PERCENTILE_EXEMPT = ("benchmarks/_stats.py", "runtime/observe.py")


def _check_percentile(tree: ast.AST, path: str, lines: Sequence[str]
                      ) -> List[Finding]:
    norm = path.replace("\\", "/")
    if any(norm.endswith(s) for s in _PERCENTILE_EXEMPT):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _dotted(node.func) in _PERCENTILE_CALLS \
                and not _pragma_allows(lines, node.lineno, "CP005"):
            out.append(Finding(
                "CP005", path, node.lineno,
                f"`{_dotted(node.func)}` outside the canonical quantile "
                f"modules — use runtime.observe.percentile"))
    return out


# ---------------------------------------------------------------------------
# CP006 — wall clock in engine latency paths
# ---------------------------------------------------------------------------

_WALL_CLOCK_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
                     "time.process_time", "datetime.now", "datetime.utcnow"}
_CLOCK_SCOPED = ("runtime/engine.py", "runtime/session.py")


def _clock_in_scope(norm: str) -> bool:
    return any(norm.endswith(s) for s in _CLOCK_SCOPED) \
        or "/core/" in norm or norm.startswith("core/")


def _check_wall_clock(tree: ast.AST, path: str, lines: Sequence[str]
                      ) -> List[Finding]:
    norm = path.replace("\\", "/")
    if not _clock_in_scope(norm):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _dotted(node.func) in _WALL_CLOCK_CALLS \
                and not _pragma_allows(lines, node.lineno, "CP006"):
            out.append(Finding(
                "CP006", path, node.lineno,
                f"`{_dotted(node.func)}()` in an engine latency path — "
                f"engine time is virtual (`now`); pragma real "
                f"dispatch-duration sites explicitly"))
    return out


# ---------------------------------------------------------------------------
# CP007 — bare asserts in pool-accounting modules
# ---------------------------------------------------------------------------

_ASSERT_SCOPED = ("core/virtualizer.py", "core/weight_pool.py",
                  "core/prefix_cache.py")


def _check_bare_assert(tree: ast.AST, path: str, lines: Sequence[str]
                       ) -> List[Finding]:
    norm = path.replace("\\", "/")
    if not any(norm.endswith(s) for s in _ASSERT_SCOPED):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert) \
                and not _pragma_allows(lines, node.lineno, "CP007"):
            out.append(Finding(
                "CP007", path, node.lineno,
                "bare `assert` in a pool-accounting module vanishes under "
                "`python -O` — raise core.errors.PoolAccountingError "
                "(via core.errors.check)"))
    return out


# ---------------------------------------------------------------------------
# running the rules
# ---------------------------------------------------------------------------

_CHECKS = (_check_host_sync, _check_sampling, _check_hook_adjacency,
           _check_engine_ctor, _check_percentile, _check_wall_clock,
           _check_bare_assert)


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one source string as if it lived at ``path`` (rules are
    path-scoped, so tests pass repo-shaped fake paths)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("CP000", path, e.lineno or 0,
                        f"syntax error: {e.msg}")]
    lines = source.splitlines()
    out: List[Finding] = []
    for chk in _CHECKS:
        out.extend(chk(tree, path, lines))
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def lint_file(path: Path, root: Optional[Path] = None) -> List[Finding]:
    rel = str(path.relative_to(root)) if root else str(path)
    return lint_source(path.read_text(encoding="utf-8"), rel)


def _iter_py(paths: Iterable[Path]):
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def lint_paths(paths: Sequence[Path], root: Optional[Path] = None
               ) -> List[Finding]:
    out: List[Finding] = []
    for f in _iter_py(paths):
        out.extend(lint_file(f, root))
    return out


def default_roots(repo) -> List[Path]:
    """The gated tree: the port's package (NOT tests, NOT the root
    scripts)."""
    root = Path(repo) / "src" / "repro_torch"
    return [root] if root.exists() else []


def _find_repo_root() -> Path:
    here = Path(__file__).resolve()
    for parent in here.parents:
        if (parent / "src" / "repro_torch").is_dir():
            return parent
    return Path.cwd()


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="CrossPool invariant lint of the PyTorch port "
                    "(rules CP001..CP007)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rid, desc in sorted(RULES.items()):
            print(f"{rid}  {desc}")
        return 0
    repo = _find_repo_root()
    paths = args.paths or default_roots(repo)
    findings = lint_paths(paths, root=repo if not args.paths else None)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"repro_torch.analysis.lint: {n} finding{'s' if n != 1 else ''} "
          f"across {len(list(_iter_py(paths)))} files")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
