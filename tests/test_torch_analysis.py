"""The port's static tooling: the lint (``repro_torch.analysis.lint``)
and the graph audit of the fused decode bodies
(``repro_torch.analysis.graph_audit``).

* Lint: a violating and a clean snippet for each rule CP001-CP007 (and a
  syntax error, CP000); the pragma covers its own line only; the
  reference's CP003-CP007 snippets (``tests/test_analysis.py``) give the
  same rule ids and lines from the reference's lint and the port's; the
  port's own tree lints clean.
* Audit: each check CPA01-CPA04 flagged by a planted body (and only that
  check), on ``PagedFusedStep`` and ``MultiStepFusedStep(k=4)``; the
  real steps of the reference's fixture (the smoke MoE model of
  ``PAPER_COLOC_SET``, float32) clean; the recorder sees the wrappers
  only while attached; the CLI exits 0.
"""
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import graph_audit as ga
from repro_torch.analysis import lint as tl
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def rules_of(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# the lint: one violating and one clean snippet per rule
# ---------------------------------------------------------------------------

FUSED_BODY = (
    "class Step(_FusedStep):\n"
    "    def body(self, pool, arena, slot_table, tokens):\n"
    "        n = tokens.sum(){call}\n"
    "        return pool\n")

RULE_CASES = {
    # rule: (path, violating source, clean source)
    "CP001": ("src/repro_torch/core/control.py",
              FUSED_BODY.format(call=".item()"),
              FUSED_BODY.format(call="")),
    "CP001-graph": ("src/repro_torch/runtime/engine.py",
                    "def decode_body(tokens):\n"
                    "    return tokens.cpu()\n"
                    "g = DecodeGraph(self.decode_body, static)\n",
                    "def decode_body(tokens):\n"
                    "    return tokens + 1\n"
                    "g = DecodeGraph(self.decode_body, static)\n"),
    "CP001-capture": ("src/repro_torch/core/control.py",
                      "with torch.cuda.graph(g):\n"
                      "    torch.cuda.synchronize()\n",
                      "with torch.cuda.graph(g):\n"
                      "    out.copy_(body())\n"),
    "CP002": ("src/repro_torch/runtime/engine.py",
              "tok = logits.argmax(-1)\n",
              "tok = sampler.sample(logits)\n"),
    "CP002-torch": ("src/repro_torch/models/moe.py",
                    "i = torch.multinomial(p, 1)\n",
                    "i = torch.topk(p, 1).indices\n"),
    "CP003": ("src/repro_torch/core/virtualizer.py",
              "class V:\n"
              "    def swap_out(self, n):\n"
              "        self.swap_out_pages += n\n",
              "class V:\n"
              "    def swap_out(self, n):\n"
              "        self.swap_out_pages += n\n"
              "        self.hooks.kv_swap_out(n)\n"),
    "CP004": ("src/repro_torch/examples/x.py",
              "e = CrossPoolEngine(models, mode=EngineMode())\n",
              "e = CrossPoolEngine(models, config=EngineConfig())\n"),
    "CP005": ("src/repro_torch/runtime/engine.py",
              "p99 = torch.quantile(xs, 0.99)\n",
              "p99 = percentile(xs, 99)\n"),
    "CP006": ("src/repro_torch/core/control.py",
              "t0 = time.perf_counter()\n",
              "t0 = self.now\n"),
    "CP007": ("src/repro_torch/core/weight_pool.py",
              "def f(n):\n    assert n >= 0\n",
              "def f(n):\n    check(n >= 0, 'n')\n"),
    "CP000": ("src/repro_torch/core/x.py", "def f(:\n", "def f():\n"
                                                          "    pass\n"),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_each_rule_fires_and_passes(case):
    path, bad, good = RULE_CASES[case]
    rule = case.split("-")[0]
    assert rules_of(tl.lint_source(bad, path)) == [rule]
    assert tl.lint_source(good, path) == []


def test_cp002_sampler_is_exempt():
    src = "tok = torch.argmax(logits, dim=-1)\n"
    assert tl.lint_source(src, "src/repro_torch/runtime/sampler.py") == []
    assert rules_of(tl.lint_source(src, "src/repro_torch/core/x.py")) \
        == ["CP002"]


def test_cp001_only_in_captured_bodies():
    """The same call outside a captured body (a prefill reads back once)
    is not a finding."""
    src = "def prefill(x):\n    return x.cpu().numpy()\n"
    assert tl.lint_source(src, "src/repro_torch/core/control.py") == []


def test_pragma_suppresses_and_is_line_scoped():
    src = ("import time\n"
           "t0 = time.perf_counter()  # cp: allow(CP006) dispatch duration\n"
           "t1 = time.perf_counter()\n"
           "# cp: allow(CP006) a comment line above covers the next line\n"
           "t2 = time.perf_counter()\n"
           "t3 = time.perf_counter()\n")
    found = tl.lint_source(src, "src/repro_torch/runtime/engine.py")
    assert [f.line for f in found] == [3, 6]


# the reference's CP003-CP007 snippets (tests/test_analysis.py:75-137)
REFERENCE_SNIPPETS = [
    ("class KVVirtualizer:\n"
     "    def swap_out(self, n):\n"
     "        self.swap_out_pages += n\n"
     "        return n\n", "src/repro/core/virtualizer.py"),
    ("class KVVirtualizer:\n"
     "    def swap_out(self, n):\n"
     "        self.swap_out_pages += n\n"
     "        if self.hooks is not None:\n"
     "            self.hooks.kv_swap_out(n)\n"
     "        return n\n", "src/repro/core/virtualizer.py"),
    ("eng = CrossPoolEngine(models, mode=EngineMode(), seed=0)\n",
     "benchmarks/new_bench.py"),
    ("eng = CrossPoolEngine(models, config=EngineConfig(), seed=0)\n",
     "benchmarks/new_bench.py"),
    ("import numpy as np\np99 = np.percentile(xs, 99)\n",
     "src/repro/runtime/engine.py"),
    ("import numpy as np\np99 = np.percentile(xs, 99)\n",
     "benchmarks/_stats.py"),
    ("import time\nt0 = time.perf_counter()\n",
     "src/repro/runtime/engine.py"),
    ("import time\nt0 = time.perf_counter()\n", "benchmarks/new_bench.py"),
    ("def f(n):\n    assert n >= 0\n    return n\n",
     "src/repro/core/virtualizer.py"),
    ("def f(n):\n    assert n >= 0\n    return n\n",
     "src/repro/runtime/engine.py"),
    ("import time\n"
     "t0 = time.perf_counter()  # cp: allow(CP006) dispatch duration\n"
     "t1 = time.perf_counter()\n", "src/repro/runtime/engine.py"),
    ("def f(:\n", "src/repro/core/x.py"),
]


@pytest.mark.parametrize("i", range(len(REFERENCE_SNIPPETS)))
def test_reference_snippets_same_findings(i):
    from repro.analysis import lint as jl
    src, path = REFERENCE_SNIPPETS[i]
    want = [(f.rule, f.line) for f in jl.lint_source(src, path)]
    got = [(f.rule, f.line) for f in tl.lint_source(src, path)]
    assert got == want


def test_real_tree_lints_clean():
    findings = tl.lint_paths(tl.default_roots(REPO), root=REPO)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_lists_rules_and_exits_clean(capsys):
    assert tl.main(["--list-rules"]) == 0
    assert "CP007" in capsys.readouterr().out
    assert tl.main([]) == 0


# ---------------------------------------------------------------------------
# the graph audit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_steps():
    virt, steps = ga.smoke_fixture(4)
    return virt, steps


STEPS = ("PagedFusedStep", "MultiStepFusedStep(k=4)")


@pytest.mark.parametrize("target", STEPS)
def test_real_steps_are_clean(fixture_steps, target):
    virt, steps = fixture_steps
    step, inputs = steps[target]
    found, fig = ga.audit_fused_step(step, virt.pool, inputs=inputs,
                                     target=target)
    assert found == []
    k = getattr(step, "k", 1)
    assert fig["calls_per_body"] == fig["claim"] == {
        "paged_decode_attention": k * step.pooled.cfg.n_layers,
        "paged_kv_write": k * step.pooled.cfg.n_layers}
    assert fig["host_reads"] == 0 and fig["dispatches_per_block"] == 1
    assert fig["largest_foreign_read"] < ga.DEFAULT_MAX_CONST_BYTES


@pytest.mark.parametrize("target", STEPS)
def test_inactive_inputs_leave_the_pool(fixture_steps, target):
    virt, steps = fixture_steps
    step, inputs = steps[target]
    before = virt.pool.clone()
    found, _ = ga.audit_fused_step(step, virt.pool, batch=2, max_pages=4,
                                   target=target)
    assert found == []
    assert torch.equal(virt.pool, before)


@pytest.mark.parametrize("check", sorted(ga.CHECKS))
@pytest.mark.parametrize("target", STEPS)
def test_planted_body_is_flagged(fixture_steps, target, check):
    virt, steps = fixture_steps
    step, inputs = steps[target]
    found, _ = ga.audit_fused_step(ga.planted(step, check), virt.pool,
                                   inputs=inputs, target=target)
    assert [f.check for f in found] == [check]


@pytest.mark.parametrize("read", [False, True])
def test_one_hot_excuses_only_its_own_check(fixture_steps, read):
    """``F.one_hot`` on a CPU tensor reads a minimum and a maximum to the
    host; the audit excuses those reads while one_hot runs, and not an
    ``.item()`` on the same line."""
    import copy as _copy
    import torch.nn.functional as F
    virt, steps = fixture_steps
    step, inputs = steps["PagedFusedStep"]
    base = type(step)

    class OneHot(base):
        def body(self, pool, arena, slot_table, **kw):
            if read:
                F.one_hot(kw["tokens"].long(), 4).sum().item()
            else:
                F.one_hot(kw["tokens"].long(), 4).sum()
            return super().body(pool, arena, slot_table, **kw)

    planted = _copy.copy(step)
    planted.__class__ = OneHot
    found, fig = ga.audit_fused_step(planted, virt.pool, inputs=inputs,
                                     target="one_hot")
    assert [f.check for f in found] == (["CPA03"] if read else [])
    assert fig["host_reads"] == int(read)


def test_recorder_sees_calls_only_while_recording():
    q = torch.zeros(1, 1, 2, 8)
    k = v = torch.zeros(1, 4, 1, 8)
    lens = torch.tensor([3], dtype=torch.int32)
    seen = []

    class Rec:
        def kernel(self, name, args, kwargs):
            seen.append(name)
            return torch.no_grad()
    kops.decode_attention(q, k, v, lens, scale=1.0)
    with build.recording(Rec()):
        kops.decode_attention(q, k, v, lens, scale=1.0)
    kops.decode_attention(q, k, v, lens, scale=1.0)
    assert seen == ["contiguous_decode_attention"]


def test_cli_exits_clean(capsys):
    assert ga.main(["-v"]) == 0
    out = capsys.readouterr().out
    assert "0 findings" in out and "CPA04: clean" in out
