"""The port's dense-cache Model path, for every family, against the JAX
package.

The same params (the reference's own init, bridged with
``repro_torch.bridge``) and the same numpy inputs from a seed (a vlm's
stub patch embeddings, whisper's encoder frames) go through both
packages' ``build_model(cfg)``: ``forward``, ``init_cache`` +
``prefill`` + two ``decode_step`` s, on the float32 smoke config of each
of the 10 architectures; logits and every cache leaf agree within 1e-5,
relative and absolute on the scale of the tensor (``max(1, max|x|)``,
``tests/test_torch_ssm.py``'s rule for whole models: an SSM state sums a
whole sequence of layer outputs, each rounded apart in the two
frameworks), ring positions exactly.  The
port runs both its routes: the masked softmax (``impl="xla"``) and the
kernel routes (``"flash"`` prefill, ``"paged"`` decode), whose plain
versions the CPU takes; the reference runs its XLA route.

Then gemma3's sliding-window ring where prompts outrun the window,
decode crosses it and a row's real length lies below its bucket (the
padded-bucket quirk), the ring count against the reference's valid mask,
the plain versions of the contiguous decode and flash kernels at head
dim 256 against ``src/repro/kernels/ref.py``, the fp8 cache, the
engine's ``busy`` and the pools' byte counts.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, PAPER_COLOC_SET, get_smoke_config
from repro.core.pools import build_pools as j_build_pools
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import layers as jlayers
from repro.runtime.engine import CrossPoolEngine as JEngine
from repro.runtime.request import Request as JRequest
from repro_torch.bridge import params_to_torch
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.pools import build_pools as t_build_pools
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model as t_build_model
from repro_torch.runtime.engine import CrossPoolEngine as TEngine
from repro_torch.runtime.request import Request as TRequest
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
GEMMA = "gemma3-12b"
#: the port's attention routes: (prefill impl, decode impl)
ROUTES = {"xla": ("xla", "xla"), "kernels": ("flash", "paged")}


def _cfgs(name):
    return (get_smoke_config(name).replace(dtype="float32"),
            t_smoke(name).replace(dtype="float32"))


@functools.cache
def _params(name, seed=0):
    jcfg, _ = _cfgs(name)
    return jax.tree.map(np.asarray,
                        build_model(jcfg).init(jax.random.PRNGKey(seed)))


def _inputs(cfg, B, S_txt, seed):
    """tokens [B,S_txt] and the modality inputs, numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.frontend == "vision_patches":
        kw["embeddings"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        kw["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_txt)).astype(np.int32)
    return tokens, kw


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(
        v.detach().float() if isinstance(v, torch.Tensor)
        and v.dtype != torch.int32 else v) for k, v in tree.items()}


def _close_scaled(got, want, what=""):
    """Within 1e-5, relative and absolute on the scale of ``want``."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def _close_cache(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        if key == "lpos":
            np.testing.assert_array_equal(g, w)
        else:
            _close_scaled(g, w, key)


@functools.cache
def _reference_run(name, B, S_txt, max_len, seed, first_lengths, steps,
                   logit_index=None):
    """The JAX Model path on one input: forward logits, prefill logits
    and cache, then ``steps`` decode steps from ``first_lengths`` [B]
    (the tokens each step feeds are the previous step's argmax); every
    result as numpy."""
    jcfg, _ = _cfgs(name)
    model = build_model(jcfg)
    params = _params(name)
    tokens, kw = _inputs(jcfg, B, S_txt, seed)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    fwd, _ = jax.jit(lambda p, t: model.forward(p, t, **jkw))(params, tokens)
    cache = model.init_cache(B, max_len)
    logits, cache = jax.jit(lambda p, t, c: model.prefill(
        p, t, c, logit_index=logit_index, **jkw))(params, tokens, cache)
    out = dict(tokens=tokens, kw=kw, forward=np.asarray(fwd),
               prefill=(np.asarray(logits), jax.tree.map(np.asarray, cache)),
               steps=[])
    step = jax.jit(lambda p, t, c, n: model.decode_step(p, t, c, n))
    lengths = np.asarray(first_lengths, np.int32)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        logits, cache = step(params, nxt, cache, jnp.asarray(lengths))
        out["steps"].append((nxt, lengths.copy(), np.asarray(logits),
                             jax.tree.map(np.asarray, cache)))
        lengths = lengths + 1
    return out


def _port_run(name, ref, B, max_len, route, logit_index=None):
    """The port's Model path on the reference run's inputs, checked
    against it after the forward, the prefill and every decode step."""
    _, tcfg = _cfgs(name)
    model = t_build_model(tcfg)
    params = params_to_torch(_params(name))
    tokens = torch.from_numpy(ref["tokens"])
    kw = {k: torch.from_numpy(v) for k, v in ref["kw"].items()}
    prefill_impl, decode_impl = ROUTES[route]
    fwd, _ = model.forward(params, tokens, **kw)
    _close_scaled(fwd.numpy(), ref["forward"], "forward")
    cache = model.init_cache(B, max_len, "cpu")
    logits, got = model.prefill(params, tokens, cache, impl=prefill_impl,
                                logit_index=logit_index, **kw)
    assert got is cache                              # seeded in place
    want_logits, want_cache = ref["prefill"]
    _close_scaled(logits.numpy(), want_logits, "prefill")
    _close_cache(_np(cache), want_cache)
    for nxt, lengths, want_logits, want_cache in ref["steps"]:
        logits, _ = model.decode_step(params, torch.from_numpy(nxt), cache,
                                      torch.from_numpy(lengths),
                                      impl=decode_impl)
        _close_scaled(logits.numpy(), want_logits, "decode")
        _close_cache(_np(cache), want_cache)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_model_path_matches_reference(name, route):
    """forward, init_cache, prefill and two decode steps of every
    architecture: logits and caches within 1e-5 of the reference's.  The
    two rows decode from different lengths (one inside the prefilled
    prompt, whose pad KV the step overwrites)."""
    jcfg, _ = _cfgs(name)
    B, S_txt = 2, 12
    S = S_txt + (jcfg.frontend_tokens if jcfg.frontend == "vision_patches"
                 else 0)
    ref = _reference_run(name, B, S_txt, S + 8, 1, (S, S - 3), 2)
    _port_run(name, ref, B, S + 8, route)


def test_init_params_has_the_reference_layout_for_every_family():
    """The port's own init draws the reference's tree (structure, shapes,
    dtypes) for every architecture, whisper's encoder included."""
    for name in ARCH_NAMES:
        jcfg, tcfg = _cfgs(name)
        want = jax.eval_shape(lambda k: build_model(jcfg).init(k),
                              jax.random.PRNGKey(0))
        got = t_build_model(tcfg).init(torch.Generator().manual_seed(0))

        def shapes(tree, conv):
            return {k: shapes(v, conv) if isinstance(v, dict) else conv(v)
                    for k, v in tree.items()}

        assert shapes(got, lambda t: (tuple(t.shape), str(t.dtype)[6:])) \
            == shapes(want, lambda a: (tuple(a.shape), str(a.dtype))), name


def test_sinusoidal_positions_match_reference():
    """Positions up to whisper's 448.  Within 1e-4 absolute: the two
    frameworks' ``exp`` may round a frequency one ulp apart (6e-8
    relative), which a position of 448 turns into ~3e-5 of the angle,
    plus the angle's own ulp (3e-5 at 448)."""
    pos = np.arange(0, 448, 7).reshape(4, -1).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.sinusoidal_positions(torch.from_numpy(pos), 64).numpy(),
        np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), 64)),
        rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# gemma3's sliding-window ring
# ---------------------------------------------------------------------------

#: (prompt bucket S, decode steps, first lengths, logit_index): the smoke
#: window is 16
RING_CASES = {
    "prompt-past-window": (40, 20, (40, 40), None),
    "decode-crosses-window": (10, 12, (10, 10), None),
    "pad-quirk": (24, 6, (14, 24), 13),
}


def _ring_reference(case):
    S, steps, first, logit_index = RING_CASES[case]
    return _reference_run(GEMMA, 2, S, S + steps + 4, 2, first, steps,
                          logit_index)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_gemma3_ring_matches_reference(case, route):
    """Prompts longer than the window, decode crossing it, and a row whose
    real length (14) lies below its bucket (24), logits read at 13: the
    ring's positions equal the reference's exactly and its K/V rows
    within 1e-5 (values computed in two frameworks round apart; scaled as
    above), logits within 1e-5, after the prefill and after every step.
    The kernel route reads each ring through the contiguous decode
    kernel's plain version over ``ring_count`` slots, the reference
    through its masked softmax."""
    S, steps, first, logit_index = RING_CASES[case]
    _port_run(GEMMA, _ring_reference(case), 2, S + steps + 4, route,
              logit_index)


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_count_selects_the_reference_valid_mask(case):
    """On the reference's own ring states: every local layer holds the
    same positions, and after each step the slots ``[0, n)`` with ``n =
    ring_count(lpos)`` are exactly the reference's ``valid = (lpos >= 0)
    & (lpos > cur - W)`` (``attention.py:370``), pad positions of the
    quirk included.  The prefill's ring layout is the port's
    ``ring_layout``."""
    S = RING_CASES[case][0]
    ref = _ring_reference(case)
    lpos = ref["prefill"][1]["lpos"]
    W = lpos.shape[-1]
    assert (lpos == tdec.ring_layout(S, W)).all()
    for _, cur, _, cache in ref["steps"]:
        lpos = cache["lpos"]
        assert (lpos == lpos[:1, :1]).all()
        valid = (lpos[0, 0] >= 0) & (lpos[0, 0] > cur[:, None] - W)
        n = tattn.ring_count(torch.from_numpy(lpos[0, 0])).numpy()
        np.testing.assert_array_equal(np.arange(W)[None, :] < n[:, None],
                                      valid)
    if case == "pad-quirk":          # row 0 attends to pad positions > cur
        assert (lpos[0, 0, 0] > ref["steps"][-1][1][0]).any()


@pytest.mark.parametrize("impl", ["xla", "paged"])
def test_swa_decode_alone_matches_reference(impl):
    """``swa_decode`` called on its own (after ``ring_write_positions``
    and ``ring_count``, as ``decode._decode_swa`` calls it) from a ring
    seeded by a 20-token prefill (W = 16), one row at the prompt's end
    and one inside it: output and ring equal the reference's."""
    jcfg, tcfg = _cfgs(GEMMA)
    rng = np.random.default_rng(5)
    B, W, KV, hd = 2, 16, jcfg.n_kv_heads, jcfg.head_dim
    p = jax.tree.map(lambda a: a[0], _params(GEMMA)["layers"]["attn"])
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, W, KV, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.broadcast_to(tdec.ring_layout(20, W), (B, W)).astype(np.int32)
    cur = np.array([20, 17], np.int32)
    want = jax.jit(jattn.swa_decode, static_argnums=1)(
        p, jcfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), jnp.asarray(cur))
    t = [torch.from_numpy(a.copy()) for a in (ck, cv, pos)]
    tcur = torch.from_numpy(cur)
    tattn.ring_write_positions(t[2], tcur)
    out = tattn.swa_decode(params_to_torch(p), tcfg, torch.from_numpy(x),
                           *t, tcur, tattn.ring_count(t[2]), impl=impl)
    for got, w in zip([out] + t, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# the kernels' plain versions at head dim 256 (gemma3)
# ---------------------------------------------------------------------------

def test_decode_attention_plain_at_head_dim_256():
    """Row 3's plain version at gemma3's geometry (H 16 over KV 8, D 256)
    with ragged lengths, against ``src/repro/kernels/ref.py``."""
    rng = np.random.default_rng(6)
    B, T, H, KV, D = 3, 40, 16, 8, 256
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, T, KV, D)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([40, 17, 1], np.int32)
    got = kops.decode_attention(*[torch.from_numpy(a) for a in
                                  (q, ck, cv, lengths)], scale=D ** -0.5)
    want = jref.decode_attention(*[jnp.asarray(a) for a in
                                   (q, ck, cv, lengths)], D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,T", [(24, 24), (24, 40)])
def test_flash_attention_plain_at_head_dim_256(S, T):
    """Row 4's plain version at gemma3's geometry, S = T and T > S."""
    rng = np.random.default_rng(S + T)
    B, H, KV, D = 2, 16, 8, 256
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KV, D)).astype(np.float32)
            for _ in range(2))
    got = kops.flash_attention(*[torch.from_numpy(a) for a in (q, k, v)],
                               scale=D ** -0.5)
    want = jref.flash_attention(*[jnp.asarray(a) for a in (q, k, v)],
                                D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the fp8 cache
# ---------------------------------------------------------------------------

def test_f8_cache_follows_the_reference():
    """``kv_dtype="f8"``: an fp8-e4m3 cache, dequantized to bfloat16 at
    attention.  The port's prefill + decode logits stay within the
    reference's own quantization bound (``tests/test_sharding.py``:
    ``err < 0.1 * scale + 0.5``) of its float32-cache logits.  Against
    the reference's fp8 path the bound is tight: the fp8 cache codes
    match, but for at most 1% of them one step apart (K/V computed in
    two frameworks may round to neighbouring fp8 values), and the
    logits agree within 1e-2 of their scale."""
    name = "qwen3-14b"
    jcfg, tcfg = _cfgs(name)
    jmodel, tmodel = build_model(jcfg), t_build_model(tcfg)
    params = _params(name)
    tp = params_to_torch(params)
    B, seq = 2, 8
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, seq)).astype(np.int32)
    out = {}
    for kv_dtype in (None, "f8"):
        cache = tmodel.init_cache(B, 16, "cpu", kv_dtype=kv_dtype)
        tmodel.prefill(tp, torch.from_numpy(tokens), cache)
        logits, _ = tmodel.decode_step(tp, torch.zeros(B, dtype=torch.int32),
                                       cache, seq)
        out[kv_dtype] = logits.numpy()
    assert cache["k"].dtype == torch.float8_e4m3fn
    jcache = jmodel.init_cache(B, 16, kv_dtype="f8")
    _, jcache = jmodel.prefill(params, jnp.asarray(tokens), jcache)
    want, jcache = jmodel.decode_step(params, jnp.zeros((B,), jnp.int32),
                                      jcache, jnp.int32(seq))
    for leaf in ("k", "v"):
        steps = np.abs(cache[leaf].view(torch.uint8).numpy().astype(int)
                       - np.asarray(jcache[leaf]).view(np.uint8).astype(int))
        assert steps.max() <= 1 and (steps > 0).mean() <= 0.01, leaf
    scale = np.abs(out[None]).max()
    assert np.isfinite(out["f8"]).all()
    assert np.abs(out["f8"] - out[None]).max() < 0.1 * scale + 0.5
    assert np.abs(out["f8"] - np.asarray(want)).max() < 1e-2 * scale


# ---------------------------------------------------------------------------
# the engine's ``busy`` and the pools' byte counts (repairs)
# ---------------------------------------------------------------------------

ENGINE_KW = dict(page_budget=2048, page_bytes=4096, slab_bytes=4096,
                 max_batch=2, max_ctx=64, seed=0)


def test_busy_equals_the_reference_engine():
    """After each step of one run (5 requests at time 0 over the
    colocated set, one waiting for a batch slot), the port's ``busy``
    equals the JAX engine's, and both end idle."""
    jm = {n: _cfgs(n)[0] for n in PAPER_COLOC_SET}
    tm = {n: _cfgs(n)[1] for n in PAPER_COLOC_SET}
    params = {n: params_to_torch(jax.tree.map(
        np.asarray, build_model(c).init(jax.random.PRNGKey(i))))
        for i, (n, c) in enumerate(jm.items())}
    je = JEngine(jm, **ENGINE_KW)
    te = TEngine(tm, device="cpu", params=params, **ENGINE_KW)
    assert te.busy is je.busy is False
    trace = [(0, PAPER_COLOC_SET[0], 6, 3), (1, PAPER_COLOC_SET[0], 9, 2),
             (2, PAPER_COLOC_SET[0], 5, 2), (3, PAPER_COLOC_SET[2], 7, 4),
             (4, PAPER_COLOC_SET[1], 12, 3)]
    for t in trace:
        je.submit(JRequest(*t, 0.0))
        te.submit(TRequest(*t, 0.0))
    seen = []
    for _ in range(40):
        assert te.busy == je.busy
        seen.append(te.busy)
        if not je.busy:
            break
        je.step()
        te.step()
    assert seen[-1] is False and True in seen


@pytest.mark.parametrize("names", [PAPER_COLOC_SET,
                                   ("qwen3-moe-235b-a22b", "zamba2-1.2b")],
                         ids=["coloc", "mixed"])
def test_pool_byte_counts_match_the_reference(names):
    """``WeightsPool.total_bytes`` equals the reference's (the arena's
    device bytes).  On split models only, ``host_master_bytes`` (0) and
    ``KVCachePool.total_param_bytes`` equal it too; with a fallback
    model the reference keeps its FFN tree as a host master, the port
    keeps the whole tree on the device in the KV pool: the sums agree."""
    jm = {n: _cfgs(n)[0] for n in names}
    tm = {n: _cfgs(n)[1] for n in names}
    params = {n: _params(n) for n in names}
    kw = dict(page_budget=32, page_bytes=2048, slab_bytes=4096)
    j_kv, j_w, _ = j_build_pools(jm, params, pool_dtype=jnp.float32, **kw)
    t_kv, t_w, _ = t_build_pools(
        tm, {n: params_to_torch(p) for n, p in params.items()},
        device="cpu", pool_dtype=torch.float32, **kw)
    assert t_w.total_bytes() == j_w.total_bytes() > 0
    assert t_w.host_master_bytes() == 0
    assert t_kv.total_param_bytes() == (j_kv.total_param_bytes()
                                        + j_w.host_master_bytes())
    if names == PAPER_COLOC_SET:
        assert j_w.host_master_bytes() == 0
