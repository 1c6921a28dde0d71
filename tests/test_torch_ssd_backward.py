"""The SSD scan's backward: the port's plain version against the JAX
package's gradient, and the differentiable ``ops.ssd_scan`` on the CPU.

``ssd_chunked.ssd_scan_chunked_bwd`` (autograd of the port's chunked
form: the plain version the backward kernel of ``csrc/ssd_scan.cu`` is
held to on the card) against ``jax.vjp`` of the reference's
``repro.kernels.ssd_chunked.ssd_scan_chunked`` (the XLA route the JAX
package trains through), on the same float32 inputs drawn with numpy:
every gradient within 1e-5 of its scale, max(1, max|jax|).  Then
``ops.ssd_scan`` on CPU tensors (the plain route, differentiable) and the
``torch.autograd.Function`` the card route goes through, its kernels
replaced by their plain versions.  The kernels themselves run only on a
card (``tests/test_torch_cuda.py``).

    PYTHONPATH=src python -m pytest tests/test_torch_ssd_backward.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunked import ssd_scan_chunked as j_ssd_scan_chunked
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_chunked import (ssd_scan_chunked,
                                             ssd_scan_chunked_bwd)
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _inputs(B, S, H, P, G, N, with_h0, dh, seed):
    """numpy float32 (x, dt, A, B_, C_, h0 or None, dy, dh or None)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x = normal(B, S, H, P)
    dt = np.log1p(np.exp(normal(B, S, H) - 1.0)).astype(np.float32)
    A = -np.exp(normal(H)).astype(np.float32)
    Bm, Cm = normal(B, S, G, N), normal(B, S, G, N)
    h0 = normal(B, H, P, N) if with_h0 else None
    dy = normal(B, S, H, P)
    dhv = {"zero": np.zeros((B, H, P, N), np.float32),
           "given": normal(B, H, P, N)}[dh]
    return x, dt, A, Bm, Cm, h0, dy, dhv


def _jax_grads(x, dt, A, Bm, Cm, h0, dy, dh, chunk):
    start = np.zeros_like(dh) if h0 is None else h0

    def f(*args):
        return j_ssd_scan_chunked(*args[:5], chunk=chunk, h0=args[5])
    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, dt, A, Bm, Cm, start)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


def _close_scaled(name, got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{name}: {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("dh", ["zero", "given"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_backward_matches_jax_vjp(G, chunk, with_h0, dh):
    """``ssd_scan_chunked_bwd`` = ``jax.vjp`` of the reference's chunked
    form: all six gradients within 1e-5 of their scale; a zero dh gives
    the same gradients as no dh."""
    B, S, H, P, N = 2, 48, 4, 8, 16
    ins = _inputs(B, S, H, P, G, N, with_h0, dh, seed=17 * G + chunk)
    want = _jax_grads(*ins, chunk)
    t = [None if a is None else torch.from_numpy(a) for a in ins]
    got = ssd_scan_chunked_bwd(*t, chunk=chunk)
    for name, g, w, like in zip(NAMES, got, want, (t[0], t[1], t[2], t[3],
                                                   t[4], t[7])):
        assert g.dtype == torch.float32 and g.shape == like.shape, name
        _close_scaled(name, g.numpy(), w, 1e-5)
    if dh == "zero":
        for name, a, b in zip(NAMES, got, ssd_scan_chunked_bwd(
                *t[:7], None, chunk=chunk)):
            assert torch.equal(a, b), name


def test_plain_backward_keeps_the_input_dtype():
    """bf16 inputs: dx, dB, dC come back in bf16, ddt, dA, dh0 in f32, as
    the kernel returns them."""
    ins = _inputs(1, 32, 2, 8, 1, 8, False, "given", seed=3)
    t = [None if a is None else torch.from_numpy(a) for a in ins]
    for i in (0, 3, 4, 6):
        t[i] = t[i].to(torch.bfloat16)
    got = ssd_scan_chunked_bwd(*t, chunk=16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]


def _leaves(ins, with_h0):
    x, dt, A, Bm, Cm, h0 = (None if a is None else
                            torch.from_numpy(a).requires_grad_(True)
                            for a in ins[:6])
    return [x, dt, A, Bm, Cm] + ([h0] if with_h0 else [])


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_on_the_cpu_is_differentiable(with_h0):
    """``ops.ssd_scan`` on CPU tensors takes the chunked form: its outputs
    and, through autograd, its gradients equal ``ssd_scan_chunked``'s; the
    backward wrapper's CPU route is the plain version."""
    ins = _inputs(2, 32, 4, 8, 2, 8, with_h0, "given", seed=5)
    dy, dh = (torch.from_numpy(a) for a in ins[6:])
    got_in, want_in = _leaves(ins, with_h0), _leaves(ins, with_h0)
    h0g = got_in[5] if with_h0 else None
    h0w = want_in[5] if with_h0 else None
    y, h = kops.ssd_scan(*got_in[:5], chunk=8, h0=h0g)
    wy, wh = ssd_scan_chunked(*want_in[:5], chunk=8, h0=h0w)
    assert y.grad_fn is not None and h.grad_fn is not None
    assert torch.equal(y, wy) and torch.equal(h, wh)
    got = torch.autograd.grad([y, h], got_in, [dy, dh])
    want = torch.autograd.grad([wy, wh], want_in, [dy, dh])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plain = kops.ssd_scan_bwd(*[t.detach() for t in want_in[:5]],
                              None if h0w is None else h0w.detach(), dy, dh,
                              chunk=8)
    for g, w in zip(plain, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
def test_the_card_routes_autograd_function(monkeypatch, with_h0):
    """The Function the card route takes (``_SSDScan``), its two kernel
    calls replaced by the plain versions: it saves the inputs, hands y's
    and h_final's gradients to the backward (a strided dy made
    contiguous, an unused h_final as no dh) and returns h0's gradient
    only where h0 was given."""
    seen = []

    def fake_bwd(x, dt, A, B_, C_, h0, dy, dh, *, chunk):
        seen.append((dy.is_contiguous(), dh is None))
        return ssd_scan_chunked_bwd(x, dt, A, B_, C_, h0, dy.contiguous(),
                                    dh, chunk=chunk)

    def fake_fwd(x, dt, A, B_, C_, h0, chunk):
        return ssd_scan_chunked(x, dt, A, B_, C_, chunk=chunk, h0=h0)
    monkeypatch.setattr(tssd, "_forward", fake_fwd)
    monkeypatch.setattr(tssd, "ssd_scan_bwd", fake_bwd)
    ins = _inputs(2, 32, 4, 8, 1, 8, with_h0, "given", seed=9)
    got_in, want_in = _leaves(ins, with_h0), _leaves(ins, with_h0)
    h0g = got_in[5] if with_h0 else None
    h0w = want_in[5] if with_h0 else None
    w = torch.randn((32, 2, 4, 8), generator=torch.Generator()
                    .manual_seed(0)).permute(1, 0, 2, 3)
    y, _ = tssd._SSDScan.apply(*got_in[:5], h0g, 8)
    got = torch.autograd.grad((y * w).sum(), got_in)
    wy, _ = ssd_scan_chunked(*want_in[:5], chunk=8, h0=h0w)
    want = torch.autograd.grad((wy * w).sum(), want_in)
    assert seen == [(False, True)]
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the backward kernels' decomposition and product rule, emulated
# ---------------------------------------------------------------------------

def _tf32(a: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """f32 cut to TF32 (10 mantissa bits): to nearest, ties away from zero
    (the kernel's rounding of a big half, by its bits), or by truncation
    (what the tensor cores do to the bits of a small half)."""
    bits = a.contiguous().view(torch.int32)
    return (((bits + 0x1000) if nearest else bits) & ~0x1FFF).view(
        torch.float32)


def _product(rule: str):
    """a @ b (float64 operands) under one of the kernels' product rules:
    ``"f64"`` exact; ``"3xtf32"`` (the kernel's rule for f32 operands)
    each operand in f32 as big = tf32(a) (to nearest) + small = a - big
    (its bits past TF32 dropped), the sum of small.big, big.small and
    big.big in f32; ``"tf32"`` / ``"bf16"``
    each f32 operand rounded once, one product in f32.  The result comes
    back in float64."""
    if rule == "f64":
        return torch.matmul

    def split(a):
        big = _tf32(a)
        return big, _tf32(a - big, nearest=False)

    def mm(a, b):
        a, b = a.float(), b.float()
        if rule == "3xtf32":
            (ab, as_), (bb, bs) = split(a), split(b)
            out = as_ @ bb + ab @ bs + ab @ bb
        elif rule == "tf32":
            out = _tf32(a) @ _tf32(b)
        else:
            out = a.bfloat16().float() @ b.bfloat16().float()
        return out.double()
    return mm


def kernel_backward(x, dt, A, Bm, Cm, h0, dy, dh, chunk, rule):
    """The SSD scan's backward as ``csrc/ssd_scan.cu`` decomposes it in
    float64, every matrix product under ``rule`` (``_product``).  A: La
    (left to right), the decays, the chunk states and E_c; B: the states
    at the chunks' starts and the reverse pass (dS, <dS, h>, dh0); C: per
    64-row source tile, the state terms, then each target tile from the
    diagonal on (C.B and dy.x once, M1, M2, dx, dB, the direct ddt, and
    the pair's partials of dC and dLa, the inter term on the diagonal);
    D: dLa, its reverse cumsum, ddt, dA, and dB / dC over a group's
    heads.  Returns (dx, ddt, dA, dB, dC, dh0) in float64."""
    f = torch.float64
    mm = _product(rule)
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, L, T = H // G, chunk, 64
    nc, nt = S // L, -(-L // T)

    def heads(t):                                   # [B,S,H,k] -> [B,H,S,k]
        return t.to(f).permute(0, 2, 1, 3)
    xs, dys = heads(x), heads(dy)
    Bs = heads(Bm.to(f).repeat_interleave(rep, dim=2))
    Cs = heads(Cm.to(f).repeat_interleave(rep, dim=2))
    dts = dt.to(f).permute(0, 2, 1)                 # [B,H,S]
    a = dts * A.to(f)[None, :, None]
    La = a.reshape(Bb, H, nc, L).cumsum(-1)        # [B,H,nc,L]
    last = La[..., -1]
    tr = lambda t: t.transpose(-1, -2)             # noqa: E731

    # A and B
    h = torch.zeros((Bb, H, P, N), dtype=f) if h0 is None else h0.to(f)
    hstart, E = [], []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        w = torch.exp(last[..., c, None] - La[..., c, :]) * dts[..., sl]
        Sc = mm(tr(xs[..., sl, :] * w[..., None]), Bs[..., sl, :])
        E.append(mm(tr(dys[..., sl, :] * torch.exp(La[..., c, :])[..., None]),
                    Cs[..., sl, :]))
        hstart.append(h)
        h = torch.exp(last[..., c])[..., None, None] * h + Sc
    g = torch.zeros((Bb, H, P, N), dtype=f) if dh is None else dh.to(f)
    dS, hdot = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dS[c] = g
        hdot[c] = (g * hstart[c]).sum((-1, -2))
        g = torch.exp(last[..., c])[..., None, None] * g + E[c]
    dh0 = g

    # C
    dx, dBh = torch.zeros_like(xs), torch.zeros_like(Bs)
    ddt_dir = torch.zeros_like(dts)
    qsum = torch.zeros((Bb, H, nc, nt), dtype=f)
    dla_part, dc_part = {}, {}
    for c in range(nc):
        lac = La[..., c, :]
        for si in range(nt):
            s_ = slice(si * T, min(L, si * T + T))
            rows = slice(c * L + s_.start, c * L + s_.stop)
            xt, bt, dtt = xs[..., rows, :], Bs[..., rows, :], dts[..., rows]
            w = torch.exp(last[..., c, None] - lac[..., s_])
            dxa = mm(bt, tr(dS[c]))                # B_s . dS^T [s][p]
            dba = mm(xt, dS[c])                    # x_s . dS [s][n]
            q = w * (xt * dxa).sum(-1)
            dxa = dxa * (w * dtt)[..., None]
            dba = dba * (w * dtt)[..., None]
            ddt_r = torch.zeros_like(dtt)
            for tj in range(si, nt):
                t_ = slice(tj * T, min(L, tj * T + T))
                cols = slice(c * L + t_.start, c * L + t_.stop)
                dyt, ct = dys[..., cols, :], Cs[..., cols, :]
                dca = torch.zeros(ct.shape, dtype=f)
                dla_int = 0.0
                if tj == si:
                    dca = torch.exp(lac[..., t_])[..., None] * mm(dyt,
                                                                  hstart[c])
                    dla_int = (ct * dca).sum(-1)
                cb, dyx = mm(bt, tr(ct)), mm(xt, tr(dyt))   # [s][t]
                sp = torch.arange(s_.start, s_.stop)[:, None]
                tp = torch.arange(t_.start, t_.stop)[None, :]
                diff = lac[..., t_][..., None, :] - lac[..., s_][..., :, None]
                dec = torch.where(sp <= tp, torch.exp(
                    torch.where(sp <= tp, diff, 0.0)), 0.0)
                cbd = cb * dec
                ddt_r = ddt_r + (cbd * dyx).sum(-1)
                m1 = cbd * dtt[..., None]
                m2 = dyx * dec * dtt[..., None]
                dla_part[c, si, tj] = (cb * m2).sum(-2) + dla_int
                dxa = dxa + mm(m1, dyt)
                dba = dba + mm(m2, ct)
                dc_part[c, si, tj] = dca + mm(tr(m2), bt)
            ddt_dir[..., rows] = ddt_r + q
            qsum[..., c, si] = (dtt * q).sum(-1)
            dx[..., rows, :], dBh[..., rows, :] = dxa, dba

    # D
    ddt = torch.zeros_like(dts)
    dA = torch.zeros(H, dtype=f)
    dC = torch.zeros_like(Cs)
    for c in range(nc):
        rows = slice(c * L, (c + 1) * L)
        dla = torch.cat([sum(dla_part[c, si, tj] for si in range(tj + 1))
                         for tj in range(nt)], -1)
        dla = dla - dts[..., rows] * ddt_dir[..., rows]
        dla[..., -1] += (qsum[..., c, :].sum(-1)
                         + torch.exp(last[..., c]) * hdot[c])
        rc = dla.flip(-1).cumsum(-1).flip(-1)
        ddt[..., rows] = ddt_dir[..., rows] + A.to(f)[None, :, None] * rc
        dA = dA + (dts[..., rows] * rc).sum((0, 2))
        dC[..., rows, :] = torch.cat(
            [sum(dc_part[c, si, tj] for si in range(tj + 1))
             for tj in range(nt)], -2)

    def groups(t):                                 # [B,H,S,N] -> [B,S,G,N]
        return t.permute(0, 2, 1, 3).reshape(Bb, S, G, rep, N).sum(3)
    return (dx.permute(0, 2, 1, 3), ddt.permute(0, 2, 1), dA, groups(dBh),
            groups(dC), dh0)


#: (B, S, H, P, G, N, chunk): two 64-row tiles, a ragged second tile
#: (chunk 80), P and N below one mma tile, two groups and batch rows
EMULATED = [(2, 256, 4, 8, 2, 16, 128), (1, 160, 2, 16, 1, 8, 80),
            (2, 96, 4, 4, 2, 4, 16)]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", EMULATED)
def test_kernel_decomposition_matches_the_plain_backward(B, S, H, P, G, N,
                                                         chunk):
    """The backward kernels' decomposition (``kernel_backward``) with exact
    float64 products equals the plain backward (autograd of the chunked
    form, f32) within 1e-5 of each gradient's scale: the tile pairs, their
    partials, the last position's terms and the reverse cumsum add up to
    the gradient."""
    ins = _inputs(B, S, H, P, G, N, True, "given", seed=B * S + N)
    t = [None if a is None else torch.from_numpy(a) for a in ins]
    want = ssd_scan_chunked_bwd(*t, chunk=chunk)
    got = kernel_backward(*t, chunk, "f64")
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close_scaled(name, g.numpy(), w.numpy(), 1e-5)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", EMULATED)
def test_three_tf32_passes_hold_f32_accuracy(B, S, H, P, G, N, chunk):
    """The kernels' rule for f32 operands (3xTF32: big.big + big.small +
    small.big of TF32 halves, f32 sums, small's bits past TF32 dropped) on
    every product of the
    decomposition keeps each gradient within 1e-5 of its scale of the exact
    float64 products; one rounded pass (TF32 or bf16, as a single
    tensor-core product would take an f32 operand) misses that bound: the
    split is what holds f32 accuracy."""
    ins = _inputs(B, S, H, P, G, N, True, "given", seed=B * S + N)
    t = [None if a is None else torch.from_numpy(a) for a in ins]
    exact = kernel_backward(*t, chunk, "f64")
    for name, g, w in zip(NAMES, kernel_backward(*t, chunk, "3xtf32"), exact):
        _close_scaled(name, g.numpy(), w.numpy(), 1e-5)
    for rule in ("tf32", "bf16"):
        worst = max(float((g - w).abs().max())
                    / max(1.0, float(w.abs().max()))
                    for g, w in zip(kernel_backward(*t, chunk, rule), exact))
        assert worst > 1e-5, f"{rule}: {worst:.3g} of scale"
