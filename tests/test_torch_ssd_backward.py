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
