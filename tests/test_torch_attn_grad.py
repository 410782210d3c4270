"""Gradient of kernel B1's wrapper (speech2text_torch/ops/attn_weights.py:
zip_weights through its autograd.Function, the plain forward on the CPU)
against jax.grad through the JAX package's `zip_weights` (the Pallas
kernel in interpret mode and its custom_vjp).

Tolerances: f32 rtol 1e-4 (atol 1e-6), bf16 JAX's 2e-2 (atol 2e-2 of the
gradient's largest entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.ops.pallas.flash_attn import zip_weights as jzip
from speech2text_torch.ops import attn_weights as aw

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}


def _case(seed, B=2, T=23, H=2, qd=8, pd=4, mask="pad", big=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, qp, p = f(B, T, H, qd), f(B, T, H, qd), f(B, T, H, pd), \
        f(2 * T - 1, H, pd)
    if big:
        # |score| > 100 on part of the rows: the clip is taken as identity
        q[:, : T // 2] *= 40.0
    t = np.arange(T)
    if mask == "pad":
        # the second utterance's tail rows have every key masked
        lens = np.array([T] + [T // 2] * (B - 1))
        pad = t[None] < lens[:, None]
        m = pad[:, None, :] & pad[:, :, None]
    elif mask == "chunk":
        m = np.broadcast_to((t[None] // 4) <= (t[:, None] // 4),
                            (B, T, T)).copy()
    else:
        m = None
    dw = f(B, H, T, T)
    return (q, k, qp, p), m, dw


def _grads(arrays, mask, dw, dtype):
    jdt, tdt = DT[dtype]
    jm = None if mask is None else jnp.asarray(mask)
    ja = [jnp.asarray(a, jdt) for a in arrays]
    jdw = jnp.asarray(dw, jdt)
    want = jax.grad(lambda *a: jnp.sum(
        (jzip(*a, jm, w_dtype=jdt) * jdw).astype(jnp.float32)),
        argnums=(0, 1, 2, 3))(*ja)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    tm = None if mask is None else torch.from_numpy(mask)
    w = aw.zip_weights(*ts, tm, w_dtype=tdt)
    assert w.dtype == tdt and w.grad_fn is not None
    (w * torch.from_numpy(dw).to(tdt)).float().sum().backward()
    return [t.grad for t in ts], [np.asarray(g, np.float32) for g in want]


@pytest.mark.parametrize("mask", ["pad", "chunk", "none"])
def test_grad_matches_jax_f32(mask):
    arrays, m, dw = _case(0, mask=mask)
    got, want = _grads(arrays, m, dw, "f32")
    for name, g, wv in zip(("dq", "dk", "dqp", "dp"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_grad_matches_jax_bf16():
    arrays, m, dw = _case(1, mask="pad")
    got, want = _grads(arrays, m, dw, "bf16")
    for name, g, wv in zip(("dq", "dk", "dqp", "dp"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), wv, rtol=2e-2,
                                   atol=2e-2 * np.abs(wv).max(),
                                   err_msg=name)


def test_grad_clip_as_identity():
    """Scores beyond ±100: JAX's backward ignores the clip, and so does the
    port's (a plain autograd through the clip would zero those rows)."""
    arrays, m, dw = _case(2, mask="pad", big=True)
    got, want = _grads(arrays, m, dw, "f32")
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    w = aw.attn_weights_plain(*ts, torch.from_numpy(m), torch.float32)
    (w * torch.from_numpy(dw)).sum().backward()
    assert not np.allclose(ts[0].grad.numpy(), want[0], rtol=1e-2)
    for name, g, wv in zip(("dq", "dk", "dqp", "dp"), got, want):
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(wv).max()),
                                   err_msg=name)


def test_no_grad_path_is_the_plain_forward():
    """Without inputs that need a gradient the wrapper takes the forward
    alone, with no graph."""
    arrays, m, _ = _case(3, mask="chunk")
    ts = [torch.from_numpy(a) for a in arrays]
    w = aw.zip_weights(*ts, torch.from_numpy(m), w_dtype=torch.float32)
    assert w.grad_fn is None
    assert torch.equal(w, aw.attn_weights_plain(*ts, torch.from_numpy(m),
                                                torch.float32))
