"""Attention-weights port (speech2text_torch/ops/attn_weights.py, the
plain version of the CUDA kernel) against the JAX Pallas kernel
`zip_weights` (interpret mode on CPU) and the XLA oracle `xla_weights`,
with the tolerances of tests/test_flash_attn.py: 1e-5 in f32, 2e-2 in
bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.ops.pallas.flash_attn import xla_weights, zip_weights
from speech2text_torch.ops.attn_weights import attn_weights_plain
from speech2text_torch.ops.attn_weights import zip_weights as port_weights

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B=2, T=37, H=2, qd=8, pd=4, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, T, H, qd), f(B, T, H, qd), f(B, T, H, pd), f(2 * T - 1, H, pd)


def _mask(kind, B, T):
    t = np.arange(T)
    if kind == "none":
        return None
    if kind == "chunk":
        m = (t[None, :] // 8) <= (t[:, None] // 8)
        return np.array(np.broadcast_to(m, (B, T, T)))
    # pad mask: the second utterance's tail rows have every key masked
    lens = np.array([T] + [T // 2] * (B - 1))
    pad = t[None, :] < lens[:, None]
    return pad[:, None, :] & pad[:, :, None]


def _both(arrays, mask, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    j = [jnp.asarray(a, jdt) for a in arrays]
    t = [torch.from_numpy(a).to(tdt) for a in arrays]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    got = port_weights(*t, tm, w_dtype=tdt)
    assert got.dtype == tdt
    return got.float().numpy(), j, jm


@pytest.mark.parametrize("mask_kind", ["none", "chunk", "pad"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matches_pallas_and_xla(mask_kind, dtype):
    arrays = _inputs()
    mask = _mask(mask_kind, 2, 37)
    got, j, jm = _both(arrays, mask, dtype)
    jdt, _, tol = DTYPES[dtype]
    for want in (zip_weights(*j, jm, w_dtype=jdt),
                 xla_weights(*j, jm, None, jdt)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=2e-2)
    if mask is not None:
        # masked keys of rows with a valid key get exactly zero weight;
        # rows with none get uniform weights, as in JAX
        m = np.broadcast_to(mask[:, None], got.shape)
        live = m.any(-1, keepdims=True)
        assert (got[~m & live] == 0).all()
        dead = np.broadcast_to(~live, got.shape)
        np.testing.assert_allclose(got[dead], 1.0 / 37, rtol=tol)


@pytest.mark.parametrize("T", [29, 128, 131])
def test_tile_boundaries(T):
    arrays = _inputs(T=T)
    mask = _mask("chunk", 2, T)
    got, j, jm = _both(arrays, mask, "f32")
    want = zip_weights(*j, jm, w_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_clip_before_mask():
    """Scores far beyond ±100 are clipped before masking: a row of equal
    clipped scores is uniform over its allowed keys."""
    q, k, qp, p = _inputs(B=1, T=9)
    q *= 100.0
    k[:] = np.abs(k) * np.sign(q[:, :1])   # same sign as q: huge scores
    mask = _mask("chunk", 1, 9)
    got = attn_weights_plain(*map(torch.from_numpy, (q, k, qp, p)),
                             torch.from_numpy(mask), torch.float32)
    want = xla_weights(*map(jnp.asarray, (q, k, qp, p)), jnp.asarray(mask),
                       None, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["bf16_pd8", "mask_shape", "qd16",
                                  "dtype_pair"])
def test_cuda_wrapper_rejects_unsupported(case):
    """The kernel wrapper raises on what the kernels do not take, before
    anything is built or launched."""
    from speech2text_torch.ops.attn_weights import attn_weights_cuda
    qd = 16 if case == "qd16" else 32
    pd = 8 if case == "bf16_pd8" else 4
    q, k, qp, p = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(B=1, T=5, H=1, qd=qd, pd=pd))
    w_dtype = torch.float32 if case == "dtype_pair" else torch.bfloat16
    mask = torch.ones((1, 5, 4), dtype=torch.bool) \
        if case == "mask_shape" else None
    with pytest.raises(ValueError):
        attn_weights_cuda(q, k, qp, p, mask, w_dtype)
