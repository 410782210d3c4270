"""Zipformer attention weights, plain PyTorch only (the port's
speech2text_torch/ops/attn_weights.py without kernel B1): scores in f32
from bf16 or f32 inputs, clip to ±100, masked scores set to −1e30, row
softmax in f32, the result cast to `w_dtype`. Layouts: q, k (B,T,H,qd),
qp (B,T,H,pd), p (2T−1,H,pd), mask (B,T,T) bool, weights (B,H,T,T).
`zip_weights` keeps the port's gradient (the softmax vjp off the saved
output weights, the clip taken as identity), so that the reference holds
no more activations than the program does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


NEG = -1e30


def toeplitz_index(T: int, device) -> torch.Tensor:
    """(T, T) rows of the (2T−1)-row table that the score of (t, s) reads:
    (t−s)+(T−1)."""
    t = torch.arange(T, device=device)
    return t[:, None] - t[None, :] + (T - 1)


def attn_weights_plain(q: torch.Tensor, k: torch.Tensor, qp: torch.Tensor,
                       p: torch.Tensor, mask: Optional[torch.Tensor],
                       w_dtype: torch.dtype) -> torch.Tensor:
    B, T, H, qd = q.shape
    pd = qp.shape[-1]
    q, k, qp, p = (t.float() for t in (q, k, qp, p))
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(qd)
    # rel[b,h,t,r] = qp[b,t,h]·p[r,h]; the score of (t, s) takes r = t−s+T−1
    rel = torch.einsum("bthd,rhd->bhtr", qp, p)
    r_idx = toeplitz_index(T, q.device).expand(B, H, T, T)
    scores = scores + torch.gather(rel, 3, r_idx) / math.sqrt(pd)
    scores = scores.clamp(-100.0, 100.0)
    if mask is not None:
        scores = torch.where(mask[:, None], scores, NEG)
    return torch.softmax(scores, dim=-1).to(w_dtype)


def attn_weights_backward(q: torch.Tensor, k: torch.Tensor,
                          qp: torch.Tensor, p: torch.Tensor, w: torch.Tensor,
                          dw: torch.Tensor):
    """(dq, dk, dqp, dp) from the saved weights `w` and their cotangent, as
    flash_attn.py:_bwd computes them: dS = W⊙(dW − rowsum(dW⊙W)) in f32,
    cast to w's dtype; the four contractions then scale in f32 and return
    in each input's dtype. Masked keys have W = 0 and so dS = 0; a fully
    masked row (uniform W) has dS ≠ 0, as in JAX. dp sums the windows'
    gradient over each table row with index_add_."""
    T = q.shape[1]
    qd, pd = q.shape[-1], qp.shape[-1]
    wf, dwf = w.float(), dw.float()
    ds = (wf * (dwf - (dwf * wf).sum(-1, keepdim=True))).to(w.dtype)

    def dot(eq, a, b, scale):
        ct = torch.promote_types(a.dtype, b.dtype)
        return torch.einsum(eq, a.to(ct), b.to(ct)).float() * scale

    inv_sq, inv_sp = 1.0 / math.sqrt(qd), 1.0 / math.sqrt(pd)
    dq = dot("bhts,bshd->bthd", ds, k, inv_sq)
    dk = dot("bhts,bthd->bshd", ds, q, inv_sq)
    idx = toeplitz_index(T, q.device)
    dqp = dot("bhts,tshd->bthd", ds, p[idx], inv_sp)
    dpw = dot("bhts,bthd->tshd", ds, qp, inv_sp).to(p.dtype)   # (T,T,H,pd)
    dp = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dp.index_add_(0, idx.reshape(-1),
                  dpw.float().reshape(T * T, *p.shape[1:]))
    return dq.to(q.dtype), dk.to(k.dtype), dqp.to(qp.dtype), dp.to(p.dtype)


class _ZipWeights(torch.autograd.Function):
    """The weights with the gradient of flash_attn.py's custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, qp, p, mask, w_dtype):
        w = attn_weights_plain(q, k, qp, p, mask, w_dtype)
        ctx.save_for_backward(q, k, qp, p, w)
        return w

    @staticmethod
    def backward(ctx, dw):
        q, k, qp, p, w = ctx.saved_tensors
        return (*attn_weights_backward(q, k, qp, p, w, dw), None, None)


def zip_weights(q: torch.Tensor, k: torch.Tensor, qp: torch.Tensor,
                p: torch.Tensor, mask: Optional[torch.Tensor] = None,
                w_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Softmaxed zipformer attention weights (B,H,T,T) in `w_dtype`,
    differentiable in q, k, qp and p."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, qp, p)):
        return _ZipWeights.apply(q, k, qp, p, mask, w_dtype)
    return attn_weights_plain(q, k, qp, p, mask, w_dtype)
