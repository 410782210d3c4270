"""Zipformer attention weights: kernel B1's wrapper, its plain version and
its gradient.

The forward is the custom op `speech2text_torch::attn_weights`, so that
`torch.export` records it as one node (its fake implementation gives the
shape and dtype) and a reloaded program launches the kernel. The op
dispatches on the queries' device: a CPU tensor takes
`attn_weights_plain`, a CUDA tensor launches csrc/attn_weights.cu or
raises (bf16: the tensor-core kernel, f32: the f32-FMA kernel). The
plain version mirrors
speech2text_tpu/ops/pallas/flash_attn.py:xla_weights (without the
const-row option, which only the training dynamics use): scores in f32
from bf16 or f32 inputs, clip to ±100, masked scores set to −1e30, row
softmax in f32, the result cast to `w_dtype`. Layouts are the JAX ones:
q, k (B,T,H,qd), qp (B,T,H,pd), p (2T−1,H,pd), mask (B,T,T) bool,
weights (B,H,T,T).

`zip_weights` is differentiable where its inputs require grad: an
autograd.Function (`_ZipWeights`, the port of flash_attn.py:172-211)
saves the OUTPUT weights and its backward (`attn_weights_backward`, plain
torch on the CPU and the card alike) is the softmax vjp off them, with
the ±100 clip taken as identity and no gradient for the mask, as JAX's
`_bwd` does. That backward is the span "attn_weights_backward"
(utils/tracing.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..utils.tracing import span
from .build import (CudaKernel, on_device, ptr, ready, stream_handle,
                    use_kernel)

NEG = -1e30
ENTRY = "attn_weights_forward"
KERNEL = CudaKernel("attn_weights", "attn_weights.cu", entries={
    ENTRY: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]})
KERNEL_QD = 32       # the flagship's query_head_dim, the one variant built
KERNEL_PD_BF16 = 4   # the bf16 (tensor-core) kernel's pos_head_dim


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


def attn_weights_cuda(q: torch.Tensor, k: torch.Tensor, qp: torch.Tensor,
                      p: torch.Tensor, mask: Optional[torch.Tensor],
                      w_dtype: torch.dtype) -> torch.Tensor:
    """Launch csrc/attn_weights.cu on CUDA tensors."""
    B, T, H, qd = q.shape
    pd = qp.shape[-1]
    if k.shape != q.shape or qp.shape[:3] != (B, T, H) or \
            p.shape != (2 * T - 1, H, pd):
        raise ValueError(f"attention-weight shapes disagree: q {q.shape} "
                         f"k {k.shape} qp {qp.shape} p {p.shape}")
    if qd != KERNEL_QD:
        raise ValueError(f"attention-weight kernel takes qd={KERNEL_QD}, "
                         f"got {qd}")
    if q.dtype not in (torch.bfloat16, torch.float32) or w_dtype != q.dtype:
        raise ValueError(f"attention-weight kernel takes bf16 or f32 "
                         f"inputs and writes their dtype, got {q.dtype} "
                         f"→ {w_dtype}")
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16 and pd != KERNEL_PD_BF16:
        raise ValueError(f"the bf16 attention-weight kernel takes "
                         f"pd={KERNEL_PD_BF16}, got {pd}")
    dev = q.device
    q, k, qp, p = (ready(t, dev, q.dtype) for t in (q, k, qp, p))
    if mask is not None:
        if mask.shape != (B, T, T):
            raise ValueError(f"mask {mask.shape} is not {(B, T, T)}")
        mask = ready(mask, dev, torch.bool)
    out = torch.empty((B, H, T, T), dtype=w_dtype, device=dev)
    fn = KERNEL.entry(ENTRY)
    with on_device(dev):
        rc = fn(ptr(q), ptr(k), ptr(qp), ptr(p), ptr(mask), ptr(out),
                B, T, H, qd, pd, int(is_bf16), stream_handle(dev))
    KERNEL.check(rc)
    return out


@torch.library.custom_op("speech2text_torch::attn_weights", mutates_args=())
def attn_weights_op(q: torch.Tensor, k: torch.Tensor, qp: torch.Tensor,
                    p: torch.Tensor, mask: Optional[torch.Tensor],
                    w_dtype: torch.dtype) -> torch.Tensor:
    """The weights on the CPU by the plain version, on the card by the
    kernel."""
    if use_kernel(q.device):
        return attn_weights_cuda(q, k, qp, p, mask, w_dtype)
    return attn_weights_plain(q, k, qp, p, mask, w_dtype)


@attn_weights_op.register_fake
def _(q, k, qp, p, mask, w_dtype):
    B, T, H, _ = q.shape
    return q.new_empty((B, H, T, T), dtype=w_dtype)


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
        w = attn_weights_op(q, k, qp, p, mask, w_dtype)
        ctx.save_for_backward(q, k, qp, p, w)
        return w

    @staticmethod
    def backward(ctx, dw):
        q, k, qp, p, w = ctx.saved_tensors
        with span("attn_weights_backward"):
            grads = attn_weights_backward(q, k, qp, p, w, dw)
        return (*grads, None, None)


def zip_weights(q: torch.Tensor, k: torch.Tensor, qp: torch.Tensor,
                p: torch.Tensor, mask: Optional[torch.Tensor] = None,
                w_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Softmaxed zipformer attention weights (B,H,T,T) in `w_dtype`,
    differentiable in q, k, qp and p."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, qp, p)):
        return _ZipWeights.apply(q, k, qp, p, mask, w_dtype)
    return attn_weights_op(q, k, qp, p, mask, w_dtype)
