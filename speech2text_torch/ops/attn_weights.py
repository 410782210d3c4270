"""Zipformer attention weights: kernel B1's wrapper and its plain version.

`zip_weights` dispatches on the queries' device: a CPU tensor takes
`attn_weights_plain`, a CUDA tensor launches csrc/attn_weights.cu or
raises (bf16: the tensor-core kernel, f32: the f32-FMA kernel). The
plain version mirrors
speech2text_tpu/ops/pallas/flash_attn.py:xla_weights (without the
const-row option, which only training uses): scores in f32 from bf16 or
f32 inputs, clip to ±100, masked scores set to −1e30, row softmax in f32,
the result cast to `w_dtype`. Layouts are the JAX ones:
q, k (B,T,H,qd), qp (B,T,H,pd), p (2T−1,H,pd), mask (B,T,T) bool,
weights (B,H,T,T).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .build import (CudaKernel, on_device, ptr, ready, stream_handle,
                    use_kernel)

NEG = -1e30
ENTRY = "attn_weights_forward"
KERNEL = CudaKernel("attn_weights", "attn_weights.cu", entries={
    ENTRY: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]})
KERNEL_QD = 32       # the flagship's query_head_dim, the one variant built
KERNEL_PD_BF16 = 4   # the bf16 (tensor-core) kernel's pos_head_dim


def attn_weights_plain(q: torch.Tensor, k: torch.Tensor, qp: torch.Tensor,
                       p: torch.Tensor, mask: Optional[torch.Tensor],
                       w_dtype: torch.dtype) -> torch.Tensor:
    B, T, H, qd = q.shape
    pd = qp.shape[-1]
    q, k, qp, p = (t.float() for t in (q, k, qp, p))
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(qd)
    # rel[b,h,t,r] = qp[b,t,h]·p[r,h]; the score of (t, s) takes r = t−s+T−1
    rel = torch.einsum("bthd,rhd->bhtr", qp, p)
    t_idx = torch.arange(T, device=q.device)
    r_idx = (t_idx[:, None] - t_idx[None, :] + (T - 1)).expand(B, H, T, T)
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


def zip_weights(q: torch.Tensor, k: torch.Tensor, qp: torch.Tensor,
                p: torch.Tensor, mask: Optional[torch.Tensor] = None,
                w_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Softmaxed zipformer attention weights (B,H,T,T) in `w_dtype`."""
    if use_kernel(q.device):
        return attn_weights_cuda(q, k, qp, p, mask, w_dtype)
    return attn_weights_plain(q, k, qp, p, mask, w_dtype)
