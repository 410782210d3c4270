"""Transducer lattice, forward and backward, and the full-lattice RNN-T
loss (port of speech2text_tpu/ops/rnnt.py: `lattice_forward` :26-117,
`rnnt_alpha` :121-138, the clamped NLL :148-178 and `rnnt_loss` :182-205).

The alpha recursion
    alpha[t,u] = logaddexp(alpha[t-1,u] + blank[t-1,u],
                           alpha[t,u-1] + emit[t,u-1])
runs over anti-diagonals d = t+u: every cell of a diagonal depends only on
the previous diagonal. `lattice_forward` is an autograd.Function that
dispatches on the arcs' device (`ops/build.use_kernel`): a CUDA tensor
launches kernel B3 (csrc/lattice.cu), one launch for the forward and one
for the backward; a CPU tensor takes the plain versions,
`lattice_forward_plain` (a Python loop over the T+U diagonals, each one
vectorised over (B, U+1); it also returns alpha) and
`lattice_backward_plain` (the walk back from each utterance's final cell
with the arithmetic of autograd through that loop: each cell's two
arrivals weighted by their softmax). Autograd through
`lattice_forward_plain` stays the oracle the tests hold both routes
against. `lattice_occupancies` is the total with the gradient of its sum,
one forward and one backward and no autograd graph.

`rnnt_loss` takes the joiner's raw (B, T, U+1, V) logits: an f32
log-softmax, the emit arcs gathered at the targets and the blank arcs,
then the lattice. With `clamp` ≥ 0 (torchaudio's semantics) the gradient
of each utterance's NLL with respect to its logits is clipped to
±clamp before the reduction's scale multiplies in (an autograd.Function
that takes the raw gradient in its forward, so the lattice's saved
tensors are freed there).

Conventions: blank id 0; the u=0 row is the "no label yet" state;
out-of-lattice cells hold NEG_INF (finite, so sums of two stay finite in
f32) and `_logaddexp` clamps anything at or below NEG_INF back to NEG_INF.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .build import (CudaKernel, on_device, ptr, ready, stream_handle,
                    use_kernel)

NEG_INF = -1e30
MAX_U1 = 16384          # label columns U+1 the kernel takes (16 a thread)
FORWARD, BACKWARD = "lattice_forward", "lattice_backward"
KERNEL = CudaKernel("lattice", "lattice.cu", entries={
    FORWARD: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    BACKWARD: [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
    + [ctypes.c_void_p]})


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # NaN-safe under autograd: both branches are sanitised before exp, so
    # the branch `where` does not take never gives 0/0 in the backward.
    mx = torch.maximum(a, b)
    both_inf = mx <= NEG_INF
    mx_safe = torch.where(both_inf, 0.0, mx)
    a_s = torch.where(both_inf, 0.0, a - mx_safe)
    b_s = torch.where(both_inf, 0.0, b - mx_safe)
    out = mx_safe + torch.log(torch.exp(a_s) + torch.exp(b_s))
    return torch.where(both_inf, NEG_INF, out)


def _skew_diag(a_u: torch.Tensor, value: float = NEG_INF) -> torch.Tensor:
    """(B, U1, T) row-major → (B, U1, D) diagonal-major, D = T+U1-1:
    out[b, u, d] = a_u[b, u, d-u] where 0 ≤ d-u < T, `value` elsewhere
    (pad each row to T+U1, drop the last U1 of the flat view: row u lands
    shifted right by u)."""
    B, U1, T = a_u.shape
    W = T + U1
    flat = F.pad(a_u, (0, U1), value=value).reshape(B, U1 * W)
    return flat[:, :U1 * (W - 1)].reshape(B, U1, W - 1)


def _unskew_diag(a_d: torch.Tensor, T: int) -> torch.Tensor:
    """(B, U1, D) diagonal-major → (B, T, U1):
    out[b, t, u] = a_d[b, u, t+u]."""
    B, U1, _ = a_d.shape
    idx = (torch.arange(T, device=a_d.device)[None, :]
           + torch.arange(U1, device=a_d.device)[:, None])
    return torch.gather(a_d, 2, idx.expand(B, U1, T)).transpose(1, 2)


def _final_cells(t_lens: torch.Tensor, u_lens: torch.Tensor, T: int, U: int):
    """Each utterance's final cell (t_f, u_f) = (t_lens-1+u_lens-u_f,
    clamp(u_lens, 0, U)) on diagonal d_end, whether d_end is one of the
    T+U diagonals, and whether the cell lies in the lattice."""
    d_end = t_lens - 1 + u_lens
    u_f = u_lens.clamp(0, U)
    t_f = d_end - u_f
    on_diag = (d_end >= 0) & (d_end < T + U)
    return d_end, t_f, u_f, on_diag, on_diag & (t_f >= 0) & (t_f < T)


def _masked_emits(px: torch.Tensor, u_lens: torch.Tensor) -> torch.Tensor:
    """px with the emit arcs at u ≥ u_lens (int64, px's device) at
    NEG_INF."""
    u_idx = torch.arange(px.shape[2], device=px.device)
    return torch.where(u_idx[None, None, :] < u_lens[:, None, None], px,
                       NEG_INF)


def lattice_forward_plain(px: torch.Tensor, py: torch.Tensor,
                          t_lens: torch.Tensor, u_lens: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward DP over the (T, U+1) transducer lattice, a Python loop over
    its anti-diagonals (kernel B3's plain version, differentiable).

    px: (B, T, U)   emit arc (t,u)→(t,u+1) log-prob (label y_{u+1})
    py: (B, T, U+1) blank arc (t,u)→(t+1,u) log-prob
    Returns (total (B,), alpha (B, T, U+1)): the total path log-prob, the
    path ending with a blank at (t_lens-1, u_lens); emit arcs at u ≥
    u_lens are masked out. An utterance with t_lens = 0 gets NEG_INF (or
    2·NEG_INF where its final cell lies on a diagonal but off the
    lattice)."""
    B, T, U = px.shape
    U1 = U + 1
    dev = px.device
    t_lens = t_lens.to(device=dev, dtype=torch.int64)
    u_lens = u_lens.to(device=dev, dtype=torch.int64)
    px = _masked_emits(px, u_lens)
    # [b,u,t] = px[t,u-1] (emit INTO state u); the u=0 row is unreachable
    px_u = F.pad(px, (1, 0), value=NEG_INF).transpose(1, 2)     # (B,U1,T)
    py_u = py.transpose(1, 2)                                   # (B,U1,T)
    # diagonal-major, diagonal first: (D, B, U1)
    px_d = _skew_diag(px_u).permute(2, 0, 1).unbind(0)
    py_d = _skew_diag(py_u).permute(2, 0, 1)
    py_dl = py_d.unbind(0)

    alpha = torch.full((B, U1), NEG_INF, dtype=px.dtype, device=dev)
    alpha[:, 0] = 0.0                                           # d = 0
    alphas = [alpha]
    neg = torch.full((B, 1), NEG_INF, dtype=px.dtype, device=dev)
    for d in range(1, T + U1 - 1):
        a_blank = alpha + py_dl[d - 1]       # from (t-1, u): same u
        a_emit = torch.cat([neg, alpha[:, :U]], dim=1) + px_d[d]  # (t, u-1)
        alpha = _logaddexp(a_blank, a_emit)
        alphas.append(alpha)
    # the total at each utterance's final cell (t_lens-1, u_lens), which
    # lies on diagonal d_end = t_lens-1+u_lens
    d_end, _, u_c, valid, _ = _final_cells(t_lens, u_lens, T, U)
    d_c = d_end.clamp(0, len(alphas) - 1)
    b_idx = torch.arange(B, device=dev)
    all_d = torch.stack(alphas)                                 # (D,B,U1)
    total = all_d[d_c, b_idx, u_c] + py_d[d_c, b_idx, u_c]
    return (torch.where(valid, total, NEG_INF),
            _unskew_diag(all_d.permute(1, 2, 0), T))


@torch.no_grad()
def lattice_backward_plain(px: torch.Tensor, py: torch.Tensor,
                           t_lens: torch.Tensor, u_lens: torch.Tensor,
                           alpha: torch.Tensor, total: torch.Tensor,
                           g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_px, grad_py): g (B,) times the gradient of each total with
    respect to its arcs, from `lattice_forward_plain`'s alpha and total
    (kernel B3's backward, plain).

    Each cell's two arrivals, alpha[t-1,u] + py[t-1,u] and alpha[t,u-1] +
    px[t,u-1], get the softmax weights (w_b, w_e) that autograd takes
    through `_logaddexp` (0 where both are at or below NEG_INF). The walk
    goes back over the anti-diagonals from each utterance's final cell,
    where the adjoint is 1: g[t,u] = g[t+1,u]·w_b[t+1,u] +
    g[t,u+1]·w_e[t,u+1]. The arc gradients are grad_py[t,u] =
    g[t+1,u]·w_b[t+1,u], grad_px[t,u] = g[t,u+1]·w_e[t,u+1], and 1 for
    the final blank, times g. An utterance without a path (total ≤
    NEG_INF/2, or a final cell off the lattice) or with g = 0 gets 0
    everywhere."""
    B, T, U = px.shape
    U1 = U + 1
    dev = px.device
    t_lens = t_lens.to(device=dev, dtype=torch.int64)
    u_lens = u_lens.to(device=dev, dtype=torch.int64)
    # the two arrivals at each cell (t, u), as the forward formed them
    a_b = F.pad(alpha[:, :-1] + py[:, :-1], (0, 0, 1, 0),
                value=NEG_INF + NEG_INF)
    a_e = F.pad(alpha[:, :, :-1] + _masked_emits(px, u_lens), (1, 0),
                value=NEG_INF + NEG_INF)
    mx = torch.maximum(a_b, a_e)
    both_inf = mx <= NEG_INF
    mx_safe = torch.where(both_inf, 0.0, mx)
    e_b = torch.exp(torch.where(both_inf, 0.0, a_b - mx_safe))
    e_e = torch.exp(torch.where(both_inf, 0.0, a_e - mx_safe))
    s = e_b + e_e
    w_b = torch.where(both_inf, 0.0, e_b / s)
    w_e = torch.where(both_inf, 0.0, e_e / s)
    # diagonal-major, diagonal first: (D, B, U1), 0 off the lattice
    w_bd = _skew_diag(w_b.transpose(1, 2), 0.0).permute(2, 0, 1).unbind(0)
    w_ed = _skew_diag(w_e.transpose(1, 2), 0.0).permute(2, 0, 1).unbind(0)

    d_end, t_f, u_f, _, inside = _final_cells(t_lens, u_lens, T, U)
    live = inside & (total > NEG_INF / 2) & (g != 0)
    D = T + U
    u_idx = torch.arange(U1, device=dev)
    at_end = ((torch.arange(D, device=dev)[:, None] == d_end[None, :])
              & live[None, :])                                      # (D,B)
    seed = (at_end[:, :, None]
            & (u_idx[None, :] == u_f[:, None])[None]).to(px.dtype).unbind(0)
    zero = torch.zeros((B, 1), dtype=px.dtype, device=dev)
    cb = ce = torch.zeros((B, U1), dtype=px.dtype, device=dev)
    cbs, ces = [None] * D, [None] * D
    for d in range(D - 1, -1, -1):
        adj = cb + torch.cat([ce[:, 1:], zero], dim=1) + seed[d]
        cb = adj * w_bd[d]
        ce = adj * w_ed[d]
        cbs[d], ces[d] = cb, ce
    # cb[t,u] is grad_py[t-1,u]; ce[t,u] is grad_px[t,u-1]
    cb = _unskew_diag(torch.stack(cbs).permute(1, 2, 0), T)     # (B,T,U1)
    ce = _unskew_diag(torch.stack(ces).permute(1, 2, 0), T)
    final = ((torch.arange(T, device=dev)[None, :, None]
              == t_f[:, None, None])
             & (u_idx[None, None, :] == u_f[:, None, None]))
    grad_py = torch.where(final, 1.0, F.pad(cb[:, 1:], (0, 0, 0, 1)))
    gl = torch.where(live, g, 0.0).to(px.dtype)[:, None, None]
    keep = live[:, None, None]
    return (torch.where(keep, ce[:, :, 1:] * gl, 0.0),
            torch.where(keep, grad_py * gl, 0.0))


def _check_arcs(px: torch.Tensor, py: torch.Tensor, t_lens: torch.Tensor,
                u_lens: torch.Tensor) -> None:
    """Raise ValueError unless the operands are what kernel B3 takes:
    px (B, T, U) and py (B, T, U+1) f32 on one CUDA device, U+1 ≤ MAX_U1,
    integer lengths (B,)."""
    if px.dim() != 3 or py.dim() != 3 or \
            tuple(py.shape) != (*px.shape[:2], px.shape[2] + 1):
        raise ValueError(f"lattice arcs px {tuple(px.shape)} and py "
                         f"{tuple(py.shape)} are not (B,T,U) and (B,T,U+1)")
    B = px.shape[0]
    if tuple(t_lens.shape) != (B,) or tuple(u_lens.shape) != (B,):
        raise ValueError(f"lattice lengths {tuple(t_lens.shape)} and "
                         f"{tuple(u_lens.shape)} are not ({B},)")
    if px.dtype != torch.float32 or py.dtype != torch.float32:
        raise ValueError(f"the lattice kernel takes f32 arcs, got "
                         f"{px.dtype} and {py.dtype}")
    if t_lens.is_floating_point() or u_lens.is_floating_point() or \
            t_lens.is_complex() or u_lens.is_complex():
        raise ValueError(f"lattice lengths must be integers, got "
                         f"{t_lens.dtype} and {u_lens.dtype}")
    if px.shape[2] + 1 > MAX_U1:
        raise ValueError(f"the lattice kernel takes U+1 ≤ {MAX_U1}, got "
                         f"{px.shape[2] + 1}")
    if px.device.type != "cuda" or py.device != px.device:
        raise ValueError(f"the lattice kernel takes arcs on one CUDA "
                         f"device, got {px.device} and {py.device}")


def lattice_forward_cuda(px: torch.Tensor, py: torch.Tensor,
                         t_lens: torch.Tensor, u_lens: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3's forward on CUDA tensors: (total (B,), alpha (B, T,
    U+1)); alpha is written on the diagonals up to each utterance's final
    cell, the cells its backward reads."""
    _check_arcs(px, py, t_lens, u_lens)
    B, T, U = px.shape
    dev = px.device
    total = torch.empty((B,), dtype=torch.float32, device=dev)
    alpha = torch.empty((B, T, U + 1), dtype=torch.float32, device=dev)
    if B == 0:
        return total, alpha
    px, py = ready(px, dev, torch.float32), ready(py, dev, torch.float32)
    t_lens = ready(t_lens, dev, torch.int32)
    u_lens = ready(u_lens, dev, torch.int32)
    fn = KERNEL.entry(FORWARD)
    with on_device(dev):
        rc = fn(ptr(px), ptr(py), ptr(t_lens), ptr(u_lens), ptr(alpha),
                ptr(total), B, T, U, stream_handle(dev))
    KERNEL.check(rc)
    return total, alpha


def lattice_backward_cuda(px: torch.Tensor, py: torch.Tensor,
                          t_lens: torch.Tensor, u_lens: torch.Tensor,
                          alpha: torch.Tensor, total: torch.Tensor,
                          g: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3's backward on CUDA tensors: `lattice_backward_plain`'s
    (grad_px, grad_py) from `lattice_forward_cuda`'s alpha and total."""
    _check_arcs(px, py, t_lens, u_lens)
    B, T, U = px.shape
    if tuple(alpha.shape) != (B, T, U + 1) or tuple(total.shape) != (B,) \
            or tuple(g.shape) != (B,):
        raise ValueError(f"lattice alpha {tuple(alpha.shape)}, total "
                         f"{tuple(total.shape)} and g {tuple(g.shape)} do "
                         f"not fit arcs of ({B}, {T}, {U})")
    if alpha.dtype != torch.float32 or total.dtype != torch.float32:
        raise ValueError(f"the lattice kernel takes f32 alpha and total, "
                         f"got {alpha.dtype} and {total.dtype}")
    dev = px.device
    if alpha.device != dev or total.device != dev:
        raise ValueError(f"lattice alpha and total on {alpha.device} and "
                         f"{total.device}, arcs on {dev}")
    grad_px = torch.empty((B, T, U), dtype=torch.float32, device=dev)
    grad_py = torch.empty((B, T, U + 1), dtype=torch.float32, device=dev)
    if B == 0:
        return grad_px, grad_py
    px, py = ready(px, dev, torch.float32), ready(py, dev, torch.float32)
    alpha = ready(alpha, dev, torch.float32)
    total = ready(total, dev, torch.float32)
    g = ready(g, dev, torch.float32)
    t_lens = ready(t_lens, dev, torch.int32)
    u_lens = ready(u_lens, dev, torch.int32)
    fn = KERNEL.entry(BACKWARD)
    with on_device(dev):
        rc = fn(ptr(px), ptr(py), ptr(t_lens), ptr(u_lens), ptr(alpha),
                ptr(total), ptr(g), ptr(grad_px), ptr(grad_py), B, T, U,
                stream_handle(dev))
    KERNEL.check(rc)
    return grad_px, grad_py


def _alpha(px, py, t_lens, u_lens):
    if use_kernel(px.device):
        return lattice_forward_cuda(px, py, t_lens, u_lens)
    return lattice_forward_plain(px, py, t_lens, u_lens)


def _arc_grads(px, py, t_lens, u_lens, alpha, total, g):
    if use_kernel(px.device):
        return lattice_backward_cuda(px, py, t_lens, u_lens, alpha, total, g)
    return lattice_backward_plain(px, py, t_lens, u_lens, alpha, total, g)


class _Lattice(torch.autograd.Function):
    """The lattice's total (B,), its backward the arcs' gradient."""

    @staticmethod
    def forward(ctx, px, py, t_lens, u_lens):
        total, alpha = _alpha(px, py, t_lens, u_lens)
        ctx.save_for_backward(px, py, t_lens, u_lens, alpha, total)
        return total

    @staticmethod
    def backward(ctx, g):
        grad_px, grad_py = _arc_grads(*ctx.saved_tensors, g)
        return grad_px, grad_py, None, None


def lattice_forward(px: torch.Tensor, py: torch.Tensor,
                    t_lens: torch.Tensor,
                    u_lens: torch.Tensor) -> torch.Tensor:
    """The total path log-prob (B,) of the (T, U+1) lattice of px (B, T,
    U) emit and py (B, T, U+1) blank arcs, as `lattice_forward_plain`
    gives it, differentiable in both: kernel B3 on CUDA tensors, the plain
    versions on the CPU."""
    return _Lattice.apply(px, py, t_lens, u_lens)


@torch.no_grad()
def lattice_occupancies(px: torch.Tensor, py: torch.Tensor,
                        t_lens: torch.Tensor, u_lens: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, occ_px, occ_py): the lattice's total and the gradient of
    its sum with respect to px and py (the arcs' posterior occupancies),
    from one forward and one backward with g = 1."""
    total, alpha = _alpha(px, py, t_lens, u_lens)
    occ_px, occ_py = _arc_grads(px, py, t_lens, u_lens, alpha, total,
                                torch.ones_like(total))
    return total, occ_px, occ_py


def rnnt_nll(logits: torch.Tensor, targets: torch.Tensor,
             logit_lengths: torch.Tensor, target_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-utterance NLL (B,) of raw logits (B, T, U+1, V), f32."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    tgt = targets.to(device=logits.device, dtype=torch.int64)[:, :U]
    px = torch.gather(log_probs[:, :, :U], 3,
                      tgt[:, None, :, None].expand(B, T, U, 1))[..., 0]
    py = log_probs[..., blank]
    return -lattice_forward(px, py, logit_lengths, target_lengths)


class _ClampedNll(torch.autograd.Function):
    """NLL whose per-utterance logits-gradient is clipped to ±clamp, then
    scaled by the incoming gradient of each utterance."""

    @staticmethod
    def forward(ctx, logits, targets, logit_lengths, target_lengths, blank,
                clamp):
        with torch.enable_grad():
            leaf = logits.detach().requires_grad_(True)
            nll = rnnt_nll(leaf, targets, logit_lengths, target_lengths,
                           blank)
            (raw,) = torch.autograd.grad(nll.sum(), leaf)
        ctx.save_for_backward(torch.clamp(raw, -clamp, clamp))
        return nll.detach()

    @staticmethod
    def backward(ctx, g):
        (raw,) = ctx.saved_tensors
        grad = raw * g.reshape(g.shape + (1,) * (raw.ndim - 1))
        return grad.to(raw.dtype), None, None, None, None, None


def rnnt_loss(logits: torch.Tensor, targets: torch.Tensor,
              logit_lengths: torch.Tensor, target_lengths: torch.Tensor,
              blank: int = 0, reduction: str = "mean",
              clamp: float = -1.0) -> torch.Tensor:
    """The transducer loss on raw logits (B, T, U+1, V): reduction
    "mean", "sum" or "none" of the per-utterance NLL. `clamp` ≥ 0 clips
    each utterance's logits-gradient to ±clamp (< 0 or None: off); in a
    forward without a gradient it changes nothing, and is skipped."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction}")
    if clamp is not None and clamp >= 0 and torch.is_grad_enabled() \
            and logits.requires_grad:
        nll = _ClampedNll.apply(logits, targets, logit_lengths,
                                target_lengths, blank, float(clamp))
    else:
        nll = rnnt_nll(logits, targets, logit_lengths, target_lengths, blank)
    if reduction == "none":
        return nll
    return nll.sum() if reduction == "sum" else nll.mean()
