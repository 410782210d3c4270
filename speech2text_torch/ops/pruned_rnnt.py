"""Pruned RNN-T: smoothed simple loss → prune ranges → pruned loss (port of
speech2text_tpu/ops/pruned_rnnt.py): `rnnt_loss_smoothed`,
`get_rnnt_prune_ranges`, `do_rnnt_pruning`, `rnnt_loss_pruned`.

All in f32. The simple loss's joint normaliser log Σ_v exp(am + lm) is a
batched matmul of exponentials, not a (B,T,U,V) joint. The occupancies
(px_grad, py_grad) are the gradient of the lattice's total with respect to
its arcs: the forward takes them from one forward and one backward of the
lattice (`ops/rnnt.lattice_occupancies`: kernel B3 on the card), and the
simple loss's backward reuses them (`_SimpleLossWithGrads`). The pruned
loss runs the same anti-diagonal lattice (`ops/rnnt.lattice_forward`) on
the window arcs placed in (t, u), not the JAX package's walk over frames:
the same values in a third of the steps (`rnnt_loss_pruned`). The label
picks are gathers: their values and gradients are those of the JAX
package's one-hot contractions.

The three steps are the spans "simple_loss", "prune_ranges" and
"pruned_loss" (utils/tracing.py); with the recorder on, the pruned
lattice's backward is "pruned_loss_backward", on the thread autograd runs
it on.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.tracing import backward_span, span
from .rnnt import NEG_INF, lattice_forward, lattice_occupancies


class _SimpleLossWithGrads(torch.autograd.Function):
    """(px, py) → (nll (B,), occ_px, occ_py); the occupancies are detached
    outputs, and the backward of nll is −occ · g per utterance."""

    @staticmethod
    def forward(ctx, px, py, t_lens, u_lens):
        total, occ_px, occ_py = lattice_occupancies(px, py, t_lens, u_lens)
        ctx.save_for_backward(occ_px, occ_py)
        ctx.mark_non_differentiable(occ_px, occ_py)
        return -total, occ_px, occ_py

    @staticmethod
    def backward(ctx, g_nll, g_occ_px, g_occ_py):
        occ_px, occ_py = ctx.saved_tensors
        g = g_nll[:, None, None]
        return -occ_px * g, -occ_py * g, None, None


def _reduce(nll: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    if reduction == "none":
        return nll
    raise ValueError(f"unknown reduction {reduction}")


def rnnt_loss_smoothed(lm: torch.Tensor, am: torch.Tensor,
                       symbols: torch.Tensor, t_lens: torch.Tensor,
                       u_lens: torch.Tensor, termination_symbol: int = 0,
                       lm_only_scale: float = 0.0,
                       am_only_scale: float = 0.0, reduction: str = "mean"
                       ) -> Tuple[torch.Tensor,
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """k2.rnnt_loss_smoothed semantics: the trivial-joiner (am + lm)
    transducer loss, geometrically smoothed with the lm-only and am-only
    distributions.

    lm (B, U+1, C), am (B, T, C) unnormalised logits; symbols (B, U).
    Returns (loss, (px_grad (B,T,U), py_grad (B,T,U+1))), the grads being
    the detached posterior occupancies of the emit and blank arcs."""
    with span("simple_loss"):
        am = am.float()
        lm = lm.float()
        B, T, C = am.shape
        U = lm.shape[1] - 1
        sym = symbols.to(device=am.device, dtype=torch.int64)

        am_max = am.amax(-1, keepdim=True)
        lm_max = lm.amax(-1, keepdim=True)
        joint = torch.bmm(torch.exp(am - am_max),          # (B,T,U+1)
                          torch.exp(lm - lm_max).transpose(1, 2))
        norm = (torch.log(torch.clamp(joint, min=1e-37)) + am_max
                + lm_max.transpose(1, 2))

        am_y = torch.gather(am, 2, sym[:, None, :].expand(B, T, U))  # (B,T,U)
        lm_y = torch.gather(lm[:, :U], 2, sym[..., None])[..., 0]    # (B,U)
        px_joint = am_y + lm_y[:, None, :] - norm[:, :, :U]
        py_joint = (am[:, :, termination_symbol, None]     # (B,T,U+1)
                    + lm[:, None, :, termination_symbol] - norm)

        w = 1.0 - lm_only_scale - am_only_scale
        px, py = w * px_joint, w * py_joint
        if lm_only_scale > 0.0:
            lm_ls = torch.log_softmax(lm, dim=-1)
            px_lm = torch.gather(lm_ls[:, :U], 2, sym[..., None])[..., 0]
            px = px + lm_only_scale * px_lm[:, None, :]
            py = py + lm_only_scale * lm_ls[:, None, :, termination_symbol]
        if am_only_scale > 0.0:
            am_ls = torch.log_softmax(am, dim=-1)
            px_am = torch.gather(am_ls, 2, sym[:, None, :].expand(B, T, U))
            px = px + am_only_scale * px_am
            py = py + am_only_scale * am_ls[:, :, None, termination_symbol]

        nll, occ_px, occ_py = _SimpleLossWithGrads.apply(px, py, t_lens,
                                                         u_lens)
        return _reduce(nll, reduction), (occ_px, occ_py)


@torch.no_grad()
def get_rnnt_prune_ranges(px_grad: torch.Tensor, py_grad: torch.Tensor,
                          t_lens: torch.Tensor, u_lens: torch.Tensor,
                          s_range: int) -> torch.Tensor:
    """Per-frame window starts (B, T) int32 that hold the most occupancy,
    adjusted to a valid pruning bound (k2.get_rnnt_prune_ranges
    semantics): 0 at the first frame, non-decreasing, advancing less than
    s_range per frame, and the last real frame's window holding u = u_len
    (the termination state)."""
    with span("prune_ranges"):
        B, T, U1 = py_grad.shape
        dev = py_grad.device
        t_lens = t_lens.to(device=dev, dtype=torch.int64)
        u_lens = u_lens.to(device=dev, dtype=torch.int64)
        occ = py_grad + F.pad(px_grad, (0, 1))
        csum = F.pad(torch.cumsum(occ, dim=2), (1, 0))
        n_pos = max(U1 - s_range + 1, 1)
        s_pos = torch.arange(n_pos, device=dev)
        win = (csum[:, :, torch.clamp(s_pos + s_range, max=U1)]
               - csum[:, :, s_pos])                             # (B,T,n_pos)
        s_begin = torch.argmax(win, dim=2)                      # (B,T)

        s_ub = torch.clamp(u_lens + 1 - s_range, min=0)         # (B,)
        s_begin = torch.minimum(s_begin, s_ub[:, None])
        # windows at and after each utterance's last frame reach u_len
        t_idx = torch.arange(T, device=dev)
        s_begin = torch.where(t_idx[None, :] >= t_lens[:, None] - 1,
                              s_ub[:, None], s_begin)

        cols = list(s_begin.unbind(1))
        # backward pass: s[t-1] ∈ [s[t] - (s_range-1), s[t]]
        for t in range(T - 2, -1, -1):
            nxt = cols[t + 1]
            cols[t] = torch.minimum(
                torch.maximum(cols[t], nxt - (s_range - 1)), nxt)
        # forward pass: from 0, monotone with an advance of at most s_range-1
        cols[0] = torch.zeros_like(cols[0])
        for t in range(1, T):
            prev = cols[t - 1]
            cols[t] = torch.minimum(torch.maximum(cols[t], prev),
                                    prev + (s_range - 1))
        return torch.stack(cols, dim=1).to(torch.int32)


def do_rnnt_pruning(am: torch.Tensor, lm: torch.Tensor,
                    ranges: torch.Tensor, s_range: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pruned (B, T, s_range, E) am and lm rows (k2.do_rnnt_pruning);
    the window of frame t is lm rows ranges[t] .. ranges[t]+s_range-1,
    clamped to U. The lm rows are gathered in f32, so the backward sums
    each row's gradient in f32 before it returns to lm's dtype."""
    B, T, E = am.shape
    U1 = lm.shape[1]
    am_pruned = am[:, :, None, :].expand(B, T, s_range, E)
    idx = torch.clamp(ranges.to(torch.int64)[:, :, None]
                      + torch.arange(s_range, device=am.device), max=U1 - 1)
    flat = (idx + U1 * torch.arange(B, device=am.device)[:, None, None])
    lm_pruned = torch.index_select(lm.float().reshape(B * U1, E), 0,
                                   flat.reshape(-1))
    return am_pruned, lm_pruned.reshape(B, T, s_range, E).to(lm.dtype)


def rnnt_loss_pruned(logits: torch.Tensor, symbols: torch.Tensor,
                     ranges: torch.Tensor, t_lens: torch.Tensor,
                     u_lens: torch.Tensor, termination_symbol: int = 0,
                     reduction: str = "mean") -> torch.Tensor:
    """Forward DP over the pruned lattice (k2.rnnt_loss_pruned semantics).

    logits (B, T, R, V): the joiner's output on the pruned pairs; frame t's
    window covers u = ranges[t] .. ranges[t]+R-1, the ranges being valid
    as `get_rnnt_prune_ranges` makes them (0 at the first frame,
    non-decreasing by less than R, the last frame's window holding u_len).
    An utterance with no path through its pruned lattice gets 0.

    The JAX package walks the frames, each window's emits in sequence. In
    absolute (t, u) the pruned lattice is the full one with the arcs
    outside the windows taken out: an emit (t,u)→(t,u+1) exists where u
    and u+1 lie in frame t's window, a blank (t,u)→(t+1,u) where u lies in
    both frames' windows. So the window log-probs are placed on the
    (B, T, U+1) lattice, NEG_INF off the windows, and `lattice_forward`
    runs it over T+U anti-diagonals: every window cell gets the same two
    terms, in the same order, as in the frame walk, and so the same value
    and gradient."""
    with span("pruned_loss"):
        B, T, R, V = logits.shape
        U = symbols.shape[1]
        dev = logits.device
        u_lens = u_lens.to(device=dev, dtype=torch.int64)
        ranges = ranges.to(device=dev, dtype=torch.int64)
        lp = torch.log_softmax(logits.float(), dim=-1)

        u_abs = ranges[:, :, None] + torch.arange(R, device=dev)    # (B,T,R)
        sym = F.pad(symbols.to(device=dev, dtype=torch.int64), (0, 1))
        y_at = torch.gather(sym, 1, torch.clamp(u_abs, max=U).reshape(B, -1))
        px = torch.gather(lp, 3, y_at.reshape(B, T, R, 1))[..., 0]  # (B,T,R)
        py = lp[..., termination_symbol]                            # (B,T,R)

        # window position of each (t, u): k = u - ranges[t]
        u_idx = torch.arange(U + 1, device=dev)
        k = u_idx[None, None, :] - ranges[:, :, None]               # (B,T,U+1)
        kc = k.clamp(0, R - 1)
        # emits from positions 0..R-2 of the window
        px_full = torch.where((k[..., :U] >= 0) & (k[..., :U] < R - 1),
                              torch.gather(px, 2, kc[..., :U]), NEG_INF)
        # blanks from a window position that frame t+1's window holds too
        nxt = F.pad(ranges[:, 1:], (0, 1), value=0)                 # (B,T)
        py_full = torch.where((k >= 0) & (k < R)
                              & (u_idx[None, None, :] >= nxt[:, :, None]),
                              torch.gather(py, 2, kc), NEG_INF)
        nll = -lattice_forward(px_full, py_full, t_lens, u_lens)
        nll = torch.where(nll >= -NEG_INF / 2, 0.0, nll)        # infeasible
        backward_span("pruned_loss_backward", nll, (px_full, py_full))
        return _reduce(nll, reduction)
