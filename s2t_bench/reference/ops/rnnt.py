"""The transducer lattice forward (port of speech2text_tpu/ops/rnnt.py:
`lattice_forward` :26-117), which the pruned loss runs on its pruned
lattice.

The alpha recursion
    alpha[t,u] = logaddexp(alpha[t-1,u] + blank[t-1,u],
                           alpha[t,u-1] + emit[t,u-1])
runs over anti-diagonals d = t+u: every cell of a diagonal depends only on
the previous diagonal, so a Python loop over the T+U diagonals, each one
vectorised over (B, U+1), computes the lattice, and autograd gives the
beta pass. Each diagonal's alphas are kept, and the total is read at each
utterance's final cell after the loop, which gives the value and the
gradients of JAX's in-loop capture.

Conventions: blank id 0; the u=0 row is the "no label yet" state;
out-of-lattice cells hold NEG_INF (finite, so sums of two stay finite in
f32) and `_logaddexp` clamps anything at or below NEG_INF back to NEG_INF.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


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


def _skew_diag(a_u: torch.Tensor) -> torch.Tensor:
    """(B, U1, T) row-major → (B, U1, D) diagonal-major, D = T+U1-1:
    out[b, u, d] = a_u[b, u, d-u] where 0 ≤ d-u < T, NEG_INF elsewhere
    (pad each row to T+U1, drop the last U1 of the flat view: row u lands
    shifted right by u)."""
    B, U1, T = a_u.shape
    W = T + U1
    flat = F.pad(a_u, (0, U1), value=NEG_INF).reshape(B, U1 * W)
    return flat[:, :U1 * (W - 1)].reshape(B, U1, W - 1)


def lattice_forward(px: torch.Tensor, py: torch.Tensor,
                    t_lens: torch.Tensor,
                    u_lens: torch.Tensor) -> torch.Tensor:
    """Forward DP over the (T, U+1) transducer lattice.

    px: (B, T, U)   emit arc (t,u)→(t,u+1) log-prob (label y_{u+1})
    py: (B, T, U+1) blank arc (t,u)→(t+1,u) log-prob
    Returns the total path log-prob (B,), the path ending with a blank at
    (t_lens-1, u_lens); emit arcs at u ≥ u_lens are masked out. An
    utterance with t_lens = 0 gets NEG_INF."""
    B, T, U = px.shape
    U1 = U + 1
    dev = px.device
    t_lens = t_lens.to(device=dev, dtype=torch.int64)
    u_lens = u_lens.to(device=dev, dtype=torch.int64)
    u_idx = torch.arange(U1, device=dev)
    px = torch.where(u_idx[None, None, :U] < u_lens[:, None, None], px,
                     NEG_INF)
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
    d_end = t_lens - 1 + u_lens
    valid = (d_end >= 0) & (d_end < len(alphas))
    d_c = d_end.clamp(0, len(alphas) - 1)
    b_idx = torch.arange(B, device=dev)
    u_c = u_lens.clamp(0, U)
    total = (torch.stack(alphas)[d_c, b_idx, u_c] + py_d[d_c, b_idx, u_c])
    return torch.where(valid, total, NEG_INF)
