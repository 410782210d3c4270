"""CTC loss (port of speech2text_tpu/ops/ctc.py): the alpha recursion as a
torch loop over frames on a (B, S = 2U+1) state of extended labels
[blank, y1, blank, y2, ..., blank]; its gradient is autograd's through
the loop. The CPU and the card run the same torch code.

Semantics as in the JAX package: blank id 0 by default, log_softmax
inside `ctc_loss`, the f32 lattice; positions past 2·len + 1 are masked,
a frame at or after the input length leaves alpha unchanged, and an
unreachable lattice (a label longer than the input allows) gives a loss of
0 with a gradient of exactly 0 (zero_infinity). `reduction="mean"`
divides each NLL by max(label_len, 1), then takes the batch mean, as
torch.nn.CTCLoss does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B, S) shifted right by n along S, NEG_INF filled."""
    return F.pad(x, (n, 0), value=NEG_INF)[:, :x.shape[1]]


def ctc_forward(log_probs: torch.Tensor, labels: torch.Tensor,
                input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                blank: int = 0) -> torch.Tensor:
    """log_probs (B, T, V) log-softmaxed, labels (B, U ≥ 1) 0-padded →
    the per-utterance negative log-likelihood (B,)."""
    B, T, V = log_probs.shape
    U = labels.shape[1]
    S = 2 * U + 1
    dev = log_probs.device
    input_lengths = input_lengths.to(dev, torch.int64)
    label_lengths = label_lengths.to(dev, torch.int64)

    s_idx = torch.arange(S, device=dev)
    is_label = (s_idx % 2) == 1
    z = torch.where(is_label[None, :],
                    labels.to(dev, torch.int64)[:, (s_idx // 2).clamp(
                        max=U - 1)], blank)                       # (B, S)
    # a skip over the blank between two labels, where they differ
    z_m2 = F.pad(z, (2, 0), value=-1)[:, :S]
    can_skip = is_label[None, :] & (z != z_m2)
    valid_s = s_idx[None, :] < (2 * label_lengths[:, None] + 1)

    # the emission of each extended label at every frame (a gather gives
    # the values of JAX's one-hot contraction)
    emit_all = log_probs.gather(2, z[:, None, :].expand(B, T, S))

    # frame 0: the blank at s = 0, the first label at s = 1 if len > 0
    alpha = torch.cat([
        log_probs[:, 0, blank:blank + 1],
        torch.where(label_lengths > 0, emit_all[:, 0, 1], NEG_INF)[:, None],
        log_probs.new_full((B, S - 2), NEG_INF)], dim=1)
    alpha = torch.where(valid_s, alpha, NEG_INF)

    active = torch.arange(T, device=dev)[None, :] < input_lengths[:, None]
    for t in range(1, T):
        new = torch.logaddexp(alpha, _shift(alpha, 1))
        new = torch.where(can_skip, torch.logaddexp(new, _shift(alpha, 2)), new)
        new = torch.where(valid_s, new + emit_all[:, t], NEG_INF)
        alpha = torch.where(active[:, t, None], new, alpha)

    a1 = alpha.gather(1, (2 * label_lengths)[:, None])[:, 0]
    a2 = torch.where(label_lengths > 0, alpha.gather(
        1, (2 * label_lengths - 1).clamp(min=0)[:, None])[:, 0], NEG_INF)
    nll = -torch.logaddexp(a1, a2)
    return torch.where(nll >= -NEG_INF / 2, 0.0, nll)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0, reduction: str = "mean") -> torch.Tensor:
    """CTC loss on raw logits (B, T, V): log_softmax in f32, then
    `ctc_forward`; reduction "none", "sum" or "mean"."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = ctc_forward(log_probs, labels, input_lengths, label_lengths,
                      blank=blank)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        denom = label_lengths.to(nll.device, torch.float32).clamp(min=1.0)
        return (nll / denom).mean()
    raise ValueError(f"unknown reduction {reduction}")
