"""Batched decoding (port of speech2text_tpu/decoding.py): CTC greedy and
prefix beam search over log-probabilities, transducer greedy and beam
search over encoder frames, the CIF task's per-position argmax, and the
decoder factory of a `metric` config section (`build_decoding`).

- CTC greedy (`ctc_greedy_reduce`): argmax per frame → repeats collapsed
  → blanks dropped, compacted to the front of each row.
- CTC prefix beam (`ctc_prefix_beam_reduce`): K prefixes per utterance,
  batched over utterances and beams, equal prefixes merged through dual
  32-bit rolling hashes (see the function).

Each decoder is one loop over frames, vectorized over the batch (and the
beam), with no host synchronisation inside: no value is read back and no
Python branch depends on a tensor's value. The CTC decoders return
`(tokens (B, T) int32, counts (B,) int32)`, the transducer decoders
`(tokens (B, max_tokens) int32, counts (B,) int32)`; their predictor is
primed with token 0 (blank), and nothing is emitted past an utterance's
`enc_len` or beyond `max_tokens`.

- Greedy: at each frame the joiner scores the encoder frame against the
  predictor output; the argmax is emitted unless it is blank; at most
  `max_token_step` emissions per frame.
- Beam: W hypotheses per utterance as a (B, W) dimension, at most one
  emission per frame, duplicate prefixes merged, optional RNN-LM shallow
  fusion (see `RnntBeamDecoding`).

`ids_to_texts` and `reference_decoder` turn token ids and label tensors
into text through a tokenizer.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .data.tokenizer import Tokenizer
from .runtime_binding import CtcLexiconBeamDecoding

NEG_INF = -1e30
# greedy decoding's state between frames: (predictor state, predictor
# output (B, 1, D), tokens (B, max_tokens), counts (B,))
Carry = Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]


def ids_to_texts(tokens: np.ndarray, counts: np.ndarray,
                 tokenizer: Tokenizer) -> List[str]:
    """Decoded token rows (B, cap) with their counts (B,) → texts."""
    return [tokenizer.decode(row[:int(n)]) for row, n in zip(tokens, counts)]


def reference_decoder(labels: np.ndarray, label_lengths: np.ndarray,
                      tokenizer: Tokenizer) -> List[str]:
    """Ground-truth label tensor → texts."""
    return [tokenizer.decode(row[:int(n)])
            for row, n in zip(np.asarray(labels), np.asarray(label_lengths))]


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, in descending order, equal
    values in index order (lax.top_k's order; torch.topk promises none)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def merge_equal_prefixes(scores: torch.Tensor, tokens: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """Candidates' scores (B, M) with their prefixes (tokens (B, M, cap),
    zero-filled past counts (B, M)) → the scores with equal prefixes
    merged: each group's logaddexp in its lowest-index member, NEG_INF in
    the others."""
    M = scores.shape[1]
    idx = torch.arange(M, device=scores.device)
    eq = ((counts[:, :, None] == counts[:, None, :])
          & (tokens[:, :, None, :] == tokens[:, None, :, :]).all(dim=-1))
    gmax = torch.where(eq, scores[:, None, :], NEG_INF).amax(dim=-1)
    gsum = torch.where(eq, torch.exp(scores[:, None, :] - gmax[..., None]),
                       0.0).sum(dim=-1)
    dup = (eq & (idx[:, None] > idx[None, :])).any(dim=-1)
    return torch.where(dup, NEG_INF, gmax + torch.log(gsum))


# ------------------------------------------------------------------- CTC
def ctc_greedy_reduce(log_probs: torch.Tensor, lengths: torch.Tensor,
                      blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, V) → (tokens (B, T), counts (B,)): the argmax of each frame
    (the first of equal maxima), repeats collapsed, blanks and frames at or
    past `lengths` dropped, the kept tokens compacted to the front."""
    B, T, _ = log_probs.shape
    best = log_probs.argmax(dim=-1)
    prev = torch.nn.functional.pad(best, (1, 0), value=blank)[:, :T]
    t_idx = torch.arange(T, device=best.device)
    keep = (best != blank) & (best != prev) & \
        (t_idx[None, :] < lengths.to(best.device)[:, None])
    pos = torch.where(keep, keep.long().cumsum(dim=1) - 1, T)
    out = torch.zeros((B, T + 1), dtype=torch.int64, device=best.device)
    out.scatter_(1, pos, torch.where(keep, best, 0))
    return out[:, :T].to(torch.int32), keep.sum(dim=1).to(torch.int32)


class CtcGreedyDecoding:

    def __init__(self, blank: int = 0):
        self._blank = blank

    @torch.no_grad()
    def decode(self, log_probs: torch.Tensor, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return ctc_greedy_reduce(log_probs, lengths, blank=self._blank)


_HASH_M1, _HASH_M2 = 1000003, 10000019
_U32 = 0xFFFFFFFF


def _segment_logsumexp(x: torch.Tensor, seg: torch.Tensor,
                       first: torch.Tensor) -> torch.Tensor:
    """Per row of x (B, N): the logsumexp of each segment `seg` (sorted
    segment ids) at the segment's first position, NEG_INF elsewhere (JAX's
    segment_max / segment_sum formulation)."""
    m = torch.full_like(x, -torch.inf).scatter_reduce(
        1, seg, x, "amax", include_self=True).clamp(min=NEG_INF)
    tot = torch.zeros_like(x).scatter_add(1, seg,
                                          torch.exp(x - m.gather(1, seg)))
    out = torch.where(tot > 0, torch.log(tot.clamp(min=1e-38)) + m, NEG_INF)
    return torch.where(first, out.gather(1, seg), NEG_INF)


def ctc_prefix_beam_reduce(log_probs: torch.Tensor, lengths: torch.Tensor,
                           beam_size: int = 8, cand_size: int = 8,
                           blank: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search: (B, T, V) → (tokens (B, T),
    counts (B,)) of the best prefix per utterance.

    Per frame, each of the K live prefixes makes one "stay" candidate
    (the blank mass p_tot·p_blank and the repeat-of-last mass
    p_nb·p_last) and C = min(cand_size, V) "extend" candidates from the
    frame's top-C tokens (a repeat of the last token extends only from
    the blank-ended mass). Equal prefixes among the K·(C+1) candidates are
    merged: dual 32-bit rolling hashes (h·1000003 + tok + 1 and
    h·10000019 + tok + 1, wrapping; kept in int64 and masked to 32 bits)
    sorted lexicographically with the candidate index as the last key,
    a segmented logsumexp folds each group's (p_b, p_nb) into its first
    member, and the best K survive (equal scores to the lower index). A
    frame at or past `lengths` leaves the beams as they are. The same
    candidates, merge and tie order as the JAX package's."""
    B, T, V = log_probs.shape
    K, C = beam_size, min(cand_size, V)
    N = K + K * C
    dev = log_probs.device
    lp_all = log_probs.float()
    lengths = lengths.to(dev)
    kar = torch.arange(K, device=dev)
    toks = torch.zeros((B, K, T), dtype=torch.int64, device=dev)
    lens = torch.zeros((B, K), dtype=torch.int64, device=dev)
    pb = torch.full((B, K), NEG_INF, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((B, K), NEG_INF, device=dev)
    h1 = torch.ones((B, K), dtype=torch.int64, device=dev)
    h2 = torch.ones((B, K), dtype=torch.int64, device=dev)
    c_parent = torch.cat([kar, kar.repeat_interleave(C)])[None].expand(B, N)
    neg_kc = torch.full((B, K * C), NEG_INF, device=dev)
    for t in range(T):
        lp_t = lp_all[:, t]                                       # (B, V)
        ptot = torch.logaddexp(pb, pnb)
        last = torch.where(lens > 0, toks.gather(
            2, (lens - 1).clamp(min=0)[..., None])[..., 0], -1)
        lp_last = torch.where(last >= 0, lp_t.gather(1, last.clamp(min=0)),
                              NEG_INF)
        stay_pb = ptot + lp_t[:, blank:blank + 1]
        stay_pnb = pnb + lp_last
        topv, topi = top_k(lp_t, C)                               # (B, C)
        is_rep = topi[:, None, :] == last[..., None]              # (B, K, C)
        ext_pnb = torch.where(is_rep, pb[..., None] + topv[:, None, :],
                              ptot[..., None] + topv[:, None, :])
        ext_pnb = torch.where((topi == blank)[:, None, :], NEG_INF, ext_pnb)
        tok1 = topi[:, None, :] + 1
        h1e = (h1[..., None] * _HASH_M1 + tok1) & _U32
        h2e = (h2[..., None] * _HASH_M2 + tok1) & _U32

        c_pb = torch.cat([stay_pb, neg_kc], dim=1)                # (B, N)
        c_pnb = torch.cat([stay_pnb, ext_pnb.reshape(B, -1)], dim=1)
        c_h1 = torch.cat([h1, h1e.reshape(B, -1)], dim=1)
        c_h2 = torch.cat([h2, h2e.reshape(B, -1)], dim=1)
        c_tok = torch.cat([torch.full((B, K), -1, dtype=torch.int64,
                                      device=dev),
                           topi[:, None, :].expand(B, K, C).reshape(B, -1)],
                          dim=1)

        # equal prefixes grouped: (h1, h2) as one signed 64-bit key, the
        # stable sort breaking ties by candidate index
        key = (c_h1 - 2 ** 31) * 2 ** 32 + c_h2
        order = torch.sort(key, dim=1, stable=True).indices
        s_key = key.gather(1, order)
        first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                           s_key[:, 1:] != s_key[:, :-1]], dim=1)
        seg = first.long().cumsum(dim=1) - 1
        m_pb = _segment_logsumexp(c_pb.gather(1, order), seg, first)
        m_pnb = _segment_logsumexp(c_pnb.gather(1, order), seg, first)

        _, sel = top_k(torch.logaddexp(m_pb, m_pnb), K)           # (B, K)
        pick = order.gather(1, sel)
        parent = c_parent.gather(1, pick)
        tok = c_tok.gather(1, pick)
        p_lens = lens.gather(1, parent)
        new_lens = torch.where(tok >= 0, p_lens + 1, p_lens)
        new_toks = toks.gather(1, parent[..., None].expand(B, K, T))
        pos = (new_lens - 1).clamp(0, T - 1)[..., None]
        cur = new_toks.gather(2, pos)
        new_toks = new_toks.scatter(2, pos, torch.where(tok[..., None] >= 0,
                                                        tok[..., None], cur))
        active = (t < lengths)[:, None]
        toks = torch.where(active[..., None], new_toks, toks)
        lens = torch.where(active, new_lens, lens)
        pb = torch.where(active, m_pb.gather(1, sel), pb)
        pnb = torch.where(active, m_pnb.gather(1, sel), pnb)
        h1 = torch.where(active, c_h1.gather(1, pick), h1)
        h2 = torch.where(active, c_h2.gather(1, pick), h2)

    _, best = top_k(torch.logaddexp(pb, pnb), 1)                  # first max
    best_toks = toks.gather(1, best[..., None].expand(B, 1, T))[:, 0]
    return best_toks.to(torch.int32), \
        lens.gather(1, best)[:, 0].to(torch.int32)


class CtcPrefixBeamDecoding:

    def __init__(self, beam_size: int = 8, cand_size: int = 8,
                 blank: int = 0):
        self._beam = beam_size
        self._cand = cand_size
        self._blank = blank

    @torch.no_grad()
    def decode(self, log_probs: torch.Tensor, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return ctc_prefix_beam_reduce(log_probs, lengths,
                                      beam_size=self._beam,
                                      cand_size=self._cand,
                                      blank=self._blank)


# ------------------------------------------------------------------ RNN-T
def _map_state(fn: Callable, *states: Any) -> Any:
    """`fn` over the tensors of a state (a tensor, or lists and tuples of
    them, as the predictor and the LM keep it)."""
    if isinstance(states[0], torch.Tensor):
        return fn(*states)
    return type(states[0])(_map_state(fn, *parts) for parts in zip(*states))


class RnntGreedyDecoding:

    def __init__(self, predictor_step: Callable, predictor_init_state:
                 Callable, joiner_step: Callable, max_token_step: int = 1,
                 max_tokens: int = 256):
        # predictor_step(token (B,), state) → (pred_out (B,1,D), state)
        # predictor_init_state(batch_size, device) → state
        # joiner_step(enc (B,D), pred (B,D)) → log-probs (B,V)
        self._pred_step = predictor_step
        self._pred_init = predictor_init_state
        self._join = joiner_step
        self._max_token_step = max(1, int(max_token_step))
        self._cap = max_tokens

    def init_carry(self, batch_size: int, device: torch.device) -> Carry:
        """The carry before the first frame: the predictor primed with
        blank (token 0), no tokens."""
        state = self._pred_init(batch_size, device)
        pred_out, state = self._pred_step(
            torch.zeros((batch_size,), dtype=torch.int64, device=device),
            state)
        tokens = torch.zeros((batch_size, self._cap), dtype=torch.int64,
                             device=device)
        counts = torch.zeros((batch_size,), dtype=torch.int64,
                             device=device)
        return state, pred_out, tokens, counts

    def continue_frames(self, enc_out: torch.Tensor, carry: Carry,
                        enc_lens: Optional[torch.Tensor] = None) -> Carry:
        """The frame loop over enc_out (B, T, D) from `carry` (predictor
        state, predictor output, tokens (B, max_tokens), counts (B,)) →
        the carry after the last frame. Frames at or past `enc_lens`
        emit nothing; without `enc_lens` every frame is active (streaming,
        resumed chunk by chunk). Its callers run it without autograd
        (`decode` under no_grad, the streaming session under inference
        mode), so that an exported chunk program holds no grad-mode
        switch."""
        state, pred_out, tokens, counts = carry
        B, T, _ = enc_out.shape
        cap = self._cap
        slot = torch.arange(cap, device=enc_out.device)
        for t in range(T):
            enc_t = enc_out[:, t]
            active0 = None if enc_lens is None else enc_lens > t
            for _ in range(self._max_token_step):
                logp = self._join(enc_t, pred_out[:, 0])
                tok = torch.argmax(logp, dim=-1)
                emit = (tok != 0) & (counts < cap)
                if active0 is not None:
                    emit = active0 & emit
                write = emit[:, None] & (slot[None, :] == counts[:, None])
                tokens = torch.where(write, tok[:, None], tokens)
                counts = counts + emit.to(counts.dtype)
                new_pred, new_state = self._pred_step(tok, state)
                pred_out = torch.where(emit[:, None, None], new_pred,
                                       pred_out)
                state = _map_state(
                    lambda n, o: torch.where(
                        emit.reshape((B,) + (1,) * (n.ndim - 1)), n, o),
                    new_state, state)
        return state, pred_out, tokens, counts

    @torch.no_grad()
    def decode(self, enc_out: torch.Tensor, enc_lens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """enc_out (B, T, D), enc_lens (B,) → (tokens (B, max_tokens)
        int32, counts (B,) int32)."""
        carry = self.init_carry(enc_out.shape[0], enc_out.device)
        _, _, tokens, counts = self.continue_frames(
            enc_out, carry, enc_lens.to(enc_out.device))
        return tokens.to(torch.int32), counts.to(torch.int32)


class RnntBeamDecoding:
    """Beam transducer decoding, at most one emission per frame, exactly
    as the JAX package computes it (decoding.py:RnntBeamDecoding).

    Per frame, for each utterance: the W beams' blank extensions and the
    top `cutoff_top_k` (K) non-blank extensions of each beam are the
    W + W·K candidates (blanks first); the best M = min(2W, W + W·K) of
    them are materialised as token prefixes; equal prefixes (equal counts
    and equal in all `max_tokens` slots, which are zero-filled) are merged,
    their scores combined with logaddexp into the lowest-index copy and
    the other copies set to NEG_INF; the top W become the new beams. The
    predictor (and the LM) step only for beams that emitted in an active
    frame; frames past `enc_len` carry the beams through unchanged. The
    result is the beam of the highest score (the first of equal ones).
    Scores start at [0, NEG_INF, ...]; every top-k keeps equal values in
    index order, as lax.top_k does.

    With `lm_step` and a nonzero `lm_weight`, the non-blank emission
    scores gain lm_weight · log p_LM(token | the beam's tokens) (shallow
    fusion); the LM's vocabulary must cover the joiner's.
    """

    def __init__(self, predictor_step: Callable,
                 predictor_init_state: Callable, joiner_step: Callable,
                 beam_size: int = 4, cutoff_top_k: int = 4,
                 max_tokens: int = 256, lm_step: Optional[Callable] = None,
                 lm_init_state: Optional[Callable] = None,
                 lm_weight: float = 0.0):
        # lm_step(token (B,), state) → (log-probs (B, V_lm) f32, state)
        # lm_init_state(batch_size, device) → state
        self._pred_step = predictor_step
        self._pred_init = predictor_init_state
        self._join = joiner_step
        self._W = int(beam_size)
        self._K = int(cutoff_top_k)
        self._cap = max_tokens
        self._lm_step = lm_step
        self._lm_init = lm_init_state
        self._lm_weight = float(lm_weight)

    @torch.no_grad()
    def decode(self, enc_out: torch.Tensor, enc_lens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """enc_out (B, T, D), enc_lens (B,) → (tokens (B, max_tokens)
        int32, counts (B,) int32) of each utterance's best beam."""
        B, T, _ = enc_out.shape
        W, K, cap = self._W, self._K, self._cap
        BW = B * W
        M = min(2 * W, W + W * K)
        dev = enc_out.device
        enc_lens = enc_lens.to(dev)
        zeros = torch.zeros((BW,), dtype=torch.int64, device=dev)
        state = self._pred_init(BW, dev)
        pred, state = self._pred_step(zeros, state)
        use_lm = self._lm_step is not None and self._lm_weight != 0.0
        lm_state = lm_dist = None
        if use_lm:
            lm_dist, lm_state = self._lm_step(zeros, self._lm_init(BW, dev))
        scores = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        tokens = torch.zeros((B, W, cap), dtype=torch.int64, device=dev)
        counts = torch.zeros((B, W), dtype=torch.int64, device=dev)
        slot = torch.arange(cap, device=dev)

        def parents_of(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
            """x (B·W, ...) → the rows of each beam's parent."""
            xr = x.reshape(B, W, *x.shape[1:])
            idx = parent.reshape(B, W, *([1] * (x.ndim - 1))).expand_as(xr)
            return torch.gather(xr, 1, idx).reshape(x.shape)

        def where_emit(emit: torch.Tensor, new: torch.Tensor,
                       old: torch.Tensor) -> torch.Tensor:
            return torch.where(emit.reshape((BW,) + (1,) * (old.ndim - 1)),
                               new, old)

        for t in range(T):
            active = enc_lens > t                                 # (B,)
            enc_bw = enc_out[:, t].repeat_interleave(W, dim=0)    # (BW, D)
            logp = self._join(enc_bw, pred[:, 0]).reshape(B, W, -1)
            V = logp.shape[-1]
            blank_sc = scores + logp[..., 0]                      # (B, W)
            emit_lp = logp.clone()
            emit_lp[..., 0] = NEG_INF
            if use_lm:
                if lm_dist.shape[-1] < V:
                    raise ValueError(f"the LM's {lm_dist.shape[-1]} symbols "
                                     f"do not cover the joiner's {V}")
                emit_lp = emit_lp + self._lm_weight * lm_dist.reshape(
                    B, W, -1)[..., :V]
            top_lp, top_tok = top_k(emit_lp, K)                   # (B, W, K)
            emit_sc = scores[..., None] + top_lp
            cand_sc = torch.cat([blank_sc, emit_sc.reshape(B, W * K)], dim=1)

            # merge equal prefixes among the top M candidates
            m_sc, m_sel = top_k(cand_sc, M)                       # (B, M)
            m_is_emit = m_sel >= W
            m_parent = torch.where(m_is_emit, torch.div(
                m_sel - W, K, rounding_mode="floor"), m_sel)
            m_tok = torch.gather(top_tok.reshape(B, W * K), 1,
                                 (m_sel - W).clamp(0, W * K - 1))
            m_tok = torch.where(m_is_emit, m_tok, 0)
            c_tokens = torch.gather(tokens, 1,
                                    m_parent[..., None].expand(B, M, cap))
            c_counts = torch.gather(counts, 1, m_parent)
            wr = (m_is_emit[..., None]
                  & (slot[None, None, :] == c_counts[..., None])
                  & (c_counts[..., None] < cap))
            c_tokens = torch.where(wr, m_tok[..., None], c_tokens)
            c_counts = c_counts + (m_is_emit & (c_counts < cap)).to(
                c_counts.dtype)
            merged_sc = merge_equal_prefixes(m_sc, c_tokens, c_counts)
            sel_sc, sel_m = top_k(merged_sc, W)                   # (B, W)
            is_emit = torch.gather(m_is_emit, 1, sel_m)
            parent = torch.gather(m_parent, 1, sel_m)
            tok = torch.gather(m_tok, 1, sel_m).reshape(BW)
            new_tokens = torch.gather(c_tokens, 1,
                                      sel_m[..., None].expand(B, W, cap))
            new_counts = torch.gather(c_counts, 1, sel_m)

            # predictor (and LM) step for the beams that emitted
            emit_bw = (is_emit & active[:, None]).reshape(BW)
            par_state = _map_state(lambda x: parents_of(x, parent), state)
            par_pred = parents_of(pred, parent)
            stepped_pred, stepped_state = self._pred_step(tok, par_state)
            pred = where_emit(emit_bw, stepped_pred, par_pred)
            state = _map_state(lambda n, o: where_emit(emit_bw, n, o),
                               stepped_state, par_state)
            if use_lm:
                par_lm = _map_state(lambda x: parents_of(x, parent), lm_state)
                par_dist = parents_of(lm_dist, parent)
                stepped_dist, stepped_lm = self._lm_step(tok, par_lm)
                lm_state = _map_state(lambda n, o: where_emit(emit_bw, n, o),
                                      stepped_lm, par_lm)
                lm_dist = where_emit(emit_bw, stepped_dist, par_dist)

            # frames past enc_len carry the beams through unchanged
            keep = active[:, None]
            scores = torch.where(keep, sel_sc, scores)
            tokens = torch.where(keep[..., None], new_tokens, tokens)
            counts = torch.where(keep, new_counts, counts)

        _, best = top_k(scores, 1)                                # first max
        best_tokens = torch.gather(tokens, 1,
                                   best[..., None].expand(B, 1, cap))[:, 0]
        best_counts = torch.gather(counts, 1, best)[:, 0]
        return best_tokens.to(torch.int32), best_counts.to(torch.int32)


# ------------------------------------------------------------------- CIF
class CifGreedyDecoding:
    """Non-autoregressive decoding of the CIF task: the argmax of each
    fired position (the first of equal maxima), `token_lens` tokens."""

    @torch.no_grad()
    def decode(self, log_probs: torch.Tensor, token_lens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (log_probs.argmax(dim=-1).to(torch.int32),
                token_lens.to(torch.int32))


def build_decoding(metric: Dict[str, Any],
                   predictor_step: Optional[Callable] = None,
                   predictor_init_state: Optional[Callable] = None,
                   joiner_step: Optional[Callable] = None,
                   lm_step: Optional[Callable] = None,
                   lm_init_state: Optional[Callable] = None,
                   lm_weight: float = 0.0,
                   tokenizer: Optional[Tokenizer] = None):
    """The decoder a config's `metric` section asks for: over log-probs,
    `ctc_greedy_search`, and `ctc_prefix_beam_search` with `beam_size`
    and `cand_size` (default 8 each; tasks/ctc.py); over encoder frames
    with the predictor and joiner steps, `rnnt_greedy_search` with
    `max_token_step`, and `rnnt_beam_search` with `beam_size` (default
    4), `cutoff_top_k` (default 4) and the optional fusion LM
    (tasks/rnnt.py:BaseRnntTask); over the CIF task's log-probs,
    `cif_greedy_search`; and `ctc_lexicon_beam_search`, the C++ runtime's
    lexicon beam (runtime_binding.py) over the words of
    `metric.word_list`, each spelled by `tokenizer`, with the optional
    ARPA LM `arpa_lm`, `beam_size` (default 16), `lm_weight` (default
    1.0) and `word_score` (default 0.0), as tasks/ctc.py of the JAX
    package builds it; it returns texts. Any other method raises
    NotImplementedError."""
    method = metric.get("decode_method", "rnnt_greedy_search")
    if method == "ctc_greedy_search":
        return CtcGreedyDecoding()
    if method == "ctc_lexicon_beam_search":
        return lexicon_decoding(metric, tokenizer)
    if method == "ctc_prefix_beam_search":
        return CtcPrefixBeamDecoding(
            beam_size=int(metric.get("beam_size", 8)),
            cand_size=int(metric.get("cand_size", 8)))
    if method == "rnnt_greedy_search":
        return RnntGreedyDecoding(
            predictor_step, predictor_init_state, joiner_step,
            max_token_step=int(metric.get("max_token_step", 1)))
    if method == "rnnt_beam_search":
        return RnntBeamDecoding(
            predictor_step, predictor_init_state, joiner_step,
            beam_size=int(metric.get("beam_size", 4)),
            cutoff_top_k=int(metric.get("cutoff_top_k", 4)),
            lm_step=lm_step, lm_init_state=lm_init_state,
            lm_weight=lm_weight)
    if method == "cif_greedy_search":
        return CifGreedyDecoding()
    raise NotImplementedError(f"decode method {method!r} is not ported "
                              f"(ctc_greedy_search, ctc_prefix_beam_search,"
                              f" ctc_lexicon_beam_search, "
                              f"rnnt_greedy_search, rnnt_beam_search, "
                              f"cif_greedy_search)")


def lexicon_decoding(metric: Dict[str, Any], tokenizer: Tokenizer):
    """`ctc_lexicon_beam_search` of a `metric` section (build_decoding)."""
    with open(metric["word_list"]) as f:
        words = [w.strip() for w in f if w.strip()]
    lexicon = {w: tokenizer.encode(w).tolist() for w in words}
    return CtcLexiconBeamDecoding(
        lexicon, arpa_path=metric.get("arpa_lm"),
        beam_size=int(metric.get("beam_size", 16)),
        lm_weight=float(metric.get("lm_weight", 1.0)),
        word_score=float(metric.get("word_score", 0.0)))
