"""Batched transducer decoding (port of speech2text_tpu/decoding.py:
RnntGreedyDecoding, RnntBeamDecoding) and the decoder factory of a
`metric` config section (`build_decoding`).

Each decoder is one loop over encoder frames, vectorized over the batch
(and the beam), with no host synchronisation inside: no value is read
back and no Python branch depends on a tensor's value. Both return
`(tokens (B, max_tokens) int32, counts (B,) int32)`; the predictor is
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

    @torch.no_grad()
    def continue_frames(self, enc_out: torch.Tensor, carry: Carry,
                        enc_lens: Optional[torch.Tensor] = None) -> Carry:
        """The frame loop over enc_out (B, T, D) from `carry` (predictor
        state, predictor output, tokens (B, max_tokens), counts (B,)) →
        the carry after the last frame. Frames at or past `enc_lens`
        emit nothing; without `enc_lens` every frame is active (streaming,
        resumed chunk by chunk)."""
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
                state = torch.where(
                    emit.reshape((B,) + (1,) * (state.ndim - 1)), new_state,
                    state)
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


def build_decoding(metric: Dict[str, Any], predictor_step: Callable,
                   predictor_init_state: Callable, joiner_step: Callable,
                   lm_step: Optional[Callable] = None,
                   lm_init_state: Optional[Callable] = None,
                   lm_weight: float = 0.0):
    """The decoder a config's `metric` section asks for
    (tasks/rnnt.py:BaseRnntTask): `rnnt_greedy_search` with
    `max_token_step`; `rnnt_beam_search` with `beam_size` (default 4),
    `cutoff_top_k` (default 4) and the optional fusion LM. Any other
    method raises NotImplementedError."""
    method = metric.get("decode_method", "rnnt_greedy_search")
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
    raise NotImplementedError(f"decode method {method!r} is not ported "
                              f"(rnnt_greedy_search, rnnt_beam_search)")
