"""Batched greedy transducer decoding (port of
speech2text_tpu/decoding.py:RnntGreedyDecoding).

One loop over encoder frames, vectorized over the batch, with no host
synchronisation inside: at each frame the joiner scores the encoder frame
against the predictor output; the argmax is emitted unless it is blank
(0), the frame is past the utterance, or the utterance already holds
`max_tokens` tokens; at most `max_token_step` emissions per frame. The
predictor is primed with token 0. `ids_to_texts` and `reference_decoder`
turn token ids and label tensors into text through a tokenizer.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from .data.tokenizer import Tokenizer


def ids_to_texts(tokens: np.ndarray, counts: np.ndarray,
                 tokenizer: Tokenizer) -> List[str]:
    """Decoded token rows (B, cap) with their counts (B,) → texts."""
    return [tokenizer.decode(row[:int(n)]) for row, n in zip(tokens, counts)]


def reference_decoder(labels: np.ndarray, label_lengths: np.ndarray,
                      tokenizer: Tokenizer) -> List[str]:
    """Ground-truth label tensor → texts."""
    return [tokenizer.decode(row[:int(n)])
            for row, n in zip(np.asarray(labels), np.asarray(label_lengths))]


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

    @torch.no_grad()
    def decode(self, enc_out: torch.Tensor, enc_lens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """enc_out (B, T, D), enc_lens (B,) → (tokens (B, max_tokens)
        int32, counts (B,) int32)."""
        B, T, _ = enc_out.shape
        dev = enc_out.device
        cap = self._cap
        state = self._pred_init(B, dev)
        pred_out, state = self._pred_step(
            torch.zeros((B,), dtype=torch.int64, device=dev), state)
        tokens = torch.zeros((B, cap), dtype=torch.int64, device=dev)
        counts = torch.zeros((B,), dtype=torch.int64, device=dev)
        slot = torch.arange(cap, device=dev)
        enc_lens = enc_lens.to(dev)
        for t in range(T):
            enc_t = enc_out[:, t]
            active0 = enc_lens > t
            for _ in range(self._max_token_step):
                logp = self._join(enc_t, pred_out[:, 0])
                tok = torch.argmax(logp, dim=-1)
                emit = active0 & (tok != 0) & (counts < cap)
                write = emit[:, None] & (slot[None, :] == counts[:, None])
                tokens = torch.where(write, tok[:, None], tokens)
                counts = counts + emit.to(counts.dtype)
                new_pred, new_state = self._pred_step(tok, state)
                pred_out = torch.where(emit[:, None, None], new_pred,
                                       pred_out)
                state = torch.where(
                    emit.reshape((B,) + (1,) * (state.ndim - 1)), new_state,
                    state)
        return tokens.to(torch.int32), counts.to(torch.int32)
