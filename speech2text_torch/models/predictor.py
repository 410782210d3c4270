"""Transducer predictors (port of speech2text_tpu/models/predictor.py).

- `StatelessPredictor`: embedding → bias-free depthwise Conv1d over the
  last `context_size` tokens → output Dense, with no activation in
  between, as in the JAX package; the state is the last
  `context_size − 1` token ids.
- `LstmPredictor`: embedding → a stack of flax OptimizedLSTMCells
  (models/rnn_lm.py:run_lstm, weights in an `nn.LSTM` named `rnns`, so
  convert.py maps flax's `rnns_{i}/cell` leaves as for the RNN-LM) →
  output Dense; the input is blank ⊕ targets; the state is a list of
  (c, h) per layer, and `streaming_step` takes one token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Conv, Dense, Embed, dtype_of
from .rnn_lm import LstmState, flax_lstm, init_lstm_, run_lstm


@dataclasses.dataclass
class StatelessPredictorConfig:
    num_symbols: int = 128
    output_dim: int = 256
    symbol_embedding_dim: int = 512
    context_size: int = 5
    dtype: str = "float32"


@dataclasses.dataclass
class LstmPredictorConfig:
    num_symbols: int = 128
    output_dim: int = 256
    symbol_embedding_dim: int = 512
    num_lstm_layers: int = 2
    lstm_hidden_dim: int = 512
    # the JAX package always feeds blank (id 0) first, set or not
    blank_as_sos: bool = True
    dtype: str = "float32"


class StatelessPredictor(nn.Module):
    def __init__(self, config: StatelessPredictorConfig):
        super().__init__()
        cfg = self.config = config
        dt = dtype_of(cfg.dtype)
        E = cfg.symbol_embedding_dim
        self.embed = Embed(cfg.num_symbols, E, dtype=dt)
        if cfg.context_size > 1:
            self.conv = Conv(E, E, (cfg.context_size,), groups=E, bias=False,
                             dtype=dt)
        self.out = Dense(E, cfg.output_dim, dtype=dt)

    def _net(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) left-padded with context → (B, L−context+1, D)."""
        h = self.embed(tokens)
        if self.config.context_size > 1:
            h = self.conv(h)
        return self.out(h).float()

    def forward(self, targets: torch.Tensor,
                target_lengths: Optional[torch.Tensor] = None):
        """targets (B, U) → (B, U+1, output_dim); row u conditions on
        y_1..y_u (row 0 on blank context only)."""
        B, U = targets.shape
        ctx = targets.new_zeros((B, self.config.context_size))
        out = self._net(torch.cat([ctx, targets], dim=1))[:, -(U + 1):]
        if target_lengths is None:
            return out
        return out, target_lengths.to(torch.int32) + 1

    def init_state(self, batch_size: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
        """(B, context_size − 1) blank token ids."""
        n = max(self.config.context_size - 1, 1)
        return torch.zeros((batch_size, n), dtype=torch.int64, device=device)

    def streaming_step(self, token: torch.Tensor, state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """token (B,) last emitted id, state (B, context−1) →
        (pred_out (B, 1, output_dim), new_state)."""
        tokens = torch.cat([state, token.to(state.dtype)[:, None]], dim=1)
        return self._net(tokens)[:, -1:], tokens[:, 1:]


class LstmPredictor(nn.Module):
    def __init__(self, config: LstmPredictorConfig):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype_of(cfg.dtype)
        self.embed = Embed(cfg.num_symbols, cfg.symbol_embedding_dim,
                           dtype=self.dtype)
        self.rnns = flax_lstm(cfg.symbol_embedding_dim, cfg.lstm_hidden_dim,
                              cfg.num_lstm_layers)
        self.out = Dense(cfg.lstm_hidden_dim, cfg.output_dim,
                         dtype=self.dtype)

    def init_parameters(self, g: torch.Generator) -> None:
        """The LSTM's weights as flax initialises them (the embedding and
        the output Dense are initialised as submodules)."""
        init_lstm_(self.rnns, g)

    def init_state(self, batch_size: int,
                   device: torch.device | str = "cpu") -> LstmState:
        """Zero (c, h) per layer, (B, hidden) in the config's dtype."""
        zeros = torch.zeros((batch_size, self.config.lstm_hidden_dim),
                            dtype=self.dtype, device=device)
        return [(zeros, zeros) for _ in range(self.config.num_lstm_layers)]

    def _run(self, tokens: torch.Tensor, state: LstmState
             ) -> Tuple[torch.Tensor, LstmState]:
        x, new_state = run_lstm(self.rnns, self.embed(tokens), state,
                                self.dtype)
        return self.out(x).float(), new_state

    def forward(self, targets: torch.Tensor,
                target_lengths: Optional[torch.Tensor] = None):
        """targets (B, U) → (B, U+1, output_dim) f32 from blank ⊕
        targets (and the lengths + 1 with `target_lengths`)."""
        B = targets.shape[0]
        tokens = torch.cat([targets.new_zeros((B, 1)), targets], dim=1)
        out, _ = self._run(tokens, self.init_state(B, targets.device))
        if target_lengths is None:
            return out
        return out, target_lengths.to(torch.int32) + 1

    def streaming_step(self, token: torch.Tensor, state: LstmState
                       ) -> Tuple[torch.Tensor, LstmState]:
        """token (B,) → (pred_out (B, 1, output_dim), new state)."""
        return self._run(token[:, None], state)
