"""RNN language model (port of speech2text_tpu/models/rnn_lm.py): embedding
→ LSTM stack → Dense, for shallow fusion in beam decoding.

The LSTM is flax's OptimizedLSTMCell (`run_lstm`, shared with the LSTM
transducer predictor, models/predictor.py): gates i, f, g, o from
W_h·h + b_h + W_i·x (the input projections have no bias), c' = f·c + i·g,
h' = o·tanh(c'); the state of each layer is (c, h) as flax's carry. Its
weights sit in an `nn.LSTM` (`rnns`, PyTorch's layout: `weight_ih_l{i}`
stacks the gates' input kernels in the order i, f, g, o, `bias_ih_l{i}`
stays zero) whose `forward` is not used (cuDNN's cell orders and rounds
otherwise): the cell runs as matmuls in the config's dtype on f32
parameters, as flax computes it, the input projections of a layer for
every step in one matmul. Logits and log-probs are f32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, Embed, dtype_of, variance_scaling_

LstmState = List[Tuple[torch.Tensor, torch.Tensor]]


def flax_lstm(input_size: int, hidden_size: int, num_layers: int
              ) -> nn.LSTM:
    """The weights of a stack of flax OptimizedLSTMCells in an `nn.LSTM`
    (its forward is not used: `run_lstm` runs them). flax's input kernels
    have no bias, so every `bias_ih_l{i}` is zero and takes no gradient."""
    lstm = nn.LSTM(input_size, hidden_size, num_layers=num_layers,
                   batch_first=True)
    with torch.no_grad():
        for i in range(num_layers):
            getattr(lstm, f"bias_ih_l{i}").zero_().requires_grad_(False)
    return lstm


def init_lstm_(lstm: nn.LSTM, generator: torch.Generator) -> None:
    """Seeded init in flax's manner: input kernels lecun-normal, recurrent
    kernels orthogonal per gate, biases zero."""
    H = lstm.hidden_size
    with torch.no_grad():
        for i in range(lstm.num_layers):
            w_ih = getattr(lstm, f"weight_ih_l{i}")
            w_hh = getattr(lstm, f"weight_hh_l{i}")
            for gate in range(4):
                rows = slice(gate * H, (gate + 1) * H)
                variance_scaling_(w_ih[rows], 1.0, w_ih.shape[1], generator)
                nn.init.orthogonal_(w_hh[rows], generator=generator)
            getattr(lstm, f"bias_ih_l{i}").zero_()
            getattr(lstm, f"bias_hh_l{i}").zero_()


def run_lstm(lstm: nn.LSTM, x: torch.Tensor, state: LstmState,
             dtype: torch.dtype) -> Tuple[torch.Tensor, LstmState]:
    """x (B, L, in) through every layer of `lstm` from `state` ((c, h)
    per layer) with flax's OptimizedLSTMCell arithmetic in `dtype` →
    (the last layer's h at every step (B, L, H), the state after L
    steps)."""
    new_state = []
    for i, (c, h) in enumerate(state):
        w_hh = getattr(lstm, f"weight_hh_l{i}").to(dtype)
        b_hh = getattr(lstm, f"bias_hh_l{i}").to(dtype)
        xi = F.linear(x.to(dtype), getattr(lstm, f"weight_ih_l{i}").to(dtype))
        outs = []
        for t in range(x.shape[1]):
            gates = F.linear(h.to(dtype), w_hh, b_hh) + xi[:, t]
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            c = torch.sigmoid(gf) * c.to(dtype) \
                + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            outs.append(h)
        new_state.append((c, h))
        x = torch.stack(outs, dim=1)
    return x, new_state


@dataclasses.dataclass
class RnnLmConfig:
    num_symbols: int = 128
    embedding_dim: int = 256
    hidden_dim: int = 512
    num_layers: int = 2
    dtype: str = "float32"


class RnnLm(nn.Module):

    def __init__(self, config: RnnLmConfig):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype_of(cfg.dtype)
        self.embed = Embed(cfg.num_symbols, cfg.embedding_dim,
                           dtype=self.dtype)
        self.rnns = flax_lstm(cfg.embedding_dim, cfg.hidden_dim,
                              cfg.num_layers)
        self.out = Dense(cfg.hidden_dim, cfg.num_symbols, dtype=self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in flax's manner: embedding N(0, 1/E), input and
        output kernels lecun-normal, recurrent kernels orthogonal per
        gate, biases zero."""
        self.embed.init_parameters(generator)
        init_lstm_(self.rnns, generator)
        self.out.init_parameters(generator)

    def init_state(self, batch_size: int,
                   device: torch.device | str = "cpu") -> LstmState:
        """Zero (c, h) per layer, (B, hidden) in the config's dtype."""
        zeros = torch.zeros((batch_size, self.config.hidden_dim),
                            dtype=self.dtype, device=device)
        return [(zeros, zeros) for _ in range(self.config.num_layers)]

    def _run(self, tokens: torch.Tensor, state: LstmState
             ) -> Tuple[torch.Tensor, LstmState]:
        """tokens (B, L) → (logits (B, L, V) f32, state after L steps)."""
        x, new_state = run_lstm(self.rnns, self.embed(tokens), state,
                                self.dtype)
        return self.out(x).float(), new_state

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) → logits (B, L, V)."""
        return self._run(tokens, self.init_state(tokens.shape[0],
                                                 tokens.device))[0]

    def score(self, tokens: torch.Tensor) -> torch.Tensor:
        """Log-prob of each next token, (B, L−1)."""
        lp = torch.log_softmax(self(tokens[:, :-1]), dim=-1)
        return torch.gather(lp, 2, tokens[:, 1:, None].long())[..., 0]

    def score_step(self, token: torch.Tensor, state: LstmState
                   ) -> Tuple[torch.Tensor, LstmState]:
        """token (B,) → (log-probs (B, V) f32, new state)."""
        logits, new_state = self._run(token[:, None], state)
        return torch.log_softmax(logits[:, 0], dim=-1), new_state
