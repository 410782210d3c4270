"""Int8 decoding of the transducer's predictor and joiner (port of
speech2text_tpu/quant.py).

The weights are the int8 artifact of export.py:quantize_params: int8
per output channel (a flax kernel's last axis) with an f32 scale, small
leaves f32. Activations are quantized per row at run time:

  a_scale = max(max|x| / 127, 1e-12)      (per row)
  y       = int32(x_q · W_q) · (a_scale · w_scale) + bias

with the two scales multiplied first, as JAX does. The int8 × int8 →
int32 product is `torch._int_mm` (cuBLASLt on the card), on operands
zero-padded to shapes its CUDA route takes: it refuses 16 rows or fewer
and inner or output dims that are not multiples of 8, and on the H100
(torch 2.11) cuBLASLt had no algorithm for 17, 24, 48 or 80 rows at
inner dims under 128, while every multiple of 32 rows ran; so rows are
padded to a multiple of 32. The padding is exact in integers, and the
CPU takes the same padded product. Embedding tables are gathered in
int8 and scaled per column; the stateless predictor's depthwise context
conv runs in f32 on the dequantized kernel.

`Int8RnntGreedyDecoding` and `Int8RnntBeamDecoding` are the port's
greedy and beam decoders (decoding.py) on the int8 step functions.

The LSTM predictor's and the joiner's transcendental functions are
attributes (`sigmoid`, `tanh`, `log_softmax`), so that a check can take
them from another device: the card and the CPU round them differently
in the last ulp, and requantizing the LSTM state turns such a difference
into a different int8 activation now and then (chip_smoke.py phase 17).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .decoding import RnntBeamDecoding, RnntGreedyDecoding
from .export import quantize_params
from .models.predictor import LstmPredictorConfig, StatelessPredictorConfig

ROW_MULTIPLE = 32  # rows torch._int_mm runs on the card (module docstring)
DIM_MULTIPLE = 8   # its inner and output dims

Device = Union[str, torch.device]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class QTensor:
    """An int8 payload with its per-output-channel f32 scale, or an f32
    passthrough (`scale` None), as tensors on `device`. A 2-D int8
    payload also keeps its copy zero-padded for `int_mm`."""

    def __init__(self, q, scale=None, device: Device = "cpu"):
        self.q = torch.as_tensor(np.asarray(q)).to(device)
        self.scale = None if scale is None else \
            torch.as_tensor(np.asarray(scale)).to(device)
        self.q_mm = None
        if self.is_quantized and self.q.ndim == 2:
            K, N = self.q.shape
            self.q_mm = torch.zeros(
                (_round_up(K, DIM_MULTIPLE), _round_up(N, DIM_MULTIPLE)),
                dtype=torch.int8, device=self.q.device)
            self.q_mm[:K, :N] = self.q

    @property
    def is_quantized(self) -> bool:
        return self.scale is not None

    def dequant(self) -> torch.Tensor:
        if self.scale is None:
            return self.q
        return self.q.float() * self.scale


def flat_qtree(params: Dict[str, Any], min_size: int = 1024,
               device: Device = "cpu") -> Dict[str, QTensor]:
    """{path: QTensor} on `device` from a flax-layout tree (quantized by
    quantize_params) or from an artifact already in the flat format of
    save_quantized (keys ending in `.scale` / `.fp32`)."""
    if any(k.endswith((".fp32", ".scale")) for k in params):
        flat = params
    else:
        flat = quantize_params(params, min_size=min_size)
    out: Dict[str, QTensor] = {}
    for k, v in flat.items():
        if k.endswith(".scale"):
            continue
        if k.endswith(".fp32"):
            out[k[:-5]] = QTensor(v, device=device)
        else:
            out[k] = QTensor(v, flat[k + ".scale"], device=device)
    return out


def int_mm(a: torch.Tensor, w: QTensor) -> torch.Tensor:
    """a (M, K) int8 · w's payload (K, N) → (M, N) int32, by torch._int_mm
    on zero-padded operands."""
    M, K = a.shape
    N = w.q.shape[1]
    Kp = w.q_mm.shape[0]
    Mp = _round_up(M, ROW_MULTIPLE)
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    return torch._int_mm(a.contiguous(), w.q_mm)[:M, :N]


def quant_dense(x: torch.Tensor, w: QTensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Dynamic-activation int8 dense: x (..., in) · W (in, out) + bias, in
    f32."""
    if not w.is_quantized:
        y = torch.matmul(x.float(), w.q.float())
        return y if bias is None else y + bias
    a_scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    a_scale = torch.clamp(a_scale, min=1e-12)
    xq = torch.clamp(torch.round(x / a_scale), -127, 127).to(torch.int8)
    lead = xq.shape[:-1]
    y = int_mm(xq.reshape(-1, xq.shape[-1]), w).reshape(*lead, -1)
    y = y.float() * (a_scale * w.scale)
    return y if bias is None else y + bias


def _gather(embed: QTensor, ids: torch.Tensor) -> torch.Tensor:
    h = embed.q[ids]
    return h.float() * embed.scale if embed.is_quantized else h


class Int8StatelessPredictor:
    """Int8 step of models/predictor.py:StatelessPredictor: the last
    `context_size` tokens' embeddings through the f32 depthwise context
    conv (bias-free), then the int8 output dense, with no activation in
    between."""

    def __init__(self, qt: Dict[str, QTensor], context_size: int,
                 prefix: str = "predictor"):
        self.embed = qt[f"{prefix}/embed/embedding"]
        self.out_w = qt[f"{prefix}/out/kernel"]
        self.out_b = qt[f"{prefix}/out/bias"].dequant()
        self.ctx = context_size
        if context_size > 1:
            # the (ctx, 1, E) depthwise kernel → (ctx, E)
            self.conv_w = qt[f"{prefix}/conv/kernel"].dequant()[:, 0, :]

    def init_state(self, batch_size: int,
                   device: Device = "cpu") -> torch.Tensor:
        return torch.zeros((batch_size, max(self.ctx - 1, 1)),
                           dtype=torch.int64, device=device)

    def step(self, token: torch.Tensor, state: torch.Tensor):
        tokens = torch.cat([state, token.to(state.dtype)[:, None]], dim=1)
        h = _gather(self.embed, tokens)                        # (B, ctx, E)
        if self.ctx > 1:
            h = torch.einsum("bte,te->be", h, self.conv_w)
        else:
            h = h[:, -1]
        out = quant_dense(h, self.out_w, self.out_b)
        return out[:, None, :], tokens[:, 1:]


class Int8LstmPredictor:
    """Int8 step of models/predictor.py:LstmPredictor, with flax
    LSTMCell's gates (input kernels i{i,f,g,o} without bias, hidden
    kernels h{i,f,g,o} with bias): i, f, o = σ(x·Wi + h·Wh + b),
    g = tanh(...), c' = f⊙c + i⊙g, h' = o⊙tanh(c'); every gate product
    int8."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, qt: Dict[str, QTensor], num_layers: int,
                 hidden_dim: int, prefix: str = "predictor"):
        self.embed = qt[f"{prefix}/embed/embedding"]
        self.out_w = qt[f"{prefix}/out/kernel"]
        self.out_b = qt[f"{prefix}/out/bias"].dequant()
        self.layers = []
        for i in range(num_layers):
            cell = f"{prefix}/rnns_{i}/cell"
            self.layers.append({
                g: (qt[f"{cell}/i{g}/kernel"], qt[f"{cell}/h{g}/kernel"],
                    qt[f"{cell}/h{g}/bias"].dequant())
                for g in self.GATES})
        self.hidden = hidden_dim
        self.sigmoid, self.tanh = torch.sigmoid, torch.tanh

    def init_state(self, batch_size: int, device: Device = "cpu"):
        """Zero (c, h) per layer, (B, hidden) f32."""
        z = torch.zeros((batch_size, self.hidden), dtype=torch.float32,
                        device=device)
        return [(z, z) for _ in self.layers]

    def step(self, token: torch.Tensor, state):
        x = _gather(self.embed, token.long())
        new_state = []
        for (c, h), gates in zip(state, self.layers):
            h = h.float()
            acts = {g: quant_dense(x, iw, None) + quant_dense(h, hw, hb)
                    for g, (iw, hw, hb) in gates.items()}
            i = self.sigmoid(acts["i"])
            f = self.sigmoid(acts["f"])
            gg = self.tanh(acts["g"])
            o = self.sigmoid(acts["o"])
            c = f * c.float() + i * gg
            h = o * self.tanh(c)
            new_state.append((c, h))
            x = h
        out = quant_dense(x, self.out_w, self.out_b)
        return out[:, None, :], new_state


def build_int8_predictor(qt: Dict[str, QTensor], predictor_config: Any,
                         prefix: str = "predictor"):
    """The int8 predictor step of the family whose config (with its dims)
    `predictor_config` is."""
    if isinstance(predictor_config, StatelessPredictorConfig):
        return Int8StatelessPredictor(qt, predictor_config.context_size,
                                      prefix)
    if isinstance(predictor_config, LstmPredictorConfig):
        return Int8LstmPredictor(qt, predictor_config.num_lstm_layers,
                                 predictor_config.lstm_hidden_dim, prefix)
    raise ValueError(f"no int8 predictor for {predictor_config!r}")


class Int8Joiner:
    """Int8 single-frame join of models/joiner.py:Joiner.streaming_step."""

    def __init__(self, qt: Dict[str, QTensor], activation: str = "relu",
                 use_out_project: bool = True, prefix: str = "joiner"):
        def wb(name):
            return (qt[f"{prefix}/{name}/kernel"],
                    qt[f"{prefix}/{name}/bias"].dequant())
        self.enc = wb("enc_proj")
        self.pre = wb("pre_proj")
        self.act = torch.relu if activation == "relu" else torch.tanh
        self.out = (wb("out_proj_a"), wb("out_proj_b")) \
            if use_out_project else ()
        self.log_softmax = torch.log_softmax

    def step(self, enc_frame: torch.Tensor,
             pred_out: torch.Tensor) -> torch.Tensor:
        h = self.act(quant_dense(enc_frame, *self.enc)
                     + quant_dense(pred_out, *self.pre))
        for w, b in self.out:
            h = quant_dense(h, w, b)
        return self.log_softmax(h.float(), dim=-1)


def _int8_steps(params: Dict[str, Any], predictor_config: Any,
                joiner_config: Any, min_size: int, device: Device):
    qt = flat_qtree(params, min_size=min_size, device=device)
    pred = build_int8_predictor(qt, predictor_config)
    join = Int8Joiner(qt, activation=joiner_config.activation,
                      use_out_project=joiner_config.use_out_project)
    return pred, join


class Int8RnntGreedyDecoding(RnntGreedyDecoding):
    """Greedy transducer decoding with the int8 predictor and joiner, from
    a flax-layout tree (quantized here) or a save_quantized artifact."""

    def __init__(self, params: Dict[str, Any], predictor_config: Any,
                 joiner_config: Any,
                 max_token_step: int = 1, max_tokens: int = 256,
                 min_size: int = 1024, device: Device = "cpu"):
        pred, join = _int8_steps(params, predictor_config, joiner_config,
                                 min_size, device)
        super().__init__(pred.step, pred.init_state, join.step,
                         max_token_step=max_token_step,
                         max_tokens=max_tokens)
        self.predictor, self.joiner = pred, join


class Int8RnntBeamDecoding(RnntBeamDecoding):
    """Beam transducer decoding (decoding.py:RnntBeamDecoding, no LM) with
    the int8 predictor and joiner."""

    def __init__(self, params: Dict[str, Any], predictor_config: Any,
                 joiner_config: Any,
                 beam_size: int = 4, cutoff_top_k: int = 4,
                 max_tokens: int = 256, min_size: int = 1024,
                 device: Device = "cpu"):
        pred, join = _int8_steps(params, predictor_config, joiner_config,
                                 min_size, device)
        super().__init__(pred.step, pred.init_state, join.step,
                         beam_size=beam_size, cutoff_top_k=cutoff_top_k,
                         max_tokens=max_tokens)
        self.predictor, self.joiner = pred, join
