"""Forward FLOPs of the Zipformer2 pruned RNN-T model (Yao et al.,
arXiv:2310.11230): the convolutional embed, six stacks of layers at
their own frame rates, the stateless predictor, the joiner and the
simple loss's product. The counts module of the configurations that
name "zipformer" (counts/__init__.py): `step_flops` and `b2_calls`."""

from __future__ import annotations

import math
from typing import Any, Dict, List

from .frames import fbank_frames
from .kernels import b2_calls  # noqa: F401  (the flagship's featurize)

EMBED_CHANNELS = 32


def embed_frames(frames: int) -> int:
    """Frames after the embed: three 3×3 convolutions, the middle one of
    stride 2, all without padding."""
    return ((frames - 2 - 3) // 2 + 1) - 2


def embed_flops(frames: int, feat_dim: int, out_dim: int) -> float:
    C = EMBED_CHANNELS
    t1, f1 = frames - 2, feat_dim - 2
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 3) // 2 + 1
    t3, f3 = t2 - 2, f2 - 2
    return (2 * 9 * C * t1 * f1                 # conv1, 1 → C
            + 2 * 9 * C * C * t2 * f2           # conv2, stride 2
            + 2 * 9 * C * C * t3 * f3           # conv3
            + 2 * 49 * C * t3 * f3              # ConvNeXt depthwise 7×7
            + 2 * 2 * C * 3 * C * t3 * f3       # ConvNeXt pointwise pair
            + 2 * f3 * C * out_dim * t3)        # to the first stack's dim


def layer_flops(T: int, D: int, ff: int, H: int, qd: int, vd: int, pd: int,
                pos_dim: int, kernel: int) -> float:
    """One Zipformer2 layer on T frames (per utterance)."""
    per_frame = (2 * D * H * (2 * qd + pd)      # q, k, query-position
                 + 2 * 2 * D * (ff * 3 // 4)    # feedforward 1
                 + 2 * 2 * D * ff               # feedforward 2
                 + 2 * 2 * D * (ff * 5 // 4)    # feedforward 3
                 + 2 * D * 3 * (D * 3 // 4)     # nonlinear attention in
                 + 2 * (D * 3 // 4) * D         # ... and out
                 + 2 * 2 * 2 * D * H * vd       # two self-attentions: v, out
                 + 2 * (2 * D * 2 * D           # two convolution modules:
                        + 2 * kernel * D        # in, depthwise, out
                        + 2 * D * D))
    squares = (2 * H * T * T * (qd + pd)        # attention scores
               + 2 * 2 * H * T * T * vd         # two weighted sums of v
               + 2 * T * T * (D * 3 // 4))      # nonlinear attention's sum
    pos = 2 * pos_dim * H * pd * (2 * T - 1)    # position table
    return T * per_frame + squares + pos


def stack_frames(T0: int, downsampling: List[int]) -> List[int]:
    return [math.ceil(T0 / ds) for ds in downsampling]


def encoder_flops(enc: Dict[str, Any], frames: int) -> float:
    T0 = embed_frames(frames)
    dims = enc["encoder_dim"]
    total = embed_flops(frames, enc.get("feature_dim", 80), dims[0])
    for i, T in enumerate(stack_frames(T0, enc["downsampling_factor"])):
        total += enc["num_encoder_layers"][i] * layer_flops(
            T, dims[i], enc["feedforward_dim"][i], enc["num_heads"][i],
            enc["query_head_dim"], enc["value_head_dim"],
            enc["pos_head_dim"], enc["pos_dim"], enc["cnn_module_kernel"][i])
    return total


def output_frames(frames: int, enc: Dict[str, Any]) -> int:
    f = enc.get("output_downsampling_factor", 2)
    return math.ceil(embed_frames(frames) / f)


def rnnt_forward_flops(config: Dict[str, Any], batch: int, pcm_len: int,
                       label_len: int) -> float:
    enc = config["encoder"]["config"]
    frames = fbank_frames(pcm_len)
    T = output_frames(frames, enc)
    U1 = label_len + 1
    pred = config["predictor"]["config"]
    E, P = pred["symbol_embedding_dim"], pred["output_dim"]
    ctx = pred.get("context_size", 1)
    j = config["joiner"]
    D, V, r = j["input_dim"], j["output_dim"], j["prune_range"]
    per_utt = (encoder_flops(enc, frames)
               + U1 * (2 * ctx * E * (ctx > 1) + 2 * E * P)   # predictor
               + T * 2 * D * V + U1 * 2 * D * V               # projections
               + 2 * T * U1 * V)                              # simple loss
    if j.get("use_out_project", True):
        inner = j.get("inner_dim", 256)
        per_utt += T * r * 2 * 2 * V * inner
    return batch * per_utt


def step_flops(config: Dict[str, Any], batch: int, pcm_len: int,
               label_len: int) -> float:
    """Model FLOPs of one training step: 3× the forward."""
    task = config["task"]["type"]
    enc = config["encoder"]
    if task == "Pruned_Rnnt" and enc["model"] == "Zipformer":
        return 3.0 * rnnt_forward_flops(config, batch, pcm_len, label_len)
    raise ValueError(f"no FLOP count for task {task} with {enc['model']}")
