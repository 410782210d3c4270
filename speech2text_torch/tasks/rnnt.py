"""Transducer model assembly (port of the serving half of
speech2text_tpu/tasks/rnnt.py:RnntModel): encoder + predictor + joiner,
with the three calls greedy decoding needs."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..config import from_dict
from ..models.joiner import Joiner, JoinerConfig
from ..models.layers import init_parameters
from ..models.predictor import StatelessPredictor, StatelessPredictorConfig
from ..models.zipformer import Zipformer2, Zipformer2Config


def build_encoder(config: Dict[str, Any]) -> nn.Module:
    if config["model"] != "Zipformer":
        raise NotImplementedError(
            f"encoder {config['model']!r} is not ported (Zipformer only)")
    return Zipformer2(Zipformer2Config.from_config(config.get("config", {})))


def build_predictor(config: Dict[str, Any]) -> nn.Module:
    if config["model"] != "Stateless":
        raise NotImplementedError(
            f"predictor {config['model']!r} is not ported (Stateless only)")
    return StatelessPredictor(from_dict(StatelessPredictorConfig,
                                        config.get("config", {})))


class RnntModel(nn.Module):
    """Encoder + predictor + joiner in one module tree, whose state_dict
    is what speech2text_torch/convert.py produces from a flax tree."""

    def __init__(self, encoder: nn.Module, predictor: nn.Module,
                 joiner: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.predictor = predictor
        self.joiner = joiner

    @classmethod
    def from_config(cls, train_config: Dict[str, Any]) -> "RnntModel":
        """From a training config's encoder/decoder/predictor/joiner
        sections; the decoder head must be Identity (it has no weights)."""
        dec = (train_config.get("decoder") or {}).get("model", "Identity")
        if dec != "Identity":
            raise NotImplementedError(f"decoder {dec!r} is not ported")
        return cls(build_encoder(train_config["encoder"]),
                   build_predictor(train_config["predictor"]),
                   Joiner(from_dict(JoinerConfig, train_config["joiner"])))

    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        return self.encoder(feats, feat_lens)

    def predictor_step(self, token: torch.Tensor, state: torch.Tensor):
        return self.predictor.streaming_step(token, state)

    def joiner_step(self, enc_frame: torch.Tensor, pred_out: torch.Tensor):
        return self.joiner.streaming_step(enc_frame, pred_out)
