"""String-keyed model factories (port of
speech2text_tpu/models/factories.py): the encoder, decoder head and
predictor of a training config's `encoder`, `decoder` and `predictor`
sections ({"model": key, "config": {...}}).

Keys: encoders Conformer, Zipformer, Emformer and Wav2Vec2, decoders
Identity and Projector, the Stateless and Lstm predictors, as the JAX
package has them; an unknown key raises ValueError.
"""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from ..config import from_dict
from .conformer import Conformer, ConformerConfig
from .decoder import (IdentityDecoder, IdentityDecoderConfig,
                      ProjectorDecoder, ProjectorDecoderConfig)
from .emformer import Emformer, EmformerConfig
from .predictor import (LstmPredictor, LstmPredictorConfig,
                        StatelessPredictor, StatelessPredictorConfig)
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from .zipformer import Zipformer2, Zipformer2Config


def EncoderFactory(config: Dict[str, Any]) -> nn.Module:
    model, cfg = config["model"], config.get("config") or {}
    if model == "Conformer":
        return Conformer(from_dict(ConformerConfig, cfg))
    if model == "Zipformer":
        return Zipformer2(Zipformer2Config.from_config(cfg))
    if model == "Emformer":
        return Emformer(from_dict(EmformerConfig, cfg))
    if model == "Wav2Vec2":
        return Wav2Vec2Encoder(from_dict(Wav2Vec2Config, cfg))
    raise ValueError(f"unknown encoder {model}")


def DecoderFactory(config: Dict[str, Any]) -> nn.Module:
    model, cfg = config["model"], config.get("config") or {}
    if model == "Identity":
        return IdentityDecoder(from_dict(IdentityDecoderConfig, cfg))
    if model == "Projector":
        return ProjectorDecoder(from_dict(ProjectorDecoderConfig, cfg))
    raise ValueError(f"unknown decoder {model}")


def PredictorFactory(config: Dict[str, Any]) -> nn.Module:
    model, cfg = config["model"], config.get("config") or {}
    if model == "Stateless":
        return StatelessPredictor(from_dict(StatelessPredictorConfig, cfg))
    if model == "Lstm":
        return LstmPredictor(from_dict(LstmPredictorConfig, cfg))
    raise ValueError(f"unknown predictor {model}")
