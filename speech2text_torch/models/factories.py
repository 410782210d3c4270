"""String-keyed model factories (port of
speech2text_tpu/models/factories.py): the encoder, decoder head and
predictor of a training config's `encoder`, `decoder` and `predictor`
sections ({"model": key, "config": {...}}).

Ported keys: encoders Conformer and Zipformer, decoders Identity and
Projector, the Stateless and Lstm predictors. The JAX package's other
keys (encoders Emformer and Wav2Vec2) raise NotImplementedError; an
unknown key raises ValueError.
"""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from ..config import from_dict
from .conformer import Conformer, ConformerConfig
from .decoder import (IdentityDecoder, IdentityDecoderConfig,
                      ProjectorDecoder, ProjectorDecoderConfig)
from .predictor import (LstmPredictor, LstmPredictorConfig,
                        StatelessPredictor, StatelessPredictorConfig)
from .zipformer import Zipformer2, Zipformer2Config


def _unported(kind: str, model: str, known: tuple) -> None:
    if model in known:
        raise NotImplementedError(f"{kind} {model!r} is not ported")
    raise ValueError(f"unknown {kind} {model}")


def EncoderFactory(config: Dict[str, Any]) -> nn.Module:
    model, cfg = config["model"], config.get("config") or {}
    if model == "Conformer":
        return Conformer(from_dict(ConformerConfig, cfg))
    if model == "Zipformer":
        return Zipformer2(Zipformer2Config.from_config(cfg))
    _unported("encoder", model, ("Emformer", "Wav2Vec2"))


def DecoderFactory(config: Dict[str, Any]) -> nn.Module:
    model, cfg = config["model"], config.get("config") or {}
    if model == "Identity":
        return IdentityDecoder(from_dict(IdentityDecoderConfig, cfg))
    if model == "Projector":
        return ProjectorDecoder(from_dict(ProjectorDecoderConfig, cfg))
    _unported("decoder", model, ())


def PredictorFactory(config: Dict[str, Any]) -> nn.Module:
    model, cfg = config["model"], config.get("config") or {}
    if model == "Stateless":
        return StatelessPredictor(from_dict(StatelessPredictorConfig, cfg))
    if model == "Lstm":
        return LstmPredictor(from_dict(LstmPredictorConfig, cfg))
    _unported("predictor", model, ())
