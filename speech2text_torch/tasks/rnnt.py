"""Transducer model assembly and the pruned RNN-T task (port of
speech2text_tpu/tasks/rnnt.py): `RnntModel` (encoder + predictor +
joiner) with its training forward and the three calls greedy decoding
needs, the random chunk choice of chunked-causal training
(`sample_chunk`), the pruned RNN-T task loss (`PrunedRnntLossFn`) and
`PrunedRnntTask`: the loss of its YAML (`loss`, taken in training by
train/step.py:take_step), the evaluation forward with validation losses,
and greedy hypotheses as text. The int8,
beam-search and simulated-streaming evaluation branches raise
NotImplementedError."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ..config import from_dict
from ..decoding import RnntGreedyDecoding, ids_to_texts
from ..losses import Loss
from ..models.joiner import Joiner, JoinerConfig
from ..models.layers import init_parameters
from ..models.predictor import StatelessPredictor, StatelessPredictorConfig
from ..models.zipformer import Zipformer2, Zipformer2Config
from .base import AsrTaskBase, Batch


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

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                labels: torch.Tensor, label_lens: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                chunk_size: int = -1, left_context_chunks: int = -1
                ) -> Dict[str, torch.Tensor]:
        """The training forward (RnntModel.__call__): encoder →
        predictor → joiner; `training` turns on the encoder's dropout and
        feature mask, drawn from `generator`."""
        with record_function("encoder"):
            enc, enc_lens = self.encoder(feats, feat_lens, chunk_size,
                                         left_context_chunks,
                                         training=training,
                                         generator=generator)
        with record_function("joiner_losses"):
            pred = self.predictor(labels)
            logits, ranges, simple_loss = self.joiner(enc, enc_lens, pred,
                                                      label_lens, labels)
        return {"enc": enc, "enc_lens": enc_lens, "logits": logits,
                "ranges": ranges, "simple_loss": simple_loss}

    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        return self.encoder(feats, feat_lens)

    def predictor_step(self, token: torch.Tensor, state: torch.Tensor):
        return self.predictor.streaming_step(token, state)

    def joiner_step(self, enc_frame: torch.Tensor, pred_out: torch.Tensor):
        return self.joiner.streaming_step(enc_frame, pred_out)


def sample_chunk(config: Zipformer2Config,
                 generator: torch.Generator) -> Tuple[int, int]:
    """Random chunked-causal training (tasks/rnnt.py:_sample_chunk): a
    (chunk_size, left_context_chunks) pair drawn from the encoder config's
    `chunk_size` and `left_context_frames` lists; (-1, -1), full
    attention, for a non-causal encoder or the list [-1]. `generator` is
    a CPU generator: the choice is made on the host."""
    chunks = list(config.chunk_size or [-1])
    lefts = list(config.left_context_frames or [-1])
    if not config.causal or chunks == [-1]:
        return -1, -1
    cs = int(chunks[int(torch.randint(len(chunks), (), generator=generator))])
    lf = int(lefts[int(torch.randint(len(lefts), (), generator=generator))])
    lc = max(lf // max(cs, 1), 1) if lf > 0 and cs > 0 else -1
    return cs, lc


class PrunedRnntLossFn:
    """PrunedRnntTask.loss_fn's combination (tasks/rnnt.py:335-354):
    simple_scale · simple + pruned_scale · pruned, the scales from the
    YAML `loss` section. The auxiliary CTC branch is not ported."""

    def __init__(self, loss_config: Dict[str, Any]):
        self.simple_scale = float(loss_config.get("simple_loss_scale", 0.5))
        self.pruned_scale = float(loss_config.get("pruned_loss_scale", 0.5))
        if loss_config.get("enable_ctc", False):
            raise NotImplementedError("the pruned task's CTC branch "
                                      "(enable_ctc) is not ported")
        self.pruned_loss = Loss({"model": "Pruned_Rnnt",
                                 "config": loss_config.get("config", {})})

    def __call__(self, out: Dict[str, torch.Tensor], labels: torch.Tensor,
                 label_lens: torch.Tensor) -> Dict[str, torch.Tensor]:
        pruned = self.pruned_loss({"logits": out["logits"],
                                   "ranges": out["ranges"],
                                   "logits_length": out["enc_lens"],
                                   "label": labels,
                                   "label_length": label_lens})
        simple = out["simple_loss"]
        return {"loss": self.simple_scale * simple
                + self.pruned_scale * pruned,
                "simple_loss": simple, "pruned_loss": pruned}


class PrunedRnntTask(AsrTaskBase):
    """The pruned RNN-T task (tasks/rnnt.py:PrunedRnntTask): tokenizer,
    featurizer, model, loss and greedy decoding of one training YAML."""

    def __init__(self, config: Dict[str, Any]):
        if config["joiner"].get("prune_range", -1) <= 0:
            raise ValueError("PrunedRnntTask requires joiner.prune_range > 0")
        super().__init__(config)
        self.model = RnntModel.from_config(config)
        out_dim = self.model.joiner.config.output_dim
        if len(self.tokenizer) > out_dim:
            raise ValueError(f"the tokenizer has {len(self.tokenizer)} "
                             f"labels, the joiner only {out_dim} outputs")
        self.loss = PrunedRnntLossFn(config["loss"])
        metric_cfg = config.get("metric") or {}
        method = metric_cfg.get("decode_method", "rnnt_greedy_search")
        if method != "rnnt_greedy_search":
            raise NotImplementedError(f"decode method {method!r} is not "
                                      f"ported (rnnt_greedy_search only)")
        for key in ("int8", "encoder_streaming", "lm_fusion"):
            if metric_cfg.get(key):
                raise NotImplementedError(f"metric.{key} is not ported")
        self.decode_session = RnntGreedyDecoding(
            self.model.predictor_step, self.model.predictor.init_state,
            self.model.joiner_step,
            max_token_step=int(metric_cfg.get("max_token_step", 1)))

    @torch.no_grad()
    def eval_forward(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The full forward without augmentation, dropout or chunking:
        the encoder output for decoding and the validation losses."""
        feats, feat_lens = self.featurize(batch, training=False)
        out = self.model(feats, feat_lens, batch["label"],
                         batch["label_length"])
        return {"enc": out["enc"], "enc_lens": out["enc_lens"],
                **self.eval_loss_metrics(out, batch)}

    def eval_loss_metrics(self, out: Dict[str, torch.Tensor], batch: Batch
                          ) -> Dict[str, torch.Tensor]:
        losses = self.loss(out, batch["label"], batch["label_length"])
        return {"val_simple_loss": losses["simple_loss"],
                "val_pruned_loss": losses["pruned_loss"],
                "val_loss": losses["loss"]}

    def eval_hyps(self, eval_out: Dict[str, torch.Tensor]) -> List[str]:
        tokens, counts = self.decode_session.decode(eval_out["enc"],
                                                    eval_out["enc_lens"])
        return ids_to_texts(tokens.cpu().numpy(), counts.cpu().numpy(),
                            self.tokenizer)
