"""Transducer model assembly and the transducer tasks (port of
speech2text_tpu/tasks/rnnt.py): `RnntModel` (encoder + decoder head +
predictor + joiner, built by models/factories.py: a Zipformer2 or a
Conformer encoder, an Identity or Projector head, a Stateless or LSTM
predictor) with its training forward and the predictor and joiner steps
decoding needs, the random chunk choice of chunked-causal training
(`sample_chunk`), the loss combination of each task (`PrunedRnntLossFn`:
the pruned RNN-T loss with its optional CTC branch on the head's logits;
`RnntLossFn`: the full-lattice RNN-T loss; `HybridRnntLossFn`: the
full-lattice loss plus the CTC loss of the Projector head, weighted;
`loss_fn_of` picks one for a YAML), the training losses of a step
(`train_losses`, at the global step the Zipformer2's training dynamics
read) and the tasks `PrunedRnntTask`, `RnntTask` and
`CtcHybridRnntTask`, which share `TransducerTask`: the loss of its YAML
(taken in training by train/step.py:take_step), the evaluation forward
with the validation losses of the task's loss (or, with
`metric.encoder_streaming`, the chunk-masked encoder alone: simulated
streaming; a Conformer runs unmasked, as in JAX), and hypotheses as text
from the transducer decoder the `metric` section names
(decoding.py:build_decoding: greedy, or beam search with an optional
RNN-LM from `metric.lm_fusion`, `load_fusion_lm`); the hybrid task
decodes with the transducer too, as JAX's does. With `metric.int8` the
predictor and joiner decode int8-quantized (quant.py, `Int8Decoding`),
as in JAX without the fusion LM; a CTC decode method raises
NotImplementedError."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import from_dict
from ..convert import to_flax
from ..decoding import build_decoding, ids_to_texts
from ..losses import Loss
from ..models.factories import (DecoderFactory, EncoderFactory,
                                PredictorFactory)
from ..models.joiner import Joiner, JoinerConfig
from ..models.layers import init_parameters
from ..models.rnn_lm import RnnLm, RnnLmConfig
from ..models.zipformer import Zipformer2
from ..quant import Int8RnntBeamDecoding, Int8RnntGreedyDecoding
from ..train.checkpoint import average_checkpoints
from ..utils.tracing import span
from .base import AsrTaskBase, Batch


class RnntModel(nn.Module):
    """Encoder + decoder head + predictor + joiner in one module tree,
    whose state_dict is what speech2text_torch/convert.py produces from a
    flax tree (an Identity head has no weights, and the tree no
    `decoder`)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 predictor: nn.Module, joiner: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.predictor = predictor
        self.joiner = joiner

    @classmethod
    def from_config(cls, train_config: Dict[str, Any]) -> "RnntModel":
        """From a training config's encoder/decoder/predictor/joiner
        sections (no `decoder` section: Identity)."""
        return cls(EncoderFactory(train_config["encoder"]),
                   DecoderFactory(train_config.get("decoder")
                                  or {"model": "Identity"}),
                   PredictorFactory(train_config["predictor"]),
                   Joiner(from_dict(JoinerConfig, train_config["joiner"])))

    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                labels: torch.Tensor, label_lens: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                chunk_size: int = -1, left_context_chunks: int = -1,
                step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The training forward (RnntModel.__call__): encoder → decoder
        head, and encoder → predictor → joiner; `training` turns on the
        encoder's dropout and feature mask and the head's dropout, drawn
        from `generator`, and a Zipformer2's training dynamics at the
        global `step`. A Conformer takes no chunk and no step."""
        kw = {"step": step} if isinstance(self.encoder, Zipformer2) else {}
        with span("encoder"):
            enc, enc_lens = self.encoder(feats, feat_lens, chunk_size,
                                         left_context_chunks,
                                         training=training,
                                         generator=generator, **kw)
            dec, dec_lens = self.decoder(enc, enc_lens, training=training,
                                         generator=generator)
        with span("joiner_losses"):
            pred = self.predictor(labels)
            logits, ranges, simple_loss = self.joiner(enc, enc_lens, pred,
                                                      label_lens, labels)
        return {"enc": enc, "enc_lens": enc_lens, "dec": dec,
                "dec_lens": dec_lens, "logits": logits, "ranges": ranges,
                "simple_loss": simple_loss}

    def predictor_step(self, token: torch.Tensor, state: torch.Tensor):
        return self.predictor.streaming_step(token, state)

    def joiner_step(self, enc_frame: torch.Tensor, pred_out: torch.Tensor):
        return self.joiner.streaming_step(enc_frame, pred_out)


def sample_chunk(config: Any,
                 generator: torch.Generator) -> Tuple[int, int]:
    """Random chunked-causal training (tasks/rnnt.py:_sample_chunk): a
    (chunk_size, left_context_chunks) pair drawn from the encoder config's
    `chunk_size` and `left_context_frames` lists; (-1, -1), full
    attention, with nothing drawn, for a non-causal encoder (a Conformer's
    config has no `causal`) or the list [-1]. `generator` is a CPU
    generator: the choice is made on the host."""
    if not getattr(config, "causal", False):
        return -1, -1
    chunks = list(config.chunk_size or [-1])
    lefts = list(config.left_context_frames or [-1])
    if chunks == [-1]:
        return -1, -1
    cs = int(chunks[int(torch.randint(len(chunks), (), generator=generator))])
    lf = int(lefts[int(torch.randint(len(lefts), (), generator=generator))])
    lc = max(lf // max(cs, 1), 1) if lf > 0 and cs > 0 else -1
    return cs, lc


class PrunedRnntLossFn:
    """PrunedRnntTask.loss_fn's combination (tasks/rnnt.py:329-372):
    simple_scale · simple + pruned_scale · pruned, plus, with
    `enable_ctc`, ctc_weight (default 0.3) · the CTC loss (`ctc_config`)
    of the decoder head's logits; the scales from the YAML `loss`
    section."""

    def __init__(self, loss_config: Dict[str, Any]):
        self.simple_scale = float(loss_config.get("simple_loss_scale", 0.5))
        self.pruned_scale = float(loss_config.get("pruned_loss_scale", 0.5))
        self.pruned_loss = Loss({"model": "Pruned_Rnnt",
                                 "config": loss_config.get("config", {})})
        self.enable_ctc = bool(loss_config.get("enable_ctc", False))
        if self.enable_ctc:
            self.ctc_weight = float(loss_config.get("ctc_weight", 0.3))
            self.ctc_loss = Loss({"model": "CTC", "config":
                                  loss_config.get("ctc_config", {})})

    def __call__(self, out: Dict[str, torch.Tensor], labels: torch.Tensor,
                 label_lens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{"loss", "simple_loss", "pruned_loss"} and, with the CTC
        branch, "ctc_loss"."""
        pruned = self.pruned_loss({"logits": out["logits"],
                                   "ranges": out["ranges"],
                                   "logits_length": out["enc_lens"],
                                   "label": labels,
                                   "label_length": label_lens})
        simple = out["simple_loss"]
        losses = {"loss": self.simple_scale * simple
                  + self.pruned_scale * pruned,
                  "simple_loss": simple, "pruned_loss": pruned}
        if self.enable_ctc:
            with span("ctc_loss"):
                ctc = self.ctc_loss({"logits": out["dec"],
                                     "logits_length": out["dec_lens"],
                                     "label": labels,
                                     "label_length": label_lens})
            losses["loss"] = losses["loss"] + self.ctc_weight * ctc
            losses["ctc_loss"] = ctc
        return losses


class RnntLossFn:
    """RnntTask.loss_fn (tasks/rnnt.py:259-265): the `Rnnt` loss of the
    YAML's `loss` section on the joiner's full (B, T, U+1, V) logits;
    {"loss"}."""

    def __init__(self, loss_config: Dict[str, Any]):
        self.loss = Loss(loss_config)

    def __call__(self, out: Dict[str, torch.Tensor], labels: torch.Tensor,
                 label_lens: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("rnnt_loss"):
            return {"loss": self.loss({"logits": out["logits"],
                                       "logits_length": out["enc_lens"],
                                       "label": labels,
                                       "label_length": label_lens})}


class HybridRnntLossFn:
    """CtcHybridRnntTask.loss_fn (tasks/rnnt.py:289-301): rnnt_weight
    (default 0.5) · the full-lattice RNN-T loss (`rnnt_config`) +
    ctc_weight (default 0.5) · the CTC loss (`ctc_config`) of the
    decoder head's logits; {"loss", "rnnt_loss", "ctc_loss"}."""

    def __init__(self, loss_config: Dict[str, Any]):
        self.rnnt_weight = float(loss_config.get("rnnt_weight", 0.5))
        self.ctc_weight = float(loss_config.get("ctc_weight", 0.5))
        self.rnnt_loss = RnntLossFn({"model": "Rnnt", "config":
                                     loss_config.get("rnnt_config", {})})
        self.ctc_loss = Loss({"model": "CTC", "config":
                              loss_config.get("ctc_config", {})})

    def __call__(self, out: Dict[str, torch.Tensor], labels: torch.Tensor,
                 label_lens: torch.Tensor) -> Dict[str, torch.Tensor]:
        rnnt = self.rnnt_loss(out, labels, label_lens)["loss"]
        with span("ctc_loss"):
            ctc = self.ctc_loss({"logits": out["dec"],
                                 "logits_length": out["dec_lens"],
                                 "label": labels,
                                 "label_length": label_lens})
        return {"loss": self.rnnt_weight * rnnt + self.ctc_weight * ctc,
                "rnnt_loss": rnnt, "ctc_loss": ctc}


LOSS_FNS = {"Pruned_Rnnt": PrunedRnntLossFn, "Rnnt": RnntLossFn,
            "CTC_Hybrid_Rnnt": HybridRnntLossFn}


def loss_fn_of(task: str, config: Dict[str, Any]):
    """The loss combination of the transducer task type `task` for the
    training config `config`; the pruned task needs `joiner.prune_range`
    > 0, the others ≤ 0 (ValueError otherwise)."""
    if task not in LOSS_FNS:
        raise NotImplementedError(f"task {task!r} is not a transducer task "
                                  f"of the port ({', '.join(LOSS_FNS)})")
    pruned = config["joiner"].get("prune_range", -1) > 0
    if pruned != (task == "Pruned_Rnnt"):
        raise ValueError(f"task {task} requires joiner.prune_range "
                         f"{'> 0' if task == 'Pruned_Rnnt' else '<= 0'}")
    return LOSS_FNS[task](config["loss"])


def train_losses(model: RnntModel, loss_fn, feats: torch.Tensor,
                 feat_lens: torch.Tensor, labels: torch.Tensor,
                 label_lens: torch.Tensor, chunk: Tuple[int, int],
                 generator: Optional[torch.Generator],
                 step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The training forward with the chunk `chunk` = (chunk_size,
    left_context_chunks), dropout and feature masks from `generator` and
    the global `step`, then `loss_fn`: its losses and "frames", the
    encoder's output frames (JAX's metric)."""
    cs, lc = chunk
    out = model(feats, feat_lens, labels, label_lens, training=True,
                generator=generator, chunk_size=cs, left_context_chunks=lc,
                step=step)
    with span("joiner_losses"):
        losses = loss_fn(out, labels, label_lens)
    losses["frames"] = out["enc_lens"].sum()
    return losses


def load_fusion_lm(metric: Dict[str, Any], num_symbols: int,
                   vocab: int) -> Tuple[Optional[RnnLm], float]:
    """The shallow-fusion LM of `metric.lm_fusion` (tasks/rnnt.py:
    BaseRnntTask): an `RnnLm` of `lm_config` (`num_symbols` defaults to
    `num_symbols`) with the average of the best `best_k` (default 1)
    checkpoints of `checkpoint_dir` by `monitor` (default `acc`) and
    `mode` (default `max`), and `lm_weight` (default 0.3); (None, 0.0)
    without a `checkpoint_dir`. An LM of fewer symbols than the joiner's
    `vocab` raises."""
    fusion = metric.get("lm_fusion") or {}
    if not fusion.get("checkpoint_dir"):
        return None, 0.0
    lm_cfg = dict(fusion.get("lm_config") or {})
    lm_cfg.setdefault("num_symbols", num_symbols)
    lm = RnnLm(from_dict(RnnLmConfig, lm_cfg))
    if lm.config.num_symbols < vocab:
        raise ValueError(f"the fusion LM's {lm.config.num_symbols} symbols "
                         f"do not cover the joiner's {vocab}")
    lm.load_state_dict(average_checkpoints(
        fusion["checkpoint_dir"], best_k=int(fusion.get("best_k", 1)),
        monitor=fusion.get("monitor", "acc"),
        mode=fusion.get("mode", "max")))
    return lm.eval(), float(fusion.get("lm_weight", 0.3))


def decoding_of(metric: Dict[str, Any], model: RnntModel,
                lm: Optional[RnnLm], lm_weight: float):
    """`build_decoding` over `model`'s predictor and joiner steps and the
    fusion LM's, if any."""
    return build_decoding(
        metric, model.predictor_step, model.predictor.init_state,
        model.joiner_step,
        lm_step=None if lm is None else lm.score_step,
        lm_init_state=None if lm is None else lm.init_state,
        lm_weight=lm_weight)


class Int8Decoding:
    """The int8 decoder of `metric.int8` (tasks/rnnt.py:118-125, 218-241
    of the JAX package): greedy with `max_token_step`, or beam with
    `beam_size` and `cutoff_top_k`, over the int8 predictor and joiner
    (quant.py) of `model`'s weights, leaves under `int8_min_size`
    (default 1024) elements kept f32; no fusion LM, as in JAX. The
    weights are quantized again whenever a predictor or joiner parameter
    has changed since the last decode (JAX quantizes once, at its first
    evaluation)."""

    def __init__(self, metric: Dict[str, Any], model: RnntModel):
        self.metric = metric
        self.model = model
        self._key = None
        self.session = None

    def _weights_key(self, device: torch.device):
        params = [*self.model.predictor.parameters(),
                  *self.model.joiner.parameters()]
        return device, tuple((p.data_ptr(), p._version) for p in params)

    def decoding(self, device: torch.device):
        """The int8 session for the current weights, on `device`."""
        key = self._weights_key(device)
        if key != self._key:
            m = self.metric
            tree = {"predictor": to_flax(self.model.predictor),
                    "joiner": to_flax(self.model.joiner)}
            common = dict(min_size=int(m.get("int8_min_size", 1024)),
                          device=device)
            args = (tree, self.model.predictor.config,
                    self.model.joiner.config)
            if m.get("decode_method") == "rnnt_beam_search":
                self.session = Int8RnntBeamDecoding(
                    *args, beam_size=int(m.get("beam_size", 4)),
                    cutoff_top_k=int(m.get("cutoff_top_k", 4)), **common)
            else:
                self.session = Int8RnntGreedyDecoding(
                    *args, max_token_step=int(m.get("max_token_step", 1)),
                    **common)
            self._key = key
        return self.session

    def decode(self, enc_out: torch.Tensor, enc_lens: torch.Tensor):
        return self.decoding(enc_out.device).decode(enc_out, enc_lens)


def streaming_chunks(metric: Dict[str, Any]) -> Tuple[int, int]:
    """(chunk_size, left_context_chunks) of the encoder's forward: the
    simulated-streaming chunks of `metric.encoder_streaming`
    (`streaming_chunk_size`, default 32; `streaming_left_chunks`, default
    4), else full context (-1, -1)."""
    if not metric.get("encoder_streaming"):
        return -1, -1
    return (int(metric.get("streaming_chunk_size", 32)),
            int(metric.get("streaming_left_chunks", 4)))


class TransducerTask(AsrTaskBase):
    """What the transducer tasks share (tasks/rnnt.py:BaseRnntTask):
    tokenizer, featurizer, model, the loss combination of the subclass's
    `task_type` (`loss_fn_of`) and decoding of one training YAML; the
    fusion LM, if any, is the submodule `lm`."""

    def __init__(self, config: Dict[str, Any]):
        loss = loss_fn_of(self.task_type, config)
        super().__init__(config)
        self.model = RnntModel.from_config(config)
        out_dim = self.model.joiner.config.output_dim
        if len(self.tokenizer) > out_dim:
            raise ValueError(f"the tokenizer has {len(self.tokenizer)} "
                             f"labels, the joiner only {out_dim} outputs")
        self.loss = loss
        metric = config.get("metric") or {}
        method = metric.get("decode_method", "rnnt_greedy_search")
        if method.startswith("ctc_"):
            raise NotImplementedError(f"decode method {method!r} on a "
                                      f"transducer task")
        self.streaming = streaming_chunks(metric)
        self.lm, lm_weight = load_fusion_lm(metric, len(self.tokenizer),
                                            out_dim)
        self.decode_session = Int8Decoding(metric, self.model) \
            if metric.get("int8") else \
            decoding_of(metric, self.model, self.lm, lm_weight)

    @torch.no_grad()
    def eval_forward(self, batch: Batch, losses: bool = True
                     ) -> Dict[str, torch.Tensor]:
        """The forward without augmentation or dropout: the encoder output
        for decoding and, unless `losses` is False, the validation losses
        of the full forward. With `metric.encoder_streaming` the encoder
        runs chunk-masked and alone (no losses), as in JAX."""
        feats, feat_lens = self.featurize(batch, training=False)
        if self.streaming != (-1, -1) or not losses:
            enc, enc_lens = self.model.encoder(feats, feat_lens,
                                               *self.streaming)
            return {"enc": enc, "enc_lens": enc_lens}
        out = self.model(feats, feat_lens, batch["label"],
                         batch["label_length"])
        return {"enc": out["enc"], "enc_lens": out["enc_lens"],
                **self.eval_loss_metrics(out, batch)}

    def train_losses(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                     batch: Batch, generator: Optional[torch.Generator],
                     chunk_generator: torch.Generator,
                     step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """A training step's losses (`train_losses`) at the global `step`
        with the chunk drawn from `chunk_generator` (a CPU generator)."""
        chunk = sample_chunk(self.model.encoder.config, chunk_generator)
        return train_losses(self.model, self.loss, feats, feat_lens,
                            batch["label"], batch["label_length"], chunk,
                            generator, step)

    def eval_loss_metrics(self, out: Dict[str, torch.Tensor], batch: Batch
                          ) -> Dict[str, torch.Tensor]:
        losses = self.loss(out, batch["label"], batch["label_length"])
        return {f"val_{k}": v for k, v in losses.items()}

    def eval_hyps(self, eval_out: Dict[str, torch.Tensor]) -> List[str]:
        tokens, counts = self.decode_session.decode(eval_out["enc"],
                                                    eval_out["enc_lens"])
        return ids_to_texts(tokens.cpu().numpy(), counts.cpu().numpy(),
                            self.tokenizer)


class PrunedRnntTask(TransducerTask):
    """The pruned RNN-T task (tasks/rnnt.py:PrunedRnntTask):
    `joiner.prune_range` > 0, `PrunedRnntLossFn`."""
    task_type = "Pruned_Rnnt"


class RnntTask(TransducerTask):
    """The full-lattice RNN-T task (tasks/rnnt.py:RnntTask):
    `joiner.prune_range` ≤ 0, `RnntLossFn`; validation `val_loss`."""
    task_type = "Rnnt"


class CtcHybridRnntTask(TransducerTask):
    """The CTC + RNN-T hybrid (tasks/rnnt.py:CtcHybridRnntTask):
    `joiner.prune_range` ≤ 0, `HybridRnntLossFn` with the CTC branch on
    the Projector head; validation `val_loss`, `val_rnnt_loss`,
    `val_ctc_loss`; decoding by the transducer."""
    task_type = "CTC_Hybrid_Rnnt"
