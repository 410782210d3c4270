"""The CTC task (port of speech2text_tpu/tasks/ctc.py): `CtcModel`
(encoder → decoder head, built by models/factories.py) and `CtcTask`:
the CTC loss of its YAML on the head's logits, the training losses of a
step (`train_losses`, taken by train/step.py:take_step), the evaluation
forward (`val_loss`, log-probabilities and output lengths) and
hypotheses as text from the decoder the `metric` section names
(decoding.py:build_decoding: `ctc_greedy_search`, the default,
`ctc_prefix_beam_search` with `beam_size` and `cand_size`, or
`ctc_lexicon_beam_search`, the C++ runtime's lexicon beam with an
optional ARPA LM, which returns texts)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..decoding import build_decoding, ids_to_texts
from ..losses import Loss
from ..models.factories import DecoderFactory, EncoderFactory
from ..models.layers import init_parameters
from .base import AsrTaskBase, Batch


class CtcModel(nn.Module):
    """Encoder + decoder head in one module tree, whose state_dict is what
    speech2text_torch/convert.py produces from a flax CtcModel tree."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    @classmethod
    def from_config(cls, train_config: Dict[str, Any]) -> "CtcModel":
        return cls(EncoderFactory(train_config["encoder"]),
                   DecoderFactory(train_config["decoder"]))

    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats → (logits (B, T', V) f32, output lengths); `training`
        turns on dropout, drawn from `generator`."""
        enc, lens = self.encoder(feats, feat_lens, training=training,
                                 generator=generator)
        return self.decoder(enc, lens, training=training,
                            generator=generator)


class CtcTask(AsrTaskBase):
    task_type = "CTC"

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.model = CtcModel.from_config(config)
        classes = getattr(self.model.decoder.config, "num_classes", None)
        if classes is not None and len(self.tokenizer) > classes:
            raise ValueError(f"the tokenizer has {len(self.tokenizer)} "
                             f"labels, the decoder head only {classes}")
        self.loss = Loss(config["loss"])
        metric = dict(config.get("metric") or {})
        metric.setdefault("decode_method", "ctc_greedy_search")
        method = metric["decode_method"]
        if not method.startswith("ctc_"):
            raise NotImplementedError(f"decode method {method!r} on a CTC "
                                      f"task")
        self.decode_session = build_decoding(metric, tokenizer=self.tokenizer)
        self.decodes_text = method == "ctc_lexicon_beam_search"

    def _loss(self, logits: torch.Tensor, out_lens: torch.Tensor,
              batch: Batch) -> torch.Tensor:
        return self.loss({"logits": logits, "logits_length": out_lens,
                          "label": batch["label"],
                          "label_length": batch["label_length"]})

    def train_losses(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                     batch: Batch, generator: Optional[torch.Generator],
                     chunk_generator: Optional[torch.Generator] = None,
                     step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """A training step's {"loss", "frames"} (the input frames, JAX's
        metric), dropout drawn from `generator`; a CTC task takes no
        chunk and no step (its encoders have no training dynamics)."""
        logits, out_lens = self.model(feats, feat_lens, training=True,
                                      generator=generator)
        return {"loss": self._loss(logits, out_lens, batch),
                "frames": feat_lens.sum()}

    @torch.no_grad()
    def eval_forward(self, batch: Batch, losses: bool = True
                     ) -> Dict[str, torch.Tensor]:
        """The forward without augmentation or dropout: log-probabilities
        and output lengths for decoding and, unless `losses` is False,
        `val_loss`."""
        feats, feat_lens = self.featurize(batch, training=False)
        logits, out_lens = self.model(feats, feat_lens)
        out = {"log_probs": self.loss.predict(logits), "out_lens": out_lens}
        if losses:
            out["val_loss"] = self._loss(logits, out_lens, batch)
        return out

    def eval_hyps(self, eval_out: Dict[str, torch.Tensor]) -> List[str]:
        out = self.decode_session.decode(eval_out["log_probs"],
                                         eval_out["out_lens"])
        if self.decodes_text:
            return out
        tokens, counts = out
        return ids_to_texts(tokens.cpu().numpy(), counts.cpu().numpy(),
                            self.tokenizer)
