"""The SSL task: BEST-RQ masked-prediction pretraining (port of
speech2text_tpu/tasks/ssl.py).

`SslModel` is the encoder and `logits_layer`, a Dense to
num_codebooks · codebook_size, read as (n, B, T, K) logits. A training
step (`step_losses`) featurizes the PCM batch twice: the raw view (no
augmentation) gives the labels (models/best_rq.py), the augmented view,
masked by span masks with noise, is the encoder's input. The encoder's
output and the labels are cut to their common length T2; the loss is the
mean over codebooks of the masked CE of the YAML's `loss` on the masked
valid frames (`loss_selection: mask_loss`) or on every valid frame;
`acc` is the mean top-k accuracy over the same frames (`metric.top_k`)
and `mask_rate` the share of valid frames masked.

Evaluation masks the raw view. The JAX package draws that mask from
`PRNGKey(0)` on every batch; the port cannot reproduce that draw and
takes it from its own generator seeded 0 on every batch (ROADMAP §C,
reference caveat 7). A checkpoint's encoder tensors carry over by name to
a CTC task through `finetune.base_model` (build_task.py); `logits_layer`
does not.

The step's phases are spans (utils/tracing.py): "featurize" twice (the
raw and the augmented view, tasks/base.py), "ssl_targets" (the labels,
the span mask and the noise), "encoder" (inside it one "mhsa" per
Conformer block), "ssl_head" twice (the logits layer, then the masked
CE and the accuracy), then the training step's "backward" and
"optimizer" (train/step.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import from_dict
from ..losses import Loss
from ..metrics import masked_topk_accuracy
from ..models.best_rq import BestRQConfig, BestRQLayer, Draws, \
    MaskingStrategyConfig
from ..models.factories import EncoderFactory
from ..models.layers import Dense, init_parameters
from ..parallel import global_count
from ..utils.tracing import span
from .base import AsrTaskBase, Batch

EVAL_MASK_SEED = 0


class SslModel(nn.Module):

    def __init__(self, encoder: nn.Module, output_dim: int,
                 num_codebooks: int, codebook_size: int):
        super().__init__()
        self.encoder = encoder
        self.num_codebooks = num_codebooks
        self.codebook_size = codebook_size
        self.logits_layer = Dense(output_dim, num_codebooks * codebook_size)

    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def logits(self, enc: torch.Tensor) -> torch.Tensor:
        """Encoder output (B, T', D) → logits (n, B, T', K) f32."""
        logits = self.logits_layer(enc).float()
        B, T, _ = logits.shape
        return logits.reshape(B, T, self.num_codebooks,
                              self.codebook_size).permute(2, 0, 1, 3)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats → (logits (n, B, T', K) f32, output lengths)."""
        with span("encoder"):
            enc, enc_lens = self.encoder(feats, feat_lens, training=training,
                                         generator=generator)
        with span("ssl_head"):
            return self.logits(enc), enc_lens


class SslTask(AsrTaskBase):
    task_type = "SSL"

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        brq = dict((config.get("ssl") or {}).get("best_rq") or {})
        masking = from_dict(MaskingStrategyConfig, brq.pop("masking", None)
                            or {})
        brq.setdefault("feature_dim", self.frontend.feat_dim)
        brq_cfg = from_dict(BestRQConfig, {**brq, "masking": {}})
        brq_cfg.masking = masking
        self.best_rq = BestRQLayer(brq_cfg)
        encoder = EncoderFactory(config["encoder"])
        self.model = SslModel(encoder, encoder.config.output_dim,
                              brq_cfg.num_codebooks, brq_cfg.codebook_size)
        loss_cfg = dict(config["loss"])
        self.loss_selection = loss_cfg.pop("loss_selection", "mask_loss")
        self.loss = Loss(loss_cfg)
        self.topk = int((config.get("metric") or {}).get("top_k", 1))

    def losses(self, logits: torch.Tensor, enc_lens: torch.Tensor,
               labels: torch.Tensor, mask2: torch.Tensor,
               lens2: torch.Tensor, mask_loss: bool
               ) -> Dict[str, torch.Tensor]:
        """The per-codebook losses and accuracies over the common length
        T2: {"loss", "acc", "mask_rate"}."""
        T2 = min(logits.shape[2], labels.shape[2])
        if logits.shape[2] > T2:      # a slice's backward fills a zero copy
            logits = logits[:, :, :T2]
        labels, mask2 = labels[:, :, :T2], mask2[:, :T2]
        valid = torch.arange(T2, device=logits.device)[None, :] < \
            torch.minimum(lens2, enc_lens)[:, None]
        sel = mask2 & valid if mask_loss else valid
        # unbind: one backward stack of the codebooks' gradients, not a
        # zero-filled full-size gradient per codebook
        pairs = list(zip(logits.unbind(0), labels.unbind(0)))
        losses = [self.loss({"logits": lg, "label": lb, "mask": sel})
                  for lg, lb in pairs]
        with torch.no_grad():
            accs = [masked_topk_accuracy(lg, lb, sel, k=self.topk)
                    for lg, lb in pairs]
            mask_rate = (mask2 & valid).sum() / global_count(valid.sum(), 1)
        return {"loss": torch.stack(losses).mean(),
                "acc": torch.stack(accs).mean(), "mask_rate": mask_rate}

    def masked_inputs(self, batch: Batch,
                      generator: Optional[torch.Generator],
                      draws: Optional[Dict[str, Any]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
        """The training step's two featurizes and the quantizer: (masked
        augmented features, feat_lens, labels, mask2, lens2). Augmentation,
        then the masking, drawn from `generator` in that order, unless
        `draws` gives them ({"augment": ..., "mask": ...})."""
        draws = draws or {}
        raw, feat_lens = self.featurize(batch, training=False)
        auged, _ = self.featurize(batch, generator, training=True,
                                  draws=draws.get("augment"))
        with span("ssl_targets"):
            masked, labels, mask2, lens2 = self.best_rq(
                raw, auged, feat_lens, generator, draws.get("mask"))
        return masked, feat_lens, labels, mask2, lens2

    def step_losses(self, batch: Batch, step: int,
                    generators: Tuple[torch.Generator, ...]
                    ) -> Callable[[], Dict[str, torch.Tensor]]:
        """The Trainer's step: the inputs from the augmentation generator,
        then `train_losses` with dropout from the dropout generator."""
        augment_gen, dropout_gen = generators[:2]
        inputs = self.masked_inputs(batch, augment_gen)
        return lambda: self.train_losses(*inputs, generator=dropout_gen)

    def train_losses(self, masked: torch.Tensor, feat_lens: torch.Tensor,
                     labels: torch.Tensor, mask2: torch.Tensor,
                     lens2: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        """{"loss", "acc", "mask_rate", "frames" (the encoder's output
        frames)} of the masked inputs, dropout drawn from `generator`."""
        logits, enc_lens = self.model(masked, feat_lens, training=True,
                                      generator=generator)
        with span("ssl_head"):
            out = self.losses(logits, enc_lens, labels, mask2, lens2,
                              self.loss_selection == "mask_loss")
        out["frames"] = enc_lens.sum()
        return out

    @torch.no_grad()
    def eval_forward(self, batch: Batch, draws: Optional[Draws] = None
                     ) -> Dict[str, torch.Tensor]:
        """`val_loss` and `acc` of the raw view masked with the masking
        of a generator seeded EVAL_MASK_SEED (or `draws`), on the masked
        valid frames."""
        raw, feat_lens = self.featurize(batch, training=False)
        gen = None
        if draws is None:
            gen = torch.Generator(raw.device).manual_seed(EVAL_MASK_SEED)
        with span("ssl_targets"):
            masked, labels, mask2, lens2 = self.best_rq(raw, raw, feat_lens,
                                                        gen, draws)
        logits, enc_lens = self.model(masked, feat_lens)
        out = self.losses(logits, enc_lens, labels, mask2, lens2, True)
        return {"val_loss": out["loss"], "acc": out["acc"]}

    def eval_hyps(self, eval_out: Dict[str, torch.Tensor]) -> List[str]:
        return []   # no transcripts: the Trainer keeps val_loss and acc
