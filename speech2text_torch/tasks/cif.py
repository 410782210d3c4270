"""The CIF task (port of speech2text_tpu/tasks/cif.py): non-autoregressive
decoding by continuous integrate-and-fire.

`CifModel` is the encoder → `CifLayer` (models/cif.py) → the decoder head
(a Projector) over the fired acoustic embeddings. `CifTask` trains it
with the masked cross-entropy of its YAML's `loss.ce_config` over the
first L = min(label pad, `cif.max_tokens`) positions (the mask is the
label lengths clamped to L) plus `mae_weight` times the normalized MAE of
the predicted token count Σα against U. Its evaluation runs a
teacher-forced pass (Σα rescaled to U) for `val_loss` and a free pass
(the tail fire) whose log-softmax and emitted counts
`decoding.CifGreedyDecoding` (`cif_greedy_search`) turns into text.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..config import from_dict
from ..decoding import build_decoding, ids_to_texts
from ..losses import Loss
from ..models.cif import CifConfig, CifLayer
from ..models.factories import DecoderFactory, EncoderFactory
from ..models.layers import init_parameters
from .base import AsrTaskBase, Batch


class CifModel(nn.Module):
    """Encoder + CIF + decoder head in one module tree, named as the flax
    CifModel's (`encoder`, `cif`, `decoder`)."""

    def __init__(self, encoder: nn.Module, cif: CifLayer,
                 decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.cif = cif
        self.decoder = decoder

    @classmethod
    def from_config(cls, train_config: Dict[str, Any]) -> "CifModel":
        section = train_config.get("cif") or {}
        return cls(EncoderFactory(train_config["encoder"]),
                   CifLayer(from_dict(CifConfig,
                                      section.get("config", section))),
                   DecoderFactory(train_config["decoder"]))

    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                target_lengths: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """{"logits" (B, u_cap, V) f32, "pred_counts" (B,), "emit_counts"
        (B,) int32, "enc_lens"}; `target_lengths` selects the training
        CIF (Σα = U), `training` turns on dropout, drawn from
        `generator`."""
        enc, enc_lens = self.encoder(feats, feat_lens, training=training,
                                     generator=generator)
        embeds, pred_counts, emit_counts = self.cif(enc, enc_lens,
                                                    target_lengths)
        logits, _ = self.decoder(embeds, emit_counts, training=training,
                                 generator=generator)
        return {"logits": logits, "pred_counts": pred_counts,
                "emit_counts": emit_counts, "enc_lens": enc_lens}


class CifTask(AsrTaskBase):
    task_type = "CIF"

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.model = CifModel.from_config(config)
        loss_cfg = config["loss"]
        self.mae_weight = float(loss_cfg.get("mae_weight", 1.0))
        self.mae_loss = Loss({"model": "MaeLoss",
                              "config": loss_cfg.get("mae_config") or {}})
        self.ce_loss = Loss({"model": "MaskedCELoss",
                             "config": loss_cfg.get("ce_config") or {}})
        self.decode_session = build_decoding(
            {"decode_method": "cif_greedy_search"})

    def ce(self, logits: torch.Tensor, batch: Batch) -> torch.Tensor:
        """The CE over the overlap of the label pad and the emission
        buffer, the mask clamped to it."""
        L = min(batch["label"].shape[1], logits.shape[1])
        return self.ce_loss({"logits": logits[:, :L],
                             "label": batch["label"][:, :L],
                             "mask": batch["label_length"].clamp(max=L)})

    def train_losses(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                     batch: Batch, generator: Optional[torch.Generator],
                     chunk_generator: Optional[torch.Generator] = None,
                     step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """A training step's {"loss", "ce_loss", "mae_loss", "frames" (the
        encoder's output frames)}, dropout drawn from `generator`; the
        task takes no chunk and no step."""
        out = self.model(feats, feat_lens, batch["label_length"],
                         training=True, generator=generator)
        ce = self.ce(out["logits"], batch)
        mae = self.mae_loss({"pred_token_counts": out["pred_counts"],
                             "true_token_counts": batch["label_length"]})
        return {"loss": ce + self.mae_weight * mae, "ce_loss": ce,
                "mae_loss": mae, "frames": out["enc_lens"].sum()}

    @torch.no_grad()
    def eval_forward(self, batch: Batch, losses: bool = True
                     ) -> Dict[str, torch.Tensor]:
        """The free pass's "log_probs" and "token_counts" and, unless
        `losses` is False, the teacher-forced pass's `val_loss`."""
        feats, feat_lens = self.featurize(batch, training=False)
        out = {}
        if losses:
            forced = self.model(feats, feat_lens, batch["label_length"])
            out["val_loss"] = self.ce(forced["logits"], batch)
        infer = self.model(feats, feat_lens)
        out["log_probs"] = torch.log_softmax(infer["logits"], dim=-1)
        out["token_counts"] = infer["emit_counts"]
        return out

    def eval_hyps(self, eval_out: Dict[str, torch.Tensor]) -> List[str]:
        tokens, counts = self.decode_session.decode(
            eval_out["log_probs"], eval_out["token_counts"])
        return ids_to_texts(tokens.cpu().numpy(), counts.cpu().numpy(),
                            self.tokenizer)
