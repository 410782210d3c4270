"""The NNLM task: the RNN language model that shallow fusion reads (port
of speech2text_tpu/tasks/nnlm.py).

Text only: the train and eval pipelines are data/dataset.py:LmPipeline
(<sos> tokens <eos> rows), the model is models/rnn_lm.py:RnnLm of the
YAML's `lm.config` (`num_symbols` defaults to the tokenizer's size). A
row is shifted for teacher forcing (input t[:-1], label t[1:], the mask
the row's length − 1); the loss is the YAML's (`MaskedKLDiv`), `acc` the
masked top-k accuracy (`metric.top_k`) and `frames` the count of masked
positions. There is no featurize and no transcript. The checkpoints
(top-k by `acc`) are what tasks/rnnt.py:load_fusion_lm reads.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn

from ..config import from_dict
from ..data.dataset import DataConfig, LmPipeline
from ..data.tokenizer import TokenizerSetup
from ..losses import Loss
from ..metrics import masked_topk_accuracy
from ..models.rnn_lm import RnnLm, RnnLmConfig

Batch = Dict[str, Any]


class NnLmTask(nn.Module):
    task_type = "NNLM"

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = config
        self.tokenizer = TokenizerSetup(config["tokenizer"])
        ds = dict(config.get("dataset") or {})
        self.data_config = from_dict(DataConfig, {
            k: v for k, v in ds.items()
            if k in DataConfig.__dataclass_fields__})
        lm_cfg = dict((config.get("lm") or {}).get("config") or {})
        lm_cfg.setdefault("num_symbols", len(self.tokenizer))
        self.model = RnnLm(from_dict(RnnLmConfig, lm_cfg))
        self.loss = Loss(config["loss"])
        self.topk = int((config.get("metric") or {}).get("top_k", 1))

    def init_weights(self, generator: torch.Generator) -> int:
        """The LM's seeded init; returns 0, the pretrained tensors merged."""
        self.model.init_weights(generator)
        return 0

    def make_train_pipeline(self, shard_index: int = 0, num_shards: int = 1,
                            seed: int = 17,
                            pin_memory: bool = False) -> LmPipeline:
        return LmPipeline(self.data_config.train_data, self.tokenizer,
                          batch_size=self.data_config.batch_size, seed=seed,
                          shard_index=shard_index, num_shards=num_shards,
                          training=True, pin_memory=pin_memory)

    def make_eval_pipeline(self, shard_index: int = 0, num_shards: int = 1,
                           pin_memory: bool = False) -> LmPipeline:
        return LmPipeline(self.data_config.eval_data, self.tokenizer,
                          batch_size=self.data_config.batch_size,
                          shard_index=shard_index, num_shards=num_shards,
                          training=False, pin_memory=pin_memory)

    @staticmethod
    def shift(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """(inputs, labels, mask) of the teacher-forced rows."""
        text = batch["text"].long()
        labels = text[:, 1:]
        mask = torch.arange(labels.shape[1], device=text.device)[None, :] \
            < (batch["text_length"][:, None] - 1)
        return text[:, :-1], labels, mask

    def train_losses(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """{"loss", "acc", "frames" (the masked positions)}."""
        inputs, labels, mask = self.shift(batch)
        logits = self.model(inputs)
        loss = self.loss({"logits": logits, "label": labels, "mask": mask})
        with torch.no_grad():
            acc = masked_topk_accuracy(logits, labels, mask, k=self.topk)
        return {"loss": loss, "acc": acc, "frames": mask.sum()}

    def step_losses(self, batch: Batch, step: int,
                    generators: Tuple[torch.Generator, ...]
                    ) -> Callable[[], Dict[str, torch.Tensor]]:
        """The Trainer's step: no featurize and no random draw."""
        return lambda: self.train_losses(batch)

    @torch.no_grad()
    def eval_forward(self, batch: Batch) -> Dict[str, torch.Tensor]:
        out = self.train_losses(batch)
        return {"val_loss": out["loss"], "acc": out["acc"]}

    def eval_hyps(self, eval_out: Dict[str, torch.Tensor]) -> List[str]:
        return []   # no transcripts: the Trainer keeps val_loss and acc
