"""Subword-model training preprocess (the port's copy of
speech2text_tpu/tools/spm_train.py): build a text corpus from the train
manifest, train a unigram subword model into `<export>/<name>/spm/`, and
rewrite the tokenizer config to point at it. Skipped on resume or when
`apply_train` is false."""

from __future__ import annotations

import os
from typing import Any, Dict

from ..data.manifest import iter_text, load_manifest
from ..data.spm import train_unigram
from ..utils.logging import get_logger

log = get_logger(__name__)


def spm_training_preprocess(config: Dict[str, Any]) -> Dict[str, Any]:
    tok = config.get("tokenizer", {})
    if tok.get("type") != "subword" or not tok.get("apply_train"):
        return config
    if config.get("resume"):
        log.info("resume set; skipping spm training")
        return config
    export_dir = os.path.join(config["task"]["export_path"],
                              config["task"]["name"], "spm")
    os.makedirs(export_dir, exist_ok=True)
    model_path = os.path.join(export_dir, "tokenizer.model")
    vocab_path = os.path.join(export_dir, "tokenizer.vocab")
    train_cfg = tok.get("train_config", {}) or {}
    vocab_size = int(train_cfg.get("vocab_size", 128))
    entries = load_manifest(config["dataset"]["train_data"])
    log.info("training unigram subword model (vocab=%d) on %d utts",
             vocab_size, len(entries))
    model = train_unigram(iter_text(entries), vocab_size=vocab_size,
                          max_piece_len=int(train_cfg.get("max_piece_len",
                                                          8)))
    model.save(model_path, vocab_path)
    tok.setdefault("config", {})
    tok["config"]["spm_model"] = model_path
    tok["config"]["spm_vocab"] = vocab_path
    return config
