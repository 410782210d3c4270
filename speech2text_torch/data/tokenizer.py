"""Tokenizers: char-based and subword (unigram), numpy-native (the port's
copy of speech2text_tpu/data/tokenizer.py).

  - CharTokenizer labels = ["<blank_id>", "<unk>"] + chars + ["<sos/eos>"]
  - SubwordTokenizer labels = ["<blank_id>"] + spm vocab (minus <s>, </s>,
    keeping <unk>) + ["<sos/eos>"]; blank is always id 0
  - encode → int32 id vector; decode drops nothing (caller strips blanks)
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .spm import UnigramModel

BLANK = "<blank_id>"
UNK = "<unk>"
SOS_EOS = "<sos/eos>"


class Tokenizer(abc.ABC):
    """Abstract tokenizer: ids are indices into `labels`."""

    @property
    @abc.abstractmethod
    def labels(self) -> List[str]:
        ...

    @abc.abstractmethod
    def encode_as_tokens(self, text: str) -> List[str]:
        ...

    @abc.abstractmethod
    def decode_from_tokens(self, tokens: Sequence[str]) -> str:
        ...

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def blank_id(self) -> int:
        return 0

    @property
    def unk_id(self) -> int:
        return self._index[UNK]

    @property
    def sos_eos_id(self) -> int:
        return len(self.labels) - 1

    def export_units(self, export_filename: str) -> None:
        """`<label> <id>` per line, the units file of an export."""
        with open(export_filename, "w") as f:
            for i, unit in enumerate(self.labels):
                f.write(f"{unit} {i}\n")

    def encode(self, text: str) -> np.ndarray:
        toks = self.encode_as_tokens(text)
        ids = [self._index.get(t, self._index[UNK]) for t in toks]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int] | np.ndarray) -> str:
        toks = [self.labels[int(i)] for i in np.asarray(ids).reshape(-1)]
        return self.decode_from_tokens(toks)

    @property
    def _index(self) -> Dict[str, int]:
        if not hasattr(self, "_index_cache"):
            self._index_cache = {t: i for i, t in enumerate(self.labels)}
        return self._index_cache


@dataclasses.dataclass
class CharTokenizerConfig:
    labels: tuple = ("a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k",
                     "l", "m", "n", "o", "p", "q", "r", "s", "t", "u", "v",
                     "w", "x", "y", "z", "'", " ")


class CharTokenizer(Tokenizer):

    def __init__(self, config: CharTokenizerConfig | None = None):
        config = config or CharTokenizerConfig()
        self._labels = [BLANK, UNK] + list(config.labels) + [SOS_EOS]

    @property
    def labels(self) -> List[str]:
        return self._labels

    def encode_as_tokens(self, text: str) -> List[str]:
        return [t if t in self._index else UNK for t in text]

    def decode_from_tokens(self, tokens: Sequence[str]) -> str:
        for t in tokens:
            assert t in self._index, f"OOV token '{t}'"
        return "".join(t for t in tokens if t not in (BLANK, UNK, SOS_EOS))


@dataclasses.dataclass
class SubwordTokenizerConfig:
    spm_model: str | None = None
    spm_vocab: str | None = None


class SubwordTokenizer(Tokenizer):
    """Unigram-subword tokenizer; label layout parity with reference
    dataset/utils.py:104-113 (blank at 0, <sos/eos> appended)."""

    def __init__(self, config: SubwordTokenizerConfig):
        assert config.spm_model or config.spm_vocab
        if config.spm_model:
            self._model = UnigramModel.load(config.spm_model)
        else:
            self._model = UnigramModel.load_vocab(config.spm_vocab)
        if self._model.ordered is not None:
            # real spm protobuf / .vocab file: keep the model's id order so
            # ids match the reference's vocab-derived layout EXACTLY
            # (reference dataset/utils.py:105-113 reads the file in order)
            pieces = list(self._model.ordered)
        else:
            # our JSON models: score-sorted (the order save_vocab writes)
            pieces = [p for p, _ in sorted(self._model.pieces.items(),
                                           key=lambda kv: -kv[1])]
        self._labels = [BLANK, UNK] + pieces + [SOS_EOS]

    @property
    def labels(self) -> List[str]:
        return self._labels

    def encode_as_tokens(self, text: str) -> List[str]:
        toks = self._model.encode_as_pieces(text, emit_unk_piece=True)
        return [t if t in self._index else UNK for t in toks]

    def decode_from_tokens(self, tokens: Sequence[str]) -> str:
        for t in tokens:
            assert t in self._index, f"OOV token '{t}'"
        return UnigramModel.decode_pieces(
            t for t in tokens if t not in (BLANK, SOS_EOS))


def TokenizerSetup(config: dict) -> Tokenizer:
    """Factory keyed like the reference (dataset/utils.py:170-179)."""
    if config["type"] == "char":
        return CharTokenizer(CharTokenizerConfig(**config.get("config", {})))
    elif config["type"] == "subword":
        return SubwordTokenizer(SubwordTokenizerConfig(**config["config"]))
    raise ValueError("Only 'char' and 'subword' tokenizers are supported.")
