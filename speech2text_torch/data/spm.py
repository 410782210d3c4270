"""Pure-Python unigram subword model (the port's copy of
speech2text_tpu/data/spm.py, sentencepiece-compatible surface).

  - training a subword vocab from a text corpus (unigram LM with EM
    pruning); deterministic, so the same corpus gives the same pieces and
    scores as the JAX package's trainer
  - `encode_as_pieces(text)` via Viterbi segmentation (max sum of piece
    log-probs), using the sentencepiece whitespace marker '▁'
  - a `.vocab` text file ("piece\\tscore" per line, with <unk>, <s>, </s>
    header rows) readable by SubwordTokenizer

Model files accepted by `UnigramModel.load`: the JSON format
{"pieces": {piece: score}} that `save` writes, and sentencepiece binary
`.model` protobufs (ModelProto), parsed with a minimal wire-format walker
(`_parse_spm_proto`); piece order is kept, so label ids follow the
model's layout.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import struct
from typing import Dict, Iterable, List, Optional, Tuple

WS = "▁"  # '▁' sentencepiece whitespace marker
UNK_PIECE = "<unk>"
BOS_PIECE = "<s>"
EOS_PIECE = "</s>"
_UNK_PENALTY = 10.0


def _normalize(text: str) -> str:
    text = re.sub(r"\s+", " ", text.strip())
    if not text:
        return ""
    return WS + text.replace(" ", WS)


# -------------------------------------------- sentencepiece ModelProto I/O
# Wire-format field numbers from sentencepiece_model.proto:
#   ModelProto.pieces = 1 (repeated SentencePiece)
#   SentencePiece.piece = 1 (string), .score = 2 (float), .type = 3 (enum:
#   NORMAL=1, UNKNOWN=2, CONTROL=3, USER_DEFINED=4, UNUSED=5, BYTE=6)
_SP_NORMAL, _SP_UNKNOWN, _SP_CONTROL = 1, 2, 3
_SP_USER_DEFINED, _SP_UNUSED, _SP_BYTE = 4, 5, 6


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (not a protobuf?)")


def _walk_fields(buf: bytes, start: int, end: int):
    """Yield (field_number, wire_type, value) over one message's fields.
    Length-delimited values are (start, end) offsets into buf."""
    i = start
    while i < end:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:                                   # varint
            val, i = _read_varint(buf, i)
        elif wt == 1:                                 # fixed64
            val, i = buf[i:i + 8], i + 8
        elif wt == 2:                                 # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = (i, i + ln), i + ln
        elif wt == 5:                                 # fixed32
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if i > end:
            raise ValueError("field overruns message (not a protobuf?)")
        yield field, wt, val


def _parse_spm_proto(buf: bytes) -> List[Tuple[str, float, int]]:
    """sentencepiece binary ModelProto → [(piece, score, type)] in id
    order. ~60 lines of varint walking; no protobuf dependency."""
    out: List[Tuple[str, float, int]] = []
    for field, wt, val in _walk_fields(buf, 0, len(buf)):
        if field != 1 or wt != 2:
            continue
        s, e = val
        piece: Optional[str] = None
        score, ptype = 0.0, _SP_NORMAL
        for f2, w2, v2 in _walk_fields(buf, s, e):
            if f2 == 1 and w2 == 2:
                piece = buf[v2[0]:v2[1]].decode("utf-8")
            elif f2 == 2 and w2 == 5:
                score = struct.unpack("<f", v2)[0]
            elif f2 == 3 and w2 == 0:
                ptype = v2
        if piece is not None:
            out.append((piece, score, ptype))
    if not out:
        raise ValueError("no pieces found (not a sentencepiece model?)")
    return out


class UnigramModel:
    """Unigram subword LM: piece → log-prob; Viterbi encoding.

    `ordered` (when set) is the piece list in model-file id order —
    SubwordTokenizer uses it so label ids reproduce the source model's
    layout exactly (reference dataset/utils.py:105-113 reads the .vocab
    file in order); None for our JSON models (legacy score-sorted ids)."""

    def __init__(self, pieces: Dict[str, float],
                 ordered: Optional[List[str]] = None):
        # pieces must contain all single chars seen at training time.
        self.pieces: Dict[str, float] = dict(pieces)
        self.max_len = max((len(p) for p in self.pieces), default=1)
        self.min_score = min(self.pieces.values(), default=0.0)
        self.ordered = ordered

    # ------------------------------------------------------------------ io
    def save(self, model_path: str, vocab_path: str | None = None) -> None:
        with open(model_path, "w") as f:
            json.dump({"pieces": self.pieces, "format": "s2t-unigram-v1"}, f)
        if vocab_path is not None:
            self.save_vocab(vocab_path)

    def save_vocab(self, vocab_path: str) -> None:
        # sentencepiece-compatible .vocab layout: <unk>, <s>, </s> first.
        with open(vocab_path, "w") as f:
            f.write(f"{UNK_PIECE}\t0\n{BOS_PIECE}\t0\n{EOS_PIECE}\t0\n")
            for p, s in sorted(self.pieces.items(), key=lambda kv: -kv[1]):
                f.write(f"{p}\t{s:.4f}\n")

    @classmethod
    def load(cls, model_path: str) -> "UnigramModel":
        try:
            with open(model_path, "r") as f:
                obj = json.load(f)
            return cls(obj["pieces"])
        except (UnicodeDecodeError, json.JSONDecodeError):
            pass
        # Real sentencepiece binary protobuf (reference
        # dataset/utils.py:98 loads these via the spm C++ wheel).
        with open(model_path, "rb") as f:
            buf = f.read()
        try:
            proto_pieces = _parse_spm_proto(buf)
        except (ValueError, IndexError, UnicodeDecodeError) as e:
            # last resort: a sibling .vocab file
            vocab = os.path.splitext(model_path)[0] + ".vocab"
            if os.path.exists(vocab):
                return cls.load_vocab(vocab)
            raise ValueError(
                f"{model_path} is neither an s2t-unigram JSON model nor a "
                f"parseable sentencepiece protobuf ({e}) and no sibling "
                f".vocab file found")
        pieces: Dict[str, float] = {}
        order: List[str] = []
        for piece, score, ptype in proto_pieces:
            # keep scoreable pieces; specials (<unk>/<s>/</s>, CONTROL)
            # are re-added by the tokenizer's label layout
            if ptype in (_SP_UNKNOWN, _SP_CONTROL, _SP_UNUSED):
                continue
            if piece not in pieces:
                order.append(piece)
            pieces[piece] = score
        return cls(pieces, ordered=order)

    @classmethod
    def load_vocab(cls, vocab_path: str) -> "UnigramModel":
        pieces: Dict[str, float] = {}
        order: List[str] = []
        with open(vocab_path, "r") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if not parts or not parts[0]:
                    continue
                piece = parts[0]
                if piece in (UNK_PIECE, BOS_PIECE, EOS_PIECE):
                    continue
                score = float(parts[1]) if len(parts) > 1 else 0.0
                if piece not in pieces:
                    order.append(piece)
                pieces[piece] = score
        return cls(pieces, ordered=order)

    # ------------------------------------------------------------- encode
    def encode_as_pieces(self, text: str, emit_unk_piece: bool = True) -> List[str]:
        """Viterbi segmentation maximizing total piece score.

        Characters not covered by any piece become the <unk> piece
        (parity with spm EncodeAsPieces(..., emit_unk_piece=True)).
        """
        s = _normalize(text)
        n = len(s)
        if n == 0:
            return []
        unk_score = self.min_score - _UNK_PENALTY
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: List[Tuple[int, str]] = [(0, "")] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] <= NEG:
                continue
            hi = min(n, i + self.max_len)
            for j in range(i + 1, hi + 1):
                piece = s[i:j]
                sc = self.pieces.get(piece)
                if sc is not None and best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = (i, piece)
            # single-char unk fallback
            j = i + 1
            if best[i] + unk_score > best[j]:
                best[j] = best[i] + unk_score
                back[j] = (i, UNK_PIECE)
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece)
            j = i
        return out[::-1]

    @staticmethod
    def decode_pieces(pieces: Iterable[str]) -> str:
        text = "".join(p for p in pieces if p not in (UNK_PIECE, BOS_PIECE, EOS_PIECE))
        return text.replace(WS, " ").strip()


# ---------------------------------------------------------------- training
def train_unigram(
    corpus: Iterable[str],
    vocab_size: int,
    max_piece_len: int = 8,
    seed_size_factor: int = 8,
    num_em_iters: int = 4,
    prune_frac: float = 0.25,
) -> UnigramModel:
    """Train a unigram subword model with EM + iterative pruning.

    Standard unigram-LM recipe: oversized seed vocab of frequent substrings
    → repeat {EM re-estimate scores, prune lowest-utility pieces} until
    vocab_size is reached. Single chars are never pruned (full coverage).
    `vocab_size` counts <unk>/<s>/</s>, matching sentencepiece semantics so
    the tokenizer label count works out identically.
    """
    word_counts: collections.Counter[str] = collections.Counter()
    for line in corpus:
        line = _normalize(line)
        # split on the marker but keep it attached to each word start
        for w in line.split(WS):
            if w:
                word_counts[WS + w] += 1

    # ---- seed vocab: all chars + frequent substrings
    char_counts: collections.Counter[str] = collections.Counter()
    sub_counts: collections.Counter[str] = collections.Counter()
    for w, c in word_counts.items():
        for ch in w:
            char_counts[ch] += c
        L = len(w)
        for i in range(L):
            for j in range(i + 2, min(L, i + max_piece_len) + 1):
                sub_counts[w[i:j]] += c

    target_pieces = max(vocab_size - 3, len(char_counts))  # minus <unk>,<s>,</s>
    seed_n = max(target_pieces * seed_size_factor, target_pieces + 16)
    seed = dict(char_counts)
    for piece, c in sub_counts.most_common(seed_n):
        if c >= 2:
            seed[piece] = c
    total = sum(seed.values())
    scores = {p: math.log(c / total) for p, c in seed.items()}
    model = UnigramModel(scores)

    def em_step(m: UnigramModel) -> Dict[str, float]:
        counts: Dict[str, float] = collections.defaultdict(float)
        for w, c in word_counts.items():
            for piece in _viterbi_word(m, w):
                counts[piece] += c
        tot = sum(counts.values())
        if tot <= 0:
            return m.pieces
        new = {}
        for p in m.pieces:
            cnt = counts.get(p, 0.0)
            # keep unused chars with a floor score; drop unused multi-char
            if cnt > 0:
                new[p] = math.log(cnt / tot)
            elif len(p) == 1:
                new[p] = math.log(0.5 / tot)
        return new

    while True:
        for _ in range(num_em_iters):
            model = UnigramModel(em_step(model))
        n_pieces = len(model.pieces)
        if n_pieces <= target_pieces:
            break
        # prune lowest-scoring multi-char pieces
        multi = [(s, p) for p, s in model.pieces.items() if len(p) > 1]
        multi.sort()
        n_drop = min(len(multi),
                     max(n_pieces - target_pieces,
                         int(len(multi) * prune_frac)))
        n_drop = min(n_drop, n_pieces - target_pieces)
        dropped = {p for _, p in multi[:n_drop]}
        model = UnigramModel(
            {p: s for p, s in model.pieces.items() if p not in dropped})
        if n_drop == 0:
            break
    return model


def _viterbi_word(m: UnigramModel, w: str) -> List[str]:
    n = len(w)
    NEG = -1e30
    best = [NEG] * (n + 1)
    back: List[Tuple[int, str]] = [(0, "")] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] <= NEG:
            continue
        hi = min(n, i + m.max_len)
        for j in range(i + 1, hi + 1):
            sc = m.pieces.get(w[i:j])
            if sc is not None and best[i] + sc > best[j]:
                best[j] = best[i] + sc
                back[j] = (i, w[i:j])
        if best[i + 1] <= NEG:  # coverage fallback (char unseen at seed time)
            best[i + 1] = best[i] - 100.0
            back[i + 1] = (i, w[i:i + 1])
    out: List[str] = []
    j = n
    while j > 0:
        i, piece = back[j]
        out.append(piece)
        j = i
    return out[::-1]
