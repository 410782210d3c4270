"""WER/CER metrics for evaluation (port of speech2text_tpu/metrics.py):
Levenshtein distance, corpus-level WER over (hyp, ref) pairs,
`AsrMetric`, which accumulates an eval epoch and logs a random sample
pair, and `masked_topk_accuracy`, the SSL and NNLM tasks' metric."""

from __future__ import annotations

import random
from typing import Iterable, List, Sequence, Tuple

import torch

from .parallel import all_reduce_sum, global_count
from .utils.logging import get_logger

log = get_logger(__name__)


def levenshtein(ref: Sequence, hyp: Sequence) -> int:
    """Edit distance via two-row DP."""
    if len(ref) == 0:
        return len(hyp)
    if len(hyp) == 0:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, start=1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, start=1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (0 if r == h else 1))
        prev = cur
    return prev[-1]


def wer_counts(hyps: Iterable[str], refs: Iterable[str],
               use_cer: bool = False) -> Tuple[int, int]:
    """(edits, ref_tokens) for distributed-safe accumulation."""
    edits, total = 0, 0
    for hyp, ref in zip(hyps, refs):
        h = list(hyp) if use_cer else hyp.split()
        r = list(ref) if use_cer else ref.split()
        edits += levenshtein(r, h)
        total += len(r)
    return edits, total


def word_error_rate(hyps: Iterable[str], refs: Iterable[str],
                    use_cer: bool = False) -> float:
    """Corpus WER (or CER): total edits / total reference tokens."""
    edits, total = wer_counts(hyps, refs, use_cer)
    if total == 0:
        return float(edits > 0)
    return edits / total


class AsrMetric:
    """Accumulates (hyp, ref) pairs over an eval epoch and reports WER,
    logging a random sample pair."""

    def __init__(self, use_cer: bool = False, log_samples: bool = True):
        self._use_cer = use_cer
        self._log_samples = log_samples
        self.reset()

    def reset(self) -> None:
        self._edits = 0
        self._total = 0
        self._sample: Tuple[str, str] | None = None
        self._count = 0

    def update(self, hyps: List[str], refs: List[str]) -> None:
        e, t = wer_counts(hyps, refs, self._use_cer)
        self._edits += e
        self._total += t
        self._count += len(hyps)
        if hyps and (self._sample is None or random.random() < 0.1):
            i = random.randrange(len(hyps))
            self._sample = (hyps[i], refs[i])

    def compute(self) -> float:
        if self._total == 0:
            return 0.0
        if self._log_samples and self._sample is not None:
            log.info("eval sample | hyp: %s | ref: %s", *self._sample)
        return self._edits / self._total

    @property
    def num_utts(self) -> int:
        return self._count

    def all_reduce(self) -> None:
        """Sum the edits, reference tokens and utterances over the ranks
        of a process group (each rank having updated with its rows), so
        that `compute()` is the global corpus WER."""
        counts = all_reduce_sum(torch.tensor(
            [self._edits, self._total, self._count], dtype=torch.float64))
        self._edits, self._total, self._count = (int(c) for c in counts)


def masked_topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, k: int = 1) -> torch.Tensor:
    """The share of masked positions whose label is among the k largest
    logits; logits (..., C), labels (...), mask (...) bool or float. Equal
    logits rank by index, the lower first (lax.top_k's order): for k = 1
    the first maximum, else a stable descending sort. Under a process
    group the share is of the global batch's positions
    (parallel.global_count)."""
    if k == 1:
        idx = logits.argmax(dim=-1, keepdim=True)
    else:
        idx = torch.sort(logits, dim=-1, descending=True,
                         stable=True)[1][..., :k]
    hit = (idx == labels[..., None].long()).any(dim=-1).float()
    m = mask.float()
    return (hit * m).sum() / global_count(m.sum())
