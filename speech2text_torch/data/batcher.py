"""Duration-bucketed batching with a few fixed shapes (the port's copy of
speech2text_tpu/data/batcher.py).

Each of `num_buckets` equal-width duration buckets gets a static
(batch_size, pcm_len, label_len) shape:

  batch_size(bucket) = max(min_batch_size, volume_threshold / hi_duration)
  pcm_len(bucket)    = hi_duration · sample_rate, rounded up
  label_len(bucket)  = p99.5 token count within the bucket, rounded up

so the audio per batch stays roughly constant across buckets while the
step sees at most `num_buckets` shapes. Iteration is infinite with a
per-epoch reshuffle and per-host sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    hi_duration: float
    batch_size: int
    pcm_len: int          # padded waveform samples
    label_len: int        # padded label tokens


def build_bucket_specs(
    durations: Sequence[float],
    token_counts: Sequence[int],
    num_buckets: int = 8,
    volume_threshold: float = 600.0,   # seconds of audio per batch
    min_batch_size: int = 2,
    max_batch_size: int = 512,
    sample_rate: int = 16000,
    pcm_multiple: int = 16000,         # pad pcm_len to 1s multiples
    label_multiple: int = 8,
    speed_perturb_slack: float = 1.12,  # speed 0.9 lengthens by ≤1/0.9
    batch_multiple: int = 1,           # round batch up (mesh divisibility)
) -> List[BucketSpec]:
    durations = np.asarray(durations, np.float64)
    token_counts = np.asarray(token_counts, np.int64)
    lo, hi = durations.min(), durations.max()
    edges = np.linspace(lo, hi, num_buckets + 1)[1:]
    specs = []
    prev = -np.inf
    for edge in edges:
        in_bucket = (durations > prev) & (durations <= edge)
        prev = edge
        if not in_bucket.any():
            continue
        bs = int(np.clip(int(volume_threshold / max(edge, 1e-6)),
                         min_batch_size, max_batch_size))
        bs = _round_up(bs, batch_multiple)
        pcm_len = _round_up(int(np.ceil(edge * sample_rate
                                        * speed_perturb_slack)),
                            pcm_multiple)
        lbl = int(np.percentile(token_counts[in_bucket], 99.5))
        lbl = _round_up(max(lbl, 1), label_multiple)
        specs.append(BucketSpec(float(edge), bs, pcm_len, lbl))
    return specs


class BucketBatcher:
    """Infinite epoch-reshuffled batch-index iterator with per-host sharding.

    yields (bucket_index, [entry indices]) with len == the bucket's static
    batch_size (short final batches are topped up by resampling within the
    bucket, keeping shapes fixed).
    """

    def __init__(
        self,
        durations: Sequence[float],
        specs: List[BucketSpec],
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        drop_partial: bool = False,
    ):
        self._durations = np.asarray(durations, np.float64)
        self._specs = specs
        self._edges = np.asarray([s.hi_duration for s in specs])
        self._seed = seed
        self._shard = shard_index
        self._num_shards = num_shards
        self._drop_partial = drop_partial

    def bucket_of(self, duration: float) -> int:
        return int(np.searchsorted(self._edges, duration, side="left").clip(
            0, len(self._specs) - 1))

    def epoch_batches(self, epoch: int) -> List[tuple]:
        """Lockstep schedule: every shard computes the same global batch
        sequence from the shared seed, then takes its slice of each
        batch's entries, so every shard sees the same number of batches
        per epoch and the same (bucket ⇒ T, U) shape at each step."""
        rng = np.random.default_rng(self._seed + epoch * 1_000_003)
        order = rng.permutation(len(self._durations))
        buckets: Dict[int, List[int]] = {i: [] for i in range(len(self._specs))}
        batches = []
        for idx in order:
            b = self.bucket_of(self._durations[idx])
            buckets[b].append(int(idx))
            if len(buckets[b]) == self._specs[b].batch_size:
                batches.append((b, buckets[b]))
                buckets[b] = []
        for b, rest in buckets.items():
            if not rest or self._drop_partial:
                continue
            need = self._specs[b].batch_size - len(rest)
            topup = rng.choice(rest, size=need).tolist() if need else []
            batches.append((b, rest + topup))
        rng.shuffle(batches)
        if self._num_shards > 1:
            sharded = []
            for b, idxs in batches:
                m = len(idxs) // self._num_shards * self._num_shards
                if m:
                    sharded.append((b, idxs[self._shard:m:self._num_shards]))
            batches = sharded
        return batches

    def __iter__(self) -> Iterator[tuple]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[tuple]:
        """Iterate from a global batch index (mid-epoch resume). The
        per-epoch batch count is constant
        (bucket membership is fixed by duration), so a global index maps
        statically to (epoch, offset); skipping replays only the cheap
        index schedule, not audio loading."""
        bpe = self.batches_per_epoch()
        epoch, skip = divmod(max(int(start_batch), 0), bpe)
        while True:
            for item in self.epoch_batches(epoch)[skip:]:
                yield item
            skip = 0
            epoch += 1

    def batches_per_epoch(self) -> int:
        return len(self.epoch_batches(0))
