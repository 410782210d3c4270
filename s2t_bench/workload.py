"""Traffic: the training batches of one mix, generated from its data file
(`traffic/<name>.json`) and a run's seed.

A mix's file gives its corpus as numbers: how many utterances, their
durations (a mixture of normal, lognormal and uniform components,
redrawn until they fall in [lo, hi]), tokens per second of audio and the
token ids, the batching (the port's bucket formula, copied below), and
the noise clips that augmentation mixes in. The corpus's sizes come from
the file's `corpus_seed` alone, so every run seed sees the same set of
sizes; the run seed orders the steps and draws their contents.

Batches: `bucket_specs` is speech2text_torch/data/batcher.py's
build_bucket_specs (equal-width duration buckets between the corpus's
shortest and longest utterance; batch size clip(volume / hi, min, max),
PCM padded to a whole second after the speed-perturbation slack, labels
to the bucket's 99.5th token percentile rounded up to 8); the number of
buckets, the audio per batch and the least batch are the training
config's (`dataset.bucket_sampler_config`), the rest the mix's. An epoch of
the port's BucketBatcher has ceil(n_b / bs_b) batches of bucket b; the
steps here take the buckets in those proportions, in the order of a
smooth weighted round robin, which the seed permutes within blocks of
eight steps: every seed takes the same shapes in every block, so any
run of steps holds each shape in its epoch share and two seeds' windows
do the same work in another order. Each step's rows are drawn
without replacement from its bucket's utterances.

Contents are made on the device: each utterance is synth_corpus's tones
plus noise (speech2text_torch/tools/synth_corpus.py: three tones of
amplitude U(0.03, 0.15), frequency U(80, 4000) Hz, random phase, plus
white noise of amplitude U(0.005, 0.03)), quantised to int16 as the
port's pipeline does, zero past its length; labels are ids drawn
uniformly from the file's range, zero past the utterance's token count.
The noise batch takes, per row, one clip of a pool made at set-up.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

def derived_seed(*key: int) -> int:
    """A 63-bit seed that is a function of the integers `key`."""
    state = np.random.SeedSequence([int(k) % (1 << 64) for k in key]) \
        .generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


BLOCK = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    hi_duration: float
    batch_size: int
    pcm_len: int
    label_len: int


def bucket_specs(durations: Sequence[float], token_counts: Sequence[int],
                 num_buckets: int, volume_threshold: float,
                 min_batch_size: int, max_batch_size: int,
                 sample_rate: int, pcm_multiple: int, label_multiple: int,
                 speed_perturb_slack: float) -> List[BucketSpec]:
    """The port's build_bucket_specs (one shard, batch_multiple 1)."""
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
        pcm_len = _round_up(int(np.ceil(edge * sample_rate
                                        * speed_perturb_slack)),
                            pcm_multiple)
        lbl = int(np.percentile(token_counts[in_bucket], 99.5))
        lbl = _round_up(max(lbl, 1), label_multiple)
        specs.append(BucketSpec(float(edge), bs, pcm_len, lbl))
    return specs


def draw_durations(spec: Dict, n: int, rng: np.random.Generator
                   ) -> np.ndarray:
    """`n` durations from the mixture, each redrawn until in [lo, hi]."""
    comps = spec["components"]
    weights = np.array([c["weight"] for c in comps], np.float64)
    weights /= weights.sum()
    out = np.empty(0)
    while out.size < n:
        m = 2 * (n - out.size) + 16
        which = rng.choice(len(comps), size=m, p=weights)
        x = np.empty(m)
        for i, c in enumerate(comps):
            k = int((which == i).sum())
            if c["dist"] == "normal":
                v = rng.normal(c["mean"], c["sd"], k)
            elif c["dist"] == "lognormal":
                v = np.exp(np.log(c["median"]) + c["sigma"]
                           * rng.standard_normal(k))
            elif c["dist"] == "uniform":
                v = rng.uniform(c["lo"], c["hi"], k)
            else:
                raise ValueError(f"unknown distribution {c['dist']!r}")
            x[which == i] = v
        x = x[(x >= spec["lo"]) & (x <= spec["hi"])]
        out = np.concatenate([out, x])
    return out[:n]


def swrr_order(weights: Sequence[int]) -> List[int]:
    """One period (sum(weights) picks) of a smooth weighted round robin."""
    w = np.asarray(weights, np.int64)
    cur = np.zeros_like(w)
    order = []
    for _ in range(int(w.sum())):
        cur += w
        i = int(np.argmax(cur))
        cur[i] -= w.sum()
        order.append(i)
    return order


class Traffic:
    """The corpus, buckets and step schedule of one mix."""

    def __init__(self, name: str, spec: Dict, sampler: Dict):
        self.name = name
        self.spec = spec
        self.sample_rate = int(spec["sample_rate"])
        rng = np.random.default_rng(int(spec["corpus_seed"]))
        n = int(spec["utterances"])
        self.durations = draw_durations(spec["durations"], n, rng)
        lo_r, hi_r = spec["tokens_per_second"]
        rates = rng.uniform(lo_r, hi_r, n)
        self.token_counts = np.maximum(
            np.round(self.durations * rates).astype(np.int64), 1)
        b = spec["batching"]
        self.buckets = bucket_specs(
            self.durations, self.token_counts, int(sampler["num_bucket"]),
            float(sampler["volume_threshold"]),
            int(sampler["min_batch_size"]), int(b["max_batch_size"]),
            self.sample_rate,
            int(b["pcm_multiple"]), int(b["label_multiple"]),
            float(b["speed_perturb_slack"]))
        edges = np.array([s.hi_duration for s in self.buckets])
        which = np.searchsorted(edges, self.durations, side="left").clip(
            0, len(self.buckets) - 1)
        self.members = [np.flatnonzero(which == i)
                        for i in range(len(self.buckets))]
        self.epoch_batches = [math.ceil(len(m) / s.batch_size)
                              for m, s in zip(self.members, self.buckets)]
        self.order = swrr_order(self.epoch_batches)
        nc = spec["noise"]
        self.noise_samples = np.round(
            rng.uniform(*nc["seconds"], int(nc["clips"]))
            * self.sample_rate).astype(np.int64)

    def bucket_at(self, seed: int, position: int) -> int:
        """The bucket at `position` of the seed's schedule: the round
        robin's order from its start, permuted by the seed within each
        block of BLOCK steps, so that every seed takes the same shapes in
        every block."""
        block, k = divmod(position, BLOCK)
        perm = np.random.default_rng(derived_seed(seed, 1, block)) \
            .permutation(BLOCK)
        return self.order[(block * BLOCK + int(perm[k])) % len(self.order)]

    def rows(self, seed: int, step: int, bucket: int) -> np.ndarray:
        """Corpus indices of one step's rows (distinct)."""
        rng = np.random.default_rng(derived_seed(seed, 2, step))
        m = self.members[bucket]
        bs = self.buckets[bucket].batch_size
        if bs <= len(m):
            return m[rng.choice(len(m), size=bs, replace=False)]
        # fewer utterances than rows: every one, then repeats
        return np.concatenate([m, m[rng.integers(0, len(m), bs - len(m))]])

    def audio_seconds(self, rows: np.ndarray) -> float:
        """Unpadded audio of the rows, seconds (the samples fed)."""
        return float(np.round(self.durations[rows] * self.sample_rate)
                     .astype(np.int64).sum()) / self.sample_rate


def _tones(gen: torch.Generator, n_rows: int, n_samples: int,
           sample_rate: int, device: torch.device) -> torch.Tensor:
    """(n_rows, n_samples) f32: three tones plus white noise per row."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((n_rows, 3, 1), generator=gen,
                                           device=device)
    amp, freq, phase = u(0.03, 0.15), u(80.0, 4000.0), u(0.0, 2 * math.pi)
    t = torch.arange(n_samples, device=device, dtype=torch.float32) \
        / sample_rate
    x = torch.zeros((n_rows, n_samples), device=device)
    for k in range(3):
        x += amp[:, k] * torch.sin(2 * math.pi * freq[:, k] * t
                                   + phase[:, k])
    noise_amp = 0.005 + 0.025 * torch.rand((n_rows, 1), generator=gen,
                                           device=device)
    x += noise_amp * torch.randn((n_rows, n_samples), generator=gen,
                                 device=device)
    return x


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on the device without waiting for the card: a copy
    from pinned memory, as the port's pipeline makes it (a plain copy
    from pageable memory would wait for every step queued before it)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _quant16(x: torch.Tensor) -> torch.Tensor:
    """f32 in [-1, 1] → int16, as the port's pipeline quantises."""
    return torch.clamp(torch.round(x * 32768.0), -32768, 32767) \
        .to(torch.int16)


class NoisePool:
    """The mix's noise clips, made on the device from the run seed."""

    def __init__(self, traffic: Traffic, seed: int, device: torch.device):
        gen = torch.Generator(device).manual_seed(derived_seed(seed, 3))
        lens = traffic.noise_samples
        self.lengths = to_device(lens.astype(np.int32), device)
        clips = _tones(gen, len(lens), int(lens.max()),
                       traffic.sample_rate, device)
        keep = torch.arange(clips.shape[1], device=device)[None] \
            < self.lengths[:, None]
        self.pcm = _quant16(torch.where(keep, clips, 0.0))


def make_batch(traffic: Traffic, noise: NoisePool, seed: int, step: int,
               bucket: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """One step's batch on the device, as the port's pipeline gives it:
    pcm (B, pcm_len) int16, pcm_length, label (B, label_len), label_length,
    noise_pcm (B, longest clip) int16, noise_length (int32)."""
    spec = traffic.buckets[bucket]
    rows = traffic.rows(seed, step, bucket)
    sr = traffic.sample_rate
    n = np.minimum(np.round(traffic.durations[rows] * sr).astype(np.int64),
                   spec.pcm_len)
    u = np.minimum(traffic.token_counts[rows], spec.label_len)
    gen = torch.Generator(device).manual_seed(derived_seed(seed, 4, step))
    pcm_len = to_device(n.astype(np.int32), device)
    label_len = to_device(u.astype(np.int32), device)
    x = _tones(gen, len(rows), spec.pcm_len, sr, device)
    idx = torch.arange(spec.pcm_len, device=device)
    pcm = _quant16(torch.where(idx[None] < pcm_len[:, None], x, 0.0))
    lo, hi = traffic.spec["vocab"]
    ids = torch.randint(int(lo), int(hi) + 1, (len(rows), spec.label_len),
                        generator=gen, device=device, dtype=torch.int32)
    lidx = torch.arange(spec.label_len, device=device)
    label = torch.where(lidx[None] < label_len[:, None], ids, 0)
    pick = torch.randint(0, noise.pcm.shape[0], (len(rows),), generator=gen,
                         device=device)
    return {"pcm": pcm, "pcm_length": pcm_len, "label": label,
            "label_length": label_len, "noise_pcm": noise.pcm[pick],
            "noise_length": noise.lengths[pick]}
