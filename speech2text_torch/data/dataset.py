"""The ASR data pipeline (the port's copy of speech2text_tpu/data/dataset.py):
the host loads PCM and tokens, the device does the rest.

  host (this module): manifest → wav read → optional speed perturbation →
    fixed-shape padded int16 PCM + token ids (+ a noise PCM batch)
  device (tasks/base.py:AsrTaskBase.featurize): add_noise → fbank →
    mix_feats → CMVN → SpecAugment.

Batch dict: {pcm (B,N) int16, pcm_length (B,) i32, label (B,U) i32,
label_length (B,) i32, [noise_pcm (B,Nn) int16, noise_length (B,) i32],
[text, audio_filepath: lists of str with keep_text]}.

The arrays equal the JAX package's bit for bit: the same batcher, the same
per-(seed, shard, batch index) numpy generator for speed perturbation and
noise draws, and the same resampler. With `pin_memory` set, the prefetch
thread hands each array over as a torch tensor in pinned host memory, so
the trainer copies it to the card without blocking.

`LmPipeline` is the NNLM task's text pipeline: rows <sos> tokens <eos>
(B, max_len + 2) with their lengths, in a seeded permutation per epoch,
equal to the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from .audio import read_wav, speed_perturb
from .batcher import BucketBatcher, build_bucket_specs
from .manifest import load_manifest
from .tokenizer import Tokenizer

_SPEEDS = (0.9, 1.0, 1.1)


@dataclasses.dataclass
class DataConfig:
    """The YAML `dataset` section."""
    train_data: str | None = None
    eval_data: str | None = None
    test_data: str | None = None
    noise_data: str | None = None
    apply_segment: bool = False
    dur_min_filter: float = 0.0
    dur_max_filter: float = 60.0
    batch_size: int = 16
    use_bucket_sampler: bool = True
    bucket_sampler_config: dict = dataclasses.field(default_factory=dict)
    feat_type: str = "lhotes_fbank"
    feat_config: dict = dataclasses.field(default_factory=dict)
    data_aug_config: dict = dataclasses.field(default_factory=dict)
    sample_rate: int = 16000
    num_buckets: int = 8
    prefetch: int = 2
    batch_multiple: int = 1   # round batch sizes up
    base_dir: str = ""    # manifest audio paths resolved relative to this
    # in-memory decoded-PCM cache budget (bytes); 0 disables
    pcm_cache_bytes: int = 2 << 30
    # dtype of the pcm arrays: "int16" (the device dequantizes with
    # /32768) or "float32"
    pcm_dtype: str = "int16"


def _resolve(base: str, path: str) -> str:
    if os.path.isabs(path) or not base:
        return path
    return os.path.join(base, path)


def _quant16(wav: np.ndarray) -> np.ndarray:
    """float [-1,1] → int16 (the device dequantizes with /32768)."""
    return np.clip(np.round(wav * 32768.0), -32768, 32767).astype(np.int16)


class NoisePool:
    """Noise PCM clips for add_noise / mix_feats, cut at `max_seconds`."""

    def __init__(self, manifest_path: str, base_dir: str = "",
                 max_seconds: float = 10.0, sample_rate: int = 16000):
        entries = load_manifest(manifest_path)
        self._clips: List[np.ndarray] = []
        n_max = int(max_seconds * sample_rate)
        for e in entries:
            path = e.get("noise_filepath") or e["audio_filepath"]
            pcm, _ = read_wav(_resolve(base_dir, path))
            self._clips.append(pcm[:n_max])
        if not self._clips:
            raise ValueError(f"no noise clips in {manifest_path}")

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        """(B, longest clip) f32 PCM of clips drawn with `rng`, lengths."""
        n_len = max(len(c) for c in self._clips)
        out = np.zeros((batch_size, n_len), np.float32)
        lens = np.zeros((batch_size,), np.int32)
        idx = rng.integers(0, len(self._clips), size=batch_size)
        for i, j in enumerate(idx):
            c = self._clips[j]
            out[i, :len(c)] = c
            lens[i] = len(c)
        return out, lens


def _pinned(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: torch.from_numpy(v).pin_memory()
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


class AsrPipeline:
    """Bucketed ASR pipeline (train: speed perturbation + noise batch;
    eval/test: clean). Infinite for training, one epoch for eval/test."""

    def __init__(
        self,
        manifest_path: str,
        tokenizer: Tokenizer,
        config: DataConfig,
        training: bool = True,
        keep_text: bool = False,
        seed: int = 17,
        shard_index: int = 0,
        num_shards: int = 1,
        pin_memory: bool = False,
    ):
        self.cfg = config
        self.training = training
        self.keep_text = keep_text
        self.pin_memory = pin_memory
        self.tokenizer = tokenizer
        self.entries = load_manifest(manifest_path, config.dur_min_filter,
                                     config.dur_max_filter)
        if not self.entries:
            raise ValueError(f"empty manifest {manifest_path}")
        self._tokens = [tokenizer.encode(e["text"]) for e in self.entries]
        durations = [float(e["duration"]) for e in self.entries]
        bs_cfg = config.bucket_sampler_config or {}
        if config.use_bucket_sampler and training:
            volume = float(bs_cfg.get("volume_threshold", 600.0))
            min_bs = int(bs_cfg.get("min_batch_size", config.batch_size))
        else:
            # fixed batch size; single volume so every bucket uses it
            volume = 0.0
            min_bs = config.batch_size
        self.specs = build_bucket_specs(
            durations, [len(t) for t in self._tokens],
            num_buckets=int(bs_cfg.get("num_bucket", config.num_buckets)),
            volume_threshold=volume, min_batch_size=min_bs,
            max_batch_size=max(min_bs, 512) if volume > 0 else min_bs,
            sample_rate=config.sample_rate,
            speed_perturb_slack=1.12 if training else 1.0,
            batch_multiple=config.batch_multiple)
        self.batcher = BucketBatcher(durations, self.specs, seed=seed,
                                     shard_index=shard_index,
                                     num_shards=num_shards,
                                     drop_partial=False)
        aug = config.data_aug_config or {}
        self.use_speed_perturb = training and aug.get("use_speed_perturb",
                                                      False)
        self.need_noise = training and (aug.get("use_add_noise", False)
                                        or aug.get("use_mix_feats", False))
        self.noise_pool: Optional[NoisePool] = None
        if self.need_noise and config.noise_data:
            self.noise_pool = NoisePool(config.noise_data, config.base_dir,
                                        sample_rate=config.sample_rate)
        self._seed = seed
        self._shard_index = shard_index
        self._start_batch = 0
        self._pcm_cache: Dict[int, np.ndarray] = {}
        self._pcm_cache_used = 0

    def skip_batches(self, n: int) -> None:
        """Resume at global batch index `n` (one batch per trainer step).
        With the augmentation generator a function of (seed, shard, global
        batch index), a resumed run sees exactly the batches, indices and
        augmentations, that an uninterrupted run would."""
        self._start_batch = max(int(n), 0)

    def _load_pcm(self, j: int) -> np.ndarray:
        cached = self._pcm_cache.get(j)
        if cached is not None:
            return cached
        e = self.entries[j]
        wav, sr = read_wav(_resolve(self.cfg.base_dir, e["audio_filepath"]))
        if self.cfg.apply_segment and "offset" in e:
            o = int(float(e["offset"]) * sr)
            wav = wav[o:o + int(float(e["duration"]) * sr)]
        if self._pcm_cache_used + wav.nbytes <= self.cfg.pcm_cache_bytes:
            self._pcm_cache[j] = wav
            self._pcm_cache_used += wav.nbytes
        return wav

    # ------------------------------------------------------------- loading
    def _load_batch(self, bucket: int, idxs: List[int],
                    rng: np.random.Generator) -> Dict[str, Any]:
        spec = self.specs[bucket]
        B = len(idxs)
        int16 = self.cfg.pcm_dtype == "int16"
        pcm = np.zeros((B, spec.pcm_len), np.int16 if int16 else np.float32)
        pcm_len = np.zeros((B,), np.int32)
        label = np.zeros((B, spec.label_len), np.int32)
        label_len = np.zeros((B,), np.int32)
        texts, paths = [], []
        for i, j in enumerate(idxs):
            e = self.entries[j]
            wav = self._load_pcm(j)
            if self.use_speed_perturb:
                speed = _SPEEDS[rng.integers(0, len(_SPEEDS))]
                wav = speed_perturb(wav, speed)
            n = min(len(wav), spec.pcm_len)
            pcm[i, :n] = _quant16(wav[:n]) if int16 else wav[:n]
            pcm_len[i] = n
            toks = self._tokens[j]
            u = min(len(toks), spec.label_len)
            label[i, :u] = toks[:u]
            label_len[i] = u
            if self.keep_text:
                texts.append(e["text"])
                paths.append(e["audio_filepath"])
        batch = {"pcm": pcm, "pcm_length": pcm_len, "label": label,
                 "label_length": label_len}
        if self.noise_pool is not None:
            npcm, nlen = self.noise_pool.sample_batch(rng, B)
            batch["noise_pcm"] = _quant16(npcm) if int16 else npcm
            batch["noise_length"] = nlen
        if self.keep_text:
            batch["text"] = texts
            batch["audio_filepath"] = paths
        return _pinned(batch) if self.pin_memory else batch

    # ------------------------------------------------------------ iterators
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.training:
            it = self.batcher.iter_from(self._start_batch)
            start = self._start_batch
        else:
            it = iter(self.batcher.epoch_batches(0))
            start = 0
        yield from self._prefetched(it, start)

    def _prefetched(self, batch_iter, start_idx: int = 0
                    ) -> Iterator[Dict[str, Any]]:
        """Batches loaded by one thread, `prefetch` ahead. Closing the
        iterator stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()
        END = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                # augmentation rng is a pure function of (seed, shard,
                # global batch index): resume-exact and shard-distinct
                for n, (b, idxs) in enumerate(batch_iter, start=start_idx):
                    rng = np.random.default_rng(
                        (self._seed, self._shard_index, n))
                    if not put(self._load_batch(b, idxs, rng)):
                        return
                put(END)
            except Exception as e:  # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10.0)

    def batches_per_epoch(self) -> int:
        return self.batcher.batches_per_epoch()


class LmPipeline:
    """The NNLM text pipeline: the manifest's texts tokenized at load
    time and kept when they have `min_tokens` to `max_tokens` tokens;
    batches {text (B, max_len + 2) int32 = <sos> tokens <eos> zero-padded,
    text_length (B,) int32 = tokens + 2}, max_len the longest row + 1
    rounded up to `pad_multiple`. Each epoch is a permutation from
    `default_rng(seed + epoch)` cut into full batches; evaluation also
    keeps the rest, topped up with repeats of its first row, and runs one
    epoch; training runs forever and resumes at a global batch index
    (`skip_batches`). With shards, every shard takes its slice of each
    global batch. The task shifts the rows for teacher forcing."""

    def __init__(self, manifest_path: str, tokenizer: Tokenizer,
                 batch_size: int = 32, min_tokens: int = 1,
                 max_tokens: int = 256, seed: int = 17,
                 shard_index: int = 0, num_shards: int = 1,
                 training: bool = True, pad_multiple: int = 8,
                 pin_memory: bool = False):
        self.seqs = []
        for e in load_manifest(manifest_path):
            ids = tokenizer.encode(e["text"])
            if min_tokens <= len(ids) <= max_tokens:
                self.seqs.append(ids)
        if not self.seqs:
            raise ValueError(f"{manifest_path}: no text of {min_tokens}-"
                             f"{max_tokens} tokens")
        self.batch_size = batch_size
        self.training = training
        self.pin_memory = pin_memory
        self._seed = seed
        self._start_batch = 0
        self._shard = shard_index
        self._num_shards = num_shards
        longest = max(len(s) for s in self.seqs) + 1
        self.max_len = -(-longest // pad_multiple) * pad_multiple
        self.sos_eos = tokenizer.sos_eos_id

    def _make_batch(self, idxs) -> Dict[str, Any]:
        text = np.zeros((len(idxs), self.max_len + 2), np.int32)
        lens = np.zeros((len(idxs),), np.int32)
        for i, j in enumerate(idxs):
            s = self.seqs[j]
            text[i, 0] = self.sos_eos
            text[i, 1:1 + len(s)] = s
            text[i, 1 + len(s)] = self.sos_eos
            lens[i] = len(s) + 2
        batch = {"text": text, "text_length": lens}
        return _pinned(batch) if self.pin_memory else batch

    def batches_per_epoch(self) -> int:
        return max(len(self._epoch_batches(0)), 1)

    def _epoch_batches(self, epoch: int) -> List[np.ndarray]:
        order = np.random.default_rng(self._seed + epoch).permutation(
            len(self.seqs))
        bs = self.batch_size
        batches = [order[i:i + bs]
                   for i in range(0, len(order) - bs + 1, bs)]
        if not self.training:
            rest = order[len(order) - len(order) % bs:]
            if len(rest):
                batches.append(np.asarray(
                    list(rest) + [rest[0]] * (bs - len(rest))))
        if self._num_shards > 1:
            sharded = []
            for idxs in batches:
                m = len(idxs) // self._num_shards * self._num_shards
                if m:
                    sharded.append(idxs[self._shard:m:self._num_shards])
            batches = sharded
        return batches

    def skip_batches(self, n: int) -> None:
        """Resume training at global batch index `n`."""
        self._start_batch = max(int(n), 0)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        epoch, skip = divmod(self._start_batch if self.training else 0,
                             self.batches_per_epoch())
        while True:
            for idxs in self._epoch_batches(epoch)[skip:]:
                yield self._make_batch(idxs)
            if not self.training:
                return
            skip = 0
            epoch += 1
