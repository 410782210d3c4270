"""A synthetic ASR corpus from a seed: 16 kHz int16 wavs of tones plus
noise, transcripts drawn from a fixed word list, and the three JSON-lines
manifests (train, eval, noise) that the training YAML's `dataset`
section names.

    python -m speech2text_torch.tools.synth_corpus OUT_DIR [--seed S]

writes OUT_DIR/{train,eval,noise}/*.wav and OUT_DIR/{train,eval,noise}.json
(absolute audio paths). Nothing is read from outside the repo.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Tuple

import numpy as np

from ..data.audio import write_wav

WORDS = (
    "the of and to in is was he for it with as his on be at by had are but "
    "from or have an they which one you were her all she there would their "
    "we him been has when who will more no if out so said what up its about "
    "into than them can only other new some could time these two may then "
    "do first any my now such like our over man me even most made after "
    "also did many before must through back years where much your way well "
    "down should because each just those people how too little state good "
    "very make world still own see men work long get here between both life "
    "being under never day same another know while last might us great old "
    "year off come since against go came right used take three"
).split()


def _tone_noise(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    x = np.zeros(n)
    for _ in range(3):
        x += rng.uniform(0.03, 0.15) * np.sin(
            2 * np.pi * rng.uniform(80, 4000) * t + rng.uniform(0, 2 * np.pi))
    x += rng.uniform(0.005, 0.03) * rng.standard_normal(n)
    return x.astype(np.float32)


def _write_set(out_dir: str, name: str, n: int, lo_s: float, hi_s: float,
               rng: np.random.Generator, sr: int, with_text: bool) -> str:
    os.makedirs(os.path.join(out_dir, name), exist_ok=True)
    manifest = os.path.join(out_dir, f"{name}.json")
    key = "audio_filepath" if with_text else "noise_filepath"
    with open(manifest, "w") as f:
        for i in range(n):
            samples = int(rng.uniform(lo_s, hi_s) * sr)
            path = os.path.abspath(os.path.join(out_dir, name,
                                                f"{name}_{i:04d}.wav"))
            write_wav(path, _tone_noise(rng, samples, sr), sr)
            entry = {key: path, "duration": samples / sr}
            if with_text:
                n_words = max(1, int(round(samples / sr * 2.0)))
                entry["text"] = " ".join(rng.choice(WORDS, n_words))
            f.write(json.dumps(entry) + "\n")
    return manifest


def write_corpus(out_dir: str, seed: int = 0, n_train: int = 128,
                 n_eval: int = 32, n_noise: int = 8,
                 train_seconds: Tuple[float, float] = (2.0, 12.0),
                 eval_seconds: Tuple[float, float] = (2.0, 12.0),
                 noise_seconds: Tuple[float, float] = (3.0, 9.0),
                 sample_rate: int = 16000) -> Dict[str, str]:
    """Write the corpus; returns the manifests' paths by the dataset keys
    train_data, eval_data, noise_data."""
    rng = np.random.default_rng(seed)
    return {
        "train_data": _write_set(out_dir, "train", n_train, *train_seconds,
                                 rng, sample_rate, True),
        "eval_data": _write_set(out_dir, "eval", n_eval, *eval_seconds, rng,
                                sample_rate, True),
        "noise_data": _write_set(out_dir, "noise", n_noise, *noise_seconds,
                                 rng, sample_rate, False),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(write_corpus(args.out_dir, seed=args.seed)))
