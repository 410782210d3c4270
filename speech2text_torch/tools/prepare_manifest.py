"""JSON-lines manifests from a directory of audio and transcripts (the
port's copy of speech2text_tpu/tools/prepare_manifest.py).

LibriSpeech layout: nested directories with `*.trans.txt` files (`utt_id
text` per line, the text lower-cased) beside the audio; tsv layout: a
table of `utt_id<TAB>text` naming audio under the root. Each line is
{"audio_filepath", "duration" (seconds, 3 decimals), "text"}; `.flac`
files are read with soundfile where it is installed and skipped where it
is not.

    python -m speech2text_torch.tools.prepare_manifest \\
        --audio_dir /data/LibriSpeech/train-clean-100 \\
        --output train.json [--layout librispeech|tsv] [--tsv TABLE]
"""

from __future__ import annotations

import argparse
import json
import os
import wave
from typing import Iterator, List, Optional, Tuple


def wav_duration(path: str) -> float:
    with wave.open(path, "rb") as w:
        return w.getnframes() / w.getframerate()


def _audio(stem: str) -> Optional[str]:
    for ext in (".wav", ".flac"):
        if os.path.exists(stem + ext):
            return stem + ext
    return None


def librispeech_entries(root: str) -> Iterator[Tuple[str, str]]:
    for dirpath, _, files in os.walk(root):
        for t in (f for f in files if f.endswith(".trans.txt")):
            with open(os.path.join(dirpath, t)) as f:
                for line in f:
                    utt, _, text = line.strip().partition(" ")
                    audio = _audio(os.path.join(dirpath, utt))
                    if audio:
                        yield audio, text.lower()


def tsv_entries(root: str, tsv: str) -> Iterator[Tuple[str, str]]:
    with open(tsv) as f:
        for line in f:
            utt, _, text = line.rstrip("\n").partition("\t")
            audio = _audio(os.path.join(root, utt))
            if audio:
                yield audio, text


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m speech2text_torch.tools.prepare_manifest",
        description="Write a JSON-lines manifest of a corpus directory.")
    ap.add_argument("--audio_dir", required=True, help="root dir to scan")
    ap.add_argument("--output", required=True, help="output manifest path")
    ap.add_argument("--layout", default="librispeech",
                    choices=("librispeech", "tsv"), help="corpus layout")
    ap.add_argument("--tsv", default=None,
                    help="utt_id<TAB>text table (layout tsv)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    """Write the manifest; returns the number of entries."""
    args = parse_args(argv)
    gen = (librispeech_entries(args.audio_dir)
           if args.layout == "librispeech"
           else tsv_entries(args.audio_dir, args.tsv))
    n = 0
    with open(args.output, "w") as out:
        for audio, text in gen:
            if audio.endswith(".flac"):
                try:
                    import soundfile as sf
                except ImportError:
                    continue
                dur = sf.info(audio).duration
            else:
                dur = wav_duration(audio)
            out.write(json.dumps({"audio_filepath": audio,
                                  "duration": round(dur, 3),
                                  "text": text}) + "\n")
            n += 1
    print(f"wrote {n} entries → {args.output}")
    return n


if __name__ == "__main__":
    main()
