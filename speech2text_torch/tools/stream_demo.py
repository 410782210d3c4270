"""Streaming ASR demo: decode wavs chunk by chunk with per-chunk latency
(port of tools/stream_demo.py).

Drives speech2text_torch.streaming.StreamingAsrSession (raw PCM →
streaming fbank → Zipformer2 streaming_step → greedy transducer
continuation) over a trained run's averaged port checkpoints and prints
the transcript and a latency table: the first chunk, the steady chunks'
p50 / p95 / max, and the real-time factor (steady p50 over the audio a
chunk holds). Runs on `cuda` unless `--device cpu` is given; with no card
and no such request it raises.

    python -m speech2text_torch.tools.stream_demo \\
        --train_config <export_path>/<name>/<training yaml> \\
        --wav a.wav [b.wav ...] [--chunk_size 32] [--left_chunks 4] \\
        [--avg_best_k 2] [--checkpoints_dir DIR] [--device cpu] \\
        [--export_dir DIR]

With `--export_dir` the session's chunk path is first exported
(export.py:export_streaming_session: `stream_prime.pt2`,
`stream_step.pt2` and `streaming_spec.json`, traced on the session's
device), then the wavs are streamed, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.audio import read_wav
from ..export import export_streaming_session
from ..inference import _resolve, inference_train_config
from ..streaming import StreamingAsrSession
from ..tasks.rnnt import PrunedRnntTask
from ..train.checkpoint import average_checkpoints
from ..train.loop import resolve_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train_config", required=True)
    ap.add_argument("--wav", required=True, nargs="+")
    ap.add_argument("--chunk_size", type=int, default=32,
                    help="post-frontend frames per step (divisible by "
                         "every downsampling factor)")
    ap.add_argument("--left_chunks", type=int, default=4)
    ap.add_argument("--avg_best_k", type=int, default=2)
    ap.add_argument("--checkpoints_dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--export_dir", default=None,
                    help="export the session's prime and step "
                         "programs here first")
    return ap.parse_args(argv)


def latency_summary(lat: List[float], chunk_ms: float) -> Dict[str, float]:
    """Per-chunk latencies (ms, the first chunk first) → first, steady
    p50 / p95 / max and RTF = steady p50 / chunk_ms."""
    steady = lat[1:] or lat
    p50 = float(np.percentile(steady, 50))
    return {"first_ms": lat[0], "p50_ms": p50,
            "p95_ms": float(np.percentile(steady, 95)),
            "max_ms": float(max(steady)), "rtf": p50 / chunk_ms}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Export the session if asked, then stream each wav; returns
    {"session", "exported" (the export's paths, or None), "results":
    [{"wav", "seconds", "text", "latency_ms", "summary"}, ...]}."""
    args = parse_args(argv)
    device = resolve_device(args.device, {})
    cfg = inference_train_config(
        {"task": {"train_config": _resolve(args.train_config)}})
    task = PrunedRnntTask(cfg)
    ckpt_dir = args.checkpoints_dir or os.path.join(
        cfg["task"]["export_path"], cfg["task"]["name"], "checkpoints")
    task.model.load_state_dict(average_checkpoints(ckpt_dir,
                                                   best_k=args.avg_best_k))
    print(f"loaded checkpoint average (best {args.avg_best_k}) from "
          f"{ckpt_dir}")
    sess = StreamingAsrSession(task, chunk_size=args.chunk_size,
                               left_context_chunks=args.left_chunks,
                               device=device)
    exported = None
    if args.export_dir:
        exported = export_streaming_session(sess, args.export_dir)
        print(f"serving graph exported: {exported}")
    sr = task.frontend.cfg.sample_rate
    print(f"chunk = {sess.step_samples} samples ({sess.chunk_ms:.0f} ms "
          f"audio), prime = {sess.prime_samples} samples, device {device}")
    results = []
    for wav in args.wav:
        pcm, wav_sr = read_wav(wav)
        if wav_sr != sr:
            raise ValueError(f"{wav}: {wav_sr} Hz, the model takes {sr} Hz")
        texts, lat = sess.run_utterance(pcm[None], measure_latency=True)
        summary = latency_summary(lat, sess.chunk_ms)
        print(f"\n== {os.path.basename(wav)} ({len(pcm) / sr:.2f} s, "
              f"{len(lat)} chunks) ==")
        print(f"transcript: {texts[0]}")
        print(f"latency ms/chunk: first={summary['first_ms']:.1f}  steady "
              f"p50={summary['p50_ms']:.1f}  p95={summary['p95_ms']:.1f}  "
              f"max={summary['max_ms']:.1f}")
        pace = "real time" if summary["rtf"] < 1 else \
            "slower than real time"
        print(f"steady-state RTF={summary['rtf']:.3f} ({pace})")
        results.append({"wav": wav, "seconds": len(pcm) / sr,
                        "text": texts[0], "latency_ms": lat,
                        "summary": summary})
    return {"session": sess, "exported": exported, "results": results}


if __name__ == "__main__":
    main()
