"""True streaming ASR: a session that decodes raw PCM chunk by chunk (port
of speech2text_tpu/streaming.py).

Per chunk: raw f32 PCM in [−1, 1) → kaldi fbank framing continued across
chunks by a carried sample tail → the task's frontend (kernel B2 on the
card) and CMVN → Zipformer2 `streaming_prime` (first chunk) or
`streaming_step` (six caches per layer) → the greedy transducer loop
(decoding.RnntGreedyDecoding.continue_frames) resumed from the carried
predictor state and token buffer. Transcripts equal the offline
chunk-masked decode (`metric.encoder_streaming`) on the same audio.

Framing (snip_edges, 25 ms / 10 ms): frames(n) = 1 + (n − flen)//shift,
so a stream carries flen − shift samples. The first chunk must give
2·chunk_size + Zipformer2.PRIME_EXTRA_RAW fbank frames, every later one
2·chunk_size: the frontend halves the rate, so the encoder advances by
chunk_size frames per step. At chunk 32 that is 11760 samples for the
first chunk and 10240 (640 ms) per step.

The session runs on the device it is given (`cuda` unless the caller
asks for the CPU) under `torch.inference_mode()`, so no cache carries an
autograd graph, and reads nothing back from the card within a chunk.
The state also holds the last chunk's encoder output (`enc_out`); the
profiler spans of a chunk are `featurize`, `encoder` and `greedy`.
`program_state` and `program_chunk` give the state in JAX's layout and
the chunk function on it that export.py:export_streaming_session traces
into `stream_prime.pt2` / `stream_step.pt2`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .decoding import RnntGreedyDecoding, _map_state, ids_to_texts
from .models.zipformer import Zipformer2
from .train.loop import resolve_device
from .utils import tracing


class StreamingAsrSession:
    """Chunk-by-chunk streaming decode over a pruned RNN-T task with a
    causal Zipformer2 encoder.

        sess = StreamingAsrSession(task, chunk_size=32, device="cuda")
        state = sess.init_state(batch_size=1)
        state = sess.prime(pcm[:, :sess.prime_samples], state)
        for off in range(sess.prime_samples, N, sess.step_samples):
            state = sess.step(pcm[:, off:off + sess.step_samples], state)
        texts = sess.texts(state)
    """

    def __init__(self, task, chunk_size: int = 32,
                 left_context_chunks: int = 4, max_tokens: int = 256,
                 max_token_step: int = 1,
                 device: Union[str, torch.device, None] = "cuda"):
        enc = task.model.encoder
        if not isinstance(enc, Zipformer2):
            raise TypeError("streaming requires a Zipformer2 encoder")
        self.device = resolve_device(device, {})
        self.task = task.to(self.device).eval()
        self.model = task.model
        self.tokenizer = task.tokenizer
        self.chunk = int(chunk_size)
        self.left_chunks = int(left_context_chunks)
        fb = task.frontend.cfg
        if not fb.snip_edges:
            raise ValueError("streaming framing requires snip_edges")
        self._prime_frames = 2 * self.chunk + Zipformer2.PRIME_EXTRA_RAW
        self._step_frames = 2 * self.chunk
        self._tail = fb.frame_length - fb.frame_shift
        self.prime_samples = (self._prime_frames - 1) * fb.frame_shift \
            + fb.frame_length
        self.step_samples = self._step_frames * fb.frame_shift
        self.chunk_ms = 1000.0 * self.step_samples / fb.sample_rate
        self.cap = int(max_tokens)
        self.greedy = RnntGreedyDecoding(
            self.model.predictor_step, self.model.predictor.init_state,
            self.model.joiner_step, max_token_step=max_token_step,
            max_tokens=max_tokens)
        # validates the chunk against the config before any audio arrives
        enc.init_streaming_state(1, self.chunk, self.left_chunks, "meta")

    # -------------------------------------------------------------- state
    @torch.inference_mode()
    def init_state(self, batch_size: int) -> Dict[str, Any]:
        dev = self.device
        pred_state, pred_out, tokens, counts = self.greedy.init_carry(
            batch_size, dev)
        return {
            "enc": self.model.encoder.init_streaming_state(
                batch_size, self.chunk, self.left_chunks, dev),
            "pred_state": pred_state, "pred_out": pred_out,
            "tokens": tokens, "counts": counts,
            "pcm_tail": torch.zeros((batch_size, self._tail), device=dev),
            "enc_out": None,
        }

    # ----------------------------------------------------------- internals
    def _pcm(self, pcm, want: int, what: str) -> torch.Tensor:
        if isinstance(pcm, np.ndarray):
            pcm = torch.from_numpy(np.ascontiguousarray(pcm, np.float32))
        if pcm.shape[-1] != want:
            raise ValueError(f"{what} takes {want} samples, got "
                             f"{pcm.shape[-1]}")
        return pcm.to(self.device, torch.float32)

    def _featurize(self, pcm: torch.Tensor, n_frames: int) -> torch.Tensor:
        B, n = pcm.shape
        feats, _ = self.task.frontend(
            pcm, torch.full((B,), n, dtype=torch.int32, device=pcm.device))
        return self.task.cmvn(feats)[:, :n_frames]

    def _chunk(self, pcm: torch.Tensor, state: Dict[str, Any],
               prime: bool, spans: bool = True) -> Dict[str, Any]:
        enc = self.model.encoder
        span = tracing.span if spans else (
            lambda name: contextlib.nullcontext())
        if not prime:
            pcm = torch.cat([state["pcm_tail"], pcm], dim=1)
        with span("featurize"):
            feats = self._featurize(
                pcm, self._prime_frames if prime else self._step_frames)
        with span("encoder"):
            run = enc.streaming_prime if prime else enc.streaming_step
            enc_out, enc_state = run(feats, state["enc"])
        with span("greedy"):
            pred_state, pred_out, tokens, counts = \
                self.greedy.continue_frames(
                    enc_out, (state["pred_state"], state["pred_out"],
                              state["tokens"], state["counts"]))
        return {"enc": enc_state, "pred_state": pred_state,
                "pred_out": pred_out, "tokens": tokens, "counts": counts,
                "pcm_tail": pcm[:, -self._tail:], "enc_out": enc_out}

    # --------------------------------------------------- exported programs
    def program_state(self, state: Optional[Dict[str, Any]] = None,
                      batch_size: int = 1) -> Dict[str, Any]:
        """A state in the layout of the exported programs, which is JAX's
        (speech2text_tpu/streaming.py): `processed` an int32 0-dim tensor
        and no `chunk_size` in the encoder state, the predictor state (an
        integer one), tokens and counts in int32, no `enc_out`, and every
        dict's keys sorted, as jax.tree_util flattens them. Without
        `state`: the state before the first chunk, whose `pred_out` is
        None as JAX's (the prime program primes the predictor)."""
        if state is None:
            state = self.init_state(batch_size)
            state["pred_state"] = self.model.predictor.init_state(
                batch_size, self.device)
            state["pred_out"] = None
        enc = {k: v for k, v in state["enc"].items() if k != "chunk_size"}
        enc["processed"] = torch.as_tensor(enc["processed"],
                                           dtype=torch.int32,
                                           device=self.device)
        tree = {"enc": enc, "pred_out": state["pred_out"],
                "pred_state": _map_state(_int32, state["pred_state"]),
                "tokens": _int32(state["tokens"]),
                "counts": _int32(state["counts"]),
                "pcm_tail": state["pcm_tail"]}
        return _sorted(tree)

    def program_chunk(self, pcm: torch.Tensor, tree: Dict[str, Any],
                      prime: bool) -> Dict[str, Any]:
        """One chunk on a `program_state` tree → the next tree: the
        function that export.export_streaming_session traces, without the
        profiler spans and the inference mode of `prime`/`step`."""
        B = pcm.shape[0]
        enc = dict(tree["enc"], chunk_size=self.chunk)
        pred_state = _map_state(_int64, tree["pred_state"])
        pred_out = tree["pred_out"]
        if pred_out is None:
            pred_out, pred_state = self.model.predictor_step(
                torch.zeros((B,), dtype=torch.int64, device=pcm.device),
                pred_state)
        state = {"enc": enc, "pred_state": pred_state, "pred_out": pred_out,
                 "tokens": _int64(tree["tokens"]),
                 "counts": _int64(tree["counts"]),
                 "pcm_tail": tree["pcm_tail"]}
        return self.program_state(self._chunk(pcm, state, prime, spans=False))

    # ------------------------------------------------------------- public
    @torch.inference_mode()
    def prime(self, pcm, state: Dict[str, Any]) -> Dict[str, Any]:
        """The first chunk: (B, prime_samples) f32 PCM."""
        return self._chunk(self._pcm(pcm, self.prime_samples, "prime"),
                           state, prime=True)

    @torch.inference_mode()
    def step(self, pcm, state: Dict[str, Any]) -> Dict[str, Any]:
        """A later chunk: (B, step_samples) f32 PCM."""
        return self._chunk(self._pcm(pcm, self.step_samples, "step"),
                           state, prime=False)

    def texts(self, state: Dict[str, Any]) -> List[str]:
        return ids_to_texts(state["tokens"].cpu().numpy(),
                            state["counts"].cpu().numpy(), self.tokenizer)

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_utterance(self, pcm, measure_latency: bool = False
                      ) -> Tuple[List[str], List[float]]:
        """Stream a whole (B, N) or (N,) utterance chunk by chunk → (texts,
        per-chunk wall latencies in ms, empty unless measured; each ends
        with a synchronise on the card). Audio shorter than the first chunk
        is padded with zeros; trailing samples that do not fill a chunk are
        dropped (a deployment would pad with silence and flush)."""
        pcm = np.asarray(pcm, np.float32)
        if pcm.ndim == 1:
            pcm = pcm[None]
        off = self.prime_samples
        if pcm.shape[1] < off:
            pcm = np.pad(pcm, ((0, 0), (0, off - pcm.shape[1])))
        lat: List[float] = []
        state = self.init_state(pcm.shape[0])
        chunks = [(0, True)] + [
            (o, False) for o in range(off, pcm.shape[1] - self.step_samples
                                      + 1, self.step_samples)]
        for start, prime in chunks:
            if measure_latency:
                self._fence()
                t0 = time.perf_counter()
            if prime:
                state = self.prime(pcm[:, :off], state)
            else:
                state = self.step(pcm[:, start:start + self.step_samples],
                                  state)
            if measure_latency:
                self._fence()
                lat.append((time.perf_counter() - t0) * 1e3)
        return self.texts(state), lat


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_floating_point() else t.to(torch.int32)


def _int64(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_floating_point() else t.to(torch.int64)


def _sorted(tree: Any) -> Any:
    """Every dict of `tree` with its keys sorted."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree
