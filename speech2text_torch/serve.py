"""Transducer serving: PCM in, token ids out.

`RnntServer` is built from an inference config such as
configs/inference/zipformer_stateless_pruned_rnnt_beam_search.yaml and
the training config it names (`task.train_config`), applied to each other
by inference.py:inference_train_config, as the inference entry does.
`transcribe` runs featurize (int16 → f32, fbank, CMVN; no augmentation) →
Zipformer2 encoder (chunk-masked when `streaming.is_encoder_streaming`
asks for simulated streaming) → the decoder of the `decoding` section
(greedy, or beam search with an optional RNN-LM from
`metric.lm_fusion`; decoding.py:build_decoding; with `metric.int8`,
the int8 predictor and joiner of tasks/rnnt.py:Int8Decoding).

Runs on `cuda` unless the caller passes `device="cpu"`. Weights are a
seeded random init (`seed`), a port checkpoint (`checkpoint=`: a
`step_*.pt` file, or a checkpoint directory from which the config's
`task` section selects, train/checkpoint.py:inference_weights), or a
converted flax tree (`server.model.load_state_dict(
convert.flax_to_state_dict(...))`). Token ids become text through a
tokenizer (decoding.ids_to_texts); a test set with a WER report goes
through `python -m speech2text_torch.inference`. Restoring the JAX
package's orbax checkpoints is not ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .config import load_config
from .data.frontend import Fbank, FrontendSetup, dequant_pcm
from .inference import _resolve, inference_train_config
from .models.cmvn import GlobalCmvn
from .tasks.rnnt import (Int8Decoding, RnntModel, decoding_of,
                         load_fusion_lm, streaming_chunks)
from .train.checkpoint import inference_weights


# the training config an inference config serves: the inference entry's
serving_train_config = inference_train_config


class RnntServer:

    def __init__(self, inference_config: Union[str, Dict[str, Any]],
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 checkpoint: Optional[str] = None):
        """`inference_config` is a path or a loaded config dict;
        `checkpoint` a port checkpoint file or directory (else the
        weights are seeded)."""
        infer_cfg = load_config(_resolve(inference_config)) \
            if isinstance(inference_config, str) else inference_config
        train_cfg = serving_train_config(infer_cfg)
        metric = train_cfg.get("metric") or {}
        self.device = torch.device(device)
        self.batch_size = int(((infer_cfg.get("testset") or {}).get(
            "config") or {}).get("batch_size", 16))

        ds = train_cfg.get("dataset") or {}
        self.frontend = FrontendSetup(ds.get("feat_type", "lhotes_fbank"),
                                      ds.get("feat_config") or {})
        if not isinstance(self.frontend, Fbank):
            raise NotImplementedError("only fbank frontends are ported")
        cmvn_cfg = (train_cfg.get("callbacks") or {}).get("global_cmvn") \
            or {}
        path = cmvn_cfg.get("pre_compute_cmvn")
        self.cmvn = GlobalCmvn.from_file(path) \
            if cmvn_cfg.get("apply") and path and os.path.exists(path) \
            else GlobalCmvn()

        self.model = RnntModel.from_config(train_cfg)
        if checkpoint is None:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        elif os.path.isdir(checkpoint):
            self.model.load_state_dict(inference_weights(
                dict(infer_cfg["task"], checkpoints_dir=checkpoint),
                train_cfg))
        else:
            self.model.load_state_dict(torch.load(
                checkpoint, map_location="cpu", weights_only=True)["model"])
        vocab = self.model.joiner.config.output_dim
        self.lm, lm_weight = load_fusion_lm(metric, vocab, vocab)
        self.streaming = streaming_chunks(metric)
        for m in (self.frontend, self.cmvn, self.model, self.lm):
            if m is not None:
                m.to(self.device).eval()
        self.decoder = Int8Decoding(metric, self.model) \
            if metric.get("int8") else \
            decoding_of(metric, self.model, self.lm, lm_weight)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x).to(self.device)

    @torch.inference_mode()
    def featurize(self, pcm, pcm_lengths) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """pcm (B, N) int16 or f32, pcm_lengths (B,) → (feats, lens)."""
        feats, lens = self.frontend(dequant_pcm(self._tensor(pcm)),
                                    self._tensor(pcm_lengths))
        return self.cmvn(feats), lens

    @torch.inference_mode()
    def encode(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        return self.model.encoder(feats, feat_lens, *self.streaming)

    @torch.inference_mode()
    def transcribe(self, pcm, pcm_lengths):
        """pcm (B, N) int16|f32, pcm_lengths (B,) → (tokens (B, 256) int32,
        counts (B,) int32)."""
        feats, feat_lens = self.featurize(pcm, pcm_lengths)
        return self.decoder.decode(*self.encode(feats, feat_lens))
