"""Greedy transducer serving: PCM in, token ids out.

`RnntServer` is built from an inference config such as
configs/inference/pruned_rnnt_greedy_search.yaml and the training config
it names (`task.train_config`), the way inference.py reads them:
the test set's feature settings and the decoding section override the
training config. `transcribe` runs featurize (int16 → f32, fbank, CMVN;
no augmentation) → Zipformer2 encoder → batched greedy decoding.

Runs on `cuda` unless the caller passes `device="cpu"`. Weights are a
seeded random init (`seed`) or a converted flax tree
(`server.model.load_state_dict(convert.flax_to_state_dict(...))`).
Restoring the JAX package's orbax checkpoints, token-id → text and the
manifest CLI are not ported yet.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from .config import load_config
from .data.frontend import Fbank, FrontendSetup, dequant_pcm
from .decoding import RnntGreedyDecoding
from .models.cmvn import GlobalCmvn
from .tasks.rnnt import RnntModel

REPO_ROOT = Path(__file__).resolve().parents[1]


def _resolve(path: str) -> str:
    """A config path as given, else relative to the repo root."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return str(REPO_ROOT / path)


def serving_train_config(infer_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The training config an inference config serves
    (`task.train_config`, a path or a loaded config dict), with the test
    set's feature settings and the decoding section applied, as
    inference.py applies them."""
    train_cfg = infer_cfg["task"]["train_config"]
    train_cfg = copy.deepcopy(train_cfg) if isinstance(train_cfg, dict) \
        else load_config(_resolve(train_cfg))
    ts_cfg = (infer_cfg.get("testset") or {}).get("config") or {}
    ds = train_cfg.setdefault("dataset", {})
    if "feat_type" in ts_cfg and not ts_cfg["feat_type"].startswith(
            "torchscript") and ds.get("feat_type") != "pcm":
        ds["feat_type"] = ts_cfg["feat_type"]
    if "num_mel_bins" in (ts_cfg.get("feat_config") or {}):
        ds.setdefault("feat_config", {})["num_mel_bins"] = \
            ts_cfg["feat_config"]["num_mel_bins"]
    dec = infer_cfg.get("decoding") or {}
    if dec.get("type"):
        metric = train_cfg.setdefault("metric", {})
        metric["decode_method"] = dec["type"]
        metric.update(dec.get("config") or {})
    return train_cfg


class RnntServer:

    def __init__(self, inference_config: Union[str, Dict[str, Any]],
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        """`inference_config` is a path or a loaded config dict."""
        infer_cfg = load_config(inference_config) \
            if isinstance(inference_config, str) else inference_config
        train_cfg = serving_train_config(infer_cfg)
        metric = train_cfg.get("metric") or {}
        method = metric.get("decode_method", "rnnt_greedy_search")
        if method != "rnnt_greedy_search":
            raise NotImplementedError(f"decode method {method!r} is not "
                                      f"ported (rnnt_greedy_search only)")
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
        self.model.init_weights(torch.Generator().manual_seed(seed))
        for m in (self.frontend, self.cmvn, self.model):
            m.to(self.device).eval()
        self.decoder = RnntGreedyDecoding(
            self.model.predictor_step, self.model.predictor.init_state,
            self.model.joiner_step,
            max_token_step=int(metric.get("max_token_step", 1)))

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
        return self.model.encode(feats, feat_lens)

    @torch.inference_mode()
    def transcribe(self, pcm, pcm_lengths):
        """pcm (B, N) int16|f32, pcm_lengths (B,) → (tokens (B, 256) int32,
        counts (B,) int32)."""
        feats, feat_lens = self.featurize(pcm, pcm_lengths)
        return self.decoder.decode(*self.encode(feats, feat_lens))
