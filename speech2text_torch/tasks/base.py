"""Shared ASR task plumbing (port of speech2text_tpu/tasks/base.py): the
tokenizer, the data pipelines and the device-side featurization
(add_noise → fbank → mix_feats → CMVN → SpecAugment).

`Featurizer` holds the frontend (fbank, or the raw-PCM passthrough of
`feat_type: pcm`), CMVN and the augmentation config of a training YAML;
`AsrTaskBase` adds the tokenizer, the pipelines, the training step's
inputs (`step_losses`) and the weights' init (`init_weights`: the
seeded init, then the merge of a converted pretrained encoder,
`merge_pretrained_encoder`).
`featurize(batch, generator, training)` draws every augmentation value
from `generator` (on the batch's device) before it computes, in a fixed
order (add_noise, mix_feats, SpecAugment, then the dither noise, one
standard normal value per frame sample of the speech batch, when the
frontend's dither is > 0), so one generator state gives one result.
`draws` given explicitly replace the sampled ones (a `draws` without
"dither" still draws the dither noise from `generator`); the tests feed
the JAX package's draws there. The fbank of the speech batch, dither
included, and of the noise batch go through kernel B2 on the card. With the PCM frontend only add_noise
applies (mix_feats and SpecAugment act on fbank features, as the JAX
package's `isinstance(frontend, Fbank)` checks decide), and no kernel
runs: the features are the dequantised PCM, CMVN applied as JAX applies
it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import from_dict
from ..data import augment
from ..data.dataset import AsrPipeline, DataConfig
from ..data.frontend import Fbank, FrontendSetup, dequant_pcm, feat_lengths
from ..data.tokenizer import TokenizerSetup
from ..models.cmvn import GlobalCmvn
from ..ops.fbank import dither_noise
from ..utils.tracing import span

Batch = Dict[str, Any]


class Featurizer(nn.Module):
    """frontend + CMVN + augmentation of a training config's `dataset`
    and `callbacks` sections."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        ds = config.get("dataset") or {}
        self.frontend = FrontendSetup(ds.get("feat_type", "lhotes_fbank"),
                                      ds.get("feat_config") or {})
        self.aug = dict(ds.get("data_aug_config") or {})
        cmvn_cfg = (config.get("callbacks") or {}).get("global_cmvn") or {}
        path = cmvn_cfg.get("pre_compute_cmvn")
        self.cmvn = GlobalCmvn.from_file(path) \
            if cmvn_cfg.get("apply") and path and os.path.exists(path) \
            else GlobalCmvn()

    def sample_augmentation(self, batch: Batch, generator: torch.Generator
                            ) -> Dict[str, augment.Draws]:
        """The training augmentation's random values for `batch`, as the
        YAML turns each transform on."""
        aug = self.aug
        draws: Dict[str, augment.Draws] = {}
        has_noise = "noise_pcm" in batch
        if aug.get("use_add_noise") and has_noise:
            nc = aug.get("add_noise_config") or {}
            draws["add_noise"] = augment.sample_add_noise(
                batch["noise_length"], generator,
                p=float(aug.get("add_noise_proportion", 0.5)),
                min_snr_db=float(nc.get("min_snr_db", 10)),
                max_snr_db=float(nc.get("max_snr_db", 50)))
        if not isinstance(self.frontend, Fbank):
            return draws
        cfg = self.frontend.cfg
        if aug.get("use_mix_feats") and has_noise:
            mc = aug.get("mix_feats_config") or {}
            draws["mix_feats"] = augment.sample_mix_feats(
                feat_lengths(cfg, batch["noise_length"]), generator,
                p=float(aug.get("mix_feats_proportion", 0.5)),
                snrs=tuple(mc.get("snrs", (10, 20))))
        if aug.get("use_spec_aug"):
            sc = aug.get("spec_aug_config") or {}
            draws["spec_augment"] = augment.sample_spec_augment(
                feat_lengths(cfg, batch["pcm_length"]), cfg.num_mel_bins,
                generator,
                num_time_masks=int(sc.get("num_time_masks", 2)),
                time_mask_max=int(sc.get("time_mask_max", 50)),
                num_freq_masks=int(sc.get("num_freq_masks", 2)),
                freq_mask_max=int(sc.get("freq_mask_max", 10)))
        frames = cfg.num_frames(int(batch["pcm"].shape[-1]))
        if cfg.dither > 0.0 and frames > 0:
            draws["dither"] = dither_noise(
                batch["pcm"].shape[0], frames, cfg.frame_length, generator,
                batch["pcm"].device)
        return draws

    @torch.no_grad()
    def featurize(self, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  training: bool = False,
                  draws: Optional[Dict[str, augment.Draws]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pcm batch (tensors on one device) → (feats (B, T, D),
        feat_lens); augmented only when training with a generator or
        draws."""
        with span("featurize"):
            pcm = dequant_pcm(batch["pcm"])
            pcm_lens = batch["pcm_length"]
            if not training or (generator is None and draws is None):
                feats, lens = self.frontend(pcm, pcm_lens)
                return self.cmvn(feats), lens
            if draws is None:
                draws = self.sample_augmentation(batch, generator)
            if "add_noise" in draws:
                pcm = augment.add_noise(pcm, pcm_lens,
                                        dequant_pcm(batch["noise_pcm"]),
                                        batch["noise_length"],
                                        draws["add_noise"])
            feats, lens = self.frontend(pcm, pcm_lens,
                                        dither_generator=generator,
                                        noise=draws.get("dither"))
            if "mix_feats" in draws:
                nfeats, nlens = self.frontend(dequant_pcm(batch["noise_pcm"]),
                                              batch["noise_length"])
                feats = augment.mix_feats(feats, lens, nfeats, nlens,
                                          draws["mix_feats"])
            feats = self.cmvn(feats)
            if "spec_augment" in draws:
                feats = augment.spec_augment(feats, draws["spec_augment"])
            return feats, lens


class AsrTaskBase(Featurizer):
    """Tokenizer, data config, featurizer and pipelines from a training
    YAML tree."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.config = config
        self.tokenizer = TokenizerSetup(config["tokenizer"])
        ds = dict(config.get("dataset") or {})
        self.data_config = from_dict(DataConfig, {
            k: v for k, v in ds.items()
            if k in DataConfig.__dataclass_fields__})

    def make_train_pipeline(self, shard_index: int = 0, num_shards: int = 1,
                            seed: int = 17,
                            pin_memory: bool = False) -> AsrPipeline:
        return AsrPipeline(self.data_config.train_data, self.tokenizer,
                           self.data_config, training=True, seed=seed,
                           shard_index=shard_index, num_shards=num_shards,
                           pin_memory=pin_memory)

    def make_eval_pipeline(self, shard_index: int = 0, num_shards: int = 1,
                           pin_memory: bool = False) -> AsrPipeline:
        return AsrPipeline(self.data_config.eval_data, self.tokenizer,
                           self.data_config, training=False,
                           shard_index=shard_index, num_shards=num_shards,
                           pin_memory=pin_memory)

    def make_test_pipeline(self, shard_index: int = 0, num_shards: int = 1
                           ) -> AsrPipeline:
        return AsrPipeline(self.data_config.test_data, self.tokenizer,
                           self.data_config, training=False, keep_text=True,
                           shard_index=shard_index, num_shards=num_shards)

    def step_losses(self, batch: Batch, step: int,
                    generators: Tuple[torch.Generator, ...]
                    ) -> Callable[[], Dict[str, torch.Tensor]]:
        """The training step of train/loop.py:Trainer on a device batch:
        the training featurize (augmentation from the first of the step's
        generators (augmentation, dropout, chunk)), then the closure
        train/step.py:take_step runs, the task's `train_losses` at the
        global `step` with dropout and the chunk from the other two. The
        SSL and NNLM tasks override it."""
        augment_gen, dropout_gen, chunk_gen = generators
        feats, feat_lens = self.featurize(batch, augment_gen, training=True)
        return lambda: self.train_losses(feats, feat_lens, batch,
                                         dropout_gen, chunk_gen, step=step)

    @property
    def vocab_size(self) -> int:
        return len(self.tokenizer)

    def init_weights(self, generator: torch.Generator) -> int:
        """The model's seeded init, then the converted pretrained encoder
        over it (`merge_pretrained_encoder`); returns the tensors merged."""
        self.model.init_weights(generator)
        return self.merge_pretrained_encoder()

    def merge_pretrained_encoder(self) -> int:
        """Load the converted checkpoint that `encoder.config.
        pretrained_path` names (speech2text_torch/tools/
        convert_wav2vec2.py's file) over the encoder's weights; returns
        the tensors loaded (0 with no path). Its recorded layout must
        match the config (ValueError); a tensor the encoder lacks raises
        KeyError and one of another shape ValueError, before anything is
        loaded."""
        enc_cfg = (self.config.get("encoder") or {}).get("config") or {}
        path = enc_cfg.get("pretrained_path")
        if not path:
            return 0
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        layout = ckpt.get("layout")
        if layout is not None:
            # the pre-norm and post-norm layouts have the same names and
            # shapes: a merge of the wrong one would load and compute
            # garbage
            want = {
                "num_layers": int(enc_cfg.get("num_layers", 12)),
                "do_stable_layer_norm": int(
                    bool(enc_cfg.get("do_stable_layer_norm", False))),
                "feat_extract_norm": int(
                    enc_cfg.get("feat_extract_norm", "group") == "layer"),
            }
            for k, expect in want.items():
                if k in layout and int(layout[k]) != expect:
                    raise ValueError(
                        f"pretrained checkpoint layout mismatch: {k} is "
                        f"{int(layout[k])} in {path} but the encoder "
                        f"config expects {expect}")
        live = self.model.encoder.state_dict()
        for k, v in ckpt["encoder"].items():
            if k not in live:
                raise KeyError(f"pretrained key encoder/{k} not in model "
                               f"params (layout mismatch?)")
            if tuple(live[k].shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at encoder/{k}: model "
                                 f"{tuple(live[k].shape)} vs checkpoint "
                                 f"{tuple(v.shape)}")
        with torch.no_grad():
            for k, v in ckpt["encoder"].items():
                live[k].copy_(v)
        return len(ckpt["encoder"])
