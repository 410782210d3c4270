"""BEST-RQ's random-projection quantizer and span masking (port of
speech2text_tpu/models/best_rq.py).

The frozen projector (xavier-uniform, (stack_size · feature_dim,
codebook_dim)) and the codebooks (standard normal, (num_codebooks,
codebook_size, codebook_dim)) come from `np.random.default_rng(seed)` in
the JAX package's order, so they equal its tensors bit for bit; they are
buffers, not parameters, and are not saved with the model.

- `stack_feats`: (B, T, D) → (B, T // s, s · D) frames stacked by the
  encoder's subsampling rate s, lengths // s;
- `labels`: each codebook's nearest entry to the projected stacked raw
  features, (num_codebooks, B, T2): the argmin of ‖c‖² − 2 p·c
  (euclidean), or the argmax of the normalized product (cosine); equal
  distances take the lower index;
- `span_mask`: starts drawn Bernoulli(mask_proportion / mean_span), each
  start masking a span of static, uniform, normal or poisson length,
  within each utterance's valid frames (B, T2);
- `apply_mask`: masked frames (label rate, expanded × s) of the
  augmented features replaced by N(0, noise_std) noise.

Every draw comes from an explicit `torch.Generator` (`sample_draws`:
starts, span lengths, then the noise), or is given (`draws`), which is
how the tests feed the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Draws = Dict[str, torch.Tensor]


@dataclasses.dataclass
class MaskingStrategyConfig:
    mask_proportion: float = 0.5      # share of the label-rate frames
    mean_span_length: int = 2         # in label-rate frames
    span_distribution: str = "static"  # static | uniform | normal | poisson
    noise_std: float = 0.1


@dataclasses.dataclass
class BestRQConfig:
    feature_dim: int = 80
    stack_size: int = 4               # the encoder's subsampling rate
    num_codebooks: int = 16
    codebook_size: int = 8192
    codebook_dim: int = 16
    distance: str = "euclidean"       # euclidean | cosine
    seed: int = 1234
    masking: MaskingStrategyConfig = dataclasses.field(
        default_factory=MaskingStrategyConfig)


class BestRQLayer(torch.nn.Module):
    """The quantizer and masking of one BEST-RQ config; nothing in it is
    trained."""

    def __init__(self, config: BestRQConfig):
        super().__init__()
        self.cfg = config
        if config.masking.span_distribution not in (
                "static", "uniform", "normal", "poisson"):
            raise ValueError(config.masking.span_distribution)
        rng = np.random.default_rng(config.seed)
        d_in = config.feature_dim * config.stack_size
        limit = np.sqrt(6.0 / (d_in + config.codebook_dim))
        projector = rng.uniform(-limit, limit, (d_in, config.codebook_dim))
        books = rng.standard_normal(
            (config.num_codebooks, config.codebook_size,
             config.codebook_dim)).astype(np.float32)
        self.register_buffer("projector", torch.from_numpy(
            projector.astype(np.float32)), persistent=False)
        self.register_buffer("codebooks", torch.from_numpy(books),
                             persistent=False)

    def stack_feats(self, feats: torch.Tensor, feat_lens: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, D = feats.shape
        s = self.cfg.stack_size
        T2 = T // s
        return feats[:, :T2 * s].reshape(B, T2, s * D), \
            torch.div(feat_lens, s, rounding_mode="floor")

    @torch.no_grad()
    def labels(self, raw_feats: torch.Tensor, feat_lens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw (unmasked) features → (labels (n, B, T2) int64, lens2),
        one codebook at a time (a (B, T2, K) distance tensor each)."""
        stacked, lens2 = self.stack_feats(raw_feats.float(), feat_lens)
        proj = stacked @ self.projector
        books = self.codebooks
        if self.cfg.distance == "cosine":
            proj = proj / (proj.norm(dim=-1, keepdim=True) + 1e-8)
            books = books / (books.norm(dim=-1, keepdim=True) + 1e-8)
            labels = [(proj @ c.T).argmax(dim=-1) for c in books]
        else:
            c2 = books.square().sum(dim=-1)
            labels = [(c2[i] - 2.0 * (proj @ c.T)).argmin(dim=-1)
                      for i, c in enumerate(books)]
        return torch.stack(labels), lens2

    def sample_draws(self, B: int, T2: int, feat_shape: Tuple[int, ...],
                     generator: torch.Generator) -> Draws:
        """The masking's random values, in order: the start Bernoullis
        (B, T2) bool, the span lengths (B, T2) int64, the standard-normal
        noise of `feat_shape`; on the generator's device."""
        m = self.cfg.masking
        mean = max(m.mean_span_length, 1)
        dev = generator.device
        starts = torch.rand((B, T2), generator=generator,
                            device=dev) < m.mask_proportion / mean
        dist = m.span_distribution
        if dist == "static":
            span = torch.full((B, T2), mean, dtype=torch.int64, device=dev)
        elif dist == "uniform":
            span = torch.randint(1, 2 * mean + 1, (B, T2),
                                 generator=generator, device=dev)
        elif dist == "normal":
            span = torch.round(mean + torch.randn(
                (B, T2), generator=generator, device=dev) * mean * 0.5
            ).clamp(1, 4 * mean).long()
        else:
            span = torch.poisson(torch.full((B, T2), float(mean),
                                            device=dev),
                                 generator=generator).clamp(
                1, 6 * mean).long()
        noise = torch.randn(feat_shape, generator=generator, device=dev)
        return {"starts": starts, "span": span, "noise": noise}

    def span_mask(self, starts: torch.Tensor, span: torch.Tensor,
                  lens2: torch.Tensor) -> torch.Tensor:
        """(B, T2) bool: frame t is masked when a start s ≤ t < s + span(s)
        (+1 at each start, −1 at its end, a running sum > 0), within the
        valid frames."""
        B, T2 = starts.shape
        mean = max(self.cfg.masking.mean_span_length, 1)
        W = T2 + 4 * mean + 8
        t_idx = torch.arange(T2, device=starts.device)
        s = starts.long()
        delta = torch.zeros((B, W), dtype=torch.int64, device=starts.device)
        delta[:, :T2] += s
        ends = (t_idx[None, :] + span.long()).clamp(max=W - 1)
        delta.scatter_add_(1, ends, -s)
        mask = delta.cumsum(dim=1)[:, :T2] > 0
        return mask & (t_idx[None, :] < lens2[:, None])

    def apply_mask(self, feats: torch.Tensor, mask2: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
        """Masked frames of (B, T, D) `feats` → `noise` · noise_std."""
        T = feats.shape[1]
        frame = mask2.repeat_interleave(self.cfg.stack_size, dim=1)
        frame = torch.nn.functional.pad(
            frame, (0, max(T - frame.shape[1], 0)))[:, :T]
        return torch.where(frame[..., None],
                           noise * self.cfg.masking.noise_std, feats)

    def forward(self, raw_feats: torch.Tensor, auged_feats: torch.Tensor,
                feat_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Draws] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """(masked features, labels (n, B, T2), mask2 (B, T2), lens2):
        labels from the raw view, the mask applied to the augmented view;
        the draws from `generator` unless given."""
        labels, lens2 = self.labels(raw_feats, feat_lens)
        if draws is None:
            draws = self.sample_draws(raw_feats.shape[0], labels.shape[-1],
                                      tuple(auged_feats.shape), generator)
        mask2 = self.span_mask(draws["starts"], draws["span"], lens2)
        masked = self.apply_mask(auged_feats, mask2, draws["noise"])
        return masked, labels, mask2, lens2
