"""The port's flagship train step (speech2text_torch/train/step.py)
against the JAX package's `bench.py:one_step` at
`__graft_entry__._tiny_config`, and the training forward's dropout
semantics.

Three f32 steps fbank → model (training mode, dropout and feature mask at
0, the chunk fixed) → 0.5·simple + 0.5·pruned → ScaledAdam + Eden, from
the same weights (convert.to_flax), JAX's attention weights through its
Pallas kernel (interpret mode, with its custom_vjp). Tolerances: each
step's losses rtol 1e-5; parameters after step 3 rtol 1e-4 with atol
1e-5 (a ScaledAdam step moves a parameter by lr·rms·g/denom, and an
element whose gradient is near 0 sees that ratio move with f32 rounding).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _build_model, _tiny_config
from speech2text_tpu.data import frontend as jf
from speech2text_tpu.losses import Loss as JLoss
from speech2text_tpu.optim import OptimSetup as JOptimSetup
from speech2text_torch.convert import to_flax
from speech2text_torch.models import zipformer as tz
from speech2text_torch.models.layers import init_parameters
from speech2text_torch.tasks.rnnt import sample_chunk
from speech2text_torch.train.step import TrainStep

VOCAB = 64
CHUNK = (8, 4)          # chunk_size 8, left context 32 frames = 4 chunks


def _config(dropout=0.0, mask_prob=0.0):
    cfg = _tiny_config(VOCAB)
    cfg["encoder"]["config"].update(dropout=dropout,
                                    feature_mask_dropout_prob=mask_prob)
    cfg["dataset"] = {"feat_type": "lhotes_fbank",
                      "feat_config": {"num_mel_bins": 80,
                                      "snip_edges": True}}
    cfg["loss"] = {"model": "Pruned_Rnnt", "simple_loss_scale": 0.5,
                   "pruned_loss_scale": 0.5,
                   "config": {"termination_symbol": 0, "reduction": "mean"},
                   "enable_ctc": False}
    cfg["optim_setup"] = {
        "optimizer": {"type": "ScaledAdam",
                      "config": {"lr": 0.045, "clipping_scale": 2.0}},
        "lr_scheduler": {"type": "Eden", "config": {"lr_batches": 7000}}}
    return cfg


def _batch(seed=0, B=2, N=16000, U=6):
    rng = np.random.default_rng(seed)
    pcm = (0.1 * rng.standard_normal((B, N))).astype(np.float32)
    lens = np.array([N, 3 * N // 4], np.int32)
    labels = rng.integers(1, VOCAB, (B, U)).astype(np.int32)
    label_lens = np.array([U, U - 2], np.int32)
    return pcm, lens, labels, label_lens


def _jax_steps(cfg, params, batch, n):
    jcfg = copy.deepcopy(cfg)
    jcfg["encoder"]["config"].update(use_flash_attn=True, flash_min_batch=0)
    model = _build_model(jcfg)
    fbank = jf.Fbank(jf.FbankConfig(num_mel_bins=80, snip_edges=True),
                     use_pallas=False)
    loss_obj = JLoss({"model": "Pruned_Rnnt", "config": cfg["loss"]["config"]})
    tx, _ = JOptimSetup(cfg["optim_setup"])
    pcm, lens, labels, lab_lens = map(jnp.asarray, batch)
    cs, lc = (jnp.asarray(c, jnp.int32) for c in CHUNK)

    @jax.jit
    def one_step(params, opt_state):
        feats, feat_lens = fbank(pcm, lens)

        def lf(p):
            out = model.apply({"params": p}, feats, feat_lens, labels,
                              lab_lens, deterministic=False, chunk_size=cs,
                              left_context_chunks=lc,
                              rngs={"dropout": jax.random.PRNGKey(0)})
            pruned = loss_obj({"logits": out["logits"],
                               "ranges": out["ranges"],
                               "logits_length": out["enc_lens"],
                               "label": labels, "label_length": lab_lens})
            return 0.5 * out["simple_loss"] + 0.5 * pruned, (
                out["simple_loss"], pruned)

        (loss, aux), grads = jax.value_and_grad(lf, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, (loss, *aux)

    opt_state = tx.init(params)
    losses = []
    for _ in range(n):
        params, opt_state, ls = one_step(params, opt_state)
        losses.append([float(x) for x in ls])
    return losses, params


def test_three_steps_match_jax():
    cfg = _config()
    batch = _batch()
    ts = TrainStep.from_config(cfg, device="cpu", seed=3)
    params = jax.tree.map(jnp.asarray, to_flax(ts.model))
    want_losses, want_params = _jax_steps(cfg, params, batch, 3)
    for i in range(3):
        out = ts.step(*batch, chunk=CHUNK)
        got = [out[k].item() for k in ("loss", "simple_loss", "pruned_loss")]
        np.testing.assert_allclose(got, want_losses[i], rtol=1e-5,
                                   err_msg=f"step {i}")
    assert want_losses[2][0] < want_losses[0][0]
    got_params = to_flax(ts.model)
    flat_w = jax.tree_util.tree_flatten_with_path(want_params)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got_params)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


# ------------------------------------------------------ dropout semantics
def test_dropout_share_and_scale():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = tz.dropout(x, 0.2, True, g)
    zeros = float((y == 0).float().mean())
    assert abs(zeros - 0.2) < 0.01
    assert torch.allclose(y[y != 0], torch.tensor(1.0 / 0.8))
    assert tz.dropout(x, 0.2, False, g) is x
    assert tz.dropout(x, 0.0, True, g) is x
    yb = tz.dropout(x.bfloat16(), 0.2, True, g)
    assert yb.dtype == torch.bfloat16


def _encoder(dropout, mask_prob):
    cfg = _config(dropout, mask_prob)["encoder"]["config"]
    enc = tz.Zipformer2(tz.Zipformer2Config.from_config(cfg))
    init_parameters(enc, torch.Generator().manual_seed(1))
    return enc


def _feats(B=6, T=60):
    rng = np.random.default_rng(2)
    return (torch.from_numpy(rng.standard_normal((B, T, 80))
                             .astype(np.float32)),
            torch.full((B,), T, dtype=torch.int64))


def test_feature_mask_whole_utterances_above_unmasked_dim():
    """With dropout off, the feature mask zeroes channels at or above
    encoder_unmasked_dim (24 of the tiny encoder's 32/64) of whole
    utterances; an utterance it keeps gives the serving output."""
    enc = _encoder(0.0, 0.5)
    feats, lens = _feats()
    with torch.no_grad():
        out, _ = enc(feats, lens, *CHUNK, training=True,
                     generator=torch.Generator().manual_seed(5))
        ref, _ = enc(feats, lens, *CHUNK)
    # the mask's draw: the first the generator gives
    keep = (torch.rand((feats.shape[0], 1, 1),
                       generator=torch.Generator().manual_seed(5))
            < 0.5)[:, 0, 0]
    assert 0 < int(keep.sum()) < feats.shape[0]
    um = enc.config.encoder_unmasked_dim[-1]
    assert torch.equal(out[keep], ref[keep])
    assert bool((out[~keep][..., um:] == 0).all())
    assert float(out[~keep][..., :um].abs().min()) >= 0.0
    assert bool((out[~keep][..., :um] != 0).any())


def test_same_seed_same_masks_and_eval_is_serving():
    enc = _encoder(0.3, 0.3)
    feats, lens = _feats()
    with torch.no_grad():
        a, _ = enc(feats, lens, *CHUNK, training=True,
                   generator=torch.Generator().manual_seed(7))
        b, _ = enc(feats, lens, *CHUNK, training=True,
                   generator=torch.Generator().manual_seed(7))
        c, _ = enc(feats, lens, *CHUNK, training=True,
                   generator=torch.Generator().manual_seed(8))
        serve, _ = enc(feats, lens, *CHUNK)
        off, _ = enc(feats, lens, *CHUNK, training=False,
                     generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(off, serve) and not torch.equal(a, serve)


def test_masks_do_not_touch_the_global_rng():
    enc = _encoder(0.3, 0.3)
    feats, lens = _feats(B=2, T=40)
    torch.manual_seed(0)
    before = torch.rand(3)
    torch.manual_seed(0)
    with torch.no_grad():
        enc(feats, lens, training=True,
            generator=torch.Generator().manual_seed(1))
    assert torch.equal(torch.rand(3), before)


def test_chunk_sampling_and_unported_options():
    enc_cfg = tz.Zipformer2Config.from_config(
        _config()["encoder"]["config"])
    assert enc_cfg.chunk_size == (8, -1)
    g = torch.Generator().manual_seed(0)
    seen = {sample_chunk(enc_cfg, g) for _ in range(40)}
    assert seen == {(8, 4), (8, -1), (-1, -1)}
    assert sample_chunk(dataclasses.replace(enc_cfg, causal=False),
                        g) == (-1, -1)
    assert sample_chunk(dataclasses.replace(enc_cfg, chunk_size=(-1,)),
                        g) == (-1, -1)
    bad = _config()
    bad["task"] = {"type": "CTC"}
    with pytest.raises(NotImplementedError):
        TrainStep.from_config(bad, device="cpu")
    bad = _config()
    bad["task"] = {"type": "Rnnt"}      # a pruned joiner on the full task
    with pytest.raises(ValueError, match="prune_range"):
        TrainStep.from_config(bad, device="cpu")
