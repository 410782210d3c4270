"""The SSL (BEST-RQ) task family of the port (speech2text_torch/models/
best_rq.py, tasks/ssl.py, the SSL → CTC finetune chain) against the JAX
package's, on the CPU. Tolerances: f32 rtol 1e-5 / atol 1e-6; frozen
tensors, masks and labels exact (labels: but at near ties, below).

JAX draws the masking from PRNG keys, the port from a torch.Generator;
the tests reproduce JAX's draws from its key (the split sequence of
speech2text_tpu/models/best_rq.py:__call__ and span_mask) and feed them
to the port (`draws`). The projected features are f32 matmuls that sum
in different orders in XLA and torch, so a label may differ where a
codebook's best and second-best distances are within 1e-5 of each other
(relative); those near ties are counted and printed, every other label
is equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_torch import build_task
from speech2text_torch.convert import to_flax
from speech2text_torch.models.best_rq import BestRQConfig, BestRQLayer, \
    MaskingStrategyConfig
from speech2text_torch.tasks.ctc import CtcTask
from speech2text_torch.tasks.ssl import SslTask

from conformer_task_util import BEST_RQ, make_corpus, metrics_lines, \
    ssl_config, tiny_recipe_argv

TOL = dict(rtol=1e-5, atol=1e-6)
NEAR_TIE = 1e-5
DISTS = ("static", "uniform", "normal", "poisson")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _layers(dist="static", distance="euclidean", **kw):
    from speech2text_tpu.models import best_rq as jbrq
    masking = dict(mask_proportion=0.5, mean_span_length=2,
                   span_distribution=dist)
    cfg = dict(feature_dim=80, stack_size=4, num_codebooks=4,
               codebook_size=512, codebook_dim=16, distance=distance, **kw)
    return (BestRQLayer(BestRQConfig(
        **cfg, masking=MaskingStrategyConfig(**masking))),
            jbrq.BestRQLayer(jbrq.BestRQConfig(
                **cfg, masking=jbrq.MaskingStrategyConfig(**masking))))


def jax_draws(jlayer, key, B, T2, feat_shape):
    """JAX's masking draws from `key` (best_rq.py:__call__ → span_mask,
    apply_mask), as the port's `draws`."""
    m = jlayer.cfg.masking
    k_mask, k_noise = jax.random.split(key)
    k_start, k_len = jax.random.split(k_mask)
    mean = max(m.mean_span_length, 1)
    starts = jax.random.bernoulli(k_start, m.mask_proportion / mean, (B, T2))
    if m.span_distribution == "static":
        span = jnp.full((B, T2), mean, jnp.int32)
    elif m.span_distribution == "uniform":
        span = jax.random.randint(k_len, (B, T2), 1, 2 * mean + 1)
    elif m.span_distribution == "normal":
        span = jnp.clip(jnp.round(mean + jax.random.normal(k_len, (B, T2))
                                  * mean * 0.5), 1, 4 * mean).astype(
            jnp.int32)
    else:
        span = jnp.clip(jax.random.poisson(k_len, mean, (B, T2)), 1,
                        6 * mean).astype(jnp.int32)
    return {"starts": _t(starts), "span": _t(span).long(),
            "noise": _t(jax.random.normal(k_noise, feat_shape))}


def test_frozen_projector_and_codebooks_equal():
    """The YAML's quantizer (16 codebooks × 8192 × 16 over 4 × 80) and a
    small one with another seed: bit for bit."""
    from speech2text_tpu.models import best_rq as jbrq
    for kw in ({}, {"num_codebooks": 2, "codebook_size": 16, "seed": 7}):
        layer = BestRQLayer(BestRQConfig(**kw))
        jlayer = jbrq.BestRQLayer(jbrq.BestRQConfig(**kw))
        assert torch.equal(layer.projector, _t(jlayer.projector))
        assert torch.equal(layer.codebooks, _t(jlayer.codebooks))
        assert layer.state_dict() == {}      # never saved with the model


def _feats(seed, B=4, T=203):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, 80)).astype(np.float32)
    lens = np.array([T, 150, 97, 61][:B], np.int32)
    return feats, lens


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_labels_match_jax(distance):
    """Stacking (T=203 → T2=50, lengths // 4) and labels of 4 codebooks
    of 512: equal but for near ties, which are counted."""
    layer, jlayer = _layers(distance=distance)
    feats, lens = _feats(1)
    want, want_lens = jlayer.labels(jnp.asarray(feats), jnp.asarray(lens))
    got, got_lens = layer.labels(_t(feats), _t(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == (4, 4, 50)
    want = np.asarray(want)
    stacked, _ = layer.stack_feats(_t(feats), _t(lens))
    proj = (stacked @ layer.projector).double()
    books = layer.codebooks.double()
    if distance == "cosine":
        proj = proj / (proj.norm(dim=-1, keepdim=True) + 1e-8)
        books = books / (books.norm(dim=-1, keepdim=True) + 1e-8)
        score = -torch.einsum("btc,nkc->nbtk", proj, books)
    else:
        score = books.square().sum(-1)[:, None, None, :] - 2 * torch.einsum(
            "btc,nkc->nbtk", proj, books)
    top2 = score.topk(2, dim=-1, largest=False).values
    gap = (top2[..., 1] - top2[..., 0]) / top2[..., 0].abs().clamp(min=1e-12)
    near = gap.numpy() <= NEAR_TIE
    differ = got.numpy() != want
    print(f"{distance}: {int(near.sum())} near ties of {near.size} labels, "
          f"{int(differ.sum())} labels differ")
    assert not (differ & ~near).any()


@pytest.mark.parametrize("dist", DISTS)
def test_span_mask_given_jax_draws(dist):
    """JAX's span mask from its draws, equal; the port's sampler and
    JAX's reach the configured share within a band on a seeded batch
    (B=64, T2=250, lengths 150-250): the expected share of a start rate
    of 0.25 with spans of mean 2 is about 0.44 (static), so the band is
    0.3-0.6, and the two samplers within 0.03 of each other."""
    layer, jlayer = _layers(dist)
    B, T2 = 64, 250
    lens2 = np.random.default_rng(3).integers(150, T2 + 1, B).astype(
        np.int32)
    key = jax.random.PRNGKey(5)
    k_mask, _ = jax.random.split(key)
    want = np.asarray(jlayer.span_mask(k_mask, B, T2, jnp.asarray(lens2)))
    draws = jax_draws(jlayer, key, B, T2, (1, 1))
    got = layer.span_mask(draws["starts"], draws["span"], _t(lens2)).numpy()
    np.testing.assert_array_equal(got, want)
    sampled = layer.sample_draws(B, T2, (1, 1),
                                 torch.Generator().manual_seed(5))
    mine = layer.span_mask(sampled["starts"], sampled["span"], _t(lens2))
    share = {"port": float(mine.sum()) / lens2.sum(),
             "jax": float(want.sum()) / lens2.sum()}
    print(dist, share)
    assert all(0.3 <= v <= 0.6 for v in share.values()), share
    assert abs(share["port"] - share["jax"]) < 0.03, share
    assert not (mine.numpy() & (np.arange(T2)[None] >= lens2[:, None])).any()


def test_best_rq_layer_given_jax_draws():
    """The layer's call (labels from the raw view, the mask with noise
    on the augmented view) given JAX's key's draws."""
    layer, jlayer = _layers("uniform")
    raw, lens = _feats(2)
    auged = raw + np.float32(0.5)
    key = jax.random.PRNGKey(9)
    want = jlayer(key, jnp.asarray(raw), jnp.asarray(auged),
                  jnp.asarray(lens))
    draws = jax_draws(jlayer, key, 4, 50, auged.shape)
    got = layer(_t(raw), _t(auged), _t(lens), draws=draws)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert (got[0].numpy() != auged).any() and got[2].any()
    assert (got[1].numpy() == np.asarray(want[1])).mean() > 0.99


def _batch(task, seed):
    it = iter(task.make_train_pipeline(seed=seed))
    batch = next(it)
    it.close()
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def test_ssl_task_matches_jax(corpus, tmp_path, monkeypatch):
    """SslTask's training loss, acc and mask_rate against JAX's loss_fn,
    and its evaluation's val_loss and acc against JAX's eval_forward, with
    JAX's features (raw, and augmented with its draws) and JAX's masking
    draws fed to the port; both loss selections."""
    from speech2text_tpu.tasks.ssl import SslTask as JTask
    cfg = ssl_config(corpus, str(tmp_path / "ssl"))
    cfg["dataset"]["data_aug_config"] = {
        "use_speed_perturb": True, "use_spec_aug": True}
    task = SslTask(cfg)
    task.model.init_weights(torch.Generator().manual_seed(4))
    params = jax.tree.map(jnp.asarray, to_flax(task.model))
    jtask = JTask(cfg)
    batch = _batch(task, 2)
    jbatch = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(3)
    k_aug, k_mask, _ = jax.random.split(rng, 3)
    raw, lens = jtask.featurize(jbatch, None, training=False)
    auged, _ = jtask.featurize(jbatch, k_aug, training=True)
    views = {False: (raw, lens), True: (auged, lens)}
    monkeypatch.setattr(jtask, "featurize",
                        lambda b, k, training: views[training])
    monkeypatch.setattr(task, "featurize", lambda b, g=None, training=False,
                        draws=None: tuple(_t(x) for x in views[training]))
    T2 = raw.shape[1] // 4
    tbatch = {k: _t(v) for k, v in batch.items()}
    for selection in ("mask_loss", "all"):
        jtask.loss_selection = task.loss_selection = selection
        loss, metrics = jax.jit(jtask.loss_fn)(params, jbatch, rng, 0)
        draws = jax_draws(jtask.best_rq, k_mask, raw.shape[0], T2,
                          raw.shape)
        inputs = task.masked_inputs(tbatch, None, {"mask": draws})
        got = task.train_losses(*inputs)
        np.testing.assert_allclose(got["loss"].item(), float(loss), **TOL)
        for k in ("acc", "mask_rate"):
            np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                       **TOL, err_msg=k)
        assert int(got["frames"]) == int(metrics["frames"])
        assert 0.2 < float(got["mask_rate"]) < 0.7
    want = jax.jit(jtask.eval_forward)(params, jbatch)
    draws = jax_draws(jtask.best_rq, jax.random.PRNGKey(0), raw.shape[0],
                      T2, raw.shape)
    out = task.eval_forward(tbatch, draws=draws)
    assert set(out) == {"val_loss", "acc"}
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(want[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["conformer_ssl", "conformer_ssl_heldout"])
def test_build_task_ssl_yaml_then_ctc_finetune(corpus, tmp_path, name):
    """build_task's main on the SSL YAML at tiny dims, 2 codebooks × 16:
    two steps with acc and mask_rate, an evaluation with val_loss and acc,
    a checkpoint kept by acc; then conformer_ctc.yaml finetuned from that
    checkpoint: every encoder tensor copied, logits_layer not."""
    argv = tiny_recipe_argv(f"configs/training/{name}.yaml", corpus,
                            str(tmp_path)) + [
        "--override", "ssl.best_rq.num_codebooks=2",
        "--override", "ssl.best_rq.codebook_size=16"]
    trainer = build_task.main(argv)
    task = trainer.task
    assert isinstance(task, SslTask) and trainer.clip == 5.0
    assert task.best_rq.codebooks.shape == (2, 16, 16)
    assert (trainer.ckpt.monitor, trainer.ckpt.mode) == ("acc", "max")
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite([r["loss"], r["acc"], r["mask_rate"],
                            r["grad_norm"]]).all() for r in lines)
    assert set(trainer.last_eval) == {"val_loss", "acc"}
    ckpt = trainer.ckpt.path(2)
    assert os.path.exists(ckpt)

    ctc = build_task.prepare(tiny_recipe_argv(
        "configs/training/conformer_ctc.yaml", corpus,
        str(tmp_path / "ctc")) + [
        "--override", f"tokenizer.config.spm_model={corpus['spm_model']}",
        "--override", "tokenizer.apply_train=false",
        "--override", "decoder.config.input_dim=32",
        "--override", f"decoder.config.num_classes={corpus['vocab']}",
        "--override", f"finetune.base_model={ckpt}"])
    ft, kw = ctc
    assert isinstance(ft.task, CtcTask)
    base = kw["finetune_state"]
    encoder = [k for k in base if k.startswith("encoder.")]
    assert set(base) - set(encoder) == {"logits_layer.weight",
                                         "logits_layer.bias"}
    ft.init_state(finetune_state=base)
    live = ft.task.model.state_dict()
    assert ft.finetune_copied == len(encoder) == len(
        [k for k in live if k.startswith("encoder.")]) > 30
    assert all(torch.equal(live[k], base[k]) for k in encoder)
    assert not any(k.startswith("logits_layer") for k in live)
    ft.close()
