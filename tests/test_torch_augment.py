"""The port's augmentation (speech2text_torch/data/augment.py) and training
featurize (tasks/base.py) against the JAX package's, given the same
random draws.

JAX draws from its PRNG keys; the port draws from a torch.Generator. So
each test reproduces JAX's draws from its key here (the same
jax.random.split sequence as speech2text_tpu/tasks/base.py:84-85 and
data/augment.py) and feeds them to the port's deterministic apply
functions. Tolerances: SpecAugment exact; mix_feats and add_noise
rtol = atol = 1e-5; the whole training featurize (CPU, plain fbank) at
the fbank parity tolerance of tests/test_torch_fbank.py, rtol 1e-4 /
atol 1e-3: the two packages' f32 DFT products sum in different orders,
and the fbank alone differs from JAX's by up to 2.5e-4 on these inputs.
The port's samplers are checked for their ranges and their determinism.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.data import augment as jaug
from speech2text_tpu.data.frontend import feat_lengths as j_feat_lengths
from speech2text_tpu.tasks.base import AsrTaskBase as JTaskBase
from speech2text_torch.data import augment as taug
from speech2text_torch.ops import fbank as tfb
from speech2text_torch.tasks.base import Featurizer

TOL = dict(rtol=1e-5, atol=1e-5)
FBANK_TOL = dict(rtol=1e-4, atol=1e-3)
AUG = {"use_speed_perturb": True, "use_spec_aug": True,
       "use_add_noise": True, "add_noise_proportion": 0.5,
       "add_noise_config": {"min_snr_db": 10, "max_snr_db": 50},
       "use_mix_feats": True, "mix_feats_proportion": 0.5,
       "mix_feats_config": {"snrs": [10, 20]}}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def jax_spec_draws(key, feat_lens, D, nT=2, tmax=50, nF=2, fmax=10):
    """augment.spec_augment's draws from `key`, as (B, masks)."""
    B = feat_lens.shape[0]
    kt, kw, kf, kfw = jax.random.split(key, 4)
    tw = jax.random.randint(kw, (B, nT, 1), 0, tmax + 1)
    max_start = jnp.maximum(feat_lens[:, None, None] - tw, 1)
    ts = (jax.random.uniform(kt, (B, nT, 1))
          * max_start.astype(jnp.float32)).astype(jnp.int32)
    fw = jax.random.randint(kfw, (B, nF, 1), 0, fmax + 1)
    fs = jax.random.randint(kf, (B, nF, 1), 0, max(D - fmax, 1))
    return {"time_start": _t(ts[..., 0]), "time_width": _t(tw[..., 0]),
            "freq_start": _t(fs[..., 0]), "freq_width": _t(fw[..., 0])}


def jax_mix_draws(key, apply_key, p, noise_lens, snrs):
    B = noise_lens.shape[0]
    apply = jax.random.bernoulli(apply_key, p, (B,))
    k_snr, k_off = jax.random.split(key)
    snr = jnp.asarray(snrs, jnp.float32)[
        jax.random.randint(k_snr, (B,), 0, len(snrs))]
    off = jax.random.randint(k_off, (B,), 0, jnp.maximum(noise_lens, 1))
    return {"apply": _t(apply), "snr": _t(snr), "offset": _t(off)}


def jax_noise_draws(key, apply_key, p, noise_lens, lo, hi):
    B = noise_lens.shape[0]
    apply = jax.random.bernoulli(apply_key, p, (B,))
    k_snr, k_off = jax.random.split(key)
    snr = jax.random.uniform(k_snr, (B,), minval=lo, maxval=hi)
    off = jax.random.randint(k_off, (B,), 0, jnp.maximum(noise_lens, 1))
    return {"apply": _t(apply), "snr": _t(snr), "offset": _t(off)}


@pytest.mark.parametrize("seed,apply", [(0, False), (1, True), (2, True)])
def test_spec_augment_exact(seed, apply):
    rng = np.random.default_rng(seed)
    B, T, D = 5, 120, 80
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.array([120, 90, 31, 7, 60], np.int32)
    key = jax.random.PRNGKey(seed)
    mask = rng.random(B) < 0.5 if apply else None
    want = jaug.spec_augment(jnp.asarray(feats), jnp.asarray(lens), key,
                             apply=None if mask is None
                             else jnp.asarray(mask))
    draws = jax_spec_draws(key, jnp.asarray(lens), D)
    got = taug.spec_augment(_t(feats), draws,
                            None if mask is None else _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got == 0).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_mix_feats_given_draws(seed):
    rng = np.random.default_rng(seed)
    B, T, Tn, D = 6, 90, 40, 80
    feats = rng.normal(-2.0, 3.0, (B, T, D)).astype(np.float32)
    noise = rng.normal(-4.0, 2.0, (B, Tn, D)).astype(np.float32)
    lens = np.array([90, 70, 45, 12, 90, 3], np.int32)
    nlens = np.array([40, 33, 1, 25, 40, 17], np.int32)
    key, akey = jax.random.split(jax.random.PRNGKey(seed + 10))
    apply = jax.random.bernoulli(akey, 0.5, (B,))
    want = jaug.mix_feats(jnp.asarray(feats), jnp.asarray(lens),
                          jnp.asarray(noise), jnp.asarray(nlens), key,
                          snrs=(10.0, 20.0), apply=apply)
    draws = jax_mix_draws(key, akey, 0.5, jnp.asarray(nlens), (10.0, 20.0))
    got = taug.mix_feats(_t(feats), _t(lens), _t(noise), _t(nlens), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert 0 < int(draws["apply"].sum()) < B or seed != 0


@pytest.mark.parametrize("seed", [0, 1])
def test_add_noise_given_draws(seed):
    rng = np.random.default_rng(seed)
    B, N, Nn = 5, 4000, 1700
    pcm = (0.3 * rng.standard_normal((B, N))).clip(-1, 1).astype(np.float32)
    noise = (0.5 * rng.standard_normal((B, Nn))).astype(np.float32)
    lens = np.array([4000, 3100, 1500, 900, 10], np.int32)
    nlens = np.array([1700, 1234, 800, 1, 1700], np.int32)
    key, akey = jax.random.split(jax.random.PRNGKey(seed + 20))
    apply = jax.random.bernoulli(akey, 0.5, (B,))
    want = jaug.add_noise(jnp.asarray(pcm), jnp.asarray(lens),
                          jnp.asarray(noise), jnp.asarray(nlens), key,
                          min_snr_db=0.0, max_snr_db=5.0, apply=apply)
    draws = jax_noise_draws(key, akey, 0.5, jnp.asarray(nlens), 0.0, 5.0)
    got = taug.add_noise(_t(pcm), _t(lens), _t(noise), _t(nlens), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _featurize_config():
    return {"tokenizer": {"type": "char"},
            "dataset": {"feat_type": "lhotes_fbank",
                        "feat_config": {"num_mel_bins": 80,
                                        "snip_edges": True},
                        "data_aug_config": AUG}}


def _noisy_batch(seed, B=4, N=24000, Nn=13000):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / 16000
    pcm = np.zeros((B, N), np.float32)
    lens = np.array([N, 17000, 9001, 4000][:B], np.int32)
    for b in range(B):
        x = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t) \
            + 0.02 * rng.standard_normal(N)
        pcm[b, :lens[b]] = x[:lens[b]]
    noise = (0.1 * rng.standard_normal((B, Nn))).astype(np.float32)
    nlens = np.array([Nn, 8000, 5500, Nn][:B], np.int32)
    noise[np.arange(Nn)[None] >= nlens[:, None]] = 0.0
    q = lambda x: np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    return {"pcm": q(pcm), "pcm_length": lens, "label": np.ones((B, 4),
                                                                 np.int32),
            "label_length": np.full((B,), 4, np.int32),
            "noise_pcm": q(noise), "noise_length": nlens}


@pytest.mark.parametrize("seed", [0, 3])
def test_training_featurize_given_jax_draws(seed):
    """add_noise → fbank → mix_feats → CMVN → SpecAugment, JAX's order
    and draws (tasks/base.py:84-114), on the CPU's plain fbank."""
    cfg = _featurize_config()
    jtask = JTaskBase(cfg)
    batch = _noisy_batch(seed)
    rng = jax.random.PRNGKey(seed + 100)
    want, want_lens = jtask.featurize(
        {k: jnp.asarray(v) for k, v in batch.items()}, rng, training=True)

    k_noise, k_apply1, k_mix, k_apply2, k_spec, _ = jax.random.split(rng, 6)
    fcfg = jtask.frontend.cfg
    nlens = j_feat_lengths(fcfg, jnp.asarray(batch["noise_length"]))
    flens = j_feat_lengths(fcfg, jnp.asarray(batch["pcm_length"]))
    draws = {
        "add_noise": jax_noise_draws(
            k_noise, k_apply1, 0.5, jnp.asarray(batch["noise_length"]),
            10.0, 50.0),
        "mix_feats": jax_mix_draws(k_mix, k_apply2, 0.5, nlens,
                                   (10.0, 20.0)),
        "spec_augment": jax_spec_draws(k_spec, flens, 80)}
    feat = Featurizer(cfg)
    got, got_lens = feat.featurize({k: _t(v) for k, v in batch.items()},
                                   training=True, draws=draws)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FBANK_TOL)
    # SpecAugment's zeros fall on the same elements
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)
    # every transform took part
    assert bool(draws["add_noise"]["apply"].any())
    assert bool(draws["mix_feats"]["apply"].any())


def test_eval_featurize_is_plain_fbank():
    cfg = _featurize_config()
    batch = {k: _t(v) for k, v in _noisy_batch(1).items()}
    feat = Featurizer(cfg)
    a, _ = feat.featurize(batch, torch.Generator().manual_seed(0),
                          training=False)
    b, _ = feat.featurize(batch)
    assert torch.equal(a, b)
    c, _ = feat.featurize(batch, torch.Generator().manual_seed(0),
                          training=True)
    assert not torch.equal(a, c)


def test_sampled_featurize_is_deterministic():
    """featurize with a generator equals featurize with the draws that
    `sample_augmentation` takes from the same generator state."""
    feat = Featurizer(_featurize_config())
    batch = {k: _t(v) for k, v in _noisy_batch(2).items()}
    a, _ = feat.featurize(batch, torch.Generator().manual_seed(7), True)
    g = torch.Generator().manual_seed(7)
    draws = feat.sample_augmentation(batch, g)
    b, _ = feat.featurize(batch, training=True, draws=draws)
    assert torch.equal(a, b)
    assert set(draws) == {"add_noise", "mix_feats", "spec_augment"}


def test_samplers_ranges():
    g = torch.Generator().manual_seed(0)
    B = 4000
    lens = torch.randint(1, 600, (B,), generator=g)
    d = taug.sample_spec_augment(lens, 80, g)
    assert d["time_width"].min() >= 0 and d["time_width"].max() == 50
    assert d["freq_width"].min() == 0 and d["freq_width"].max() == 10
    assert (d["time_start"] >= 0).all()
    assert (d["time_start"] < torch.clamp(lens[:, None] - d["time_width"],
                                          min=1)).all()
    assert d["freq_start"].min() == 0 and d["freq_start"].max() == 69
    nl = torch.randint(0, 1000, (B,), generator=g)
    m = taug.sample_mix_feats(nl, g, p=0.3, snrs=(10.0, 20.0))
    assert set(m["snr"].tolist()) == {10.0, 20.0}
    assert abs(float(m["apply"].float().mean()) - 0.3) < 0.03
    assert (m["offset"] >= 0).all() and (
        m["offset"] < torch.clamp(nl, min=1)).all()
    n = taug.sample_add_noise(nl, g, p=0.5, min_snr_db=10, max_snr_db=50)
    assert n["snr"].min() >= 10 and n["snr"].max() < 50
    assert abs(float(n["apply"].float().mean()) - 0.5) < 0.03
    assert (n["offset"] < torch.clamp(nl, min=1)).all()
    # one generator state, one set of draws
    a = taug.sample_add_noise(nl, torch.Generator().manual_seed(3), 0.5)
    b = taug.sample_add_noise(nl, torch.Generator().manual_seed(3), 0.5)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_offsets_stay_in_range_for_long_clips():
    lens = torch.full((64,), 160_000, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        off = taug.sample_offsets(lens, g)
        assert (off >= 0).all() and (off < 160_000).all()


def test_dither_plain_only(monkeypatch):
    """dither > 0 adds Gaussian frame noise in training only; the wrapper
    draws it once from the generator and a CUDA-routed call hands the
    kernel the very noise the plain route adds, with its scale."""
    cfg = _featurize_config()
    cfg["dataset"]["feat_config"]["dither"] = 0.5
    feat = Featurizer(cfg)
    batch = {k: _t(v) for k, v in _noisy_batch(0).items()}
    clean, _ = Featurizer(_featurize_config()).featurize(batch)
    noisy, _ = feat.featurize(batch, torch.Generator().manual_seed(0),
                              training=True, draws={})
    assert not torch.equal(clean, noisy)
    evald, _ = feat.featurize(batch)
    assert torch.equal(evald, clean)
    fb = feat.frontend
    x = torch.zeros((1, 800))
    args = (x, fb.window, fb.dft_cos, fb.dft_sin, fb.banks, 3)
    want_noise = tfb.dither_noise(1, 3, 400, torch.Generator().manual_seed(9),
                                  "cpu")
    plain = tfb.fbank(*args, dither=0.5,
                      generator=torch.Generator().manual_seed(9))
    assert torch.equal(plain, tfb.fbank_plain(*args, 400, 160, 0.97, True,
                                              True, want_noise, 0.5))
    seen = []

    def recorded(*a):
        seen.append(a)
        return tfb.fbank_plain(*a)

    monkeypatch.setattr(tfb, "use_kernel", lambda device: True)
    monkeypatch.setattr(tfb, "fbank_cuda", recorded)
    routed = tfb.fbank(*args, dither=0.5,
                       generator=torch.Generator().manual_seed(9))
    (a,) = seen
    assert torch.equal(a[11], want_noise) and a[12] == 0.5
    assert torch.equal(routed, plain)


def _dither_config():
    cfg = _featurize_config()
    cfg["dataset"]["feat_config"]["dither"] = 1.0 / 32768
    return cfg


@pytest.mark.parametrize("seed", [0, 3])
def test_training_featurize_dither_given_jax_draws(seed):
    """The whole training featurize with dither (one int16 step): JAX's
    Featurizer with a key against the port given JAX's draws, its dither
    noise `jax.random.normal(k_dither, frames.shape)` among them; and
    `sample_augmentation` draws the noise last, so featurize with a
    generator equals featurize with the draws from the same state."""
    cfg = _dither_config()
    jtask = JTaskBase(cfg)
    batch = _noisy_batch(seed)
    rng = jax.random.PRNGKey(seed + 200)
    want, _ = jtask.featurize(
        {k: jnp.asarray(v) for k, v in batch.items()}, rng, training=True)
    k_noise, k_apply1, k_mix, k_apply2, k_spec, k_dither = \
        jax.random.split(rng, 6)
    fcfg = jtask.frontend.cfg
    B, N = batch["pcm"].shape
    nlens = j_feat_lengths(fcfg, jnp.asarray(batch["noise_length"]))
    flens = j_feat_lengths(fcfg, jnp.asarray(batch["pcm_length"]))
    draws = {
        "add_noise": jax_noise_draws(
            k_noise, k_apply1, 0.5, jnp.asarray(batch["noise_length"]),
            10.0, 50.0),
        "mix_feats": jax_mix_draws(k_mix, k_apply2, 0.5, nlens,
                                   (10.0, 20.0)),
        "spec_augment": jax_spec_draws(k_spec, flens, 80),
        "dither": _t(jax.random.normal(
            k_dither, (B, fcfg.num_frames(N), fcfg.frame_length)))}
    feat = Featurizer(cfg)
    tb = {k: _t(v) for k, v in batch.items()}
    got, _ = feat.featurize(tb, training=True, draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FBANK_TOL)
    undithered, _ = feat.featurize(tb, training=True, draws=dict(
        draws, dither=torch.zeros_like(draws["dither"])))
    assert not torch.equal(got, undithered)
    a, _ = feat.featurize(tb, torch.Generator().manual_seed(4), True)
    sampled = feat.sample_augmentation(tb, torch.Generator().manual_seed(4))
    assert list(sampled) == ["add_noise", "mix_feats", "spec_augment",
                             "dither"]
    b, _ = feat.featurize(tb, training=True, draws=sampled)
    assert torch.equal(a, b)
