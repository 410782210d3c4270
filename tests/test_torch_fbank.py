"""Fbank port (speech2text_torch/data/frontend.py, ops/fbank.py) against
the JAX frontend: the jnp `_fbank_impl` path, the Pallas kernel in
interpret mode, and the float64 numpy oracle, with the tolerances of
tests/test_pallas_fbank.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.data import frontend as jf
from speech2text_tpu.ops.pallas.fbank_kernel import (build_operands,
                                                     fbank_pallas)
from speech2text_torch.data import frontend as tf
from speech2text_torch.ops import fbank as tfb
from speech2text_torch.ops.fbank import fbank_plain

JNP_TOL = dict(rtol=1e-4, atol=1e-3)
NUMPY_TOL = dict(rtol=1e-3, atol=1e-2)
# Band-limited audio leaves mel bands with ~1e-7 of a frame's energy: both
# the FFT and the DFT product hold them as rounding noise, so their logs
# may differ by more than 1e-3. Compare linear mel instead, within 1e-5 of
# the frame's mel energy (the two routes differ by ~6e-7 of it on this
# input) and 1e-4 relative.
BAND_REL_TOL = 1e-4
BAND_ENERGY_TOL = 1e-5


def _pcm(rng, B, N):
    return (0.2 * rng.standard_normal((B, N))).astype(np.float32)


def band_limited_pcm(rng, B, N, sr=16000):
    """Four sines below 4 kHz per utterance with a stretch of silence."""
    t = np.arange(N) / sr
    x = np.zeros((B, N))
    for b in range(B):
        for _ in range(4):
            x[b] += rng.uniform(0.05, 0.3) * np.sin(
                2 * np.pi * rng.uniform(100, 3900) * t
                + rng.uniform(0, 2 * np.pi))
        a = rng.integers(0, N // 2)
        x[b, a:a + rng.integers(N // 8, N // 3)] = 0.0
    return x.astype(np.float32)


def _fft_route(pcm, fbank, T):
    """The FFT kernel's algorithm in PyTorch: the power spectrum of the
    frame zero-padded to 512 samples by torch.fft.rfft (a check of the
    algorithm, not the kernel's FFT), the mel projection over each
    filter's run of bins."""
    cfg = fbank.cfg
    fr = tfb.frame_signal(pcm, T, cfg.frame_length, cfg.frame_shift)
    fr = fr - fr.mean(dim=-1, keepdim=True)
    fr = fr - cfg.preemphasis * torch.cat([fr[..., :1], fr[..., :-1]], -1)
    spec = torch.fft.rfft(fr * fbank.window, n=cfg.padded_window_size)
    power = spec.real.square() + spec.imag.square()
    runs, w = tfb.mel_runs(fbank.banks.numpy())
    mel = torch.stack([(power[..., lo:lo + n] * torch.from_numpy(w[o:o + n]))
                       .sum(-1) for lo, n, o in runs], dim=-1)
    return torch.log(torch.clamp(mel, min=tfb.EPSILON))


@pytest.mark.parametrize("signal", ["white", "band_limited"])
def test_fft_route_matches_dft_product(rng, signal):
    """The power spectrum by a 512-point FFT and the mel sum over runs
    give fbank_plain's DFT product within the kernel's tolerance; frames
    of silence give exactly log(FLT_EPSILON)."""
    N = 16077
    pcm = _pcm(rng, 2, N) if signal == "white" else \
        band_limited_pcm(rng, 2, N)
    fbank = tf.Fbank()
    T = fbank.cfg.num_frames(N)
    x = torch.from_numpy(pcm)
    want = fbank_plain(x, fbank.window, fbank.dft_cos, fbank.dft_sin,
                       fbank.banks, T)
    got = _fft_route(x, fbank, T)
    if signal == "white":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **JNP_TOL)
        return
    lin, want_lin = got.exp(), want.exp()
    energy = want_lin.sum(-1, keepdim=True)
    assert bool(((lin - want_lin).abs() <= BAND_ENERGY_TOL * energy
                 + BAND_REL_TOL * want_lin).all())
    silent = (tfb.frame_signal(x, T, 400, 160) == 0).all(-1)
    assert int(silent.sum()) > 0
    assert bool((got[silent] == want[silent]).all())
    assert bool((want[silent] == np.float32(np.log(np.float32(tfb.EPSILON))))
                .all())


@pytest.mark.parametrize("kw", [{}, {"num_mel_bins": 40,
                                     "window_type": "hamming"},
                                {"low_freq": 300.0, "high_freq": -600.0}])
def test_mel_runs_cover_banks(rng, kw):
    """Each filter's run holds every non-zero of its row of `banks`, and a
    sequential f32 sum over the run equals the dense sequential sum bit
    for bit (adding x * 0 leaves the sum as it is)."""
    banks = tf.make_mel_banks(tf.FbankConfig(**kw))
    runs, w = tfb.mel_runs(banks)
    assert runs.shape == (banks.shape[0], 3)
    covered = np.zeros_like(banks, bool)
    for m, (lo, n, off) in enumerate(runs):
        covered[m, lo:lo + n] = True
        np.testing.assert_array_equal(w[off:off + n], banks[m, lo:lo + n])
    assert not (banks[~covered] != 0).any()
    power = (rng.random((64, banks.shape[1])) ** 4).astype(np.float32)
    dense = np.zeros((64, banks.shape[0]), np.float32)
    for j in range(banks.shape[1]):
        dense += power[:, j:j + 1] * banks[:, j]
    restricted = np.zeros_like(dense)
    for m, (lo, n, off) in enumerate(runs):
        for j in range(n):
            restricted[:, m] += power[:, lo + j] * w[off + j]
    np.testing.assert_array_equal(restricted, dense)


def test_builders_match():
    for kw in ({}, {"num_mel_bins": 40, "window_type": "hamming"}):
        jc, tc = jf.FbankConfig(**kw), tf.FbankConfig(**kw)
        np.testing.assert_array_equal(tf.make_window(tc), jf.make_window(jc))
        np.testing.assert_array_equal(tf.make_mel_banks(tc),
                                      jf.make_mel_banks(jc))
        for a, b in zip(tf.make_dft_matrices(tc), jf.make_dft_matrices(jc)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sample_rate", [8000, 16000, 32000, 48000])
@pytest.mark.parametrize("n_samples", [16000, 16077, 400, 561])
@pytest.mark.parametrize("snip_edges", [True, False])
def test_matches_jnp_and_numpy(rng, n_samples, snip_edges, sample_rate):
    """Includes N % shift != 0 (where JAX also takes `_fbank_impl`), the
    256-, 512-, 1024- and 2048-point DFTs of 25 ms frames at 8, 16, 32
    and 48 kHz, and clips shorter than half a frame (400 samples at 48
    kHz: centred framing reflects more than once)."""
    pcm = _pcm(rng, 2, n_samples)
    lens = np.array([n_samples, n_samples - 7], np.int32)
    kw = dict(snip_edges=snip_edges, sample_rate=sample_rate)
    jfb = jf.Fbank(jf.FbankConfig(**kw), use_pallas=False)
    tfb = tf.Fbank(tf.FbankConfig(**kw))
    want, want_len = jfb(jnp.asarray(pcm), jnp.asarray(lens))
    got, got_len = tfb(torch.from_numpy(pcm), torch.from_numpy(lens))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JNP_TOL)
    ref = jf.fbank_numpy(jfb.cfg, pcm[0])
    np.testing.assert_allclose(got[0].numpy(), ref, **NUMPY_TOL)


def test_shorter_than_one_frame_is_empty(rng):
    pcm = _pcm(rng, 2, 399)
    got, lens = tf.Fbank()(torch.from_numpy(pcm), torch.tensor([399, 200]))
    assert got.shape == (2, 0, 80)
    np.testing.assert_array_equal(lens.numpy(), [0, 0])


@pytest.mark.parametrize("n_samples", [16000, 48000])
def test_matches_pallas_interpret(rng, n_samples):
    cfg = jf.FbankConfig()
    pcm = _pcm(rng, 2, n_samples)
    ops = build_operands(jf.make_window(cfg), *jf.make_dft_matrices(cfg),
                         jf.make_mel_banks(cfg))
    T = cfg.num_frames(n_samples)
    want = fbank_pallas(jnp.asarray(pcm), *map(jnp.asarray, ops), T,
                        interpret=True)
    tfb = tf.Fbank()
    got = fbank_plain(torch.from_numpy(pcm), tfb.window, tfb.dft_cos,
                      tfb.dft_sin, tfb.banks, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JNP_TOL)


def test_frontend_setup_and_lengths():
    fb = tf.FrontendSetup("lhotes_fbank", {"num_mel_bins": 80,
                                           "snip_edges": True})
    assert isinstance(fb, tf.Fbank) and fb.feat_dim == 80
    assert tf.FrontendSetup("pcm").feat_dim == -1
    n = np.array([0, 399, 400, 559, 560, 16000, 16077], np.int32)
    for snip in (True, False):
        np.testing.assert_array_equal(
            tf.feat_lengths(tf.FbankConfig(snip_edges=snip),
                            torch.from_numpy(n)).numpy(),
            np.asarray(jf.feat_lengths(jf.FbankConfig(snip_edges=snip),
                                       jnp.asarray(n))))


def test_global_cmvn(rng, tmp_path):
    import json

    from speech2text_tpu.models.cmvn import GlobalCmvn as JCmvn
    from speech2text_torch.models.cmvn import GlobalCmvn
    feats = rng.standard_normal((2, 7, 80)).astype(np.float32)
    path = tmp_path / "cmvn.json"
    path.write_text(json.dumps({"mean": rng.standard_normal(80).tolist(),
                                "istd": rng.random(80).tolist()}))
    got = GlobalCmvn.from_file(str(path))(torch.from_numpy(feats))
    want = JCmvn.from_file(str(path))(jnp.asarray(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(GlobalCmvn()(torch.from_numpy(feats)),
                                  feats)


def test_fft_operands_made_once_and_checked():
    """The FFT kernel's operands are made once per banks tensor, and DFT
    matrices of a size the kernel does not compute are refused."""
    fbank = tf.Fbank()
    ops = tfb.fft_operands(fbank.dft_cos, fbank.dft_sin, fbank.banks)
    assert ops[0].shape == (512, 2) and ops[1].shape == (80, 3)
    again = tfb.fft_operands(fbank.dft_cos, fbank.dft_sin, fbank.banks)
    assert all(a is b for a, b in zip(ops, again))
    banks = fbank.banks.clone()
    tfb.fft_operands(fbank.dft_cos, fbank.dft_sin, banks)
    key = id(banks)
    assert key in tfb._OPERANDS
    del banks                       # the entry goes with its tensor
    assert key not in tfb._OPERANDS
    for n_fft in (100, 4096):
        cos, sin = (torch.from_numpy(m) for m in tfb.dft_matrices(64, n_fft))
        with pytest.raises(ValueError, match="128- to 2048-point"):
            tfb.fft_operands(cos, sin, torch.ones((4, n_fft // 2 + 1)))
    # the matrices of another frame length than their rows say
    cos, sin = (torch.from_numpy(m) for m in tfb.dft_matrices(400, 512))
    with pytest.raises(ValueError, match="another transform"):
        tfb.fft_operands(cos, sin * 2, fbank.banks)


@pytest.mark.parametrize("n_fft", [128, 256, 512, 1024, 2048])
def test_fft_operands_every_size(n_fft):
    """Twiddles exp(-2πik/n) within 1e-7 for every FFT size the kernel
    takes, from DFT matrices of a frame shorter than n."""
    flen = 3 * n_fft // 4 + 1
    cos, sin = (torch.from_numpy(m) for m in tfb.dft_matrices(flen, n_fft))
    banks = tf.make_mel_banks(tf.FbankConfig(
        sample_rate=n_fft * 25, num_mel_bins=23))
    assert banks.shape[1] == n_fft // 2 + 1
    tw, runs, _ = tfb.fft_operands(cos, sin, torch.from_numpy(banks))
    assert tfb.fft_size(cos) == n_fft and tw.shape == (n_fft, 2)
    assert runs.shape == (23, 3)
    np.testing.assert_allclose(
        tw.numpy()[:, 0] + 1j * tw.numpy()[:, 1],
        np.exp(-2j * np.pi * np.arange(n_fft) / n_fft), rtol=0, atol=1e-7)


# dither: the port's plain route given JAX's noise, rtol 1e-5; the atol of
# JNP_TOL stays for the few narrow mel bands (8 kHz: a filter over one or
# two bins) whose f32 sums the two routes take in another order (2.5e-4
# at worst on these inputs)
DITHER_TOL = dict(rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("snip_edges", [True, False])
@pytest.mark.parametrize("sample_rate", [8000, 16000])
def test_dither_matches_jax_given_its_noise(rng, snip_edges, sample_rate):
    """JAX's `_fbank_impl` with a dither key against the port's wrapper
    given `jax.random.normal(key, frames.shape)`; the same noise drawn
    by a generator gives the same features as that noise handed in."""
    import jax
    N = sample_rate + 77
    pcm = _pcm(rng, 3, N)
    kw = dict(snip_edges=snip_edges, sample_rate=sample_rate, dither=0.5)
    jfb = jf.Fbank(jf.FbankConfig(**kw), use_pallas=False)
    t = tf.Fbank(tf.FbankConfig(**kw))
    cfg = t.cfg
    T = cfg.num_frames(N)
    key = jax.random.PRNGKey(sample_rate + snip_edges)
    want = jf._fbank_impl(jfb.cfg, jnp.asarray(pcm), T, jfb._window,
                          jfb._banks, jfb._dft_cos, jfb._dft_sin, key)
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, (3, T, cfg.frame_length))))
    got, _ = t(torch.from_numpy(pcm), torch.full((3,), N), noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DITHER_TOL)
    clean, _ = t(torch.from_numpy(pcm), torch.full((3,), N))
    assert float((got - clean).abs().max()) > 1e-3
    g = torch.Generator().manual_seed(5)
    drawn, _ = t(torch.from_numpy(pcm), torch.full((3,), N),
                 dither_generator=g)
    given = tfb.dither_noise(3, T, cfg.frame_length,
                             torch.Generator().manual_seed(5), "cpu")
    again, _ = t(torch.from_numpy(pcm), torch.full((3,), N), noise=given)
    assert torch.equal(drawn, again)
