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
from speech2text_torch.ops.fbank import fbank_plain

JNP_TOL = dict(rtol=1e-4, atol=1e-3)
NUMPY_TOL = dict(rtol=1e-3, atol=1e-2)


def _pcm(rng, B, N):
    return (0.2 * rng.standard_normal((B, N))).astype(np.float32)


def test_builders_match():
    for kw in ({}, {"num_mel_bins": 40, "window_type": "hamming"}):
        jc, tc = jf.FbankConfig(**kw), tf.FbankConfig(**kw)
        np.testing.assert_array_equal(tf.make_window(tc), jf.make_window(jc))
        np.testing.assert_array_equal(tf.make_mel_banks(tc),
                                      jf.make_mel_banks(jc))
        for a, b in zip(tf.make_dft_matrices(tc), jf.make_dft_matrices(jc)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_samples", [16000, 16077, 400, 561])
@pytest.mark.parametrize("snip_edges", [True, False])
def test_matches_jnp_and_numpy(rng, n_samples, snip_edges):
    """Includes N % 160 != 0 (where JAX also takes `_fbank_impl`)."""
    pcm = _pcm(rng, 2, n_samples)
    lens = np.array([n_samples, n_samples - 7], np.int32)
    jfb = jf.Fbank(jf.FbankConfig(snip_edges=snip_edges), use_pallas=False)
    tfb = tf.Fbank(tf.FbankConfig(snip_edges=snip_edges))
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
