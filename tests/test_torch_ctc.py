"""The port's CTC loss (speech2text_torch/ops/ctc.py, losses.py `CTC`) and
CTC decoders (decoding.py) against the JAX package on the CPU, and the
loss against torch.nn.functional.ctc_loss as an independent oracle.

- Loss values and gradients (w.r.t. the raw logits) on ragged batches
  with repeated labels, a label longer than its input allows (loss 0,
  gradient exactly 0) and an empty label, in the three reductions:
  against JAX within 1e-5, against F.ctc_loss within 1e-4.
- Greedy tokens equal JAX's; prefix-beam tokens equal JAX's on 32 seeded
  utterances with forced ties (equal log-probabilities of two tokens), at
  three (beam, cand) sizes; with cand_size = V, equal to JAX's host-side
  dict oracle (`_decode_one_numpy`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech2text_tpu import decoding as jdec
from speech2text_tpu.ops import ctc as jctc
from speech2text_torch import decoding as tdec
from speech2text_torch.losses import CtcLoss, Loss
from speech2text_torch.ops import ctc as tctc

B, T, V, U = 6, 15, 7, 6


def _case(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    labels[1, :4] = 3                                   # repeats
    in_lens = np.array([15, 11, 4, 15, 9, 15], np.int32)
    lab_lens = np.array([6, 4, 5, 0, 3, 6], np.int32)   # row 2: too long
    labels[np.arange(U)[None, :] >= lab_lens[:, None]] = 0
    return logits, labels, in_lens, lab_lens


def _torch_loss(logits, labels, in_lens, lab_lens, reduction):
    x = torch.tensor(logits, requires_grad=True)
    loss = tctc.ctc_loss(x, torch.tensor(labels), torch.tensor(in_lens),
                         torch.tensor(lab_lens), reduction=reduction)
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_loss_and_gradient_match_jax(reduction):
    logits, labels, in_lens, lab_lens = _case()

    def f(x):
        return jnp.sum(jctc.ctc_loss(x, labels, in_lens, lab_lens,
                                     reduction=reduction))

    want = jctc.ctc_loss(jnp.asarray(logits), labels, in_lens, lab_lens,
                         reduction=reduction)
    want_g = jax.grad(f)(jnp.asarray(logits))
    got, got_g = _torch_loss(logits, labels, in_lens, lab_lens, reduction)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)
    if reduction == "none":
        # the unreachable lattice: loss 0, gradient exactly 0, no NaN
        assert got[2] == 0.0 and np.all(got_g[2] == 0.0)
        assert np.all(np.isfinite(got_g))
        # frames past an input length get no gradient
        assert np.all(got_g[1, 11:] == 0.0)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_loss_and_gradient_match_torch_ctc_loss(reduction):
    logits, labels, in_lens, lab_lens = _case(1)
    x = torch.tensor(logits, requires_grad=True)
    want = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1),
                      torch.tensor(labels, dtype=torch.long),
                      torch.tensor(in_lens, dtype=torch.long),
                      torch.tensor(lab_lens, dtype=torch.long), blank=0,
                      reduction=reduction, zero_infinity=True)
    want.sum().backward()
    got, got_g = _torch_loss(logits, labels, in_lens, lab_lens, reduction)
    np.testing.assert_allclose(got, want.detach().numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_g, x.grad.numpy(), rtol=1e-4, atol=1e-4)


def test_loss_factory():
    loss = Loss({"model": "CTC", "config": {"blank_label": 0,
                                            "reduction": "sum",
                                            "zero_infinity": True}})
    assert isinstance(loss, CtcLoss) and loss.config.reduction == "sum"
    logits, labels, in_lens, lab_lens = _case(2)
    got = loss({"logits": torch.tensor(logits),
                "label": torch.tensor(labels),
                "logits_length": torch.tensor(in_lens),
                "label_length": torch.tensor(lab_lens)})
    want = jctc.ctc_loss(jnp.asarray(logits), labels, in_lens, lab_lens,
                         reduction="sum")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        loss.predict(torch.tensor(logits)).numpy(),
        np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1)),
        rtol=1e-6, atol=1e-6)


def _log_probs(seed, n, t, v, ties=True):
    """Seeded log-probabilities, with `ties` forced ties: tokens 3 and 5
    equal everywhere, and blank equal to token 4 on every other frame of
    every third utterance."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, t, v)) * 2).astype(np.float32)
    if ties:
        x[:, :, 3] = x[:, :, 5]
        x[::3, ::2, 0] = x[::3, ::2, 4]
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))
    lens = rng.integers(1, t + 1, n).astype(np.int32)
    lens[0] = t
    return lp, lens


def test_greedy_matches_jax():
    lp, lens = _log_probs(3, 32, 40, 12)
    want_t, want_c = jdec.ctc_greedy_reduce(jnp.asarray(lp),
                                            jnp.asarray(lens))
    got_t, got_c = tdec.CtcGreedyDecoding().decode(torch.tensor(lp),
                                                   torch.tensor(lens))
    assert got_t.dtype == torch.int32 and got_t.shape == (32, 40)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert int(got_c.sum()) > 0


@pytest.mark.parametrize("beam,cand", [(8, 8), (4, 3), (2, 12)])
def test_prefix_beam_matches_jax(beam, cand):
    lp, lens = _log_probs(4, 32, 40, 12)
    want_t, want_c = jdec.ctc_prefix_beam_reduce(
        jnp.asarray(lp), jnp.asarray(lens), beam_size=beam, cand_size=cand)
    dec = tdec.build_decoding({"decode_method": "ctc_prefix_beam_search",
                               "beam_size": beam, "cand_size": cand})
    got_t, got_c = dec.decode(torch.tensor(lp), torch.tensor(lens))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert int(got_c.sum()) > 0


class _Ids:
    """A tokenizer stand-in whose decode returns the ids."""

    def decode(self, ids):
        return [int(i) for i in ids]


def test_prefix_beam_with_all_candidates_matches_the_dict_oracle():
    # no forced ties: the oracle's order among equal scores is its sort's
    lp, lens = _log_probs(5, 12, 20, 6, ties=False)
    beam = 4                     # the oracle shortlists max(2·4, 8) ≥ V
    oracle = jdec.CtcPrefixBeamDecoding(_Ids(), beam_size=beam)
    got_t, got_c = tdec.ctc_prefix_beam_reduce(
        torch.tensor(lp), torch.tensor(lens), beam_size=beam, cand_size=6)
    for i in range(len(lens)):
        want = oracle._decode_one_numpy(lp[i, :lens[i]])
        assert got_t[i, :got_c[i]].tolist() == want, i


def test_build_decoding_ctc_methods(tmp_path):
    assert isinstance(tdec.build_decoding(
        {"decode_method": "ctc_greedy_search"}), tdec.CtcGreedyDecoding)
    dec = tdec.build_decoding({"decode_method": "ctc_prefix_beam_search"})
    assert (dec._beam, dec._cand) == (8, 8)
    # the C++ runtime's lexicon beam over a word list spelled by the
    # tokenizer (tests/test_torch_lexicon.py holds it to JAX's)
    from speech2text_torch.data.tokenizer import TokenizerSetup
    from speech2text_torch.runtime_binding import CtcLexiconBeamDecoding
    words = tmp_path / "words.txt"
    words.write_text("the\ncat\n")
    tok = TokenizerSetup({"type": "char", "config": {}})
    dec = tdec.build_decoding({"decode_method": "ctc_lexicon_beam_search",
                               "word_list": str(words)}, tokenizer=tok)
    assert isinstance(dec, CtcLexiconBeamDecoding)
    with pytest.raises(NotImplementedError):
        tdec.build_decoding({"decode_method": "ctc_no_such_search"})
