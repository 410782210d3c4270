"""The port's beam transducer decoding (speech2text_torch/decoding.py:
RnntBeamDecoding, build_decoding) against the JAX package's.

- The cases of tests/test_decoding.py on the same fake sessions (the
  joiner is log_softmax of the encoder frame): beam W=1/K=1 equals greedy,
  a wider beam, LM fusion flipping an acoustic tie, merging of equal
  prefixes, length masking; each also against JAX's decoder.
- A tiny real RnntModel (`__graft_entry__._tiny_config`, the same weights
  in both packages through convert.py) with ragged lengths including
  enc_len 1 and 0, W ∈ {1, 2, 4} × K ∈ {1, 3, 4}, with and without a
  fusion LM, and with joiner rows copied so that several tokens score
  exactly alike (exact ties at every frame, where the order of equal
  values decides): tokens and counts identical to JAX's.
- On the same model, W=1/K=1 beam tokens equal the port's greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from speech2text_tpu.data.tokenizer import CharTokenizer
from speech2text_tpu.decoding import RnntBeamDecoding as JBeam
from speech2text_tpu.models.factories import JoinerFactory, PredictorFactory
from speech2text_tpu.models.joiner import Joiner as JJoiner
from speech2text_tpu.models.predictor import StatelessPredictor as JPred
from speech2text_tpu.models.rnn_lm import RnnLm as JLm
from speech2text_tpu.models.rnn_lm import RnnLmConfig as JLmConfig
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.decoding import (NEG_INF, CifGreedyDecoding,
                                        CtcGreedyDecoding,
                                        CtcPrefixBeamDecoding,
                                        RnntBeamDecoding,
                                        RnntGreedyDecoding, build_decoding,
                                        ids_to_texts, merge_equal_prefixes,
                                        top_k)
from speech2text_torch.models.rnn_lm import RnnLm, RnnLmConfig
from speech2text_torch.tasks.rnnt import RnntModel

TOK = CharTokenizer()
V_TINY = 48
CAP = 24


def one_hot_logits(ids, V, scale=5.0):
    out = np.full((len(ids), V), -1.0, np.float32)
    out[np.arange(len(ids)), ids] = scale
    return out


# ------------------------------------------------------------ fake sessions
def _port_fake(beam, lm_token=None, lm_weight=0.0, **kw):
    """The fake sessions of tests/test_decoding.py for the port."""
    V = len(TOK)

    def pred_step(token, state):
        return torch.zeros((token.shape[0], 1, 4)), state

    def pred_init(B, device):
        return torch.zeros((B, 1), dtype=torch.int64, device=device)

    def join(enc, pred):
        return torch.log_softmax(enc, dim=-1)

    def lm_step(token, state):
        dist = torch.full((token.shape[0], V), -10.0)
        dist[:, lm_token] = 0.0
        return dist, state

    if not beam:
        return RnntGreedyDecoding(pred_step, pred_init, join, **kw)
    return RnntBeamDecoding(
        pred_step, pred_init, join, lm_step=lm_step if lm_token else None,
        lm_init_state=pred_init if lm_token else None, lm_weight=lm_weight,
        **kw)


def _jax_fake(lm_token=None, lm_weight=0.0, **kw):
    V = len(TOK)

    def pred_step(params, token, state):
        return jnp.zeros((token.shape[0], 1, 4), jnp.float32), state

    def pred_init(B):
        return jnp.zeros((B, 1), jnp.int32)

    def join(params, enc, pred):
        return jax.nn.log_softmax(enc, axis=-1)

    def lm_step(params, token, state):
        return jnp.full((token.shape[0], V), -10.0).at[:, lm_token].set(
            0.0), state

    return JBeam(TOK, pred_step, pred_init, join,
                 lm_step=lm_step if lm_token else None,
                 lm_init=pred_init if lm_token else None,
                 lm_weight=lm_weight, **kw)


def _texts(dec, enc, lens):
    tokens, counts = dec.decode(torch.from_numpy(enc), torch.from_numpy(
        np.asarray(lens, np.int32)))
    return ids_to_texts(tokens.numpy(), counts.numpy(), TOK)


def _same_as_jax(dec, jdec, enc, lens):
    """Tokens and counts identical to JAX's on the same inputs."""
    got = dec.decode(torch.from_numpy(enc),
                     torch.from_numpy(np.asarray(lens, np.int32)))
    want = jdec._decode_jit(None, jnp.asarray(enc),
                            jnp.asarray(lens, jnp.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_beam1_matches_greedy_fake():
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 6, len(TOK))).astype(np.float32)
    lens = [6, 4]
    greedy = _texts(_port_fake(False, max_token_step=1), enc, lens)
    beam = _port_fake(True, beam_size=1, cutoff_top_k=1)
    assert _texts(beam, enc, lens) == greedy
    _same_as_jax(beam, _jax_fake(beam_size=1, cutoff_top_k=1), enc, lens)


def test_beam_runs_wider_fake():
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((3, 5, len(TOK))).astype(np.float32)
    for W, K in ((4, 3), (2, 4), (3, 1)):
        _same_as_jax(_port_fake(True, beam_size=W, cutoff_top_k=K),
                     _jax_fake(beam_size=W, cutoff_top_k=K), enc, [5, 2, 0])


def test_lm_flips_acoustic_tie():
    a, b = TOK.encode("ab").tolist()
    enc = np.full((1, 1, len(TOK)), -8.0, np.float32)
    enc[0, 0, a] = 2.0
    enc[0, 0, b] = 2.0 + 1e-4            # acoustically b barely wins
    kw = dict(beam_size=2, cutoff_top_k=2)
    assert _texts(_port_fake(True, a, 0.0, **kw), enc, [1]) == ["b"]
    assert _texts(_port_fake(True, a, 1.0, **kw), enc, [1]) == ["a"]
    for w in (0.0, 1.0):
        _same_as_jax(_port_fake(True, a, w, **kw), _jax_fake(a, w, **kw),
                     enc, [1])


def test_merge_changes_winner():
    """Frame 1: p(blank)=.3, p(a)=.25, p(b)=.45; frame 2: p(blank)=.5,
    p(a)=.5. "a" has mass .275 over two paths, "b" .225 over one: the
    single best path is "b", the merged winner "a"."""
    V = len(TOK)
    a, b = TOK.encode("ab").tolist()
    f1 = np.full((V,), -30.0, np.float32)
    f1[0], f1[a], f1[b] = np.log([0.3, 0.25, 0.45])
    f2 = np.full((V,), -30.0, np.float32)
    f2[0], f2[a] = np.log([0.5, 0.5])
    enc = np.stack([f1, f2])[None]
    kw = dict(beam_size=3, cutoff_top_k=2)
    assert _texts(_port_fake(True, **kw), enc, [2]) == ["a"]
    _same_as_jax(_port_fake(True, **kw), _jax_fake(**kw), enc, [2])


def test_length_masking_fake():
    a, b = TOK.encode("ab").tolist()
    enc = one_hot_logits([a, b], len(TOK))[None]
    beam = _port_fake(True, beam_size=2, cutoff_top_k=2)
    assert _texts(beam, enc, [2]) == ["ab"]
    assert _texts(beam, enc, [1]) == ["a"]
    assert _texts(beam, enc, [0]) == [""]


def test_top_k_keeps_index_order_on_ties():
    x = torch.tensor([[0.0, 1.0, 1.0, -1e30, 1.0, -1e30, -1e30]])
    vals, idx = top_k(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(want[1]).tolist()
    assert vals.tolist() == np.asarray(want[0]).tolist()


def test_merge_into_lowest_index():
    """Each group of equal prefixes: logaddexp of its scores in the
    lowest-index member, NEG_INF in the others; against a loop over the
    candidates."""
    rng = np.random.default_rng(6)
    B, M, cap = 3, 8, 5
    counts = rng.integers(0, 3, (B, M))
    tokens = np.where(np.arange(cap) < counts[..., None],
                      rng.integers(1, 3, (B, M, cap)), 0)
    scores = rng.standard_normal((B, M)).astype(np.float32)
    scores[0, 3] = NEG_INF
    got = merge_equal_prefixes(torch.from_numpy(scores),
                               torch.from_numpy(tokens),
                               torch.from_numpy(counts)).numpy()
    want = np.empty_like(scores)
    for b in range(B):
        for i in range(M):
            group = [j for j in range(M) if counts[b, j] == counts[b, i]
                     and (tokens[b, j] == tokens[b, i]).all()]
            want[b, i] = NEG_INF if group[0] < i else np.logaddexp.reduce(
                scores[b, group])
    assert (want == NEG_INF).sum() >= 6      # several merged groups
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ragged_batch_equals_each_alone_fake():
    """Frames past an utterance's length carry its beams unchanged: each
    row of a ragged batch decodes as the utterance alone."""
    rng = np.random.default_rng(8)
    enc = rng.standard_normal((4, 9, len(TOK))).astype(np.float32)
    lens = np.array([9, 4, 1, 6], np.int32)
    dec = _port_fake(True, beam_size=3, cutoff_top_k=2)
    tokens, counts = dec.decode(torch.from_numpy(enc), torch.from_numpy(lens))
    for b, n in enumerate(lens):
        t, c = dec.decode(torch.from_numpy(enc[b:b + 1, :n]),
                          torch.from_numpy(lens[b:b + 1]))
        assert torch.equal(t[0], tokens[b]) and int(c[0]) == int(counts[b])


# -------------------------------------------------------- tiny real model
def _train_config():
    cfg = _tiny_config(V_TINY)
    cfg["metric"] = {"decode_method": "rnnt_beam_search"}
    return cfg


@pytest.fixture(scope="module")
def tiny():
    """A seeded port model, the same weights as a flax tree, a tied copy
    (the joiner rows of tokens 1-6 a constant: those tokens always score
    exactly alike, mostly above the others) and a seeded fusion LM with
    its flax tree."""
    model = RnntModel.from_config(_train_config()).eval()
    model.init_weights(torch.Generator().manual_seed(5))
    tied = RnntModel.from_config(_train_config()).eval()
    tied.load_state_dict(model.state_dict())
    with torch.no_grad():
        for proj in (tied.joiner.enc_proj, tied.joiner.pre_proj):
            proj.weight[1:7] = 0.0
            proj.bias[1:7] = 3.0
    lm_cfg = dict(num_symbols=V_TINY, embedding_dim=16, hidden_dim=24,
                  num_layers=2)
    jlm = JLm(JLmConfig(**lm_cfg))
    lm_params = jlm.init(jax.random.PRNGKey(3),
                         jnp.zeros((1, 2), jnp.int32))["params"]
    lm = RnnLm(RnnLmConfig(**lm_cfg)).eval()
    lm.load_state_dict(flax_to_state_dict(lm_params, lm))
    return {"model": model, "params": to_flax(model), "tied": tied,
            "tied_params": to_flax(tied), "lm": lm, "jlm": jlm,
            "lm_params": lm_params}


def _jax_beam(params, lm=None, lm_params=None, lm_weight=0.0, **kw):
    cfg = _train_config()
    pred = JPred(PredictorFactory(cfg["predictor"]).config)
    join = JJoiner(JoinerFactory(cfg["joiner"]).config)

    def pred_step(p, tok, state):
        return pred.apply({"params": p["predictor"]}, tok, state,
                          method=JPred.streaming_step)

    def join_step(p, enc, pr):
        return join.apply({"params": p["joiner"]}, enc, pr,
                          method=JJoiner.streaming_step)

    lm_step = lm_init = None
    if lm is not None:
        def lm_step(p, tok, state):
            return lm.apply({"params": lm_params}, tok, state,
                            method=JLm.score_step)

        lm_init = lm.init_state
    return JBeam(None, pred_step, lambda B: jnp.zeros((B, 1), jnp.int32),
                 join_step, max_tokens=CAP, lm_step=lm_step, lm_init=lm_init,
                 lm_weight=lm_weight, **kw), params


def _port_beam(model, lm=None, lm_weight=0.0, **kw):
    return RnntBeamDecoding(
        model.predictor_step, model.predictor.init_state, model.joiner_step,
        max_tokens=CAP, lm_step=None if lm is None else lm.score_step,
        lm_init_state=None if lm is None else lm.init_state,
        lm_weight=lm_weight, **kw)


def _encoder_out(seed, B=4, T=13, D=64):
    rng = np.random.default_rng(seed)
    enc = (2 * rng.standard_normal((B, T, D))).astype(np.float32)
    return enc, np.array([T, 1, 0, 7][:B], np.int32)


def _compare_real(dec, jdec, params, enc, lens):
    got_tok, got_cnt = dec.decode(torch.from_numpy(enc),
                                  torch.from_numpy(lens))
    want_tok, want_cnt = jdec._decode_jit(params, jnp.asarray(enc),
                                          jnp.asarray(lens))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    return got_cnt.numpy()


@pytest.mark.parametrize("W,K", [(1, 1), (1, 4), (2, 1), (2, 3), (4, 3),
                                 (4, 4)])
def test_real_model_tokens_identical(tiny, W, K):
    enc, lens = _encoder_out(W * 10 + K)
    dec = _port_beam(tiny["model"], beam_size=W, cutoff_top_k=K)
    jdec, params = _jax_beam(tiny["params"], beam_size=W, cutoff_top_k=K)
    counts = _compare_real(dec, jdec, params, enc, lens)
    assert counts[0] > 0 and counts[2] == 0


@pytest.mark.parametrize("W,K", [(2, 3), (4, 4)])
def test_real_model_exact_ties(tiny, W, K):
    """Tokens 1-6 score exactly alike at every frame: the top-k and the
    merge meet equal values, which both packages order by index."""
    model = tiny["tied"]
    enc, lens = _encoder_out(7 + W)
    with torch.no_grad():
        pred, _ = model.predictor_step(torch.zeros(4, dtype=torch.int64),
                                       model.predictor.init_state(4))
        logp = model.joiner_step(torch.from_numpy(enc[:, 0]), pred[:, 0])
    assert bool((logp[:, 1:7] == logp[:, 1:2]).all())
    assert bool((top_k(logp[:, 1:], K)[0][:, 0] == logp[:, 1]).all()), \
        "the tied tokens are not among the best"
    dec = _port_beam(model, beam_size=W, cutoff_top_k=K)
    jdec, params = _jax_beam(tiny["tied_params"], beam_size=W,
                             cutoff_top_k=K)
    assert _compare_real(dec, jdec, params, enc, lens)[0] > 0


@pytest.mark.parametrize("W,K,weight", [(2, 3, 0.3), (4, 4, 0.5),
                                        (4, 4, 0.0)])
def test_real_model_lm_fusion_identical(tiny, W, K, weight):
    enc, lens = _encoder_out(30 + W)
    dec = _port_beam(tiny["model"], tiny["lm"], weight, beam_size=W,
                     cutoff_top_k=K)
    jdec, params = _jax_beam(tiny["params"], tiny["jlm"], tiny["lm_params"],
                             weight, beam_size=W, cutoff_top_k=K)
    _compare_real(dec, jdec, params, enc, lens)
    if weight == 0.0:    # weight 0 is the unfused decoder
        plain = _port_beam(tiny["model"], beam_size=W, cutoff_top_k=K)
        got = dec.decode(torch.from_numpy(enc), torch.from_numpy(lens))
        want = plain.decode(torch.from_numpy(enc), torch.from_numpy(lens))
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_real_model_beam1_matches_greedy(tiny):
    model = tiny["model"]
    enc, lens = _encoder_out(41)
    greedy = RnntGreedyDecoding(model.predictor_step,
                                model.predictor.init_state,
                                model.joiner_step, max_tokens=CAP)
    beam = _port_beam(model, beam_size=1, cutoff_top_k=1)
    got = beam.decode(torch.from_numpy(enc), torch.from_numpy(lens))
    want = greedy.decode(torch.from_numpy(enc), torch.from_numpy(lens))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(want[1].sum()) > 0


def test_lm_smaller_than_joiner_raises(tiny):
    small = RnnLm(RnnLmConfig(num_symbols=V_TINY - 1, embedding_dim=8,
                              hidden_dim=8, num_layers=1))
    dec = _port_beam(tiny["model"], small, 0.3, beam_size=2, cutoff_top_k=2)
    enc, lens = _encoder_out(1)
    with pytest.raises(ValueError, match="do not cover"):
        dec.decode(torch.from_numpy(enc), torch.from_numpy(lens))


def test_build_decoding(tiny):
    model = tiny["model"]
    args = (model.predictor_step, model.predictor.init_state,
            model.joiner_step)
    greedy = build_decoding({"max_token_step": 2}, *args)
    assert isinstance(greedy, RnntGreedyDecoding)
    assert greedy._max_token_step == 2
    beam = build_decoding({"decode_method": "rnnt_beam_search"}, *args)
    assert isinstance(beam, RnntBeamDecoding)
    assert (beam._W, beam._K, beam._lm_step) == (4, 4, None)
    beam = build_decoding({"decode_method": "rnnt_beam_search",
                           "beam_size": 3, "cutoff_top_k": 2}, *args,
                          lm_step=tiny["lm"].score_step,
                          lm_init_state=tiny["lm"].init_state,
                          lm_weight=0.3)
    assert (beam._W, beam._K, beam._lm_weight) == (3, 2, 0.3)
    # the CTC methods decode log-probs (tests/test_torch_ctc.py)
    assert isinstance(build_decoding({"decode_method": "ctc_greedy_search"},
                                     *args), CtcGreedyDecoding)
    assert isinstance(build_decoding(
        {"decode_method": "ctc_prefix_beam_search"}, *args),
        CtcPrefixBeamDecoding)
    # the CIF task's per-position argmax (tests/test_torch_cif.py)
    assert isinstance(build_decoding({"decode_method": "cif_greedy_search"},
                                     *args), CifGreedyDecoding)
    # ctc_lexicon_beam_search is ported (tests/test_torch_lexicon.py); an
    # unknown method raises and names the ported ones
    with pytest.raises(NotImplementedError, match="ctc_lexicon_beam_search"):
        build_decoding({"decode_method": "ctc_no_such_search"}, *args)
