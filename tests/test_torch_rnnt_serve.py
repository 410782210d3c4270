"""Serving path of the port against the JAX package: predictor and joiner
steps, greedy decoding (identical token ids), `RnntServer.transcribe` end
to end on the CPU, the flax ↔ torch weight converter, and the config
reader against PyYAML."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _build_model, _tiny_config
from speech2text_tpu.data import frontend as jf
from speech2text_tpu.decoding import RnntGreedyDecoding as JaxGreedy
from speech2text_tpu.models.factories import JoinerFactory, PredictorFactory
from speech2text_tpu.models.joiner import Joiner as JJoiner
from speech2text_tpu.models.predictor import StatelessPredictor as JPred
from speech2text_tpu.tasks.rnnt import RnntModel as JRnntModel
from speech2text_torch.config import load_config, loads, override
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.decoding import RnntGreedyDecoding
from speech2text_torch.serve import RnntServer, serving_train_config
from speech2text_torch.tasks.rnnt import RnntModel

VOCAB = 64
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "configs").rglob("*.yaml"))


def _train_config():
    cfg = _tiny_config(VOCAB)
    cfg["dataset"] = {"feat_type": "lhotes_fbank",
                      "feat_config": {"num_mel_bins": 80,
                                      "snip_edges": True}}
    cfg["metric"] = {"decode_method": "rnnt_greedy_search",
                     "max_token_step": 1}
    return cfg




def _write_configs(tmp_path):
    """The tiny recipe as a training YAML and an inference YAML naming
    it; returns the inference config's path."""
    train = tmp_path / "train.yaml"
    train.write_text(yaml.safe_dump(_train_config()))
    infer = {"task": {"type": "pruned_rnnt_inference",
                      "train_config": str(train)},
             "testset": {"config": {"batch_size": 2,
                                    "feat_type": "lhotes_fbank",
                                    "feat_config": {"num_mel_bins": 80}}},
             "decoding": {"type": "rnnt_greedy_search",
                          "config": {"max_token_step": 1}}}
    path = tmp_path / "infer.yaml"
    path.write_text(yaml.safe_dump(infer))
    return str(path)


@pytest.fixture(scope="module")
def tiny():
    """A seeded port model and the same weights as a flax tree."""
    model = RnntModel.from_config(_train_config()).eval()
    model.init_weights(torch.Generator().manual_seed(11))
    return model, to_flax(model)


def _jax_steps(cfg, params):
    pred = JPred(PredictorFactory(cfg["predictor"]).config)
    join = JJoiner(JoinerFactory(cfg["joiner"]).config)

    def pred_step(p, tok, state):
        return pred.apply({"params": p["predictor"]}, tok, state,
                          method=JPred.streaming_step)

    def join_step(p, enc, pr):
        return join.apply({"params": p["joiner"]}, enc, pr,
                          method=JJoiner.streaming_step)

    return pred, pred_step, join_step


def test_predictor_and_joiner_steps(tiny):
    model, params = tiny
    cfg = _train_config()
    pred, pred_step, join_step = _jax_steps(cfg, params)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, VOCAB, (3,)).astype(np.int32)
    state = rng.integers(0, VOCAB, (3, 1)).astype(np.int32)
    want, want_state = pred_step(params, jnp.asarray(tok), jnp.asarray(state))
    with torch.no_grad():
        got, got_state = model.predictor_step(torch.from_numpy(tok),
                                              torch.from_numpy(state).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got_state.numpy(),
                                      np.asarray(want_state))
        targets = rng.integers(1, VOCAB, (2, 5)).astype(np.int32)
        full = pred.apply({"params": params["predictor"]},
                          jnp.asarray(targets))
        np.testing.assert_allclose(
            model.predictor(torch.from_numpy(targets).long()).numpy(),
            np.asarray(full), rtol=1e-5, atol=1e-5)
        enc = rng.standard_normal((3, 64)).astype(np.float32)
        got = model.joiner_step(torch.from_numpy(enc), got[:, 0])
    want = join_step(params, jnp.asarray(enc), want[:, 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("max_token_step", [1, 2])
def test_greedy_tokens_identical(tiny, max_token_step):
    model, params = tiny
    _, pred_step, join_step = _jax_steps(_train_config(), params)
    jdec = JaxGreedy(None, pred_step,
                     lambda B: jnp.zeros((B, 1), jnp.int32), join_step,
                     max_token_step=max_token_step, max_tokens=24)
    rng = np.random.default_rng(max_token_step)
    enc = (2 * rng.standard_normal((3, 17, 64))).astype(np.float32)
    lens = np.array([17, 9, 0], np.int32)
    want_tok, want_cnt = jdec._decode_jit(params, jnp.asarray(enc),
                                          jnp.asarray(lens))
    dec = RnntGreedyDecoding(model.predictor_step,
                             model.predictor.init_state,
                             model.joiner_step,
                             max_token_step=max_token_step, max_tokens=24)
    got_tok, got_cnt = dec.decode(torch.from_numpy(enc),
                                  torch.from_numpy(lens))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_cnt.numpy()[0] > 0 and got_cnt.numpy()[2] == 0


def test_transcribe_end_to_end_cpu(tiny, tmp_path):
    """int16 PCM → fbank → encoder → greedy decode, port vs JAX."""
    model, params = tiny
    server = RnntServer(_write_configs(tmp_path), device="cpu")
    assert server.batch_size == 2
    server.model.load_state_dict(model.state_dict())
    rng = np.random.default_rng(5)
    pcm = (3000 * rng.standard_normal((2, 12000))).astype(np.int16)
    lens = np.array([12000, 8350], np.int32)
    tokens, counts = server.transcribe(pcm, lens)
    enc, enc_lens = server.encode(*server.featurize(pcm, lens))

    cfg = _train_config()
    jm = _build_model(cfg)
    feats, feat_lens = jf.Fbank(jf.FbankConfig(), use_pallas=False)(
        jnp.asarray(pcm.astype(np.float32) * (1.0 / 32768.0)),
        jnp.asarray(lens))
    want_enc, want_lens = jax.jit(lambda p, f, l: jm.apply(
        {"params": p}, f, l, method=JRnntModel.encode))(params, feats,
                                                        feat_lens)
    np.testing.assert_array_equal(enc_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), rtol=1e-4,
                               atol=1e-4)
    _, pred_step, join_step = _jax_steps(cfg, params)
    jdec = JaxGreedy(None, pred_step,
                     lambda B: jnp.zeros((B, 1), jnp.int32), join_step)
    want_tok, want_cnt = jdec._decode_jit(params, want_enc, want_lens)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tok))
    assert tokens.shape == (2, 256) and counts.numpy().min() > 0


def test_converter_round_trip_and_structure(tiny):
    model, params = tiny
    shapes = jax.eval_shape(lambda: _build_model(_train_config()).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 60, 80)),
        jnp.full((2,), 60), jnp.ones((2, 4), jnp.int32),
        jnp.full((2,), 4)))["params"]
    assert jax.tree.map(lambda a: a.shape, shapes) == \
        jax.tree.map(lambda a: a.shape, params)
    sd = flax_to_state_dict(params, model)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = to_flax(model)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, params))


def test_converter_raises_on_bad_trees(tiny):
    model, params = tiny
    bad = copy.deepcopy(params)
    bad["joiner"]["extra_proj"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra_proj"):
        flax_to_state_dict(bad, model)
    bad = copy.deepcopy(params)
    del bad["predictor"]["out"]["bias"]
    with pytest.raises(KeyError, match="predictor.out.bias"):
        flax_to_state_dict(bad, model)
    bad = copy.deepcopy(params)
    bad["encoder"]["stack0"]["layers"] = bad["encoder"]["stack0"].pop(
        "layer0")
    with pytest.raises(ValueError, match="scan_layers"):
        flax_to_state_dict(bad, model)
    bad = copy.deepcopy(params)
    bad["joiner"]["enc_proj"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(bad, model)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_reader_matches_pyyaml(path):
    assert load_config(str(ROOT / path)) == \
        yaml.safe_load((ROOT / path).read_text())


def test_flagship_serving_config():
    """The serving config resolves to the flagship recipe: zipformer
    medium in bf16, stateless predictor, relu joiner without out
    projection, greedy decoding, batches of 16."""
    server_cfg = load_config(
        str(ROOT / "configs/inference/pruned_rnnt_greedy_search.yaml"))
    train = serving_train_config(server_cfg)
    want = {**yaml.safe_load((
        ROOT / "configs/training/zipformer_stateless_pruned_rnnt.yaml"
    ).read_text()),
        "metric": {"decode_method": "rnnt_greedy_search",
                   "max_token_step": 1}}
    # inference.py's rewrites: the subword model trained into the run's
    # spm/ directory, the test set's manifest
    spm = "tasks/zipformer-stateless-pruned-rnnt/spm/tokenizer"
    want["tokenizer"]["config"] = {"spm_model": spm + ".model",
                                   "spm_vocab": spm + ".vocab"}
    want["dataset"]["test_data"] = server_cfg["testset"]["test_data"]
    assert train == want
    assert train["encoder"]["config"]["dtype"] == "bfloat16"
    assert train["joiner"]["use_out_project"] is False
    assert server_cfg["testset"]["config"]["batch_size"] == 16
    d = loads("a:\n  b: [1, -2]\n  c:\n    - x\n    - 'y # z'\nd: 1.0e-3\n")
    assert d == {"a": {"b": [1, -2], "c": ["x", "y # z"]}, "d": 1e-3}
    override(d, "a.e.f", "true")
    assert d["a"]["e"] == {"f": True}
