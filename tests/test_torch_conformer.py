"""The port's Conformer encoder (speech2text_torch/models/conformer.py), its
decoder heads (models/decoder.py), the model factories and the flax ↔
torch converter's rules for them, against the JAX package on the CPU.

Weights come from JAX's `init` and are converted (convert.py); inputs
from a numpy seed. Each module in f32 within rtol/atol 1e-5, the whole
encoder (2 layers × 32 wide, ragged lengths, a fully padded row) at
subsampling rates 4, 6 and 8 within 1e-5, and one case at the published
dims (256 × 12, ffn 1024, 4 heads, B=1, 1 s of features) within 1e-4.
Dropout is off in every comparison (JAX's draws cannot be reproduced);
the training forward is checked for its dropout apart.
"""

import jax
import numpy as np
import pytest
import torch

from speech2text_tpu.models import conformer as jc
from speech2text_tpu.models import decoder as jd
from speech2text_tpu.models.factories import (DecoderFactory as JDec,
                                              EncoderFactory as JEnc,
                                              JoinerFactory as JJoin,
                                              PredictorFactory as JPred)
from speech2text_tpu.tasks.rnnt import RnntModel as JRnntModel
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.models import conformer as tc
from speech2text_torch.models import decoder as td
from speech2text_torch.models.emformer import Emformer
from speech2text_torch.models.factories import (DecoderFactory,
                                                EncoderFactory,
                                                PredictorFactory)
from speech2text_torch.models.layers import init_parameters
from speech2text_torch.models.predictor import LstmPredictor
from speech2text_torch.models.wav2vec2 import Wav2Vec2Encoder
from speech2text_torch.tasks.rnnt import RnntModel

TOL = dict(rtol=1e-5, atol=1e-5)
D, H, FFN, K = 32, 4, 64, 7
# every case runs the blocks at (B, T') = (4, 23): JAX's eager primitives,
# compiled once per shape, are shared across the cases. T frames per
# subsampling rate give T' = 23.
B, T_OUT = 4, 23
T_IN = {4: 97, 6: 140, 8: 194}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(tmod, params):
    tmod.load_state_dict(flax_to_state_dict(_np(params), tmod))
    return tmod.eval()


def _close(got, want, tol=TOL):
    if isinstance(want, torch.Tensor):
        want = want.detach()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _mask(lens, T):
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("rate", [4, 6, 8])
def test_conv_subsampling(rate):
    rng = np.random.default_rng(rate)
    x = rng.standard_normal((3, T_IN[rate], 80)).astype(np.float32)
    lens = np.array([T_IN[rate], 40, 2], np.int32)
    jm = jc.ConvSubsampling(rate, D)
    params = jm.init(jax.random.PRNGKey(rate), x, lens)["params"]
    tm = _load(tc.ConvSubsampling(rate, 80, D), params)
    (jh, jl), (th, tl) = jm.apply({"params": params}, x, lens), \
        tm(torch.tensor(x), torch.tensor(lens))
    _close(th, jh)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32 and int(tl[-1]) == 0   # clamped at 0


def test_masked_mhsa_with_a_fully_padded_row():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T_OUT, D)).astype(np.float32)
    mask = _mask([T_OUT, 15, 5, 0], T_OUT)
    jm = jc.MaskedMHSA(H)
    params = jm.init(jax.random.PRNGKey(1), x, mask)["params"]
    tm = _load(tc.MaskedMHSA(D, H), params)
    got = tm(torch.tensor(x), torch.tensor(mask))
    _close(got, jm.apply({"params": params}, x, mask))
    # the padded row attends uniformly over its (masked) keys
    v = tm.Dense_0(torch.tensor(x))[3, :, 2 * D:].mean(0)
    _close(got[3], tm.Dense_1(v)[None].expand(T_OUT, D))


def test_conv_module_and_feedforward():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T_OUT, D)).astype(np.float32)
    mask = _mask([T_OUT, 6, 12, 1], T_OUT)
    jm = jc.ConvModule(K)
    params = jm.init(jax.random.PRNGKey(2), x, mask)["params"]
    assert np.asarray(params["Conv_0"]["kernel"]).shape == (K, 1, D)
    tm = _load(tc.ConvModule(D, K), params)
    assert tuple(tm.Conv_0.weight.shape) == (D, 1, K)
    got = tm(torch.tensor(x), torch.tensor(mask))
    _close(got, jm.apply({"params": params}, x, mask))
    # padded frames are zeroed before the conv: their values do not
    # reach the valid frames
    y = x.copy()
    y[1, 6:] = 100.0
    _close(tm(torch.tensor(y), torch.tensor(mask))[1, :6], got[1, :6])

    jf = jc.FeedForward(FFN, 0.1)
    params = jf.init(jax.random.PRNGKey(3), x)["params"]
    tf = _load(tc.FeedForward(D, FFN, 0.1), params)
    _close(tf(torch.tensor(x)), jf.apply({"params": params}, x))


def test_conformer_block():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T_OUT, D)).astype(np.float32)
    mask = _mask([T_OUT, 7, 19, 2], T_OUT)
    jm = jc.ConformerBlock(H, FFN, K, 0.1)
    params = jm.init(jax.random.PRNGKey(4), x, mask)["params"]
    assert sorted(params) == sorted(
        ["FeedForward_0", "FeedForward_1", "MaskedMHSA_0", "ConvModule_0"]
        + [f"LayerNorm_{i}" for i in range(5)])
    tm = _load(tc.ConformerBlock(D, H, FFN, K, 0.1), params)
    _close(tm(torch.tensor(x), torch.tensor(mask)),
           jm.apply({"params": params}, x, mask))


def _encoder_case(cfg, B, T, seed, lens, jit=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 80)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jm = jc.Conformer(jc.ConformerConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(seed), x, lens)["params"]
    tm = _load(tc.Conformer(tc.ConformerConfig(**cfg)), params)
    want, wl = (jax.jit(jm.apply) if jit else jm.apply)({"params": params},
                                                        x, lens)
    got, gl = tm(torch.tensor(x), torch.tensor(lens))
    return got, gl, want, wl


@pytest.mark.parametrize("rate", [4, 6, 8])
def test_encoder_ragged(rate):
    cfg = dict(subsampling_rate=rate, input_dim=D, num_heads=H, ffn_dim=FFN,
               num_layers=2, depthwise_conv_kernel_size=K, output_dim=24)
    T = T_IN[rate]
    got, gl, want, wl = _encoder_case(cfg, B, T, rate, [T, 60, 33, 5])
    assert got.shape[1] == T_OUT
    _close(got, want)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert got.dtype == torch.float32
    # past each length the output is exactly 0
    pad = ~torch.tensor(_mask(gl.numpy(), got.shape[1]))
    assert float(got.detach()[pad].abs().max()) == 0.0


def test_encoder_published_dims():
    cfg = dict(subsampling_rate=4, input_dim=256, num_heads=4, ffn_dim=1024,
               num_layers=12, depthwise_conv_kernel_size=31, output_dim=256)
    got, gl, want, wl = _encoder_case(cfg, 1, 100, 5, [100], jit=True)
    _close(got, want, dict(rtol=1e-4, atol=1e-4))
    assert gl.tolist() == [int(wl[0])] == [24]


def test_training_forward_has_dropout():
    cfg = tc.ConformerConfig(input_dim=D, num_heads=H, ffn_dim=FFN,
                             num_layers=1, depthwise_conv_kernel_size=K,
                             output_dim=D, dropout=0.5)
    m = tc.Conformer(cfg)
    init_parameters(m, torch.Generator().manual_seed(0))
    x, lens = torch.randn(2, 40, 80), torch.tensor([40, 30])
    ev, _ = m(x, lens)
    a, _ = m(x, lens, training=True,
             generator=torch.Generator().manual_seed(1))
    b, _ = m(x, lens, training=True,
             generator=torch.Generator().manual_seed(1))
    assert not torch.equal(a, ev) and torch.equal(a, b)


def test_projector_decoder():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    lens = np.array([5, 3], np.int32)
    jm = jd.ProjectorDecoder(jd.ProjectorDecoderConfig(input_dim=D,
                                                       num_classes=11))
    params = jm.init(jax.random.PRNGKey(6), x, lens)["params"]
    tm = _load(td.ProjectorDecoder(td.ProjectorDecoderConfig(
        input_dim=D, num_classes=11)), params)
    (jl, _), (tl, tlen) = jm.apply({"params": params}, x, lens), \
        tm(torch.tensor(x), torch.tensor(lens))
    _close(tl, jl)
    assert tl.dtype == torch.float32 and tlen.tolist() == [5, 3]
    ident = td.IdentityDecoder(td.IdentityDecoderConfig())
    assert list(ident.state_dict()) == []


def _rnnt_config(decoder):
    return {
        "encoder": {"model": "Conformer", "config": dict(
            input_dim=D, num_heads=H, ffn_dim=FFN, num_layers=2,
            depthwise_conv_kernel_size=K, output_dim=D)},
        "decoder": decoder,
        "predictor": {"model": "Stateless", "config": dict(
            num_symbols=11, output_dim=D, symbol_embedding_dim=16,
            context_size=2)},
        "joiner": {"input_dim": D, "output_dim": 11, "prune_range": 3}}


@pytest.mark.parametrize("head", ["Projector", "Identity"])
def test_converter_rnnt_tree(head):
    dec = {"model": "Projector", "config": {"input_dim": D,
                                            "num_classes": 11}} \
        if head == "Projector" else {"model": "Identity"}
    cfg = _rnnt_config(dec)
    jm = JRnntModel(JEnc(cfg["encoder"]), JDec(cfg["decoder"]),
                    JPred(cfg["predictor"]), JJoin(cfg["joiner"]))
    x = np.zeros((1, 40, 80), np.float32)
    labels = np.ones((1, 3), np.int32)
    # JAX's tree (names and shapes) filled with seeded values
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(7), x,
                            np.array([40]), labels, np.array([3]))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), shapes)
    assert ("decoder" in params) == (head == "Projector")
    if head == "Projector":
        assert list(params["decoder"]) == ["Dense_0"]
    enc = params["encoder"]
    assert sorted(enc) == ["ConformerBlock_0", "ConformerBlock_1",
                           "ConvSubsampling_0", "Dense_0"]
    assert sorted(enc["ConvSubsampling_0"]) == ["Conv_0", "Conv_1",
                                                "Dense_0"]
    assert sorted(enc["ConformerBlock_0"]["ConvModule_0"]) == [
        "Conv_0", "Dense_0", "Dense_1", "LayerNorm_0"]
    model = RnntModel.from_config(cfg)
    sd = flax_to_state_dict(params, model)
    model.load_state_dict(sd)
    back = to_flax(model)
    flat = lambda t, p="": {k2: v2 for k, v in t.items() for k2, v2 in (
        flat(v, p + k + "/").items() if isinstance(v, dict)
        else [(p + k, v)])}
    a, b = flat(params), flat(back)
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert "encoder.ConformerBlock_1.LayerNorm_4.weight" in sd

    extra = dict(params, encoder=dict(enc, Dense_9={"kernel": np.zeros(
        (D, D), np.float32)}))
    with pytest.raises(KeyError):
        flax_to_state_dict(extra, model)
    missing = dict(params, encoder={k: v for k, v in enc.items()
                                    if k != "Dense_0"})
    with pytest.raises(KeyError):
        flax_to_state_dict(missing, model)


def test_factories():
    assert isinstance(EncoderFactory({"model": "Conformer", "config": {
        "num_layers": 1}}), tc.Conformer)
    assert isinstance(DecoderFactory({"model": "Identity"}),
                      td.IdentityDecoder)
    assert isinstance(EncoderFactory({"model": "Emformer", "config": {
        "num_layers": 1}}), Emformer)
    assert isinstance(EncoderFactory({"model": "Wav2Vec2", "config": {
        "hidden_dim": 32, "num_layers": 1, "num_heads": 2, "ffn_dim": 64,
        "conv_pos_kernel": 16, "conv_pos_groups": 4}}), Wav2Vec2Encoder)
    assert isinstance(PredictorFactory({"model": "Lstm"}), LstmPredictor)
    for fac in (EncoderFactory, DecoderFactory, PredictorFactory):
        with pytest.raises(ValueError):
            fac({"model": "Nope"})
