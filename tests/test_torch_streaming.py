"""True streaming of the port (speech2text_torch/models/zipformer.py
streaming API, speech2text_torch/streaming.py, tools/stream_demo.py)
against the JAX package, on the CPU at tiny dims.

- Each module's `step` against JAX's `step` (f32, rtol/atol 1e-5):
  ConvNeXt, AttentionWeights (cache partly filled, full, and empty),
  SelfAttention, NonlinAttention, ConvolutionModule.
- A stack's streaming (downsample 1 and 2) against JAX's streaming and
  against the port's chunk-masked stack forward (rtol 1e-3 / atol 1e-4,
  as tests/test_zipformer_streaming.py).
- The encoder chain `streaming_prime` + steps against JAX's and against
  the port's chunk-masked forward (rtol 1e-4 / atol 1e-5), the checks
  that raise, and one prime + step at the flagship's dims.
- `StreamingAsrSession` against JAX's session and the port's offline
  chunk-masked decode (equal texts and tokens), its incremental tokens,
  and `tools/stream_demo` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from speech2text_tpu.models import zipformer as jz
from speech2text_tpu.ops.masking import chunk_causal_mask as j_chunk_mask
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.data.audio import write_wav
from speech2text_torch.models import zipformer as tz
from speech2text_torch.models.layers import init_parameters
from speech2text_torch.ops.masking import chunk_causal_mask
from speech2text_torch.streaming import StreamingAsrSession
from speech2text_torch.tasks.rnnt import PrunedRnntTask
from speech2text_torch.train.checkpoint import CheckpointManager

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
STACK_TOL = dict(rtol=1e-3, atol=1e-4)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-5)

VOCAB = 31
SESSION_CFG = {
    "tokenizer": {"type": "char", "config": {}},
    "dataset": {"feat_type": "lhotes_fbank",
                "feat_config": {"num_mel_bins": 80},
                "data_aug_config": {}},
    "metric": {"decode_method": "rnnt_greedy_search",
               "encoder_streaming": True,
               "streaming_chunk_size": 8,
               "streaming_left_chunks": 4},
    "encoder": {"model": "Zipformer", "config": {
        "feature_dim": 80, "downsampling_factor": [1, 2],
        "num_encoder_layers": [1, 1], "feedforward_dim": [64, 64],
        "encoder_dim": [32, 32], "encoder_unmasked_dim": [24, 24],
        "num_heads": [2, 2], "query_head_dim": 8, "value_head_dim": 8,
        "pos_head_dim": 4, "pos_dim": 16, "cnn_module_kernel": [7, 7],
        "causal": True, "chunk_size": [8], "left_context_frames": [32],
        "dropout": 0.0}},
    "decoder": {"model": "Identity", "config": {"dummy": -1}},
    "predictor": {"model": "Stateless", "config": {
        "num_symbols": VOCAB, "output_dim": 32,
        "symbol_embedding_dim": 32, "context_size": 2}},
    "joiner": {"input_dim": 32, "output_dim": VOCAB, "prune_range": 3,
               "use_out_project": False},
    "loss": {"model": "Pruned_Rnnt", "config": {}},
}


# ------------------------------------------------------------- helpers
def _perturb(params, seed):
    """Random values for zero- or constant-initialised leaves (biases,
    norm and bypass scales, downsample weights)."""
    rng = np.random.default_rng(seed)

    def go(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = go(v)
            else:
                v = np.asarray(v, np.float32)
                if k in ("bias", "log_scale", "bypass_scale", "weights"):
                    v = v + 0.1 * rng.standard_normal(v.shape).astype(
                        np.float32)
                out[k] = v
        return out

    return go(params)


def _port(jax_module, torch_module, *args, seed=0):
    """Init `jax_module` on `args` (callables closed over), perturb, load
    into `torch_module`; returns (params, torch_module)."""
    arrays = [jnp.asarray(a) for a in args if not callable(a)]

    def init(key, *arrays):
        it = iter(arrays)
        full = [a if callable(a) else next(it) for a in args]
        return jax_module.init({"params": key}, *full)["params"]

    params = jax.jit(init)(jax.random.PRNGKey(seed), *arrays)
    params = _perturb(jax.tree.map(np.asarray, params), seed)
    torch_module.load_state_dict(flax_to_state_dict(params, torch_module))
    return params, torch_module.eval()


def _method(jax_module, params, method, *args):
    """Jitted `jax_module.apply(..., method=method)` on array args."""
    arrays = [jnp.asarray(a) for a in args]
    return jax.jit(lambda p, *a: jax_module.apply(
        {"params": p}, *a, method=method))(params, *arrays)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------- modules
def test_convnext_step(rng):
    B, c, F2, C = 2, 5, 9, 8
    x = rng.standard_normal((B, 11, F2, C)).astype(np.float32)
    win = rng.standard_normal((B, 6 + c, F2, C)).astype(np.float32)
    jm = jz.ConvNeXtBlock(C, causal=True)
    p, m = _port(jm, tz.ConvNeXtBlock(C, causal=True), x)
    with torch.no_grad():
        got = m.step(_t(win))
        _close(m(_t(x)), jm.apply({"params": p}, jnp.asarray(x)), STEP_TOL)
    _close(got, _method(jm, p, jz.ConvNeXtBlock.step, win), STEP_TOL)


def _attn_step_inputs(rng, B=2, C=4, L=8, D=32):
    x = rng.standard_normal((B, C, D)).astype(np.float32)
    table = np.asarray(jz.CompactRelPositionalEncoding(16).table(L + C - 1))
    cached = rng.standard_normal((B, L, 16)).astype(np.float32)
    return x, table, cached


@pytest.mark.parametrize("valid", [0, 3, 8, 20])
def test_attention_weights_step(rng, valid):
    """Weights and the new key cache; `valid` < L masks unfilled slots."""
    x, table, cached = _attn_step_inputs(rng)
    jm = jz.AttentionWeights(32, 2, 8, 4, 16)
    full_x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    pos = np.asarray(jz.CompactRelPositionalEncoding(16).apply({}, 7))
    p, m = _port(jm, tz.AttentionWeights(32, 2, 8, 4, 16), full_x, pos)
    with torch.no_grad():
        got_w, got_k = m.step(_t(x), _t(table), _t(cached), valid)
    want_w, want_k = _method(jm, p, jz.AttentionWeights.step, x, table,
                             cached, np.int32(valid))
    _close(got_w, want_w, STEP_TOL)
    _close(got_k, want_k, STEP_TOL)
    unfilled = 8 - min(valid, 8)
    assert not got_w[..., :unfilled].any()
    np.testing.assert_allclose(got_w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_self_attention_step(rng):
    B, C, L = 2, 4, 8
    x = rng.standard_normal((B, C, 32)).astype(np.float32)
    w = rng.random((B, 2, C, L + C)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    cached = rng.standard_normal((B, L, 16)).astype(np.float32)
    jm = jz.SelfAttention(32, 2, 8)
    p, m = _port(jm, tz.SelfAttention(32, 2, 8), x,
                 w[..., :C] / w[..., :C].sum(-1, keepdims=True))
    with torch.no_grad():
        got, got_v = m.step(_t(x), _t(w), _t(cached))
    want, want_v = _method(jm, p, jz.SelfAttention.step, x, w, cached)
    _close(got, want, STEP_TOL)
    _close(got_v, want_v, STEP_TOL)


def test_nonlin_attention_step(rng):
    B, C, L = 2, 4, 8
    x = rng.standard_normal((B, C, 32)).astype(np.float32)
    w = rng.random((B, C, L + C)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    cached = rng.standard_normal((B, L, 24)).astype(np.float32)
    jm = jz.NonlinAttention(32, 24)
    p, m = _port(jm, tz.NonlinAttention(32, 24), x,
                 np.full((B, C, C), 1.0 / C, np.float32))
    with torch.no_grad():
        got, got_v = m.step(_t(x), _t(w), _t(cached))
    want, want_v = _method(jm, p, jz.NonlinAttention.step, x, w, cached)
    _close(got, want, STEP_TOL)
    _close(got_v, want_v, STEP_TOL)


def test_convolution_module_step(rng):
    B, C, K = 2, 4, 7
    x = rng.standard_normal((B, C, 32)).astype(np.float32)
    cache = rng.standard_normal((B, K - 1, 32)).astype(np.float32)
    jm = jz.ConvolutionModule(32, K, causal=True)
    p, m = _port(jm, tz.ConvolutionModule(32, K, causal=True), x,
                 np.ones((B, C), bool))
    with torch.no_grad():
        got, got_c = m.step(_t(x), _t(cache))
    want, want_c = _method(jm, p, jz.ConvolutionModule.step, x, cache)
    _close(got, want, STEP_TOL)
    _close(got_c, want_c, STEP_TOL)


# --------------------------------------------------------------- stack
@pytest.mark.parametrize("downsample", [1, 2])
def test_stack_streaming(downsample):
    """Mirrors tests/test_zipformer_streaming.py's stack case: chunk 8,
    2 left chunks, 3 chunks, against JAX's streaming and the port's
    chunk-masked forward."""
    CHUNK, LEFT, N = 8, 2, 3
    T, D = CHUNK * N, 16
    kw = dict(num_layers=2, downsample=downsample, embed_dim=D, ff_dim=32,
              num_heads=2, query_head_dim=4, value_head_dim=4,
              pos_head_dim=2, pos_dim=8, kernel_size=5, causal=True)
    x = np.random.default_rng(downsample).standard_normal(
        (2, T, D)).astype(np.float32)
    lens = np.array([T, T], np.int32)
    cs = CHUNK // downsample

    def jmask(Td, ds, pad_mask):
        cm = j_chunk_mask(Td, jnp.asarray(cs, jnp.int32),
                          jnp.asarray(LEFT, jnp.int32))
        return pad_mask[:, None, :] & pad_mask[:, :, None] & cm[None]

    def tmask(Td, ds, pad_mask):
        cm = chunk_causal_mask(Td, cs, LEFT)
        return pad_mask[:, None, :] & pad_mask[:, :, None] & cm[None]

    jm = jz.Zipformer2Stack(dropout=0.0, **kw)
    p, m = _port(jm, tz.Zipformer2Stack(input_dim=D, dropout=0.0, **kw),
                 x, lens, jmask, seed=downsample)
    caches = m.init_cache(2, CHUNK, LEFT)
    jcaches = jm.init_cache(2, CHUNK, LEFT)
    step = jax.jit(lambda p, c, ch, v: jm.apply(
        {"params": p}, c, ch, v, method=jz.Zipformer2Stack.streaming_step))
    got, want = [], []
    with torch.no_grad():
        full = m(_t(x), torch.from_numpy(lens), tmask)
        for k in range(N):
            chunk = x[:, k * CHUNK:(k + 1) * CHUNK]
            out, caches = m.streaming_step(_t(chunk), caches, k * cs)
            got.append(out)
            out, jcaches = step(p, jnp.asarray(chunk), jcaches,
                                jnp.asarray(k * cs, jnp.int32))
            want.append(np.asarray(out))
    got = torch.cat(got, 1)
    _close(got, np.concatenate(want, 1), STACK_TOL)
    _close(got, full, STACK_TOL)


# ------------------------------------------------------------- encoder
def _chain_config(**kw):
    return dict(feature_dim=80, downsampling_factor=(1, 2),
                num_encoder_layers=(1, 1), feedforward_dim=(32, 32),
                encoder_dim=(16, 16), encoder_unmasked_dim=(8, 8),
                num_heads=(2, 2), query_head_dim=4, value_head_dim=4,
                pos_head_dim=2, pos_dim=8, cnn_module_kernel=(5, 5),
                causal=True, dropout=0.0, **kw)


def _stream(model, feats, chunk, left, n_chunks):
    """The port's prime + steps over raw fbank frames → (B, T', D)."""
    state = model.init_streaming_state(feats.shape[0], chunk, left)
    prime = 2 * chunk + tz.Zipformer2.PRIME_EXTRA_RAW
    out, state = model.streaming_prime(feats[:, :prime], state)
    outs = [out]
    for k in range(1, n_chunks):
        lo = prime + (k - 1) * 2 * chunk
        out, state = model.streaming_step(feats[:, lo:lo + 2 * chunk],
                                          state)
        outs.append(out)
    assert state["processed"] == n_chunks
    return torch.cat(outs, 1)


def test_full_chain_streaming():
    """streaming_prime + streaming_step against JAX's and against the
    port's chunk-masked forward, exact from frame 0 (chunk 8, 2 left
    chunks, 4 chunks)."""
    CHUNK, LEFT, N = 8, 2, 4
    T_raw = 2 * CHUNK * N + tz.Zipformer2.PRIME_EXTRA_RAW
    feats = np.random.default_rng(0).standard_normal(
        (2, T_raw, 80)).astype(np.float32)
    lens = np.array([T_raw, T_raw], np.int32)
    jm = jz.Zipformer2(jz.Zipformer2Config(**_chain_config()))
    tm = tz.Zipformer2(tz.Zipformer2Config(**_chain_config()))
    p, tm = _port(jm, tm, feats, lens, seed=1)

    jstate = jm.init_streaming_state(2, chunk_size=CHUNK,
                                     left_context_chunks=LEFT)
    prime = 2 * CHUNK + jz.Zipformer2.PRIME_EXTRA_RAW

    def jrun(method):
        def run(p, f, s):
            s = dict(s, chunk_size=CHUNK)
            out, s = jm.apply({"params": p}, f, s, method=method)
            s.pop("chunk_size")
            return out, s
        return jax.jit(run)

    jstate.pop("chunk_size")
    out, jstate = jrun(jz.Zipformer2.streaming_prime)(
        p, jnp.asarray(feats[:, :prime]), jstate)
    want = [np.asarray(out)]
    jstep = jrun(jz.Zipformer2.streaming_step)
    for k in range(1, N):
        lo = prime + (k - 1) * 2 * CHUNK
        out, jstate = jstep(p, jnp.asarray(feats[:, lo:lo + 2 * CHUNK]),
                            jstate)
        want.append(np.asarray(out))
    want = np.concatenate(want, 1)
    with torch.no_grad():
        got = _stream(tm, _t(feats), CHUNK, LEFT, N)
        full, full_lens = tm(_t(feats), torch.from_numpy(lens), CHUNK, LEFT)
    assert got.shape == (2, CHUNK // 2 * N, 16) and got.dtype == torch.float32
    assert int(full_lens[0]) == CHUNK * N // 2
    _close(got, want, CHAIN_TOL)
    _close(got, full[:, :got.shape[1]], CHAIN_TOL)


def test_streaming_checks_raise():
    base = _chain_config()
    m = tz.Zipformer2(tz.Zipformer2Config(**dict(
        base, downsampling_factor=(1, 8))))
    with pytest.raises(ValueError, match="divisible"):
        m.init_streaming_state(1, chunk_size=12)          # 12 % 8 != 0
    m = tz.Zipformer2(tz.Zipformer2Config(**base))
    with pytest.raises(ValueError, match="raw tail"):
        m.init_streaming_state(1, chunk_size=2)           # 2·2 < 8
    with pytest.raises(ValueError, match="causal"):
        tz.Zipformer2(tz.Zipformer2Config(**dict(
            base, causal=False))).init_streaming_state(1, 8)
    with pytest.raises(ValueError, match="widest"):
        tz.Zipformer2(tz.Zipformer2Config(**dict(
            base, encoder_dim=(16, 8), encoder_unmasked_dim=(8, 8)))
        ).init_streaming_state(1, 8)
    with pytest.raises(NotImplementedError, match="full_dim_bypass"):
        tz.Zipformer2(tz.Zipformer2Config(**dict(
            base, full_dim_bypass=True))).init_streaming_state(1, 8)
    with pytest.raises(NotImplementedError, match="full_dim_bypass"):
        stack = tz.Zipformer2Stack(16, 1, 2, 16, 32, 2, 4, 4, 2, 8, 5, True,
                                   full_dim_bypass=True)
        stack.streaming_step(torch.zeros(1, 8, 16),
                             stack.init_cache(1, 8, 2), 0)
    state = m.init_streaming_state(1, 8, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="24 raw frames"):
        m.streaming_prime(torch.zeros(1, 16, 80), state)
    with torch.no_grad(), pytest.raises(ValueError, match="16 raw frames"):
        m.streaming_step(torch.zeros(1, 24, 80), state)


def test_flagship_dims_prime_step_f32():
    """The flagship's widths and depth (12 layers, 192/256, ds 1..8),
    causal f32, chunk 32 and 4 left chunks: prime + one step against the
    port's chunk-masked forward on the same 136 raw frames."""
    cfg = tz.Zipformer2Config(causal=True)
    m = tz.Zipformer2(cfg).eval()
    init_parameters(m, torch.Generator().manual_seed(0))
    T_raw = 2 * 32 * 2 + tz.Zipformer2.PRIME_EXTRA_RAW
    feats = _t(np.random.default_rng(3).standard_normal((1, T_raw, 80)))
    with torch.no_grad():
        got = _stream(m, feats, 32, 4, 2)
        full, _ = m(feats, torch.tensor([T_raw]), 32, 4)
    assert got.shape == (1, 32, 256)
    _close(got, full[:, :32], CHAIN_TOL)


# ------------------------------------------------------------- session
@pytest.fixture(scope="module")
def session_task():
    """The port's task with seeded weights (the joiner's blank bias
    lowered so that the tiny model emits tokens), its flax tree and JAX's
    task."""
    from speech2text_tpu.tasks import TaskFactory
    task = PrunedRnntTask(SESSION_CFG)
    task.model.init_weights(torch.Generator().manual_seed(0))
    params = to_flax(task.model)
    params["joiner"]["enc_proj"]["bias"] = np.where(
        np.arange(VOCAB) == 0, -0.5, 0.0).astype(np.float32)
    task.model.load_state_dict(flax_to_state_dict(params, task.model))
    jtask = TaskFactory("Pruned_Rnnt")(SESSION_CFG)
    return task.eval(), jax.tree.map(jnp.asarray, params), jtask


def _pcm(seed, B, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n)) * 0.1).astype(np.float32)


def test_session_matches_jax_and_offline(session_task):
    from speech2text_tpu.streaming import StreamingAsrSession as JSession
    task, params, jtask = session_task
    sess = StreamingAsrSession(task, chunk_size=8, left_context_chunks=4,
                               device="cpu")
    jsess = JSession(jtask, params, chunk_size=8, left_context_chunks=4)
    assert (sess.prime_samples, sess.step_samples) == \
        (jsess.prime_samples, jsess.step_samples) == (4080, 2560)
    n = sess.prime_samples + 2 * sess.step_samples
    pcm = _pcm(7, 2, n)
    texts, lat = sess.run_utterance(pcm, measure_latency=True)
    assert len(lat) == 3
    state = sess.init_state(2)
    state = sess.prime(pcm[:, :sess.prime_samples], state)
    for k in range(2):
        off = sess.prime_samples + k * sess.step_samples
        state = sess.step(pcm[:, off:off + sess.step_samples], state)
    jtexts, _ = jsess.run_utterance(pcm)
    jstate = jsess.init_state(2)
    jstate = jsess.prime(jnp.asarray(pcm[:, :sess.prime_samples]), jstate)
    for k in range(2):
        off = sess.prime_samples + k * sess.step_samples
        jstate = jsess.step(jnp.asarray(pcm[:, off:off + sess.step_samples]),
                            jstate)
    np.testing.assert_array_equal(state["counts"].numpy(),
                                  np.asarray(jstate["counts"]))
    np.testing.assert_array_equal(state["tokens"].numpy(),
                                  np.asarray(jstate["tokens"]))
    assert int(state["counts"].min()) > 0
    batch = {"pcm": torch.from_numpy(pcm),
             "pcm_length": torch.full((2,), n, dtype=torch.int32)}
    offline = task.eval_hyps(task.eval_forward(batch, losses=False))
    assert texts == jtexts == offline == sess.texts(state), \
        (texts, jtexts, offline)


def test_session_is_incremental(session_task):
    """Counts never decrease and each chunk only appends tokens."""
    task, _, _ = session_task
    sess = StreamingAsrSession(task, chunk_size=8, left_context_chunks=4,
                               device="cpu")
    pcm = _pcm(11, 1, sess.prime_samples + 3 * sess.step_samples)
    state = sess.prime(pcm[:, :sess.prime_samples], sess.init_state(1))
    counts = [int(state["counts"][0])]
    toks = [state["tokens"][0].clone()]
    for k in range(3):
        off = sess.prime_samples + k * sess.step_samples
        state = sess.step(torch.from_numpy(
            pcm[:, off:off + sess.step_samples]), state)
        counts.append(int(state["counts"][0]))
        toks.append(state["tokens"][0].clone())
    assert counts[-1] > 0
    assert all(b >= a for a, b in zip(counts, counts[1:]))
    for a, b, ca in zip(toks, toks[1:], counts):
        assert torch.equal(a[:ca], b[:ca])
    assert all(t.is_inference() and not t.requires_grad
               for t in state["enc"]["stacks"][0][0].values())
    with pytest.raises(ValueError, match="samples"):
        sess.step(pcm[:, :100], state)


@pytest.mark.parametrize("chunk,frames", [(16, (40, 32)), (32, (72, 64)),
                                          (64, (136, 128))])
def test_session_chunk_shapes(session_task, chunk, frames):
    """The chunk sizes the flagship trains on: samples and fbank frames of
    the prime and of a step."""
    task, _, _ = session_task
    sess = StreamingAsrSession(task, chunk_size=chunk, device="cpu")
    fb = task.frontend.cfg
    assert fb.num_frames(sess.prime_samples) == frames[0]
    assert fb.num_frames(sess.step_samples + 240) == frames[1]
    assert sess.chunk_ms == 20.0 * chunk


def test_stream_demo_cpu(session_task, tmp_path, capsys):
    from speech2text_torch.tools import stream_demo
    task, _, _ = session_task
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    for step, wer in ((1, 0.5), (2, 0.4)):
        ckpt.save(step, {"model": task.model.state_dict(), "step": step},
                  {"wer": wer})
    cfg = dict(SESSION_CFG, task={"type": "Pruned_Rnnt", "name": "tiny",
                                  "export_path": str(tmp_path)})
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    sess = StreamingAsrSession(task, chunk_size=8, device="cpu")
    pcm = _pcm(5, 1, sess.prime_samples + 3 * sess.step_samples + 100)[0]
    write_wav(str(tmp_path / "a.wav"), pcm)
    run = stream_demo.main([
        "--train_config", str(tmp_path / "train.yaml"),
        "--wav", str(tmp_path / "a.wav"), "--chunk_size", "8",
        "--checkpoints_dir", str(tmp_path / "ckpt"), "--device", "cpu"])
    (res,) = run["results"]
    pcm16 = np.round(np.clip(pcm, -1.0, 1.0) * 32767.0) / 32768.0
    want, _ = sess.run_utterance(pcm16.astype(np.float32))
    assert res["text"] == want[0] and len(res["latency_ms"]) == 4
    assert res["summary"]["rtf"] > 0
    out = capsys.readouterr().out
    assert f"transcript: {want[0]}" in out and "RTF=" in out


def test_stream_demo_raises_without_card(monkeypatch, tmp_path):
    from speech2text_torch.tools import stream_demo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_demo.main(["--train_config", str(tmp_path / "none.yaml"),
                          "--wav", str(tmp_path / "none.wav")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingAsrSession(PrunedRnntTask(SESSION_CFG))
