"""Module export of the port (speech2text_torch/export.py, inference's
`task.module_export`, build_task's `callbacks.frontend_save`) against the
JAX package's (speech2text_tpu/export.py) on the CPU, at tiny dims, B=1
and max_frames 64:

- `inference` with module_export writes encoder.pt2, predictor.pt2,
  joiner.pt2, units.txt and weights.int8.npz (units and int8 arrays equal
  to JAX's), and build_task with `callbacks.frontend_save` writes
  frontend.pt2 (30 s of PCM) before training;
- each reloaded program (frontend, encoder, predictor step, joiner step)
  equals the eager module within 1e-5 and JAX's deserialized StableHLO
  within 1e-4;
- the exported encoder and frontend hold kernels B1 and B2 as the custom
  ops, whose CPU implementations equal the plain versions;
- the same `inference` run with `task.onnx_export` writes JAX's ONNX
  artifact set, and JAX's export_onnx_modules writes it for the same
  weights (convert.to_flax), at JAX's test config (max_frames 64, int8)
  with flash attention turned on in the config:
  metadata_props, input and output names, dtypes and shapes,
  encoder_stream_spec.json and units.txt equal JAX's; every graph, run
  through both packages' runners, is within rtol/atol 2e-4 of JAX's live
  forward and of the port's eager module (the streaming encoder over 3
  chunks, its state wired by the spec); every int8 graph is within JAX's
  bound of its f32 graph, smaller than it and byte-equal to JAX's
  quantize_dynamic of it; no graph holds a custom-op node;
- `stream_demo --device cpu --export_dir` on the streaming tests' session
  config writes stream_prime.pt2, stream_step.pt2 and a
  streaming_spec.json byte-equal to JAX's; over a prime and 3 steps the
  reloaded programs give the eager session's tokens and counts and those
  of JAX's deserialized export_streaming_session programs on the same
  weights; each program holds kernel B2's custom op once and B1's not at
  all;
- a CTC task's onnx_export raises JAX's ValueError, and stream_demo
  --export_dir on a Conformer transducer raises TypeError.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from speech2text_torch import build_task
from speech2text_torch import export as texport
from speech2text_torch import inference as tinf
from speech2text_torch.convert import to_flax
from speech2text_torch.ops import attn_weights as taw
from speech2text_torch.ops import fbank as tfb
from speech2text_torch.tasks.rnnt import RnntModel
from speech2text_torch.train.checkpoint import CheckpointManager

from conformer_task_util import (ctc_config, dataset_config, make_corpus,
                                 pruned_config)

MAX_FRAMES = 64
SECONDS = 30.0          # export_frontend's default, build_task's export
MODEL = {
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
        "output_dim": 32, "symbol_embedding_dim": 32, "context_size": 2}},
    "joiner": {"input_dim": 32, "prune_range": 3,
               "use_out_project": False},
    "loss": {"model": "Pruned_Rnnt", "config": {}},
}


def train_config(corpus, workdir):
    cfg = copy.deepcopy(MODEL)
    cfg["predictor"]["config"]["num_symbols"] = corpus["vocab"]
    cfg["joiner"]["output_dim"] = corpus["vocab"]
    cfg.update({"task": {"type": "Pruned_Rnnt", "name": "tiny",
                         "export_path": str(workdir)},
                "tokenizer": {"type": "subword",
                              "config": {"spm_model": corpus["spm_model"]}},
                "dataset": dataset_config(corpus),
                "metric": {"decode_method": "rnnt_greedy_search"}})
    return cfg


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """`inference` with module_export and onnx_export on a seeded tiny
    flagship-shaped model whose config turns JAX's flash attention on (as
    tests/test_onnx.py's flash-on export does; the port has no such
    switch), and JAX's exports of the same weights: StableHLO from the
    flash-off config, ONNX from the flash-on one (which JAX exports
    through its materialized path)."""
    from speech2text_tpu import export as jexport
    from speech2text_tpu.tasks import TaskFactory
    root = tmp_path_factory.mktemp("export")
    corpus = make_corpus(root / "corpus")
    cfg = train_config(corpus, root / "run")
    flash = copy.deepcopy(cfg)
    flash["encoder"]["config"]["use_flash_attn"] = True
    train_yaml = root / "train.yaml"
    train_yaml.write_text(yaml.safe_dump(flash))
    model = RnntModel.from_config(cfg)
    model.init_weights(torch.Generator().manual_seed(4))
    model.eval()
    CheckpointManager(str(root / "ckpt")).save(
        1, {"model": model.state_dict()}, {"wer": 0.5})
    test_data = root / "test.json"
    with open(corpus["eval_data"]) as f:
        test_data.write_text("".join(f.readlines()[:2]))
    out = root / "out"
    run = tinf.main(
        ["--inference_config",
         "configs/inference/pruned_rnnt_greedy_search.yaml",
         "--device", "cpu"] + [a for o in (
             f"task.train_config={train_yaml}", f"task.export_path={out}",
             f"task.checkpoints_dir={root / 'ckpt'}",
             f"testset.test_data={test_data}",
             "task.module_export=true",
             f"module_export_config.max_frames={MAX_FRAMES}",
             "task.onnx_export=true",
             f"onnx_export_config.onnx_encoder_config.max_frames={MAX_FRAMES}")
             for a in ("--override", o)])
    task = run["task"]
    paths = {k: str(out / f"{k}.pt2")
             for k in ("encoder", "predictor", "joiner")}
    cb_cfg = dict(cfg, callbacks={"frontend_save": True})
    cb_yaml = root / "frontend_save.yaml"
    cb_yaml.write_text(yaml.safe_dump(cb_cfg))
    trainer, _ = build_task.prepare([f"--training_config={cb_yaml}",
                                     "--device", "cpu"])
    trainer.close()
    paths["frontend"] = str(root / "run" / "tiny" / "frontend.pt2")
    jtask = TaskFactory("Pruned_Rnnt")(cfg)
    params = jax.tree.map(jnp.asarray, to_flax(model))
    jdir = root / "jax"
    jpaths = jexport.export_asr_modules(jtask, params, str(jdir),
                                        max_frames=MAX_FRAMES)
    jpaths["frontend"] = jexport.export_frontend(jtask.frontend, str(jdir),
                                                 max_seconds=SECONDS)
    jonnx = jexport.export_onnx_modules(
        TaskFactory("Pruned_Rnnt")(flash), params, str(root / "jonnx"),
        max_frames=MAX_FRAMES, int8=True)
    return {"out": out, "task": task, "model": model, "paths": paths,
            "jtask": jtask, "params": params, "jpaths": jpaths,
            "jonnx": jonnx, "corpus": corpus, "root": root, "programs": {}}


def program_of(exported, name):
    """The reloaded program `name`, loaded once per module."""
    progs = exported["programs"]
    if name not in progs:
        progs[name] = texport.load_exported(exported["paths"][name])
    return progs[name]


def test_module_export_writes_the_files(exported):
    from speech2text_tpu.export import quantize_params
    out = exported["out"]
    for name in ("encoder.pt2", "predictor.pt2", "joiner.pt2", "units.txt",
                 "weights.int8.npz", "test_report.txt"):
        assert (out / name).stat().st_size > 0, name
    jdir = exported["jpaths"]["encoder"].rsplit("/", 1)[0]
    exported["jtask"].tokenizer.export_units(f"{jdir}/units.txt")
    assert (out / "units.txt").read_bytes() == \
        open(f"{jdir}/units.txt", "rb").read()
    got = dict(np.load(out / "weights.int8.npz"))
    want = quantize_params(to_flax(exported["model"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def _inputs(name, task, rng):
    if name == "frontend":
        n = int(SECONDS * 16000)
        pcm = (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
        return pcm, np.array([n - 123457], np.int32)
    if name == "encoder":
        return (rng.standard_normal((1, MAX_FRAMES, 80)).astype(np.float32),
                np.array([MAX_FRAMES - 9], np.int32))
    if name == "predictor":
        return np.array([5], np.int64), np.array([[3]], np.int64)
    d = task.model.joiner.config.input_dim
    return (rng.standard_normal((1, d)).astype(np.float32),
            rng.standard_normal((1, d)).astype(np.float32))


def _eager(name, task):
    return {"frontend": task.frontend, "encoder": task.model.encoder,
            "predictor": task.model.predictor.streaming_step,
            "joiner": task.model.joiner.streaming_step}[name]


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for part in x for y in _flat(part)]
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)]


@pytest.mark.parametrize("name", ["frontend", "encoder", "predictor",
                                  "joiner"])
def test_reloaded_program_matches_eager_and_jax(exported, name):
    from speech2text_tpu.export import load_exported
    task = exported["task"]
    args = _inputs(name, task, np.random.default_rng(len(name)))
    t_args = [torch.from_numpy(a) for a in args]
    program = program_of(exported, name)
    with torch.no_grad():
        got = _flat(program(*t_args))
        eager = _flat(_eager(name, task)(*t_args))
    j_args = [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
              for a in args]
    jfn = load_exported(exported["jpaths"][name])
    want = _flat(jfn.call(*j_args) if name == "frontend"
                 else jfn.call(exported["params"], *j_args))
    assert len(got) == len(eager) == len(want)
    for g, e, w in zip(got, eager, want):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name,op", [
    ("encoder", "speech2text_torch.attn_weights"),
    ("frontend", "speech2text_torch.fbank")])
def test_exported_graph_holds_the_kernel_op(exported, name, op):
    program = program_of(exported, name)
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function"]
    n_layers = sum(MODEL["encoder"]["config"]["num_encoder_layers"])
    assert ops.count(f"{op}.default") == (n_layers if name == "encoder"
                                          else 1)


def test_custom_ops_cpu_equal_plain():
    rng = np.random.default_rng(0)
    B, T, H, qd, pd = 2, 9, 2, 8, 4
    q, k = (torch.from_numpy(rng.standard_normal((B, T, H, qd)).astype(
        np.float32)) for _ in range(2))
    qp = torch.from_numpy(rng.standard_normal((B, T, H, pd)).astype(
        np.float32))
    p = torch.from_numpy(rng.standard_normal((2 * T - 1, H, pd)).astype(
        np.float32))
    mask = torch.from_numpy(rng.random((B, T, T)) > 0.3)
    got = torch.ops.speech2text_torch.attn_weights(q, k, qp, p, mask,
                                                   torch.float32)
    assert torch.equal(got, taw.attn_weights_plain(q, k, qp, p, mask,
                                                   torch.float32))
    from speech2text_torch.data.frontend import Fbank
    fb = Fbank()
    pcm = torch.from_numpy(rng.standard_normal((2, 4000)).astype(
        np.float32))
    args = (pcm, fb.window, fb.dft_cos, fb.dft_sin, fb.banks, 23, 400, 160,
            0.97, True)
    for snip in (True, False):
        got = torch.ops.speech2text_torch.fbank(*args, snip)
        assert torch.equal(got, tfb.fbank_plain(*args, snip))


def test_onnx_and_stream_export_raise(exported, tmp_path):
    """The errors that remain: ONNX export of a CTC task (JAX's
    ValueError), and the streaming-session export of a model whose encoder
    is not a Zipformer2 (the session's TypeError)."""
    from speech2text_torch.tasks.ctc import CtcTask
    from speech2text_torch.tasks.rnnt import PrunedRnntTask
    from speech2text_torch.tools import stream_demo
    corpus = exported["corpus"]
    with pytest.raises(ValueError, match="needs a transducer task"):
        texport.export_onnx_modules(CtcTask(ctc_config(corpus, tmp_path)),
                                    str(tmp_path / "onnx"))
    cfg = pruned_config(corpus, tmp_path)
    task = PrunedRnntTask(cfg)
    CheckpointManager(str(tmp_path / "ckpt")).save(
        1, {"model": task.model.state_dict()}, {"wer": 0.5})
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    with pytest.raises(TypeError, match="Zipformer2"):
        stream_demo.main(["--train_config", str(tmp_path / "train.yaml"),
                          "--wav", "a.wav", "--device", "cpu",
                          "--checkpoints_dir", str(tmp_path / "ckpt"),
                          "--export_dir", str(tmp_path / "stream")])
    assert not (tmp_path / "stream").exists()


# ------------------------------------------------------ streaming session
@pytest.fixture(scope="module")
def session_export(tmp_path_factory):
    """`stream_demo --device cpu --export_dir` on the streaming tests'
    session config with seeded weights saved as checkpoints, and JAX's
    export_streaming_session of the same weights."""
    from speech2text_torch.convert import flax_to_state_dict
    from speech2text_torch.data.audio import write_wav
    from speech2text_torch.tasks.rnnt import PrunedRnntTask
    from speech2text_torch.tools import stream_demo
    from speech2text_tpu import export as jexport
    from speech2text_tpu.streaming import StreamingAsrSession as JSession
    from speech2text_tpu.tasks import TaskFactory
    from test_torch_streaming import SESSION_CFG, VOCAB
    root = tmp_path_factory.mktemp("session")
    task = PrunedRnntTask(SESSION_CFG)
    task.model.init_weights(torch.Generator().manual_seed(0))
    params = to_flax(task.model)
    # the blank bias lowered, so that the tiny model emits tokens
    params["joiner"]["enc_proj"]["bias"] = np.where(
        np.arange(VOCAB) == 0, -0.5, 0.0).astype(np.float32)
    task.model.load_state_dict(flax_to_state_dict(params, task.model))
    ckpt = CheckpointManager(str(root / "ckpt"))
    ckpt.save(1, {"model": task.model.state_dict()}, {"wer": 0.5})
    cfg = dict(SESSION_CFG, task={"type": "Pruned_Rnnt", "name": "tiny",
                                  "export_path": str(root)})
    (root / "train.yaml").write_text(yaml.safe_dump(cfg))
    rng = np.random.default_rng(21)
    n = 4080 + 3 * 2560
    pcm = (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
    write_wav(str(root / "a.wav"), pcm[0])
    run = stream_demo.main([
        "--train_config", str(root / "train.yaml"), "--wav",
        str(root / "a.wav"), "--chunk_size", "8", "--avg_best_k", "1",
        "--checkpoints_dir", str(root / "ckpt"), "--device", "cpu",
        "--export_dir", str(root / "stream")])
    jparams = jax.tree.map(jnp.asarray, params)
    jsess = JSession(TaskFactory("Pruned_Rnnt")(SESSION_CFG), jparams,
                     chunk_size=8, left_context_chunks=4)
    jpaths = jexport.export_streaming_session(jsess, str(root / "jax"))
    d = root / "stream"
    programs = {k: texport.load_exported(str(d / f"stream_{k}.pt2"))
                for k in ("prime", "step")}
    return {"run": run, "pcm": pcm, "jsess": jsess, "jparams": jparams,
            "jpaths": jpaths, "dir": d, "programs": programs}


def test_stream_demo_export_dir_writes_the_programs(session_export):
    d = session_export["dir"]
    paths = session_export["run"]["exported"]
    assert paths == {"prime": str(d / "stream_prime.pt2"),
                     "step": str(d / "stream_step.pt2"),
                     "spec": str(d / "streaming_spec.json")}
    for path in paths.values():
        assert os.path.getsize(path) > 0
    (res,) = session_export["run"]["results"]
    assert len(res["latency_ms"]) == 4 and res["text"]


def test_streaming_spec_equals_jax(session_export):
    with open(session_export["jpaths"]["spec"], "rb") as f:
        want = f.read()
    assert (session_export["dir"] / "streaming_spec.json").read_bytes() \
        == want


def test_session_programs_match_eager_and_jax(session_export):
    """The reloaded programs over a prime and 3 steps: tokens and counts
    equal to the eager session's and to JAX's deserialized programs' on
    the same weights and PCM."""
    from speech2text_tpu.export import load_exported
    sess = session_export["run"]["session"]
    jsess, jparams = session_export["jsess"], session_export["jparams"]
    prime, step = (session_export["programs"][k] for k in ("prime", "step"))
    jprime = load_exported(session_export["jpaths"]["prime"])
    jstep = load_exported(session_export["jpaths"]["step"])
    pcm = session_export["pcm"]
    off = sess.prime_samples
    chunks = [pcm[:, :off]] + [
        pcm[:, o:o + sess.step_samples]
        for o in range(off, pcm.shape[1], sess.step_samples)]
    assert len(chunks) == 4
    state = sess.program_state(batch_size=1)
    eager = sess.init_state(1)
    jstate = jsess.init_state(1)
    for i, chunk in enumerate(chunks):
        t = torch.from_numpy(chunk)
        state = (prime if i == 0 else step)(t, state)
        eager = (sess.prime if i == 0 else sess.step)(t, eager)
        jstate = (jprime if i == 0 else jstep).call(
            jparams, jnp.asarray(chunk), jstate)
        for key in ("tokens", "counts"):
            assert state[key].dtype == torch.int32
            np.testing.assert_array_equal(state[key].numpy(),
                                          eager[key].numpy())
            np.testing.assert_array_equal(state[key].numpy(),
                                          np.asarray(jstate[key]))
        assert int(state["enc"]["processed"]) == i + 1
    assert int(state["counts"][0]) > 0
    assert sess.texts(state) == sess.texts(eager)


@pytest.mark.parametrize("name", ["prime", "step"])
def test_session_program_holds_fbank_once(session_export, name):
    graph = session_export["programs"][name].graph
    ops = [str(n.target) for n in graph.nodes
           if n.op == "call_function"]
    assert ops.count("speech2text_torch.fbank.default") == 1
    assert not any("attn_weights" in op for op in ops)


# ------------------------------------------------------------------ ONNX
ONNX_GRAPHS = ("encoder", "predictor", "joiner", "encoder_stream")
ONNX_TOL = dict(rtol=2e-4, atol=2e-4)


def _onnx_bytes(exported, name, jax_side=False):
    if jax_side:
        return open(exported["jonnx"][name], "rb").read()
    return (exported["out"] / f"{name}.onnx").read_bytes()


def _runners(data):
    from speech2text_tpu.onnx import OnnxRunner as JRunner
    from speech2text_torch.onnx import OnnxRunner
    return OnnxRunner(data), JRunner(data)


def test_onnx_export_writes_jax_artifacts(exported):
    out, jonnx = exported["out"], exported["jonnx"]
    names = {"units": "units.txt",
             "encoder_stream_spec": "encoder_stream_spec.json"}
    assert sorted(jonnx) == sorted(
        [*ONNX_GRAPHS, *(f"{g}_int8" for g in ONNX_GRAPHS), *names])
    for key, path in jonnx.items():
        got = out / names.get(key, f"{key}.onnx")
        assert got.stat().st_size > 0, key
        if key in names:
            assert got.read_bytes() == open(path, "rb").read(), key


@pytest.mark.parametrize("name", [*ONNX_GRAPHS,
                                  *(f"{g}_int8" for g in ONNX_GRAPHS)])
def test_onnx_interface_and_metadata_equal_jax(exported, name):
    from speech2text_tpu.onnx import proto as jproto
    from speech2text_torch.onnx import proto
    got = proto.parse_model(_onnx_bytes(exported, name))
    want = jproto.parse_model(_onnx_bytes(exported, name, jax_side=True))
    assert got.metadata == want.metadata
    assert (got.ir_version, got.opset) == (want.ir_version, want.opset)
    assert got.graph.inputs == want.graph.inputs
    assert got.graph.outputs == want.graph.outputs
    # every node is in the runners' op subset: no custom-op node
    ops = {n.op_type for n in got.graph.nodes}
    assert ops <= RUNNER_OPS, ops - RUNNER_OPS


RUNNER_OPS = {
    "Add", "Sub", "Mul", "Div", "Max", "Min", "And", "Or", "Xor", "Not",
    "Neg", "Abs", "Exp", "Log", "Sqrt", "Reciprocal", "Tanh", "Sigmoid",
    "Sign", "Sin", "Cos", "Floor", "Ceil", "Erf", "Pow", "Mod", "Greater",
    "GreaterOrEqual", "Less", "LessOrEqual", "Equal", "Where", "Clip",
    "Cast", "Identity", "Reshape", "Transpose", "Expand", "Concat", "Slice",
    "Pad", "Split", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd",
    "ReduceMean", "ArgMax", "ArgMin", "MatMul", "Einsum", "Gather", "Conv",
    "Softmax", "DynamicQuantizeLinear", "MatMulInteger"}


def _graph_cases(exported, name, rng):
    """The cases of graph `name`, computed once per module."""
    cases = exported.setdefault("cases", {})
    if name not in cases:
        cases[name] = _make_cases(exported, name, rng)
    return cases[name]


def _make_cases(exported, name, rng):
    """[(inputs, JAX's live outputs, the port's eager outputs)] of graph
    `name`: one call, or for the streaming encoder three chunks of
    features with the encoder outputs and `processed` after each (the
    inputs then hold the spec's initial state, which the caller replaces
    by the graph's own state after the first chunk)."""
    from speech2text_tpu.models.zipformer import Zipformer2 as JZip
    from speech2text_tpu.tasks.rnnt import RnntModel as JModel
    jmodel, params = exported["jtask"].model, exported["params"]
    model = exported["model"]

    def live(method, *args):
        fn = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a,
                                                method=method))
        with jax.default_matmul_precision("highest"):
            return _flat(jax.tree.map(np.asarray, fn(
                params, *[jnp.asarray(a) for a in args])))

    with torch.no_grad():
        if name == "encoder":
            args = (rng.standard_normal((1, MAX_FRAMES, 80)).astype(
                np.float32), np.array([MAX_FRAMES - 9], np.int32))
            return [(args, live(JModel.encode, *args), _flat(
                model.encoder(*(torch.from_numpy(a) for a in args))))]
        if name == "predictor":
            args = (np.array([5], np.int32), np.array([[3]], np.int32))
            return [(args, live(JModel.predictor_step, *args),
                     _flat(model.predictor.streaming_step(
                         *(torch.from_numpy(a) for a in args))))]
        d = model.joiner.config.input_dim
        if name == "joiner":
            args = tuple(rng.standard_normal((1, d)).astype(np.float32)
                         for _ in range(2))
            return [(args, live(JModel.joiner_step, *args),
                     _flat(model.joiner.streaming_step(
                         *(torch.from_numpy(a) for a in args))))]
    import json
    spec = json.load(open(exported["out"] / "encoder_stream_spec.json"))
    chunk, left = spec["chunk_size"], spec["left_context_chunks"]
    jenc = {"params": params["encoder"]}
    jst = jmodel.encoder.apply(jenc, 1, chunk, left,
                               method=JZip.init_streaming_state)
    jst.pop("chunk_size")

    @jax.jit
    def jstep(p, f, st):
        out, st = jmodel.encoder.apply(p, f, dict(st, chunk_size=chunk),
                                       method=JZip.streaming_step)
        st.pop("chunk_size")
        return out, st

    tst = model.encoder.init_streaming_state(1, chunk, left)
    state = [np.zeros(s["shape"], s["dtype"]) for s in spec["state"]]
    cases = []
    for _ in range(3):
        feats = (rng.standard_normal((1, spec["feats_per_step"], 80))
                 * 0.3).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            jout, jst = jstep(jenc, jnp.asarray(feats), jst)
        with torch.no_grad():
            tout, tst = model.encoder.streaming_step(torch.from_numpy(feats),
                                                     tst)
        cases.append(((feats, *state), [np.asarray(jout),
                                        np.asarray(jst["processed"])],
                      [tout.numpy()]))
    return cases


@pytest.mark.parametrize("name", ONNX_GRAPHS)
def test_onnx_graph_matches_jax_and_eager(exported, name):
    """Every output within 2e-4 of JAX's live forward and of the port's
    eager module, integer outputs equal. The streaming encoder is driven
    as JAX's test_onnx_streaming_encoder_parity drives its graph: the
    spec's zero state, then each chunk's state outputs fed back, its
    encoder_out compared and its `processed` equal to JAX's."""
    runners = _runners(_onnx_bytes(exported, name))
    cases = _graph_cases(exported, name, np.random.default_rng(9))
    stream = name == "encoder_stream"
    if stream:
        import json
        spec = json.load(open(exported["out"] / "encoder_stream_spec.json"))
        (i_proc,) = [1 + i for i, s in enumerate(spec["state"])
                     if s["shape"] == []]
    for runner in runners:
        state = None
        for args, want, eager in cases:
            if stream and state is not None:
                args = (args[0], *state)
            got = runner(*args)
            if stream:
                state = got[1:]
                got = [got[0], got[i_proc]]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if np.issubdtype(w.dtype, np.integer):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, **ONNX_TOL)
            for g, e in zip(got, eager):
                np.testing.assert_allclose(g, e, **ONNX_TOL)


@pytest.mark.parametrize("name", ONNX_GRAPHS)
def test_onnx_int8_graph_within_jax_bound(exported, name):
    from speech2text_tpu.onnx import quantize_dynamic as jquantize
    from speech2text_torch.onnx import quantize_dynamic
    data = _onnx_bytes(exported, name)
    qdata = _onnx_bytes(exported, f"{name}_int8")
    ops = ("MatMul", "Gather") if name == "predictor" else ("MatMul",)
    assert qdata == quantize_dynamic(data, ops) == jquantize(data, ops)
    assert len(qdata) < len(data)
    (args, _, _), *_ = _graph_cases(exported, name,
                                    np.random.default_rng(10))
    fp = _runners(data)[0](*args)[0]
    for runner in _runners(qdata):
        q = runner(*args)[0]
        assert np.abs(q - fp).max() < 0.05 * max(np.abs(fp).max(), 1e-3)
