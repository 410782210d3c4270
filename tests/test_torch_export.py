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
- onnx_export and stream_demo --export_dir still raise.
"""

import copy

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

from conformer_task_util import dataset_config, make_corpus

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
    """`inference` with module_export on a seeded tiny flagship-shaped
    model, and JAX's export of the same weights."""
    from speech2text_tpu import export as jexport
    from speech2text_tpu.tasks import TaskFactory
    root = tmp_path_factory.mktemp("export")
    corpus = make_corpus(root / "corpus")
    cfg = train_config(corpus, root / "run")
    train_yaml = root / "train.yaml"
    train_yaml.write_text(yaml.safe_dump(cfg))
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
             f"module_export_config.max_frames={MAX_FRAMES}")
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
    return {"out": out, "task": task, "model": model, "paths": paths,
            "jtask": jtask, "params": params, "jpaths": jpaths,
            "programs": {}}


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
    from speech2text_torch.tools import stream_demo
    with pytest.raises(NotImplementedError, match="onnx_export"):
        tinf.prepare(["--inference_config",
                      "configs/inference/pruned_rnnt_greedy_search.yaml",
                      "--device", "cpu", "--override",
                      "task.onnx_export=true", "--override",
                      f"task.export_path={tmp_path}"])
    with pytest.raises(NotImplementedError, match="export_dir"):
        stream_demo.main(["--train_config", "x.yaml", "--wav", "a.wav",
                          "--export_dir", str(tmp_path)])
