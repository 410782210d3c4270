"""The port's multi-rank training and test sharding (speech2text_torch/
parallel/, the Trainer's ranks, inference over ranks) against the JAX
package's mesh on the CPU.

One torchrun job of 2 gloo ranks (tests/torch_parallel_ranks.py) runs
every multi-rank case while the JAX side runs on 2 of conftest's 8
virtual CPU devices (a `("data", "model")` mesh of 2 × 1): the flagship's
steps in a process of their own (tests/jax_mesh_reference.py, whose
trace and compile take ~25 s), the rest in this one, which then runs the
one-process side of the checks while that compile goes on.

- (a) DDP: 3 steps of the tiny flagship (`__graft_entry__._tiny_config`
  dims, test_torch_trainer.py's corpus and config, pruned RNN-T +
  ScaledAdam, augmentation (speed perturbation too) and dropout off)
  against JAX's Trainer step jitted over the mesh with its shardings, on
  the same global batches: the logged losses rtol 1e-5, grad_norm rtol
  1e-4, the step-3 parameters within 1e-4 of each tensor's largest entry
  (the worst stated in the failure message; the keys' biases, whose exact
  gradient is 0, are noise below 1e-6 and held to atol 1e-6); the
  sharded evaluation equals a one-process evaluation of that checkpoint.
- (b) FSDP: the same run with `trainer.fsdp`, against the same JAX step
  (FSDP shards the JAX tree's layout, not its arithmetic: one compile of
  the step serves both cases); its checkpoint, written by 2 ranks, loads
  into a 1-process Trainer and equals the DDP run's. The FSDP run again
  with the encoder's `remat: full` equals it bit for bit.
- (c) global denominators: the NNLM task's masked KL (AdamW, clipping at
  5.0) over 2 ranks whose token counts differ against JAX's mesh step:
  loss and acc rtol 1e-5, grad_norm 1e-4, parameters 1e-5 relative.
- (d) the balancer's and whitening's gradients, each rank on half of a
  batch, against JAX's ops/regularizers.py on the whole batch (rtol 1e-5,
  atol 1e-6 of the largest).
- (e) inference over 2 ranks writes the report of JAX's inference.py on
  a 2-device mesh byte for byte (seeded weights, batches rounded up).
- (f) draws: with one process the step generators are the ones of
  before; over 2 ranks augmentation and dropout differ per rank and the
  chunk draw is the same.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from conformer_task_util import lm_config
from jax_mesh_reference import flat, mesh_steps, nested
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.tasks.factory import TaskFactory
from speech2text_torch.tasks.rnnt import PrunedRnntTask, RnntModel
from speech2text_torch.train import checkpoint as tckpt
from speech2text_torch.train.loop import (STREAM_AUGMENT, STREAM_CHUNK,
                                          STREAM_DROPOUT, Trainer, step_seed)
from test_torch_trainer import _config, _lines, corpus  # noqa: F401
from torch_parallel_ranks import (BALANCER, WHITEN, regularizer_batch,
                                  regularizer_grads)

REPO = Path(__file__).resolve().parents[1]
SEED, STEPS = 7, 3
LOSS_KEYS = ("loss", "simple_loss", "pruned_loss", "train_loss")


def _mesh_config(cfg, **trainer):
    cfg["trainer"].update({"mesh": {"data": 2, "model": 1}}, **trainer)
    return cfg


def _flagship(corpus, workdir, **trainer):
    cfg = _config(corpus, workdir, **trainer)
    cfg["dataset"]["data_aug_config"] = {}       # no speed perturbation
    return _mesh_config(cfg)


def _seeded(cfg):
    """The task of `cfg` with the Trainer's seeded weights."""
    task = TaskFactory(cfg["task"]["type"])(cfg)
    task.init_weights(torch.Generator().manual_seed(SEED))
    return task


def _jax_report(infer_path, export_path, ckpt_dir):
    import inference as jinf
    from speech2text_tpu.parallel import mesh as jmesh
    make = jmesh.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "make_mesh", lambda config=None, devices=None:
                   make(config, devices=jax.devices()[:2]))
        jinf.FLAGS.unparse_flags()
        jinf.FLAGS(["inference", f"--inference_config={infer_path}",
                    f"--override=task.export_path={export_path}",
                    f"--override=task.checkpoints_dir={ckpt_dir}"])
        jinf.run_inference([])
    return (Path(export_path) / "test_report.txt").read_bytes()


def _write_spec(corpus, root):
    """The job's spec, the inference YAMLs and seeded checkpoints of both
    packages, the flagship's seeded weights as a flat flax tree; returns
    (spec, the flagship model, the inference model)."""
    spec = {"seed": SEED, "steps": STEPS, "out": str(root)}
    for name, kw in (("ddp", {}), ("fsdp", {"fsdp": True}),
                     ("fsdp_remat", {"fsdp": True})):
        spec[f"{name}_dir"] = str(root / name)
        spec[name] = _flagship(corpus, spec[f"{name}_dir"], **kw)
    spec["fsdp_remat"]["encoder"]["config"].update(remat=True,
                                                   remat_policy="full")
    spec["nnlm_dir"] = str(root / "nnlm")
    spec["nnlm"] = _mesh_config(lm_config(corpus, spec["nnlm_dir"]))
    train_yaml = root / "train.yaml"
    train_yaml.write_text(yaml.safe_dump(spec["ddp"]))
    model = RnntModel.from_config(spec["ddp"])
    model.init_weights(torch.Generator().manual_seed(3))
    spec["ckpt_torch"], spec["ckpt_jax"] = str(root / "ckpt_torch"), \
        str(root / "ckpt_jax")
    tckpt.CheckpointManager(spec["ckpt_torch"]).save(
        1, {"model": model.state_dict()}, {"wer": 0.5})
    infer = {"task": {"type": "pruned_rnnt_inference",
                      "export_path": str(root / "infer_torch"),
                      "train_config": str(train_yaml),
                      "checkpoints_dir": spec["ckpt_torch"]},
             "testset": {"test_data": corpus["eval_data"],
                         "config": {"batch_size": 3,
                                    "feat_type": "lhotes_fbank",
                                    "feat_config": {"num_mel_bins": 80}}},
             "decoding": {"type": "rnnt_greedy_search",
                          "config": {"max_token_step": 1}},
             "streaming": {"is_encoder_streaming": False}}
    spec["infer"] = str(root / "infer.yaml")
    Path(spec["infer"]).write_text(yaml.safe_dump(infer))
    (root / "spec.json").write_text(json.dumps(spec))
    flagship = _seeded(spec["ddp"]).model
    np.savez(root / "start.npz", **flat(to_flax(flagship)))
    return spec, flagship, model


def _jax_side(spec, root, model):
    """The JAX references computed in this process: the NNLM's mesh
    steps, the regularizers' gradients, the 2-device inference report."""
    from speech2text_tpu.ops.regularizers import balancer as jbalancer
    from speech2text_tpu.ops.regularizers import whiten as jwhiten
    from speech2text_tpu.tasks.nnlm import NnLmTask as JLmTask
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    want = {}
    lm = _seeded(spec["nnlm"])
    steps, params = mesh_steps(JLmTask(spec["nnlm"]), spec["nnlm"],
                               to_flax(lm.model), SEED, STEPS)
    want["nnlm"] = (steps, flax_to_state_dict(params, lm.model))
    x, g = regularizer_batch()
    for name, fn in (("balancer", lambda t: jbalancer(t, **BALANCER)),
                     ("whiten", lambda t: jwhiten(t, **WHITEN))):
        want[name] = np.asarray(jax.jit(
            lambda a, b, fn=fn: jax.vjp(fn, a)[1](b)[0])(x, g))
    JCkpt(spec["ckpt_jax"]).save(1, {"params": to_flax(model)}, {"wer": 0.5})
    want["report"] = _jax_report(spec["infer"], str(root / "infer_jax"),
                                 spec["ckpt_jax"])
    return want


def _one_process(spec, root):
    """One process's side of the checks, on the ranks' checkpoints: the
    evaluation of each (the global batches of 2 ranks), the FSDP one
    loaded into a Trainer, the step generators."""
    out = {}
    for mode in ("ddp", "fsdp", "fsdp_remat"):
        cfg = _mesh_config(spec[mode])
        cfg["trainer"]["mesh"] = {"data": 1, "model": 1}
        trainer = Trainer(PrunedRnntTask(cfg), cfg, str(root / f"{mode}_1"),
                          seed=SEED, device="cpu")
        out[f"{mode}_step"] = trainer.init_state(
            resume=os.path.join(spec[f"{mode}_dir"], "checkpoints"))
        trainer.task.data_config.batch_multiple = 2
        out[f"{mode}_eval"] = trainer.evaluate()
        out[f"{mode}_state"] = (trainer.model.state_dict(),
                                trainer.optimizer.state_dict())
        out["draws"] = {str(step): [torch.rand(4, generator=g).tolist()
                                    for g in trainer.generators(step)]
                        for step in (0, 1)}
        trainer.close()
    return out


@pytest.fixture(scope="module")
def run(corpus, tmp_path_factory):  # noqa: F811
    """The torchrun job's outputs beside the JAX side's and one
    process's."""
    root = tmp_path_factory.mktemp("parallel")
    spec, flagship, model = _write_spec(corpus, root)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    jobs = {name: subprocess.Popen(
        [sys.executable] + argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, argv in (
            ("ranks", ["-m", "torch.distributed.run", "--standalone",
                       "--nproc_per_node", "2",
                       str(REPO / "tests/torch_parallel_ranks.py"),
                       str(root / "spec.json")]),
            ("jax", [str(REPO / "tests/jax_mesh_reference.py"),
                     str(root / "spec.json"), "ddp", str(root / "start.npz"),
                     str(root / "jax_ddp")]))}
    logs = {}
    try:
        want = _jax_side(spec, root, model)
        logs["ranks"] = jobs["ranks"].communicate(timeout=600)[0]
        assert jobs["ranks"].returncode == 0, logs["ranks"][-6000:]
        alone = _one_process(spec, root)
        logs["jax"] = jobs["jax"].communicate(timeout=600)[0]
        assert jobs["jax"].returncode == 0, logs["jax"][-6000:]
    finally:
        for job in jobs.values():
            if job.poll() is None:
                job.kill()
                job.communicate()
    want["flagship"] = (
        json.loads((root / "jax_ddp.json").read_text()),
        flax_to_state_dict(nested(dict(np.load(root / "jax_ddp.npz"))),
                           flagship))
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(2)]
    grads = [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]
    return {"spec": spec, "want": want, "ranks": ranks, "grads": grads,
            "alone": alone, "root": root}


def _check_params(got, want, rtol):
    """Each tensor within `rtol` of its largest entry (atol 1e-6 where
    that is below 1e-6); the worst relative error in the message."""
    worst = max((float((got[k] - w).abs().max() / w.abs().max()), k)
                for k, w in want.items() if float(w.abs().max()) > 1e-6)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), rtol=0,
            atol=max(rtol * float(w.abs().max()), 1e-6),
            err_msg=f"{k} (worst relative error {worst[0]:.3g} at "
                    f"{worst[1]})")


def _check_steps(workdir, want_steps, keys):
    got = _lines(workdir)
    assert [r["step"] for r in got] == list(range(1, STEPS + 1))
    for g, w in zip(got, want_steps):
        np.testing.assert_allclose([g[k] for k in keys],
                                   [w.get(k, w["train_loss"]) for k in keys],
                                   rtol=1e-5, err_msg=f"step {g['step']}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
    return got


def _step_state(workdir):
    return tckpt.CheckpointManager(
        os.path.join(workdir, "checkpoints")).restore(STEPS)


@pytest.mark.parametrize("mode", ["ddp", "fsdp", "fsdp_remat"])
def test_two_ranks_match_jax_mesh_step(run, mode):
    """(a), (b): losses, grad_norm and step-3 parameters of 2 ranks against
    JAX's data=2 mesh step (FSDP also with `remat: full`, each layer's
    recompute inside its FSDP unit); the evaluation sharded over the
    ranks equals one process's evaluation of the checkpoint on the same
    batches."""
    spec, (want_steps, want_params) = run["spec"], run["want"]["flagship"]
    _check_steps(spec[f"{mode}_dir"], want_steps, LOSS_KEYS)
    _check_params(_step_state(spec[f"{mode}_dir"])["model"], want_params,
                  1e-4)
    alone = run["alone"][f"{mode}_eval"]
    sharded = run["ranks"][0][f"{mode}_eval"]
    assert set(alone) == set(sharded) == {"val_simple_loss",
                                          "val_pruned_loss", "val_loss",
                                          "wer"}
    for k in alone:
        assert sharded[k] == pytest.approx(alone[k], rel=1e-6), k


def test_fsdp_checkpoint_loads_into_one_process(run):
    """(b): 2 FSDP ranks sharded the parameters; their checkpoint holds
    whole tensors, loads into a 1-process Trainer (weights and ScaledAdam
    state), and equals the 2-rank DDP run's."""
    spec, alone = run["spec"], run["alone"]
    assert all(r["fsdp_sharded"] > 0 for r in run["ranks"])
    fsdp, ddp = _step_state(spec["fsdp_dir"]), _step_state(spec["ddp_dir"])
    assert alone["fsdp_step"] == STEPS
    live, opt = alone["fsdp_state"]
    assert all(torch.equal(live[k], v) for k, v in fsdp["model"].items())
    assert opt["step_count"] == STEPS
    for name in ("delta", "exp_avg_sq", "param_rms"):
        assert all(torch.equal(a, b) for a, b in
                   zip(opt[name], fsdp["optimizer"][name])), name
    _check_params(fsdp["model"], ddp["model"], 1e-4)
    for name in ("delta", "exp_avg_sq"):
        for a, b in zip(fsdp["optimizer"][name], ddp["optimizer"][name]):
            assert a.shape == b.shape


def test_fsdp_remat_equals_fsdp(run):
    """(b): the FSDP run with `remat: full` logs the same losses and
    grad_norm and ends with the same weights and ScaledAdam state as the
    FSDP run without it, bit for bit."""
    spec = run["spec"]
    keys = ("step", "lr", "grad_norm") + LOSS_KEYS
    got, want = ([{k: r[k] for k in keys} for r in _lines(spec[f"{m}_dir"])]
                 for m in ("fsdp_remat", "fsdp"))
    assert len(got) == STEPS and got == want
    remat, fsdp = (_step_state(spec[f"{m}_dir"])
                   for m in ("fsdp_remat", "fsdp"))
    assert all(torch.equal(remat["model"][k], v)
               for k, v in fsdp["model"].items())
    for name in ("delta", "exp_avg_sq", "param_rms"):
        assert all(torch.equal(a, b) for a, b in
                   zip(remat["optimizer"][name], fsdp["optimizer"][name]))


def test_nnlm_global_denominators(run):
    """(c): the masked KL's count is the global batch's on both ranks,
    whose own counts differ: the NNLM steps equal JAX's mesh steps."""
    spec, (want_steps, want_params) = run["spec"], run["want"]["nnlm"]
    tokens = [r["nnlm_tokens"] for r in run["ranks"]]
    assert tokens[0] != tokens[1]
    got = _check_steps(spec["nnlm_dir"], want_steps, ("loss", "train_loss"))
    rows = spec["nnlm"]["dataset"]["batch_size"]
    for i, (g, w) in enumerate(zip(got, want_steps)):
        assert tokens[0][i] + tokens[1][i] == w["frames"]
        assert g["acc"] == pytest.approx(w["acc"], rel=1e-5)
        # the counters count the global batch: its rows and tokens
        assert g["frames_per_sec"] / g["utts_per_sec"] == pytest.approx(
            (w["frames"] + rows) / rows, rel=1e-9)
    _check_params(_step_state(spec["nnlm_dir"])["model"], want_params,
                  1e-5)


@pytest.mark.parametrize("name", ["balancer", "whiten"])
def test_regularizers_over_ranks(run, name):
    """(d): each rank's gradient is its rows of JAX's on the whole batch;
    one process on the whole batch gives the same."""
    want = run["want"][name]
    got = np.concatenate([g[name] for g in run["grads"]])
    tol = dict(rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(regularizer_grads(*regularizer_batch())[name],
                               want, **tol)


def test_sharded_inference_report_equals_jax(run):
    """(e): rank 0's report of 2 ranks = JAX's inference.py on 2 devices."""
    got = (run["root"] / "infer_torch" / "test_report.txt").read_bytes()
    assert got == run["want"]["report"]
    # 6 utterances in batches of 3 rounded up to 4: 8 rows
    assert got.decode().count("\nhyp: ") == 8
    assert all(r["infer"]["num_utts"] == 8 for r in run["ranks"])
    assert run["ranks"][0]["infer"] == run["ranks"][1]["infer"]


def test_draws_per_rank(run):
    """(f): one process keeps the generators of (seed, step, stream);
    over 2 ranks augmentation and dropout are the rank's own and the
    chunk draw is every rank's."""
    def first(seed):
        return torch.rand(4, generator=torch.Generator().manual_seed(
            seed)).tolist()

    for step in (0, 1):
        for stream, draws in zip((STREAM_AUGMENT, STREAM_DROPOUT,
                                  STREAM_CHUNK),
                                 run["alone"]["draws"][str(step)]):
            state = np.random.SeedSequence(
                (SEED, step, stream)).generate_state(1, np.uint64)
            assert draws == first(int(state[0] >> np.uint64(1)))
        ranks = [r["draws"][str(step)] for r in run["ranks"]]
        for r, draws in enumerate(ranks):
            assert draws[0] == first(step_seed(SEED, step, STREAM_AUGMENT,
                                               r))
            assert draws[1] == first(step_seed(SEED, step, STREAM_DROPOUT,
                                               r))
            assert draws[2] == first(step_seed(SEED, step, STREAM_CHUNK))
        assert ranks[0][0] != ranks[1][0] and ranks[0][1] != ranks[1][1]
        assert ranks[0][2] == ranks[1][2]
