"""The training loop's options in the port against the JAX package, on the
CPU, on a synthetic corpus (tests/conformer_task_util.py's tiny CTC
Conformer, augmentation off but speed perturbation):

- gradient accumulation (`trainer.accumulate_grad_batches: 2`,
  optim/setup.py:MultiSteps) over 4 micro-batches against JAX's Trainer
  with optax.MultiSteps, with AdamW + Warmup (clipping 5.0 on the mean)
  and with ScaledAdam + Eden: each micro-batch's loss rtol 1e-5 and
  grad_norm rtol 1e-4, the logged lr (the schedule at step // 2) rtol
  1e-6, the parameters after the 4 micro-batches rtol 1e-5 (atol 1e-6
  for AdamW; 4.5e-5, 1e-3 of the lr, for ScaledAdam, whose normalised
  step on an element of near-zero mean gradient takes the sign its
  rounding gives), the optimizer's count 2; a run stopped between two
  micro-batches (step 3) resumes to the same step-4 weights bitwise;
- global CMVN statistics computed by build_task (`callbacks.global_cmvn.
  apply` with no statistics file), over 10 train batches: its cmvn.json
  equals, byte for byte,
  the file of the JAX package's `compute_cmvn_stats` over the same
  featurized batches, and each package loads the other's file.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.models.cmvn import GlobalCmvn as JCmvn
from speech2text_tpu.models.cmvn import compute_cmvn_stats as j_stats

from speech2text_torch import build_task
from speech2text_torch.config import dumps
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.models.cmvn import GlobalCmvn
from speech2text_torch.optim import MultiSteps
from speech2text_torch.tasks.ctc import CtcTask
from speech2text_torch.train.loop import Trainer

from conformer_task_util import ctc_config, make_corpus, metrics_lines

# ScaledAdam's step on an element whose mean gradient is near 0 is a
# normalised ±lr·rms whose sign rounding decides: 1e-3 of its lr there
PARAM_ATOL = {"AdamW": 1e-6, "ScaledAdam": 4.5e-5}
SCALED_ADAM = {"optimizer": {"type": "ScaledAdam", "config": {"lr": 0.045}},
               "lr_scheduler": {"type": "Eden",
                                "config": {"lr_batches": 7000}}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def _accum_config(corpus, workdir, optimizer):
    cfg = ctc_config(corpus, workdir)
    cfg["trainer"] = dict(cfg["trainer"], accumulate_grad_batches=2)
    if optimizer == "ScaledAdam":
        cfg["optim_setup"] = SCALED_ADAM
    return cfg


@pytest.mark.parametrize("optimizer", ["AdamW", "ScaledAdam"])
def test_accumulation_matches_jax_multisteps(corpus, tmp_path, optimizer):
    from speech2text_tpu.parallel.mesh import MeshConfig, make_mesh
    from speech2text_tpu.tasks.ctc import CtcTask as JTask
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    from speech2text_tpu.train.loop import Trainer as JTrainer

    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tcfg = _accum_config(corpus, tdir, optimizer)
    jcfg = _accum_config(corpus, jdir, optimizer)
    trainer = Trainer(CtcTask(tcfg), tcfg, tdir, seed=7, device="cpu")
    start = jax.tree.map(jnp.asarray, to_flax(trainer.task.model))
    trainer.fit(max_steps=4)
    trainer.close()
    opt = trainer.optimizer
    assert isinstance(opt, MultiSteps) and opt.gradient_step == 2
    assert opt.mini_step == 0
    inner = opt.optimizer.state_dict()
    assert inner.get("count", inner.get("step_count")) == 2
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtrainer = JTrainer(JTask(jcfg), jcfg, jdir, seed=7, mesh=mesh)
    assert jtrainer.accum == 2
    jtrainer.fit(finetune_params=start, max_steps=4)

    got, want = metrics_lines(tdir), metrics_lines(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        [1, 2, 3, 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                   err_msg=f"step {g['step']}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    # micro-batches 1-2 share the first update: the loss moves after it
    assert got[2]["loss"] != got[0]["loss"]
    jparams = JCkpt(os.path.join(jdir, "checkpoints")).restore(4)["params"]
    want_sd = flax_to_state_dict(jax.tree.map(np.asarray, jparams),
                                 trainer.task.model)
    live = trainer.task.model.state_dict()
    atol = PARAM_ATOL[optimizer]
    for k, w in want_sd.items():
        np.testing.assert_allclose(live[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=atol, err_msg=k)
    if optimizer == "ScaledAdam":
        return
    # a run stopped at micro-batch 3 checkpoints half a mean; resumed, it
    # reaches the uninterrupted run's step-4 weights bitwise
    rdir = str(tmp_path / "resumed")
    rcfg = _accum_config(corpus, rdir, optimizer)
    for steps in (3, 4):
        again = Trainer(CtcTask(rcfg), rcfg, rdir, seed=7, device="cpu")
        again.fit(max_steps=steps)
        again.close()
        if steps == 3:
            saved = again.ckpt.restore(3)["optimizer"]
            assert saved["mini_step"] == 1 and saved["gradient_step"] == 1
            assert any(float(t.abs().max()) > 0 for t in saved["acc"])
    assert [h["step"] for h in again.history] == [4]
    assert all(torch.equal(a, live[k]) for k, a in
               again.task.model.state_dict().items())


def test_global_cmvn_computed_like_jax(corpus, tmp_path, monkeypatch):
    # more batches than one epoch of the corpus holds (4), fewer than the
    # 200 the entry reads by default
    monkeypatch.setattr(build_task, "CMVN_BATCHES", 10)
    cfg = ctc_config(corpus, str(tmp_path / "tasks" / "cmvn"))
    cfg["callbacks"]["global_cmvn"] = {"apply": True}
    path = tmp_path / "cmvn.yaml"
    path.write_text(dumps(cfg))
    trainer, _ = build_task.prepare([f"--training_config={path}",
                                     "--device", "cpu"])
    trainer.close()
    got_path = os.path.join(trainer.workdir, "cmvn.json")
    task = trainer.task
    with open(got_path) as f:
        got = json.load(f)
    assert len(got["mean"]) == len(got["istd"]) == 80
    assert torch.equal(task.cmvn.mean, torch.tensor(got["mean"]))
    assert torch.equal(task.cmvn.istd, torch.tensor(got["istd"]))

    fresh = CtcTask(cfg)
    batches = list(build_task.cmvn_feature_batches(fresh,
                                                   torch.device("cpu")))
    assert len(batches) == build_task.CMVN_BATCHES
    want_path = str(tmp_path / "jax_cmvn.json")
    j_stats(batches).save(want_path)
    with open(got_path, "rb") as f, open(want_path, "rb") as g:
        assert f.read() == g.read()
    # each package loads the other's file
    jc = JCmvn.from_file(got_path)
    tc = GlobalCmvn.from_file(want_path)
    assert np.array_equal(np.asarray(jc.mean), tc.mean.numpy())
    assert np.array_equal(np.asarray(jc.istd), tc.istd.numpy())
    x = np.random.default_rng(0).standard_normal((2, 5, 80)).astype(
        np.float32)
    np.testing.assert_allclose(tc(torch.from_numpy(x)).numpy(),
                               np.asarray(jc(jnp.asarray(x))), rtol=1e-6)
    # a second run finds the file and computes nothing
    trainer2, _ = build_task.prepare([f"--training_config={path}",
                                      "--device", "cpu"])
    trainer2.close()
    assert torch.equal(trainer2.task.cmvn.mean, task.cmvn.mean)
