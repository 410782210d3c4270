"""The Conformer family's tasks of the port against the JAX package's, on a
synthetic corpus written to tmp_path (speech2text_torch/tools/
synth_corpus.py), on the CPU:

- a tiny conformer_ctc (1 Conformer layer × 32, Projector head, CTC,
  AdamW + Warmup, `gradient_clip_val: 5.0`, dropout and augmentation off
  but speed perturbation) trained by the port's Trainer and by JAX's from
  the same weights: the three steps' logged losses within rtol 1e-5
  (grad_norm rtol 1e-4), then one evaluation: val_loss within rtol 1e-5,
  WER and the hypotheses of the trained models equal;
- a pruned RNN-T + CTC step of a tiny Conformer (Projector head,
  `enable_ctc`) through train/step.py:take_step against JAX's `loss_fn`:
  the losses (simple, pruned, ctc, total) and every gradient within rtol
  1e-5.

The family's inference YAMLs and build_task on its YAML are
tests/test_torch_conformer_inference.py's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.tasks.ctc import CtcTask
from speech2text_torch.tasks.rnnt import PrunedRnntTask
from speech2text_torch.train.loop import Trainer
from speech2text_torch.train.step import take_step

from conformer_task_util import ctc_config, make_corpus, metrics_lines, \
    pruned_config


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def test_ctc_trainer_matches_jax_trainer(corpus, tmp_path):
    from speech2text_tpu.parallel.mesh import MeshConfig, make_mesh
    from speech2text_tpu.tasks.ctc import CtcTask as JTask
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    from speech2text_tpu.train.loop import Trainer as JTrainer

    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tcfg, jcfg = ctc_config(corpus, tdir), ctc_config(corpus, jdir)
    task = CtcTask(tcfg)
    trainer = Trainer(task, tcfg, tdir, seed=7, device="cpu")
    assert trainer.clip == 5.0
    start = jax.tree.map(jnp.asarray, to_flax(task.model))
    got_eval = trainer.fit(max_steps=3)
    trainer.close()

    jtask = JTask(jcfg)
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtrainer = JTrainer(jtask, jcfg, jdir, seed=7, mesh=mesh)
    want_eval = jtrainer.fit(finetune_params=start, max_steps=3)

    got, want = metrics_lines(tdir), metrics_lines(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(w) <= set(g)
        np.testing.assert_allclose([g["loss"], g["train_loss"]],
                                   [w["loss"], w["train_loss"]], rtol=1e-5,
                                   err_msg=f"step {g['step']}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert got[2]["loss"] != got[0]["loss"]

    assert set(got_eval) == set(want_eval) == {"val_loss", "wer"}
    assert got_eval["val_loss"] == pytest.approx(want_eval["val_loss"],
                                                 rel=1e-5)
    assert got_eval["wer"] == want_eval["wer"]

    jparams = JCkpt(os.path.join(jdir, "checkpoints")).restore(3)["params"]
    fwd = jtrainer._eval_fwd          # the evaluation's compiled forward
    hyps, jhyps = [], []
    for batch in task.make_eval_pipeline():
        arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
        hyps += task.eval_hyps(task.eval_forward(
            {k: torch.from_numpy(v) for k, v in arrays.items()}))
        jhyps += jtask.eval_hyps(fwd(jparams, jax.tree.map(jnp.asarray,
                                                           arrays)))
    assert hyps == jhyps and any(hyps)
    # the AdamW state of the checkpoint resumes bitwise
    state = trainer.ckpt.restore(3)
    assert state["optimizer"]["count"] == 3
    again = Trainer(CtcTask(tcfg), tcfg, tdir, seed=7, device="cpu")
    assert again.init_state() == 3
    live = again.optimizer.state_dict()
    assert all(torch.equal(a, b) for k in ("mu", "nu")
               for a, b in zip(state["optimizer"][k], live[k]))
    again.close()


class _KeepGrads:
    """An optimizer stand-in that leaves the gradients in place."""

    def zero_grad(self):
        pass

    def step(self):
        pass


def test_pruned_ctc_step_matches_jax_loss_fn(corpus, tmp_path):
    from speech2text_tpu.tasks.rnnt import PrunedRnntTask as JTask
    cfg = pruned_config(corpus, str(tmp_path / "p"))
    task = PrunedRnntTask(cfg)
    assert task.loss.enable_ctc and task.loss.ctc_weight == 0.3
    task.model.init_weights(torch.Generator().manual_seed(3))
    params = to_flax(task.model)
    assert "decoder" in params
    pipe = task.make_train_pipeline(seed=5)
    it = iter(pipe)
    batch = next(it)
    it.close()
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    feats, feat_lens = task.featurize(tb, training=False)
    got = take_step(task.model, lambda: task.train_losses(
        feats, feat_lens, tb, None, torch.Generator()), _KeepGrads())

    jtask = JTask(cfg)

    def loss_fn(p):
        return jtask.loss_fn(p, jax.tree.map(jnp.asarray, arrays),
                             jax.random.PRNGKey(0), 0)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params))
    for k in ("simple_loss", "pruned_loss", "ctc_loss"):
        assert float(got[k]) == pytest.approx(float(metrics[k]), rel=1e-5), k
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)
    assert int(got["frames"]) == int(metrics["frames"])
    want = flax_to_state_dict(jax.tree.map(np.asarray, grads), task.model)
    named = dict(task.model.named_parameters())
    assert named["decoder.Dense_0.weight"].grad.abs().max() > 0
    for k, g in want.items():
        p = named[k].grad
        np.testing.assert_allclose(p.numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()) + 1e-12,
                                   err_msg=k)
