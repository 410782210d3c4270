"""BEST-RQ pretraining of the relative-position Conformer
(configs/training/conformer_bestrq_xl.yaml) at tiny widths on the CPU:
2 blocks of width 64, 4 heads, 2 codebooks of 32 × 8.

- The port's SSL step (Trainer.train_step) against the benchmark's plain
  reference (s2t_bench/reference/bestrq.py) on the same weights, batches
  and generators, in f32: the losses (rtol 1e-5: the port averages each
  codebook's masked CE, then the codebooks; the reference takes one mean
  over every (frame, codebook) row, so the sums run in another order),
  every leaf's gradient norm after the first step (rtol 1e-4: the
  gradients pass two blocks' products, summed in another order by the
  gather of the reference and the strided view of the port), and every
  leaf's change after 2 AdamW steps (rtol 1e-3: Adam divides by √ν + ε,
  which magnifies the gradients' rounding where they lie near ε).
- `pos_enc: rel` scores against a double loop over (i, j) that indexes
  the table of offsets directly (atol 1e-5 on scores of order 1: f32).
- The attention's recompute in the backward gives the gradients of the
  plain graph bit for bit, dropout included, and leaves the dropout
  generator where the plain graph leaves it.
- `pos_enc: none` computes today's Conformer bit for bit: the output of
  a frozen copy of its attention and block, and the same seeded init.
- The reference imports neither JAX nor the port.
- build_task trains the YAML for 2 steps at tiny widths.
"""

import copy
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from speech2text_torch import build_task
from speech2text_torch.models import conformer as tc
from speech2text_torch.models.layers import dropout, init_parameters
from speech2text_torch.tasks.factory import TaskFactory
from speech2text_torch.tasks.ssl import SslTask
from speech2text_torch.train.loop import Trainer

from conformer_task_util import BESTRQ_YAML as YAML, bestrq_config, \
    make_corpus, metrics_lines, tiny_recipe_argv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from s2t_bench.reference.bestrq import ReferenceTrainer  # noqa: E402
from s2t_bench.tests.tiny import TINY_TRAFFIC  # noqa: E402
from s2t_bench.weights import write_weights  # noqa: E402
from s2t_bench.workload import NoisePool, Traffic, make_batch  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1021


def _norms(tensors):
    return np.array([float(torch.linalg.vector_norm(t.float()))
                     for t in tensors])


def _readings(model, step, batches):
    params = dict(model.named_parameters())
    names = sorted(params)
    start = [params[n].detach().clone() for n in names]
    losses, grads = [], None
    for i, batch in enumerate(batches):
        out = step(batch, i)
        losses.append(float(out["train_loss" if "train_loss" in out
                                 else "loss"]))
        if i == 0:
            grads = _norms([params[n].grad for n in names])
    change = _norms([params[n].detach() - s for n, s in zip(names, start)])
    return names, np.array(losses), grads, change


@pytest.mark.parametrize("clip", [5.0, 1e-3])
def test_ssl_step_matches_reference(clip):
    """2 steps of the port and of the reference; clip 1e-3 clips every
    step's gradients, 5 none of them."""
    cfg = bestrq_config(clip=clip)
    sampler = cfg["dataset"]["bucket_sampler_config"]
    traffic = Traffic("tiny", TINY_TRAFFIC, sampler)
    noise = NoisePool(traffic, SEED, CPU)
    batches = [make_batch(traffic, noise, SEED, i,
                          traffic.bucket_at(SEED, i), CPU) for i in range(2)]
    with tempfile.TemporaryDirectory() as wd:
        task = TaskFactory("SSL")(copy.deepcopy(cfg))
        trainer = Trainer(task, cfg, wd, seed=SEED, device=CPU)
        write_weights(trainer.model, SEED)
        trainer.init_state()
        got = _readings(trainer.model, trainer.train_step, batches)
        trainer.close()
    ref = ReferenceTrainer(cfg, SEED, CPU, lambda m: write_weights(m, SEED))
    want = _readings(ref.model, ref.train_step, batches)
    assert got[0] == want[0]                  # the same leaves
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-3)
    assert (got[2] > 0).all() and (got[3] > 0).all()


def test_rel_scores_match_a_double_loop():
    g = torch.Generator().manual_seed(3)
    B, H, T, d = 2, 2, 5, 3
    q, k = (torch.randn(B, H, T, d, generator=g) for _ in range(2))
    u, vb = (torch.randn(H, d, generator=g) for _ in range(2))
    table = tc.rel_position_table(T, 4, CPU)
    p = torch.randn(H, 2 * T - 1, d, generator=g)
    got = tc.rel_scores(q, k, u, vb, p)
    want = torch.empty(B, H, T, T)
    for b in range(B):
        for h in range(H):
            for i in range(T):
                for j in range(T):
                    row = (T - 1) - (i - j)       # the offset i − j
                    want[b, h, i, j] = (
                        (q[b, h, i] + u[h]) @ k[b, h, j]
                        + (q[b, h, i] + vb[h]) @ p[h, row]) / math.sqrt(d)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for row in range(2 * T - 1):
        pos = T - 1 - row
        for m in range(2):
            w = 10000.0 ** (-2 * m / 4)
            assert abs(table[row, 2 * m] - math.sin(pos * w)) < 1e-6
            assert abs(table[row, 2 * m + 1] - math.cos(pos * w)) < 1e-6


def _attention(plain, monkeypatch):
    """One training forward and backward of a rel MHSA with dropout: the
    output, the gradients and the dropout generator's state after."""
    m = tc.MaskedMHSA(16, 4, torch.float32, "rel")
    init_parameters(m, torch.Generator().manual_seed(1))
    x = torch.randn(2, 7, 16, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    mask = torch.arange(7)[None] < torch.tensor([7, 4])[:, None]
    if plain:
        monkeypatch.setattr(tc._RelAttention, "apply",
                            lambda *a: tc._rel_attend(*a))
    g = torch.Generator().manual_seed(5)
    y = m(x, mask, 0.3, True, g)
    y.square().sum().backward()
    return y, [p.grad for p in m.parameters()] + [x.grad], g.get_state()


def test_recompute_gives_the_plain_gradients(monkeypatch):
    y, grads, state = _attention(False, monkeypatch)
    y0, grads0, state0 = _attention(True, monkeypatch)
    assert torch.equal(y, y0) and torch.equal(state, state0)
    assert len(grads) == 8 and all(torch.equal(a, b)
                                   for a, b in zip(grads, grads0))


def _old_mhsa(m, x, pad_mask, rate, training, generator):
    """MaskedMHSA.forward before `pos_enc`, frozen."""
    B, T, D = x.shape
    H = m.num_heads
    hd = D // H
    q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
               for t in m.Dense_0(x).chunk(3, dim=-1))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(hd)
    scores = torch.where(pad_mask[:, None, None, :], scores, -1e30)
    attn = torch.softmax(scores, dim=-1).to(m.dtype)
    attn = dropout(attn, rate, training, generator)
    out = torch.matmul(attn.float(), v.float())
    out = out.transpose(1, 2).reshape(B, T, D).to(m.dtype)
    return m.Dense_1(out)


def _old_conformer(enc, feats, lengths, generator):
    """Conformer.forward (training) before `pos_enc`, frozen."""
    h, out_lens = enc.ConvSubsampling_0(feats, lengths)
    pad_mask = torch.arange(h.shape[1])[None, :] < out_lens[:, None]
    for i in range(enc.config.num_layers):
        blk = getattr(enc, f"ConformerBlock_{i}")
        x = h + 0.5 * blk.FeedForward_0(blk.LayerNorm_0(h), True, generator)
        x = x + _old_mhsa(blk.MaskedMHSA_0, blk.LayerNorm_1(x), pad_mask,
                          blk.rate, True, generator)
        x = x + blk.ConvModule_0(blk.LayerNorm_2(x), pad_mask)
        x = x + 0.5 * blk.FeedForward_1(blk.LayerNorm_3(x), True, generator)
        h = blk.LayerNorm_4(x)
    out = torch.where(pad_mask[..., None], enc.Dense_0(h), 0.0)
    return out.float(), out_lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_pos_enc_is_todays_conformer(dtype, monkeypatch):
    cfg = tc.ConformerConfig(input_dim=32, num_heads=4, ffn_dim=64,
                             num_layers=2, depthwise_conv_kernel_size=5,
                             output_dim=24, dtype=dtype)
    assert cfg.pos_enc == "none"
    enc = tc.Conformer(cfg)
    init_parameters(enc, torch.Generator().manual_seed(4))
    # MaskedMHSA's init draws nothing without the relative terms
    monkeypatch.delattr(tc.MaskedMHSA, "init_parameters")
    old = tc.Conformer(cfg)
    init_parameters(old, torch.Generator().manual_seed(4))
    monkeypatch.undo()
    assert enc.state_dict().keys() == old.state_dict().keys()
    assert all(torch.equal(a, b) for a, b in
               zip(enc.state_dict().values(), old.state_dict().values()))
    feats = torch.randn(2, 61, 80, generator=torch.Generator().manual_seed(6))
    lens = torch.tensor([61, 45])
    got = enc(feats, lens, training=True,
              generator=torch.Generator().manual_seed(8))
    want = _old_conformer(enc, feats, lens,
                          torch.Generator().manual_seed(8))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; import s2t_bench.reference.bestrq; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT)).stdout
    loaded = set(out.split())
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "optax",
                         "speech2text_tpu", "speech2text_torch"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def test_build_task_trains_the_yaml(corpus, tmp_path):
    """build_task's main on conformer_bestrq_xl.yaml: width 32, 4 heads,
    one block, 2 codebooks of 16, relative attention, bf16."""
    argv = tiny_recipe_argv(YAML, corpus, str(tmp_path)) + [
        "--override", "encoder.config.num_heads=4",
        "--override", "ssl.best_rq.num_codebooks=2",
        "--override", "ssl.best_rq.codebook_size=16"]
    trainer = build_task.main(argv)
    task = trainer.task
    assert isinstance(task, SslTask) and trainer.clip == 5.0
    enc = task.model.encoder
    assert enc.config.pos_enc == "rel" and enc.config.dtype == "bfloat16"
    assert enc.ConformerBlock_0.MaskedMHSA_0.Dense_2.weight.shape == (32, 32)
    assert task.best_rq.codebooks.shape == (2, 16, 16)
    assert task.best_rq.cfg.distance == "cosine"
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite([r["loss"], r["acc"], r["mask_rate"],
                            r["grad_norm"]]).all() for r in lines)
    assert set(trainer.last_eval) == {"val_loss", "acc"}
