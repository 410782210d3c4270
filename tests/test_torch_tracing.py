"""The port's spans and their recorder (speech2text_torch/utils/tracing.py)
on one tiny pruned RNN-T train step on the CPU. Off, the recorder keeps
nothing and registers no autograd hook, and the step's autograd graph is
the same as with it on; on, it keeps the step's spans with their
parents, the pruned lattice's backward inside `backward`, and changes no
loss and no gradient. `backward_span` opens at the gradient's arrival at
its start and closes once it has reached every end."""

import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from speech2text_torch.tasks.rnnt import train_losses
from speech2text_torch.train.step import TrainStep, take_step
from speech2text_torch.utils import tracing

VOCAB = 32
CHUNK = (8, 4)


def _config():
    cfg = _tiny_config(VOCAB)
    cfg["dataset"] = {"feat_type": "lhotes_fbank",
                      "feat_config": {"num_mel_bins": 80,
                                      "snip_edges": True}}
    cfg["loss"] = {"model": "Pruned_Rnnt", "simple_loss_scale": 0.5,
                   "pruned_loss_scale": 0.5,
                   "config": {"termination_symbol": 0, "reduction": "mean"},
                   "enable_ctc": False}
    cfg["optim_setup"] = {
        "optimizer": {"type": "ScaledAdam",
                      "config": {"lr": 0.045, "clipping_scale": 2.0}},
        "lr_scheduler": {"type": "Eden", "config": {"lr_batches": 7000}}}
    return cfg


def _graph(t):
    """The type names of every node of t's autograd graph, sorted."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        todo.extend(f for f, _ in n.next_functions)
    return sorted(type(n).__name__ for n in seen)


def _step(record: bool):
    """One seeded step; what the recorder kept, the hooks registered, the
    graph, the losses, gradients and parameters."""
    ts = TrainStep.from_config(_config(), device="cpu", seed=0)
    rng = np.random.default_rng(0)
    N, U = 16000, 6
    pcm = (0.1 * rng.standard_normal((2, N))).astype(np.float32)
    feats, feat_lens = ts.featurize(pcm, np.array([N, 3 * N // 4], np.int32))
    labels = torch.from_numpy(rng.integers(1, VOCAB, (2, U)).astype(np.int64))
    label_lens = torch.tensor([U, U - 2])
    got = {}

    def losses_fn():
        out = train_losses(ts.model, ts.loss_fn, feats, feat_lens, labels,
                           label_lens, CHUNK, ts.generator, 0)
        got["graph"] = _graph(out["loss"])
        return out

    hooks = []
    real = torch.Tensor.register_hook

    def counted(t, fn):
        hooks.append(fn)
        return real(t, fn)

    tracing.take()
    if record:
        tracing.enable()
    try:
        with mock.patch.object(torch.Tensor, "register_hook", counted):
            out = take_step(ts.model, losses_fn, ts.optimizer)
    finally:
        tracing.disable()
    got.update(
        records=tracing.take(), hooks=len(hooks), losses=out,
        grads={n: p.grad for n, p in ts.model.named_parameters()
               if p.grad is not None},
        params={n: p.detach() for n, p in ts.model.named_parameters()})
    return got


@pytest.fixture(scope="module")
def steps():
    return {"off": _step(False), "on": _step(True)}


def test_off_records_nothing_and_registers_no_hook(steps):
    off, on = steps["off"], steps["on"]
    assert off["records"] == []
    assert off["hooks"] == 0
    assert on["hooks"] == 3        # the pruned loss's nll, px_full, py_full
    assert off["graph"] == on["graph"]


def test_spans_and_parents(steps):
    recs = steps["on"]["records"]
    names = [r.name for r in recs]
    for name in ("simple_loss", "prune_ranges", "pruned_loss"):
        assert names.count(name) == 1, name
        (r,) = [r for r in recs if r.name == name]
        assert r.parent == "joiner_losses"
    assert names.count("joiner_losses") == 2
    assert names.count("attn_weights_backward") == 2    # one per layer
    assert names.count("pruned_loss_backward") == 1
    assert all(r.start_ns <= r.end_ns for r in recs)
    (back,) = [r for r in recs if r.name == "backward"]
    for r in recs:
        if r.name in ("pruned_loss_backward", "attn_weights_backward"):
            assert back.start_ns <= r.start_ns <= r.end_ns <= back.end_ns


@pytest.mark.parametrize("part", ["losses", "grads", "params"])
def test_recorder_changes_no_number(steps, part):
    off, on = steps["off"][part], steps["on"][part]
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("case", ["off", "ends_without_grad", "one_end",
                                  "two_ends"])
def test_backward_span(case):
    """The span opens before any later hook on its start runs and closes
    after every earlier hook on its ends has run; off, or with no end
    that takes a gradient, it registers nothing."""
    x = torch.randn(3, requires_grad=True)
    y = torch.randn(3, requires_grad=case != "ends_without_grad")
    a, b = x * 2.0, y * 3.0
    start = (a * b).sum()
    ends = {"one_end": (a,), "ends_without_grad": (b,)}.get(case, (a, b))
    seen = {}

    def stamp(name):
        def hook(grad):
            seen.setdefault(name, time.time_ns())
        return hook

    for name, t in zip("ab", ends):
        if t.requires_grad:
            t.register_hook(stamp(name))
    tracing.take()
    if case != "off":
        tracing.enable()
    registered = []
    real = torch.Tensor.register_hook
    try:
        with mock.patch.object(torch.Tensor, "register_hook",
                               lambda t, fn: registered.append(fn)
                               or real(t, fn)):
            tracing.backward_span("stretch", start, ends)
        start.register_hook(stamp("start"))
        start.backward()
    finally:
        tracing.disable()
    recs = tracing.take()
    if case in ("off", "ends_without_grad"):
        assert (recs, registered) == ([], [])
        return
    assert len(registered) == 1 + len(ends)
    (r,) = recs
    assert (r.name, r.parent) == ("stretch", None)
    assert r.start_ns <= seen["start"]
    assert max(seen[n] for n in "ab"[:len(ends)]) <= r.end_ns
    assert seen["start"] <= min(seen[n] for n in "ab"[:len(ends)])


def test_recorder_threads_and_take():
    tracing.take()
    with tracing.span("outside"):
        pass
    assert tracing.take() == []
    tracing.enable()
    try:
        with tracing.span("a"):
            with tracing.span("b"):
                t = threading.Thread(target=lambda: tracing.span("c")
                                     .__enter__().__exit__(None, None, None))
                t.start()
                t.join()
    finally:
        tracing.disable()
    recs = {r.name: r for r in tracing.take()}
    assert tracing.take() == []
    assert (recs["a"].parent, recs["b"].parent, recs["c"].parent) == \
        (None, "a", None)
    assert recs["a"].thread == recs["b"].thread != recs["c"].thread
    assert recs["a"].start_ns <= recs["b"].start_ns <= recs["b"].end_ns \
        <= recs["a"].end_ns


def test_ssl_step_spans():
    """One SSL step (conformer_bestrq_xl.yaml at tiny widths: 2 blocks of
    relative attention) with the recorder on: the two featurizes, the
    targets, the encoder with one `mhsa` per block inside it, the head
    twice (logits, then the loss), the backward and the optimizer."""
    from conformer_task_util import bestrq_config
    from speech2text_torch.optim import OptimSetup
    from speech2text_torch.tasks.factory import TaskFactory
    cfg = bestrq_config()
    task = TaskFactory("SSL")(cfg)
    task.init_weights(torch.Generator().manual_seed(0))
    optimizer, _ = OptimSetup(cfg["optim_setup"],
                              task.model.named_parameters())
    g = torch.Generator().manual_seed(1)
    batch = {"pcm": torch.randint(-3000, 3000, (2, 16000), generator=g,
                                  dtype=torch.int16),
             "pcm_length": torch.tensor([16000, 12000], dtype=torch.int32),
             "noise_pcm": torch.randint(-3000, 3000, (2, 8000), generator=g,
                                        dtype=torch.int16),
             "noise_length": torch.tensor([8000, 6000], dtype=torch.int32)}
    gens = (torch.Generator().manual_seed(2), torch.Generator().manual_seed(3))
    tracing.take()
    tracing.enable()
    try:
        take_step(task.model, task.step_losses(batch, 0, gens), optimizer,
                  5.0)
    finally:
        tracing.disable()
    recs = tracing.take()
    names = [r.name for r in recs]
    want = {"featurize": 2, "ssl_targets": 1, "encoder": 1, "mhsa": 2,
            "ssl_head": 2, "backward": 1, "optimizer": 1}
    assert {n: names.count(n) for n in set(names)} == want
    (enc,) = [r for r in recs if r.name == "encoder"]
    for r in recs:
        assert r.parent == ("encoder" if r.name == "mhsa" else None), r
        if r.name == "mhsa":
            assert enc.start_ns <= r.start_ns <= r.end_ns <= enc.end_ns
    order = [n for n in names if n != "mhsa"]
    assert order == ["featurize", "featurize", "ssl_targets", "encoder",
                     "ssl_head", "ssl_head", "backward", "optimizer"]
