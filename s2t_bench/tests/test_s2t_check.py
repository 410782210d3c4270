"""The check that decides `correct`, driven through a whole run of the
tiny cells on the CPU with the timed path broken underneath: a sound run
is correct, and a step that leaves its state unchanged, a step that
leaves out half of the batch, and the control (the reference one
precision lower in the program's place) are not."""

import time

import pytest
import torch

import s2t_bench.bench as bench
from s2t_bench.check import lower_precision
from s2t_bench.program import Program
from s2t_bench.reference.step import ReferenceTrainer
from s2t_bench.tests.tiny import ZIP, tiny_cell
from s2t_bench.weights import write_weights

CPU = torch.device("cpu")


class Unchanged(Program):
    """The optimizer's update never lands."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.optimizer.step = lambda: None


class HalfBatch(Program):
    """Half of every batch's rows left out, the mean over the rest."""

    def train_step(self, batch, step):
        return super().train_step(
            {k: v[: v.shape[0] // 2] for k, v in batch.items()}, step)


class Control:
    """The plain reference in a lower precision, in the program's place."""

    def __init__(self, cfg, seed, device, workdir):
        self.ref = ReferenceTrainer(cfg, seed, device,
                                    lambda m: write_weights(m, seed))
        self.model = self.ref.model
        self.device = device

    def train_step(self, batch, step):
        with lower_precision(self.device):
            out = self.ref.train_step(batch, step)
        out["train_loss"] = out.pop("loss")
        return out

    @staticmethod
    def launches():
        return {"attn_weights": 0, "fbank": 0}

    def close(self):
        pass


def run(name, program=None, monkeypatch=None):
    if program is not None:
        monkeypatch.setattr(bench, "Program", program)
    return bench.run_cell(tiny_cell(name), 31337, 0.2, False, CPU,
                          time.perf_counter())


@pytest.mark.parametrize("name", [ZIP])
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] is True
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", [ZIP])
@pytest.mark.parametrize("fault,number", [(Unchanged, "change_gap"),
                                          (HalfBatch, None),
                                          (Control, None)])
def test_fault_is_not_correct(name, fault, number, monkeypatch):
    r = run(name, fault, monkeypatch)
    assert r["correct"] is False
    over = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert over
    if number:
        assert number in over
