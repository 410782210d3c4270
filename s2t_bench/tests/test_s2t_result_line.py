"""The run's last line carries exactly the contract's keys, the checks
last, and only the cell's own metrics; without a card the command
prints no result and exits non-zero."""

import json
import math
import time

import pytest
import torch

from s2t_bench import run as run_mod
from s2t_bench.bench import run_cell
from s2t_bench.tests.tiny import ZIP, tiny_cell

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", [ZIP])
def test_untraced_line(name):
    cell = tiny_cell(name)
    r = json.loads(json.dumps(run_cell(cell, 2 ** 31 + 5, 0.2, False, CPU,
                                       time.perf_counter())))
    assert list(r) == KEYS + ["checks"]
    assert set(r["metrics"]) == {m["name"] for m in cell.metrics(False)}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert r["attempted"] >= 8 and r["failed"] == 0


@pytest.mark.parametrize("name", [ZIP])
def test_traced_line(name):
    cell = tiny_cell(name)
    r = run_cell(cell, 11, 0.2, True, CPU, time.perf_counter())
    assert list(r) == KEYS[:4] + ["breakdown", "device", "checks"]
    assert set(r["metrics"]) <= {m["name"] for m in cell.metrics(True)}
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    rc = run_mod.main(["--workload", ZIP, "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
