"""On the card, at each cell's own sizes (one seed): the program's
checked steps pass the cell's limits against the plain reference, and
the control (the reference one precision lower) does not.

    python3 -m pytest s2t_bench/tests -m card
"""

import pytest

from s2t_bench.bench import set_precision
from s2t_bench.calibrate import readings
from s2t_bench.cell import load_cell
from s2t_bench.check import CHECKED_STEPS, compare, limits_of, verdict
from s2t_bench.tests.tiny import ZIP
from s2t_bench.workload import NoisePool, Traffic, make_batch

SEED = 9700000001


@pytest.mark.card
@pytest.mark.parametrize("name", [ZIP])
def test_program_passes_and_control_fails(name, card):
    cell = load_cell(name)
    set_precision(cell.meta)
    sampler = cell.train_config["dataset"]["bucket_sampler_config"]
    traffic = Traffic(cell.traffic, cell.traffic_spec, sampler)
    noise = NoisePool(traffic, SEED, card)
    first = [traffic.bucket_at(SEED, i) for i in range(CHECKED_STEPS)]

    def batch_of(i):
        return make_batch(traffic, noise, SEED, i, first[i], card)
    ref = readings(cell, SEED, "reference", card, batch_of)
    limits = limits_of(name)
    assert verdict(compare(readings(cell, SEED, "program", card, batch_of),
                           ref), limits)
    assert not verdict(compare(readings(cell, SEED, "control", card,
                                        batch_of), ref), limits)
