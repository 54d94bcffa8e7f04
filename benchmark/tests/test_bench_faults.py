"""The comparison fails what it must: the control (the reference in
float8, the step below the configuration's bfloat16, put in the program's
place) and each fault a cell can have, planted in the program, make
``correct`` come out false under the cell's limits. The harness's look
for a card is skipped; the rest of a run is driven on the CPU at a small
size, with the kernels' plain versions and the graphed route's stand-in.
Card-only: the same on the card, at the cells' own size, is
``benchmark/readings.py`` (its readings are in PERF.md)."""
import pytest
import torch

from benchmark import compare, faults, harness, reference
from benchmark.tests.cpu import small_run

TRAIN = ["gcn_reddit.train_learned", "gat_gsage_reddit.train_learned",
         "gcn_reddit.train_random"]
SERVE = ["gcn_reddit.serve_predict"]


def _verdict(cell, numbers):
    return compare.verdict(numbers, harness.Cell(cell).limits)[0]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell):
    """In float32, where the program follows the reference to rounding:
    at this small size bfloat16's gaps are no reading of the cell's."""
    _, _, numbers = small_run(cell, 2 ** 31 + 5, flags=dict(dtype="float32"))
    assert _verdict(cell, numbers), numbers


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_control_is_not_correct(cell):
    run, _, _ = small_run(cell, 2 ** 31 + 6)
    numbers = run.check(reference.FP8, control=True)
    assert not _verdict(cell, numbers), numbers


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in TRAIN + SERVE for f in faults.CAUGHT[c]])
def test_a_planted_fault_is_not_correct(cell, fault):
    torch.manual_seed(0)
    with faults.FAULTS[fault]():
        _, _, numbers = small_run(cell, 2 ** 31 + 7)
    assert not _verdict(cell, numbers), (fault, numbers)
