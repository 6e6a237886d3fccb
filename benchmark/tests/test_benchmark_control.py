"""The control of the cell's comparison and the fault the comparison has to
catch, on the card at the cell's own size, each on three seeds: the plain
reference computed in fp8 (``benchmark/reference/lowp.py``), the step below
the configuration's bf16, put in the program's place; and the program's
step with its loss taken over half of the batch's documents (the forward
over all of them). Both have to come out as not correct. Run on the card:

    python3 -m pytest benchmark/tests/test_benchmark_control.py -q
"""

import contextlib
import io
import json

import pytest

from benchmark.harness import cli
from benchmark.tests.test_benchmark_harness import CELL, _train_fault

SEEDS = (2**40 + 11, 2**40 + 12, 2**40 + 13)


def _run(seed, control=0, faults=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.run(["--workload", CELL, "--seed", str(seed), "--seconds", "3",
                      "--control", str(control)], faults=faults)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(card, seed):
    result = _run(seed, control=1)
    assert result["correct"] is False, result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_loss_over_half_the_batch_is_not_correct(card, seed):
    result = _run(seed, faults=_train_fault("half_loss"))
    assert result["correct"] is False, result["compared"]
