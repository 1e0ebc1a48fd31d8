"""The control (the reference in bfloat16 in the program's place) fails
every cell's limits, at a sub-sampled size on the CPU. On the card's host
the same runs at the cells' own size:
``python3 -m benchmark.control --workload <name> --seeds 1 2 3``."""

import pytest

from benchmark import manifest as mf
from benchmark.control import control_numbers


def _cells(root):
    return [w["name"] for w in mf.load_manifest(root)["workloads"]]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_the_control_is_not_correct(root, seed):
    for workload in _cells(root):
        out = control_numbers(root, workload, seed, sub=8)
        assert not out["correct"], out
        # the labels alone tell it apart
        lab = out["checks"]["label_mismatch"]
        assert lab["value"] > lab["limit"], out
