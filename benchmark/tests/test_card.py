"""A short run of every cell on the card, as the benchmark's command runs
it: the last line of standard output is the result, correct, with its
metrics. Marked ``gpu``; skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import manifest as mf


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_correct_on_the_card(root, card, trace):
    man = mf.load_manifest(root)
    for w in man["workloads"]:
        proc = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload", w["name"],
             "--seed", "987654321", "--seconds", "4", "--trace", str(trace)],
            cwd=root, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["correct"], out["checks"]
        assert out["device"]["kind"] == card
        want = {m["name"] for m in mf.metrics_of(man, w["name"], traced=bool(trace))}
        assert set(out["metrics"]) == want
