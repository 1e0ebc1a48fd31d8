"""The reader of ``frame.inherited_planes.drive``: the program's counter
over the scans of the facade's steps, nothing where the program has no
such counter (the default ``Params()``, or a program that predates it),
and a number in a small traced run of the launch-profile cell on the CPU."""

import sys
import types
import time

import pytest

from benchmark import manifest as mf
from benchmark import run
from benchmark.metrics import _spans

profiling = pytest.importorskip("patchworkpp_tpu_torch.utils.profiling")
from benchmark.tests.test_faults import SMALL  # noqa: E402

NAME = "frame.inherited_planes.drive"
CELL = "ros_launch_hdl64.drive_seq24"


def _fake(monkeypatch, counters, steps):
    def spans(name=None):
        return [profiling.SpanRecord("facade.step", 0, 1, 0, i, i, s, False)
                for i, s in enumerate(steps) if name in (None, "facade.step")]

    mod = types.SimpleNamespace(spans=spans, counters=lambda: counters)
    monkeypatch.setitem(sys.modules, _spans.MODULE, mod)


def test_the_count_is_taken_over_the_scans_of_every_step(monkeypatch):
    _fake(monkeypatch, {"frame.inherited_planes": profiling.Count(960, 0.0)}, [24, 24, 24, 24])
    assert mf.reader(NAME)(None) == pytest.approx(10.0)


def test_a_program_without_the_counter_gives_nothing_to_read(monkeypatch):
    _fake(monkeypatch, {"facade.step": profiling.Count(4, 1.0)}, [24, 24])
    assert mf.reader(NAME)(None) is None
    _fake(monkeypatch, {"frame.inherited_planes": profiling.Count(9, 0.0)}, [])
    assert mf.reader(NAME)(None) is None
    monkeypatch.setitem(sys.modules, _spans.MODULE, types.SimpleNamespace(spans=lambda n=None: []))
    assert mf.reader(NAME)(None) is None
    monkeypatch.delitem(sys.modules, _spans.MODULE)
    assert mf.reader(NAME)(None) is None


def test_a_small_traced_run_of_the_cell_reports_the_count(root):
    profiling.clear()
    man = mf.load_manifest(root)
    cell = mf.workload(man, CELL)
    cfg = dict(mf.config(man, root, cell["config"]), capacity=8192)
    mix = mf.traffic(cell["traffic"])
    mix = dict(mix, **SMALL[mix["entry"]])
    out = run.run_cell(root, man, CELL, 2**31 + 11, 1.0, True, "cpu", time.perf_counter(),
                       cfg=cfg, mix=mix, sub=32)
    # of the 504 patches a scan, every one processed, the empty ones through the carry
    assert 0 < out["metrics"][NAME]["value"] < 504
    assert out["metrics"][NAME]["unit"] == "planes/scan"
