"""The ``program_span`` metrics that read the program's span recorder: both
cells run traced on the CPU at ``test_faults.py``'s small size report every
host span metric; the readers' arithmetic on made-up records; a program
without the recorder gives nothing to read."""

import sys
import types

import pytest

from benchmark import manifest as mf
from benchmark.metrics import _spans

profiling = pytest.importorskip("patchworkpp_tpu_torch.utils.profiling")
from benchmark.tests.test_faults import CELLS, _run  # noqa: E402

SpanRecord = profiling.SpanRecord

HOST = {
    "kitti_hdl64.drive_seq24": ["facade.upload_ms.drive", "dispatch.launch_ms.drive",
                                "facade.readback_ms.drive", "facade.unpack_ms.drive"],
    "kitti_hdl64.replay_closed": ["server.queue_ms.replay", "facade.upload_ms.replay",
                                  "dispatch.launch_ms.replay", "facade.readback_ms.replay",
                                  "facade.unpack_ms.replay"],
}


@pytest.mark.parametrize("workload", CELLS)
def test_every_host_span_metric_reports_a_number(root, workload):
    profiling.clear()
    out = _run(root, workload, traced=True)
    assert out["correct"], out["checks"]
    for name in HOST[workload]:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    # a replay's device time and the graph's capture exist on the card only
    assert not [n for n in out["metrics"] if n.startswith("frame.span_ms")]
    assert "dispatch.capture_s" not in out["metrics"]
    spans = {r.name for r in profiling.spans()}
    assert {"facade.step", "facade.stage", "dispatch.launch"} <= spans


def _fake(monkeypatch, records):
    def spans(name=None):
        return [r for r in records if name is None or r.name == name]

    monkeypatch.setitem(sys.modules, _spans.MODULE, types.SimpleNamespace(spans=spans))


def _rec(name, dur_ms, request, scans=1, profiled=False, id=0, parent=0):
    return SpanRecord(name, 0, int(dur_ms * 1e6), parent, id, request, scans, profiled)


def test_span_readers_sum_a_request_and_leave_profiled_records_out(monkeypatch):
    _fake(monkeypatch, [
        _rec("facade.stage", 12.0, 1, scans=24), _rec("facade.upload", 12.0, 1, scans=24),
        _rec("facade.stage", 24.0, 2, scans=24), _rec("facade.upload", 24.0, 2, scans=24),
        _rec("facade.stage", 48.0, 3, scans=24), _rec("facade.upload", 48.0, 3, scans=24),
        # profiled: left out whole, however long
        _rec("facade.stage", 1e3, 4, scans=24), _rec("facade.upload", 1.0, 4, scans=24,
                                                      profiled=True),
        # a request without its upload is left out
        _rec("facade.stage", 1e3, 5, scans=24),
        _rec("frame.span", 2.0, 1), _rec("frame.span", 3.0, 1), _rec("frame.span", 9.0, 2,
                                                                    profiled=True),
    ])
    assert mf.reader("facade.upload_ms.drive")(None) == pytest.approx(2.0)
    assert mf.reader("frame.span_ms.drive")(None) == pytest.approx(2.5)
    assert mf.reader("facade.unpack_ms.drive")(None) is None


def test_capture_seconds_leave_their_kernel_builds_out(monkeypatch):
    _fake(monkeypatch, [
        _rec("dispatch.capture", 900.0, 1, id=10), _rec("dispatch.capture", 100.0, 2, id=20),
        _rec("kernels.build", 600.0, 1, id=11, parent=10),
        _rec("kernels.build", 50.0, 3, id=30, parent=0),   # outside any capture
    ])
    assert mf.reader("dispatch.capture_s")(None) == pytest.approx(0.4)
    _fake(monkeypatch, [])
    assert mf.reader("dispatch.capture_s")(None) is None


def test_a_program_without_the_recorder_gives_nothing_to_read(monkeypatch):
    monkeypatch.setitem(sys.modules, _spans.MODULE, types.SimpleNamespace())
    names = [n for names in HOST.values() for n in names] + [
        "frame.span_ms.drive", "frame.span_ms.replay", "dispatch.capture_s"]
    assert all(mf.reader(n)(None) is None for n in names)
    monkeypatch.delitem(sys.modules, _spans.MODULE)
    assert all(mf.reader(n)(None) is None for n in names)
