"""A run driven end to end on the CPU, at a small size, with the timed path
broken underneath: ``correct`` has to come out false for each fault the
cells can have, and true for the unbroken program. The harness's look for
a card is skipped (``run_cell`` on "cpu")."""

import time

import numpy as np
import pytest

from benchmark import manifest as mf
from benchmark import run
from benchmark.drivers import Kept, Output, Sample

torch = pytest.importorskip("torch")
facade = pytest.importorskip("patchworkpp_tpu_torch.models.patchworkpp")
PatchworkPP = facade.PatchworkPP

# the mixes cut to what a test holds: a few short calls, few samples
SMALL = {
    "sequence": {"cycle": 8, "call_scans": 4, "warmup_calls": 1, "trace_from": 1,
                 "trace_calls": 1, "check": {"start_scans": 4, "samples": 1,
                                             "sample_scans": 2, "sample_from": 2,
                                             "sample_span": 3}},
    "server": {"cycle": 8, "warmup_scans": 1, "trace_from": 2, "trace_scans": 2,
               "check": {"start_scans": 3, "samples": 1, "sample_from": 4,
                         "sample_span": 5}},
}
CELLS = ["kitti_hdl64.drive_seq24", "kitti_hdl64.replay_closed"]


def _run(root, workload, traced=False, seconds=4.0):
    man = mf.load_manifest(root)
    cell = mf.workload(man, workload)
    cfg = dict(mf.config(man, root, cell["config"]), capacity=8192)
    mix = mf.traffic(cell["traffic"])
    mix = dict(mix, **SMALL[mix["entry"]])
    return run.run_cell(root, man, workload, 2**31 + 11, seconds, traced, "cpu",
                        time.perf_counter(), cfg=cfg, mix=mix, sub=32)


def _state_unchanged(monkeypatch):
    seq, one = PatchworkPP.estimate_ground_sequence, PatchworkPP.estimate_ground

    def frozen(fn):
        def call(self, clouds):
            state = self.state
            out = fn(self, clouds)
            self.state = state
            return out
        return call

    monkeypatch.setattr(PatchworkPP, "estimate_ground_sequence", frozen(seq))
    monkeypatch.setattr(PatchworkPP, "estimate_ground", frozen(one))


def _half_left_out(monkeypatch):
    seq, one = PatchworkPP.estimate_ground_sequence, PatchworkPP.estimate_ground

    def half_seq(self, clouds):
        done = seq(self, clouds[: len(clouds) // 2])
        return done + done[: len(clouds) - len(done)]

    def half_one(self, cloud):
        res = one(self, cloud[: len(cloud) // 2])
        mask = np.zeros(len(cloud), bool)
        mask[: len(res.ground_mask)] = res.ground_mask
        return res._replace(ground_mask=mask)

    monkeypatch.setattr(PatchworkPP, "estimate_ground_sequence", half_seq)
    monkeypatch.setattr(PatchworkPP, "estimate_ground", half_one)


def _answer_altered(monkeypatch):
    seq, one = PatchworkPP.estimate_ground_sequence, PatchworkPP.estimate_ground

    def alter(res):
        mask = res.ground_mask.copy()
        k = max(1, len(mask) // 100)
        mask[:k] = ~mask[:k]
        return res._replace(ground_mask=mask)

    monkeypatch.setattr(PatchworkPP, "estimate_ground_sequence",
                        lambda self, clouds: [alter(r) for r in seq(self, clouds)])
    monkeypatch.setattr(PatchworkPP, "estimate_ground", lambda self, c: alter(one(self, c)))


def _buffers_reordered(monkeypatch):
    """The rings' sample buffers kept in the reverse order: the thresholds,
    a mean and a deviation of each buffer, come out the same until the
    buffers are trimmed, so only the buffers' own comparison sees it."""
    seq, one = PatchworkPP.estimate_ground_sequence, PatchworkPP.estimate_ground

    def reorder(self):
        state = self.state.clone()
        for name in ("elev", "flat"):
            buf, cnt = getattr(state, f"{name}_buf"), getattr(state, f"{name}_cnt")
            for ring in range(buf.shape[0]):
                n = int(cnt[ring])
                buf[ring, :n] = buf[ring, :n].flip(0)
        self.state = state

    def after(fn):
        def call(self, arg):
            out = fn(self, arg)
            reorder(self)
            return out
        return call

    monkeypatch.setattr(PatchworkPP, "estimate_ground_sequence", after(seq))
    monkeypatch.setattr(PatchworkPP, "estimate_ground", after(one))


@pytest.mark.parametrize("workload", CELLS)
def test_the_unbroken_program_is_correct(root, workload):
    out = _run(root, workload, traced=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert "setup_s" not in out["metrics"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_program_is_not_correct(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _run(root, workload)
    assert not out["correct"], out["checks"]
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("workload", CELLS)
def test_reordered_buffers_fail_the_buffer_check(root, monkeypatch, workload):
    _buffers_reordered(monkeypatch)
    out = _run(root, workload)
    assert not out["correct"], out["checks"]
    gap = out["checks"]["buffer_gap"]
    assert gap["value"] > gap["limit"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_places_past_the_close_are_awaited(root, workload):
    # a window that closes after its first call or scan: the sampled places
    # lie past it, and the run goes on, untimed, until they are answered
    out = _run(root, workload, seconds=0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > out["phases"]["scans"]


def test_a_place_never_answered_leaves_the_check_incomplete():
    check = {"start_scans": 2, "samples": 2, "sample_scans": 1}
    out = Output(np.zeros(3, bool), np.zeros((1, 3)), np.zeros((1, 3)))
    whole = Kept([out, out], {}, [Sample(5, {}, [out]), Sample(9, {}, [out])])
    assert whole.complete(check)
    assert not Kept([out, out], {}, whole.samples[:1]).complete(check)
    assert not Kept([out], {}, whole.samples).complete(check)
    assert not Kept([out, out], None, whole.samples).complete(check)
    assert not Kept([out, out], {}, whole.samples, states_after=True).complete(check)
    after = [Sample(5, {}, [out], {}), Sample(9, {}, [out], {})]
    assert Kept([out, out], {}, after, states_after=True).complete(check)
