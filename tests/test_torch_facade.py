"""The port's PatchworkPP facade, finished: the JAX byte layout of the packed
readback, the bucketed upload, estimate_ground_sequence as one pipelined
step and one readback span per uniform-RNR run, the slots that both entries
share, profile_stages, the chunks= switch, and the per-stage aggregation of
utils/roofline.py.

Inputs are tests/test_fuzz_parity.py:synth_cloud at capacity 8192, PyTorch
on one thread. The sequence must equal the port's own frame loop bit for
bit (labels, centers, normals, state) and the JAX package's
estimate_ground_sequence in labels, its state floats within
test_torch_frame.py's tolerances. The packed buffer must equal the JAX
package's byte for byte on the same arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from patchworkpp_tpu.models import PatchworkPP as JPatchworkPP
from patchworkpp_tpu.models.patchworkpp import _pack_result as j_pack
from patchworkpp_tpu.pipeline import FrameResult as JFrameResult
import patchworkpp_tpu_torch.models.patchworkpp as tfacade
from patchworkpp_tpu_torch import Params, PatchworkPP
from patchworkpp_tpu_torch.pipeline import FrameResult
from patchworkpp_tpu_torch.utils import roofline
from patchworkpp_tpu_torch.utils import profiling
from patchworkpp_tpu_torch.utils.profiling import FrameTimer
from test_fuzz_parity import CAP, synth_cloud
from test_torch_frame import _assert_state_close, _one_torch_thread  # noqa: F401

STAGES_FUSED = {"stage_rnr_czm", "stage_sort", "stage_fused_fit", "stage_gle_tail"}


def _clouds(seed=0, n=3):
    return [synth_cloud(seed + 5 * k, exact_edges=False) for k in range(n)]


def _assert_results_equal(a, b, label):
    for f in ("ground_mask", "ground_indices", "nonground_indices", "centers", "normals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{label} {f}")


def _random_result(rng, lead, rows, npatch=504):
    """The same random FrameResult in both packages (numpy arrays in)."""
    arrs = dict(
        ground_mask=rng.uniform(size=lead + (rows,)) < 0.4,
        num_ground=rng.integers(0, rows, size=lead).astype(np.int32),
        patch_mean=rng.normal(size=lead + (npatch, 3)).astype(np.float32),
        patch_normal=rng.normal(size=lead + (npatch, 3)).astype(np.float32),
        patch_svals=rng.normal(size=lead + (npatch, 3)).astype(np.float32),
        patch_processed=rng.uniform(size=lead + (npatch,)) < 0.5,
    )
    port = FrameResult(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrs.items()})
    ref = JFrameResult(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return arrs, port, ref


@pytest.mark.parametrize("lead", [(), (3,)], ids=["frame", "batch3"])
def test_pack_matches_jax_bytes_and_round_trips(lead):
    """An odd row count (4100 % 8 = 4) takes the bit-pad branch."""
    arrs, port, ref = _random_result(np.random.default_rng(len(lead)), lead, 4100)
    weights = torch.tensor(tfacade._BIT_WEIGHTS, dtype=torch.int32)
    buf = tfacade._pack_result(port, weights).numpy()
    np.testing.assert_array_equal(buf, np.asarray(j_pack(ref)))
    mask, ng, mean, normal, proc = tfacade._unpack_result(buf, port)
    np.testing.assert_array_equal(mask, arrs["ground_mask"])
    np.testing.assert_array_equal(ng, arrs["num_ground"])
    np.testing.assert_array_equal(mean, arrs["patch_mean"])
    np.testing.assert_array_equal(normal, arrs["patch_normal"])
    np.testing.assert_array_equal(proc, arrs["patch_processed"])


def test_odd_capacity_frame_equals_aligned():
    cloud = synth_cloud(1, exact_edges=False)
    a = PatchworkPP(capacity=4100, device="cpu").estimate_ground(cloud)
    b = PatchworkPP(capacity=CAP, device="cpu").estimate_ground(cloud)
    _assert_results_equal(a, b, "capacity 4100 vs 8192")


def test_packed_readback_equals_device_result():
    m = PatchworkPP(capacity=CAP, device="cpu")
    cloud = synth_cloud(2, exact_edges=False)
    res = m.estimate_ground(cloud)
    dev = m.last_result
    np.testing.assert_array_equal(res.ground_mask, dev.ground_mask.numpy()[: len(cloud)])
    proc = dev.patch_processed.numpy()
    np.testing.assert_array_equal(res.centers, dev.patch_mean.numpy()[proc])
    np.testing.assert_array_equal(res.normals, dev.patch_normal.numpy()[proc])


@pytest.mark.parametrize("sequence", [False, True], ids=["frame", "sequence"])
def test_bucketed_upload_equals_tight_capacity(monkeypatch, sequence):
    """A fixed capacity of 32768 copies only each ~3.7k-point scan's own
    rows into its 32768-row device slot, one scan or a sequence: the
    results and the state equal a tight capacity's."""
    rows = []
    copy_rows = tfacade._copy_rows

    def spy_rows(dst, src, n, non_blocking):
        rows.append((tuple(dst.shape), n))
        return copy_rows(dst, src, n, non_blocking)

    monkeypatch.setattr(tfacade, "_copy_rows", spy_rows)
    clouds = _clouds(3, 2 if sequence else 1)

    def run(m):
        return m.estimate_ground_sequence(clouds) if sequence else [m.estimate_ground(clouds[0])]

    wide = PatchworkPP(capacity=32768, device="cpu")
    tight = PatchworkPP(capacity=CAP, device="cpu")
    got = run(wide)
    assert rows == [((32768, 4), len(c)) for c in clouds]
    for i, (a, b) in enumerate(zip(got, run(tight))):
        _assert_results_equal(a, b, f"bucketed scan {i}")
    for k, v in tight.state.to_numpy().items():
        np.testing.assert_array_equal(wide.state.to_numpy()[k], v, err_msg=k)


def test_sequence_equals_frame_loop_and_jax():
    clouds = _clouds(4)
    seq = PatchworkPP(capacity=CAP, device="cpu")
    loop = PatchworkPP(capacity=CAP, device="cpu")
    got = seq.estimate_ground_sequence(clouds)
    want = [loop.estimate_ground(c) for c in clouds]
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_results_equal(a, b, f"frame {i}")
    assert got[0].time_taken_s > 0 and all(r.time_taken_s == 0.0 for r in got[1:])
    for k, v in loop.state.to_numpy().items():
        np.testing.assert_array_equal(seq.state.to_numpy()[k], v, err_msg=k)
    for f in FrameResult._fields:
        assert torch.equal(getattr(seq.last_result, f), getattr(loop.last_result, f)), f

    ref = JPatchworkPP(capacity=CAP)
    jres = ref.estimate_ground_sequence(clouds)
    for i, (a, b) in enumerate(zip(got, jres)):
        np.testing.assert_array_equal(a.ground_mask, b.ground_mask, err_msg=f"jax frame {i}")
    _assert_state_close(ref.state, seq.state, "sequence vs jax")


def test_mixed_width_batch_runs_per_rnr_run(monkeypatch):
    """A 4, 4, 3, 4-column batch runs as three uniform-RNR runs, one
    pipelined step and one facade.readback span each, each scan packed and
    read back on its own, equal to the frame loop."""
    clouds = _clouds(6, 4)
    clouds[2] = clouds[2][:, :3]
    m = PatchworkPP(capacity=CAP, device="cpu")
    packs = []
    pack = tfacade._pack_result
    monkeypatch.setattr(tfacade, "_pack_result", lambda res, *args, **kw: packs.append(
        tuple(res.ground_mask.shape)) or pack(res, *args, **kw))
    n0 = len(profiling.spans("facade.readback"))
    got = m.estimate_ground_sequence(clouds)
    assert packs == [(CAP,)] * 4
    assert [r.scans for r in profiling.spans("facade.readback")[n0:]] == [2, 1, 1]
    assert [r.time_taken_s > 0 for r in got] == [True, False, True, True]
    loop = PatchworkPP(capacity=CAP, device="cpu")
    for i, c in enumerate(clouds):
        _assert_results_equal(got[i], loop.estimate_ground(c), f"mixed frame {i}")
    assert m.sensor_height == loop.sensor_height
    assert PatchworkPP(device="cpu").estimate_ground_sequence([]) == []


def _padded(cloud, cap=CAP):
    out = np.zeros((cap, 4), np.float32)
    out[: len(cloud), : cloud.shape[1]] = cloud
    return out


@pytest.mark.parametrize("interleaved", [False, True], ids=["sequence", "interleaved"])
def test_pipelined_slots_hold_no_stale_rows(monkeypatch, interleaved):
    """Three calls on one facade reuse its slots with shorter scans after
    longer ones, and a 3-column scan where a 4-column one was: three
    sequence calls, or (interleaved) a sequence call, the next call's
    scans one estimate_ground each through slot 0, then a sequence call
    again. Every frame's input is its scan zero-padded to the capacity,
    and the results, the state and last_result equal a fresh facade's
    estimate_ground scan by scan, bit for bit."""
    base = _clouds(7, 6)
    calls = [
        [base[0], base[1][: len(base[1]) // 3], base[2]],
        [base[3][: len(base[3]) // 4], base[4], base[5][: len(base[5]) // 2]],
        [base[0][: len(base[0]) // 5, :3], base[2][:, :3], base[4][: len(base[4]) // 2]],
    ]
    inputs = []
    run = tfacade.CapturedFrame.run

    def spy(self, points, npts):
        inputs.append(points.clone().numpy())
        return run(self, points, npts)

    monkeypatch.setattr(tfacade.CapturedFrame, "run", spy)
    seq = PatchworkPP(capacity=CAP, device="cpu")
    loop = PatchworkPP(capacity=CAP, device="cpu")
    for k, call in enumerate(calls):
        inputs.clear()
        if interleaved and k == 1:
            got = [seq.estimate_ground(c) for c in call]
        else:
            got = seq.estimate_ground_sequence(call)
        assert len(inputs) == len(call)
        for i, (x, c) in enumerate(zip(inputs, call)):
            np.testing.assert_array_equal(x, _padded(c), err_msg=f"call {k} input {i}")
        for i, c in enumerate(call):
            _assert_results_equal(got[i], loop.estimate_ground(c), f"call {k} frame {i}")
        for name, v in loop.state.to_numpy().items():
            np.testing.assert_array_equal(seq.state.to_numpy()[name], v, err_msg=f"{k} {name}")
        for f in FrameResult._fields:  # NaN eigenvalues of a thin patch compare equal
            np.testing.assert_array_equal(getattr(seq.last_result, f).numpy(),
                                          getattr(loop.last_result, f).numpy(), err_msg=f)


def test_sequence_results_survive_the_next_call():
    """The arrays a sequence call returns own their memory: a second call
    on the same facade, through the same slots, leaves them unchanged."""
    m = PatchworkPP(capacity=CAP, device="cpu")
    first = m.estimate_ground_sequence(_clouds(8, 3))
    kept = [{f: np.array(getattr(r, f), copy=True) for f in
             ("ground_mask", "ground_indices", "nonground_indices", "centers", "normals")}
            for r in first]
    second = m.estimate_ground_sequence(_clouds(9, 3))
    assert any(len(a.ground_mask) != len(b.ground_mask)
               or (a.ground_mask != b.ground_mask).any() for a, b in zip(first, second))
    for i, (r, k) in enumerate(zip(first, kept)):
        for f, v in k.items():
            np.testing.assert_array_equal(getattr(r, f), v, err_msg=f"scan {i} {f}")


def test_pipelined_step_records_one_span_a_phase():
    """A 3-scan step records one facade.stage, facade.upload,
    dispatch.launch, facade.readback and facade.unpack, each with scans=3
    under the step, which the benchmark's per-request reader sums; the
    CPU counts no overlapped scan (it has no events to query)."""
    from benchmark.metrics._spans import summed_ms

    names = ("facade.stage", "facade.upload", "dispatch.launch", "facade.readback",
             "facade.unpack")
    m = PatchworkPP(capacity=CAP, device="cpu")
    before = profiling.counters().get("facade.overlapped_scans", profiling.Count(0, 0.0)).n
    m.estimate_ground_sequence(_clouds(10, 3))
    step = profiling.spans("facade.step")[-1]
    assert step.scans == 3
    for name in names:
        recs = [r for r in profiling.spans(name) if r.request == step.request]
        assert [(r.scans, r.parent) for r in recs] == [(3, step.id)], name
        assert 0 < recs[0].dur_ns <= step.dur_ns, name
        assert step.start_ns <= recs[0].start_ns
        assert summed_ms([name]) is not None, name
    assert summed_ms(["facade.stage", "facade.upload"]) > 0
    assert profiling.counters().get("facade.overlapped_scans",
                                    profiling.Count(0, 0.0)).n == before


def test_verbose_print_uses_packed_count(capsys):
    m = PatchworkPP(Params(verbose=True), capacity=CAP, device="cpu")
    res = m.estimate_ground(synth_cloud(0, exact_edges=False))
    assert f"-> {int(res.ground_mask.sum())} ground" in capsys.readouterr().out


def test_chunks_switch():
    """chunks=K keeps the JAX facade's capacity rule: the automatic
    capacity rounds up to a multiple of lcm(8192, K), a fixed one that K
    does not divide raises; chunks < 1 raises. (The chunked frame's labels:
    tests/test_torch_chunked.py.)"""
    with pytest.raises(ValueError, match="chunks"):
        PatchworkPP(device="cpu", chunks=0)
    assert PatchworkPP(device="cpu", chunks=1).device.type == "cpu"
    m = PatchworkPP(device="cpu", chunks=3)
    assert m._capacity(100) == 24576 and m._capacity(30000) == 49152
    assert PatchworkPP(device="cpu", chunks=2)._capacity(100) == 8192
    with pytest.raises(ValueError, match="not divisible"):
        PatchworkPP(capacity=1000, chunks=3, device="cpu").estimate_ground(
            np.zeros((10, 4), np.float32))


def test_profile_stages_on_cpu(capsys):
    m = PatchworkPP(Params(verbose=True), capacity=CAP, device="cpu")
    stages, ops = m.profile_stages(synth_cloud(0, exact_edges=False), frames=2)
    assert STAGES_FUSED <= set(stages)
    assert all(stages[k] > 0 for k in STAGES_FUSED)
    assert ops and all(sec >= 0 and n >= 1 for _, sec, n in ops)
    assert "per-stage time:" in capsys.readouterr().out


def _ev(name, start, dur, on_device, annotation=False, self_us=0.0):
    return roofline.Event(name, float(start), float(dur), on_device, annotation, self_us)


def test_stage_breakdown_on_synthetic_events():
    """Device kernels go to the stage whose device span holds their start,
    the rest to ``other``; without device events the host ranges count."""
    events = [
        _ev("stage_sort", 0, 100, False, True), _ev("stage_sort", 10, 50, True, True),
        _ev("stage_fused_fit", 100, 50, False, True),
        _ev("stage_fused_fit", 60, 40, True, True),
        _ev("sort_kernel", 12, 20, True), _ev("sort_kernel", 35, 10, True),
        _ev("fit_kernel", 70, 25, True), _ev("Memcpy DtoH (Device -> Pageable)", 120, 5, True),
        _ev("aten::add", 1, 30, False, self_us=30.0),
    ]
    stages = roofline.stage_breakdown(events)
    assert stages == pytest.approx({"stage_sort": 30e-6, "stage_fused_fit": 25e-6,
                                    "other": 5e-6})
    ops = roofline.op_table(events)
    assert ops[0] == ("sort_kernel", pytest.approx(30e-6), 2)
    rep = roofline.frame_report(events, wall_s=200e-6, frames=2)
    assert rep["device_launches_per_frame"] == 2.0
    assert rep["dtoh_copies_per_frame"] == 0.5
    assert rep["device_busy_share"] == pytest.approx(60 / 200)
    assert rep["stages"]["stage_sort"] == pytest.approx(
        {"host_ms": 0.05, "device_span_ms": 0.025, "device_busy_ms": 0.015})
    host = [e for e in events if not e.on_device]
    assert roofline.stage_breakdown(host) == pytest.approx(
        {"stage_sort": 100e-6, "stage_fused_fit": 50e-6})
    assert roofline.op_table(host) == [("aten::add", pytest.approx(30e-6), 1)]
    text = roofline.format_report(stages, frames=1, header="h")
    assert text.splitlines()[0] == "h" and "stage_sort" in text and "total" in text


def test_frame_timer_and_profile_trace():
    """FrameTimer's totals, and its segments as ``server.`` spans of the
    recorder (``profiling.spans``), kept while the recorder is off."""
    def count():
        return profiling.counters().get("server.infer", profiling.Count(0, 0.0)).n

    n0 = count()
    t = FrameTimer()
    with t.segment("infer", scans=2):
        torch.ones(4).sum()
    t.tick_frame()
    assert t.frames == 1 and t.time_taken_us > 0 and "infer" in t.report()
    rec = profiling.spans("server.infer")[-1]
    assert count() == n0 + 1
    assert rec.scans == 2 and rec.seconds == pytest.approx(t.totals["infer"])
    assert "server.infer: n=" in profiling.timing_report()
    profiling.enable(False)
    try:
        with t.segment("infer"):
            torch.ones(4).sum()
    finally:
        profiling.enable(True)
    assert t.totals["infer"] > rec.seconds and count() == n0 + 1
