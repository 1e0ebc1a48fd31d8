"""The port's PatchworkPP facade, finished: the JAX byte layout of the packed
readback, the bucketed upload, estimate_ground_sequence as one sequence call
and one readback per uniform-RNR run, profile_stages, the chunks= switch,
and the per-stage aggregation of utils/roofline.py.

Inputs are tests/test_fuzz_parity.py:synth_cloud at capacity 8192, PyTorch
on one thread. The sequence must equal the port's own frame loop bit for
bit (labels, centers, normals, state) and the JAX package's
estimate_ground_sequence in labels, its state floats within
test_torch_frame.py's tolerances. The packed buffer must equal the JAX
package's byte for byte on the same arrays.
"""

from __future__ import annotations

import json
import os

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
from patchworkpp_tpu_torch.utils.profiling import FrameTimer, profile_trace
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
    buf = tfacade._pack_result(port).numpy()
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


def test_bucketed_upload_equals_tight_capacity(monkeypatch):
    """A fixed capacity of 32768 uploads only the 8192-row bucket of a
    ~3.7k-point scan and zero-extends it on the device: the frame and the
    sequence equal a tight capacity's."""
    seen = []
    extend = tfacade._zero_extend

    def spy(a, cap):
        seen.append((tuple(a.shape), cap))
        return extend(a, cap)

    monkeypatch.setattr(tfacade, "_zero_extend", spy)
    clouds = _clouds(3, 2)
    wide = PatchworkPP(capacity=32768, device="cpu")
    tight = PatchworkPP(capacity=CAP, device="cpu")
    _assert_results_equal(wide.estimate_ground(clouds[0]), tight.estimate_ground(clouds[0]),
                          "bucketed frame")
    assert seen[0] == ((1, CAP, 4), 32768)
    wide.reset()
    tight.reset()
    for a, b in zip(wide.estimate_ground_sequence(clouds),
                    tight.estimate_ground_sequence(clouds)):
        _assert_results_equal(a, b, "bucketed sequence")
    assert ((2, CAP, 4), 32768) in seen
    assert wide.sensor_height == tight.sensor_height


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
    sequence call and one readback each, equal to the frame loop."""
    clouds = _clouds(6, 4)
    clouds[2] = clouds[2][:, :3]
    m = PatchworkPP(capacity=CAP, device="cpu")
    reads = []
    readback = m._readback
    monkeypatch.setattr(m, "_readback", lambda res: reads.append(
        tuple(res.ground_mask.shape)) or readback(res))
    got = m.estimate_ground_sequence(clouds)
    assert reads == [(2, CAP), (1, CAP), (1, CAP)]
    assert [r.time_taken_s > 0 for r in got] == [True, False, True, True]
    loop = PatchworkPP(capacity=CAP, device="cpu")
    for i, c in enumerate(clouds):
        _assert_results_equal(got[i], loop.estimate_ground(c), f"mixed frame {i}")
    assert m.sensor_height == loop.sensor_height
    assert PatchworkPP(device="cpu").estimate_ground_sequence([]) == []


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


def test_frame_timer_and_profile_trace(tmp_path):
    t = FrameTimer()
    with t.segment("infer"):
        torch.ones(4).sum()
    t.tick_frame()
    assert t.frames == 1 and t.time_taken_us > 0 and "infer" in t.report()
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path)):
        torch.ones(8).sum()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
