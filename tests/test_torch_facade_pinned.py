"""The facade's one transport on the card: page-locked staging and readback
slots, each scan's copies queued without waiting, the host staging scan i+1
while the card replays scan i, and single scans through the same slots.

This file imports no JAX, so that it runs on a machine with the card and
without JAX, past tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_facade_pinned.py

Here it skips without a card; the CPU loop is held to the frame loop in
tests/test_torch_facade.py.
"""

from __future__ import annotations

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from patchworkpp_tpu_torch import PatchworkPP
from patchworkpp_tpu_torch.io.synthetic import make_scan
from patchworkpp_tpu_torch.models.presets import ros_launch_params
from patchworkpp_tpu_torch.utils import profiling

CAPACITY = 131072
SCANS = 24


def _overlapped() -> int:
    return profiling.counters().get("facade.overlapped_scans", profiling.Count(0, 0.0)).n


@pytest.mark.gpu
def test_pipelined_sequence_on_card_equals_frame_loop():
    """Two 24-scan calls through the same slots (every third scan, then
    every fourth, cut to half its rows, so shorter scans follow longer ones
    in a slot) equal estimate_ground scan by scan, bit for bit, state
    included; the slots are page-locked; at least 20 of each call's 24
    scans are staged while the previous scan is still on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    full = [make_scan(0, f) for f in range(2 * SCANS)]
    calls = [[s[: len(s) // 2] if f % 3 == 0 else s for f, s in enumerate(full[:SCANS])],
             [s[: len(s) // 2] if f % 4 == 0 else s for f, s in enumerate(full[SCANS:])]]
    seq = PatchworkPP(capacity=CAPACITY)
    loop = PatchworkPP(capacity=CAPACITY)
    seq.estimate_ground_sequence(full[:2])  # captures the frame
    seq.reset()
    for k, call in enumerate(calls):
        before = _overlapped()
        got = seq.estimate_ground_sequence(call)
        overlapped = _overlapped() - before
        for i, scan in enumerate(call):
            want = loop.estimate_ground(scan)
            for f in ("ground_mask", "ground_indices", "nonground_indices", "centers",
                      "normals"):
                np.testing.assert_array_equal(getattr(got[i], f), getattr(want, f),
                                              err_msg=f"call {k} scan {i} {f}")
        for name, v in loop.state.to_numpy().items():
            np.testing.assert_array_equal(seq.state.to_numpy()[name], v,
                                          err_msg=f"call {k} {name}")
        assert overlapped >= 20, f"call {k}: {overlapped} of {SCANS} scans overlapped"
        print(f"call {k}: facade.overlapped_scans {overlapped} of {SCANS}")
    slots = seq._slots
    assert slots.host.is_pinned() and slots.back.is_pinned()
    assert slots.dev.device.type == "cuda"


@pytest.mark.gpu
def test_single_scans_on_card_go_through_the_slots_and_equal_the_cpu():
    """estimate_ground on the card is a one-scan pass of the pipeline:
    six chained scans under the launch profile (whose packed readback also
    carries the count of inherited planes) go through the facade's one set
    of page-locked slots, slot 0 each time, and their labels, planes and
    state equal the CPU facade's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = ros_launch_params()
    scans = [make_scan(3, f) for f in range(6)]
    cpu = PatchworkPP(p, capacity=CAPACITY, device="cpu")
    card = PatchworkPP(p, capacity=CAPACITY)
    card.estimate_ground(scans[0])  # captures the frame
    card.reset()
    slots = card._slots
    assert slots.host.is_pinned() and slots.back.is_pinned()
    for i, scan in enumerate(scans):
        got, want = card.estimate_ground(scan), cpu.estimate_ground(scan)
        for f in ("ground_mask", "ground_indices", "nonground_indices", "centers", "normals"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"scan {i} {f}")
        assert slots.rows[0] == len(scan)
    assert card._slots is slots
    for name, v in cpu.state.to_numpy().items():
        np.testing.assert_array_equal(card.state.to_numpy()[name], v, err_msg=name)
