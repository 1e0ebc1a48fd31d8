"""The correctness check: the plain reference (``reference/oracle.py``)
works out again what the window's kept outputs should be, from the scans
the benchmark made, and three numbers compare them:

- ``label_mismatch``: the largest share of a compared frame's points whose
  ground label differs from the reference's;
- ``plane_mismatch``: the share of the compared frames' processed patches
  whose plane center or normal lies more than ``PLANE_TOL`` from the
  reference's (every patch of a frame counts when the processed sets
  differ);
- ``height_gap``: the median over the sensor height and the four rings'
  elevation thresholds of the gap between the program's and the
  reference's, against the largest magnitude of the reference's, at its
  largest over the compared states;
- ``flatness_gap``: the same over the four rings' flatness thresholds;
- ``buffer_gap``: the median, over every entry of the four rings'
  elevation and flatness sample buffers that the thresholds are worked out
  from, of the gap between the program's entry and the reference's at the
  same place, against the largest magnitude of that reference buffer; an
  entry that one side lacks counts as infinite.

All three take the median entry: one near-tie patch decided the other way (a
label mismatch of a few points) sends one more sample into one ring's
buffer, and that ring's threshold then stays ~1e-3 apart for the rest of
the chain; and a flatness threshold is a mean of smallest covariance
eigenvalues, which the program's float32 solver gets to a few digits on
some patches. Either moves one entry, where the median stays steady.

The start of the window is followed from the fresh state, the reference's
own; each sampled place starts from the program's checkpoint before it
(the reference cannot follow thousands of frames), so the start covers the
state's update chain and the samples the frames deep in the window. The
checkpoints' buffers are the program's: the start's are held to the
reference's own, and in the server's samples, where the state after each
is kept, those after a frame from a full, trimmed buffer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.drivers import Output
from benchmark.reference.oracle import Reference
from benchmark.reference.params import Params

PLANE_TOL = 1e-3
# name -> (state keys, how the gaps of the group's entries reduce)
STATE_GROUPS = {"height_gap": (("sensor_height", "elevation_thr"), np.median),
                "flatness_gap": (("flatness_thr",), np.median)}


def _plane_bad(centers, normals, ref_centers, ref_normals) -> Tuple[int, int]:
    """(patches off by more than PLANE_TOL, patches compared)."""
    ref_c = np.asarray(ref_centers, np.float64).reshape(-1, 3)
    ref_n = np.asarray(ref_normals, np.float64).reshape(-1, 3)
    c = np.asarray(centers, np.float64).reshape(-1, 3)
    n = np.asarray(normals, np.float64).reshape(-1, 3)
    total = max(len(ref_c), len(c))
    if len(ref_c) != len(c):
        return total, total
    with np.errstate(invalid="ignore"):
        gap = np.maximum(np.abs(c - ref_c).max(axis=1, initial=0.0),
                         np.abs(n - ref_n).max(axis=1, initial=0.0))
    both_nan = np.isnan(n).any(axis=1) & np.isnan(ref_n).any(axis=1)
    bad = ~(gap <= PLANE_TOL) & ~both_nan
    return int(bad.sum()), total


def state_gaps(program: Optional[dict], ref: dict) -> Dict[str, float]:
    """Each group's gaps against the reference group's largest magnitude,
    reduced; inf for a state the program never gave."""
    out = {}
    for name, (keys, reduce) in STATE_GROUPS.items():
        if program is None:
            out[name] = np.inf
            continue
        r = np.concatenate([np.atleast_1d(np.asarray(ref[k], np.float64)) for k in keys])
        p = np.concatenate([np.atleast_1d(np.asarray(program[k], np.float64)) for k in keys])
        gap = float(reduce(np.abs(p - r))) / max(float(np.abs(r).max()), 1e-12)
        out[name] = gap if np.isfinite(gap) else np.inf
    return out


def buffer_gap(program: Optional[dict], ref: dict) -> float:
    """The median entry's gap of the rings' sample buffers (module doc); inf
    for a state the program never gave."""
    if program is None:
        return np.inf
    gaps = []
    for name in ("elev", "flat"):
        p_buf, r_buf = (np.asarray(d[f"{name}_buf"], np.float64) for d in (program, ref))
        p_cnt, r_cnt = (np.asarray(d[f"{name}_cnt"]).astype(int) for d in (program, ref))
        for ring in range(len(r_cnt)):
            p, r = p_buf[ring, : p_cnt[ring]], r_buf[ring, : r_cnt[ring]]
            m = min(len(p), len(r))
            scale = max(float(np.abs(r).max(initial=0.0)), 1e-12)
            gaps += [np.abs(p[:m] - r[:m]) / scale, np.full(max(len(p), len(r)) - m, np.inf)]
    entries = np.concatenate(gaps)
    gap = float(np.median(entries)) if len(entries) else 0.0
    return gap if np.isfinite(gap) else np.inf


class _Tally:
    def __init__(self) -> None:
        self.label = 0.0
        self.plane_bad = 0
        self.plane_total = 0
        self.state = dict.fromkeys([*STATE_GROUPS, "buffer_gap"], 0.0)

    def frame(self, out, ref: Reference, ref_mask: np.ndarray) -> None:
        mask = np.asarray(out.mask, bool)
        if mask.shape != ref_mask.shape:
            self.label = 1.0
        else:
            self.label = max(self.label, float((mask != ref_mask).mean()) if len(mask) else 0.0)
        bad, total = _plane_bad(out.centers, out.normals, ref.centers, ref.normals)
        self.plane_bad += bad
        self.plane_total += total

    def state_pair(self, program: Optional[dict], ref: Reference) -> None:
        want = ref.export_state()
        gaps = dict(state_gaps(program, want), buffer_gap=buffer_gap(program, want))
        for name, gap in gaps.items():
            self.state[name] = max(self.state[name], gap)

    def numbers(self) -> Dict[str, float]:
        return {
            "label_mismatch": self.label,
            "plane_mismatch": self.plane_bad / max(self.plane_total, 1),
            **self.state,
        }


def compare(params: Params, cycle: List[np.ndarray], kept) -> Dict[str, float]:
    """The numbers for the kept outputs of a run over ``cycle``."""
    tally = _Tally()
    ref = Reference(params)
    for g, out in enumerate(kept.start):
        tally.frame(out, ref, ref.estimate_ground(cycle[g % len(cycle)]))
    tally.state_pair(kept.start_state, ref)
    for s in kept.samples:
        ref = Reference(params)
        ref.import_state(s.state_before)
        for j, out in enumerate(s.outputs):
            tally.frame(out, ref, ref.estimate_ground(cycle[(s.first + j) % len(cycle)]))
        if s.state_after is not None:
            tally.state_pair(s.state_after, ref)
    return tally.numbers()


def control(params: Params, cycle: List[np.ndarray], frames: int) -> Dict[str, float]:
    """The numbers of the control: the reference computed in bfloat16, in
    the program's place, over the window's first ``frames`` scans from the
    fresh state (the start of the check)."""
    low, ref = Reference(params, lowp=True), Reference(params)
    tally = _Tally()
    for g in range(frames):
        scan = cycle[g % len(cycle)]
        out = Output(low.estimate_ground(scan), np.array(low.centers), np.array(low.normals))
        tally.frame(out, ref, ref.estimate_ground(scan))
    tally.state_pair(low.export_state(), ref)
    return tally.numbers()


def judge(numbers: Dict[str, float], limits: Dict[str, float], failed: int,
          complete: bool) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, no scan failed, and the kept outputs complete. A number that is
    not finite (a state the program never gave) shows as 1e300."""
    shown = {k: {"value": float(v) if np.isfinite(v) else 1e300, "limit": float(limits[k])}
             for k, v in numbers.items()}
    ok = failed == 0 and complete and all(
        np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return bool(ok), shown
