"""Per-stage timing from ``torch.profiler`` events (port of
``patchworkpp_tpu/utils/roofline.py``, which reads ``jax.profiler`` trace
files).

The reference instruments its frame with clock() segment timers printed
under ``verbose`` (reference: cpp/patchworkpp/src/patchworkpp.cpp:179,
:320-333, the czm/sort/pca/gle split). The port's frame labels its stages
with ``torch.profiler.record_function`` ranges (``pipeline.py``:
stage_rnr_czm, stage_sort, stage_fused_fit or stage_rvpf / stage_rgpf,
stage_gle_tail). On the card a stage's device time is that of the kernels
that start inside the range's device span; on the CPU it is the range's host
time. Also: the top ops by time, and the per-frame report that
``chip_smoke.py --profile`` prints (host and device time per stage, the
device's busy share, launches and device -> host copies per frame).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

STAGE_PREFIX = "stage_"


class Event(NamedTuple):
    """One profiler event, in microseconds."""

    name: str
    start_us: float
    dur_us: float
    on_device: bool   # on the card's timeline (a kernel, a copy, a span)
    annotation: bool  # a record_function range, not an op or a kernel
    self_us: float    # host events: the time not spent in child events


def events_from_profiler(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        on_dev = e.device_type == DeviceType.CUDA
        out.append(Event(
            name=e.name,
            start_us=float(e.time_range.start),
            dur_us=float(e.time_range.elapsed_us()),
            on_device=on_dev,
            # a stage range's span on the card counts as a range whatever
            # this torch version flags it as
            annotation=bool(getattr(e, "is_user_annotation", False))
            or e.name.startswith(STAGE_PREFIX),
            self_us=0.0 if on_dev else float(e.self_cpu_time_total),
        ))
    return out


def trace(run_frames) -> Tuple[List[Event], float]:
    """Run ``run_frames()`` under ``torch.profiler`` (the card's activity
    too when CUDA is available, synchronized before and after). Returns
    (events, wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_frames()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return events_from_profiler(prof), wall


def _kernels(events: List[Event]) -> List[Event]:
    """Work on the card: kernels and copies (not the ranges' spans)."""
    return [e for e in events if e.on_device and not e.annotation]


def _stage_spans(events: List[Event], on_device: bool):
    return [(e.start_us, e.start_us + e.dur_us, e.name) for e in events
            if e.annotation and e.on_device == on_device
            and e.name.startswith(STAGE_PREFIX)]


def _stage_of(start_us: float, spans) -> str:
    for a, b, name in spans:
        if a <= start_us < b:
            return name
    return "other"


def stage_breakdown(events: List[Event]) -> Dict[str, float]:
    """Stage -> total seconds. With device events: the time of the kernels
    that start inside each stage's device span (``other`` for the rest);
    without (a CPU run): each stage range's host time."""
    totals: Dict[str, float] = defaultdict(float)
    kernels = _kernels(events)
    if kernels:
        spans = _stage_spans(events, on_device=True)
        for k in kernels:
            totals[_stage_of(k.start_us, spans)] += k.dur_us * 1e-6
    else:
        for a, b, name in _stage_spans(events, on_device=False):
            totals[name] += (b - a) * 1e-6
    return dict(totals)


def op_table(events: List[Event], top: int = 20) -> List[Tuple[str, float, int]]:
    """Top ops by total time: (name, seconds, count). Kernels by device
    time when the card was traced, else host ops by self time."""
    agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    kernels = _kernels(events)
    rows = ([(k.name, k.dur_us) for k in kernels] if kernels else
            [(e.name, e.self_us) for e in events if not e.annotation and not e.on_device])
    for name, us in rows:
        a = agg[name]
        a[0] += us * 1e-6
        a[1] += 1
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name, v[0], int(v[1])) for name, v in ranked]


def profile_frames(run_frames) -> Tuple[Dict[str, float], List[Tuple[str, float, int]]]:
    """Trace ``run_frames()`` (which must end in a sync on its results) and
    return (stage -> seconds, top-op table) over the traced region."""
    events, _ = trace(run_frames)
    return stage_breakdown(events), op_table(events)


def format_report(stages: Dict[str, float], frames: int, header: str = "") -> str:
    """Human-readable per-frame stage split (the verbose analog)."""
    total = sum(stages.values())
    lines = [header] if header else []
    for name, sec in sorted(stages.items(), key=lambda kv: -kv[1]):
        ms = sec / max(frames, 1) * 1e3
        pct = 100.0 * sec / total if total else 0.0
        lines.append(f"  {name:<18} {ms:8.3f} ms/frame  ({pct:4.1f}%)")
    lines.append(f"  {'total':<18} {total / max(frames, 1) * 1e3:8.3f} ms/frame")
    return "\n".join(lines)


# CUDA API calls (runtime, and the cu* launch) that put work on a stream:
# a captured frame's launches from Python are these, a graph's kernels not
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def frame_report(events: List[Event], wall_s: float, frames: int) -> dict:
    """Per frame of a traced run of ``frames`` frames: the host time of
    each stage range, its span on the card and the device time of the
    kernels inside that span; the card's busy share of the window (kernel
    and copy time over wall time); the count of device launches (kernels
    and copies on the card), of the host's launch calls (kernel launches,
    graph launches, copies and sets put on a stream) and of device -> host
    copies; and the kernels with the most device time."""
    kernels = _kernels(events)
    spans = _stage_spans(events, on_device=True)
    host: Dict[str, float] = defaultdict(float)
    span: Dict[str, float] = defaultdict(float)
    for a, b, name in _stage_spans(events, on_device=False):
        host[name] += b - a
    for a, b, name in spans:
        span[name] += b - a
    busy_in: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for k in kernels:
        st = _stage_of(k.start_us, spans)
        if st != "other":
            busy_in[st] += k.dur_us
        by_name[k.name][0] += k.dur_us
        by_name[k.name][1] += 1
    busy_us = sum(k.dur_us for k in kernels)
    wall_us = wall_s * 1e6
    per = 1e3 * frames  # us over the run -> ms per frame
    stages = {
        k: {"host_ms": host.get(k, 0.0) / per, "device_span_ms": span.get(k, 0.0) / per,
            "device_busy_ms": busy_in.get(k, 0.0) / per}
        for k in sorted(set(host) | set(span))
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "frames": frames, "wall_ms_per_frame": wall_us / per,
        "device_busy_ms_per_frame": busy_us / per,
        "device_busy_share": busy_us / wall_us if wall_us else 0.0,
        "device_launches_per_frame": len(kernels) / frames,
        "host_launch_calls_per_frame": sum(
            not e.on_device and e.name.startswith(HOST_LAUNCH_CALLS) for e in events) / frames,
        "dtoh_copies_per_frame": sum("DtoH" in k.name for k in kernels) / frames,
        "stages": stages,
        "top_kernels": [{"name": k, "device_ms_per_frame": t / per,
                         "launches_per_frame": c / frames} for k, (t, c) in top],
    }


def print_frame_report(out: dict) -> None:
    print(f"profile ({out['frames']} frames, profiler on): wall "
          f"{out['wall_ms_per_frame']:.3f} ms/frame, device busy "
          f"{out['device_busy_ms_per_frame']:.3f} ms/frame "
          f"(share {out['device_busy_share']:.3f}), "
          f"{out['device_launches_per_frame']:g} device launches, "
          f"{out['host_launch_calls_per_frame']:g} launch calls from the host and "
          f"{out['dtoh_copies_per_frame']:g} device->host copies per frame")
    for k, v in out["stages"].items():
        print(f"  {k}: host {v['host_ms']:.3f} ms, device span {v['device_span_ms']:.3f} ms, "
              f"device busy {v['device_busy_ms']:.3f} ms per frame")
    for t in out["top_kernels"]:
        print(f"  {t['device_ms_per_frame']:.4f} ms/frame  x{t['launches_per_frame']:g}  "
              f"{t['name'][:90]}")
