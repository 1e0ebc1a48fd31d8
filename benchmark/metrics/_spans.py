"""The program's span recorder, read for the ``program_span`` metrics.

The recorder is ``patchworkpp_tpu_torch.utils.profiling``, taken from the
modules the program loaded in this process (the benchmark reaches the
program only through ``system.py``; a program without the recorder's
``spans`` gives nothing to read). Only records made while no profiler ran
count, so a traced run's profiled slice is left out, as its host timings
leave it out. A scan's share of a span is its duration over its ``scans``:
24 in a drive's step, 1 in a replay's.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np

MODULE = "patchworkpp_tpu_torch.utils.profiling"


def recorder():
    """The program's recorder module, or None where it has none."""
    mod = sys.modules.get(MODULE)
    return mod if mod is not None and hasattr(mod, "spans") else None


def summed_ms(names: Sequence[str]) -> Optional[float]:
    """The median over requests (a facade step, a server message) of the
    summed durations of ``names``' spans in it, a scan, in ms: only
    requests that hold each name and no profiled record of them."""
    mod = recorder()
    if mod is None:
        return None
    per_request = {}
    for name in names:
        for r in mod.spans(name):
            d = per_request.setdefault(r.request, {})
            d[name] = None if r.profiled or name in d else (r.dur_ns, r.scans)
    values = [sum(v[0] for v in d.values()) / max(d[names[0]][1], 1)
              for d in per_request.values()
              if len(d) == len(names) and None not in d.values()]
    return float(np.median(values)) * 1e-6 if values else None


def median_ms(name: str) -> Optional[float]:
    """The median over ``name``'s unprofiled spans of a scan's share, in ms."""
    mod = recorder()
    if mod is None:
        return None
    values = [r.dur_ns / max(r.scans, 1) for r in mod.spans(name) if not r.profiled]
    return float(np.median(values)) * 1e-6 if values else None


def capture_s() -> Optional[float]:
    """The run's ``dispatch.capture`` seconds less those of their
    ``kernels.build`` children (compiling or loading the kernels)."""
    mod = recorder()
    if mod is None:
        return None
    caps = mod.spans("dispatch.capture")
    if not caps:
        return None
    ids = {r.id for r in caps}
    builds = sum(r.dur_ns for r in mod.spans("kernels.build") if r.parent in ids)
    return (sum(r.dur_ns for r in caps) - builds) * 1e-9
