"""The processed patches a scan that held no point and took the plane of
the patch before them (the program's counter ``frame.inherited_planes``),
over every scan the facade's steps unpacked in the run. Nothing to read
where the program has no such counter: it counts only where the frame
carries planes (``num_min_pts`` 0)."""

from benchmark.metrics._spans import recorder


def read(run):
    mod = recorder()
    if mod is None or not hasattr(mod, "counters"):
        return None
    count = mod.counters().get("frame.inherited_planes")
    scans = sum(r.scans for r in mod.spans("facade.step"))
    if count is None or not scans:
        return None
    return count.n / scans
