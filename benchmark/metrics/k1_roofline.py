"""The fit kernel K1's share of its roofline: its least time a launch
(``peaks.k1_least_seconds``, from the benchmark's own binning of the
scans) over its mean time a launch in the traced slice. K1 is the fit
program on the bf16x3 sum (``fit_program_kernel<Split3>``); K2, the same
program on a plain float32 chain, does not count."""

NAME = "fit_program_kernel"
NOT = "F32Chain"


def read(run):
    t = run.trace
    if t is None or not run.k1_least_s:
        return None
    launches, seconds = 0, 0.0
    for name, (n, s) in t.kernels.items():
        if NAME in name and NOT not in name:
            launches += n
            seconds += s
    if not launches or seconds <= 0:
        return None
    return 100.0 * run.k1_least_s / (seconds / launches)
