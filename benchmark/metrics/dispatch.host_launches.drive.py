"""Host calls that put work on a stream (kernel and graph launches, copies,
sets; ``trace.HOST_LAUNCH_CALLS``) in the traced slice, a scan."""


def read(run):
    t = run.trace
    if t is None or not t.scans:
        return None
    return t.host_launch_calls / t.scans
