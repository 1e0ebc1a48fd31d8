"""The port's native prefetching loader (io/native_loader.py over
csrc/loader.cpp, built at first use with g++): the five cases of
tests/test_native_loader.py (order, loop mode, a missing file, truncation,
a scan of exactly the capacity) on synthetic ``.bin`` files, each staged
buffer held against the port's ``read_bin`` + ``pad_cloud``; long looping
runs on the schedule that wedges the JAX package's native/loader.cpp with
several workers; and the streaming bench's native path. Skips only where
g++ is absent.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from patchworkpp_tpu_torch.io import NativeScanLoader
from patchworkpp_tpu_torch.io import native_loader
from patchworkpp_tpu_torch.io.kitti import pad_cloud, read_bin
from patchworkpp_tpu_torch.io.synthetic import make_scan
from test_torch_frame import _one_torch_thread  # noqa: F401

CAP = 16384


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native loader cannot be built here")
    assert native_loader.available()
    d = tmp_path_factory.mktemp("native_scans")
    out = []
    for f in range(4):
        p = d / f"{f:06d}.bin"
        make_scan(0, f)[:: 8 + f].tofile(p)  # unequal lengths
        out.append(str(p))
    return out


def test_ordered_iteration_matches_numpy(paths):
    with NativeScanLoader(paths, capacity=CAP, queue_depth=3) as ld:
        seen = 0
        for view, npts, idx in ld:
            assert idx == seen
            want, n = pad_cloud(read_bin(paths[idx]), CAP)
            assert npts == n
            np.testing.assert_array_equal(view, want)
            seen += 1
        assert seen == len(paths)
        assert ld.io_errors == 0 and ld.truncations == 0


def test_long_loop_does_not_wedge(paths):
    """Many short looping runs with a slow consumer and the default two
    workers: each run ends in well under a second."""
    import time

    for _ in range(10):
        with NativeScanLoader(paths, capacity=CAP, queue_depth=4, loop=True) as ld:
            for i, (_, _, idx) in enumerate(ld):
                assert idx == i
                time.sleep(0.001)
                if i == 40:
                    break


def test_three_workers_do_not_deadlock(paths):
    """The schedule on which native/loader.cpp deadlocks (a worker claims
    its scan index before it holds a free slot): 3 workers, 4 slots, loop
    mode, a consumer that takes 2 ms a scan, 20 runs. It runs in its own
    process under a timeout, so a hang fails the test instead of the suite."""
    root = Path(__file__).resolve().parent.parent
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(root)!r})
        from patchworkpp_tpu_torch.io import NativeScanLoader
        for run in range(20):
            with NativeScanLoader({paths!r}, capacity={CAP}, queue_depth=4,
                                  n_threads=3, loop=True) as ld:
                for i, (_, _, idx) in enumerate(ld):
                    assert idx == i, (run, i, idx)
                    time.sleep(0.002)
                    if i == 40:
                        break
        print("runs 20")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["runs", "20"]


def test_loop_mode_wraps(paths):
    with NativeScanLoader(paths[:2], capacity=CAP, loop=True) as ld:
        it = iter(ld)
        got = []
        for _ in range(5):
            view, npts, idx = next(it)
            np.testing.assert_array_equal(view, pad_cloud(read_bin(paths[idx % 2]), CAP)[0])
            got.append(idx)
        assert got == [0, 1, 2, 3, 4]  # the index keeps counting past the end


def test_missing_file_counts_error(paths, tmp_path):
    with NativeScanLoader([paths[0], str(tmp_path / "nope.bin")], capacity=CAP) as ld:
        out = [(view.copy(), npts, idx) for view, npts, idx in ld]
        assert [o[2] for o in out] == [0, 1]
        np.testing.assert_array_equal(out[0][0], pad_cloud(read_bin(paths[0]), CAP)[0])
        assert out[1][1] == 0 and not out[1][0].any()  # a failed scan: 0 points
        assert ld.io_errors == 1 and ld.truncations == 0


def test_oversized_scan_truncation_is_observable(paths):
    ref = read_bin(paths[0])
    cap = 1024
    with NativeScanLoader(paths[:2], capacity=cap) as ld:
        view, npts, idx = next(ld)
        assert (idx, npts) == (0, cap) and ld.last_truncated is True
        assert 1 <= ld.truncations <= 2  # prefetch: this scan, maybe the next
        np.testing.assert_array_equal(view, ref[:cap])
        _, npts2, _ = next(ld)
        assert npts2 == cap and ld.last_truncated is True and ld.truncations == 2


def test_exact_capacity_scan_is_not_flagged(paths, tmp_path):
    n = 2048
    path = tmp_path / "exact.bin"
    read_bin(paths[0])[:n].tofile(path)
    with NativeScanLoader([str(path)], capacity=n) as ld:
        view, npts, _ = next(ld)
        assert npts == n and ld.last_truncated is False and ld.truncations == 0
        np.testing.assert_array_equal(view, pad_cloud(read_bin(str(path)), n)[0])


def test_stream_bench_native_loader_matches_numpy(paths):
    """cli/stream_bench.py's two loaders: the same frames, the same labels
    on the first epoch (each staged buffer goes through one reused host
    tensor on the native path)."""
    import torch

    from patchworkpp_tpu_torch.cli import stream_bench

    dev = torch.device("cpu")
    n_nat, _, nat = stream_bench.run(dev, CAP, 2, "native", paths=paths)
    n_np, _, ref = stream_bench.run(dev, CAP, 2, "numpy", scans=[read_bin(p) for p in paths])
    assert n_nat == n_np == 2 * len(paths) and len(nat) == len(ref) == len(paths)
    for a, b in zip(nat, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="scan-dir"):
        stream_bench.main(["--device", "cpu", "--loader", "native", "--scan-dir", ""])


def test_a_loader_that_cannot_build_raises(paths, tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "SOURCE", tmp_path / "missing.cpp")
    assert not native_loader.available()
    with pytest.raises(RuntimeError, match="source not found"):
        NativeScanLoader(paths, capacity=CAP)
