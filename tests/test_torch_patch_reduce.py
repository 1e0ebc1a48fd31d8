"""KR's moment mode and its chunk count bound, on the CPU.

- ``ops/onehot.py:patch_moment_sums`` on CPU tensors is exactly
  ``patch_reduce_reference(masked_moment_features_cols(...))`` (tolerance 0)
  and equals, bit for bit, the fold written out in float32 numpy
  (tests/test_torch_engines.py:_fold_sum) over monomials formed in numpy,
  on the per-patch sum's hazards: empty patches among one-chunk and
  multi-chunk ones, one-point patches, -0.0 coordinates, negative
  coordinates under mask 0 (their masked monomials are -0.0), and only
  empty patches. Every patch whose rows are all masked out sums to +0.0.
- The same sums equal the JAX package's ``patch_reduce`` of its
  ``masked_moment_features_cols`` within the 1e-5 that
  test_torch_engines.py:test_patch_reduce_matches_jax_patch_reduce states
  (the JAX sum is a one-hot dot in the host's order).
- The moment mode's ``extern "C"`` entry, and the one that reads the
  kernels' own launch counts, have the argtypes the wrapper declares; the
  wrapper runs the plain version on a CPU tensor without counting, and the
  kernel refuses a tensor that is not on CUDA.
- A call's chunk count (counted by brute force) stays within
  ``ops/patch_reduce_kernel.py:max_chunks``, which sizes the kernel's grid
  and its scratch, with equality where every patch holds one row. The
  kernel's own chunk map is held on the card (the ``gpu`` cases below and
  chip_smoke.py's recorded calls).

The moment mode on the card: test_torch_engines.py:
test_cuda_patch_reduce_matches_plain_on_card (``gpu``) and chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from test_torch_engines import _bits, _fold_sum, _kr_cases  # noqa: E402


def _moment_inputs(rng, counts):
    """(qx, qy, qz, mask) columns, patch_id and start for per-patch
    ``counts``: coordinates of a few metres, about half the rows masked."""
    counts = np.asarray(counts)
    start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    pid = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    p = int(counts.sum())
    q = (rng.normal(size=(3, p)) * 4.0).astype(np.float32)
    mask = (rng.random(p) < 0.5).astype(np.float32)
    return [q[0], q[1], q[2], mask], pid, start


def _moment_cases():
    """name -> ((qx, qy, qz, mask), patch_id, start)."""
    rng = np.random.default_rng(5)
    cases = {}
    # the generic mode's mixed runs (empty, one-point, one-chunk, exactly
    # one chunk, multi-chunk, a long overflow bucket), as moments
    cases["mixed"] = _moment_inputs(rng, np.diff(_kr_cases()["mixed"][2]))
    # -0.0 coordinates under mask 1 (whole patches, and scattered) and
    # negative coordinates under mask 0: their masked monomials are -0.0
    cols, pid, st = _moment_inputs(rng, [3, 128, 256, 400, 1, 0, 90, 200])
    for c in cols[:3]:
        c[: st[2]] = -0.0
        c[st[4]: st[7]][rng.random(st[7] - st[4]) < 0.3] = -0.0
        c[st[2]: st[4]] = -np.abs(c[st[2]: st[4]]) - 1.0
    cols[3][: st[2]] = 1.0
    cols[3][st[2]: st[4]] = 0.0
    cols[3][st[7]:] = 0.0  # a patch of mixed signs, all masked out
    cases["signed_zeros"] = (cols, pid, st)
    # one-point and empty patches only
    cases["one_point"] = _moment_inputs(rng, [1, 0, 1, 1, 0, 0, 1, 0, 1])
    # only empty patches (no rows)
    cases["only_empty"] = _moment_inputs(rng, [0] * 6)
    return cases


def _numpy_monomials(qx, qy, qz, m):
    mx, my, mz = qx * m, qy * m, qz * m
    return np.stack([m, mx, my, mz, mx * mx, mx * my, mx * mz, my * my, my * mz, mz * mz], 1)


@pytest.mark.parametrize("case", ["mixed", "signed_zeros", "one_point", "only_empty"])
def test_patch_moment_sums_is_the_plain_sum_of_the_monomials(case):
    """Tolerance 0: the CPU path of the moment mode is the plain version of
    the monomial table, and both equal the fold written out in numpy over
    numpy's float32 monomials (the same products, the same adds)."""
    from patchworkpp_tpu_torch.ops.moments import masked_moment_features_cols
    from patchworkpp_tpu_torch.ops.onehot import patch_moment_sums, patch_reduce_reference

    cols, pid, start = _moment_cases()[case]
    tcols = [torch.from_numpy(c) for c in cols]
    tpid, tstart = torch.from_numpy(pid), torch.from_numpy(start)
    got = patch_moment_sums(*tcols, tpid, tstart).numpy()
    plain = patch_reduce_reference(masked_moment_features_cols(*tcols), tpid, tstart).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(_fold_sum(_numpy_monomials(*cols), start)))
    counts = np.diff(start)
    masked_out = np.array([not cols[3][a:b].any() for a, b in zip(start[:-1], start[1:])])
    assert (_bits(got[counts == 0]) == 0).all()  # empty patches: +0.0
    assert (_bits(got[masked_out]) == 0).all()  # no -0.0 from masked rows
    if case == "signed_zeros":
        assert (_bits(got[:2, 1:]) == 0).all()  # -0.0 coordinates sum to +0.0


def test_patch_moment_sums_matches_jax_patch_reduce():
    """Against the JAX package's one-hot dot of its monomial table over the
    512-wide patch space: within 1e-5 (rtol and atol, as
    test_patch_reduce_matches_jax_patch_reduce); the order differs, so the
    bits may."""
    from patchworkpp_tpu.ops.moments import masked_moment_features_cols as j_features
    from patchworkpp_tpu.ops.onehot import patch_reduce as j_patch_reduce

    from patchworkpp_tpu_torch.ops import SPAD
    from patchworkpp_tpu_torch.ops.onehot import patch_moment_sums

    rng = np.random.default_rng(9)
    counts = rng.integers(0, 40, SPAD)
    counts[::9] = 0
    counts[17] = 700
    cols, pid, start = _moment_inputs(rng, counts)
    cols = [c * np.float32(0.25) for c in cols[:3]] + [cols[3]]  # |q| ~ 1 m
    got = patch_moment_sums(*(torch.from_numpy(c) for c in cols), torch.from_numpy(pid),
                            torch.from_numpy(start)).numpy()
    want = np.asarray(jax.jit(lambda *a: j_patch_reduce(j_features(*a[:4]), a[4]))(
        *(jnp.asarray(c) for c in cols), jnp.asarray(pid)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_patch_moments_argtypes_follow_extern_c_signature():
    from test_torch_fit import _extern_c_argtypes

    from patchworkpp_tpu_torch.ops import patch_reduce_kernel as kr

    assert list(kr.MOMENT_ARGTYPES) == _extern_c_argtypes(kr.SOURCE, "ppk_patch_moments")


def test_launch_count_entry_follows_its_extern_c_signature():
    """The entry that reads the kernels' own launch counts: its argtypes
    follow its signature, and the wrapper names one counter for each of the
    source's LaunchCounter values, in their order."""
    import re

    from test_torch_fit import _extern_c_argtypes

    from patchworkpp_tpu_torch.ops import patch_reduce_kernel as kr

    assert list(kr.LAUNCH_ARGTYPES) == _extern_c_argtypes(kr.SOURCE, "ppk_patch_reduce_launches")
    enum = re.search(r"enum LaunchCounter \{([^}]*)\}", kr.SOURCE.read_text()).group(1)
    names = [n.strip() for n in enum.split(",")]
    assert names[-1] == "kCounters"
    assert len(names) - 1 == len(kr.LAUNCH_COUNTERS)
    assert names[:-1] == ["kChunkSums", "kMomentSums", "kFoldGeneric", "kFoldMoments"]
    assert kr.LAUNCH_COUNTERS == ("kr_chunk_sums", "kr_moment_sums", "kr_fold generic",
                                  "kr_fold moments")


def test_patch_moment_sums_runs_plain_on_cpu_without_counting():
    from patchworkpp_tpu_torch.ops.onehot import patch_moment_sums
    from patchworkpp_tpu_torch.ops.patch_reduce_kernel import (
        patch_moment_sums_kernel,
        patch_reduce_kernel,
    )

    cols, pid, start = _moment_cases()["mixed"]
    tcols = [torch.from_numpy(c) for c in cols]
    before = (patch_reduce_kernel.launches, patch_moment_sums_kernel.launches)
    patch_moment_sums(*tcols, torch.from_numpy(pid), torch.from_numpy(start))
    assert (patch_reduce_kernel.launches, patch_moment_sums_kernel.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        patch_moment_sums_kernel(*tcols, torch.from_numpy(start))
    with pytest.raises(ValueError, match="CUDA tensors"):
        patch_moment_sums(*(c.to("meta") for c in tcols), torch.from_numpy(pid).to("meta"),
                          torch.from_numpy(start).to("meta"))


def _chunk_count_cases():
    """name -> per-patch row counts, and the rows past the last patch."""
    return {
        "rows_not_a_multiple_of_128": ([5, 300, 0, 129, 1, 0, 77], 0),
        "all_rows_in_one_patch": ([1000], 0),
        "a_313_chunk_patch": ([3, 40064, 0, 1], 0),
        "only_empty_patches": ([0] * 9, 0),
        "only_empty_patches_rows_outside": ([0] * 9, 200),
        "one_row_patches": ([1] * 513, 0),
        "rows_past_the_last_patch": ([130, 0, 2], 61),
    }


@pytest.mark.parametrize("case", list(_chunk_count_cases()))
def test_max_chunks_bounds_every_layout(case):
    """The kernel's grid and the wrapper's scratch are sized by max_chunks
    from the shapes alone: the chunks a call has (each patch cut into
    kChunk-row chunks from its first row, counted by brute force) never
    exceed it, with equality where every patch holds one row; the source's
    chunk length is the wrapper's."""
    import re

    from patchworkpp_tpu_torch.ops.patch_reduce_kernel import CHUNK, SOURCE, max_chunks

    assert re.search(r"constexpr int kChunk = (\d+);", SOURCE.read_text()).group(1) == str(CHUNK)
    counts, outside = _chunk_count_cases()[case]
    chunks = sum(len(range(0, n, CHUNK)) for n in counts)
    rows = sum(counts) + outside
    assert chunks <= max_chunks(rows, len(counts))
    if case == "one_row_patches":
        assert chunks == max_chunks(rows, len(counts))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_events(names):
    """Device events of the named kernels, 10 us apart, as a profiler trace
    reads them (a kernel's name carries its signature), with a host event
    and an annotation among them."""
    from patchworkpp_tpu_torch.utils.roofline import Event

    out = [Event("aten::copy_", 0.0, 5.0, False, False, 5.0),
           Event("kr_fold", 1.0, 1.0, True, True, 0.0)]
    for i, n in enumerate(names):
        out.append(Event(f"(anonymous namespace)::{n}(float const*, int)", 10.0 * (i + 1), 4.0,
                         True, False, 0.0))
    return out[::-1]  # the reader sorts by start


@pytest.mark.parametrize("order, want", [
    (["kr_chunk_sums", "kr_fold", "kr_moment_sums", "kr_fold", "kr_moment_sums", "kr_fold"],
     {"generic": {"kr_chunk_sums": 1, "kr_fold": 1},
      "moments": {"kr_moment_sums": 2, "kr_fold": 2}}),
    (["kr_fold"], "no chunk launch before it"),
    (["kr_chunk_sums", "kr_moment_sums", "kr_fold"], "with no kr_fold"),
    (["kr_moment_sums", "kr_fold", "kr_chunk_sums"], "has no kr_fold"),
], ids=["both_modes", "fold_first", "chunk_after_chunk", "last_without_fold"])
def test_chip_smoke_counts_kr_launches_by_mode_from_a_trace(order, want):
    """chip_smoke.kr_launches, which reads KR's kernels (launches and device
    ms by name) from phase 4e's trace of unfused replays: each kernel
    counted by name among the trace's device kernels
    (annotations and host events ignored), each fold given to the mode of
    the chunk launch before it, and a trace out of that order refused."""
    cs = _chip_smoke()
    events = _kernel_events(order)
    if isinstance(want, str):
        with pytest.raises(AssertionError, match=want):
            cs.kr_launches(events)
        return
    got = cs.kr_launches(events)
    assert got["by_mode"] == want
    assert {n: v["launches"] for n, v in got["by_kernel"].items()} == {
        "kr_chunk_sums": 1, "kr_moment_sums": 2, "kr_fold": 3}
    assert got["by_kernel"]["kr_fold"]["ms"] == pytest.approx(3 * 4.0 / 1e3)
