#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (patchworkpp_tpu_torch).

Phases, in order; any failure raises and exits nonzero before the last line:

1. print the card (nvidia-smi name, power limit) and build the two CUDA fit
   kernels, K1 from patchworkpp_tpu_torch/csrc/fit_grid.cu and K2 from
   csrc/fit_onehot.cu (both the fit program of csrc/fit_program.cuh, with
   their own per-patch sums), with one nvcc each started together (build
   time, ptxas reports);
2. make a synthetic KITTI-scale scan from --seed (io/synthetic.py: 64
   beams over 360 deg, a tilted noisy ground plane, walls, boxes, reflected
   noise below ground, points out of range);
3. hold each fit kernel against its plain PyTorch version on the card and
   on the CPU, on that scan's tiled inputs at capacity 131072, on a
   crowded-patch cloud whose largest patch holds more tiles than the kernels
   keep in shared memory (so it is staged chunk by chunk at every walk) and
   on a cloud whose processed patches hold one tile each; K1 also on a
   small cloud with num_iter=4 (K2 refuses it); on each cloud K2's integer
   columns must equal K1's;
4. drive the main paths through PatchworkPP(...).estimate_ground over
   --frames state-chained frames: the default engine (K1) and
   fused="onehot" (K2), each with every launch count set to 0 just before
   and read just after; the labels must equal the CPU path's on the same
   frames, each kernel's launch count must equal the frame count on its
   path and be 0 on the other's, the final adaptive state must agree; then
   the unfused engine (fused=False) for 3 frames, labels equal to the CPU
   unfused engine's; the labels that differ between the three engines are
   printed, not asserted;
4b. the serving surface: for each preset (models/presets.py:
   patchwork_params, R-VPF and TGR off; ros_launch_params, num_min_pts=0)
   K1 bit for bit against its plain version on that preset's tiled inputs,
   and 3 chained facade frames on the card equal to the CPU path's; the
   facade's estimate_ground_sequence of 6 scans equal to the estimate_ground
   loop (labels and state, bit for bit) with one device -> host copy, and a
   quarter-density scan bucketed at capacity 131072 equal to capacity 32768;
   the streaming server (serve/server.py) in a closed loop over 20 chained
   scans, each answered within a timeout by a live worker, labels and state
   equal to a facade's, K1 launched 20 times and K2 none (counts set to 0
   just before), its p50/p95 service latency and timing report printed;
   a 6-scan backlog through batch_max=2 equal to the per-frame facade; two
   streams of serve/multi_stream.py equal to two facades; the compat
   module's getters equal to the facade's result; and cli/bench.py run in
   its own process at a short setting, its JSON line parsed and printed;
4c. references: six synthetic scans make_scan(0, 0..5) at full width are
   written as .bin files; golden-format npz files (fresh_<name>, seq_<name>)
   are built from the CPU path, tiled and unfused; scripts/gpu_parity.py runs
   in its own process on the card over the 12 configurations (modes None
   and onehot against the tiled npz, False against the unfused one: 36 PASS
   lines, exit 0); the port's NumPy oracle (oracle/, on the host, one
   process per fresh scan and one for the chain) labels the same 12
   configurations, and the card's tiled and onehot labels must equal the
   oracle's on every configuration outside ENGINE_VS_ORACLE, and differ
   from it exactly where the CPU path does, point for point, on those in
   it; cli/eval_semantickitti.py scores the card against the tiled npz at
   --batch 1 and 2 (precision = recall = f1 = 1); cli/stream_bench.py
   streams the files through the native loader and the numpy one, with
   the same frames and first-epoch labels, their scans/s printed;
5. time both kernels (also on the crowded-patch cloud), their plain
   versions on the card and the frame of each engine, with CUDA events
   after warm-up; print K1's time per walk of
   the largest patch over its tiles (kernel ms / (tiles x walks)) and the
   kernels JSON line;
6. print {"ok": true, "device": {...}} as the last line.

With --profile, a torch.profiler window over a few frames of each engine
(tiled, onehot, unfused) follows phase 5: host and device time per frame
stage, the device's busy share and the kernels that take the most device
time (printed, and kept in chiprun_out/chip_smoke.json with the other
numbers).

Usage: python3 chip_smoke.py [--seed 0] [--frames 20] [--profile]
Needs one CUDA card and nvcc (CUDA toolkit); run from a checkout of the repo.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

CAPACITY = 131072
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores
SLEEP_CYCLES_PER_S = 1.98e9  # torch.cuda._sleep's unit at the H100's top SM clock
# f32 operations per tiled row and pass of the fit program: distance or
# seed test (~8), 3 shifts, 15 monomial products, 10 lane-sum adds, mask
# and LPR bookkeeping (~4). Both kernels run the same 7 fused passes, so
# both are held to that work.
FIT_OPS_PER_ROW_PASS = 40
UNFUSED_FRAMES = 3
SERVER_FRAMES = 20
# A kernel and its plain version run the same float operations in the same
# order (nvcc's contraction off, the plain version's fused multiply-adds as
# explicit ones), so their tables must agree bit for bit (tolerance 0).
# CPU path vs card path, adaptive state floats: within STATE_ATOL.
STATE_ATOL = 1e-5


def compare_tables(k, ref, params, label, exact=True):
    """Kernel table vs plain table: integer columns equal, NaNs in the same
    places, and, when ``exact``, every other float equal bit for bit (else
    its largest difference is only printed). Returns max |err|."""
    import torch

    from patchworkpp_tpu_torch.ops.fit_kernel import OUT_GCOUNT, OUT_N
    from patchworkpp_tpu_torch.ops.tiled_fit import out_layout

    k, ref = k.double().cpu(), ref.double().cpu()
    if k.shape != ref.shape:
        raise AssertionError(f"{label}: shape {tuple(k.shape)} vs {tuple(ref.shape)}")
    snap_off, carry2_off, _ = out_layout(params)
    int_cols = [OUT_N, OUT_GCOUNT] + list(range(snap_off, carry2_off, 5))
    if not torch.equal(k[:, int_cols], ref[:, int_cols]):
        bad = (k[:, int_cols] != ref[:, int_cols]).nonzero()[:5].tolist()
        raise AssertionError(f"{label}: integer columns differ at {bad}")
    nan_k, nan_r = torch.isnan(k), torch.isnan(ref)
    if not torch.equal(nan_k, nan_r):
        raise AssertionError(f"{label}: NaN positions differ")
    fin = ~nan_k
    # infinities (a one-point fit's plane) count in the bitwise test only
    err = (k - ref).abs()[torch.isfinite(k) & torch.isfinite(ref)]
    max_err = float(err.max()) if err.numel() else 0.0
    bitwise = bool(torch.equal(k[fin], ref[fin]))
    if exact and not bitwise:
        worst = int(((k - ref).abs().nan_to_num(0.0)).max(dim=0).values.argmax())
        raise AssertionError(
            f"{label}: not bit for bit, max |err| {max_err} (worst column {worst}, "
            f"rows differing {int(((k != ref) & fin).any(dim=1).sum())})"
        )
    print(f"{label}: max_abs_err {max_err} bitwise {bitwise}")
    return max_err


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn``, from CUDA events around ``reps`` calls.
    The timed calls are queued behind a device-side sleep twice as long as
    their host time, so that a kernel shorter than its wrapper's host
    overhead is timed on the card, not on the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profile_frames(frame, state, xs_dev, npts, n: int = 5) -> dict:
    """torch.profiler over n frames, reported per frame by
    utils/roofline.py:frame_report: the host time of each stage_* range
    (pipeline.py), its span on the device and the device time of the
    kernels inside that span; the device's busy share of the window
    (kernel and copy time over wall time); the count of device launches and
    of device -> host copies; and the kernels with the most device time."""
    from patchworkpp_tpu_torch.utils.roofline import frame_report, print_frame_report, trace

    def run():
        nonlocal state
        for k in range(n):
            state, _ = frame(state, xs_dev[k], npts[k])

    events, wall_s = trace(run)
    out = frame_report(events, wall_s, n)
    print_frame_report(out)
    return out


def _equal_states(a, b, label):
    """Two adaptive states equal bit for bit."""
    sa, sb = a.to_numpy(), b.to_numpy()
    for key in sa:
        if not np.array_equal(sa[key], sb[key]):
            raise AssertionError(f"{label}: state {key} differs")


def _equal_labels(got, want, label):
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g.ground_mask, w.ground_mask):
            raise AssertionError(f"{label} frame {i}: "
                                 f"{int((g.ground_mask != w.ground_mask).sum())} labels differ")


def serving_phase(seed, scans, fit_inputs, check_k1, here, device="cuda",
                  timeout=120.0) -> dict:
    """Phase 4b: the serving surface on the card (presets, the facade's
    sequence and bucketed upload, the streaming server, the multi-stream
    segmenter, the compat module, the bench) on ``device``. Raises on any
    failure."""
    import threading

    import torch

    from patchworkpp_tpu_torch import PatchworkPP
    from patchworkpp_tpu_torch.compat import pypatchworkpp
    from patchworkpp_tpu_torch.io.synthetic import make_scan
    from patchworkpp_tpu_torch.models import patchwork_params, ros_launch_params
    from patchworkpp_tpu_torch.ops import fit_kernel as fk
    from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg
    from patchworkpp_tpu_torch.serve import (
        CloudMsg,
        GroundSegmentationServer,
        MultiStreamSegmenter,
        ServerConfig,
    )
    from patchworkpp_tpu_torch.utils.roofline import trace

    t_phase = time.perf_counter()
    chain = scans if len(scans) >= SERVER_FRAMES else [
        make_scan(seed, f) for f in range(SERVER_FRAMES)]
    out = {}

    # a. the presets: K1 bit for bit against its plain version, then three
    # chained facade frames on the card equal to the CPU path's
    for label, params in (("patchwork_params", patchwork_params()),
                          ("ros_launch_params", ros_launch_params())):
        check_k1(fit_inputs(chain[0], params), params, label)
        gpu = PatchworkPP(params, capacity=CAPACITY, device=device)
        cpu = PatchworkPP(params, capacity=CAPACITY, device="cpu")
        res = [gpu.estimate_ground(s) for s in chain[:3]]
        _equal_labels(res, [cpu.estimate_ground(s) for s in chain[:3]],
                      f"{label}, card vs cpu")
        print(f"{label}: 3 chained frames, labels equal to the cpu path, ground "
              f"{[int(r.ground_mask.sum()) for r in res]}")

    # b. the facade: one sequence call == the frame loop, one device->host
    # copy for the run; the bucketed upload == a tight capacity
    seq_m = PatchworkPP(capacity=CAPACITY, device=device)
    loop_m = PatchworkPP(capacity=CAPACITY, device=device)
    seq_res = []
    events, _ = trace(lambda: seq_res.extend(seq_m.estimate_ground_sequence(chain[:6])))
    dtoh = sum(1 for e in events if e.on_device and "DtoH" in e.name)
    loop_res = [loop_m.estimate_ground(s) for s in chain[:6]]
    _equal_labels(seq_res, loop_res, "estimate_ground_sequence vs estimate_ground")
    _equal_states(seq_m.state, loop_m.state, "estimate_ground_sequence vs estimate_ground")
    if dtoh != (device == "cuda"):  # one copy on the card (none on the CPU)
        raise AssertionError(f"estimate_ground_sequence of 6 scans made {dtoh} "
                             "device->host copies, expected 1")
    sparse = make_scan(seed)[::4]
    wide = PatchworkPP(capacity=CAPACITY, device=device).estimate_ground(sparse)
    tight = PatchworkPP(capacity=32768, device=device).estimate_ground(sparse)
    _equal_labels([wide], [tight], f"{len(sparse)} points at capacity {CAPACITY} vs 32768")
    print(f"facade: sequence of 6 == frame loop (labels, state), {dtoh} device->host "
          f"copy; {len(sparse)}-point scan bucketed at {CAPACITY} == capacity 32768")

    # c. the server, closed loop: one message in flight, each answered in time
    srv = GroundSegmentationServer(config=ServerConfig(capacity=CAPACITY), device=device)
    got, lat, errors, answered = [], [], [], threading.Event()

    def on_result(r):
        lat.append(time.perf_counter() - r.msg.stamp)
        got.append(r.result)
        errors.append(r.error)
        answered.set()

    srv.on_result(on_result)

    def wait_answer(server, what):
        t_end = time.perf_counter() + timeout
        while not answered.wait(0.05):
            if not server.worker_alive:
                raise RuntimeError(f"{what}: server worker died: {server.worker_error!r}")
            if time.perf_counter() > t_end:
                raise RuntimeError(f"{what}: no answer within {timeout} s")
        failed = [e for e in errors if e is not None]
        if failed:  # a build or launch error on the first frame fails at once
            raise RuntimeError(f"{what}: a scan raised in the server: {failed[0]!r}")

    fkg.fused_fit_grid.launches = 0
    fk.fused_fit.launches = 0
    with srv:
        for i, s in enumerate(chain[:SERVER_FRAMES]):
            answered.clear()
            srv.publish(CloudMsg(points=s, stamp=time.perf_counter()))
            wait_answer(srv, f"closed loop message {i}")
    counts = {"fit_grid": fkg.fused_fit_grid.launches, "fit_onehot": fk.fused_fit.launches}
    want_k1 = SERVER_FRAMES if device == "cuda" else 0  # the CPU runs the plain fit
    if counts != {"fit_grid": want_k1, "fit_onehot": 0}:
        raise AssertionError(f"server: launches {counts} in {SERVER_FRAMES} frames, "
                             f"expected fit_grid {want_k1} and fit_onehot 0")
    ref = PatchworkPP(capacity=CAPACITY, device=device)
    _equal_labels(got, [ref.estimate_ground(s) for s in chain[:SERVER_FRAMES]],
                  "server vs facade")
    _equal_states(srv._model.state, ref.state, "server vs facade")
    lat_ms = np.asarray(lat) * 1e3
    out["server"] = {
        "frames": SERVER_FRAMES, "launches": counts,
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "latency_ms_max": float(lat_ms.max()),
        "latency_ms_each": lat_ms.tolist(),
        "timing_report": srv.timing_report(),
    }
    print(f"server closed loop: {SERVER_FRAMES} frames at capacity {CAPACITY}, labels "
          f"and state equal to the facade's, launches {counts}; service latency "
          f"p50 {out['server']['latency_ms_p50']:.3f} ms, p95 "
          f"{out['server']['latency_ms_p95']:.3f} ms, max "
          f"{out['server']['latency_ms_max']:.3f} ms; {srv.timing_report()}")

    # c'. a backlog through the batching path (queue_depth 8, batch_max 2)
    back = GroundSegmentationServer(
        config=ServerConfig(capacity=CAPACITY, queue_depth=8, batch_max=2), device=device)
    batches = []
    seq_call = back._model.estimate_ground_sequence

    def counted(clouds):
        batches.append(len(clouds))
        return seq_call(clouds)

    back._model.estimate_ground_sequence = counted
    back_res = []
    back.on_result(lambda r: (back_res.append(r.result), errors.append(r.error),
                              answered.set() if len(back_res) == 6 or r.error else None))
    answered.clear()
    with back:
        for s in chain[:6]:
            back.publish(CloudMsg(points=s, stamp=time.perf_counter()))
        wait_answer(back, "backlog")
    ref = PatchworkPP(capacity=CAPACITY, device=device)
    _equal_labels(back_res, [ref.estimate_ground(s) for s in chain[:6]], "backlog vs facade")
    if back.sensor_height != ref.sensor_height:
        raise AssertionError(f"backlog sensor_height {back.sensor_height} != {ref.sensor_height}")
    out["backlog_sequence_calls"] = len(batches)
    print(f"server backlog: 6 scans, {len(batches)} sequence calls of 2, labels and "
          "sensor_height equal to the per-frame facade's")

    # d. two streams through one MultiStreamSegmenter == two facades
    ms = MultiStreamSegmenter(capacity=CAPACITY, device=device)
    other = [make_scan(seed + 1, f) for f in range(3)]
    fa = PatchworkPP(capacity=CAPACITY, device=device)
    fb = PatchworkPP(capacity=CAPACITY, device=device)
    for i in range(3):
        _equal_labels([ms.segment("a", chain[i]), ms.segment("b", other[i])],
                      [fa.estimate_ground(chain[i]), fb.estimate_ground(other[i])],
                      f"multi-stream step {i}")
    if (ms.sensor_height("a"), ms.sensor_height("b")) != (fa.sensor_height, fb.sensor_height):
        raise AssertionError("multi-stream sensor heights differ from the facades'")
    print("multi-stream: 2 streams x 3 interleaved frames equal to two facades")

    # e. the compat module's getters == the facade's result
    eng = pypatchworkpp.patchworkpp(pypatchworkpp.Parameters(), device=device)
    eng.estimateGround(chain[0])
    r = PatchworkPP(device=device).estimate_ground(chain[0])
    for got_v, want in ((eng.getGroundIndices(), r.ground_indices),
                        (eng.getNongroundIndices(), r.nonground_indices),
                        (eng.getCenters(), r.centers), (eng.getNormals(), r.normals),
                        (eng.getGround(), chain[0][r.ground_indices, :3])):
        if not np.array_equal(got_v, want):
            raise AssertionError("compat getters differ from the facade's result")
    print(f"compat: getters equal to the facade's result ({len(r.ground_indices)} ground)")

    # f. the bench, in its own process, at a short setting
    cmd = [sys.executable, "-m", "patchworkpp_tpu_torch.cli.bench",
           "--epochs", "24", "--groups", "3", "--seed", str(seed), "--device", device]
    proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if not (line["metric"].endswith("_seq_scans_per_s") and np.isfinite(line["value"])
            and line["value"] > 0):
        raise AssertionError(f"bench line malformed: {line}")
    out["bench"] = line
    print(f"bench ({' '.join(cmd[2:])}): {line['metric']} {line['value']:.3f} scans/s "
          f"(min {line['min']:.3f}, max {line['max']:.3f}; {line['groups']} groups, "
          f"{line['frames_total']} frames, {line['frames_per_dispatch']} a dispatch)")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"serving phase: {out['wall_s']:.1f} s")
    return out


# The configurations of make_scan(0, 0..5) (fresh_<f> per scan, seq_<f>
# chained) where the engines' labels differ from the oracle's, and by how
# many points, on the CPU; tests/test_torch_oracle.py holds the JAX engines,
# the JAX oracle and the port's CPU path to the same table. The engines
# equal the oracle on the other seven.
ENGINE_VS_ORACLE = {"fresh_000002": 17, "fresh_000003": 1, "fresh_000005": 16,
                    "seq_000002": 17, "seq_000005": 16}
REF_SCANS = [f"{i:06d}" for i in range(6)]


def _oracle_worker(paths, chain):
    """The port's NumPy oracle over ``paths`` (one fresh oracle per scan, or
    one chained through them): [(ground mask, patch id per point)], and the
    seconds per frame. Runs in its own process, on one CPU thread."""
    import torch

    from patchworkpp_tpu_torch.io import read_bin
    from patchworkpp_tpu_torch.oracle import NumpyPatchworkpp

    torch.set_num_threads(1)
    out, orc = [], NumpyPatchworkpp()
    t0 = time.perf_counter()
    for path in paths:
        if not chain:
            orc = NumpyPatchworkpp()
        out.append((orc.estimate_ground(read_bin(path)), orc.last_patch_id))
    return out, (time.perf_counter() - t0) / len(paths)


def references_phase(here, card, device="cuda") -> dict:
    """Phase 4c: the GPU parity script, the NumPy oracle, the eval CLI and
    the native loader on ``device``, over six synthetic scans written to a
    temporary directory. Raises on any failure."""
    import contextlib
    import io
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from patchworkpp_tpu_torch import PatchworkPP
    from patchworkpp_tpu_torch.cli import eval_semantickitti, stream_bench
    from patchworkpp_tpu_torch.io.synthetic import make_scan
    from patchworkpp_tpu_torch.ops import fit_kernel as fk
    from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg

    t_phase = time.perf_counter()
    dev = torch.device(device)
    per_frame = int(dev.type == "cuda")  # the CPU runs the plain fit
    out = {}
    tmp = tempfile.mkdtemp(prefix="ppk_references_")
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 3))  # the oracle takes three cores
    try:
        # 1. the scans (seed 0: ENGINE_VS_ORACLE is that seed's table)
        scans = [make_scan(0, f) for f in range(len(REF_SCANS))]
        paths = [os.path.join(tmp, f"{n}.bin") for n in REF_SCANS]
        for s, path in zip(scans, paths):
            s.tofile(path)
        # the oracle on the host, in three processes: the chain, and the
        # fresh scans in two halves (~9 s a frame on one host thread)
        chain_fut = pool.submit(_oracle_worker, paths, True)
        fresh_futs = [pool.submit(_oracle_worker, paths[:3], False),
                      pool.submit(_oracle_worker, paths[3:], False)]

        def configs(model):
            """{key: ground mask} over the 12 configurations."""
            masks = {}
            for variant in ("fresh", "seq"):
                model.reset()
                for name, s in zip(REF_SCANS, scans):
                    if variant == "fresh":
                        model.reset()
                    masks[f"{variant}_{name}"] = model.estimate_ground(s).ground_mask
            return masks

        # 2. golden-format npz files from the CPU path
        cpu = {}
        npz = {}
        for label, fused in (("tiled", None), ("unfused", False)):
            cpu[label] = configs(PatchworkPP(capacity=CAPACITY, device="cpu", fused=fused))
            npz[label] = os.path.join(tmp, f"golden_{label}.npz")
            np.savez(npz[label], **{k: np.flatnonzero(m).astype(np.int32)
                                    for k, m in cpu[label].items()})
        print(f"references: 6 scans of {len(scans[0])}+ points in {tmp}; npz from the "
              f"cpu path: tiled, unfused ({time.perf_counter() - t_phase:.1f} s)")

        # 3. scripts/gpu_parity.py on the card, in its own process
        passes = 0
        for modes, label in ((["None", "onehot"], "tiled"), (["False"], "unfused")):
            cmd = [sys.executable, os.path.join(here, "scripts", "gpu_parity.py"),
                   "--device", device, "--scan-dir", tmp, "--golden", npz[label],
                   "--capacity", str(CAPACITY), "--modes", *modes]
            proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                                  timeout=600)
            lines = proc.stdout.splitlines()
            verdicts = [ln for ln in lines if ln.startswith("[fused=") and ": " in ln
                        and ("PASS" in ln or "FAIL" in ln)]
            bad = [ln for ln in verdicts if "PASS (0 mismatched" not in ln]
            if (proc.returncode != 0 or bad or len(verdicts) != 12 * len(modes)
                    or lines[-1:] != ["PARITY: OK"]):
                raise AssertionError(
                    f"gpu_parity --modes {' '.join(modes)} exited {proc.returncode}: "
                    f"{bad or lines[-3:]} {proc.stderr[-2000:]}")
            passes += len(verdicts)
            print(f"gpu_parity --modes {' '.join(modes)} vs the {label} npz: "
                  f"{len(verdicts)} PASS, PARITY: OK")
        out["gpu_parity_pass_lines"] = passes

        # 4. the card's tiled and onehot labels, launches counted
        card_masks = {}
        for label, fused, kernel in (("tiled", None, "fit_grid"),
                                     ("onehot", "onehot", "fit_onehot")):
            fkg.fused_fit_grid.launches = 0
            fk.fused_fit.launches = 0
            card_masks[label] = configs(PatchworkPP(capacity=CAPACITY, device=device,
                                                    fused=fused))
            counts = {"fit_grid": fkg.fused_fit_grid.launches,
                      "fit_onehot": fk.fused_fit.launches}
            if counts != {k: 12 * per_frame if k == kernel else 0 for k in counts}:
                raise AssertionError(f"references, {label}: launches {counts} in 12 frames")

        # 5. the eval CLI on the card against the tiled npz
        fkg.fused_fit_grid.launches = 0
        for batch in (1, 2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                eval_semantickitti.main(["--device", device, "--scan-dir", tmp,
                                         "--golden", npz["tiled"], "--json",
                                         "--capacity", str(CAPACITY),
                                         "--batch", str(batch)])
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            if not (line["frames"] == 6 and line["precision"] == line["recall"]
                    == line["f1"] == 1.0):
                raise AssertionError(f"eval --batch {batch}: {line}")
            out[f"eval_batch{batch}"] = line
            print(f"eval_semantickitti --batch {batch}: precision {line['precision']} "
                  f"recall {line['recall']} f1 {line['f1']}, {line['scans_per_s']:.1f} "
                  "scans/s")
        if fkg.fused_fit_grid.launches != 12 * per_frame:
            raise AssertionError(f"eval: fit_grid launched {fkg.fused_fit_grid.launches} "
                                 "times in 12 frames")

        # 6. the oracle: card vs oracle, and the CPU path's difference kept
        t_wait = time.perf_counter()
        oracle = {}
        fresh, fresh_s = [], []
        for fut in fresh_futs:
            res, sec = fut.result()
            fresh += res
            fresh_s.append(sec)
        chain, chain_s = chain_fut.result()
        for name, f_res, c_res in zip(REF_SCANS, fresh, chain):
            oracle[f"fresh_{name}"] = f_res
            oracle[f"seq_{name}"] = c_res
        table = {}
        for key, (want, pid) in oracle.items():
            d_cpu = cpu["tiled"][key] != want
            for label, masks in card_masks.items():
                d_card = masks[key] != want
                if key not in ENGINE_VS_ORACLE and d_card.any():
                    raise AssertionError(f"{key}: card {label} differs from the oracle on "
                                         f"{int(d_card.sum())} points")
                if not np.array_equal(d_card, d_cpu):
                    raise AssertionError(f"{key}: card {label} - oracle is not cpu - oracle "
                                         f"({int(d_card.sum())} vs {int(d_cpu.sum())} points)")
            table[key] = int(d_cpu.sum())
            if d_cpu.any():
                print(f"  {key}: card and cpu differ from the oracle on the same "
                      f"{int(d_cpu.sum())} points, patches {sorted(set(pid[d_cpu].tolist()))}")
        out["engine_vs_oracle"] = table
        out["oracle_ms_per_frame"] = {"fresh": [1e3 * x for x in fresh_s],
                                      "chain": 1e3 * chain_s}
        print(f"oracle: 12 configurations; card == oracle on "
              f"{sum(v == 0 for v in table.values())}, card - oracle == cpu - oracle "
              f"elsewhere; oracle {np.mean(fresh_s) * 1e3:.0f} ms a fresh frame, "
              f"{chain_s * 1e3:.0f} ms a chained frame (one host thread each, "
              f"3 processes), waited {time.perf_counter() - t_wait:.1f} s")

        # 7. stream_bench: the native loader against the numpy one (after
        # the oracle's processes, which would share the host)
        rates, first = {}, {}
        for loader in ("numpy", "native"):
            fkg.fused_fit_grid.launches = 0
            frames, secs, first[loader] = stream_bench.run(
                dev, CAPACITY, 10, loader, scans=scans, paths=paths)
            if frames != 60 or fkg.fused_fit_grid.launches < frames * per_frame:
                raise AssertionError(f"stream_bench {loader}: {frames} frames, expected 60, "
                                     f"fit_grid launched {fkg.fused_fit_grid.launches} times")
            rates[loader] = frames / secs
        for i, (a, b) in enumerate(zip(first["native"], first["numpy"])):
            if not np.array_equal(a, b):
                raise AssertionError(f"stream_bench: native loader's labels differ on scan {i}")
        out["stream_scans_per_s"] = rates
        print(f"stream_bench, 60 frames each: numpy loader {rates['numpy']:.3f} scans/s, "
              f"native loader {rates['native']:.3f} scans/s, first-epoch labels equal "
              f"({card})")
    finally:
        torch.set_num_threads(threads)
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"references phase: {out['wall_s']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the frame")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import patchworkpp_tpu_torch
    from patchworkpp_tpu_torch import Params, PatchworkPP, init_state
    from patchworkpp_tpu_torch.cli import workload
    from patchworkpp_tpu_torch.io.synthetic import (
        make_crowded_scan,
        make_one_tile_scan,
        make_scan,
    )
    from patchworkpp_tpu_torch.ops import fit_kernel as fk
    from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg
    from patchworkpp_tpu_torch.ops.tiled_fit import tiled_fit
    from patchworkpp_tpu_torch.pipeline import make_frame_fn

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(patchworkpp_tpu_torch.__file__)))
    if pkg_dir != here:
        raise RuntimeError(f"patchworkpp_tpu_torch imported from {pkg_dir}, not this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = workload.card(dev)
    name = torch.cuda.get_device_name(0)

    # ---- 1. card and build (one nvcc per source, started together)
    print(f"card: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(fkg.build), pool.submit(fk.build)]:
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"fit kernels build (K1 and K2 in parallel): {build_s:.2f} s")
    print(fkg.build_log().strip())
    print(fk.build_log().strip())

    # ---- 2. scan
    p = Params()
    scans = [make_scan(args.seed, f) for f in range(args.frames)]
    print(f"scan: {len(scans[0])} points, frames {args.frames}")

    # ---- 3. kernel vs plain on the card, at the main path's shapes
    def fit_inputs(cloud, params, capacity=CAPACITY):
        x = torch.zeros((capacity, 4), device=dev)
        x[: len(cloud)] = torch.from_numpy(cloud).to(dev)
        return make_frame_fn(params, device=dev).fit_inputs(
            init_state(params, dev), x, len(cloud))

    def patch_tiles(fi):
        """(largest processed patch's tiles, processed tiles, processed patches)"""
        tiles = ((fi.pad_start[1:] - fi.pad_start[:-1]) // 128)[fi.processed]
        return int(tiles.max()), int(tiles.sum()), int(fi.processed.sum())

    def check_k1(fi, params, label):
        """K1 vs its plain version on the card and on the CPU, bit for bit."""
        a = (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates)
        out = fkg.fused_fit_grid(*a, fi.consts, params)
        torch.cuda.synchronize()
        compare_tables(out, tiled_fit(*(t.cpu() for t in a), fi.consts[0].cpu(), params),
                       params, f"K1 vs plain (cpu), {label}")
        err = compare_tables(out, tiled_fit(*a, fi.consts[0], params), params,
                             f"K1 vs plain (card), {label}")
        largest, ptiles, npatch = patch_tiles(fi)
        rows = ("resident in shared memory" if largest <= fkg.CAP_TILES
                else "staged in chunks at every walk")
        print(f"  {label}: {npatch} processed patches over {ptiles} tiles, largest "
              f"{largest} tiles ({rows})")
        return out, err

    fi = fit_inputs(scans[0], p)
    fit_args = (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
                fi.gates, fi.consts)
    k_out, max_err = check_k1(fi, p, "main scan")
    largest, proc_tiles, _ = patch_tiles(fi)
    if largest > fkg.CAP_TILES:
        raise AssertionError(f"main scan's largest patch ({largest} tiles) is over "
                             f"K1's shared-memory cap of {fkg.CAP_TILES}")
    print(f"tiled rows {fi.xs.numel()}, tiles {fi.xs.shape[0]}")

    p4 = Params(num_iter=4)
    check_k1(fit_inputs(scans[0][::16], p4, capacity=8192), p4, "num_iter=4")
    fi_crowd = fit_inputs(make_crowded_scan(args.seed), p)
    crowd_tiles = patch_tiles(fi_crowd)[0]
    if crowd_tiles <= fkg.CAP_TILES:
        raise AssertionError(f"crowded patch has {crowd_tiles} tiles, not over {fkg.CAP_TILES}")
    k1_crowd, _ = check_k1(fi_crowd, p, "crowded patch")
    crowd_args = (fi_crowd.xs, fi_crowd.ys, fi_crowd.zs, fi_crowd.valid_f,
                  fi_crowd.tile_patch, fi_crowd.pad_start, fi_crowd.gates, fi_crowd.consts)
    fi_one = fit_inputs(make_one_tile_scan(args.seed), p)
    if patch_tiles(fi_one)[0] != 1:
        raise AssertionError("one-tile cloud has a processed patch of more than one tile")
    k1_one, _ = check_k1(fi_one, p, "one-tile patches")

    def check_k2(fi, k1_out, label):
        """K2 vs its plain version on the card and on the CPU, bit for bit;
        K2 vs K1: the same program with other per-patch sums, so the
        integer columns are equal and the floats differ by ulps."""
        a = (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates,
             fi.consts)
        out = fk.fused_fit(*a, p)
        torch.cuda.synchronize()
        compare_tables(out, fk.fused_fit_reference(*(t.cpu() for t in a), p), p,
                       f"K2 vs plain (cpu), {label}")
        err = compare_tables(out, fk.fused_fit_reference(*a, p), p,
                             f"K2 vs plain (card), {label}")
        return err, compare_tables(out, k1_out, p, f"K2 vs K1 (card), {label}",
                                   exact=False)

    k2_err, k1k2_err = check_k2(fi, k_out, "main scan")
    check_k2(fi_crowd, k1_crowd, "crowded patch")
    check_k2(fi_one, k1_one, "one-tile patches")

    # ---- 4. main paths on the card vs the CPU path
    def drive(fused, frames, want):
        """``frames`` chained frames of engine ``fused`` on the card and
        on the CPU; labels and state must agree. Every launch count is
        set to 0 just before the card's run and read just after; ``want``
        names the kernel that must have launched once a frame (the other
        must not have launched)."""
        gpu = PatchworkPP(p, capacity=CAPACITY, device="cuda", fused=fused)
        fkg.fused_fit_grid.launches = 0
        fk.fused_fit.launches = 0
        res = [gpu.estimate_ground(s) for s in scans[:frames]]
        counts = {"fit_grid": fkg.fused_fit_grid.launches,
                  "fit_onehot": fk.fused_fit.launches}
        for k, n in counts.items():
            expect = frames if k == want else 0
            if n != expect:
                raise AssertionError(f"fused={fused!r}: {k} launched {n} times "
                                     f"in {frames} frames, expected {expect}")
        cpu = PatchworkPP(p, capacity=CAPACITY, device="cpu", fused=fused)
        for i, s in enumerate(scans[:frames]):
            r = cpu.estimate_ground(s)
            g = res[i]
            if not np.array_equal(g.ground_mask, r.ground_mask):
                diff = int((g.ground_mask != r.ground_mask).sum())
                raise AssertionError(f"fused={fused!r} frame {i}: {diff} labels "
                                     "differ card vs cpu")
            if g.ground_mask.shape != (len(s),) or not 0 < g.ground_mask.sum() < len(s):
                raise AssertionError(f"fused={fused!r} frame {i}: implausible labels")
        st_g, st_c = gpu.state.to_numpy(), cpu.state.to_numpy()
        for key in st_c:
            if st_c[key].dtype.kind == "i":
                np.testing.assert_array_equal(st_g[key], st_c[key], err_msg=key)
            else:
                np.testing.assert_allclose(st_g[key], st_c[key], rtol=0,
                                           atol=STATE_ATOL, err_msg=key)
        print(f"fused={fused!r}: {frames} frames, labels equal to the cpu path, "
              f"ground {[int(r.ground_mask.sum()) for r in res[:3]]}..., "
              f"sensor_height {gpu.sensor_height:.6f}, launches {counts}")
        return res, counts

    gpu_res, counts_k1 = drive(None, args.frames, "fit_grid")
    onehot_res, counts_k2 = drive("onehot", args.frames, "fit_onehot")
    launches, launches_k2 = counts_k1["fit_grid"], counts_k2["fit_onehot"]
    unfused_res, _ = drive(False, UNFUSED_FRAMES, None)
    engines = {"tiled": gpu_res, "onehot": onehot_res, "unfused": unfused_res}
    names = list(engines)
    for a in range(len(names)):
        for b in range(a + 1, len(names)):
            ra, rb = engines[names[a]], engines[names[b]]
            n = min(len(ra), len(rb))
            diff = [int((ra[i].ground_mask != rb[i].ground_mask).sum()) for i in range(n)]
            print(f"labels differing {names[a]} vs {names[b]} on the card, "
                  f"frames 0..{n - 1}: {diff}")

    # ---- 4b. the serving surface on the card
    serving = serving_phase(args.seed, scans, fit_inputs, check_k1, here)

    # ---- 4c. references: the parity script, the oracle, eval, native loader
    references = references_phase(here, card)

    # ---- 5. timing
    kernel_ms = cuda_ms(lambda: fkg.fused_fit_grid(*fit_args, p), reps=50)

    # the crowded cloud: a patch over the kernels' shared-memory cap
    crowd_ms = cuda_ms(lambda: fkg.fused_fit_grid(*crowd_args, p), reps=20)
    k2_crowd_ms = cuda_ms(lambda: fk.fused_fit(*crowd_args, p), reps=20)
    plain_ms = cuda_ms(lambda: tiled_fit(*fit_args[:7], fi.consts[0], p), reps=5)
    k2_ms = cuda_ms(lambda: fk.fused_fit(*fit_args, p), reps=50)
    k2_plain_ms = cuda_ms(lambda: fk.fused_fit_reference(*fit_args, p), reps=3, warmup=1)
    xs_dev = []
    for s in scans:
        x = torch.zeros((CAPACITY, 4), device=dev)
        x[: len(s)] = torch.from_numpy(s).to(dev)
        xs_dev.append(x)
    npts = [len(s) for s in scans]

    def frame_times(fn, frames, warmup=3):
        """Per-frame CUDA-event ms over ``frames`` chained frames."""
        st = init_state(p, dev)
        for k in range(min(warmup, len(scans))):
            st, _ = fn(st, xs_dev[k], npts[k])
        out = []
        for k in range(frames):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            st, _ = fn(st, xs_dev[k], npts[k])
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return st, out

    frame = make_frame_fn(p, device=dev)
    state, per_frame = frame_times(frame, len(scans))
    frame_ms = float(np.median(per_frame))
    host_ms = float(np.median([r.time_taken_s for r in gpu_res[1:]]) * 1e3)
    _, per_frame_k2 = frame_times(make_frame_fn(p, device=dev, fused="onehot"), len(scans))
    frame_k2_ms = float(np.median(per_frame_k2))
    _, per_frame_unf = frame_times(make_frame_fn(p, device=dev, fused=False),
                                   min(UNFUSED_FRAMES, len(scans)), warmup=1)
    frame_unf_ms = float(np.median(per_frame_unf))

    npasses, kind = fkg._pass_config(p)[:2]
    rows = 128 * proc_tiles
    # the per-walk unit: one walk over a patch's tiles a pass, two a SEEDFIT
    # pass (the pass program's count; K1 skips gate-shut passes' walks)
    walks = npasses + int((kind == fkg.K_SEEDFIT).sum())
    per_walk_us = kernel_ms * 1e3 / (largest * walks)
    spad, cols = k_out.shape
    nbytes = rows * 16 + 4 * (spad + 1) + 32 * spad + 32 + 4 * spad * cols
    ops = rows * npasses * FIT_OPS_PER_ROW_PASS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"fit kernel {kernel_ms:.4f} ms, plain on card {plain_ms:.3f} ms, "
          f"bound {bound_ms:.5f} ms ({nbytes} B, {ops} ops); largest patch {largest} "
          f"tiles x {walks} walks: {per_walk_us:.5f} us per tile-walk; crowded-patch "
          f"cloud ({crowd_tiles} tiles, staged) {crowd_ms:.4f} ms; frame median "
          f"{frame_ms:.3f} ms (CUDA events), {host_ms:.3f} ms host median incl. copies")
    print(f"K2 {k2_ms:.4f} ms, plain on card {k2_plain_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms, crowded-patch cloud {k2_crowd_ms:.4f} ms; "
          f"onehot frame median {frame_k2_ms:.3f} ms, "
          f"unfused frame median {frame_unf_ms:.3f} ms (CUDA events)")

    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    kernels = {"kernels": [{
        "name": "fit_grid",
        "route": "cuda",
        "source": "patchworkpp_tpu_torch/csrc/fit_grid.cu",
        "replaces": "patchworkpp_tpu/ops/pallas/fit_kernel_grid.py:318",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "per_walk_us": per_walk_us,
    }, {
        "name": "fit_onehot",
        "route": "cuda",
        "source": "patchworkpp_tpu_torch/csrc/fit_onehot.cu",
        "replaces": "patchworkpp_tpu/ops/pallas/fit_kernel.py:422",
        "launches": launches_k2,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    record = {
        "card": card, "build_s": build_s, "frame_ms": frame_ms,
        "host_frame_ms": host_ms, "points": len(scans[0]),
        "tiles": int(fi.xs.shape[0]), "processed_tiles": proc_tiles,
        "largest_patch_tiles": largest, "walks": walks, "frame_ms_each": per_frame,
        "crowded_patch_tiles": crowd_tiles, "crowded_ms": crowd_ms,
        "k2_crowded_ms": k2_crowd_ms,
        "onehot_frame_ms": frame_k2_ms, "onehot_frame_ms_each": per_frame_k2,
        "unfused_frame_ms": frame_unf_ms, "unfused_frame_ms_each": per_frame_unf,
        "k1_k2_max_abs_diff": k1k2_err, "serving": serving,
        "references": references, **kernels,
    }
    if args.profile:
        record["profile"] = {}
        for label, fused, n in (("tiled", None, 5), ("onehot", "onehot", 5),
                                ("unfused", False, UNFUSED_FRAMES)):
            print(f"engine {label}:")
            fn = make_frame_fn(p, device=dev, fused=fused)
            st, _ = fn(init_state(p, dev), xs_dev[0], npts[0])  # warm-up
            record["profile"][label] = profile_frames(
                fn, st, xs_dev, npts, n=min(n, len(scans)))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
