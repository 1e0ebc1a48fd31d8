#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (patchworkpp_tpu_torch).

Phases, in order; any failure raises and exits nonzero before the last line:

1. print the card (nvidia-smi name, power limit) and build the five CUDA
   kernels, K1 from patchworkpp_tpu_torch/csrc/fit_grid.cu, K2 from
   csrc/fit_onehot.cu (both the fit program of csrc/fit_program.cuh, with
   their own per-patch sums), KS, the sharded fit, from
   csrc/fit_sharded.cu (the same program for sharded points: a cluster of
   CTAs a patch across the chunks of one process, or launches cut at the
   cross-shard points), KR, the unfused engine's per-patch sum, from
   csrc/patch_reduce.cu, and KL, every frame's label replay, from
   csrc/label_replay.cu, with one nvcc each started together (build time,
   ptxas reports);
2. make a synthetic KITTI-scale scan from --seed (io/synthetic.py: 64
   beams over 360 deg, a tilted noisy ground plane, walls, boxes, reflected
   noise below ground, points out of range);
3. hold each fit kernel against its plain PyTorch version on the card and
   on the CPU, on that scan's tiled inputs at capacity 131072, on a
   crowded-patch cloud whose largest patch holds more tiles than the kernels
   keep in shared memory (so it is staged chunk by chunk at every walk) and
   on a cloud whose processed patches hold one tile each; K1 also on a
   small cloud with num_iter=4 (K2 refuses it); on each cloud K2's integer
   columns must equal K1's; KR against its plain version on the card and
   on the CPU, bit for bit, on every KR call of an unfused frame of the
   scan and of the crowded-patch cloud (11 calls each, the inputs recorded
   from the frame: 4 ops.patch_reduce calls in the generic mode, 7
   ops.patch_moment_sums calls in the moment mode, whose monomial tables
   the generic mode also sums);
3b. hold KS's two routes against their plain versions on the card: the
   scan and the crowded-patch cloud at capacity 131072 as 2, 4 and 8
   chunks of the in-process transport (parallel/chunked.py), every chunk's
   table bit for bit; the cluster route (the default for such chunks: one
   launch for the chunk group) against tiled_fit(comm=...) and its own
   plain version, launching once a frame, the phase route (forced) against
   tiled_fit(comm=...), launching its stated count (12) a chunk; chunk 0's
   phase launches of the 2-chunk run are recorded and replayed back to
   back (the phase route's kernel time) and through the plain phases
   (which must give the same table); then KS built with PPK_CLUSTER_CHECKS
   (each cluster's CTAs trap unless they hold the same plane and alive
   after every pass) on the scan's 2, 4 and 8 chunks, equal to the release
   build;
4. drive the main paths through PatchworkPP(...).estimate_ground over
   --frames state-chained frames: the default engine (K1) and
   fused="onehot" (K2), each a captured CUDA graph replayed once a frame
   (patchworkpp_tpu_torch/graphs.py; one frame first builds the kernel and
   captures the graph, then the state is reset), with every launch count
   set to 0 just before and read just after; the labels must equal the CPU path's on the same
   frames, each kernel's launch count must equal the frame count on its
   path and be 0 on the other's (KL's, counted by the wrapper and on the
   card, must equal the frame count on every engine), the final adaptive
   state must agree (the
   default engine's thresholds, sensor height and elevation buffer bit for
   bit, and its whole state after frame 6 bit for bit); then
   the unfused engine (fused=False) over the same frames, captured too
   (KR called 11 times a frame, 7 of them in the moment mode, nothing
   else; KR's kernels count their own launches on the card: each call a
   kr_chunk_sums or kr_moment_sums launch and a kr_fold launch), its
   replays equal to its
   eager frames bit for bit (every FrameResult field, the state after each
   frame) and its labels to the CPU unfused engine's; the labels that
   differ between the three engines are printed, not asserted;
4b. the serving surface: for each preset (models/presets.py:
   patchwork_params, R-VPF and TGR off; ros_launch_params, num_min_pts=0)
   K1 bit for bit against its plain version on that preset's tiled inputs,
   and 3 chained facade frames on the card equal to the CPU path's; the
   facade's estimate_ground_sequence of 6 scans equal to the estimate_ground
   loop (labels and state, bit for bit) with one device -> host copy a scan
   (the pipelined readback into page-locked slots), and a
   quarter-density scan bucketed at capacity 131072 equal to capacity 32768;
   the streaming server (serve/server.py) in a closed loop over 20 chained
   scans, each answered within a timeout by a live worker, labels and state
   equal to a facade's, K1 launched 20 times and K2 none (counts set to 0
   just before, after one frame that captures the server's graph), its
   p50/p95 service latency and timing report printed;
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
4d. the multi-device layer (patchworkpp_tpu_torch/parallel/), on
   make_scan(seed, 0..19) chained at capacity 131072: PatchworkPP(chunks=2)
   and chunks=4 captured on the card (KS's cluster route, 1 launch a replay
   for all chunks, K1, K2 and KR none, the plain tiled_fit never called),
   their replays equal to their eager frames bit for bit (every
   FrameResult field, the state after each frame) and to the CPU chunked
   path bit for bit (labels, planes, state), chunks=2's labels equal to the
   card's K1 frame on frames 0..2 (a chunks=1 control launches K1 once a
   frame and nothing else; the differing labels of all 20 printed);
   chunks=16 (KS's phase route, 12 launches a chunk a replay) and chunks=2
   of the unfused engine (KR 7 launches a chunk a replay) captured over 3
   frames, equal to their eager frames; make_chunked_frame_fn and
   make_chunked_sequence_fn (compiled: captured graphs) over the 20 frames
   equal to the facade's eager chunks=2 frames bit for bit; then two gloo
   ranks, both on this card, in their own processes under a timeout: the
   point-sharded frame (eager: gloo gathers through the host) equal to the
   card's chunks=2 frame bit for bit (every FrameResult field and the
   state; KS 12 launches a rank a frame, nothing else) and two
   frame-parallel streams, one per rank, through the rank's captured frame,
   each equal to its own facade, with K1 launched once per replay per rank;
   the 2-rank frame time on the host clock;
4e. the captured frames (graphs.py): over 20 chained frames, captured ==
   eager bit for bit (every FrameResult field and the state after each
   frame) for the facade's tiled and onehot frames, both presets, the
   crowded cloud on both engines, pipeline.segment (also from two threads
   at once, one on a side stream, 10 frames each), and a server whose
   backlog runs as sequence batches (one graph, K1 launched 20 times);
   K1 and K2 counted by name in a torch.profiler trace of 20 replays and
   the launch counters equal to those counts; then eager against captured
   in this one call, each on its own line: the frame median (CUDA
   events), the facade's host ms a frame, the short bench's scans/s and
   the server's closed-loop p50 and p95; the graph's memory pool in MB;
   the captured tiled frame's graph node count and device operations
   (scripts/frame_graph_probe.py, whose frame_ms times every frame of this
   phase) beside its ms a frame; eager against captured ms a frame of the
   chunks=2, chunks=4, chunks=16 and unfused frames, with their graphs'
   node counts and pools, KS's phase route's device ms and launches
   in a chunks=16 replay, and the device busy ms and KR's kernels' device
   ms and launches in an unfused replay (profiler traces); and a 24-frame
   sequence as the
   frame graph replayed 24 times against the whole chain captured as one
   graph (ms a frame);
4f. ops.masked_patch_moments (no engine runs it) on the main scan binned
   into its patches: the card's sums equal the CPU's bit for bit; its ms
   a call on the card and on the host;
5. time the four kernels (also on the crowded-patch cloud), their plain
   versions on the card and the frame of each engine, with CUDA events
   after warm-up (KS: the cluster route on 2, 4 and 8 chunks, the phase
   route as chunk 0's 12 recorded launches replayed, and the fit stage of
   a chunks=2 frame for both routes and tiled_fit(comm); KR's generic
   mode on a recorded moment sum's 10-column table and on an LPR sum, the
   generic mode's one shape on the main path, its moment mode on the same
   moment sum's columns, both also on the crowded cloud, beside their
   plain versions, index_add_ on the table and their byte bounds; KL on the
   replay inputs of a Params() and a ROS 2 launch-profile frame, equal to
   its plain version on the card and on the CPU bit for bit, beside the
   plain version's time, its byte bound and the captured frame's graph
   node count of each profile); print
   K1's time
   per walk of the largest patch over its tiles (kernel ms / (tiles x
   walks)) and the kernels JSON line;
6. print {"ok": true, "device": {...}} as the last line.

With --profile, a torch.profiler window over a few frames of each engine
(tiled, onehot, unfused, eagerly, and the three frames captured)
follows phase 5: host and device time per frame stage (the
eager frames; a replay has no stage ranges), the device's busy share, the
device launches and the host's launch calls a frame, and the kernels that
take the most device time (printed, and kept with the other numbers in
the JSON record the script writes).

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
SERVER_FRAMES = 20
EAGER_UNFUSED_FRAMES = 3  # eager unfused frames timed or profiled (~0.6 s each)
EAGER_UNFUSED_TIMED = 6  # eager unfused frames of phase 4e's timing
# A kernel and its plain version run the same float operations in the same
# order (nvcc's contraction off, the plain version's fused multiply-adds as
# explicit ones), so their tables must agree bit for bit (tolerance 0).
# CPU path vs card path, adaptive state floats: the tiled engine's
# thresholds, sensor height and elevation buffer bit for bit (their sums
# are float32 adds in a fixed order, ops.row_sum; TILED_EXACT_STATE), the
# rest within STATE_ATOL.
STATE_ATOL = 1e-5
TILED_EXACT_STATE = ("sensor_height", "elevation_thr", "flatness_thr", "elev_buf")
# The tiled engine's whole state after this frame (index) of the 64-beam
# chain is held card vs CPU path bit for bit: the frame where the JAX tiled
# engine's flatness first differs from the port's, by the order its unstable
# sort leaves tied rows in (ROADMAP queue 3; the port sorts stably on both
# devices, so the card and the CPU agree)
CHECKED_FRAME = 6


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


def bitwise(a, b) -> bool:
    """Two float tables equal bit for bit (-0.0 and 0.0 differ; NaNs with
    the same bits agree)."""
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


class PhaseRecorder:
    """A sharded fit's phases (ops/sharded_fit.py) that keep each launch's
    inputs, so that one shard's launches can be run again back to back
    (``replay``), without the comm between them: KS's time per shard and
    frame, and its plain phases' on the same inputs."""

    def __init__(self, phases):
        self.phases, self.calls = phases, []

    def seed(self, i, mom):
        self.calls.append(("seed", (i, mom)))
        return self.phases.seed(i, mom)

    def moments(self, i, mom, lpr_sum, cnt):
        self.calls.append(("moments", (i, mom, lpr_sum, cnt)))
        return self.phases.moments(i, mom, lpr_sum, cnt)

    def finish(self, mom):
        self.calls.append(("finish", (mom,)))
        return self.phases.finish(mom)

    def replay(self, phases):
        out = None
        for name, args in self.calls:
            out = getattr(phases, name)(*args)
        return out


def record_patch_reduce(p, cloud, device="cuda") -> list:
    """The inputs of every KR call of one eager unfused frame of ``cloud`` at
    capacity CAPACITY, in call order: ("reduce", (feats, patch_id, start))
    for an ``ops.patch_reduce`` call (the 4 LPR sums of 2 columns at
    default Params) and ("moments", ((qx, qy, qz, mask_f), patch_id,
    start)) for an ``ops.patch_moment_sums`` call (the 7 moment sums)."""
    import torch

    from patchworkpp_tpu_torch import init_state, pipeline

    calls, real, real_mom = [], pipeline.patch_reduce, pipeline.patch_moment_sums

    def recording(feats, patch_id, start):
        calls.append(("reduce", (feats.clone(), patch_id.clone(), start.clone())))
        return real(feats, patch_id, start)

    def recording_mom(qx, qy, qz, mask_f, patch_id, start):
        calls.append(("moments", (tuple(t.clone() for t in (qx, qy, qz, mask_f)),
                                  patch_id.clone(), start.clone())))
        return real_mom(qx, qy, qz, mask_f, patch_id, start)

    dev = torch.device(device)
    x = torch.zeros((CAPACITY, 4), device=dev)
    x[: len(cloud)] = torch.from_numpy(cloud).to(dev)
    pipeline.patch_reduce, pipeline.patch_moment_sums = recording, recording_mom
    try:
        pipeline.make_frame_fn(p, device=dev, fused=False)(init_state(p, dev), x, len(cloud))
    finally:
        pipeline.patch_reduce, pipeline.patch_moment_sums = real, real_mom
    return calls


def kr_table(call):
    """A recorded KR call's (feats, patch_id, start): a moment call's
    monomial table made by ops/moments.py:masked_moment_features_cols."""
    from patchworkpp_tpu_torch.ops.moments import masked_moment_features_cols

    mode, (a, pid, start) = call
    return (masked_moment_features_cols(*a) if mode == "moments" else a), pid, start


def check_kr(calls, label) -> float:
    """KR vs its plain version on the card and on the CPU on each recorded
    call, bit for bit, in the call's mode (a moment call: the moment mode
    against the plain sum of the monomial table, and the generic mode on
    that table); one call counted each (two launches). Returns max |err|
    (0)."""
    import torch

    from patchworkpp_tpu_torch.ops import patch_reduce_kernel as kr
    from patchworkpp_tpu_torch.ops.onehot import patch_reduce_reference

    before, err = kr.patch_reduce_kernel.launches, 0.0
    n_mom = sum(mode == "moments" for mode, _ in calls)
    # the last call's table 4 times over (40 columns): the generic mode in
    # two calls, of 32 and 8 columns
    wide = kr_table(calls[-1])
    wide = (torch.cat([wide[0]] * 4, dim=1), *wide[1:])
    for i, call in enumerate([*calls, ("reduce", wide)]):
        feats, pid, start = kr_table(call)
        outs = {"generic": kr.patch_reduce_kernel(feats, start)}
        if call[0] == "moments":
            outs["moment mode"] = kr.patch_moment_sums_kernel(*call[1][0], start)
        torch.cuda.synchronize()
        refs = (("card", patch_reduce_reference(feats, pid, start)),
                ("cpu", patch_reduce_reference(feats.cpu(), pid.cpu(), start.cpu())))
        for mode, out in outs.items():
            for where, ref in refs:
                if not bitwise(out.cpu(), ref.cpu()):
                    raise AssertionError(
                        f"KR {mode} vs plain ({where}), {label} call {i}: not bit for bit, "
                        f"max |err| {float((out.cpu() - ref.cpu()).abs().max())}")
                err = max(err, float((out.cpu() - ref.cpu()).abs().max()))
    if kr.patch_reduce_kernel.launches != before + len(calls) + n_mom + 2:
        raise AssertionError(f"KR {label}: {kr.patch_reduce_kernel.launches - before} calls "
                             f"for {len(calls) + n_mom + 2}")
    counts = np.diff(calls[0][1][2].cpu().numpy())
    widths = sorted({c[1][0].shape[1] for c in calls if c[0] == "reduce"})
    print(f"KR vs plain (card and cpu), {label}: {len(calls)} calls of one unfused frame "
          f"({len(calls) - n_mom} generic of {widths} columns, {n_mom} moment-mode calls "
          f"also summed by the generic mode, and the last one's table 4 times over, 40 "
          f"columns in two calls; "
          f"{len(counts)} patches, largest {int(counts.max())} rows, "
          f"{int((counts == 0).sum())} empty) bit for bit, max_abs_err {err}")
    return err


def _bound(nbytes: int, ops: int) -> dict:
    """The least time for ``nbytes`` moved and ``ops`` f32 operations on the
    H100, and which of the two sets it."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kr_timing(main_calls, crowd_calls) -> dict:
    """KR on the card (CUDA events, cuda_ms): the generic mode on the first
    moment sum of the main scan's unfused frame as a 10-column table
    (kr_table; the shape timed before the moment mode, no longer a
    main-path input of the generic mode) and on the crowded cloud's, and on the first LPR sum (2
    columns, the generic mode's one shape on the main path); the moment mode
    on the same moment sums' columns; each mode's plain version, and
    index_add_ (one PyTorch call, atomics in no fixed order) on the table.
    Bounds from these inputs: every input read once, the sums written once;
    the generic mode one add a feature, the moment mode 9 multiplies and 10
    adds a row."""
    import torch

    from patchworkpp_tpu_torch.ops import patch_reduce_kernel as kr
    from patchworkpp_tpu_torch.ops.moments import masked_moment_features_cols
    from patchworkpp_tpu_torch.ops.onehot import patch_reduce_reference

    main = next(c for c in main_calls if c[0] == "moments")
    crowd = next(c for c in crowd_calls if c[0] == "moments")
    feats, pid, start = kr_table(main)
    c_feats, c_pid, c_start = kr_table(crowd)
    l_feats, _, l_start = kr_table(next(c for c in main_calls if c[0] == "reduce"))
    s, c = start.shape[0] - 1, feats.shape[1]
    acc = torch.zeros((s, c), device=feats.device)
    pid64, c_pid64 = pid.to(torch.int64), c_pid.to(torch.int64)
    cols, c_cols = main[1][0], crowd[1][0]
    p = cols[0].numel()
    lpr = _bound(4 * (l_feats.numel() + l_start.numel() + s * l_feats.shape[1]), l_feats.numel())
    return {"generic": {
        "rows": feats.shape[0], "cols": c, "patches": s,
        "ms": cuda_ms(lambda: kr.patch_reduce_kernel(feats, start), reps=50),
        "plain_ms": cuda_ms(lambda: patch_reduce_reference(feats, pid, start), reps=3,
                            warmup=1),
        "library_ms": cuda_ms(lambda: acc.index_add_(0, pid64, feats), reps=50),
        "crowded_ms": cuda_ms(lambda: kr.patch_reduce_kernel(c_feats, c_start), reps=50),
        "crowded_plain_ms": cuda_ms(lambda: patch_reduce_reference(c_feats, c_pid, c_start),
                                    reps=3, warmup=1),
        "crowded_library_ms": cuda_ms(lambda: acc.index_add_(0, c_pid64, c_feats), reps=50),
        "lpr_ms": cuda_ms(lambda: kr.patch_reduce_kernel(l_feats, l_start), reps=50),
        "lpr_cols": l_feats.shape[1], "lpr_bytes": lpr["bytes"],
        "lpr_bound_ms": lpr["bound_ms"], "lpr_bound_by": lpr["bound_by"],
        **_bound(4 * (feats.numel() + start.numel() + s * c), feats.numel())},
        "moments": {
        "ms": cuda_ms(lambda: kr.patch_moment_sums_kernel(*cols, start), reps=50),
        "plain_ms": cuda_ms(lambda: patch_reduce_reference(
            masked_moment_features_cols(*cols), pid, start), reps=3, warmup=1),
        "crowded_ms": cuda_ms(lambda: kr.patch_moment_sums_kernel(*c_cols, c_start), reps=50),
        "crowded_plain_ms": cuda_ms(lambda: patch_reduce_reference(
            masked_moment_features_cols(*c_cols), c_pid, c_start), reps=3, warmup=1),
        **_bound(4 * (4 * p + start.numel() + s * c), 19 * p)}}


def print_kr_timing(t, card) -> None:
    g, m = t["generic"], t["moments"]
    print(f"KR generic mode {g['ms']:.4f} ms a call ({g['rows']} rows x {g['cols']} columns, "
          f"{g['patches']} patches), plain on the card {g['plain_ms']:.3f} ms, index_add_ "
          f"{g['library_ms']:.4f} ms, bound {g['bound_ms']:.5f} ms ({g['bytes']} B), "
          f"crowded-patch cloud {g['crowded_ms']:.4f} ms (plain {g['crowded_plain_ms']:.3f}, "
          f"index_add_ {g['crowded_library_ms']:.4f}); an LPR sum ({g['lpr_cols']} columns, "
          f"the generic mode's main-path shape) {g['lpr_ms']:.4f} ms, bound "
          f"{g['lpr_bound_ms']:.5f} ms ({g['lpr_bytes']} B); {card}")
    print(f"KR moment mode {m['ms']:.4f} ms a call (the same sum from qx, qy, qz, mask), "
          f"plain on the card {m['plain_ms']:.3f} ms, bound {m['bound_ms']:.5f} ms "
          f"({m['bytes']} B), crowded-patch cloud {m['crowded_ms']:.4f} ms (plain "
          f"{m['crowded_plain_ms']:.3f}); {card}")


KR_KERNELS = ("kr_chunk_sums", "kr_moment_sums", "kr_fold")


def kr_launches(events) -> dict:
    """KR's kernels in a profiler trace (utils/roofline.py:trace), by
    name: each kernel's launches and device ms, and each mode's launches
    (generic: kr_chunk_sums and the kr_fold after each; moment mode:
    kr_moment_sums and its kr_fold). Raises unless every fold follows a
    chunk launch of its call."""
    mine = sorted((e for e in events if e.on_device and not e.annotation
                   and any(n in e.name for n in KR_KERNELS)), key=lambda e: e.start_us)
    out = {n: {"launches": 0, "ms": 0.0} for n in KR_KERNELS}
    mode = {"generic": {"kr_chunk_sums": 0, "kr_fold": 0},
            "moments": {"kr_moment_sums": 0, "kr_fold": 0}}
    last = None
    for e in mine:
        n = next(n for n in KR_KERNELS if n in e.name)
        out[n]["launches"] += 1
        out[n]["ms"] += e.dur_us / 1e3
        if n == "kr_fold":
            if last is None:
                raise AssertionError("KR trace: a kr_fold with no chunk launch before it")
            mode[last][n] += 1
            last = None
        else:
            if last is not None:
                raise AssertionError(f"KR trace: {n} follows a chunk launch with no kr_fold")
            last = "generic" if n == "kr_chunk_sums" else "moments"
            mode[last][n] += 1
    if last is not None:
        raise AssertionError("KR trace: the last chunk launch has no kr_fold")
    return {"by_kernel": out, "by_mode": mode}


def sharded_fit_phase(p, cloud, label, device="cuda") -> dict:
    """Phase 3b: KS (ops/sharded_fit.py) against its plain versions on the
    card: ``cloud`` at capacity 131072 as 2, 4 and 8 chunks of the
    in-process transport. The cluster route (the default there: one launch
    for all the chunks) must equal ``tiled_fit(comm=...)`` and its plain
    version (``sharded_fit_reference`` over the same chunk comm) bit for bit,
    in one launch a frame; the phase route (forced) must equal ``tiled_fit(comm=...)``, in
    its stated count a chunk. Returns chunk 0's recorded phase launches at 2
    chunks, each chunk count's fit inputs (for the timing) and the checks'
    numbers."""
    import torch

    from patchworkpp_tpu_torch.ops import sharded_fit as sf
    from patchworkpp_tpu_torch.ops.tiled_fit import FitProgram, tiled_fit
    from patchworkpp_tpu_torch.parallel.chunked import _chunk_fit_tables

    dev = torch.device(device)
    x = torch.zeros((CAPACITY, 4), device=dev)
    x[: len(cloud)] = torch.from_numpy(cloud).to(dev)
    per_chunk = sf.launches_per_frame(p)

    def args(fi):
        return (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates,
                fi.consts)

    def cluster(fi, comm):  # the route sharded_fit takes for these chunks
        return sf.sharded_fit(*args(fi), p, comm)

    def phases(fi, comm):  # the route of shards in other processes, here forced
        return sf._drive(sf._Kernel(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start, fi.gates,
                                    fi.consts, p), p, comm)

    def plain(fi, comm):
        return tiled_fit(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
                         fi.gates, fi.consts[0], p, comm=comm)

    def cluster_plain(fi, comm):
        return sf.sharded_fit_reference(*args(fi), p, comm)

    def recorded(fi, comm):
        rec = PhaseRecorder(sf._Kernel(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start,
                                       fi.gates, fi.consts, p))
        return fi, rec, sf._drive(rec, p, comm).clone()

    def counted(fits, k):
        before = sf.sharded_fit.launches
        tables = _chunk_fit_tables(p, k, x, len(cloud), fits, device=dev)
        torch.cuda.synchronize()
        return tables, sf.sharded_fit.launches - before

    out = {"launches_per_chunk": per_chunk, "cluster_inputs": {}}
    max_err = 0.0
    for k in (2, 4, 8):
        tables, launched = counted([cluster, plain, cluster_plain,
                                    lambda fi, comm: args(fi)], k)
        if launched != 1:
            raise AssertionError(f"KS cluster {label} chunks={k}: {launched} launches, "
                                 "expected 1 for the chunk group")
        phase_tables, launched = counted([phases], k)
        if launched != k * per_chunk:
            raise AssertionError(f"KS phases {label} chunks={k}: {launched} launches, "
                                 f"expected {k} x {per_chunk}")
        for c, ((got, want, want_cl, _), (ph,)) in enumerate(zip(tables, phase_tables)):
            for a, b, what in ((got, want, "cluster vs tiled_fit(comm)"),
                               (got, want_cl, "cluster vs its plain version"),
                               (ph, want, "phases vs tiled_fit(comm)")):
                max_err = max(max_err, compare_tables(
                    a, b, p, f"KS {what} (card), {label}, chunks={k}, chunk {c}"))
                if not bitwise(a, b):
                    raise AssertionError(f"KS {what} {label} chunks={k} chunk {c}: "
                                         "not bit for bit")
        out["cluster_inputs"][k] = [t[3] for t in tables]
    out["max_abs_err"] = max_err
    fi, rec, table = _chunk_fit_tables(p, 2, x, len(cloud), [recorded], device=dev)[0][0]
    if not bitwise(rec.replay(sf._Kernel(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start,
                                         fi.gates, fi.consts, p)), table):
        raise AssertionError(f"KS {label}: the replayed launches differ from the run")
    plain_again = rec.replay(sf._Reference(FitProgram(
        fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates,
        fi.consts[0], p)))
    if not bitwise(plain_again, table):
        raise AssertionError(f"KS {label}: the plain phases on the recorded inputs differ")
    rows = []
    for chunk in out["cluster_inputs"][2]:
        tiles = ((chunk[5][1:] - chunk[5][:-1]) // 128)[chunk[6][:, 0] > 0.5]
        rows.append((int(tiles.sum()), int(tiles.max())))
    out.update(chunk0_processed_tiles=rows[0][0], chunk0_largest_tiles=rows[0][1],
               processed_tiles_2=sum(r[0] for r in rows),
               largest_tiles_2=max(r[1] for r in rows))
    print(f"KS {label}: chunks=2, 4 and 8: the cluster route == tiled_fit(comm) and its "
          f"plain version on the card bit for bit in 1 launch a frame, the phase route == "
          f"tiled_fit(comm) in {per_chunk} launches a chunk; chunks=2: "
          f"{out['processed_tiles_2']} processed tiles, largest patch in a chunk "
          f"{out['largest_tiles_2']}")
    return {"record": (fi, rec), **out}


def cluster_checks_phase(p, cluster_inputs, label) -> None:
    """Phase 3b's debug build: KS built with PPK_CLUSTER_CHECKS, whose
    cluster kernel traps unless every CTA of a cluster holds rank 0's plane
    and alive after every pass (the decisions that every CTA must share to
    reach every cluster barrier), run on each chunk count's inputs; its
    tables must equal the release build's bit for bit."""
    import ctypes
    import hashlib

    import torch

    from patchworkpp_tpu_torch.ops import nvcc
    from patchworkpp_tpu_torch.ops import sharded_fit as sf

    digest = hashlib.sha256(b"".join(f.read_bytes() for f in sorted(
        sf.SOURCE.parent.glob("fit_*.cu*")))).hexdigest()[:12]
    nvcc.BUILD_DIR.mkdir(exist_ok=True)
    wrapper = nvcc.BUILD_DIR / f"fit_sharded_checks_{digest}.cu"
    wrapper.write_text(f'// KS with its cluster checks, sources {digest}\n'
                       f'#define PPK_CLUSTER_CHECKS\n#include "{sf.SOURCE}"\n')
    lib = nvcc.build(wrapper, "ppk_fit_sharded", sf.ARGTYPES)
    lib.ppk_fit_sharded_cluster.argtypes = list(sf.CLUSTER_ARGTYPES)
    lib.ppk_fit_sharded_cluster.restype = ctypes.c_int
    release = sf.build
    for k, chunks in cluster_inputs.items():
        want = sf.cluster_fit(chunks, p)
        sf.build = lambda: lib
        try:
            got = sf.cluster_fit(chunks, p)
            torch.cuda.synchronize()
        finally:
            sf.build = release
        for c, (a, b) in enumerate(zip(got, want)):
            if not bitwise(a, b):
                raise AssertionError(f"KS cluster checks build {label} chunks={k} chunk {c}: "
                                     "differs from the release build")
    print(f"KS cluster checks build, {label}: chunks={sorted(cluster_inputs)} uniform over "
          "every cluster (no trap), tables == the release build's")


def sharded_stage_ms(p, cloud, fit, reps, device="cuda") -> float:
    """The fit stage of a chunks=2 frame on CUDA events: from chunk 0's
    second call of ``fit(fit_inputs, comm)`` to the end of chunk 1's last,
    per call (the chunks' launches and the comm's steps between them, at
    the host's pace)."""
    import torch

    from patchworkpp_tpu_torch.parallel.chunked import _chunk_fit_tables

    dev = torch.device(device)
    x = torch.zeros((CAPACITY, 4), device=dev)
    x[: len(cloud)] = torch.from_numpy(cloud).to(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fi, comm):
        i = comm.transport.index
        for r in range(reps + 1):
            if r == 1 and i == 0:
                a.record()
            fit(fi, comm)
        if i == 1:
            b.record()

    _chunk_fit_tables(p, 2, x, len(cloud), [timed], device=dev)
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
    # copy a scan; the bucketed upload == a tight capacity
    seq_m = PatchworkPP(capacity=CAPACITY, device=device)
    loop_m = PatchworkPP(capacity=CAPACITY, device=device)
    seq_m.estimate_ground_sequence(chain[:1])  # captures the frame, outside the trace
    seq_m.reset()
    seq_res = []
    events, _ = trace(lambda: seq_res.extend(seq_m.estimate_ground_sequence(chain[:6])))
    dtoh = sum(1 for e in events if e.on_device and "DtoH" in e.name)
    loop_res = [loop_m.estimate_ground(s) for s in chain[:6]]
    _equal_labels(seq_res, loop_res, "estimate_ground_sequence vs estimate_ground")
    _equal_states(seq_m.state, loop_m.state, "estimate_ground_sequence vs estimate_ground")
    if dtoh != 6 * (device == "cuda"):  # one copy a scan on the card (none on the CPU)
        raise AssertionError(f"estimate_ground_sequence of 6 scans made {dtoh} "
                             "device->host copies, expected 6")
    sparse = make_scan(seed)[::4]
    wide = PatchworkPP(capacity=CAPACITY, device=device).estimate_ground(sparse)
    tight = PatchworkPP(capacity=32768, device=device).estimate_ground(sparse)
    _equal_labels([wide], [tight], f"{len(sparse)} points at capacity {CAPACITY} vs 32768")
    print(f"facade: sequence of 6 == frame loop (labels, state), {dtoh} device->host "
          f"copies; {len(sparse)}-point scan bucketed at {CAPACITY} == capacity 32768")

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

    if device == "cuda":  # builds the kernel and captures the frame, uncounted
        srv.process(CloudMsg(points=chain[0], stamp=0.0))
        srv._model.reset()
    fkg.fused_fit_grid.launches = 0
    fk.fused_fit.launches = 0
    with srv:
        for i, s in enumerate(chain[:SERVER_FRAMES]):
            answered.clear()
            srv.publish(CloudMsg(points=s, stamp=time.perf_counter()))
            wait_answer(srv, f"closed loop message {i}")
    counts = {"fit_grid": fkg.fused_fit_grid.launches, "fit_onehot": fk.fused_fit.launches}
    if device == "cuda":
        _all_captured(srv._model, "server")
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
            and line["value"] > 0 and line["captured"] == (device == "cuda")):
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
    from patchworkpp_tpu_torch.graphs import WARMUP_FRAMES
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
            model = PatchworkPP(capacity=CAPACITY, device=device, fused=fused)
            model.estimate_ground(scans[0])  # captures the frame (configs resets)
            fkg.fused_fit_grid.launches = 0
            fk.fused_fit.launches = 0
            card_masks[label] = configs(model)
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
        # each of the two runs captures one frame, after WARMUP_FRAMES eager ones
        if fkg.fused_fit_grid.launches != per_frame * (12 + 2 * WARMUP_FRAMES):
            raise AssertionError(f"eval: fit_grid launched {fkg.fused_fit_grid.launches} "
                                 f"times in 12 frames and 2 captures")

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


MULTI_FRAMES = 3
MULTI_TIMEOUT = 300.0
CHUNK_FRAMES = 20  # chained frames of each captured chunks=2 and 4 facade
PHASE_ROUTE_CHUNKS = 16  # over KS's cluster size: its phase route, captured
PHASE_ROUTE_FRAMES = 3


def _multi_device_rank(rank: int, nprocs: int, cfg: dict) -> None:
    """One rank of phase 4d, on cuda:0 (gloo gathers through the host):
    the point-sharded frame over ``MULTI_FRAMES`` chained scans, then two
    frame-parallel streams (stream b: make_scan(seed + b, f)) through the
    captured frame (a first call captures it), each with the launch counts
    set to 0 just before and read just after. Writes ``rank<r>.npz``."""
    import torch

    from patchworkpp_tpu_torch import Params, init_state
    from patchworkpp_tpu_torch.io.synthetic import make_scan
    from patchworkpp_tpu_torch.ops import fit_kernel as fk
    from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg
    from patchworkpp_tpu_torch.ops import sharded_fit as sf
    from patchworkpp_tpu_torch.ops import tiled_fit as tf
    from patchworkpp_tpu_torch.parallel import (
        batch_init_state,
        make_batch_frame_fn,
        make_point_sharded_frame_fn,
    )

    def zero_counts():
        fkg.fused_fit_grid.launches = fk.fused_fit.launches = 0
        sf.sharded_fit.launches = tf.tiled_fit.calls = 0

    def counts():  # K1, K2 and KS launches, plain sharded fit calls
        return np.array([fkg.fused_fit_grid.launches, fk.fused_fit.launches,
                         sf.sharded_fit.launches, tf.tiled_fit.calls])

    dev = torch.device(cfg["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    p = Params()
    out = {}

    def upload(cloud):
        x = torch.zeros((CAPACITY, 4), device=dev)
        x[: len(cloud)] = torch.from_numpy(cloud).to(dev)
        return x, len(cloud)

    scans = [[upload(make_scan(cfg["seed"] + b, f)) for f in range(MULTI_FRAMES)]
             for b in range(nprocs)]
    frame = make_point_sharded_frame_fn(p, device=dev)
    frame(init_state(p, dev), *scans[0][0])  # warm-up
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    zero_counts()
    st = init_state(p, dev)
    host_ms = []
    for f, (x, n) in enumerate(scans[0]):
        t0 = time.perf_counter()
        st, res = frame(st, x, n)
        sync()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        out.update({f"ps{f}_{k}": getattr(res, k).cpu().numpy() for k in res._fields})
    out.update({f"ps_state_{k}": v for k, v in st.to_numpy().items()})
    out["ps_launches"] = counts()
    out["ps_host_ms"] = np.array(host_ms)

    batch = make_batch_frame_fn(p, device=dev)
    first = torch.stack([scans[b][0][0] for b in range(nprocs)])
    batch(batch_init_state(p, nprocs, dev), first, [scans[b][0][1] for b in range(nprocs)])
    sync()  # the first call captured the frame; the counts follow the replays
    out["fp_captured"] = np.array(batch.compiled.is_captured)
    states = batch_init_state(p, nprocs, dev)
    zero_counts()
    for f in range(MULTI_FRAMES):
        states, res = batch(states, torch.stack([scans[b][f][0] for b in range(nprocs)]),
                            [scans[b][f][1] for b in range(nprocs)])
        for b in range(nprocs):
            out[f"fp{f}_{b}_ground_mask"] = res.ground_mask[b].cpu().numpy()
    out.update({f"fp_state_{k}": v for k, v in states.to_numpy().items()})
    out["fp_launches"] = counts()
    np.savez(os.path.join(cfg["out"], f"rank{rank}.npz"), **out)


def multi_device_phase(seed, device="cuda") -> dict:
    """Phase 4d: the multi-device layer on ``device``, on make_scan(seed,
    0..CHUNK_FRAMES-1) chained at capacity 131072. Raises on any failure."""
    import tempfile

    import torch

    from patchworkpp_tpu_torch import Params, PatchworkPP, init_state
    from patchworkpp_tpu_torch.graphs import CompiledSequence
    from patchworkpp_tpu_torch.io.synthetic import make_scan
    from patchworkpp_tpu_torch.ops import fit_kernel as fk
    from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg
    from patchworkpp_tpu_torch.ops import patch_reduce_kernel as kr
    from patchworkpp_tpu_torch.ops import sharded_fit as sf
    from patchworkpp_tpu_torch.ops import tiled_fit as tf
    from patchworkpp_tpu_torch.parallel import make_chunked_frame_fn, make_chunked_sequence_fn
    from patchworkpp_tpu_torch.parallel.selfcheck import spawn

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    per_frame = int(on_card)  # the CPU runs the plain fit
    p = Params()
    ks = per_frame * sf.launches_per_frame(p)  # KS's phase launches a rank a frame
    scans = [make_scan(seed, f) for f in range(CHUNK_FRAMES)]
    out = {}

    def zero_counts():
        fkg.fused_fit_grid.launches = fk.fused_fit.launches = 0
        sf.sharded_fit.launches = tf.tiled_fit.calls = kr.patch_reduce_kernel.launches = 0
        kr.patch_moment_sums_kernel.launches = 0

    def counts():
        return {"fit_grid": fkg.fused_fit_grid.launches, "fit_onehot": fk.fused_fit.launches,
                "fit_sharded": sf.sharded_fit.launches, "tiled_fit_calls": tf.tiled_fit.calls,
                "patch_reduce": kr.patch_reduce_kernel.launches,
                "patch_moments": kr.patch_moment_sums_kernel.launches}

    def run(model, chain):
        return [model.estimate_ground(s) for s in chain], model.state.to_numpy()

    def same(a, b, label):
        (ra, sa), (rb, sb) = a, b
        for i, (x, y) in enumerate(zip(ra, rb)):
            for f in ("ground_mask", "centers", "normals"):
                # a one-point fit's normal is NaN on both sides
                if not np.array_equal(getattr(x, f), getattr(y, f), equal_nan=True):
                    raise AssertionError(f"{label} frame {i}: {f} differ")
        for k in sa:
            if not np.array_equal(sa[k], sb[k]):
                raise AssertionError(f"{label}: state {k} differs")

    def captured_run(label, frames, want, **kw):
        """PatchworkPP(**kw) over ``frames`` chained scans, its frame
        captured (one frame first captures it, then the state is reset;
        every count set to 0 just before the run and read just after, and
        equal to ``want``); each frame, every FrameResult field and the
        state after it, == an eager facade's bit for bit. Returns (the
        results and final state, [(FrameResult, state)] a frame, the graph
        pool's bytes)."""
        model = PatchworkPP(p, capacity=CAPACITY, device=dev, **kw)
        model.estimate_ground(scans[0])  # builds the kernels, captures the frame
        model.reset()
        zero_counts()
        res, kept = [], []
        for s in scans[:frames]:
            res.append(model.estimate_ground(s))
            kept.append((model.last_result, model.state))
        got = counts()
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        cfs = _all_captured(model, label) if on_card else list(model._frames.values())
        eager = PatchworkPP(p, capacity=CAPACITY, device=dev, **kw)
        for i, s in enumerate(scans[:frames]):
            eager._estimate(s, captured=False)
            _same_frame(kept[i], (eager.last_result, eager._state),
                        f"{label} frame {i}, captured vs eager")
        print(f"{label} on the card, captured: {frames} chained frames == eager frames bit "
              f"for bit (every field, the state after each); launches {got}")
        return (res, model.state.to_numpy()), kept, cfs[0].pool_bytes, got

    def want(fit_sharded=0, patch_reduce=0, calls=0):
        # a chunked frame's KR calls are all moment sums (its LPR sums are
        # the comm's table merge), in KR's moment mode
        return {"fit_grid": 0, "fit_onehot": 0, "fit_sharded": fit_sharded,
                "tiled_fit_calls": calls, "patch_reduce": patch_reduce,
                "patch_moments": patch_reduce}

    # a. the facade, chunks=2 and 4, captured on the card: KS's cluster route
    # launches once a replay for all chunks, K1, K2 and KR none, the plain
    # sharded fit is never called; == its eager frames bit for bit, == the CPU
    # chunked path bit for bit; chunks=2's labels == the card's K1 frame on
    # the first MULTI_FRAMES frames (a chunks=1 control launches K1 once a
    # frame and nothing else), the differing labels of the whole chain printed
    n = CHUNK_FRAMES
    chunked, kept = {}, {}
    out["chunked_launches"], out["chunked_pool_mb"] = {}, {}
    for k in (2, 4):
        calls = 0 if on_card else k * n  # the CPU runs the plain sharded fit
        chunked[k], kept[k], pool, got = captured_run(
            f"chunks={k}", n, want(fit_sharded=per_frame * n, calls=calls), chunks=k)
        out["chunked_launches"][k] = got
        out["chunked_pool_mb"][k] = pool / 2**20
        t0 = time.perf_counter()
        same(chunked[k], run(PatchworkPP(p, capacity=CAPACITY, device="cpu", chunks=k), scans),
             f"chunks={k} card vs cpu")
        print(f"chunks={k}: {n} frames == the cpu chunked path bit for bit (labels, planes, "
              f"state; cpu {time.perf_counter() - t0:.1f} s)")
    control = PatchworkPP(p, capacity=CAPACITY, device=dev)
    control.estimate_ground(scans[0])  # captures the frame
    control.reset()
    zero_counts()
    plain = run(control, scans)
    out["control_launches"] = counts()
    if out["control_launches"] != {**want(calls=(1 - per_frame) * n), "fit_grid": per_frame * n}:
        raise AssertionError(f"chunks=1 control: launches {out['control_launches']}")
    diff = [int((a.ground_mask != b.ground_mask).sum())
            for a, b in zip(chunked[2][0], plain[0])]
    if any(diff[:MULTI_FRAMES]):
        raise AssertionError(f"chunks=2 vs K1, frames 0..{MULTI_FRAMES - 1}: labels differ "
                             f"{diff[:MULTI_FRAMES]}")
    out["chunks2_vs_k1_labels_differing"] = diff
    print(f"chunks=2 labels == the K1 frame's on frames 0..{MULTI_FRAMES - 1}; differing "
          f"labels a frame over {n}: {diff}; control launches {out['control_launches']}")

    # the phase route (more than 8 chunks) captured: 12 KS launches a chunk a
    # replay; the unfused engine chunked: KR 7 launches a chunk a replay (its
    # LPR sums are the comm's table merge)
    pr = PHASE_ROUTE_CHUNKS
    _, _, pool, out["phase_route_launches"] = captured_run(
        f"chunks={pr} (KS's phase route)", PHASE_ROUTE_FRAMES,
        want(fit_sharded=ks * pr * PHASE_ROUTE_FRAMES,
             calls=0 if on_card else pr * PHASE_ROUTE_FRAMES),
        chunks=pr)
    out["phase_route_pool_mb"] = pool / 2**20
    n_mom = 2 * p.num_iter + 1 if p.enable_RVPF else p.num_iter + 1  # moment sums a frame
    out["chunked_unfused_launches"] = captured_run(
        "chunks=2, unfused", PHASE_ROUTE_FRAMES,
        want(patch_reduce=per_frame * 2 * n_mom * PHASE_ROUTE_FRAMES),
        chunks=2, fused=False)[3]

    # b. make_chunked_frame_fn and make_chunked_sequence_fn (compiled on the
    # card, KS once a replay) == the eager frames of a, bit for bit
    fn = make_chunked_frame_fn(p, 2, device=dev)
    seq = make_chunked_sequence_fn(p, 2, device=dev)
    if on_card and not isinstance(seq, CompiledSequence):
        raise AssertionError(f"make_chunked_sequence_fn gave {type(seq).__name__}")
    xs = []
    for s in scans:
        x = torch.zeros((CAPACITY, 4), device=dev)
        x[: len(s)] = torch.from_numpy(s).to(dev)
        xs.append(x)
    fn(init_state(p, dev), xs[0], len(scans[0]))  # captures
    seq(init_state(p, dev), torch.stack(xs[:2]), [len(s) for s in scans[:2]])  # captures
    zero_counts()
    st, ref = init_state(p, dev), []
    for i, (x, s) in enumerate(zip(xs, scans)):
        st, res = fn(st, x, len(s))
        _same_frame((res, st), kept[2][i], f"make_chunked_frame_fn frame {i}")
        ref.append(res)
    st_seq, res_seq = seq(init_state(p, dev), torch.stack(xs), [len(s) for s in scans])
    for i in range(n):
        for name, f in zip(res_seq._fields, res_seq):
            if not _same_bits(f[i], getattr(kept[2][i][0], name)):
                raise AssertionError(f"make_chunked_sequence_fn frame {i}: {name} differs")
    _same_frame((ref[-1], st_seq), kept[2][-1], "make_chunked_sequence_fn, the state")
    got = counts()
    if got != want(fit_sharded=2 * per_frame * n, calls=0 if on_card else 4 * n):
        raise AssertionError(f"compiled chunked frame and sequence: launches {got}")
    if on_card and not (fn.is_captured and seq.is_captured):
        raise AssertionError("make_chunked_frame_fn / make_chunked_sequence_fn not captured")
    print(f"make_chunked_frame_fn and make_chunked_sequence_fn (chunks=2), captured: {n} "
          f"frames each == the eager frames bit for bit; launches {got}")

    # c. two gloo ranks, both on this card, in their own processes
    with tempfile.TemporaryDirectory(prefix="ppk_multi_") as tmp:
        t0 = time.perf_counter()
        spawn(_multi_device_rank, 2, ({"seed": seed, "out": tmp, "device": str(dev)},),
              timeout=MULTI_TIMEOUT)
        out["two_rank_wall_s"] = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(2)]
    for r, got in enumerate(ranks):
        for f, res in enumerate(ref[:MULTI_FRAMES]):
            for k in res._fields:
                if not np.array_equal(got[f"ps{f}_{k}"], getattr(res, k).cpu().numpy()):
                    raise AssertionError(f"rank {r} point-sharded frame {f}: {k} differs "
                                         "from the card's chunks=2 frame")
        for k, v in kept[2][MULTI_FRAMES - 1][1].to_numpy().items():
            if not np.array_equal(got[f"ps_state_{k}"], v):
                raise AssertionError(f"rank {r} point-sharded: state {k} differs")
        cpu_calls = (1 - per_frame) * MULTI_FRAMES  # the CPU runs the plain fit
        if got["ps_launches"].tolist() != [0, 0, ks * MULTI_FRAMES, cpu_calls]:
            raise AssertionError(f"rank {r}: point-sharded launches (K1, K2, KS, plain "
                                 f"calls) {got['ps_launches']}, expected KS "
                                 f"{ks * MULTI_FRAMES} and no other")
        if got["fp_launches"].tolist() != [per_frame * MULTI_FRAMES, 0, 0, cpu_calls]:
            raise AssertionError(f"rank {r}: frame-parallel launches {got['fp_launches']}, "
                                 f"expected K1 {MULTI_FRAMES} (once a replay) and no other")
        if on_card and not got["fp_captured"]:
            raise AssertionError(f"rank {r}: the frame-parallel frame is not captured")
    # frame-parallel stream b (make_scan(seed + b, f)) == its own facade
    facades = [run(PatchworkPP(p, capacity=CAPACITY, device=dev),
                   [make_scan(seed + b, f) for f in range(MULTI_FRAMES)]) for b in range(2)]
    for b, (results, state) in enumerate(facades):
        for f, r in enumerate(results):
            got = ranks[0][f"fp{f}_{b}_ground_mask"][: len(r.ground_mask)]
            if not np.array_equal(got, r.ground_mask):
                raise AssertionError(f"frame-parallel stream {b} frame {f}: labels differ "
                                     "from its facade")
        for k, v in state.items():
            if not np.array_equal(ranks[0][f"fp_state_{k}"][b], v):
                raise AssertionError(f"frame-parallel stream {b}: state {k} differs")
    out["two_rank_frame_ms_each"] = ranks[0]["ps_host_ms"].tolist()
    out["two_rank_launches"] = ranks[0]["ps_launches"].tolist()
    out["two_rank_frame_ms"] = float(np.median(out["two_rank_frame_ms_each"]))
    print(f"2 gloo ranks on the card: point-sharded == chunks=2 bit for bit "
          f"({MULTI_FRAMES} frames, every field and the state), KS {ks * MULTI_FRAMES} "
          f"launches a rank, K1 and K2 0, plain sharded fit 0 calls; frame-parallel, 2 "
          f"streams, captured, == their facades, K1 {per_frame * MULTI_FRAMES} a rank in "
          f"{MULTI_FRAMES} replays")
    print(f"2-rank point-sharded frame median {out['two_rank_frame_ms']:.3f} ms (host clock, "
          f"rank 0) {[round(t, 3) for t in out['two_rank_frame_ms_each']]}; spawn to exit "
          f"{out['two_rank_wall_s']:.1f} s")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"multi-device phase: {out['wall_s']:.1f} s")
    return out


GRAPH_FRAMES = 20
GRAPH_BENCH_DISPATCHES = 6  # the short bench: 6 dispatches of 24 frames in 3 groups


def _same_bits(a, b) -> bool:
    """Two tensors equal bit for bit (floats through their int32 bits, so a
    NaN, a one-point patch's eigenvalue, equals a NaN with the same bits)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return bitwise(a, b)
    return torch.equal(a, b)


def _same_frame(got, want, label):
    """Two FrameResults and two states, every field bit for bit."""
    (res_g, st_g), (res_w, st_w) = got, want
    for name in res_w._fields:
        if not _same_bits(getattr(res_g, name), getattr(res_w, name)):
            raise AssertionError(f"{label}: FrameResult.{name} differs")
    for k in st_w.to_numpy():
        if not _same_bits(getattr(st_g, k), getattr(st_w, k)):
            raise AssertionError(f"{label}: state {k} differs")


def _all_captured(model, label):
    frames = list(model._frames.values())
    if not frames or not all(cf.is_captured for cf in frames):
        raise AssertionError(f"{label}: the facade's frames are not all captured: "
                             f"{[cf.is_captured for cf in frames]}")
    return frames


def _frame_graph_probe():
    """scripts/frame_graph_probe.py of this checkout, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "frame_graph_probe.py")
    spec = importlib.util.spec_from_file_location("frame_graph_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def moments_phase(p, cloud, card, device="cuda") -> dict:
    """Phase 4f: ``ops.masked_patch_moments``, a public op that no engine
    runs, at the frame's patch sizes: ``cloud`` binned into its patches at
    capacity CAPACITY. Its sums on the card equal the CPU's bit for bit (a
    segment's points added in point order on every device, one step a
    rank of the largest patch); its ms a call on the card (CUDA events
    around a call, which syncs the host once) and on the host. Raises on
    a difference."""
    import torch

    from patchworkpp_tpu_torch.ops import bin_points, masked_patch_moments
    from patchworkpp_tpu_torch.params import CZMGeometry

    geom = CZMGeometry.create(p)
    args = {}
    for d in (device, "cpu"):
        x = torch.zeros((CAPACITY, 4), device=d)
        x[: len(cloud)] = torch.from_numpy(cloud).to(d)
        bins = bin_points(x, len(cloud), torch.tensor(p.sensor_height, device=d), p, geom)
        mask = bins.valid & bins.in_range & ~bins.noise
        args[d] = (x[:, :3], mask, bins.patch_id, geom.num_patches)
    got = masked_patch_moments(*args[device])
    want = masked_patch_moments(*args["cpu"])
    if not _same_bits(got.cpu(), want):
        raise AssertionError("masked_patch_moments: the card's sums differ from the CPU's")
    ids = args["cpu"][2][args["cpu"][1]].long()
    largest = int(torch.bincount(ids, minlength=geom.num_patches + 1)[:-1].max())

    def timed(fn, on_card):
        """Median ms of 3 calls after a warm-up: CUDA events on the card,
        the host clock on the CPU."""
        t = []
        for _ in range(4):
            if on_card:
                torch.cuda.synchronize()
                ea, eb = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                ea.record()
                fn()
                eb.record()
                torch.cuda.synchronize()
                t.append(ea.elapsed_time(eb))
            else:
                t0 = time.perf_counter()
                fn()
                t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t[1:]))

    out = {"points": int(args["cpu"][1].sum()), "segments": geom.num_patches,
           "largest_segment": largest,
           "card_ms": timed(lambda: masked_patch_moments(*args[device]), True),
           "host_ms": timed(lambda: masked_patch_moments(*args["cpu"]), False)}
    print(f"ops.masked_patch_moments at capacity {CAPACITY}: {out['points']} points in "
          f"{out['segments']} segments, largest {largest} points; card == cpu bit for "
          f"bit; {out['card_ms']:.3f} ms a call on the card (CUDA events), "
          f"{out['host_ms']:.3f} ms on the host's CPU; {card}")
    return out


def label_replay_phase(seed, card, device="cuda") -> dict:
    """Phase 5's KL: the frame tail's label replay at the main path's
    shapes. For Params() and the ROS 2 launch profile, the replay's inputs
    of an eager frame of make_scan(seed, 0) at capacity CAPACITY, recorded
    on the card (pipeline.label_replay swapped for a recorder): KL's mask
    and count equal the plain version's on the card and on the CPU, bit for
    bit; KL's and the plain version's ms a call on the card (CUDA events);
    KL's byte bound; and the graph node count of each profile's captured
    facade frame (scripts/frame_graph_probe.py). Raises on a difference."""
    import torch

    import patchworkpp_tpu_torch.pipeline as tpipe
    from patchworkpp_tpu_torch import Params, PatchworkPP, init_state
    from patchworkpp_tpu_torch.io.synthetic import make_scan
    from patchworkpp_tpu_torch.models.presets import ros_launch_params
    from patchworkpp_tpu_torch.ops import label_replay_kernel as kl

    scan = make_scan(seed, 0)
    probe = _frame_graph_probe()
    out = {}
    for label, p in (("kitti", Params()), ("ros_launch", ros_launch_params())):
        calls = []
        saved = tpipe.label_replay
        tpipe.label_replay = lambda *a: (calls.append(a), saved(*a))[1]
        try:
            x = torch.zeros((CAPACITY, 4), device=device)
            x[: len(scan)] = torch.from_numpy(scan).to(device)
            tpipe.make_frame_fn(p, device=device)(init_state(p, device), x, len(scan))
        finally:
            tpipe.label_replay = saved
        args = calls[0]
        got = kl.label_replay(*args)
        torch.cuda.synchronize()
        host = [a.cpu() if torch.is_tensor(a) else a for a in args]
        for where, want in (("cpu", kl.label_replay_reference(*host)),
                            ("card", kl.label_replay_reference(*args))):
            if not (torch.equal(got[0].cpu(), want[0].cpu()) and int(got[1]) == int(want[1])):
                raise AssertionError(f"KL vs plain ({where}), {label}: "
                                     f"{int((got[0].cpu() != want[0].cpu()).sum())} labels, "
                                     f"count {int(got[1])} vs {int(want[1])}")
        pts, _, tab = args[:3]
        rows, (s, cols) = pts.shape[0], tab.shape
        # the cloud (P, 4) f32 and patch ids read, the table read once, one
        # byte a point and the int32 count written
        b = _bound(rows * 16 + rows * 4 + s * cols * 4 + rows + 4, 0)
        m = PatchworkPP(p, capacity=CAPACITY, device=device)
        m.estimate_ground(scan)  # builds and captures
        nodes, why = probe.graph_nodes(_all_captured(m, f"KL {label}")[0])
        out[label] = {"ms": cuda_ms(lambda: kl.label_replay(*args), reps=200, warmup=20),
                      "plain_ms": cuda_ms(lambda: kl.label_replay_reference(*args), reps=20),
                      "ground": int(got[1]), "rows": rows, "table": [s, cols],
                      "frame_graph_nodes": nodes if nodes is not None else why, **b}
        o = out[label]
        print(f"KL, {label}: == plain (card, cpu) bit for bit, {o['ground']} of {rows} ground, "
              f"table {s} x {cols}; {o['ms']:.5f} ms a call, plain on the card "
              f"{o['plain_ms']:.4f} ms, bound {o['bound_ms']:.6f} ms ({o['bytes']} B); "
              f"captured frame {o['frame_graph_nodes']} graph nodes; {card}")
    return out


def graphs_phase(seed, scans, card, device="cuda") -> dict:
    """Phase 4e: the captured frames (graphs.py) on the card. Captured ==
    eager bit for bit over GRAPH_FRAMES chained frames (every FrameResult
    field and the state after each frame): the facade's tiled and onehot
    frames, both presets, the crowded cloud on both engines,
    pipeline.segment, and a server whose backlog runs as batches; K1 and K2
    counted by name in a torch.profiler trace of GRAPH_FRAMES replays, the
    launch counters equal to those counts; then eager against captured in
    this one call: the frame (CUDA events), the facade's host ms, the short
    bench's scans/s, the server's p50 and p95; and the frame graph replayed
    24 times against a 24-frame chain captured whole. Raises on any
    failure."""
    import threading

    import torch

    from patchworkpp_tpu_torch import Params, PatchworkPP, init_state
    from patchworkpp_tpu_torch import pipeline
    from patchworkpp_tpu_torch.cli import bench
    from patchworkpp_tpu_torch.graphs import WARMUP_FRAMES, CapturedFrame
    from patchworkpp_tpu_torch.io.synthetic import make_crowded_scan
    from patchworkpp_tpu_torch.models import patchwork_params, ros_launch_params
    from patchworkpp_tpu_torch.ops import fit_kernel as fk
    from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg
    from patchworkpp_tpu_torch.parallel.chunked import chunked_step
    from patchworkpp_tpu_torch.params import CZMGeometry
    from patchworkpp_tpu_torch.serve import CloudMsg, GroundSegmentationServer, ServerConfig
    from patchworkpp_tpu_torch.utils.roofline import trace

    t_phase = time.perf_counter()
    dev = torch.device(device)
    n = GRAPH_FRAMES
    chain = scans[:n]
    crowded = make_crowded_scan(seed)
    out = {"warmup_frames": WARMUP_FRAMES}

    def upload(cloud):
        x = torch.zeros((CAPACITY, 4), device=dev)
        x[: len(cloud)] = torch.from_numpy(cloud).to(dev)
        return x

    def eager_chain(params, fused, clouds):
        frame = pipeline.make_frame_fn(params, device=dev, fused=fused)
        st, outs = init_state(params, dev), []
        for c in clouds:
            st, res = frame(st, upload(c), len(c))
            outs.append((res, st))
        return outs

    # a. the facade: captured == eager, frame by frame
    t_cap = {}
    for label, params, fused, clouds in (
            ("tiled", Params(), None, chain), ("onehot", Params(), "onehot", chain),
            ("patchwork_params", patchwork_params(), None, chain),
            ("ros_launch_params", ros_launch_params(), None, chain),
            ("crowded, tiled", Params(), None, [crowded] * n),
            ("crowded, onehot", Params(), "onehot", [crowded] * n)):
        want = eager_chain(params, fused, clouds)
        m = PatchworkPP(params, capacity=CAPACITY, device=dev, fused=fused)
        t0 = time.perf_counter()
        m.estimate_ground(clouds[0])  # builds and captures the frame
        t_cap[label] = time.perf_counter() - t0
        m.reset()
        for i, c in enumerate(clouds):
            m.estimate_ground(c)
            _same_frame((m.last_result, m._state), want[i], f"{label} frame {i}, captured")
        cf = _all_captured(m, label)[0]
        out.setdefault("pool_mb", {})[label] = cf.pool_bytes / 2**20
        print(f"captured == eager, {label}: {n} chained frames bit for bit (every field, "
              f"the state); first frame with capture {t_cap[label]:.2f} s, graph pool "
              f"{cf.pool_bytes / 2**20:.2f} MB")
    out["first_frame_with_capture_s"] = t_cap

    # b. pipeline.segment: a captured frame cached per Params
    p = Params()
    want = eager_chain(p, None, chain)
    st = init_state(p, dev)
    for i, c in enumerate(chain):
        st, res = pipeline.segment(st, upload(c), len(c), p)
        _same_frame((res, st), want[i], f"segment frame {i}")
    if not pipeline._cached_frame_fn(p, upload(chain[0]).device).is_captured:
        raise AssertionError("segment's frame is not captured")
    print(f"captured == eager, pipeline.segment: {n} chained frames bit for bit")

    # b2. segment from two threads at once, the second on a side stream
    halves = [chain[: n // 2], chain[n // 2:]]
    wants = [eager_chain(p, None, h) for h in halves]
    got, errors = [[], []], []
    start = threading.Barrier(2)

    def seg_chain(clouds, results, stream):
        try:
            with torch.cuda.stream(stream):
                st = init_state(p, dev)
                start.wait()
                for c in clouds:
                    st, res = pipeline.segment(st, upload(c), len(c), p)
                    results.append((res, st))
                stream.synchronize()
        except Exception as e:  # noqa: BLE001 - raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=seg_chain, args=(h, g, s)) for h, g, s in
               zip(halves, got, (torch.cuda.default_stream(dev), torch.cuda.Stream(dev)))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"segment from two threads: {errors or 'a thread hung'}")
    for i, (ref, results) in enumerate(zip(wants, got)):
        if len(results) != len(ref):
            raise AssertionError(f"segment thread {i}: {len(results)} of {len(ref)} frames")
        for k, r in enumerate(results):
            _same_frame(r, ref[k], f"segment thread {i} frame {k}")
    print(f"pipeline.segment from two threads, one on a side stream: {n // 2} chained "
          f"frames each, equal to the eager chains bit for bit")

    # c. a server whose backlog batches: every frame one replay of one graph
    srv = GroundSegmentationServer(config=ServerConfig(
        capacity=CAPACITY, queue_depth=8, batch_max=2, drop_when_full=False), device=device)
    batches = []
    seq_call = srv._model.estimate_ground_sequence
    srv._model.estimate_ground_sequence = lambda clouds: (batches.append(len(clouds)),
                                                           seq_call(clouds))[1]
    srv.process(CloudMsg(points=chain[0], stamp=0.0))  # builds and captures
    srv._model.reset()
    got, errors, done = [], [], threading.Event()

    def on_result(r):
        got.append(r.result)
        errors.append(r.error)
        if len(got) == n or r.error is not None:
            done.set()

    srv.on_result(on_result)
    fkg.fused_fit_grid.launches = fk.fused_fit.launches = 0
    with srv:
        for c in chain:
            srv.publish(CloudMsg(points=c, stamp=time.perf_counter()))
        if not done.wait(300.0):
            raise RuntimeError(f"server backlog: {len(got)} of {n} answered in 300 s")
    if any(e is not None for e in errors):
        raise RuntimeError(f"server backlog: a scan raised: {errors}")
    counts = {"fit_grid": fkg.fused_fit_grid.launches, "fit_onehot": fk.fused_fit.launches}
    if counts != {"fit_grid": n, "fit_onehot": 0}:
        raise AssertionError(f"server backlog: launches {counts} in {n} frames")
    for i, (r, (res, _)) in enumerate(zip(got, want)):
        mask = res.ground_mask[: len(chain[i])].cpu().numpy()
        proc = res.patch_processed.cpu().numpy()
        if not (np.array_equal(r.ground_mask, mask)
                and np.array_equal(r.centers, res.patch_mean.cpu().numpy()[proc])
                and np.array_equal(r.normals, res.patch_normal.cpu().numpy()[proc],
                                   equal_nan=True)):
            raise AssertionError(f"server backlog frame {i}: differs from the eager chain")
    _same_frame((want[-1][0], srv._model._state), want[-1], "server backlog final state")
    frames = _all_captured(srv._model, "server backlog")
    if len(frames) != 1 or not any(b > 1 for b in batches):
        raise AssertionError(f"server backlog: {len(frames)} graphs, batches {batches}")
    out["server_backlog"] = {"batches": batches, "launches": counts}
    print(f"captured == eager, server with a backlog: {n} frames ({sum(batches)} in "
          f"{len(batches)} sequence calls of {sorted(set(batches))}), one graph, launches "
          f"{counts}")

    # d. the fit kernel by name in a profiler trace of n replays
    out["profiled_replays"] = {}
    for label, fused, name, counter in (("tiled", None, "Split3", fkg.fused_fit_grid),
                                        ("onehot", "onehot", "F32Chain", fk.fused_fit)):
        m = PatchworkPP(p, capacity=CAPACITY, device=dev, fused=fused)
        m.estimate_ground(chain[0])
        cf = _all_captured(m, label)[0]
        xs = [upload(c) for c in chain]
        fkg.fused_fit_grid.launches = fk.fused_fit.launches = 0
        events, _ = trace(lambda: [cf.run(x, len(c)) for x, c in zip(xs, chain)])
        named = sum(e.on_device and "fit_program_kernel" in e.name and name in e.name
                    for e in events)
        launched = {"fit_grid": fkg.fused_fit_grid.launches,
                    "fit_onehot": fk.fused_fit.launches}
        if named != n or counter.launches != n or sum(launched.values()) != n:
            raise AssertionError(f"{label}: {named} fit kernels named {name} in the trace of "
                                 f"{n} replays, counters {launched}")
        out["profiled_replays"][label] = {"kernels_named": named, "launches": launched}
        print(f"{label}: {n} replays traced, fit_program_kernel<{name}> {named} times on the "
              f"card, launch counters {launched}")

    # e. eager against captured, in this one call (the probe script's timing)
    probe = _frame_graph_probe()

    def frame_ms(fn, xs):
        return float(np.median(probe.frame_ms(lambda k: fn(k, xs), len(xs))))

    xs = [upload(c) for c in chain]
    timing = {}
    for label, fused in (("tiled", None), ("onehot", "onehot")):
        frame = pipeline.make_frame_fn(p, device=dev, fused=fused)
        box = [init_state(p, dev)]

        def eager(k, xs, frame=frame, box=box):
            box[0], _ = frame(box[0], xs[k], len(chain[k]))

        m = PatchworkPP(p, capacity=CAPACITY, device=dev, fused=fused)
        m.estimate_ground(chain[0])
        cf = _all_captured(m, label)[0]
        timing[f"{label}_frame_ms"] = {
            "eager": frame_ms(eager, xs),
            "captured": frame_ms(lambda k, xs: cf(xs[k], len(chain[k])), xs)}
        host = {}
        for mode in ("eager", "captured"):
            fm = PatchworkPP(p, capacity=CAPACITY, device=dev, fused=fused)
            fm._capture = mode == "captured"  # the eager facade, for this comparison
            fm.estimate_ground(chain[0])
            fm.reset()
            host[mode] = float(np.median(
                [fm.estimate_ground(c).time_taken_s for c in chain][1:]) * 1e3)
        timing[f"{label}_facade_host_ms"] = host
        if label == "tiled":
            graph = probe.probe(cf, xs, [len(c) for c in chain])
            out["tiled_frame_graph"] = graph
            print(f"captured tiled frame: {graph['graph_nodes']} graph nodes "
                  f"({graph['graph_nodes_note'] or 'cuGraphGetNodes'}), "
                  f"{graph['device_ops_per_frame']:g} device operations a frame, "
                  f"{timing['tiled_frame_ms']['captured']:.4f} ms a frame (CUDA events, "
                  f"median of {n}); {card}")
        print(f"eager vs captured, {label} frame median (CUDA events): "
              f"{timing[f'{label}_frame_ms']['eager']:.3f} ms vs "
              f"{timing[f'{label}_frame_ms']['captured']:.3f} ms; {card}")
        print(f"eager vs captured, {label} facade host ms a frame (upload, frame, "
              f"readback; median of {n - 1}): {host['eager']:.3f} vs {host['captured']:.3f}; "
              f"{card}")

    # the chunked (K = 2, 4, and 16: KS's phase route) and unfused frames:
    # eager against captured, the graph's node count and pool
    out["graph_nodes"] = {"tiled": out["tiled_frame_graph"]["graph_nodes"]}
    for label, kw, frames in (("chunks=2", {"chunks": 2}, n), ("chunks=4", {"chunks": 4}, n),
                              ("chunks=16", {"chunks": PHASE_ROUTE_CHUNKS}, PHASE_ROUTE_FRAMES),
                              ("unfused", {"fused": False}, EAGER_UNFUSED_TIMED)):
        step = chunked_step(p, kw.get("chunks", 1), CZMGeometry.create(p), kw.get("fused"),
                            dev)
        box = [init_state(p, dev)]

        def eager(k, xs, step=step, box=box):
            box[0], _ = step(box[0], xs[k], len(chain[k]))

        m = PatchworkPP(p, capacity=CAPACITY, device=dev, **kw)
        m.estimate_ground(chain[0])
        cf = _all_captured(m, label)[0]
        timing[f"{label}_frame_ms"] = {
            "eager": frame_ms(eager, xs[:frames]),
            "captured": frame_ms(lambda k, xs: cf(xs[k], len(chain[k])), xs)}
        nodes, why = probe.graph_nodes(cf)
        out["graph_nodes"][label] = nodes
        out["pool_mb"][label] = cf.pool_bytes / 2**20
        print(f"eager vs captured, {label} frame median (CUDA events; eager over {frames} "
              f"frames, captured over {n}): {timing[f'{label}_frame_ms']['eager']:.3f} ms vs "
              f"{timing[f'{label}_frame_ms']['captured']:.3f} ms; graph "
              f"{nodes if nodes is not None else why} nodes, pool "
              f"{cf.pool_bytes / 2**20:.2f} MB; {card}")
        if label == "chunks=16":
            # KS's phase route inside the captured frame: its kernels' device
            # ms and count a replay, from a profiler trace of 3 replays
            events, _ = trace(lambda cf=cf: [cf.run(x, len(c)) for x, c in
                                             zip(xs[:3], chain[:3])])
            kernels = [e for e in events if e.on_device and not e.annotation]
            ks = [e for e in kernels if "fit_sharded_kernel" in e.name]
            out["chunks16_replay"] = {"busy_ms": sum(e.dur_us for e in kernels) / 3e3,
                                      "ks_ms": sum(e.dur_us for e in ks) / 3e3,
                                      "ks_launches": len(ks) / 3}
            print(f"captured chunks={PHASE_ROUTE_CHUNKS} frame, a replay (profiler trace of 3): "
                  f"KS's phase route {out['chunks16_replay']['ks_ms']:.4f} ms of device time "
                  f"in {out['chunks16_replay']['ks_launches']:g} launches, device busy "
                  f"{out['chunks16_replay']['busy_ms']:.3f} ms; {card}")
        if label == "unfused":
            # the device busy ms and KR's kernels a replay, from a profiler
            # trace of 5 replays
            events, _ = trace(lambda cf=cf: [cf.run(x, len(c)) for x, c in
                                             zip(xs[:5], chain[:5])])
            kernels = [e for e in events if e.on_device and not e.annotation]
            by = kr_launches(events)["by_kernel"]
            out["unfused_replay"] = {
                "busy_ms": sum(e.dur_us for e in kernels) / 5e3,
                "kr_ms": sum(v["ms"] for v in by.values()) / 5,
                "kr_by_kernel": {n: {"ms": v["ms"] / 5, "launches": v["launches"] / 5}
                                 for n, v in by.items()}}
            r = out["unfused_replay"]
            each = ", ".join(f"{n} {v['ms']:.4f} ms in {v['launches']:g}"
                             for n, v in r["kr_by_kernel"].items())
            print(f"captured unfused frame, a replay (profiler trace of 5): device busy "
                  f"{r['busy_ms']:.3f} ms, KR's kernels {r['kr_ms']:.4f} ms of device time "
                  f"({each}); {card}")

    stack6, npts6 = bench.build_stack(scans[:6], 1, CAPACITY)
    stack = torch.from_numpy(np.tile(stack6, (4, 1, 1))).to(dev)
    npts = [int(k) for k in np.tile(npts6, 4)]
    rates = {}
    for mode, seq in (("eager", pipeline.sequence_of(pipeline.make_frame_fn(p, device=dev))),
                      ("captured", pipeline.make_sequence_fn(p, device=dev))):
        box = [init_state(p, dev)]

        def step(seq=seq, box=box):
            box[0], _ = seq(box[0], stack, npts)

        for _ in range(bench.WARMUP_DISPATCHES):
            step()
        r, _, _ = bench.timed_groups(step, lambda box=box: box[0].sensor_height.item(),
                                     GRAPH_BENCH_DISPATCHES, 3, len(npts))
        rates[mode] = {"median": float(np.median(r)), "min": min(r), "max": max(r)}
        if mode == "captured" and not seq.is_captured:
            raise AssertionError("the bench's sequence is not captured")
    timing["bench_scans_per_s"] = rates

    # the whole 24-frame chain as one graph, against the frame graph
    # replayed 24 times (what make_sequence_fn does), on the bench's stack
    seq = pipeline.make_sequence_fn(p, device=dev)
    chain_cf = CapturedFrame(pipeline.make_frame_fn(p, device=dev), CAPACITY, init_state(p, dev))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            chain_cf.sequence(stack, npts)
    torch.cuda.current_stream().wait_stream(side)
    whole = torch.cuda.CUDAGraph()
    with torch.cuda.graph(whole, stream=side):
        chain_cf.sequence(stack, npts)
    st0 = init_state(p, dev)
    per_frame = {"frame_graph": lambda: seq(st0, stack, npts), "chain_graph": whole.replay}
    chain_ms = {k: cuda_ms(fn, reps=5) / len(npts) for k, fn in per_frame.items()}
    timing["chain_ms_per_frame"] = chain_ms
    print(f"a {len(npts)}-frame sequence, ms a frame (CUDA events): the frame graph replayed "
          f"{len(npts)} times {chain_ms['frame_graph']:.4f}, the whole chain captured as one "
          f"graph {chain_ms['chain_graph']:.4f}; {card}")
    print(f"eager vs captured, short bench ({GRAPH_BENCH_DISPATCHES} dispatches of "
          f"{len(npts)} chained frames, 3 groups): {rates['eager']['median']:.3f} vs "
          f"{rates['captured']['median']:.3f} scans/s (min {rates['eager']['min']:.3f} / "
          f"{rates['captured']['min']:.3f}, max {rates['eager']['max']:.3f} / "
          f"{rates['captured']['max']:.3f}); {card}")

    lat = {}
    for mode in ("eager", "captured"):
        srv = GroundSegmentationServer(config=ServerConfig(capacity=CAPACITY), device=device)
        srv._model._capture = mode == "captured"  # the eager server, for this comparison
        srv.process(CloudMsg(points=chain[0], stamp=0.0))
        got_l, answered = [], threading.Event()
        srv.on_result(lambda r: (got_l.append((time.perf_counter() - r.msg.stamp, r.error)),
                                 answered.set()))
        with srv:
            for i, c in enumerate(chain):
                answered.clear()
                srv.publish(CloudMsg(points=c, stamp=time.perf_counter()))
                if not answered.wait(120.0):
                    raise RuntimeError(f"{mode} server: message {i} not answered in 120 s")
        if any(e is not None for _, e in got_l):
            raise RuntimeError(f"{mode} server: a scan raised")
        ms = np.asarray([t for t, _ in got_l]) * 1e3
        lat[mode] = {"p50": float(np.percentile(ms, 50)), "p95": float(np.percentile(ms, 95))}
        if mode == "captured":
            _all_captured(srv._model, "captured server")
    timing["server_latency_ms"] = lat
    print(f"eager vs captured, server closed loop ({n} frames): p50 "
          f"{lat['eager']['p50']:.3f} vs {lat['captured']['p50']:.3f} ms, p95 "
          f"{lat['eager']['p95']:.3f} vs {lat['captured']['p95']:.3f} ms; {card}")
    out["timing"] = timing
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"graphs phase: {out['wall_s']:.1f} s")
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
    from patchworkpp_tpu_torch.ops import label_replay_kernel as kl
    from patchworkpp_tpu_torch.ops import patch_reduce_kernel as kr
    from patchworkpp_tpu_torch.ops import sharded_fit as sf
    from patchworkpp_tpu_torch.ops.onehot import patch_reduce_reference
    from patchworkpp_tpu_torch.ops.tiled_fit import FitProgram, tiled_fit
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
    with ThreadPoolExecutor(5) as pool:
        for fut in [pool.submit(m.build) for m in (fkg, fk, sf, kr, kl)]:
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"kernels build (K1, K2, KS, KR and KL in parallel): {build_s:.2f} s")
    for module in (fkg, fk, sf, kr, kl):
        print(module.build_log().strip())

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

    # KR, the unfused engine's per-patch sum, on every call of an unfused
    # frame of the main scan and of the crowded cloud
    kr_main = record_patch_reduce(p, scans[0])
    kr_crowd = record_patch_reduce(p, make_crowded_scan(args.seed))
    kr_err = max(check_kr(kr_main, "main scan"), check_kr(kr_crowd, "crowded patch"))

    # ---- 3b. KS's two routes vs the plain sharded fits on the card, chunks=2, 4, 8
    ks_main = sharded_fit_phase(p, scans[0], "main scan")
    ks_crowd = sharded_fit_phase(p, make_crowded_scan(args.seed), "crowded patch")
    cluster_checks_phase(p, ks_main["cluster_inputs"], "main scan")
    if ks_crowd["largest_tiles_2"] <= fkg.CAP_TILES:
        raise AssertionError("crowded cloud: no chunk's largest patch is over the "
                             f"{fkg.CAP_TILES}-tile cap")

    # ---- 4. main paths on the card vs the CPU path
    counters = {"fit_grid": fkg.fused_fit_grid, "fit_onehot": fk.fused_fit,
                "fit_sharded": sf.sharded_fit, "patch_reduce": kr.patch_reduce_kernel,
                "patch_moments": kr.patch_moment_sums_kernel, "label_replay": kl.label_replay}

    def drive(fused, frames, want):
        """``frames`` chained frames of engine ``fused`` on the card, a
        captured frame replayed each, and on the CPU; labels and state must
        agree. Every launch count is set to 0 just before the card's run and
        read just after; ``want`` maps the kernels of the engine to their
        launches a frame (every other kernel must not have launched). In
        the unfused engine's run KR's kernels count their own launches on
        the card (patch_reduce_kernel.kernel_launches, zeroed with the
        wrappers' counts: a chunk launch and a fold a call); its replays
        must also equal its eager frames bit for bit (every FrameResult
        field, and the state after each frame). Every engine's replay
        launches KL once, which counts itself on the card too."""
        want = {**want, "label_replay": 1}
        gpu = PatchworkPP(p, capacity=CAPACITY, device="cuda", fused=fused)
        gpu.estimate_ground(scans[0])  # builds the kernel, captures the frame
        gpu.reset()
        res, states, kept = [], {}, []

        def run():
            for i, s in enumerate(scans[:frames]):
                res.append(gpu.estimate_ground(s))
                if fused is False:
                    kept.append((gpu.last_result, gpu.state))
                if i == CHECKED_FRAME:
                    states["card"] = gpu.state.to_numpy()

        for fn in counters.values():
            fn.launches = 0
        kr.kernel_launches(reset=True)
        kl.kernel_launches(reset=True)
        run()
        counts = {k: fn.launches for k, fn in counters.items()}
        on_card = kr.kernel_launches()
        if kl.kernel_launches() != frames:
            raise AssertionError(f"fused={fused!r}: KL launched {kl.kernel_launches()} times on "
                                 f"the card in {frames} frames")
        for k, n in counts.items():
            expect = frames * want.get(k, 0)
            if n != expect:
                raise AssertionError(f"fused={fused!r}: {k} launched {n} times "
                                     f"in {frames} frames, expected {expect}")
        n_gen = counts["patch_reduce"] - counts["patch_moments"]
        want_kr = dict(zip(kr.LAUNCH_COUNTERS, (n_gen, counts["patch_moments"], n_gen,
                                                counts["patch_moments"])))
        if on_card != want_kr:
            raise AssertionError(f"fused={fused!r}: KR's kernels launched {on_card} times on "
                                 f"the card for {counts['patch_reduce']} calls "
                                 f"({counts['patch_moments']} moment mode)")
        if fused is False:
            if min(on_card.values()) == 0:
                raise AssertionError(f"fused=False: a KR kernel never launched: {on_card}")
            counts["kr_on_card"] = on_card
            print(f"fused=False: KR's kernels counted {on_card} launches on the card in the "
                  f"{frames} frames, for {counts['patch_reduce']} wrapper calls")
        _all_captured(gpu, f"fused={fused!r}")
        if fused is False:
            eager = PatchworkPP(p, capacity=CAPACITY, device="cuda", fused=fused)
            for i, s in enumerate(scans[:frames]):
                eager._estimate(s, captured=False)
                _same_frame(kept[i], (eager.last_result, eager._state),
                            f"fused=False frame {i}, captured vs eager")
            print(f"fused=False: {frames} captured frames == eager frames bit for bit "
                  "(every FrameResult field and the state after each)")
        cpu = PatchworkPP(p, capacity=CAPACITY, device="cpu", fused=fused)
        for i, s in enumerate(scans[:frames]):
            r = cpu.estimate_ground(s)
            if i == CHECKED_FRAME:
                states["cpu"] = cpu.state.to_numpy()
            g = res[i]
            if not np.array_equal(g.ground_mask, r.ground_mask):
                diff = int((g.ground_mask != r.ground_mask).sum())
                raise AssertionError(f"fused={fused!r} frame {i}: {diff} labels "
                                     "differ card vs cpu")
            if g.ground_mask.shape != (len(s),) or not 0 < g.ground_mask.sum() < len(s):
                raise AssertionError(f"fused={fused!r} frame {i}: implausible labels")
        if fused is None and states:  # every field, bit for bit, after frame 6
            for key, v in states["cpu"].items():
                if not np.array_equal(states["card"][key].view(np.uint32), v.view(np.uint32)):
                    raise AssertionError(f"frame {CHECKED_FRAME}: state {key} differs card "
                                         "vs cpu")
            print(f"fused=None: the state after frame {CHECKED_FRAME} equals the cpu path's "
                  f"bit for bit, every field ({', '.join(states['cpu'])})")
        st_g, st_c = gpu.state.to_numpy(), cpu.state.to_numpy()
        exact = TILED_EXACT_STATE if fused is None else ()
        state_err = {}
        for key in st_c:
            if st_c[key].dtype.kind == "i":
                np.testing.assert_array_equal(st_g[key], st_c[key], err_msg=key)
            else:
                state_err[key] = float(np.abs(st_g[key].astype(np.float64) - st_c[key]).max())
                np.testing.assert_allclose(st_g[key], st_c[key], rtol=0,
                                           atol=0.0 if key in exact else STATE_ATOL,
                                           err_msg=key)
        print(f"fused={fused!r}: {frames} frames, labels equal to the cpu path, "
              f"ground {[int(r.ground_mask.sum()) for r in res[:3]]}..., "
              f"sensor_height {gpu.sensor_height:.6f}, wrapper counts "
              f"{ {k: v for k, v in counts.items() if k != 'kr_on_card'} }; state card vs "
              f"cpu max |err| {state_err} (0 required for {list(exact)})")
        return res, counts

    gpu_res, counts_k1 = drive(None, args.frames, {"fit_grid": 1})
    onehot_res, counts_k2 = drive("onehot", args.frames, {"fit_onehot": 1})
    launches, launches_k2 = counts_k1["fit_grid"], counts_k2["fit_onehot"]
    # KR once a call in either mode, the calls of one unfused frame (11 at
    # default Params: 4 LPR sums, 7 moment sums in the moment mode); its
    # launches from the run's trace
    n_mom = sum(mode == "moments" for mode, _ in kr_main)
    unfused_res, counts_kr = drive(False, args.frames, {"patch_reduce": len(kr_main),
                                                         "patch_moments": n_mom})
    calls_kr = counts_kr["patch_reduce"] - counts_kr["patch_moments"]
    calls_mom = counts_kr["patch_moments"]
    on_card = counts_kr["kr_on_card"]
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

    # ---- 4d. the multi-device layer: chunked, point-sharded, frame-parallel
    multi = multi_device_phase(args.seed)

    # ---- 4e. captured frames: == eager bit for bit, kernels in the replays, timing
    graphs = graphs_phase(args.seed, scans, card)

    # ---- 4f. the public ops.masked_patch_moments at the frame's patch sizes
    moments = moments_phase(p, scans[0], card)

    # ---- 5. timing
    kernel_ms = cuda_ms(lambda: fkg.fused_fit_grid(*fit_args, p), reps=50)

    # the crowded cloud: a patch over the kernels' shared-memory cap
    crowd_ms = cuda_ms(lambda: fkg.fused_fit_grid(*crowd_args, p), reps=20)
    k2_crowd_ms = cuda_ms(lambda: fk.fused_fit(*crowd_args, p), reps=20)
    plain_ms = cuda_ms(lambda: tiled_fit(*fit_args[:7], fi.consts[0], p), reps=5)
    k2_ms = cuda_ms(lambda: fk.fused_fit(*fit_args, p), reps=50)
    k2_plain_ms = cuda_ms(lambda: fk.fused_fit_reference(*fit_args, p), reps=3, warmup=1)
    # KS: chunk 0's launches of a chunks=2 frame, back to back on their
    # recorded inputs; its plain phases on the same; the fit stage of the
    # frame (both chunks, the comm between) for KS and the plain program
    ks_fi, ks_rec = ks_main["record"]
    ks_ms = cuda_ms(lambda: ks_rec.replay(sf._Kernel(
        ks_fi.xs, ks_fi.ys, ks_fi.zs, ks_fi.valid_f, ks_fi.pad_start, ks_fi.gates,
        ks_fi.consts, p)), reps=50)
    ks_plain_ms = cuda_ms(lambda: ks_rec.replay(sf._Reference(FitProgram(
        ks_fi.xs, ks_fi.ys, ks_fi.zs, ks_fi.valid_f, ks_fi.tile_patch, ks_fi.pad_start,
        ks_fi.gates, ks_fi.consts[0], p))), reps=3, warmup=1)
    fi_c, rec_c = ks_crowd["record"]
    ks_crowd_ms = cuda_ms(lambda: rec_c.replay(sf._Kernel(
        fi_c.xs, fi_c.ys, fi_c.zs, fi_c.valid_f, fi_c.pad_start, fi_c.gates, fi_c.consts,
        p)), reps=20)
    # the cluster route: both chunks of a chunks=2 frame in one launch (also
    # 4 and 8 chunks, and the crowded cloud), the most clusters of each size
    # the card holds at once; its plain version (the plain phases over the
    # chunk comm) as a fit stage on the card
    cl_in = ks_main["cluster_inputs"]
    cluster_ms = {k: cuda_ms(lambda k=k: sf.cluster_fit(cl_in[k], p), reps=50)
                  for k in (2, 4, 8)}
    cluster_occ = {k: sf.cluster_occupancy(k) for k in (2, 4, 8)}
    cluster_crowd_ms = cuda_ms(lambda: sf.cluster_fit(ks_crowd["cluster_inputs"][2], p),
                               reps=20)
    cluster_plain_ms = sharded_stage_ms(p, scans[0], lambda fi, comm: sf.sharded_fit_reference(
        fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates, fi.consts,
        p, comm), reps=3)
    ks_stage_ms = sharded_stage_ms(p, scans[0], lambda fi, comm: sf.sharded_fit(
        fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates, fi.consts,
        p, comm), reps=20)
    ks_phase_stage_ms = sharded_stage_ms(p, scans[0], lambda fi, comm: sf._drive(sf._Kernel(
        fi.xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start, fi.gates, fi.consts, p), p, comm),
        reps=20)
    plain_stage_ms = sharded_stage_ms(p, scans[0], lambda fi, comm: tiled_fit(
        fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates,
        fi.consts[0], p, comm=comm), reps=3)
    kr_t = kr_timing(kr_main, kr_crowd)
    kl_t = label_replay_phase(args.seed, card)
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
                                   min(EAGER_UNFUSED_FRAMES, len(scans)), warmup=1)
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
          f"{frame_ms:.3f} ms (eager, CUDA events), {host_ms:.3f} ms the facade's host "
          "median (captured frame, upload and readback included)")
    print(f"K2 {k2_ms:.4f} ms, plain on card {k2_plain_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms, crowded-patch cloud {k2_crowd_ms:.4f} ms; "
          f"onehot frame median {frame_k2_ms:.3f} ms, "
          f"unfused frame median {frame_unf_ms:.3f} ms (CUDA events)")

    bound_by = "bytes" if t_bytes >= t_ops else "operations"

    # KS's bound, chunk 0 of 2 on the main scan: its processed tiles' rows,
    # pad_start, gates, consts read once; each launch's table from the comm
    # read (the reduced moments at 7 pass ends, the merged LPR sum and count
    # at 4 SEEDFIT passes) and its own table written (4 LPR tables, 7
    # moment tables, the fit table)
    n_seed = int((kind == fkg.K_SEEDFIT).sum())
    ks_rows = 128 * ks_main["chunk0_processed_tiles"]
    ks_tables = (n_seed * spad * (2 * p.num_lpr + 1 + 2) + 2 * npasses * 10 * spad
                 + spad * cols)
    ks_bytes = ks_rows * 16 + 4 * (spad + 1) + 32 * spad + 32 + 4 * ks_tables
    ks_ops = ks_rows * npasses * FIT_OPS_PER_ROW_PASS
    ks_t_bytes, ks_t_ops = ks_bytes / H100_BYTES_PER_S, ks_ops / H100_F32_FLOPS
    ks_bound_ms = max(ks_t_bytes, ks_t_ops) * 1e3
    # the cluster route's bound, both chunks of 2 on the main scan: both
    # chunks' processed tiles' rows and pad_start, chunk 0's gates and
    # consts read once, both tables written (the rows the CTAs exchange stay
    # in distributed shared memory, and are neither input nor output)
    n_proc = int((cl_in[2][0][6][:, 0] > 0.5).sum())
    cl_rows = 128 * ks_main["processed_tiles_2"]
    cl_bytes = cl_rows * 16 + 2 * 4 * (spad + 1) + 32 * spad + 32 + 2 * 4 * spad * cols
    cl_ops = cl_rows * npasses * FIT_OPS_PER_ROW_PASS
    cl_t_bytes, cl_t_ops = cl_bytes / H100_BYTES_PER_S, cl_ops / H100_F32_FLOPS
    cl_bound_ms = max(cl_t_bytes, cl_t_ops) * 1e3
    print(f"KS phase route {ks_ms:.4f} ms a shard a frame ({sf.launches_per_frame(p)} "
          f"launches, chunk 0 of 2, replayed), plain phases on the card {ks_plain_ms:.3f} ms, "
          f"bound {ks_bound_ms:.5f} ms ({ks_bytes} B, {ks_ops} ops), crowded-patch cloud "
          f"{ks_crowd_ms:.4f} ms")
    print(f"KS cluster route {cluster_ms[2]:.4f} ms for both chunks of 2 (1 launch; 4 chunks "
          f"{cluster_ms[4]:.4f} ms, 8 chunks {cluster_ms[8]:.4f} ms), its plain version on "
          f"the card {cluster_plain_ms:.3f} ms (a fit stage), bound {cl_bound_ms:.5f} ms "
          f"({cl_bytes} B, {cl_ops} ops), crowded-patch cloud {cluster_crowd_ms:.4f} ms")
    print("KS cluster route occupancy (cudaOccupancyMaxActiveClusters): " + ", ".join(
        f"{k} chunks {cluster_occ[k]} clusters ({k * cluster_occ[k]} CTAs) at once, "
        f"{-(-n_proc // cluster_occ[k])} waves of the {n_proc} processed patches"
        for k in (2, 4, 8)))
    print(f"fit stage of a chunks=2 frame (CUDA events, both chunks and their meetings): "
          f"KS cluster {ks_stage_ms:.3f} ms, KS phases {ks_phase_stage_ms:.3f} ms, plain "
          f"tiled_fit(comm) {plain_stage_ms:.3f} ms; chunks=2 frame median "
          f"{graphs['timing']['chunks=2_frame_ms']['captured']:.3f} ms captured, "
          f"{graphs['timing']['chunks=2_frame_ms']['eager']:.3f} ms eager, 2-rank frame "
          f"median {multi['two_rank_frame_ms']:.3f} ms; {card}")
    print_kr_timing(kr_t, card)
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
    }, {
        "name": "fit_sharded_cluster",
        "route": "cuda",
        "source": "patchworkpp_tpu_torch/csrc/fit_sharded.cu",
        "replaces": "patchworkpp_tpu/ops/tiled_fit.py:254",
        "launches": multi["chunked_launches"][2]["fit_sharded"],
        "max_abs_err": max(ks_main["max_abs_err"], ks_crowd["max_abs_err"]),
        "ms": cluster_ms[2],
        "plain_ms": cluster_plain_ms,
        "bound_ms": cl_bound_ms,
        "bound_by": "bytes" if cl_t_bytes >= cl_t_ops else "operations",
        "library_ms": None,
        "stage_ms": ks_stage_ms,
        "plain_stage_ms": plain_stage_ms,
        "ms_4_chunks": cluster_ms[4],
        "ms_8_chunks": cluster_ms[8],
        "max_active_clusters": {str(k): v for k, v in cluster_occ.items()},
    }, {
        "name": "fit_sharded",
        "route": "cuda",
        "source": "patchworkpp_tpu_torch/csrc/fit_sharded.cu",
        "replaces": "patchworkpp_tpu/ops/tiled_fit.py:254",
        "launches": multi["two_rank_launches"][2],
        "max_abs_err": max(ks_main["max_abs_err"], ks_crowd["max_abs_err"]),
        "ms": ks_ms,
        "plain_ms": ks_plain_ms,
        "bound_ms": ks_bound_ms,
        "bound_by": "bytes" if ks_t_bytes >= ks_t_ops else "operations",
        "library_ms": None,
        "stage_ms": ks_phase_stage_ms,
        "plain_stage_ms": plain_stage_ms,
    }, {
        # the generic mode: ms, bounds and index_add_ on the 10-column
        # moment table; the main path gives it only the LPR sums (lpr_*)
        "name": "patch_reduce",
        "route": "cuda",
        "source": "patchworkpp_tpu_torch/csrc/patch_reduce.cu",
        "replaces": "patchworkpp_tpu/ops/onehot.py:281",
        "launches": on_card["kr_chunk_sums"] + on_card["kr_fold generic"],
        "max_abs_err": kr_err,
        "ms": kr_t["generic"]["ms"],
        "plain_ms": kr_t["generic"]["plain_ms"],
        "bound_ms": kr_t["generic"]["bound_ms"],
        "bound_by": kr_t["generic"]["bound_by"],
        "library_ms": kr_t["generic"]["library_ms"],
        "shape": f"{kr_t['generic']['cols']}-column moment table (not a main-path input "
                 f"since the moment mode); main path: the {kr_t['generic']['lpr_cols']}-column "
                 "LPR sums, lpr_ms",
        "crowded_ms": kr_t["generic"]["crowded_ms"],
        "lpr_ms": kr_t["generic"]["lpr_ms"],
        "lpr_bound_ms": kr_t["generic"]["lpr_bound_ms"],
        "lpr_bound_by": kr_t["generic"]["lpr_bound_by"],
        "calls": calls_kr,
        "launches_by_kernel": {"kr_chunk_sums": on_card["kr_chunk_sums"],
                               "kr_fold": on_card["kr_fold generic"]},
    }, {
        "name": "patch_moment_sums",
        "route": "cuda",
        "source": "patchworkpp_tpu_torch/csrc/patch_reduce.cu",
        "replaces": "patchworkpp_tpu/ops/onehot.py:281",
        "launches": on_card["kr_moment_sums"] + on_card["kr_fold moments"],
        "max_abs_err": kr_err,
        "ms": kr_t["moments"]["ms"],
        "plain_ms": kr_t["moments"]["plain_ms"],
        "bound_ms": kr_t["moments"]["bound_ms"],
        "bound_by": kr_t["moments"]["bound_by"],
        "library_ms": None,
        "crowded_ms": kr_t["moments"]["crowded_ms"],
        "calls": calls_mom,
        "launches_by_kernel": {"kr_moment_sums": on_card["kr_moment_sums"],
                               "kr_fold": on_card["kr_fold moments"]},
    }, {
        "name": "label_replay",
        "route": "cuda",
        "source": "patchworkpp_tpu_torch/csrc/label_replay.cu",
        "replaces": None,
        "launches": counts_k1["label_replay"],
        "max_abs_err": 0.0,
        "ms": kl_t["kitti"]["ms"],
        "plain_ms": kl_t["kitti"]["plain_ms"],
        "bound_ms": kl_t["kitti"]["bound_ms"],
        "bound_by": kl_t["kitti"]["bound_by"],
        "library_ms": None,
        "ros_launch_ms": kl_t["ros_launch"]["ms"],
        "frame_graph_nodes": {k: v["frame_graph_nodes"] for k, v in kl_t.items()},
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
        "ks_crowded_ms": ks_crowd_ms, "ks_cluster_crowded_ms": cluster_crowd_ms,
        "ks_checks": {k: v for k, v in ks_main.items()
                      if k not in ("record", "cluster_inputs")},
        "references": references, "multi_device": multi, "graphs": graphs,
        "masked_patch_moments": moments, **kernels,
    }
    if args.profile:
        record["profile"] = {}
        for label, fused, n in (("tiled", None, 5), ("onehot", "onehot", 5),
                                ("unfused", False, EAGER_UNFUSED_FRAMES)):
            print(f"engine {label}:")
            fn = make_frame_fn(p, device=dev, fused=fused)
            st, _ = fn(init_state(p, dev), xs_dev[0], npts[0])  # warm-up
            record["profile"][label] = profile_frames(
                fn, st, xs_dev, npts, n=min(n, len(scans)))
        for label, fused in (("tiled captured", None), ("onehot captured", "onehot"),
                             ("unfused captured", False)):
            print(f"engine {label}:")
            m = PatchworkPP(p, capacity=CAPACITY, device=dev, fused=fused)
            m.estimate_ground(scans[0])  # builds and captures, outside the trace
            cf = _all_captured(m, label)[0]
            record["profile"][label] = profile_frames(
                lambda st, x, k: (st, cf(x, k)), None, xs_dev, npts, n=min(5, len(scans)))
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
