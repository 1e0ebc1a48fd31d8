#!/usr/bin/env python
"""Does XLA:CPU's per-patch sum of the JAX unfused engine depend on the host?

The JAX unfused engine sums per-point features into patches with one f32
HIGHEST dot, ``patchworkpp_tpu/ops/onehot.py:patch_reduce`` (``f32_dot_c0``,
k = points, m = 512 patches). This script runs that function jitted on the
CPU on a seeded (131072,) -> (512, 10) reduce in child processes pinned to
1, 2 and all of the host's CPUs (``os.sched_setaffinity``), and prints how
many of the 5120 sums differ from the all-CPU run. It also prints the
optimized HLO's root instruction: the dot is not fused into a generated
loop (XLA:CPU runs it as a library contraction at run time).

A sum whose bits change with the number of CPUs the process may use has no
fixed order that another program could mirror.

Usage: JAX_PLATFORMS=cpu python scripts/xla_cpu_dot_order.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

CHILD = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from patchworkpp_tpu.ops.onehot import patch_reduce
rng = np.random.default_rng(0)
pid = np.sort(rng.integers(0, 512, 131072)).astype(np.int32)
feats = rng.normal(size=(131072, 10)).astype(np.float32)
fn = jax.jit(lambda p, x: patch_reduce(x, p))
if sys.argv[2] == "hlo":
    hlo = fn.lower(pid, feats).compile().as_text()
    print([l.strip()[:160] for l in hlo.splitlines() if "ROOT" in l and "dot" in l])
np.save(sys.argv[1], np.asarray(fn(pid, feats)))
"""


def run(cpus, out, hlo=False) -> None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run(
        [sys.executable, "-c", CHILD, out, "hlo" if hlo else "-"], check=True, cwd=root,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": root},
        preexec_fn=lambda: os.sched_setaffinity(0, cpus),
    )


def main() -> int:
    every = sorted(os.sched_getaffinity(0))
    with tempfile.TemporaryDirectory() as d:
        ref = os.path.join(d, "all.npy")
        run(set(every), ref, hlo=True)
        base = np.load(ref)
        print(f"{len(every)} CPUs: reference")
        for n in (1, 2):
            if n >= len(every):
                continue
            path = os.path.join(d, f"{n}.npy")
            run(set(every[:n]), path)
            got = np.load(path)
            print(f"{n} CPU(s): {int((got != base).sum())} of {base.size} sums differ "
                  f"from the {len(every)}-CPU run, max |diff| {float(np.abs(got - base).max())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
