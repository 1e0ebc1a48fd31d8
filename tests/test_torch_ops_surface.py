"""The port's public op surface and its packaging, against the JAX package's.

- ``ops.moment_features`` equals the JAX function bit for bit (products
  only), with the shape check of tests/test_ops.py:test_moment_features_shape.
- ``ops.masked_patch_moments`` equals the jitted and the op-by-op JAX
  function bit for bit (XLA:CPU's scatter-add adds a segment's rows in
  point order; the port adds them in that order on every device), on
  sorted and unsorted ids with some outside [0, num_segments).
- ``ops.SPAD`` is the JAX package's.
- ``pyproject.toml`` ships every source under ``patchworkpp_tpu_torch/csrc``
  (the loader's ``.cpp`` too), declares the ``torch`` extra and eight
  ``ppk-torch-*`` console scripts whose ``module:function`` resolves, and
  keeps the JAX package's eight ``ppk-*`` scripts as they were. No build
  is needed.
"""

from __future__ import annotations

import fnmatch
import importlib
from pathlib import Path

import pytest

pytest.importorskip("torch")
tomllib = pytest.importorskip("tomllib")  # Python 3.11+

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from patchworkpp_tpu.ops import SPAD as J_SPAD  # noqa: E402
from patchworkpp_tpu.ops import masked_patch_moments as j_masked_patch_moments  # noqa: E402
from patchworkpp_tpu.ops import moment_features as j_moment_features  # noqa: E402
from patchworkpp_tpu_torch.ops import SPAD, masked_patch_moments, moment_features  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PYPROJECT = tomllib.loads((ROOT / "pyproject.toml").read_text())

# The JAX package's console scripts, as they stand (pyproject.toml)
JAX_SCRIPTS = {
    "ppk-demo-visualize": "patchworkpp_tpu.cli.demo_visualize:main",
    "ppk-demo-sequential": "patchworkpp_tpu.cli.demo_sequential:main",
    "ppk-eval": "patchworkpp_tpu.cli.eval_semantickitti:main",
    "ppk-stream-bench": "patchworkpp_tpu.cli.stream_bench:main",
    "ppk-demo-multi-stream": "patchworkpp_tpu.cli.demo_multi_stream:main",
    "ppk-bench": "patchworkpp_tpu.cli.bench:main",
    "ppk-soak": "patchworkpp_tpu.cli.soak:main",
    "ppk-serve-bench": "patchworkpp_tpu.cli.serve_bench:main",
}
TORCH_SCRIPTS = sorted(k for k in PYPROJECT["project"]["scripts"] if k.startswith("ppk-torch-"))


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def test_moment_features_shape_and_bits():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(128, 3)).astype(np.float32)
    f = moment_features(torch.from_numpy(q)).numpy()
    assert f.shape == (128, 10)
    np.testing.assert_allclose(f[:, 0], 1.0)
    np.testing.assert_allclose(f[:, 4], q[:, 0] ** 2, rtol=1e-6)
    want = np.asarray(jax.jit(j_moment_features)(jnp.asarray(q)))
    np.testing.assert_array_equal(_bits(f), _bits(want))


@pytest.mark.parametrize("points,segments,ids_sorted", [
    (128, 8, True), (4096, 64, True), (4096, 64, False), (20000, 505, True)])
@pytest.mark.parametrize("jitted", [True, False], ids=["jit", "eager"])
def test_masked_patch_moments_matches_jax(points, segments, ids_sorted, jitted):
    rng = np.random.default_rng(points + segments)
    q = (rng.normal(size=(points, 3)) * 3.0).astype(np.float32)
    mask = rng.random(points) < 0.7
    pid = rng.integers(-2, segments + 2, points).astype(np.int32)  # some dropped
    if ids_sorted:
        pid = np.sort(pid)
    fn = (jax.jit(j_masked_patch_moments, static_argnums=(3, 4)) if jitted
          else j_masked_patch_moments)
    want = np.asarray(fn(jnp.asarray(q), jnp.asarray(mask), jnp.asarray(pid), segments,
                         ids_sorted))
    got = masked_patch_moments(torch.from_numpy(q), torch.from_numpy(mask),
                               torch.from_numpy(pid), segments, ids_sorted).numpy()
    assert got.shape == want.shape == (segments, 10)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_spad_is_the_jax_constant():
    assert SPAD == J_SPAD == 512


def test_every_port_source_is_package_data():
    globs = PYPROJECT["tool"]["setuptools"]["package-data"]["patchworkpp_tpu_torch"]
    files = sorted(p.relative_to(ROOT / "patchworkpp_tpu_torch").as_posix()
                   for p in (ROOT / "patchworkpp_tpu_torch" / "csrc").rglob("*")
                   if p.is_file())
    assert "csrc/loader.cpp" in files and "csrc/fit_grid.cu" in files
    missing = [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, f"not in the wheel: {missing}"


def test_torch_extra_is_declared():
    assert "torch" in PYPROJECT["project"]["optional-dependencies"]["torch"]


def test_jax_console_scripts_unchanged():
    scripts = PYPROJECT["project"]["scripts"]
    assert {k: v for k, v in scripts.items() if not k.startswith("ppk-torch-")} == JAX_SCRIPTS


def test_port_has_a_console_script_for_each_jax_one():
    assert TORCH_SCRIPTS == sorted(k.replace("ppk-", "ppk-torch-", 1) for k in JAX_SCRIPTS)


@pytest.mark.parametrize("name", TORCH_SCRIPTS)
def test_torch_console_script_resolves(name):
    target = PYPROJECT["project"]["scripts"][name]
    module, func = target.split(":")
    assert module.startswith("patchworkpp_tpu_torch.cli.")
    jax_module = JAX_SCRIPTS[name.replace("-torch", "", 1)].split(":")[0]
    assert module.replace("_torch", "", 1) == jax_module
    assert callable(getattr(importlib.import_module(module), func))
