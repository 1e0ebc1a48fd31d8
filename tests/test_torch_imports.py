"""The PyTorch port stands alone: no module of patchworkpp_tpu_torch, and
none of chip_smoke.py and the card scripts (scripts/gpu_parity.py,
torch_multiproc_parity.py, frame_graph_probe.py, ks_route_bench.py),
imports jax or the JAX package, and no module of the package imports
chip_smoke.py, a script at the root of the repo that an installed package
does not have (checked on the source with the ast module, since importing
would pull in whatever the interpreter has already loaded)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "patchworkpp_tpu_torch"
FILES = sorted(PACKAGE.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "gpu_parity.py",
    ROOT / "scripts" / "torch_multiproc_parity.py", ROOT / "scripts" / "frame_graph_probe.py",
    ROOT / "scripts" / "ks_route_bench.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(mod: str, path: Path) -> bool:
    top = mod.split(".")[0]
    return (top in ("jax", "jaxlib", "patchworkpp_tpu")
            or (top == "chip_smoke" and PACKAGE in path.parents))


def test_port_has_the_expected_files():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for want in (
        "patchworkpp_tpu_torch/params.py",
        "patchworkpp_tpu_torch/state.py",
        "patchworkpp_tpu_torch/pipeline.py",
        "patchworkpp_tpu_torch/graphs.py",
        "patchworkpp_tpu_torch/ops/tiled_fit.py",
        "patchworkpp_tpu_torch/ops/fit_kernel_grid.py",
        "patchworkpp_tpu_torch/ops/fit_kernel.py",
        "patchworkpp_tpu_torch/ops/sharded_fit.py",
        "patchworkpp_tpu_torch/ops/nvcc.py",
        "patchworkpp_tpu_torch/device.py",
        "patchworkpp_tpu_torch/ops/trig.py",
        "patchworkpp_tpu_torch/ops/segments.py",
        "patchworkpp_tpu_torch/ops/moments.py",
        "patchworkpp_tpu_torch/ops/onehot.py",
        "patchworkpp_tpu_torch/models/patchworkpp.py",
        "patchworkpp_tpu_torch/models/presets.py",
        "patchworkpp_tpu_torch/utils/profiling.py",
        "patchworkpp_tpu_torch/utils/roofline.py",
        "patchworkpp_tpu_torch/io/kitti.py",
        "patchworkpp_tpu_torch/io/synthetic.py",
        "patchworkpp_tpu_torch/compat/pypatchworkpp.py",
        "patchworkpp_tpu_torch/serve/server.py",
        "patchworkpp_tpu_torch/serve/multi_stream.py",
        "patchworkpp_tpu_torch/serve/ros2_bridge.py",
        "patchworkpp_tpu_torch/serve/launch.py",
        "patchworkpp_tpu_torch/cli/workload.py",
        "patchworkpp_tpu_torch/cli/bench.py",
        "patchworkpp_tpu_torch/cli/stream_bench.py",
        "patchworkpp_tpu_torch/cli/serve_bench.py",
        "patchworkpp_tpu_torch/cli/soak.py",
        "patchworkpp_tpu_torch/cli/demo_sequential.py",
        "patchworkpp_tpu_torch/cli/demo_multi_stream.py",
        "patchworkpp_tpu_torch/cli/demo_visualize.py",
        "patchworkpp_tpu_torch/cli/eval_semantickitti.py",
        "patchworkpp_tpu_torch/io/native_loader.py",
        "patchworkpp_tpu_torch/oracle/__init__.py",
        "patchworkpp_tpu_torch/oracle/numpy_oracle.py",
        "patchworkpp_tpu_torch/parallel/__init__.py",
        "patchworkpp_tpu_torch/parallel/point_sharded.py",
        "patchworkpp_tpu_torch/parallel/chunked.py",
        "patchworkpp_tpu_torch/parallel/sharded.py",
        "patchworkpp_tpu_torch/parallel/selfcheck.py",
        "chip_smoke.py",
        "scripts/gpu_parity.py",
        "scripts/torch_multiproc_parity.py",
    ):
        assert want in names
    for src in ("fit_grid.cu", "fit_onehot.cu", "fit_program.cuh", "fit_math.cuh", "loader.cpp"):
        assert (ROOT / "patchworkpp_tpu_torch" / "csrc" / src).exists()
    assert (ROOT / "patchworkpp_tpu_torch" / "serve" / "rviz" / "patchworkpp.rviz").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m, path)})
    assert not bad, f"{path.name} imports {bad}"


def test_public_names_cover_the_jax_packages():
    """The port's top-level and ``ops`` ``__all__`` hold every name of the
    JAX package's (``__version__`` included), and each name resolves."""
    pytest.importorskip("torch")
    import patchworkpp_tpu
    import patchworkpp_tpu.ops
    import patchworkpp_tpu_torch
    import patchworkpp_tpu_torch.ops

    for jax_mod, port_mod in ((patchworkpp_tpu, patchworkpp_tpu_torch),
                              (patchworkpp_tpu.ops, patchworkpp_tpu_torch.ops)):
        missing = set(jax_mod.__all__) - set(port_mod.__all__)
        assert not missing, f"{port_mod.__name__} lacks {sorted(missing)}"
        for name in port_mod.__all__:
            assert hasattr(port_mod, name), (port_mod.__name__, name)
    assert patchworkpp_tpu_torch.__version__ == patchworkpp_tpu.__version__
