"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program either. Top-level names are
compared whole: the port's name begins with the JAX package's."""

import ast
import sys

from benchmark import manifest as mf
from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "patchworkpp_tpu"}
PROGRAM = "patchworkpp_tpu_torch"


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in mf.HERE.rglob("*.py") if "tests" not in p.parts]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {p.name: sorted(set(_imported(p)) & FORBIDDEN) for p in _sources()}
    assert not any(found.values()), found


def test_the_reference_imports_nothing_of_the_program():
    ref = [p for p in _sources() if "reference" in p.parts]
    assert ref
    for p in ref:
        assert not (set(_imported(p)) & (FORBIDDEN | {PROGRAM})), p
    # and nothing the reference itself imports from the benchmark reaches it
    for p in ref:
        for name in _imported(p):
            assert name in {"__future__", "dataclasses", "math", "typing", "numpy",
                            "benchmark"}, (p, name)


def test_the_program_is_imported_only_by_the_system_module():
    users = [p.name for p in _sources() if PROGRAM in set(_imported(p))]
    assert users == ["system.py"]


def test_the_run_compares_whole_top_level_names(monkeypatch):
    fake = dict(sys.modules)
    fake.pop("jax", None)
    fake["patchworkpp_tpu_torch.models"] = sys
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["patchworkpp_tpu.ops"] = sys
    assert run.forbidden_modules() == ["patchworkpp_tpu"]
