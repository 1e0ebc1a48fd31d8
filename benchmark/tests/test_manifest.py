"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json

import pytest

from benchmark import manifest as mf

CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.fixture
def man(root):
    return mf.load_manifest(root)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert 1 <= len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    assert man["paths"] == ["benchmark"]


def test_names_and_units_use_allowed_characters(man):
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]] \
        + [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["config"] for w in man["workloads"]] + [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    assert all(mf.NAME_RE.match(n) for n in names), names
    units = [m["unit"] for m in man["end_to_end"] + man["per_layer"]]
    assert all(mf.UNIT_RE.match(u) for u in units), units
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in man[group]}) == len(man[group])
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entries_have_just_their_keys(man):
    assert all(set(c) == CONFIG_KEYS and _line(c["why"]) and _line(c["source"])
               for c in man["configs"])
    assert all(set(w) == WORKLOAD_KEYS and _line(w["why"]) and w["chips"] in (1, 4)
               for w in man["workloads"])
    assert all(set(m) <= E2E_KEYS and m["better"] in ("lower", "higher")
               and m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
               for m in man["end_to_end"])
    assert all(set(m) <= LAYER_KEYS and m["better"] in ("lower", "higher") and _line(m["layer"])
               and m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
               for m in man["per_layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(man):
    for w in man["workloads"]:
        e2e = {m["name"] for m in mf.metrics_of(man, w["name"], traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert mf.metrics_of(man, w["name"], traced=True), w["name"]


def test_each_per_layer_metric_moves_an_end_to_end_metric_of_each_of_its_cells(man):
    for m in man["per_layer"]:
        for w in m.get("workloads", [x["name"] for x in man["workloads"]]):
            e2e = {x["name"] for x in mf.metrics_of(man, w, traced=False)}
            assert m["moves"] in e2e, (m["name"], w)


def test_named_files_exist(man, root):
    cfg_names = {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        assert c["file"].startswith("benchmark/")
        data = json.loads((root / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    for w in man["workloads"]:
        assert w["config"] in cfg_names
        assert (mf.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        limits = mf.limits(w["name"])
        assert set(limits) == {"label_mismatch", "plane_mismatch", "height_gap",
                                  "flatness_gap", "buffer_gap"}
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(mf.reader(m["name"]))
    assert {c["name"] for c in man["configs"]} == {w["config"] for w in man["workloads"]}


def test_the_whole_check_fits_its_time(man):
    cells = 24  # what later PRs may grow to
    runs = 2 + 14 * cells
    assert runs * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(man)) <= 64 * 1024
