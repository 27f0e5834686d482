"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""
import json
import math
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench(bench_path):
    with open(bench_path) as f:
        return json.load(f)


def _metrics(bench):
    return bench["end_to_end"] + bench["per_layer"]


def test_keys_and_size(bench, bench_path):
    assert set(bench) == TOP
    assert bench_path.stat().st_size <= 64 * 1024
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in _metrics(bench)]
             + [w["traffic"] for w in bench["workloads"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for group in (bench["configs"], bench["workloads"], _metrics(bench)):
        assert len({x["name"] for x in group}) == len(group)
    for m in _metrics(bench):
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in bench["workloads"]]
                 + [c["why"] for c in bench["configs"]]
                 + [c["source"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_sources(bench):
    names = [m["name"] for m in bench["end_to_end"]]
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_run_seconds_fit_the_check_with_24_cells(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_cells_chips_and_what_each_reports(bench, bench_path):
    cells = bench["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert four <= max(1, math.floor(0.25 * len(cells)))
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in cells:
        _, _, _, _, ends, layers = harness.load(bench_path, w["name"])
        reported = {m["name"] for m in ends}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert layers, w["name"]
        for m in layers:
            # the end-to-end metric a per-layer metric moves is reported in
            # every cell that reports the per-layer metric
            assert m["moves"] in e2e and m["moves"] in reported, (w, m)


def test_every_name_has_its_files(bench, bench_path):
    root = bench_path.parent
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        with open(root / c["file"]) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert (root / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (root / "portbench" / "limits" / f"{w['name']}.json").is_file()
    for m in _metrics(bench):
        assert (root / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_shares_are_percent(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%", m
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline"), m
