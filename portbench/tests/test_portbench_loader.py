"""The harness finds configurations, traffic, scenes, drivers and metrics
by the names in BENCHMARK.json, and the file keeps to its contract."""

import json
import os
import re

import pytest

from portbench.core import loader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return loader.benchmark()


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cfg = loader.config(w["config"])
        traffic = loader.traffic(w["traffic"])
        assert cfg["name"] == w["config"]
        drv = loader.plugin("drivers", cfg["driver"])
        for attr in ("Driver", "records", "Reference", "compare"):
            assert hasattr(drv, attr)
        assert hasattr(loader.plugin("scenes", traffic["scene"]), "make")
        assert callable(loader.plugin("pacing", traffic["pacing"]).run)
        assert cfg["limits"] and set(cfg["limits"]) <= set(drv.NUMBERS)
        if cfg["driver"] == "multistream":
            # The track, the means, the green trace and one BPM number.
            assert {"track_px", "means_gap", "green_gap"} <= \
                set(cfg["limits"])
            assert len({"bpm_pct", "bpm_stage_pct"}
                       & set(cfg["limits"])) == 1


def test_every_metric_has_a_reader(bench):
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert callable(loader.plugin("metrics", m["name"]).read)


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics_of_a_cell(bench, section):
    for w in bench["workloads"]:
        got = [m["name"] for m in loader.metrics_of(bench, w["name"],
                                                    section)]
        assert got
        if section == "end_to_end":
            assert "setup_s" in got and len(got) >= 2


def test_unknown_names_raise(bench):
    with pytest.raises(KeyError):
        loader.cell(bench, "no-such-cell")
    with pytest.raises(KeyError):
        loader.config("no-such-config")
    with pytest.raises(KeyError):
        loader.plugin("metrics", "no-such-metric")


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert os.path.exists(os.path.join(loader.ROOT, c["file"]))
        assert c["file"].startswith(bench["paths"][0] + "/")
        with open(os.path.join(loader.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        assert loader.metrics_of(bench, cell, "per_layer")
