"""BENCHMARK.json against the benchmark's contract, and every file it leads
to: names, units, keys, the configurations' files, the traffic files and
their drivers, the metric readers and the limits of every cell."""

import ast
import json
import math
import os
import re

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
HERE = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_token")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and p != "benchmarks"
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells, 14 runs each, fits in 43200 seconds
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_keys(bench):
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in bench[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert _line(e["why"])
    for e in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in bench["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in bench["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(e["layer"])
    setup = [e for e in bench["end_to_end"] if e["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25


def test_configs_match_their_files(bench):
    files = set()
    for c in bench["configs"]:
        assert _line(c["source"]) and c["file"].startswith("portbench/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
        assert conf["precision"]["models"] == "float64"
        # the reference builds the tables at the sizes and by the rules
        # the file states
        for sp in ("dm", "star"):
            assert {k: type(v) for k, v in conf["speed_tables"][sp].items()
                    } == {"rows": int, "n_s": int, "n_q": int}
        assert all(conf[k] for k in ("df", "tables", "draws"))
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells_and_their_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        _, _, _, traffic, limits = harness.cell_of(ROOT, w["name"])
        assert os.path.exists(os.path.join(HERE, "drivers",
                                           traffic["entry"] + ".py"))
        assert traffic["check_within"] <= traffic["trace_calls"]
        assert limits["limits"]
        for key, lim in limits["limits"].items():
            assert lim["limit"] > 0 and lim["lower"] < lim["limit"]
            assert lim["upper"] >= 3 * lim["lower"] or lim["lower"] == 0
            assert lim["limit"] < lim["upper"]
        reported = harness.metrics_for(bench, w, False)
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2
        assert harness.metrics_for(bench, w, True)


def test_every_metric_has_a_reader_and_moves_a_metric_of_its_cells(bench):
    e2e = {e["name"]: e for e in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells
            assert "workloads" not in moved or w in moved["workloads"]
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_readers_import_nothing_of_the_port():
    for sub in ("metrics", "reference", "yardstick", "traffic_gen"):
        for name in os.listdir(os.path.join(HERE, sub)):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(HERE, sub, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for mod in mods:
                    assert mod.split(".")[0] not in (
                        "cluster_generator_tpu", "cluster_generator_tpu_torch",
                        "jax", "jaxlib", "flax"), (sub, name, mod)


def test_run_seconds_leaves_tails_enough_samples(bench):
    # the slowest cell's batches (about 70-80 ms) give some tens of calls
    # beyond the 95th percentile in one window
    assert math.floor(bench["run_seconds"] / 0.08 * 0.05) >= 10
