"""BENCHMARK.json against the benchmark's rules: names, units and their
characters, every entry's keys, the files each name points to, and that
each per-layer metric's cells report the end-to-end metric it moves."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj"
                   r"|head|expansion|experts_per|features|classes|nhid")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()


def test_the_command_names_no_file_outside_the_paths():
    for word in BENCH["command"]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys_names_and_lines(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = set(e) - KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end",
                                                      "per_layer")
                         else set()), (e["name"], extra)
        assert KEYS[section] <= set(e), e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_no_two_names_collide_across_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs_point_to_their_files_and_cut_no_width():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        conf = json.loads(path.read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
            assert key in conf["graph"] and key in conf["source_values"]
            assert conf["graph"][key] != conf["source_values"][key]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_every_config_is_used_and_every_cell_has_its_files():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, math.floor(len(BENCH["workloads"]) / 4))
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


def _cells_reporting(metric):
    cells = [w["name"] for w in BENCH["workloads"]]
    return metric.get("workloads", cells)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in _cells_reporting(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in _cells_reporting(m)
                   for m in BENCH["per_layer"]), w["name"]


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in _cells_reporting(m):
            assert cell in _cells_reporting(moved), (m["name"], cell)
        layers.setdefault(m["layer"], m["layer"])
    known = {"data", "graphed epoch", "train step", "eval", "serve",
             "models", "kernels", "device"}
    assert set(layers) <= known


def test_shares_of_a_roofline_are_named_for_it():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_limits_name_every_number_the_check_compares():
    from benchmark import compare
    doc = compare.__doc__
    for w in BENCH["workloads"]:
        lim = json.loads((ROOT / "benchmark" / "limits"
                          / f"{w['name']}.json").read_text())
        for k, v in lim.items():
            assert k in doc and isinstance(v, (int, float)), (w["name"], k)
