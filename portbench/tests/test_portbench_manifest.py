"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and a file under ``portbench/`` for every configuration, traffic mix,
cell limit and per-layer metric it names."""
import json
import re
from pathlib import Path

import pytest

from portbench.check import NUMBERS

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")

KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    command, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(command) <= 32
    assert all(TEXT.match(word) for word in command)
    assert 1 <= len(paths) <= 16
    for path in paths:
        assert PATH.match(path) and not path.startswith("/")
        assert ".." not in path.split("/")
        assert not path.endswith("_torch")
    for word in command[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys_and_names(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for entry in MANIFEST[section]:
        allowed = KEYS[section] | ({"workloads"} if section in (
            "end_to_end", "per_layer") else set())
        assert KEYS[section] <= set(entry) <= allowed, entry
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert TEXT.match(entry[key]), entry[key]


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))


def test_configs_have_their_files():
    for config in MANIFEST["configs"]:
        assert config["file"] == f"portbench/configs/{config['name']}.json"
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]
        assert len(config["reduced"]) <= 16
        assert all(NAME.match(k) for k in config["reduced"])
        assert (BENCH / "reference" / f"{data['reference']}.py").is_file()
        assert any(w["config"] == config["name"]
                   for w in MANIFEST["workloads"])


def test_cells_have_their_files():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    for cell in MANIFEST["workloads"]:
        assert cell["config"] in configs
        assert NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
        limits = json.loads((BENCH / "limits" / f"{cell['name']}.json")
                            .read_text())
        numbers = [k for k in limits if k in NUMBERS]
        assert numbers, limits
        assert all(limits[k] > 0 for k in numbers)
        notes = [v for k, v in limits.items() if k not in NUMBERS]
        assert not any(isinstance(v, (int, float)) for v in notes)
        pairs.add((cell["config"], cell["traffic"]))
    assert len(pairs) == len(MANIFEST["workloads"])
    four = sum(c["chips"] == 4 for c in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_metrics_have_readers_and_bounds():
    ends = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in ends
    for metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    cells = {c["name"] for c in MANIFEST["workloads"]}
    layers = {}
    for metric in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
        assert metric["moves"] in ends
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert set(metric.get("workloads", cells)) <= cells
        layers.setdefault(metric["layer"], []).append(metric["name"])
    assert set(layers) == {"harness", "data", "model step", "kernels",
                           "device"}


@pytest.mark.parametrize("cell", [c["name"] for c in MANIFEST["workloads"]])
def test_every_cell_reports_enough(cell):
    ends = [m["name"] for m in MANIFEST["end_to_end"]
            if cell in m.get("workloads", [cell])]
    layers = [m["name"] for m in MANIFEST["per_layer"]
              if cell in m.get("workloads", [cell])]
    assert "setup_s" in ends and len(ends) >= 2
    assert layers


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
