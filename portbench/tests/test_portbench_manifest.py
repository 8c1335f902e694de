"""BENCHMARK.json against the benchmark's contract, and a cell and a
metric added from files alone."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.ROOT
MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*(_dim|_rank)$")


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert _line_ok(c["source"]) and _line_ok(c["why"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.match(key), key
            assert key in data


def test_workloads():
    cells = MANIFEST["workloads"]
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(cells) <= 24
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line_ok(w["why"])
        for kind, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert (harness.BENCH / kind / f"{name}.json").exists()
        driver = json.loads((harness.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (harness.BENCH / "drivers" / f"{driver['driver']}.py").exists()
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def test_end_to_end_metrics():
    e2e = MANIFEST["end_to_end"]
    assert 1 <= len(e2e) <= 16
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
    for w in MANIFEST["workloads"]:
        cell = harness.Cell(MANIFEST, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_per_layer_metrics_report_with_what_they_move():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line_ok(m["layer"]) and m["moves"] in e2e
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_cell_and_a_metric_come_from_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    limit file, a metric reader and manifest entries, and runs the new
    cell without an edit to any file that was there."""
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "portbench"
    config = json.loads((bench / "configs" / "C_maze64_a64.json").read_text())
    config.update(name="C_tiny", num_envs=8, reduced=["num_envs", "grid"])
    config["grid"].update(size=12, num_agents=6, obs_radius=2, max_episode_steps=16)
    (bench / "configs" / "C_tiny.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "random.json").read_text())
    traffic.update(check_within_steps=20, check_envs=4)
    (bench / "traffic" / "random_tiny.json").write_text(json.dumps(traffic))
    (bench / "limits" / "C_tiny.random.json").write_text('{"mismatched_values": 0}')
    (bench / "metrics" / "units_done.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "C_tiny", "source": "test", "file":
                                "portbench/configs/C_tiny.json", "reduced": ["num_envs", "grid"],
                                "why": "test"})
    manifest["workloads"].append({"name": "C_tiny.random", "config": "C_tiny",
                                  "traffic": "random_tiny", "chips": 1, "why": "test"})
    manifest["end_to_end"].append({"name": "units_done", "unit": "steps", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["C_tiny.random"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = (f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "from portbench import harness\n"
            f"assert str(harness.BENCH).startswith({str(tmp_path)!r})\n"
            "cell = harness.Cell(harness.load_manifest(), 'C_tiny.random')\n"
            "ctx = harness.Context(cell, 5, 'cpu', False)\n"
            "run, checks = harness.measure(ctx, 0.2, 0.0)\n"
            "print(json.dumps(harness.result_line(run, checks, False, 'cpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    # The end-to-end metrics that list their cells do not reach the new one.
    assert set(line["metrics"]) == {"setup_s", "units_done"}
    assert line["metrics"]["units_done"]["value"] == line["attempted"]
    assert list(line)[-1] == "checks"


def test_every_file_of_the_benchmark_is_named_from_name_characters():
    for path in harness.BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        assert len(rel) <= 200


def test_benchmark_paths_hold_the_benchmark_alone():
    assert Path(ROOT / "portbench").is_dir()
    assert not (ROOT / "portbench" / "pogema_torch").exists()
