"""`BENCHMARK.json` keeps to its contract, and everything a cell names is
found by name: also a configuration, a traffic mix and a metric added as
new files and entries, with no edit to a file that is there."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.fixture(scope="module")
def bench():
    return manifest.manifest()


def test_manifest_shape(bench):
    assert set(bench) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[section]:
            extra = set(e) - KEYS[section]
            assert not extra and KEYS[section] <= set(e), (section, e)
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert _line(c["source"]) and _line(c["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    metric_names = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))
    assert "setup_s" in metric_names
    # every name a file is made from keeps to the characters of a name
    for root, _dirs, files in os.walk(os.path.join(ROOT, "perfbench")):
        for f in files:
            if "__pycache__" not in root:
                assert PATH.match(os.path.relpath(os.path.join(root, f), ROOT)), f


def test_every_cell_finds_its_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        cell = manifest.find_cell(w["name"])
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert configs[w["config"]]["file"].startswith("perfbench/")
        assert manifest.generator(cell.traffic).make
        assert cell.limits, w["name"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(manifest.metric_reader(m["name"]))
    assert used == set(configs)


def test_reduced_names_every_changed_key(bench):
    """A configuration file's `reduced` explains each key named in the
    manifest's `reduced`, and nothing else was changed from the yaml it
    mirrors."""
    from eggfusion_tpu_torch import config as cfglib

    for c in bench["configs"]:
        doc = manifest.load_json(os.path.join(ROOT, c["file"]))
        assert set(doc["reduced"]) == set(c["reduced"])
        src = cfglib.load_config(os.path.join(ROOT, doc["yaml"]), make_workspace=False).to_plain()
        for k in ("base_config", "data_config"):
            src.pop(k, None)
        changed = {k for k in set(src) | set(doc["config"]) if src.get(k) != doc["config"].get(k)}
        assert changed <= set(c["reduced"]), changed


NEW_METRIC = '''
def read(record):
    return float(len(record["latency_ms"]))
'''


def _tree(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = fh.read()
    return out


def test_new_files_run_with_no_edit(tmp_path):
    """In a copy of the benchmark, a new configuration, traffic mix, metric
    and cell are added as files and manifest entries only; the new cell
    runs (on the CPU, at a small size) and reports the new metric."""
    copy = tmp_path / "co"
    shutil.copytree(os.path.join(ROOT, "perfbench"), copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "eggfusion_tpu_torch"), copy / "eggfusion_tpu_torch")
    os.symlink(os.path.join(ROOT, "native"), copy / "native")
    os.symlink(os.path.join(ROOT, "build"), copy / "build")
    bench = manifest.manifest()
    before = _tree(copy / "perfbench")

    cfg = manifest.load_json(os.path.join(ROOT, "perfbench", "configs", "replica.json"))
    cfg["name"] = "replica_small"
    (copy / "perfbench" / "configs" / "replica_small.json").write_text(json.dumps(cfg))
    traffic = manifest.load_json(os.path.join(ROOT, "perfbench", "traffic", "sway.json"))
    traffic.update(ramp=2, period=4, warm_frames=2)
    (copy / "perfbench" / "traffic" / "short_sway.json").write_text(json.dumps(traffic))
    (copy / "perfbench" / "metrics" / "window.frames.py").write_text(NEW_METRIC)
    (copy / "perfbench" / "limits" / "replica_small.short_sway.json").write_text(json.dumps({"map_mm": 1e9}))
    bench["configs"].append({"name": "replica_small", "source": "a test", "file": "perfbench/configs/replica_small.json",
                             "reduced": ["Dataset"], "why": "a test"})
    bench["workloads"].append({"name": "replica_small.short_sway", "config": "replica_small",
                               "traffic": "short_sway", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "window.frames", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "fps"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    script = (
        "import sys, json, time; sys.path.insert(0, '.');"
        "import torch; torch.set_num_threads(2);"
        "from perfbench.harness import driver;"
        "line, _ = driver.run('replica_small.short_sway', 3, 1e9, True, time.perf_counter(), device='cpu',"
        " scale=0.1, max_frames=2);"
        "print(json.dumps(line))")
    res = subprocess.run([sys.executable, "-c", script], cwd=copy, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["metrics"]["window.frames"]["value"] == 2.0
    assert line["attempted"] == 2 and "map_mm" in line["checks"]
    after = _tree(copy / "perfbench")
    assert {p: after[p] for p in before} == before
    assert set(after) - set(before) == {"configs/replica_small.json", "traffic/short_sway.json",
                                        "metrics/window.frames.py", "limits/replica_small.short_sway.json"}
