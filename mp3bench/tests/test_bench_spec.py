"""BENCHMARK.json against the contract, and every file it names found by
name; a new cell, traffic mix and metric found without editing a file."""
import json
import os
import re
import shutil
import subprocess
import sys

from mp3bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.spec()


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "mp3bench/run.py"]
    assert BENCH["paths"] == ["mp3bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    for x in every:
        assert NAME.match(x["name"]), x["name"]
        for k in ("why", "layer", "source"):
            if k in x:
                assert 1 <= len(x[k]) <= 200 and "\n" not in x[k] \
                    and "\t" not in x[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs_files_and_cells():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("mp3bench/")
        conf = harness.load_json(harness.ROOT, c["file"])
        assert conf["source"] == c["source"] and conf["reduced"] == \
            c["reduced"] == []
        assert list(conf["limits"])[:2] == ["bad_frames", "mismatch_ppm"]
        assert set(conf["limits"]) <= {"bad_frames", "mismatch_ppm",
                                       "silenced_pct", "unspent_pct"}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1


def test_metrics_reported_by_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        reports = [m for m in BENCH["end_to_end"]
                   if c in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reports] and len(reports) > 1
        assert any(c in m["workloads"] for m in BENCH["per_layer"])


def test_every_file_loads_by_name():
    for w in BENCH["workloads"]:
        work, config, traffic = harness.cell(BENCH, w["name"])
        assert config["name"] == work["config"]
        assert callable(harness.entry(traffic["entry"]).make)
    for m in BENCH["per_layer"]:
        assert callable(harness.load_file("metrics", m["name"]).read)


def test_a_new_cell_traffic_and_metric_need_no_edit(tmp_path):
    """A copy of the benchmark with one more traffic file, metric file
    and entries in BENCHMARK.json finds them; no file that was there
    changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "mp3bench"),
                    root / "mp3bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "mp3bench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    tr = json.load(open(root / "mp3bench/traffic/spots.json"))
    tr["job_seconds"] = [5, 7]
    (root / "mp3bench/traffic/news.json").write_text(json.dumps(tr))
    (root / "mp3bench/metrics/l12.jobs_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.jobs)\n")
    bench["workloads"].append(dict(name="l2-dab-192k.news",
                                   config="l2-dab-192k", traffic="news",
                                   chips=1, why="news bulletins"))
    bench["per_layer"].append(dict(
        name="l12.jobs_traced", unit="jobs", better="higher",
        source="program_counter", layer="drivers: encoder.py",
        moves="audio_rtf", workloads=["l2-dab-192k.news"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from mp3bench import harness; b = harness.spec(); "
            "w, c, t = harness.cell(b, 'l2-dab-192k.news'); "
            "m = harness.load_file('metrics', 'l12.jobs_traced'); "
            "print(t['job_seconds'], m.read(type('C', (), {'jobs': 3})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[5,", "7]", "3.0"]
    for p, data in before.items():
        assert p.read_bytes() == data
