"""BENCHMARK.json against the contract, and every configuration, mix,
cell and metric found by name: a new one is new files and entries only."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from perfbench import specs
from perfbench.traffic import Mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return specs.load_benchmark(ROOT)


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert bench["paths"] == ["perfbench"]
    assert len(json.dumps(bench)) < 64 * 1024
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:  # each cell it lists reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_is_whole(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(names)
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = specs.load_cell(w["name"], bench=bench)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(specs.metric_reader(m["name"]))
        assert cell.check["limits"] and int(cell.check["tune_trials"]) > 0
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used and c["file"].startswith("perfbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for key in c["reduced"]:  # a cut of depth, never of a width
            assert key in cfg["published"] and not key.endswith(("_size", "_dim", "_rank"))
        assert os.path.exists(os.path.join(BENCH, "references", f"{cfg['reference']}.py"))


def test_a_new_configuration_mix_cell_and_metric_are_found_by_name(tmp_path, bench):
    """A copy of the benchmark grows by new files and new entries; no file
    that was there changes, and the new ones are found by their names."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("_state", "tests"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    new_cfg = json.loads((root / "perfbench/configs/qwen2-72b.json").read_text())
    new_cfg.update(name="qwen2-72b-tiny", num_hidden_layers=2)
    (root / "perfbench/configs/qwen2-72b-tiny.json").write_text(json.dumps(new_cfg))
    mix = json.loads((root / "perfbench/traffic/long-prompt.json").read_text())
    mix.update(name="short-chat", batch=16, gen_tokens=64, bucket=256,
               prompt_len={"dist": "lognormal", "median": 1020, "sigma": 1.0,
                           "low": 64, "high": 256})
    (root / "perfbench/traffic/short-chat.json").write_text(json.dumps(mix))
    (root / "perfbench/cells/qwen2-72b-tiny.short-chat.json").write_text(json.dumps(
        {"name": "qwen2-72b-tiny.short-chat", "tune_trials": 4, "check_requests": 2,
         "limits": {"widest_gap": 0.1}}))
    (root / "perfbench/metrics/requests_s.py").write_text(
        "def read(ctx):\n    return sum(len(b.lens) for b in ctx.batches) / ctx.window_s\n")
    grown = json.loads(json.dumps(bench))
    grown["configs"].append({"name": "qwen2-72b-tiny", "source": new_cfg["source"],
                             "file": "perfbench/configs/qwen2-72b-tiny.json",
                             "reduced": ["num_hidden_layers"], "why": "a test"})
    grown["workloads"].append({"name": "qwen2-72b-tiny.short-chat", "config": "qwen2-72b-tiny",
                               "traffic": "short-chat", "chips": 1, "why": "a test"})
    grown["end_to_end"].append({"name": "requests_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["qwen2-72b-tiny.short-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(grown))
    cell = specs.load_cell("qwen2-72b-tiny.short-chat", root=str(root),
                           bench_dir=str(root / "perfbench"))
    assert cell.config["num_hidden_layers"] == 2 and cell.traffic["batch"] == 16
    assert Mix.from_file(cell.traffic).draw(1, 0, 100).prompts.shape == (16, 256)
    assert cell.check["limits"]["widest_gap"] == 0.1
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "requests_s"}
    read = specs.metric_reader("requests_s", bench_dir=str(root / "perfbench"))

    class Ctx:
        window_s = 2.0
        batches = [type("B", (), {"lens": [1, 2, 3]})()]

    assert read(Ctx) == 1.5
    # the old cells still read the same files, untouched
    assert specs.load_cell("qwen2-72b.long-prompt", root=str(root),
                           bench_dir=str(root / "perfbench")).traffic["gen_tokens"] == 16
    after = {p: p.read_bytes() for p in before}
    assert after == before
