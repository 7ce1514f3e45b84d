"""The harness finds every cell, configuration, traffic mix, metric and
reference that ``BENCHMARK.json`` names, by name; and a new cell with a
new traffic mix and a new metric takes only new files and new entries."""
import json
import re
import shutil

import pytest

from bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["arch"] and c.traffic["clients"] > 0
    assert c.end_to_end and c.per_layer
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
    assert callable(harness.reference(c.config["reference"]).logits)
    entry = {x["name"]: x for x in BENCH["configs"]}[c.workload["config"]]
    assert sorted(entry["reduced"]) == sorted(c.config["reduced"])


def test_names_and_entries_keep_the_contract():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves and "bound" not in m
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_new_cell_takes_only_new_files(tmp_path):
    shutil.copytree(harness.ROOT / "bench", tmp_path / "bench")
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    (tmp_path / "bench" / "traffic" / "short.json").write_text(json.dumps({
        "loop": "closed", "clients": 8, "max_cache_len": 1024, "block": 16,
        "prompt": {"uniform": [16, 64]}, "output": {"uniform": [8, 16]}}))
    (tmp_path / "bench" / "metrics" / "decode_rows.py").write_text(
        "def read(run):\n    return sum(c['active'] for c in run.decode_calls)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mamba2.short", "config": "mamba2-2.7b",
                               "traffic": "short", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "decode_rows", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "output_tok_s", "workloads": ["mamba2.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.load_cell("mamba2.short", tmp_path)
    assert c.traffic["clients"] == 8
    assert [m["name"] for m in c.per_layer][-1] == "decode_rows"
    run = harness.Run(setup_s=1.0, window_s=1.0, tokens_out=1, ttft_s=[], itl_s=[],
                      steps=[], prefill_calls=[], decode_calls=[{"active": 3}],
                      counters={}, config=c.config)
    assert harness.metric_reader("decode_rows", tmp_path).read(run) == 3
    for p, data in before.items():
        assert p.read_bytes() == data
