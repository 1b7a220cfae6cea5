"""A configuration, a traffic mix and a per-layer metric added as files
only are found by name, and the metrics a cell reports follow
``BENCHMARK.json``."""
import json

from bench_tiny import BENCH, REPO, make_root, run_cell
from benchlib import registry


def test_bench_scratch_parts_added_as_files_are_found(tmp_path):
    root = make_root(tmp_path)
    b = root / "bench"
    (b / "configs" / "scratch-model.json").write_text(json.dumps({"name": "scratch-model"}))
    (b / "traffic" / "scratch-mix.json").write_text(json.dumps({"driver": "serve_closed_loop"}))
    (b / "metrics" / "scratch_metric.x.py").write_text("def read(run):\n    return 42.0\n")
    assert registry.load_json("configs", "scratch-model", bench=b)["name"] == "scratch-model"
    assert registry.load_json("traffic", "scratch-mix", bench=b)["driver"] == "serve_closed_loop"
    assert registry.load_module("metrics", "scratch_metric.x", bench=b).read(None) == 42.0
    assert not (BENCH / "metrics" / "scratch_metric.x.py").exists()


def test_bench_scratch_metric_reaches_a_traced_run(tmp_path):
    root = make_root(tmp_path)
    (root / "bench" / "metrics" / "scratch_rows.py").write_text(
        "def read(run):\n    e = run.engine\n    return e['rows'] if e else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "scratch_rows", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "serving engine, prefill lane",
                               "moves": "output_tokens_per_s",
                               "workloads": ["olmo-tiny.chat-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cell(root, "olmo-tiny.chat-tiny", trace=1)
    assert rc == 0, err
    assert res["metrics"]["scratch_rows"]["value"] > 0
    assert list(res)[-1] == "checks"


def test_bench_cells_report_what_benchmark_json_lists():
    bench = registry.load_benchmark(REPO)
    for w in bench["workloads"]:
        e2e = {m["name"] for m in registry.metrics_of(bench, w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert registry.metrics_of(bench, w, "per_layer"), w["name"]
        for m in registry.metrics_of(bench, w, "per_layer"):
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "configs" / f"{w['config']}.json").is_file()
