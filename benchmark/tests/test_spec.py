"""BENCHMARK.json against the contract's shape and the files found by name;
a cell added by new files alone is found and runs."""

import json
import re
import shutil

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    assert len(set(w["name"] for w in SPEC["workloads"])) == len(SPEC["workloads"])
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_entry_resolves_to_files():
    for w in SPEC["workloads"]:
        cell = harness.resolve_cell(SPEC, w["name"])
        assert cell.config["model"]["core"]["d_model"] > 0
        assert callable(cell.driver.run)
        assert cell.limits, f"{w['name']} has no limits file"
        e2e, layer = harness.metrics_of(SPEC, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        for reader in harness.readers_of(cell).values():
            assert callable(reader.read)
    for c in SPEC["configs"]:
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_a_cell_of_new_files_is_found(tmp_path):
    """A new configuration, mix, driver, metric and limits, as files and
    entries: nothing that is there is edited."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    base = tmp_path / "benchmark"
    cfg = json.loads((base / "configs" / "spec8.json").read_text())
    cfg["config"]["model"]["core"]["n_layers"] = 2
    (base / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    (base / "traffic" / "dummy-mix.json").write_text(json.dumps({"driver": "dummy", "n": 3}))
    (base / "drivers" / "dummy.py").write_text(
        "from benchmark.harness import Outcome\n"
        "def run(cell, seed, seconds, trace, device='cuda', t0=None):\n"
        "    n = cell.traffic['n']\n"
        "    return Outcome({'dummy_per_s': float(n), 'setup_s': 1.0}, {'n': n}, n, 0, 0,\n"
        "                   [('dummy_err', 0.0, cell.limits['dummy_err'])])\n")
    (base / "metrics" / "dummy_count.py").write_text("def read(ctx):\n    return ctx['n']\n")
    (base / "limits").mkdir(exist_ok=True)
    (base / "limits" / "dummy-cell.json").write_text(json.dumps({"limits": {"dummy_err": 0.5}}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="dummy-cfg",
                                file="benchmark/configs/dummy-cfg.json"))
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy-cfg",
                              "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["dummy-cell"]})
    spec["per_layer"].append({"name": "dummy_count", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "dummy",
                              "moves": "dummy_per_s", "workloads": ["dummy-cell"]})
    cell = harness.resolve_cell(spec, "dummy-cell", tmp_path)
    assert cell.config["model"]["core"]["n_layers"] == 2
    out = cell.driver.run(cell, 1, 1.0, True)
    device = {"platform": "gpu", "kind": "test", "count": 1}
    line = harness.result_line(cell, out, False, device)
    assert line["correct"] and set(line["metrics"]) == {"dummy_per_s", "setup_s"}
    line = harness.result_line(cell, out, True, device, harness.readers_of(cell, tmp_path))
    assert line["metrics"] == {"dummy_count": {"value": 3.0, "unit": "1"}}
