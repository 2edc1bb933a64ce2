"""A configuration, a traffic mix and a metric are found by name; a later change
adds them as files and entries, and edits no file that is there."""

import json
import re
import shutil

from portbench.harness import loader
from portbench.harness.record import Call, Run

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_and_metric_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = loader.cell(w["name"], ROOT)
        assert cell.end_to_end and cell.per_layer and cell.limits
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m).read)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        reporting = [w["name"] for w in bench["workloads"] if w["name"] in m["workloads"]]
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert all("workloads" not in moved or w in moved["workloads"] for w in reporting)


def test_a_new_configuration_mix_and_metric_are_files(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}

    config = json.loads((root / "portbench/configs/swave_1000x1000.json").read_text())
    (root / "portbench/configs/swave_512x512.json").write_text(json.dumps({**config, "shape": [512, 512, 1]}))
    mix = json.loads((root / "portbench/traffic/ldos_map.json").read_text())
    (root / "portbench/traffic/ldos_map_short.json").write_text(json.dumps({**mix, "order": 256}))
    (root / "portbench/metrics/calls_total.py").write_text("def read(run):\n    return len(run.calls)\n")
    (root / "portbench/limits/swave_512x512.ldos_map_short.json").write_text(json.dumps({"ldos_gap": 3e-4}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "swave_512x512", "source": "a test", "file": "portbench/configs/swave_512x512.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "swave_512x512.ldos_map_short", "config": "swave_512x512",
                               "traffic": "ldos_map_short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_total", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "call_ms", "workloads": ["swave_512x512.ldos_map_short"]})
    bench["end_to_end"][0]["workloads"].append("swave_512x512.ldos_map_short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = loader.cell("swave_512x512.ldos_map_short", root)
    assert cell.config["shape"] == [512, 512, 1] and cell.mix["order"] == 256
    assert cell.driver.Driver.__name__ == "Driver" and cell.limits == {"ldos_gap": 3e-4}
    assert [m["name"] for m in cell.per_layer] == ["calls_total"]
    assert {m["name"] for m in cell.end_to_end} == {"call_ms", "peak_mem_gib", "setup_s"}
    run = Run(cell, True, calls=[Call(0.0, 1.0, 1, [])] * 3)
    assert cell.reader(cell.per_layer[0]).read(run) == 3
    assert all(p.read_bytes() == b for p, b in before.items())
