"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files in a copy of the benchmark, and the harness runs the new cell
and reads the new metric with no file of the copy edited."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from portbench import harness
cell = harness.load_cell("chol-tiny-new")
run, line = harness.execute(cell, seed=2**31 + 3, seconds=0.2, trace=True,
                            device="cpu")
print(json.dumps({"line": line, "harness": harness.__file__,
                  "forbidden": harness.forbidden_loaded()}))
"""


def test_new_cell_config_mix_and_metric_are_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "cholesky-n7680-b192-f64.json")
                      .read_text())
    conf.update(name="cholesky-tiny", n=96, tile=32,
                reduced=conf["reduced"] + ["n"])
    (pb / "configs" / "cholesky-tiny.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "factor-closed1.json").read_text())
    mix.update(pool=2, sample=2, traced=1)
    (pb / "traffic" / "factor-closed2.json").write_text(json.dumps(mix))
    limits = json.loads((pb / "workloads" / "chol-n7680-compiled.json")
                        .read_text())["limits"]
    (pb / "workloads" / "chol-tiny-new.json").write_text(json.dumps(
        {"config": "cholesky-tiny", "traffic": "factor-closed2", "chips": 1,
         "why": "a tiny cell added as files", "limits": limits}))
    (pb / "metrics" / "factorizations.tiny.py").write_text(
        "def read(rec):\n    return rec.facts.get('factorizations')\n")
    # BENCHMARK.json is not under paths: a later PR adds its entries there
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "chol-tiny-new",
                              "config": "cholesky-tiny",
                              "traffic": "factor-closed2", "chips": 1,
                              "why": "a tiny cell added as files"})
    spec["end_to_end"][0]["workloads"].append("chol-tiny-new")
    spec["per_layer"].append({"name": "factorizations.tiny", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "Compiled driver",
                              "moves": "factor_gflops",
                              "workloads": ["chol-tiny-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(root),
                          str(harness.ROOT / "src")], capture_output=True,
                         text=True, env=env, timeout=240, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(res["harness"]).resolve().parent == pb.resolve()
    assert res["forbidden"] == []
    line = res["line"]
    assert line["correct"], line["checks"]
    assert line["metrics"]["factorizations.tiny"]["value"] >= 1
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, f"{p} was edited"
