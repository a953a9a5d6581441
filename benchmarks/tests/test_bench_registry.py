"""The harness finds a cell, a configuration, a traffic mix, a generator, a
driver and a metric that are added as new files, without an edit to any
file it already has (BENCHMARK.json gains entries)."""

import json
import os

import benchcopy  # noqa: F401  (puts the repository on sys.path)

from benchmarks import run
from benchmarks.harness import registry

DRIVER = '''
import os
from benchmarks.harness import registry

class Driver:
    def __init__(self, cell, ctx):
        self.cell, self.ctx = cell, ctx

    def setup(self, hook=None):
        gen = registry.load_module("generators", self.cell.traffic["generator"], self.cell.root)
        self.items = gen.generate(self.cell.traffic["params"], self.ctx.seed, self.ctx.work)

    def window(self, seconds, spans=False):
        return {"wall_s": 2.0, "files": [(p, 0.0, 1.0, 3.0) for p in self.items],
                "attempted": len(self.items), "done": len(self.items), "errors": {},
                "timers": {}}

    def release(self):
        pass

    def check(self, windows):
        n = sum(len(w["files"]) for w in windows)
        return [{"name": "items", "value": float(n), "limit": 1, "op": ">="}]
'''

GENERATOR = '''
import os

def generate(params, seed, out_dir):
    out = []
    for i in range(params["n"]):
        p = os.path.join(out_dir, f"item{i}.txt")
        with open(p, "w") as f:
            f.write(str(seed + i))
        out.append(p)
    return out
'''

METRIC = '''
def read(records):
    w = records.get("window")
    return sum(f[3] for f in w["files"]) / w["wall_s"] if w else None
'''


def _add(root, rel, text):
    path = os.path.join(root, rel)
    assert not os.path.exists(path), f"{rel} exists: the test must only add files"
    with open(path, "w") as f:
        f.write(text)


def test_new_files_are_found_by_name(tmp_path):
    root = benchcopy.tiny_copy(str(tmp_path))
    _add(root, "drivers/echo_items.py", DRIVER)
    _add(root, "generators/echo_items.py", GENERATOR)
    _add(root, "metrics/echo.items_per_s.py", METRIC)
    _add(root, "traffic/echo-three.json",
         json.dumps({"generator": "echo_items", "params": {"n": 3}}))
    _add(root, "configs/echo-config.json", json.dumps({"driver": "echo_items"}))
    _add(root, "workloads/echo-cell.json", json.dumps({}))
    spec_path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "echo-config", "source": "https://example.org",
                            "file": "benchmarks/configs/echo-config.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "echo-cell", "config": "echo-config",
                              "traffic": "echo-three", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "echo.items_per_s", "unit": "items/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["echo-cell"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    cell = registry.find_cell("echo-cell", root)
    assert cell.config["driver"] == "echo_items"
    assert cell.traffic["params"] == {"n": 3}
    assert {m["name"] for m in cell.end_to_end} >= {"echo.items_per_s", "setup_s"}
    # metrics listed for other cells do not apply
    assert all("echo-cell" in m.get("workloads", ["echo-cell"]) for m in cell.end_to_end)

    result, checks = run.run_cell("echo-cell", 5, 1.0, False, device="cpu", root=root)
    assert result["correct"] is True
    assert result["metrics"]["echo.items_per_s"] == {"value": 4.5, "unit": "items/s"}
    assert result["metrics"]["setup_s"]["value"] > 0
    assert list(result)[-1] == "checks"
    assert checks == [{"name": "items", "value": 3.0, "limit": 1, "op": ">="}]


def test_every_named_file_exists():
    spec = registry.load_spec()
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(registry.REPO_DIR, c["file"]))
        assert c["file"].startswith(spec["paths"][0] + "/")
    for w in spec["workloads"]:
        cell = registry.find_cell(w["name"])
        registry.load_module("drivers", cell.config["driver"])
        registry.load_module("generators", cell.traffic["generator"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(registry.load_module("metrics", m["name"]).read)
        assert cell.per_layer, f"{w['name']} reports no per-layer metric"
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
