"""The benchmark's files: every cell finds its configuration, traffic and
limits by name, every metric its reader, every configuration holds the
sizes the port runs, and nothing under ``kbench/`` imports JAX or the JAX
package (the references not even the port)."""
from __future__ import annotations

import ast
import dataclasses
import json
import re

import pytest

from kbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KBENCH = harness.KBENCH


def test_the_file_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kbench"]
    assert BENCH["command"] == ["python3", "kbench/run.py"]
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = harness.load_cell(cell, trace=False)
    tenants = c.traffic["tenants"]
    assert len({t["name"] for t in tenants}) == len(tenants)
    want = set()
    for t in tenants:
        assert t["phase"] in ("prefill", "decode")
        want |= {f"{t['name']}.rel", f"{t['name']}.row"}
        if t["phase"] == "decode":
            want.add(f"{t['name']}.state")
            if c.config["reference"] == "dense":
                want.add(f"{t['name']}.changed")
    assert set(c.limits) == want
    e2e = {m["name"] for m, _ in c.metrics}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.load_cell(cell, trace=True)
    assert layer.metrics


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_each_config_holds_the_sizes_the_port_runs(config):
    from repro_torch.configs import get_config
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    arch = get_config(data["arch"])
    fields = {f.name for f in dataclasses.fields(arch)}
    assert set(data["model"]) <= fields
    assert harness.port_config(data) == arch      # nothing cut or changed
    assert (KBENCH / "reference" / f"{data['reference']}.py").exists()


def test_every_metric_has_its_reader():
    workloads = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness._reader(m["name"])), m["name"]
        assert set(m.get("workloads", [])) <= workloads
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _top(name):
    return name.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in KBENCH.rglob("*.py"):
        tops = {_top(n) for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path


def test_the_references_import_nothing_of_the_port():
    seen, todo = set(), ["kbench.reference.dense", "kbench.reference.rwkv6"]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = harness.ROOT / (mod.replace(".", "/") + ".py")
        if not path.exists():
            path = path.with_suffix("") / "__init__.py"
        if not path.exists():          # a name from a module, not a module
            continue
        for name in _imports(path):
            assert _top(name) not in ("repro_torch", "repro", "jax"), \
                (mod, name)
            if _top(name) == "kbench":
                todo.append(name)


def test_importing_the_harness_loads_no_jax():
    import os
    import subprocess
    import sys
    code = (
        "import sys\n"
        "sys.path[:0] = ['kbench']\n"
        "import run\n"
        "run.prepare_environment()\n"
        "from kbench import harness, calibrate\n"
        "import repro_torch.launch.serve\n"
        "for w in ('phi3-mixed', 'rwkv6-mixed', 'phi3-decode-solo'):\n"
        "    for t in (False, True):\n"
        "        harness.load_cell(w, trace=t)\n"
        "bad = run.forbidden_modules()\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(harness.ROOT),
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr
