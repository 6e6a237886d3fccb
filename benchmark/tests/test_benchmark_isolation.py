"""The benchmark imports neither JAX nor the JAX package, its reference
imports nothing of the port either, and ``BENCHMARK.json`` names only files
that exist under ``benchmark/``."""

import ast
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NO_RUN = {"jax", "jaxlib", "flax", "vibertgrid_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_no_jax_package(path):
    found = set(_top_imports(path)) & NO_RUN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(HERE, "reference"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    found = set(_top_imports(path)) & (NO_RUN | {"vibertgrid_tpu_torch"})
    assert not found, f"{path} imports {found}"


def test_test_files_have_names_of_their_own():
    ours = {f for f in os.listdir(os.path.join(HERE, "tests")) if f.startswith("test_")}
    theirs = set(os.listdir(os.path.join(ROOT, "tests")))
    assert not ours & theirs


def test_benchmark_json_names_what_exists():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert spec["paths"] == ["benchmark"] and spec["command"][1] == "benchmark/run.py"
    cells = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in cells.values())
    for name, w in cells.items():
        cell = json.load(open(os.path.join(HERE, "workloads", name + ".json")))
        assert cell["config"] == w["config"] in configs and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert os.path.isfile(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and os.path.isfile(
            os.path.join(HERE, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for name in cells:  # every cell reports setup_s, another end-to-end metric and a layer's
        own = [m for m in e2e.values() if name in m.get("workloads", [name])]
        assert len(own) >= 2
        assert any(name in m.get("workloads", ()) for m in spec["per_layer"])
