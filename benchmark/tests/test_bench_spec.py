"""BENCHMARK.json against its contract's form, the harness finding what it
names by file, and the check that nothing of JAX is loaded."""

import copy
import json
import re
import shutil
import subprocess
import sys

import pytest

from harness import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_.\-/]+$")


@pytest.fixture(scope="module")
def spec():
    return bench.Spec()


def test_names_and_units_use_the_permitted_characters(spec):
    b = spec.bench
    names = [c["name"] for c in b["configs"]]
    for w in b["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for m in b["end_to_end"] + b["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for text in [w["why"] for w in b["workloads"]] \
            + [c["source"] for c in b["configs"]] \
            + [m["layer"] for m in b["per_layer"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text, text


def test_every_name_leads_to_a_file(spec):
    b = spec.bench
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and FILE.match(c["file"])
    for w in b["workloads"]:
        for q in bench.mix(w["traffic"])["queries"]:
            mod = bench.query_module(q)
            for attr in ("TABLES", "SCANS", "draw", "build", "reference",
                         "compare"):
                assert hasattr(mod, attr), (q, attr)
    for m in b["end_to_end"] + b["per_layer"]:
        assert hasattr(bench.metric_module(m["name"]), "read"), m["name"]
        moved = m.get("moves")
        if moved:
            e2e = {e["name"]: e for e in b["end_to_end"]}
            assert moved in e2e
            for cell in m.get("workloads", []):
                assert cell in e2e[moved].get("workloads", [cell])


def test_every_file_under_benchmark_is_named_by_name_characters(spec):
    for p in (spec.root / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(spec.root).as_posix()
        assert FILE.match(rel), rel


def test_a_mix_added_by_file_is_found_by_name(tmp_path, monkeypatch):
    shutil.copytree(bench.HERE / "queries", tmp_path / "queries")
    shutil.copytree(bench.HERE / "metrics", tmp_path / "metrics")
    (tmp_path / "mixes").mkdir()
    (tmp_path / "mixes" / "q4only.json").write_text(json.dumps(
        {"queries": ["q4"], "why": "a mix that only a file adds"}))
    monkeypatch.setattr(bench, "HERE", tmp_path)
    assert bench.mix("q4only")["queries"] == ["q4"]
    spec = bench.Spec()
    b = copy.deepcopy(spec.bench)
    b["workloads"].append({"name": "tpch-sf10-dbl.q4only",
                           "config": "tpch-sf10-dbl", "traffic": "q4only",
                           "chips": 1, "why": "test"})
    spec = bench.Spec(spec.root, b)
    cfg = spec.config("tpch-sf10-dbl")
    cfg["scale_factor"] = 0.002
    out = bench.run_cell(spec, "tpch-sf10-dbl.q4only", 1, 1e-6, False,
                         device="cpu", config=cfg)
    assert out["correct"] and out["attempted"] == 1


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of benchmark/'s queries, metrics and mixes that the harness
    reads in place of its own, for a test to add files to."""
    for d in ("queries", "metrics", "mixes"):
        shutil.copytree(bench.HERE / d, tmp_path / d)
    monkeypatch.setattr(bench, "HERE", tmp_path)
    return tmp_path


def tiny_cell(traffic, config="tpch-sf10-dbl", **extra):
    spec = bench.Spec()
    b = copy.deepcopy(spec.bench)
    name = f"{config}.{traffic}"
    b["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": 1, "why": "test"})
    cfg = spec.config(config)
    cfg.update(scale_factor=0.002, **extra)
    return bench.Spec(spec.root, b), name, cfg


NATCOUNT = """
import torch
from harness import tpch

COLUMNS = {
    "c_nationkey": tpch.ColumnDef(
        "customer", "int32", lambda g: g.randint(
            "c_nationkey", 0, 24, g.counts["customer"], torch.int32)),
    "r_regionkey": tpch.ColumnDef(
        "region", "int32", lambda g: torch.arange(
            5, dtype=torch.int32, device=g.device)),
}
ROWS = {"region": lambda sf: 5}
TABLES = {"customer": ["c_custkey", "c_nationkey"],
          "region": ["r_regionkey"]}
SCANS = ("customer", "region")


def draw(rng):
    return {}


def build(q, params):
    F = q.m.F
    return (q.df("customer", TABLES["customer"])
            .join(q.df("region"), left_on="c_nationkey",
                  right_on="r_regionkey")
            .group_by("c_nationkey").agg((F.count(), "n"))
            .sort("c_nationkey"))


def reference(r, params):
    n = torch.bincount(r.col("c_nationkey").long(), minlength=25)
    return [(k, int(n[k])) for k in range(5) if int(n[k])]


def compare(got, want, r, out):
    out.rows(got, want, "natcount")
"""


def test_a_query_adding_a_column_and_a_table_by_file(tree):
    """A query file that brings a column (c_nationkey) and a table (region)
    of its own: the generator makes them, the run is correct."""
    (tree / "queries" / "natcount.py").write_text(NATCOUNT)
    (tree / "mixes" / "nations.json").write_text(json.dumps(
        {"queries": ["natcount"], "why": "a column only a file adds"}))
    spec, cell, cfg = tiny_cell("nations")
    out = bench.run_cell(spec, cell, 4, 1e-6, False, device="cpu",
                         config=cfg)
    assert out["correct"] and out["attempted"] == 1, out["checks"]


def test_a_mix_of_two_clients_by_file(tree):
    """A mix that sets `clients`: two closed-loop streams at once, each
    with a stream of its own."""
    (tree / "mixes" / "two.json").write_text(json.dumps(
        {"queries": ["q19", "q4"], "clients": 2, "why": "two streams"}))
    spec, cell, cfg = tiny_cell("two")
    out = bench.run_cell(spec, cell, 6, 0.3, False, device="cpu",
                         config=cfg)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["attempted"] >= 4 and out["attempted"] % 2 == 0


GENERATOR = """
import torch
from harness import tpch


class Generator(tpch.Generator):
    def _l_tax(self):
        return torch.full((self._n_lines(),), 8, dtype=torch.int64,
                          device=self.device)
"""

SETUP = """
from pathlib import Path
from harness import bench


def set_up(cfg, queries, seed, dev, log):
    Path(cfg["marker"]).write_text("set up")
    return bench.set_up_resident(cfg, queries, seed, dev, log)
"""


def test_a_generator_and_a_set_up_named_by_file(tree):
    """A configuration that names its generator and its set-up by file:
    the run makes its tables with them, and the reference reads the same
    tables."""
    (tree / "gens").mkdir()
    (tree / "gens" / "taxed.py").write_text(GENERATOR)
    (tree / "setups").mkdir()
    (tree / "setups" / "marked.py").write_text(SETUP)
    marker = tree / "marker.txt"
    spec, cell, cfg = tiny_cell("pricing", "tpch-sf10-dec",
                                generator="gens/taxed.py",
                                setup="setups/marked.py",
                                marker=str(marker))
    queries = {"q1": bench.query_module("q1")}
    gen = bench.generator(cfg, queries, 1, "cpu")
    assert int(gen.column("l_tax").min()) == 8
    out = bench.run_cell(spec, cell, 1, 1e-6, False, device="cpu",
                         config=cfg)
    assert out["correct"], out["checks"]
    assert marker.read_text() == "set up"


def test_forbidden_names_compare_the_whole_top_level_name(monkeypatch):
    before = bench.forbidden_modules()
    for name in ("spark_rapids_tpu_torch", "spark_rapids_tpu_torch.exec",
                 "jaxtyping", "jax_free", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert bench.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "spark_rapids_tpu.exec", sys)
    assert "spark_rapids_tpu" in bench.forbidden_modules()


def test_a_run_imports_nothing_of_jax():
    """A whole run on the CPU in a process of its own: nothing it loads has
    the top-level name jax, jaxlib, flax or spark_rapids_tpu."""
    code = f"""
import sys
sys.path[:0] = [{str(bench.ROOT)!r}, {str(bench.HERE)!r}]
from harness import bench
import control
spec = bench.Spec()
cfg = spec.config("tpch-sf10-dbl"); cfg["scale_factor"] = 0.002
out = bench.run_cell(spec, "tpch-sf10-dbl.join", 1, 1e-6, True,
                     device="cpu", config=cfg)
assert out["correct"], out
print(sorted({{k.split(".")[0] for k in sys.modules}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(bench.ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]
                         .replace("'", '"')))
    assert "spark_rapids_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "spark_rapids_tpu"}


def test_run_refuses_without_a_card():
    """benchmark/run.py prints no result and exits non-zero where the cell's
    cards are missing (this machine has none)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "tpch-sf10-dbl.join", "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(bench.ROOT))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
