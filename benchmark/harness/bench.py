"""One run of one cell: the tables from the seed, the session, the warm-up,
the closed-loop window through `DataFrame.collect()`, the metrics, and
the comparison of every query's rows with the plain reference.

Everything a cell is made of is found by name under benchmark/:
`BENCHMARK.json` names the cell's configuration, traffic and metrics;
`configs/<file>` holds the configuration, `mixes/<traffic>.json` the mix,
`queries/<query>.py` each query, `metrics/<metric>.py` each metric's
reader. Adding a cell, a mix, a query or a metric adds files and entries
and edits none:

- a mix names its queries, and may set `clients` (closed-loop streams at
  once, 1 by default) and `options` ({query: {key: value}}, added to each
  of the query's drawn parameters);
- a configuration may name by file (relative to benchmark/) its
  `generator` (a module with a `Generator` like harness/tpch.py's) and
  its `setup` (a module with `set_up(cfg, queries, seed, device, log)`
  returning a `QueryContext` and the tables' row counts, in place of
  the resident tables of `set_up_resident`), and turn off
  `prune_scans`;
- a query file may bring the columns and tables it adds (its `COLUMNS`
  and `ROWS`, see harness/tpch.py);
- a metric split by a dot (`rows_per_s.join`, `query_ms.q3`) is read by
  the reader of the part before the dot, unless it has a file of its
  own; every reader gets the metric's name.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import random
import sys
import threading
import time
import traceback
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent                                  # the checkout
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_rapids_tpu")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module_name(prefix: str, name: str) -> str:
    return prefix + "".join(ch if ch.isalnum() else "_" for ch in name)


class Spec:
    """BENCHMARK.json and what its names lead to."""

    def __init__(self, root: Path = ROOT, bench: Optional[dict] = None):
        self.root = root
        self.bench = bench if bench is not None else json.loads(
            (root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace 0) or per-layer metrics
        (trace 1): those that list it, or list no cells."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def query_module(name: str) -> ModuleType:
    return load_module(HERE / "queries" / f"{name}.py",
                       _module_name("bench_q_", name))


def metric_module(name: str) -> ModuleType:
    """The reader of metric `name`: metrics/<name>.py, else the reader of
    the name's part before its first dot."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, _module_name("bench_m_", path.stem))


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})


class Schedule:
    """One client's query stream, as TPC-H's power test has it: rounds,
    each a permutation of the mix's queries drawn from the seed, every
    query with substitution parameters of its own drawn from the seed
    (clause 2.4.x.3), plus the mix's options for it. The warm-up runs each
    query once with a draw of its own, apart from the window's, so the
    window meets literals its plans have not run, as a user's stream
    does."""

    def __init__(self, seed: int, queries: Dict[str, ModuleType],
                 options: Optional[Dict[str, dict]] = None,
                 client: int = 0):
        self.queries = queries
        self.options = options or {}
        self._params = random.Random(f"{seed}:{client}:parameters")
        self._order = random.Random(f"{seed}:{client}:order")
        warm = random.Random(f"{seed}:warm-up")
        self.warm = [(q, self._draw(q, warm)) for q in sorted(queries)]

    def _draw(self, name: str, rng: random.Random) -> dict:
        return {**self.queries[name].draw(rng),
                **self.options.get(name, {})}

    def round(self):
        names = sorted(self.queries)
        self._order.shuffle(names)
        return [(q, self._draw(q, self._params)) for q in names]


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile by linear interpolation between ranks (numpy's
    default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    at = (len(xs) - 1) * p / 100.0
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def scanned_rows(module: ModuleType, counts: Dict[str, int]) -> int:
    return sum(counts[t] for t in module.SCANS)


class Observation:
    """What a run observed, for the metric readers: the set-up seconds,
    the window's queries (name, params, seconds, rows scanned), its
    length, the trace, and each reader's own state."""

    def __init__(self):
        self.setup_s = 0.0
        self.queries: List[SimpleNamespace] = []
        self.window_s = 0.0
        self.trace = None
        self.state: Dict[str, object] = {}

    @property
    def completed(self) -> List[SimpleNamespace]:
        return [q for q in self.queries if q.ok]


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: Spec, cell: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             config: Optional[dict] = None, log=sys.stderr) -> dict:
    """One run of `cell`; returns the result's fields (the caller prints
    them). `config` replaces the configuration file's content (the tests
    run a tiny scale factor on the CPU)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    w = spec.workload(cell)
    cfg = config if config is not None else spec.config(w["config"])
    traffic = mix(w["traffic"])
    queries = {q: query_module(q) for q in traffic["queries"]}
    dev = torch.device(device)
    obs = Observation()
    set_up = load_module(HERE / cfg["setup"], _module_name(
        "bench_s_", cfg["setup"])).set_up if "setup" in cfg \
        else set_up_resident
    qc, counts = set_up(cfg, queries, seed, dev, log)
    scheds = [Schedule(seed, queries, traffic.get("options"), k)
              for k in range(int(traffic.get("clients", 1)))]
    for name, params in scheds[0].warm:
        t0 = time.perf_counter()
        queries[name].build(qc, params).collect()
        print(f"warm-up {name} {time.perf_counter() - t0:.4f} s", file=log)
    sync(dev)
    obs.setup_s = time.perf_counter() - t_start
    print(f"set-up {obs.setup_s:.3f} s: tables {counts}", file=log)

    readers = {m["name"]: metric_module(m["name"])
               for m in spec.metrics(cell, trace)}
    before = _program_counters()
    _window(obs, qc, queries, scheds, counts, seconds,
            readers if trace else None, dev)
    chips = range(int(w["chips"]))
    memory_peak = max(torch.cuda.max_memory_allocated(k) for k in chips) \
        if dev.type == "cuda" else 0
    _log_window(obs, before, log)
    metrics = {}
    for m in spec.metrics(cell, trace):
        value = readers[m["name"]].read(obs, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison, with the program's state freed
    del qc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    found = _compare(obs, queries, cfg, seed, dev, log)
    readings = {"mismatches": found.mismatches, "rel_gap": found.rel_gap}
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in cfg["limits"].items()}
    failed = sum(1 for q in obs.queries if not q.ok)
    correct = failed == 0 and bool(obs.completed) and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(obs.queries),
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu",
                      "count": len(chips),
                      "memory_peak_bytes": int(memory_peak)}}
    if obs.trace is not None and obs.trace.device_ops:
        from .trace import top
        out["device"]["busy_s"] = obs.trace.busy_s()
        out["device"]["window_s"] = obs.trace.window_s
        out["breakdown"] = {
            "device_ops": top(obs.trace.device_time_by_name(), short=True),
            "idle_gaps": top(obs.trace.idle_by_host())}
    out["checks"] = checks
    return out


def generator(cfg: dict, queries: Dict[str, ModuleType], seed: int, dev):
    """The configuration's tables of `seed` on `dev`: its `generator`
    module's (harness/tpch.py's by default), with the columns and tables
    the queries add (the first query in the mix that adds one makes
    it)."""
    from . import tpch
    columns: Dict[str, object] = {}
    rows: Dict[str, object] = {}
    for mod in queries.values():
        for k, v in getattr(mod, "COLUMNS", {}).items():
            columns.setdefault(k, v)
        for k, v in getattr(mod, "ROWS", {}).items():
            rows.setdefault(k, v)
    cls = load_module(HERE / cfg["generator"], _module_name(
        "bench_g_", cfg["generator"])).Generator if "generator" in cfg \
        else tpch.Generator
    return cls(seed, cfg["scale_factor"], dev, columns, rows)


def set_up_resident(cfg: dict, queries: Dict[str, ModuleType], seed: int,
                    dev, log):
    """The tables on `dev`, their batches and the session: (a
    QueryContext, the tables' row counts). Only the columns the queries
    read are made; each table is cut at the session's
    spark.rapids.sql.batchSizeBytes."""
    from spark_rapids_tpu_torch.api.session import TpuSession

    from . import query, tables
    t0 = time.perf_counter()
    session = TpuSession(dict(cfg.get("confs", {})), device=dev)
    columns = [c for mod in queries.values() for cs in mod.TABLES.values()
               for c in cs]
    gen = generator(cfg, queries, seed, dev)
    builder = tables.TableBuilder(gen, cfg["money"], cfg["encoded"],
                                  int(session.conf.batch_size_bytes))
    batches = {t: builder.batches(t, cs)
               for t, cs in gen.columns_by_table(columns).items()}
    counts = {t: gen.num_rows(t) for t in batches}
    sync(dev)
    print(f"set-up: tables {time.perf_counter() - t0:.3f} s, batches "
          f"{ {t: len(b[0]) for t, b in batches.items()} }", file=log)
    return query.QueryContext(session, batches, cfg["money"],
                              cfg.get("prune_scans", True)), counts


def _window(obs: Observation, qc, queries, scheds: List[Schedule],
            counts: Dict[str, int], seconds: float, readers, dev) -> None:
    """The closed loop: each client (one Schedule each; more than one run
    in threads of their own) runs whole rounds until one ends past
    `seconds`. With `readers` (a traced run) the window runs under
    torch.profiler and each reader's install/finish."""
    import torch
    with contextlib.ExitStack() as stack:
        if readers is not None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            for r in readers.values():
                finish = r.install(obs) if hasattr(r, "install") else None
                if finish is not None:
                    stack.callback(finish)
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(torch.profiler.record_function(
                "bench.window"))

        def span(name):
            return torch.profiler.record_function(name) \
                if readers is not None else contextlib.nullcontext()
        t_w0 = time.perf_counter()
        ends = [t_w0] * len(scheds)

        def client(k: int) -> None:
            t_end = t_w0
            while t_end - t_w0 < seconds:
                for name, params in scheds[k].round():
                    rec = SimpleNamespace(name=name, params=params,
                                          ok=False, rows=None, seconds=None,
                                          scanned=scanned_rows(
                                              queries[name], counts))
                    obs.queries.append(rec)
                    t0 = time.perf_counter()
                    try:
                        with span(f"bench.query.{name}"):
                            rec.rows = queries[name].build(
                                qc, params).collect()
                        rec.ok = True
                    except Exception:  # noqa: BLE001 — counted as failed
                        traceback.print_exc(file=sys.stderr)
                    t_end = time.perf_counter()
                    rec.seconds = t_end - t0
            ends[k] = t_end

        if len(scheds) == 1:
            client(0)
        else:
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(len(scheds))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        obs.window_s = max(ends) - t_w0
    if readers is not None:
        from .trace import from_profiler
        obs.trace = from_profiler(prof)


def _log_window(obs: Observation, before: Dict[str, int], log) -> None:
    """Per query, its times in the window; and any build, capture or cold
    sizing the window met (a stage whose static key holds a literal
    captures a graph for each fresh parameter)."""
    by_query: Dict[str, List[float]] = {}
    for q in obs.completed:
        by_query.setdefault(q.name, []).append(q.seconds)
    for name, secs in sorted(by_query.items()):
        print(f"{name}: {len(secs)} in the window, seconds min "
              f"{min(secs):.4f} median {percentile(secs, 50):.4f} max "
              f"{max(secs):.4f}", file=log)
    for k, v in _program_counters().items():
        if v != before.get(k, 0):
            print(f"in the window: {k} +{v - before.get(k, 0)}", file=log)


def _compare(obs: Observation, queries, cfg: dict, seed: int, dev, log):
    """Every completed query's rows against the plain reference, over
    tables made anew from the seed: a reference.Compared."""
    from . import reference
    t0 = time.perf_counter()
    ref = reference.RefContext(generator(cfg, queries, seed, dev),
                               cfg["money"])
    found = reference.Compared()
    for rec in obs.completed:
        mod = queries[rec.name]
        mod.compare(rec.rows, mod.reference(ref, rec.params), ref, found)
    print(f"reference: {len(obs.completed)} queries compared in "
          f"{time.perf_counter() - t0:.3f} s", file=log)
    if found.first:
        print(f"first mismatch: {found.first}", file=log)
    return found


def _program_counters() -> Dict[str, int]:
    """The port's counters of work that compiles or captures: kernel
    library builds and loads, stage-compiler captures and cold sizings."""
    from spark_rapids_tpu_torch.exec import stage_compiler
    from spark_rapids_tpu_torch.obs import dispatch
    c = stage_compiler.counters()
    return {"graph_captures": int(c["graph_captures"]),
            "cold_sizings": int(c["cold_sizings"]),
            "cache_misses": int(c["cache_misses"]),
            "builds_and_loads": int(dispatch.counters()["traces"])}
