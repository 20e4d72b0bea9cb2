"""The control of `correct`: the plain reference put in the program's place
and computed in the precision below the one the configuration states
(float32 for a DOUBLE configuration; DOUBLE, float64 over the decimal
values, for a DECIMAL one), held to the same comparison and limits as a
run holds the program.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--rounds 1]

prints, per seed, the numbers compared and whether the control came out
correct (it must not). It takes the queries of the first `--rounds`
rounds the window of that seed would run, at the cell's own scale factor,
on the card (on the CPU with --device cpu). The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: the precision below each money type's
BELOW = {"DOUBLE": "float32", "DECIMAL": "float64"}


def control_checks(cfg: dict, queries: dict, seed: int, rounds: int,
                   device) -> dict:
    """The control's numbers for one seed: {name: value}."""
    from harness import bench, tables, tpch
    from harness import reference as R
    base = tables.parse_money(cfg["money"])[0]
    sched = bench.Schedule(seed, queries)
    work = [q for _ in range(rounds) for q in sched.round()]
    exact = R.RefContext(tpch.Generator(seed, cfg["scale_factor"], device),
                         cfg["money"])
    low = R.RefContext(exact.gen, cfg["money"], BELOW[base])
    found = R.Compared()
    for name, params in work:
        mod = queries[name]
        got = low_rows(mod, low, params)
        mod.compare(got, mod.reference(exact, params), exact, found)
    return {"mismatches": found.mismatches, "rel_gap": found.rel_gap,
            "first": found.first}


def low_rows(mod, r, params):
    want = mod.reference(r, params)
    return mod.rows(r, want) if hasattr(mod, "rows") else want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import bench
    spec = bench.Spec(ROOT)
    w = spec.workload(args.workload)
    cfg = spec.config(w["config"])
    queries = {q: bench.query_module(q)
               for q in bench.mix(w["traffic"])["queries"]}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        c = control_checks(cfg, queries, seed, args.rounds, args.device)
        c.update(seed=seed, seconds=round(time.perf_counter() - t0, 3),
                 correct=all(c[k] <= v for k, v in cfg["limits"].items()))
        print(json.dumps(c), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
