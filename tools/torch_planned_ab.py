#!/usr/bin/env python3
"""Time the port's planned q3 and TPC-H Q3 on true types (chip_smoke.py's
planned q3 and P19) in two source trees, in turns, on one CUDA card.

    python3 tools/torch_planned_ab.py OLD_ROOT NEW_ROOT [--runs 5]

Each tree runs in its own process (the two trees' packages share their
module names), in the order OLD, NEW, NEW, OLD: the process imports the
tree's chip_smoke.py and spark_rapids_tpu_torch, builds the kernels the
two queries launch, makes their data at full size from chip_smoke's seeds,
collect()s each query once counted (its kernel launches) and then RUNS
times more, one synchronisation a run, holding every result to its
oracle. Prints one JSON line per process and the card's name and power
limit. Needs a CUDA card; runs nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def measure(runs: int) -> dict:
    """One tree's numbers; chip_smoke is the tree's own (on sys.path)."""
    import torch
    import chip_smoke as cs
    from spark_rapids_tpu_torch.kernels import build
    build.build_all([build.csrc_source(name) for name in (
        "murmur3.cu", "probe_verify.cu", "row_gather.cu", "dict_gather.cu")])
    dev = cs.DEVICE
    sm = cs.session_modules()
    sess = sm.session.TpuSession(cs.Q3_CONF, dev)
    d3 = cs.q3_data()
    o_schema, l_schema = cs.q3_schemas("LONG")
    q3 = cs.q3_df(sm, sess, cs.q3_batches(d3, dev, o_schema, cs.Q3_ORDERS),
                  cs.q3_batches(d3, dev, l_schema, cs.Q3_LINES))
    q3_want = cs.q3_oracle(d3)
    dj = cs.tpch_join_data()
    m, b, wants = cs.types_inputs(dev, cs.q19_data(), dj,
                                  cs.q3_types_data(dj))
    p19 = cs.q3_types_df(m, m.session.TpuSession(cs.P19_CONF, dev), b["q3"])
    checks = {"q3": lambda rows: cs.check_q3(rows, q3_want, "q3"),
              "P19": lambda rows: cs.exact_rows(wants["P19"])(rows, "P19")}
    out = {}
    for label, df in (("q3", q3), ("P19", p19)):
        wrappers = cs.kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        rows = df.collect()
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        checks[label](rows)
        ms = []
        for _ in range(runs):
            t0 = time.perf_counter()
            rows = df.collect()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            checks[label](rows)
        out[label] = {"launches": launches, "ms": ms}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("old", type=Path)
    p.add_argument("new", type=Path)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.measure:
        print(json.dumps(measure(args.runs)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_planned_ab: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    me = Path(__file__).resolve()
    for tag, root in (("old", args.old), ("new", args.new),
                      ("new", args.new), ("old", args.old)):
        root = root.resolve()
        res = subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path[:0] = [{str(root)!r}]; "
             f"sys.argv = ['x', 'a', 'b', '--measure', '--runs', "
             f"'{args.runs}']; import runpy; "
             f"runpy.run_path({str(me)!r}, run_name='__main__')"],
            cwd=root, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(json.dumps({"tree": tag, "root": str(root),
                          **json.loads(res.stdout.strip().splitlines()[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
