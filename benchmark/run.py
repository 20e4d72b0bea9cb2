"""The benchmark of spark_rapids_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints the checks (each number compared beside its limit) as the
last lines of standard error and one JSON line as the last line of
standard output; exits 0 only when it printed a result. What a run does
is in benchmark/harness/bench.py; PERF.md says why.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc cache is spark_rapids_tpu_torch/_build/)."""
    base = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    caches(ROOT)
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import bench
    spec = bench.Spec(ROOT)
    cell = spec.workload(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    out = bench.run_cell(spec, args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START)
    found = bench.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
