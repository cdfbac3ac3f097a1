"""Runs of one cell in turn, one process each, and the spread of each metric.

    python3 -m portbench.sets --workload NAME --seeds 1,2,3 [--seconds S]
        [--trace 0|1] [--out FILE]

Each run is `python3 -m portbench.run` as the benchmark's command runs it,
one after another on this machine.  Prints each run's result line, then
for each metric its values, median and spread: the distance between the
first and third quartiles (statistics.quantiles(values, n=4)) as a share
of the median.  --out appends every result line, with its seed, to FILE.
The seconds default to BENCHMARK.json's run_seconds.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def spread(values) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values) if statistics.median(values) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    seconds = a.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    results, rc = [], 0
    for seed in a.seeds.split(","):
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", a.workload, "--seed", seed,
                            "--seconds", str(seconds), "--trace", str(a.trace)],
                           cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
        except json.JSONDecodeError:
            res = None
        if res is None:
            rc = 1
            print(json.dumps({"workload": a.workload, "seed": int(seed), "rc": p.returncode, "wall_s": wall,
                              "stderr_tail": p.stderr[-3000:]}), flush=True)
            continue
        res = {"workload": a.workload, "seed": int(seed), "wall_s": wall, **res,
               "stderr_tail": p.stderr.strip().splitlines()[-7:]}
        print(json.dumps(res), flush=True)
        results.append(res)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(res) + "\n")
    names = sorted({k for r in results for k in r["metrics"]})
    for k in names:
        vals = [r["metrics"][k]["value"] for r in results if k in r["metrics"]]
        print(json.dumps({"workload": a.workload, "metric": k, "values": vals,
                          "median": statistics.median(vals), "spread": spread(vals)}), flush=True)
    print(json.dumps({"workload": a.workload, "runs": len(results), "correct": [r["correct"] for r in results],
                      "peak_bytes": [r["device"]["memory_peak_bytes"] for r in results]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
