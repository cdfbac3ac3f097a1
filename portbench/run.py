"""One run of one benchmark cell of halo_accumulation_tpu_torch on the card.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Reads BENCHMARK.json at the checkout's root and finds everything of the
cell by name: the cell's file workloads/<name>.json (how many requests a
traced run takes), its configuration's file (configs/<config>.json: the
URS size and the chains), its traffic mix (traffic/<traffic>.json: the
entry its requests call, the chain, the tampering, read by generator.py),
the entry (entries/<entry>.py), each end-to-end metric's reader
(e2e/<metric>.py)
and each per-layer metric's (metrics/<metric>.py, else the reader of the
name before its first dot, which serves every family).

Set-up (timed as setup_s, from the process's start): the CUDA context, the
program's kernels built or loaded from build/, the URS made on the card,
the inputs made from the seed and each warmed up.  Then one client in a
closed loop for --seconds: no request starts after that, and the window
ends when the last one comes back.  With --trace 0 the line holds the
cell's end-to-end metrics; with --trace 1 the requests (at most the
cell's trace_requests, within --seconds) run under torch.profiler and the
line holds its per-layer metrics, the device's busy and window seconds
and the breakdown.  After the window: the peak device memory, then the
program's state freed, then the plain reference (reference/) judges every
answer, and `correct` is whether all agree.

Exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), when the program cannot be imported, or when JAX or
the JAX package is loaded in this process once the window has closed.
The last line of standard output is the result; the last lines of
standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_IMPORT = _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "halo_accumulation_tpu")
PROGRAM = "halo_accumulation_tpu_torch"


@dataclass
class Cell:
    name: str
    root: pathlib.Path  # the benchmark's directory
    config: dict
    workload: dict
    mix: dict
    seed: int
    device: str


@dataclass
class Window:
    """What the end-to-end readers (e2e/) read."""

    setup_s: float
    seconds: float
    requests: int
    units: int
    latencies_s: list


class Refused(Exception):
    """The run cannot be made; the message says why."""


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(folder: pathlib.Path, name: str):
    """The read() of folder/<name>.py, else of folder/<name before its first
    dot>.py."""
    for stem in (name, name.split(".", 1)[0]):
        if (folder / f"{stem}.py").exists():
            return _module(folder / f"{stem}.py").read
    raise Refused(f"no reader {folder.name}/{name}.py")


def _cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc and g++ builds are already under build/); the
    URS is made in every run, so its disk cache points at a directory no
    run writes."""
    base = root / "build" / "portbench"
    for var, sub in (("HALO_TPU_URS_CACHE", "urs_cache"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)


def applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether a metric is this cell's: listed for it, or with no list and
    (per-layer) moving one of the cell's end-to-end metrics."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def plan(root: pathlib.Path, workload: str) -> tuple[dict, dict, list, list]:
    """(manifest cell entry, config entry, its end-to-end metrics, its
    per-layer metrics) from root/BENCHMARK.json."""
    manifest = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    e2e = [m for m in manifest["end_to_end"] if applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if applies(m, workload, names)]
    return w, configs[w["config"]], e2e, layer


def _sm_mhz(index: int) -> float:
    out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30, check=True)
    return float(out.stdout.strip().splitlines()[0])


def forbidden_loaded() -> list:
    """The top-level names of FORBIDDEN that this process has loaded,
    each compared whole (the program's name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def latency_note(records: list, latencies: list, units: int) -> str:
    """Each kind of input's median latency and count, the valid requests'
    median latency in each eighth of the window, and the rate of units over
    the valid requests' own time."""
    by_kind: dict = {}
    for (key, _), lat in zip(records, latencies):
        by_kind.setdefault(key.split("@", 1)[0], []).append(lat * 1e3)
    out = "latency ms by input, median (count): " + ", ".join(
        f"{k} {statistics.median(v):.1f} ({len(v)})" for k, v in sorted(by_kind.items()))
    # the chain cells' untampered input, or the prover's one kind of request
    valid = by_kind.get("valid", next(iter(by_kind.values())) if len(by_kind) == 1 else [])
    if len(valid) >= 8:
        n = len(valid)
        out += "; valid by eighth of the window: " + " ".join(
            f"{statistics.median(valid[i * n // 8 : (i + 1) * n // 8]):.1f}" for i in range(8))
    if valid:
        out += f"; {len(valid) * units / (sum(valid) / 1e3):.3f} units/s over the valid requests' own time"
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, root: pathlib.Path = ROOT,
        device: str | None = None, plant=None) -> tuple[dict, list]:
    """One run of one cell: (the result object, the line printed, with
    "checks" last; the lines for standard error, the numbers compared
    last).  device None: the card, which must be there (the
    command line's only way); "cpu" lets a test drive a run without one.
    plant: called with the cell's entry before its set-up, to put the
    control (control.py) or a test's fault in the program's place."""
    import torch

    w, cfg_entry, e2e, layer = plan(root, workload)
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False: this benchmark runs on the card only")
        if torch.cuda.device_count() < w["chips"]:
            raise Refused(f"{workload} asks for {w['chips']} cards, this machine has {torch.cuda.device_count()}")
        device = "cuda"
    bench = root / "portbench"
    cell = Cell(workload, bench, _load_json(root / cfg_entry["file"]), _load_json(bench / "workloads" / f"{workload}.json"),
                _load_json(bench / "traffic" / f"{w['traffic']}.json"), seed, device)
    _cache_dirs(root)
    marks = [("the interpreter and torch", time.perf_counter())]
    try:
        importlib.import_module(PROGRAM)
    except ImportError as e:
        raise Refused(f"the program ({PROGRAM}) does not import here: {e}") from e
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    marks.append(("the program imported", time.perf_counter()))
    entry = _module(bench / "entries" / f"{cell.mix['entry']}.py").Entry(cell)
    if plant is not None:
        plant(entry)
    marks.append(("the inputs made (the chain read, the tampered copies)", time.perf_counter()))
    entry.setup()
    marks.append(("the program's set-up", time.perf_counter()))
    from halo_accumulation_tpu_torch import runtime

    captured = [g.capture_s for g in runtime.graphs.values()]
    readers = {m["name"]: _reader(bench / ("metrics" if trace else "e2e"), m["name"]) for m in (layer if trace else e2e)}

    records, latencies = [], []
    t_first = time.perf_counter()
    setup_s = AGE_AT_IMPORT + (t_first - T_IMPORT)
    limit = cell.workload["trace_requests"] if trace else None
    prof = None
    if trace:
        from portbench import trace as tr

        ck.reset_launches()
        with tr.profiler() as prof:
            with tr.span(tr.WINDOW_SPAN):
                t_first = time.perf_counter()
                while not records or (len(records) < limit and time.perf_counter() - t_first < seconds):
                    t = time.perf_counter()
                    with tr.span(tr.REQUEST_SPAN):
                        records.append(entry.request(len(records)))
                    latencies.append(time.perf_counter() - t)
            # the clock the kernels just ran at, before the card idles down
            sm_mhz = _sm_mhz(torch.cuda.current_device()) if device != "cpu" else 1980.0
        widths = ck.launch_widths()
    else:
        while not records or time.perf_counter() - t_first < seconds:
            t = time.perf_counter()
            records.append(entry.request(len(records)))
            latencies.append(time.perf_counter() - t)
    t_last = time.perf_counter()

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": w["chips"], "memory_peak_bytes": torch.cuda.max_memory_allocated(0) if device != "cpu" else 0}
    metrics, breakdown = {}, None
    if trace:
        td = tr.read(prof, latencies, widths, sm_mhz, ck.KERNELS)
        prof = None
        dev["busy_s"], dev["window_s"] = td.busy_s, td.window_s
        breakdown = td.breakdown
        source = td
    else:
        source = Window(setup_s, t_last - t_first, len(records), len(records) * entry.units, latencies)
    for m in layer if trace else e2e:
        value = readers[m["name"]](source)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    entry.release()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    bad = entry.judge(records)
    checks = {
        "answers_compared": {"value": len(records), "limit": 1, "holds": "at least"},
        "answers_differing": {"value": len(bad), "limit": 0, "holds": "at most"},
    }
    loaded = forbidden_loaded()
    if loaded:
        raise Refused(f"this process has loaded {loaded} by the window's close")
    result = {"correct": bool(records) and not bad, "attempted": len(records), "failed": len(bad),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    notes = ([f"differs: request {i}: program {got!r}, reference {want!r}" for i, got, want in bad[:20]]
                         + [f"set-up {setup_s:.3f} s: {marks[0][0]} {marks[0][1] - T_IMPORT + AGE_AT_IMPORT:.3f} s; "
                            + "; ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
                            + "".join(f"; {label} {sec:.3f} s" for label, sec in getattr(entry, "setup_parts", []))
                            + f"; of it {len(captured)} CUDA graph(s) warmed and captured in {sum(captured):.3f} s "
                            "(runtime.graphs' capture_s)",
                            latency_note(records, latencies, entry.units),
                            f"reference judged {len(records)} answers in {time.perf_counter() - t_ref:.3f} s"]
                         + [f"check {k}: {c['value']} ({c['holds']} {c['limit']})" for k, c in checks.items()])
    return result, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0:
        print("--seed is a whole number, 0 or more", file=sys.stderr)
        return 2
    try:
        result, notes = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
