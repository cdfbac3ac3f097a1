"""A copy of the benchmark with cells small enough for the CPU, at n = 16:
both verifiers on the JAX package's 2-step chain (data/chain_16_2.bin),
one tampered request in two; the decider on a batch of 12 claims, its
steps six times over (more than one chunk of acc.KC = 10); and the prover
after one set-up step; added as files only (a configuration, its batch of
12, the traffic mixes, the cells) and listed in the copy's
BENCHMARK.json."""

from __future__ import annotations

import json
import pathlib
import shutil

from portbench import generator
from portbench.reference import chainfile
from portbench.reference.chainfile import MAGIC

REPO = pathlib.Path(__file__).resolve().parents[2]
CONFIG = {
    "name": "pallas-n16",
    "source": "tests/data/chain_16_2.bin: the JAX package's build_chain(default_rng(7), 16, 2)",
    "reduced": ["urs_n"],
    "urs_n": 16,
    "d": 15,
    "chains": {"k2": "data/chain_16_2.bin", "k12": "data/chain_16_12.bin"},
}
TAMPER = {"loop": "closed", "clients": 1, "tamper_every": 2, "tamper_kinds": ["L", "cU"]}
MIXES = {
    "decide-k2-tamper2": {"entry": "decide", "chain": "k2", **TAMPER, "tamper_inputs": 4},
    "decide-k12-tamper2": {"entry": "decide", "chain": "k12", **TAMPER, "tamper_inputs": 8},
    "verify-k2-tamper2": {"entry": "verify", "chain": "k2", **TAMPER, "tamper_at": "last"},
    "prove-steps-w1": {"entry": "prove", "loop": "closed", "clients": 1, "tamper_every": 0, "warm_steps": 1},
}
CELLS = {"decide-n16-k2": "decide-k2-tamper2", "decide-n16-k12": "decide-k12-tamper2",
         "verify-n16-k2": "verify-k2-tamper2", "prove-n16": "prove-steps-w1"}
# each entry's rate (its reader is e2e/<name>.py) and the per-layer quantities
# (metrics/<quantity>.py), listed in the copy's BENCHMARK.json where missing
RATES = {"decide": ("decide_claims_per_s", "claims/s"), "verify": ("verify_chains_per_s", "chains/s"),
         "prove": ("prove_steps_per_s", "steps/s")}
LAYERS = [("device_idle_pct", "%", "lower", "device"), ("glue_ms_per_req", "ms/req", "lower", "torch glue"),
          ("kernels_roofline", "%", "higher", "kernels"), ("host_launches_per_req", "calls/req", "lower", "dispatch")]


def copy(dest: pathlib.Path) -> pathlib.Path:
    """The benchmark (BENCHMARK.json and portbench/) copied to dest, with
    the small configuration, mix and cells added: dest."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = dest / "portbench"
    (pb / "configs" / "pallas-n16.json").write_text(json.dumps(CONFIG))
    (pb / "data" / "chain_16_12.bin").write_bytes(repeated(pb / "data" / "chain_16_2.bin", 6))
    for name, mix in MIXES.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    manifest = json.loads((dest / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "pallas-n16", "source": CONFIG["source"], "file": "portbench/configs/pallas-n16.json",
                                "reduced": ["urs_n"], "why": "a CPU-sized chain"})
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    layer = {m["name"]: m for m in manifest["per_layer"]}
    for name, traffic in CELLS.items():
        (pb / "workloads" / f"{name}.json").write_text(json.dumps({"trace_requests": 2}))
        manifest["workloads"].append({"name": name, "config": "pallas-n16", "traffic": traffic, "chips": 1,
                                      "why": "CPU-sized"})
        family = MIXES[traffic]["entry"]
        rate = RATES[family]
        e2e.setdefault(rate[0], {"name": rate[0], "unit": rate[1], "better": "higher", "bound": 0.25,
                                 "source": "host_clock", "workloads": []})["workloads"].append(name)
        for quantity, unit, better, layer_name in LAYERS:
            layer.setdefault(f"{quantity}.{family}", {
                "name": f"{quantity}.{family}", "unit": unit, "better": better, "source": "device_trace",
                "layer": layer_name, "moves": rate[0], "workloads": []})["workloads"].append(name)
    manifest["end_to_end"], manifest["per_layer"] = list(e2e.values()), list(layer.values())
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dest


def repeated(path: pathlib.Path, times: int) -> bytes:
    """The chain file at path with its steps `times` over: a batch of
    valid claims `times` as long (the steps do not link up, so only the
    decider reads it)."""
    raw = path.read_bytes()
    head = len(MAGIC) if raw.startswith(MAGIC) else 0
    k = int.from_bytes(raw[head + 8 : head + 16], "little")
    return raw[: head + 8] + (k * times).to_bytes(8, "little") + raw[head + 16 :] * times


def seed_with_first(root: pathlib.Path, cell: str, kind: str, positions=None) -> int:
    """The smallest seed whose first request of `cell` carries input `kind`
    ("valid" or a tamper kind), at one of `positions` where given, so a run
    of one request meets it."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    w = {w["name"]: w for w in manifest["workloads"]}[cell]
    mix = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    depth = len(chainfile.read(root / "portbench" / CONFIG["chains"][mix["chain"]]).accs) if "chain" in mix else 1

    def meets(key: str) -> bool:
        if key == generator.VALID:
            return kind == key
        k, at = generator.parse_name(key)
        return k == kind and (positions is None or at in positions)

    return next(s for s in range(1000) if meets(generator.stream(mix, s, depth)[0].key(0)))
