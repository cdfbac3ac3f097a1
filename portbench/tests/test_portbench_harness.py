"""The harness on the CPU: BENCHMARK.json keeps the manifest's rules
(keys, names, units, bounds, one chip a cell), a cell, a configuration and
a metric are found as new files alone, nothing a run loads is JAX or the
JAX package, and a run without a card fails without a result."""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests import small

REPO = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_shape():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    assert not any(w.startswith("/") or ".." in w for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p and (REPO / p).is_dir()
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51


def test_names_units_and_keys():
    m = MANIFEST
    every = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    every += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    every += [w["config"] for w in m["workloads"]] + [w["traffic"] for w in m["workloads"]]
    every += [k for c in m["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in every), [n for n in every if not NAME.match(n)]
    for group in ("configs", "workloads"):
        names = [x["name"] for x in m[group]]
        assert len(names) == len(set(names))
    metric_names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_configs_and_cells():
    m = MANIFEST
    used = {w["config"] for w in m["workloads"]}
    files = set()
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"])) and (REPO / c["file"]).is_file()
        assert c["name"] in used and c["file"] not in files
        files.add(c["file"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"] and body["source"] == c["source"]
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1, "no cell of this benchmark takes four chips"
        assert _line(w["why"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (REPO / "portbench" / "workloads" / f"{w['name']}.json").is_file()
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()


def test_metrics_and_what_each_cell_reports():
    m = MANIFEST
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(m["per_layer"]) <= 128
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
        assert (REPO / "portbench" / "e2e" / f"{x['name'].split('.')[0]}.py").is_file()
    layers = {}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(x["layer"]) and x["moves"] in e2e
        assert (REPO / "portbench" / "metrics" / f"{x['name'].split('.')[0]}.py").is_file()
        layers.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for w in m["workloads"]:
        _, _, cell_e2e, cell_layer = run.plan(REPO, w["name"])
        names = {x["name"] for x in cell_e2e}
        assert "setup_s" in names and len(names) >= 2 and cell_layer
        assert all(x["moves"] in names for x in cell_layer)


def _tree(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_a_config_and_a_metric_are_new_files_only(tmp_path):
    """In a copy: a configuration, a traffic mix, two cells and a per-layer
    metric added as files, and listed in BENCHMARK.json, run (on the CPU)
    with no other file of the benchmark changed."""
    root = small.copy(tmp_path)
    (root / "portbench" / "metrics" / "requests_traced.py").write_text("def read(td):\n    return td.requests\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for name, unit, better in (("requests_traced.verify", "requests", "higher"), ("verify_p95_ms.host", "ms", "lower")):
        manifest["per_layer"].append({"name": name, "unit": unit, "better": better, "source": "program_counter",
                                      "layer": "protocol (host)", "moves": "verify_chains_per_s",
                                      "workloads": ["verify-n16-k2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    before, after = _tree(REPO / "portbench"), _tree(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == sorted(
        ["configs/pallas-n16.json", "data/chain_16_12.bin", "metrics/requests_traced.py"]
        + [f"traffic/{n}.json" for n in small.MIXES]
        + [f"workloads/{n}.json" for n in small.CELLS])
    res, notes = run.run("verify-n16-k2", small.seed_with_first(root, "verify-n16-k2", "L"), 0.1, True, root=root,
                         device="cpu")
    assert res["correct"], notes
    assert res["metrics"]["requests_traced.verify"]["value"] == 1
    assert "verify_p95_ms.host" not in res["metrics"]  # one request has no 95th percentile
    assert {"host_launches_per_req.verify", "device_idle_pct.verify"} <= set(res["metrics"])
    assert res["attempted"] == 1 and res["failed"] == 0
    assert list(res)[-1] == "checks" and notes[-2:] == ["check answers_compared: 1 (at least 1)",
                                                         "check answers_differing: 0 (at most 0)"]


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_harness_loads_is_jax():
    """Everything portbench.run loads for a cell of each entry, the program
    included, compared by whole top-level names (the program's name begins
    with the JAX package's)."""
    code = ("import pathlib, portbench.run as r, portbench.control, portbench.sets\n"
            "import halo_accumulation_tpu_torch.acc, halo_accumulation_tpu_torch.chain, halo_accumulation_tpu_torch.pp\n"
            "import halo_accumulation_tpu_torch.ops.cuda_kernels\n"
            "b = pathlib.Path(r.__file__).parent\n"
            "[r._module(p) for d in ('entries', 'metrics', 'e2e') for p in sorted((b / d).glob('*.py'))]\n"
            "import portbench.trace")
    loaded = _loaded_after(code)
    assert "halo_accumulation_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.protocol, portbench.reference.chainfile, "
                           "portbench.reference.curve, portbench.tamper, portbench.costs, portbench.generator")
    assert not loaded & {"halo_accumulation_tpu_torch", *run.FORBIDDEN, "torch"}, loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "halo_accumulation_tpu_torch_like", object())
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_loaded() == ["jax"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", MANIFEST["workloads"][0]["name"],
                        "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "torch.cuda.is_available() is False" in p.stderr


def test_a_run_with_only_the_benchmarks_files_fails(tmp_path):
    """A directory that holds BENCHMARK.json and portbench/ alone has no
    program: the run refuses (here past the look for a card) and prints
    no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import pathlib, sys\nfrom portbench import run\n"
            "try:\n    run.run('decide-n16384-k100', 1, 1, False, root=pathlib.Path('.'), device='cpu')\n"
            "except run.Refused as e:\n    print(e, file=sys.stderr)\n    sys.exit(3)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 3 and "{" not in p.stdout
    assert "does not import here" in p.stderr
