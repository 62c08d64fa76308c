"""The benchmark's files: BENCHMARK.json against the contract's rules, every
cell, configuration, mix and metric found by name, a new one of each found
as new files only, the import rules, and the kernels' bounds."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import flops, harness

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def doc():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    d = doc()
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["paths"] == ["perfbench"] and 1 <= d["run_seconds"] <= 51
    names = [c["name"] for c in d["configs"]] + [w["name"] for w in d["workloads"]] + \
        [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in e2e
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in d["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            e = [x for x in d["end_to_end"] if x["name"] == m["moves"]][0]
            assert "workloads" not in e or cell in e["workloads"]
    for w in d["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert harness.cell_metrics(d, w["name"], False) and harness.cell_metrics(d, w["name"], True)


def test_every_file_is_found_by_name():
    d = doc()
    for c in d["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert (PB / "weights" / c["name"] / "leaves.npz").is_file()
    for w in d["workloads"]:
        env = harness.make_env(w["name"], 1, "cpu")
        assert (PB / "drivers" / f"{env.mix['driver']}.py").is_file()
        assert env.limits and env.trace_units >= 1
    for m in d["end_to_end"] + d["per_layer"]:
        assert hasattr(harness._load(harness.reader_path(m["name"]), "m"), "read")


def test_new_cell_config_mix_and_metric_are_new_files(tmp_path):
    """A copy of the benchmark with a configuration, a mix, a driver, a cell
    and a metric added as files (and entries): the harness finds each."""
    copy = tmp_path / "checkout"
    shutil.copytree(PB, copy / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    d = doc()
    d["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                         "file": "perfbench/configs/tiny.json", "reduced": [], "why": "test"})
    d["workloads"].append({"name": "tiny.echo", "config": "tiny", "traffic": "echo",
                           "chips": 1, "why": "test"})
    d["per_layer"].append({"name": "echo_units", "unit": "units", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "setup_s", "workloads": ["tiny.echo"]})
    # a metric split by cells with no reader of its own reads its quantity's
    d["per_layer"].append({"name": "setup_s.echo", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "device",
                           "moves": "setup_s", "workloads": ["tiny.echo"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(d))
    shutil.copytree(PB / "weights" / "baseline_dopri5", copy / "perfbench" / "weights" / "tiny")
    (copy / "perfbench" / "configs" / "tiny.json").write_text('{"model": {}}')
    (copy / "perfbench" / "traffic" / "echo.json").write_text('{"driver": "echo", "n": 3}')
    (copy / "perfbench" / "workloads" / "tiny.echo.json").write_text(
        '{"trace_units": 1, "limits": {"n_gap": 0}}')
    (copy / "perfbench" / "drivers" / "echo.py").write_text(
        "class W:\n    unit_name = 'units'\n    def __init__(self, env): self.n = env.mix['n']\n"
        "    def run_unit(self): return self.n, 0\n    def counters(self): return {}\n"
        "    def check(self): return [('n_gap', 0.0)]\n"
        "def setup(env): return W(env)\n")
    (copy / "perfbench" / "metrics" / "echo_units.py").write_text(
        "def read(run): return run.attempted\n")
    code = ("import torch\nfrom perfbench import harness\n"
            "run, ok, table, _ = harness.run_cell('tiny.echo', 5, 0.0, torch.device('cpu'))\n"
            "m = harness.read_metrics(run, harness.cell_metrics(harness.benchmark(), 'tiny.echo', True))\n"
            "print(ok, run.attempted, m['echo_units']['value'], m['setup_s.echo']['value'] > 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:4] == ["True", "3", "3.0", "True"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(PB).as_posix() for p in PB.rglob("*.py")))
def test_imports(path):
    """No module of the benchmark imports JAX or the JAX package, and the
    reference imports nothing of the program (top-level names whole)."""
    names = set(_imports(PB / path))
    assert not names & {"jax", "jaxlib", "flax", "hybrid_ode_tpu"}
    if path.startswith("reference/"):
        assert "hybrid_ode_torch" not in names


def test_bounds_of_the_kernel_table():
    """flops.py gives PERF.md's bounds at B=8192, T=61, 4 substeps, H=128,
    16 context features: forward 12.600 ms, hand adjoint 37.678 ms."""
    widths = flops.field_widths(9 + 16, 128, 4)
    fwd, bwd = flops.kernel_ops(widths, 4, 128, 8192, 61, 4, 16)
    fb, bb = flops.kernel_bytes(sum(a * b + b for a, b in widths), 8192, 61, 16)
    f_ms, f_by, _, _ = flops.bound(fwd, fb)
    b_ms, b_by, _, _ = flops.bound(bwd, bb)
    assert (round(f_ms, 3), f_by) == (12.600, "operations")
    assert (round(b_ms, 3), b_by) == (37.678, "operations")


def test_no_card_no_result():
    env = {**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "tuned_h128.train_b32", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "{" not in out.stdout
