"""The port's package-level API: every name each JAX package re-exports
(`hybrid_ode_tpu/__init__.py` and each sub-package's `__all__`) imports from
the port's package of the same name, and importing them pulls in none of the
libraries the card machine lacks."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

PACKAGES = ["", "data", "dynamics", "evals", "inference", "models", "ops", "parallel",
            "plots", "solvers", "train", "utils"]
#: JAX names with no counterpart in the port (said in the port's docstrings)
NO_COUNTERPART = {("ops", "pallas_available"), ("utils", "Throughput")}
ROOT = Path(__file__).resolve().parents[1]


def _name(pkg, base):
    return base + (f".{pkg}" if pkg else "")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_jax_export_imports_from_the_port(pkg):
    jax_pkg = importlib.import_module(_name(pkg, "hybrid_ode_tpu"))
    port = importlib.import_module(_name(pkg, "hybrid_ode_torch"))
    want = [n for n in jax_pkg.__all__ if (pkg, n) not in NO_COUNTERPART]
    missing = [n for n in want if not hasattr(port, n)]
    assert not missing, missing
    assert set(want) <= set(port.__all__)
    namespace = {}
    exec(f"from {port.__name__} import {', '.join(want)}", namespace)
    if pkg == "parallel":
        assert namespace["distributed"].__name__ == "hybrid_ode_torch.parallel.distributed"


def test_the_packages_import_without_the_optional_libraries():
    code = ("import sys, hybrid_ode_torch as ht; ht.HybridConfig; "
            + "; ".join(f"import {_name(p, 'hybrid_ode_torch')}" for p in PACKAGES if p)
            + "; print(sorted(m for m in ('pandas', 'pyarrow', 'matplotlib', 'yaml', 'jax', "
              "'hybrid_ode_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
