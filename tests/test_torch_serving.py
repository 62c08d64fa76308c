"""Port parity for the serving path as a whole: checkpoint -> data -> metrics.

`evaluate_checkpoint` of the port (on the CPU, so the fused path runs the
kernel's plain version) against the JAX package's on
checkpoints/accuracy_benchmark/best_model, every metric to 1e-5 relative
(nll also within 1e-6 absolute), with use_pallas off and on. Also: checkpoint leaves, CSV windowing and
splits, the import boundary, and that CUDA entry points raise without CUDA.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.evals.evaluate import evaluate_checkpoint as j_evaluate_checkpoint
from hybrid_ode_tpu.models.hybrid import config_from_dict as j_config_from_dict
from hybrid_ode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.evals import evaluate as teval
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.utils.checkpoint import load_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "checkpoints" / "accuracy_benchmark" / "best_model")
DATA = str(ROOT / "data" / "4gi_dataset.csv")


@pytest.fixture(scope="module")
def splits():
    jds = jdata.create_data_arrays(DATA, 61, 30, use_native=False)
    tds = tdata.create_data_arrays(DATA, 61, 30, use_native=False)
    return jdata.split_dataset(jds, seed=42), tdata.split_dataset(tds, seed=42)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_load_checkpoint_matches_jax():
    jstate, jmeta = j_load_checkpoint(CKPT)
    state, meta = load_checkpoint(CKPT)
    assert meta == jmeta
    assert jax.tree_util.tree_structure(jstate) == jax.tree_util.tree_structure(state)
    for a, b in zip(_leaves(jstate), _leaves(state)):
        np.testing.assert_array_equal(a, b)
    params = params_from_numpy(state["params"], "cpu")
    assert sorted(params) == ["enc", "nn", "ode"]
    assert tuple(params["nn"]["w0"].shape) == (25, 128)
    back = params_to_numpy(params)
    for a, b in zip(_leaves(jstate["params"]), _leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert thyb.config_from_dict(meta["config"]) == thyb.HybridConfig(
        **dataclasses.asdict(j_config_from_dict(jmeta["config"])))


@pytest.mark.parametrize("per_channel_mask", [False, True])
def test_create_data_arrays_matches_jax_pandas_path(per_channel_mask, tmp_path):
    # a copy with missing values and unsorted subjects exercises masks and order
    lines = Path(DATA).read_text().splitlines()
    head, rows = lines[0], lines[1:]
    rows = rows[300:] + rows[:300]
    cells = rows[5].split(",")
    cells[3] = ""
    rows[5] = ",".join(cells)
    path = tmp_path / "cohort.csv"
    path.write_text("\n".join([head] + rows) + "\n")
    for src in (DATA, str(path)):
        jds = jdata.create_data_arrays(src, 61, 30, use_native=False,
                                       per_channel_mask=per_channel_mask)
        tds = tdata.create_data_arrays(src, 61, 30, use_native=False,
                                       per_channel_mask=per_channel_mask)
        for f in dataclasses.fields(jdata.GlucoseDataset):
            a, b = getattr(jds, f.name), getattr(tds, f.name)
            if a is None:
                assert b is None, f.name
            else:
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_split_and_batches_match_jax(splits):
    (jtr, jva, jte), (ttr, tva, tte) = splits
    for a, b in ((jtr, ttr), (jva, tva), (jte, tte)):
        np.testing.assert_array_equal(a.subject_ids, b.subject_ids)
        np.testing.assert_array_equal(a.observations, b.observations)
    jb = list(jdata.batch_iterator(jtr, 3, seed=1))
    tb = list(tdata.batch_iterator(ttr, 3, seed=1))
    assert len(jb) == len(tb) == 3
    jp, jv = jdata.pad_batch(jb[-1], 3)
    tp, tv = tdata.pad_batch(tb[-1], 3)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jp["mask"], tp["mask"])
    np.testing.assert_array_equal(jp["external_inputs"]["meal"], tp["external_inputs"]["meal"])
    for level in ("window", "subject"):
        for a, b in zip(jdata.split_dataset(jtr, seed=3, level=level),
                        tdata.split_dataset(ttr, seed=3, level=level)):
            np.testing.assert_array_equal(a.subject_ids, b.subject_ids)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_evaluate_checkpoint_matches_jax(use_pallas, splits):
    """The slice end to end: every metric of the port to 1e-5 relative."""
    (_, jva, jte), (_, tva, tte) = splits
    _, meta = j_load_checkpoint(CKPT)
    ref = j_evaluate_checkpoint(CKPT, jte, config=j_config_from_dict(
        meta["config"], use_pallas=use_pallas), val_ds=jva)
    out = teval.evaluate_checkpoint(CKPT, tte, val_ds=tva, use_pallas=use_pallas, device="cpu")
    assert sorted(out) == sorted(ref)
    for k in ref:
        # atol: nll is a mean of O(1) terms that cancel to -0.03, so its f32
        # rounding (~4e-7) exceeds 1e-5 of the mean; every other metric
        # meets 1e-5 relative alone
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert ref["rmse"] == pytest.approx(0.3590921, rel=1e-6)


def test_evaluate_unported_branches_raise(splits):
    _, (_, tva, tte) = splits
    # the VI branch is ported: a posterior over the checkpoint's ODE
    # parameters scores with the calibration metrics
    from hybrid_ode_torch.inference.vi import VariationalInference

    state, meta = load_checkpoint(CKPT)
    vi = VariationalInference(params_from_numpy(state["params"], "cpu"),
                              thyb.config_from_dict(meta["config"]))
    metrics = teval.evaluate_checkpoint(CKPT, tte, device="cpu", variational=vi,
                                        n_posterior_samples=2, obs_sigma=0.1)
    assert np.isfinite(metrics["rmse"]) and np.isfinite(metrics["ece"])
    # identification at evaluation is for ensembles only, as in the JAX package
    with pytest.raises(ValueError, match="identify_steps requires ensemble=True"):
        teval.evaluate_checkpoint(CKPT, tte, device="cpu", identify_steps=5)


def test_cuda_entry_points_raise_without_cuda(splits, monkeypatch):
    """Asked for CUDA where there is none, entry points raise (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (_, tva, tte) = splits
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        teval.evaluate_checkpoint(CKPT, tte, val_ds=tva, use_pallas=True)  # default: cuda
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        params_from_numpy({"w": np.zeros(2)}, device="cuda")


def test_main_writes_results(tmp_path, capsys):
    out = tmp_path / "res.csv"
    teval.main([CKPT, "--data", DATA, "--output", str(out), "--device", "cpu", "--use-pallas"])
    assert "RMSE: 0.3591" in capsys.readouterr().out
    header, row = out.read_text().splitlines()
    assert header.split(",")[0] == "rmse"
    assert out.with_suffix(".txt").exists()
    # fresh-cohort protocol: every window, normalized with a reference file
    teval.main([CKPT, "--data", DATA, "--output", str(out), "--device", "cpu",
                "--no-split", "--norm-from", DATA])
    header2 = out.read_text().splitlines()[0].split(",")
    assert "ece" not in header2 and set(header2) < set(header.split(","))  # no val split


def test_port_imports_neither_jax_nor_the_jax_package():
    """No JAX, JAX package or pandas anywhere; PyYAML only inside the
    functions that read or write a YAML file (the card has no PyYAML)."""
    files = sorted((ROOT / "hybrid_ode_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                 ROOT / "backsolve_subsets.py"]
    assert len(files) > 10
    lazy_yaml = 0
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        in_function = set()
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                in_function.update(id(n) for n in ast.walk(fn) if n is not fn)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
                names = [getattr(a, "value", "") for a in node.args[:1]]
            for n in names:
                root = str(n).split(".")[0]
                assert root not in ("jax", "jaxlib", "hybrid_ode_tpu", "pandas"), (f, n)
                if root == "yaml":
                    assert id(node) in in_function, (f, "module-level yaml import")
                    lazy_yaml += 1
    assert lazy_yaml == 2  # utils/config.py: load_config, save_config
