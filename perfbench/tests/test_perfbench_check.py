"""The check that decides `correct`, driven on the CPU at a small size
(the fused kernels' plain versions stand in for the kernels): the program
passes; the control (the reference in TF32 in the program's place) fails;
each fault a cell can have (`perfbench/faults.py`), planted under the timed
path, fails."""

import pytest
import torch

from perfbench import faults, harness

CPU = torch.device("cpu")
SMALL = {
    "tuned_h128.train_b32": {"pool": 4, "points": 13, "check_from": 2, "check_to": 3},
    "tuned_h128.cohort_sim": {"windows": 24, "cohorts": 2, "check_windows": 24},
    "latent_z.nuts": {"chains": 16, "windows": 2, "points": 13, "max_depth": 4,
                      "warmup": 12, "warmup_depth": 2, "replay_chains": 16,
                      "check_calls": 3, "check_chains": 16},
    "baseline_dopri5.cohort_sim": {"windows": 12, "cohorts": 2, "check_windows": 12,
                                   "points": 13},
}
FAULTS = {
    "tuned_h128.train_b32": ["train_state_unchanged", "train_half_batch", "train_stale_batch",
                             "train_moments_frozen", "train_schedule_frozen"],
    "tuned_h128.cohort_sim": ["cohort_answer_altered", "cohort_half_batch"],
    "baseline_dopri5.cohort_sim": ["cohort_answer_altered", "cohort_half_batch"],
    "latent_z.nuts": ["nuts_state_unchanged", "nuts_answer_altered", "nuts_half_batch",
                      "nuts_leapfrog", "nuts_weights", "nuts_no_uturn"],
}


def run(cell, seed=11, control=False):
    return harness.run_cell(cell, seed, 0.0, CPU, {"mix": SMALL[cell]}, control=control)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_passes_and_control_fails(cell):
    r, correct, table, control = run(cell, control=True)
    assert r.units >= 1 and r.failed == 0
    assert correct, table
    limits = harness.make_env(cell, 1, CPU).limits
    names = dict(control)
    assert any(v > limits[k] for k, v in names.items()), (control, limits)


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs])
def test_fault_fails(cell, fault):
    undo = faults.plant(fault)
    try:
        _, correct, table, _ = run(cell)
    finally:
        undo()
    assert not correct, table
