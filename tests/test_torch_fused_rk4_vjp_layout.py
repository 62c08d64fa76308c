"""Port parity: the host side of the second-derivation adjoint's Hopper layout.

`hybrid_ode_torch/csrc/fused_rk4_bwd_vjp.cu` works on 64-sample tiles with the
MLP weights staged in shared memory, and saves every stage's operands in
slots of a per-block scratch. Its library reports tile, grid, scratch and
partials floats per block, the route and the shared memory
(`fused_rk4_bwd_vjp_sizes`, `vjp_sizes`); `_bwd_workspace` allocates from
that. Tested here on the CPU:
  * the workspace `_bwd_workspace` allocates matches chip_smoke.py's
    pure-Python statement of the kernel's formula (`expected_vjp_sizes`, the
    one the library is held to on a card by chip_smoke.py on every run and by
    the `cuda`-marked test), over batches across the tile's edge, context
    widths, hidden widths, depths, substeps and both schedules;
  * at the cohort's widths (16 context features, and the r2 checkpoint's
    params mode) the formula's shared memory is within the block's limit on
    the staged route, and H=200 takes the other route.
"""

import itertools
import re
from pathlib import Path

import pytest
import torch

from chip_smoke import SMEM_LIMIT, expected_vjp_sizes
from hybrid_ode_torch.ops import fused_rk4 as tfused

_WIDE = Path(tfused.__file__).resolve().parents[1] / "csrc" / "fused_rk4_wide.cuh"
_WIDE_SRC = _WIDE.read_text()
#: samples per tile and the shared-memory limit, read from the kernels' header
TILE = int(re.search(r"constexpr int WTILE = (\d+);", _WIDE_SRC).group(1))
HEADER_SMEM_LIMIT = int(re.search(r"constexpr int SMEM_LIMIT = (\d+);", _WIDE_SRC).group(1))
SCHEDULES = ("recompute", "chained")
SHAPES = list(itertools.product((1, 2, TILE - 1, TILE, TILE + 1, 8192), (0, 3, 16),
                                (16, 128, 200), (1, 4), (1, 4), SCHEDULES))


def _packed_floats(in_pad, H, L):
    """Floats of the packed weights and biases for these widths (_pack_weights)."""
    return sum(r * c + c for r, c in tfused._layer_shapes(in_pad, H, L))


@pytest.mark.parametrize("B,C,H,L,substeps,schedule", SHAPES)
def test_vjp_workspace_matches_the_kernel_formula(B, C, H, L, substeps, schedule):
    in_pad = -(-(9 + C) // 8) * 8
    tiles, scratch, partials, smem, staged = expected_vjp_sizes(B, C, in_pad, H, L, substeps,
                                                                schedule, TILE)
    n_w = _packed_floats(in_pad, H, L)
    assert partials == n_w, "the formula's partials are the packed weights and biases"
    assert tiles == -(-B // TILE) and smem <= SMEM_LIMIT
    assert scratch == (4 if schedule == "recompute" else 4 * substeps) * TILE * (
        in_pad + 2 * L * H + 8), "a slot per stage kept: inputs, activations, cotangents"
    sizes = tfused.VjpSizes(TILE, min(tiles, 132), scratch, partials, staged, smem)
    part, scr = tfused._bwd_workspace(sizes, n_w, "meta")
    assert part.shape == (sizes.grid, n_w) and scr.shape == (sizes.grid, scratch)
    assert part.dtype == scr.dtype == torch.float32
    with pytest.raises(RuntimeError, match="partials"):
        tfused._bwd_workspace(sizes._replace(partials=n_w + 4), n_w, "meta")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("C,in_pad", [(16, 32), (3, 16)], ids=["features16", "params3"])
def test_cohort_widths_take_the_staged_route_within_the_limit(C, in_pad, schedule):
    assert SMEM_LIMIT == HEADER_SMEM_LIMIT
    _, _, _, smem, staged = expected_vjp_sizes(8192, C, in_pad, 128, 4, 4, schedule, TILE)
    assert staged and smem <= SMEM_LIMIT
    # the widths of a layer too wide to stage take the other route, still within it
    _, _, _, smem, staged = expected_vjp_sizes(100, 3, 16, 200, 2, 2, schedule, TILE)
    assert not staged and smem <= SMEM_LIMIT


@pytest.mark.cuda
def test_cuda_library_reports_the_formula_sizes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the library is built and asked there)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, C, H, L, substeps, schedule in SHAPES:
        in_pad = -(-(9 + C) // 8) * 8
        got = tfused.vjp_sizes(B, C, in_pad, H, L, substeps, schedule)
        tiles, *want = expected_vjp_sizes(B, C, in_pad, H, L, substeps, schedule, TILE)
        assert got.tile == TILE
        assert [got.scratch, got.partials, got.smem, got.staged] == want
        assert got.grid == tiles or (got.grid % sms == 0 and got.grid < tiles)
