"""Smoke test of the PyTorch port (`hybrid_ode_torch/`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line of its own; any failure exits non-zero before
the last line:
  1. device   - require CUDA, print the card and its power limit, TF32 off
  2. build    - compile csrc/fused_rk4_fwd.cu and csrc/fused_rk4_bwd.cu
                with nvcc (sm_90a), both at once; ptxas registers / spills
  3. kernel   - the fused RK4 forward kernel against its plain PyTorch
                version on the card: the accuracy checkpoint at full width on
                a cohort of 8192 windows (T=61, substeps=4, H=128, 16 context
                features), and three small cases (2 layers without context,
                params 'mul', params 'abs'); tolerance rtol=atol=2e-4, the
                JAX suite's fused-vs-XLA tolerance
  3b. bwd     - the adjoint kernel against its plain version: the same model
                on the cohort's first 1024 windows and the three small cases
                (B=1000, T=13), cotangent gbar from numpy (seed 0). Every
                output is compared (ybar0, each dW and db, the 17 summed
                parameter gradients, dctx) by the JAX suite's _rel_err:
                limit 1e-5 on the small cases; 1e-4 at full width, where a
                leaf that misses it passes only if the kernel is no farther
                from an f64 run of the plain version than the f32 plain is
  4. main     - the serving path with every launch count at 0: evaluate the
                checkpoint (use_pallas) on the seed-42 test split against the
                JAX package's CPU metrics, then simulate the 8192 cohort with
                batched_forward(use_pallas); the kernel must have launched
  4b. train   - the training path with every launch count at 0: train_model
                for 3 epochs from the checkpoint's params and config
                (use_pallas) on the seed-42 split; the backward kernel must
                have launched >= 3 times, every loss be finite, final_model
                reload, and the first step's loss and gradient norm match the
                JAX package's CPU values to 1e-4
  5. timing   - CUDA events, median of 20: forward and backward kernels at
                the cohort shape, one train step (fwd kernel + bwd kernel +
                loss + Adam) at the cohort shape and at bench.py's train
                shape (B=8192, T=61, H=64, no context); plain versions once;
                then one cohort train step under torch.profiler: device time
                per kernel and the device's busy share of the step
Then one JSON line with both kernels, the card's name and power limit, and
last {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import create_data_arrays, split_dataset
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.evals.evaluate import evaluate_checkpoint
from hybrid_ode_torch.models.hybrid import (
    batched_forward,
    config_from_dict,
    init_hybrid_params,
    with_context,
)
from hybrid_ode_torch.ops import fused_rk4
from hybrid_ode_torch.train.loop import TrainState, _to_params, make_optimizer, make_train_step, train_model
from hybrid_ode_torch.utils.checkpoint import load_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "checkpoints" / "accuracy_benchmark" / "best_model"
DATA = ROOT / "data" / "4gi_dataset.csv"
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# JAX package, evaluate_checkpoint on the CPU (seq 61, stride 30, seed-42 split)
REF_RMSE, REF_RMSE_GLUCOSE = 0.3590921, 0.4897008
REF_RTOL = 1e-4
# JAX package, first train step on the CPU (the accuracy checkpoint's config
# with use_pallas, its params, the seed-42 split's first shuffled batch):
# loss and global gradient norm (tests/test_torch_training.py recomputes them)
REF_TRAIN_LOSS, REF_GRAD_NORM = 0.133601293, 2.02965832
RTOL = ATOL = 2e-4
COHORT = 8192          # bench.py's cohort size
SUBSTEPS = 4
BWD_B = 1024           # windows of the cohort for the adjoint's kernel-vs-plain check
BWD_SMALL_RTOL, BWD_FULL_RTOL = 1e-5, 1e-4
# NVIDIA H100 SXM data sheet, 700 W: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# operations per sample outside the MLP, counted from the kernel's formulas:
# mechanistic drift + residual add + stage state + control interpolation per
# stage evaluation, and the RK4 combination per step
MECH_OPS_PER_STAGE = 61
RK_OPS_PER_STEP = 48
# ... and for the adjoint: mechanistic Jacobian-transpose, parameter rows and
# stage cotangents per stage, the substep's cotangent sum per step
MECH_T_OPS_PER_STAGE = 124
RK_T_OPS_PER_STEP = 30


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def compare(kernel, plain, label):
    k, p = kernel.double(), plain.double()
    if not torch.isfinite(k).all():
        fail(f"{label}: kernel output is not finite")
    err = (k - p).abs()
    ratio = float((err / (ATOL + RTOL * p.abs())).max())
    max_abs = float(err.max())
    max_rel = float((err / p.abs().clamp_min(1e-6)).max())
    ok = ratio <= 1.0
    print(f"kernel-vs-plain {label}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"worst |k-p|/(atol+rtol|p|)={ratio:.3f} (rtol=atol={RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}: kernel disagrees with its plain version")
    return max_abs


def cohort_inputs(ds, params, config, device):
    """The dataset's windows tiled to COHORT samples with numpy-seeded jitter."""
    rng = np.random.default_rng(0)
    idx = np.arange(COHORT) % len(ds)
    obs = ds.observations[idx].copy()
    obs[..., :4] += 0.05 * rng.normal(size=obs[..., :4].shape).astype(np.float32)
    ts = ds.time_points[idx] + rng.uniform(0.0, 24.0, (COHORT, 1)).astype(np.float32)
    batch = {k: torch.as_tensor(v, device=device) for k, v in (
        ("observations", obs), ("time_points", ts), ("initial_state", obs[:, 0]))}
    ext = {"meal": torch.as_tensor(ds.meal[idx], device=device),
           "tVNS": torch.as_tensor(ds.tvns[idx], device=device)}
    with torch.no_grad():
        ctrl = with_context(params, batch, Controls(ts=batch["time_points"], signals=ext), config)
    return batch, ctrl


def random_mlp(rng, in_dim, hidden, n_layers, device):
    dims = [in_dim] + [hidden] * n_layers + [6]
    nn = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        scale = 0.05 if i == n_layers else 1.0 / np.sqrt(a)
        nn[f"w{i}"] = (scale * rng.normal(size=(a, b))).astype(np.float32)
        nn[f"b{i}"] = (0.1 * rng.normal(size=b)).astype(np.float32)
    return params_from_numpy(nn, device)


def small_case(name, ode, device, n_layers, mode):
    """A small random-weight case for one kernel option."""
    rng = np.random.default_rng({"layers2": 1, "mul": 2, "abs": 3}[name])
    B, T = 1000, 13  # B not a multiple of the block's tile: exercises masking
    y0 = (0.5 * rng.normal(size=(B, 6))).astype(np.float32)  # z-scored states
    ts = np.cumsum(rng.uniform(0.05, 0.15, (B, T)), 1).astype(np.float32)
    meal = np.where(rng.uniform(size=(B, T)) > 0.7, 1.0, 0.0).astype(np.float32)
    tvns = rng.uniform(0, 1, (B, T)).astype(np.float32)
    names = ("G_b", "I_b", "Glu_b")
    idx, ctx = (), None
    if mode:
        idx = tuple(fused_rk4.PARAM_ORDER.index(n) for n in names)
        if mode == "mul":
            ctx = (0.2 * rng.normal(size=(B, 3))).astype(np.float32)
        else:
            base = np.array([float(ode[n]) for n in names], np.float32)
            ctx = (base * (1 + 0.2 * rng.normal(size=(B, 3)))).astype(np.float32)
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)  # noqa: E731
    packed = fused_rk4.pack(t(y0), t(ts), t(meal), t(tvns), ode,
                            random_mlp(rng, 9, 64, n_layers, device), n_layers, t(ctx))
    return packed, idx, mode or "mul"


def time_ms(fn, warmup, reps):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(ref, x):
    """The JAX suite's _rel_err: max |ref - x| over max |ref|."""
    ref, x = ref.double(), x.double()
    return float((ref - x).abs().max() / max(float(ref.abs().max()), 1e-8))


def bwd_leaves(out, pw):
    """The adjoint's outputs as named leaves: ybar0, dW / db per layer, the
    17 parameter gradients summed over the batch (in f64), dctx."""
    ybar0, dflat, dp, dctx = out
    v = fused_rk4._unflatten(dflat, pw.in_pad, pw.hidden, pw.n_layers)
    leaves = {"ybar0": ybar0, "dparams": dp.double().sum(1)}
    for i in range(pw.n_layers + 1):
        leaves[f"dw{i}"], leaves[f"db{i}"] = v.ws[i], v.bs[i]
    if dctx is not None:
        leaves["dctx"] = dctx
    return leaves


def bwd_inputs(packed, T, substeps, idx=(), mode="mul"):
    """Forward-kernel trajectory and a numpy-seeded cotangent for `packed`."""
    B = packed[0].shape[0]
    with torch.no_grad():
        traj = fused_rk4.fused_rk4_fwd(*packed, substeps, idx, mode)
    gbar = np.random.default_rng(0).normal(size=(T, 6, B)).astype(np.float32)
    return traj, torch.as_tensor(gbar, device=traj.device)


def compare_bwd(packed, T, substeps, label, idx=(), mode="mul", full=False):
    """Adjoint kernel vs plain version; returns (max abs error, plain seconds)."""
    traj, gbar = bwd_inputs(packed, T, substeps, idx, mode)
    args = (traj, gbar, *packed[1:], substeps, idx, mode)
    with torch.no_grad():
        kernel = bwd_leaves(fused_rk4.fused_rk4_bwd(*args), packed[5])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = bwd_leaves(fused_rk4._bwd_plain(*args), packed[5])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        f64 = None
        if full:
            d = lambda x: None if x is None else x.double()  # noqa: E731
            pw = packed[5]
            pw64 = fused_rk4._unflatten(pw.flat.double(), pw.in_pad, pw.hidden, pw.n_layers)
            f64 = bwd_leaves(fused_rk4._bwd_plain(
                d(traj), d(gbar), *(d(x) for x in packed[1:5]), pw64, d(packed[6]), substeps,
                idx, mode), pw)
    limit = BWD_FULL_RTOL if full else BWD_SMALL_RTOL
    max_abs, parts, bad = 0.0, [], []
    for name, k in kernel.items():
        if not torch.isfinite(k).all():
            bad.append(f"{name} not finite")
        e = rel_err(plain[name], k)
        max_abs = max(max_abs, float((k.double() - plain[name].double()).abs().max()))
        part = f"{name} {e:.2e}"
        if full:
            dk, dp = rel_err(f64[name], k), rel_err(f64[name], plain[name])
            part += f" (f64: kernel {dk:.2e}, plain {dp:.2e})"
            if e > limit and dk > dp:
                bad.append(name)
        elif e > limit:
            bad.append(name)
        parts.append(part)
    print(f"bwd kernel-vs-plain {label} (_rel_err limit {limit:g}): " + "; ".join(parts)
          + f" {'FAIL ' + ', '.join(bad) if bad else 'ok'}")
    if bad:
        fail(f"bwd {label}: kernel disagrees with its plain version ({', '.join(bad)})")
    return max_abs, plain_s


def kernel_ops(nn, n_layers, hidden, B, T, substeps, n_ctx_feat=0):
    """Operations of the forward and the adjoint kernel on these shapes,
    counted from the kernels' formulas (unpadded MLP widths)."""
    macs = sum(nn[f"w{i}"].numel() for i in range(n_layers + 1))
    outs = sum(nn[f"b{i}"].numel() for i in range(n_layers + 1))
    hidden_outs = n_layers * hidden
    steps = B * (T - 1) * substeps
    fwd = steps * (4 * (2 * macs + outs + hidden_outs + MECH_OPS_PER_STAGE) + RK_OPS_PER_STEP)
    # the adjoint: one recomputed forward, then per stage the weight and input
    # cotangents (2 x 2 macs), bias sums, ReLU masks and the mechanistic transpose
    bwd = fwd + steps * (4 * (4 * macs + outs + hidden_outs + MECH_T_OPS_PER_STAGE + n_ctx_feat)
                         + RK_T_OPS_PER_STEP)
    return fwd, bwd


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def train_step_fn(params, batch, config, lambda2):
    """One train step (fwd kernel + bwd kernel + loss + Adam) as a closure."""
    state = TrainState(_to_params(params, torch.device("cuda")))
    opt = make_optimizer(3e-3, 1000, 1, 5.0, train_ode_params=True).bind(state.params)
    step = make_train_step(opt, config, 0.0, lambda2, True)
    gen = torch.Generator().manual_seed(0)
    return lambda: step(state, batch, gen)


def profile_ms(fn):
    """One profiled call of fn: (wall ms, {kernel name: (device ms, launches)}).
    Wall time is the host clock around fn and a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return wall_ms, kernels


def bench_train_batch(device):
    """bench.py's train-step inputs: B=8192, T=61 on one 5 h grid, two meals."""
    rng = np.random.default_rng(1)
    base = np.array([8.0, 100.0, 90.0, 20.0, 0.0, 1.2], np.float32)
    y0 = np.abs(base * (1.0 + 0.1 * rng.normal(size=(COHORT, 6)))).astype(np.float32)
    ts = np.broadcast_to(np.linspace(0.0, 5.0, 61, dtype=np.float32), (COHORT, 61))
    meal = np.zeros((COHORT, 61), np.float32)
    meal[:, 12], meal[:, 36] = 2.0, 1.5
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)  # noqa: E731
    return {"initial_state": t(y0), "observations": t(np.repeat(y0[:, None], 61, 1)),
            "time_points": t(ts), "external_inputs": {"meal": t(meal),
                                                      "tVNS": t(np.zeros_like(meal))}}


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; TF32 off")
    report = {"device": kind, "nvidia_smi": smi}

    # 2. build
    t0 = time.perf_counter()
    built = fused_rk4.build_library()
    fused_rk4._libraries()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for stem, (so, log) in built.items():
        ptxas[stem] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"build: {so.name}: " + " | ".join(ptxas[stem]))
    print(f"build: {len(built)} libraries in {build_s:.1f} s")
    report.update(build_s=build_s, ptxas=ptxas)

    # 3. kernel vs plain
    state, meta = load_checkpoint(str(CKPT))
    params = params_from_numpy(state["params"], device)
    config = config_from_dict(meta["config"], use_pallas=True)
    ds = create_data_arrays(str(DATA), 61, 30)
    batch, ctrl = cohort_inputs(ds, params, config, device)
    sig = ctrl.signals
    packed = fused_rk4.pack(batch["initial_state"], batch["time_points"], sig["meal"],
                            sig["tVNS"], params["ode"], params["nn"], config.nn_layers,
                            sig["context"])
    T = batch["time_points"].shape[1]
    C = sig["context"].shape[1]
    print(f"cohort: B={COHORT} T={T} substeps={SUBSTEPS} H={config.nn_hidden} "
          f"layers={config.nn_layers} context={C} features")
    with torch.no_grad():
        full_kernel = fused_rk4.fused_rk4_fwd(*packed, SUBSTEPS)
        torch.cuda.synchronize()
        full_plain = fused_rk4._fwd_plain(*packed, SUBSTEPS)
    max_abs = {"full": compare(full_kernel, full_plain, "full width")}
    small = {}
    for name, layers, mode in (("layers2", 2, None), ("mul", 4, "mul"), ("abs", 4, "abs")):
        small[name] = small_case(name, params["ode"], device, layers, mode)
        p, idx, m = small[name]
        k = fused_rk4.fused_rk4_fwd(*p, 2, idx, m)
        torch.cuda.synchronize()
        max_abs[name] = compare(k, fused_rk4._fwd_plain(*p, 2, idx, m), f"small {name}")
    report["max_abs_err"] = max_abs

    # 3b. adjoint kernel vs plain
    head = slice(0, BWD_B)
    packed_head = (packed[0][head].contiguous(),
                   *(x[:, head].contiguous() for x in packed[1:5]), packed[5], packed[6])
    bwd_abs, bwd_plain_s = compare_bwd(packed_head, T, SUBSTEPS,
                                       f"full width (first {BWD_B} of the cohort)", full=True)
    bwd_max_abs = {"full": bwd_abs}
    for name, (p, idx, m) in small.items():
        bwd_max_abs[name], _ = compare_bwd(p, 13, 2, f"small {name}", idx, m)
    report["bwd_max_abs_err"] = bwd_max_abs

    # 4. serving path, launch counts from 0
    fused_rk4.fused_rk4_fwd_launches = fused_rk4.fused_rk4_bwd_launches = 0
    train_ds, val_ds, test_ds = split_dataset(ds, seed=42)
    t0 = time.perf_counter()
    metrics = evaluate_checkpoint(str(CKPT), test_ds, val_ds=val_ds, use_pallas=True,
                                  device="cuda")
    eval_s = time.perf_counter() - t0
    with torch.no_grad():
        cohort_ctrl = with_context(params, batch, Controls(
            ts=batch["time_points"], signals={"meal": sig["meal"], "tVNS": sig["tVNS"]}), config)
        traj = batched_forward(params, batch["initial_state"], batch["time_points"],
                               cohort_ctrl, config)
    torch.cuda.synchronize()
    launches = fused_rk4.fused_rk4_fwd_launches
    print(f"main path (serving): evaluate_checkpoint {eval_s:.2f} s, cohort batched_forward "
          f"{tuple(traj.shape)}; fused_rk4_fwd launches={launches}")
    if launches < 1:
        fail("the serving path did not launch the fused RK4 kernel")
    for key, ref in (("rmse", REF_RMSE), ("rmse_glucose", REF_RMSE_GLUCOSE)):
        rel = abs(metrics[key] - ref) / ref
        print(f"metric {key}={metrics[key]:.7f} JAX-CPU reference={ref} rel_err={rel:.2e} "
              f"(limit {REF_RTOL})")
        if rel > REF_RTOL:
            fail(f"{key} disagrees with the JAX reference")
    print("metrics: " + json.dumps({k: round(float(v), 7) for k, v in metrics.items()}))
    if traj.shape != (COHORT, T, 6) or not torch.isfinite(traj).all():
        fail("cohort trajectory has the wrong shape or is not finite")
    compare(traj, full_plain.permute(2, 0, 1), "cohort batched_forward vs plain")
    sub = slice(0, 256)
    with torch.no_grad():
        sub_ctrl = Controls(ts=batch["time_points"][sub], signals={
            k: v[sub] for k, v in cohort_ctrl.signals.items()})
        scan = batched_forward(params, batch["initial_state"][sub], batch["time_points"][sub],
                               sub_ctrl, config_from_dict(meta["config"]))
    compare(traj[sub], scan, "cohort fused vs scan path (first 256)")
    report.update(metrics=metrics, launches=launches, eval_s=eval_s)

    # 4b. training path, launch counts from 0
    cfg = copy.deepcopy(meta["config"])
    cfg["model"]["use_pallas"] = True
    fused_rk4.fused_rk4_fwd_launches = fused_rk4.fused_rk4_bwd_launches = 0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        res = train_model(cfg, train_ds, val_ds, ckpt_dir, None, params=state["params"],
                          max_epochs=3, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = (fused_rk4.fused_rk4_fwd_launches, fused_rk4.fused_rk4_bwd_launches)
        final, final_meta = load_checkpoint(str(Path(ckpt_dir) / "final_model"))
    hist = res.history
    print(f"main path (training): train_model 3 epochs in {train_s:.2f} s, "
          f"{len(hist['step_loss'])} steps; step losses {hist['step_loss']}, grad norms "
          f"{hist['grad_norm']}, val losses {hist['val_loss']}; fused_rk4_fwd launches="
          f"{train_launches[0]} fused_rk4_bwd launches={train_launches[1]}")
    if train_launches[1] < 3:
        fail("the training path launched the backward kernel fewer than 3 times")
    if not all(np.isfinite(hist[k]).all() for k in ("step_loss", "grad_norm", "val_loss")):
        fail("a training loss is not finite")
    leaves = [v for g in final["params"].values() for v in g.values()]
    if (final_meta["epoch"] != 2 or sorted(final["params"]) != sorted(state["params"])
            or not all(np.isfinite(v).all() for v in leaves)):
        fail("final_model did not reload with finite params of the model's structure")
    for key, got, ref in (("loss", hist["step_loss"][0], REF_TRAIN_LOSS),
                          ("grad_norm", hist["grad_norm"][0], REF_GRAD_NORM)):
        rel = abs(got - ref) / ref
        print(f"first train step {key}={got:.9f} JAX-CPU reference={ref} rel_err={rel:.2e} "
              f"(limit {REF_RTOL})")
        if rel > REF_RTOL:
            fail(f"first train step {key} disagrees with the JAX reference")
    report.update(train_history=hist, train_launches=train_launches, train_s=train_s)

    # 5. timing
    with torch.no_grad():
        ms = time_ms(lambda: fused_rk4.fused_rk4_fwd(*packed, SUBSTEPS), 3, 20)
        plain_ms = time_ms(lambda: fused_rk4._fwd_plain(*packed, SUBSTEPS), 1, 10)
        traj_full, gbar_full = bwd_inputs(packed, T, SUBSTEPS)
        bwd_ms = time_ms(lambda: fused_rk4.fused_rk4_bwd(traj_full, gbar_full, *packed[1:],
                                                         SUBSTEPS), 2, 20)
    nn = params["nn"]
    steps = COHORT * (T - 1) * SUBSTEPS
    fwd_ops, bwd_ops = kernel_ops(nn, config.nn_layers, config.nn_hidden, COHORT, T, SUBSTEPS, C)
    n_w = packed[5].flat.numel()
    in_bytes = 4 * (3 * T * COHORT + C * COHORT + n_w + 32)
    fwd_bytes = in_bytes + 4 * (COHORT * 6 + T * 6 * COHORT)
    bwd_bytes = in_bytes + 4 * (2 * T * 6 * COHORT + COHORT * 6 + n_w + 17 * COHORT + C * COHORT)
    bound_ms, bound_by, _, t_bytes = bound(fwd_ops, fwd_bytes)
    bwd_bound_ms, bwd_bound_by, _, bwd_t_bytes = bound(bwd_ops, bwd_bytes)
    print(f"timing ({smi}): fwd kernel {ms:.3f} ms = {steps / ms * 1e3:.4e} substeps/s; plain "
          f"{plain_ms:.3f} ms = {steps / plain_ms * 1e3:.4e} substeps/s; bound {bound_ms:.3f} ms "
          f"({fwd_ops:.4e} FLOP at f32 peak; {fwd_bytes} B = {t_bytes:.4f} ms at HBM peak)")
    print(f"timing ({smi}): bwd kernel {bwd_ms:.3f} ms at B={COHORT}; plain "
          f"{bwd_plain_s * 1e3:.3f} ms once at B={BWD_B}; bound {bwd_bound_ms:.3f} ms "
          f"({bwd_ops:.4e} FLOP at f32 peak; {bwd_bytes} B = {bwd_t_bytes:.4f} ms at HBM peak)")

    lambda2 = cfg["training"]["lambda2"]
    train_batch = dict(batch, external_inputs={"meal": sig["meal"], "tVNS": sig["tVNS"]},
                       mask=torch.ones((COHORT, T), device=device),
                       loss_weights=torch.as_tensor(ds.loss_weights, device=device))
    step128 = train_step_fn(state["params"], train_batch, config, lambda2)
    step_ms = time_ms(step128, 2, 20)
    bench_cfg = config_from_dict({"model": {"solver": "rk4", "nn_hidden": 64, "substeps": 4,
                                            "use_pallas": True}})
    p64 = init_hybrid_params(torch.Generator().manual_seed(0), bench_cfg)
    p64["nn"]["w4"] = 0.01 * torch.randn(p64["nn"]["w4"].shape,
                                         generator=torch.Generator().manual_seed(2))
    step64_ms = time_ms(train_step_fn(p64, bench_train_batch(device), bench_cfg, lambda2), 2, 20)
    b64 = kernel_ops(p64["nn"], 4, 64, COHORT, T, SUBSTEPS)
    train_bounds = {"H128_C16": bound_ms + bwd_bound_ms,
                    "H64": (b64[0] + b64[1]) / PEAK_F32_FLOPS * 1e3}
    print(f"timing ({smi}): train step (fwd kernel + bwd kernel + loss + Adam) at B={COHORT} "
          f"T={T}: H=128 C=16 {step_ms:.3f} ms (kernel bound {train_bounds['H128_C16']:.3f} ms); "
          f"H=64 no context {step64_ms:.3f} ms (kernel bound {train_bounds['H64']:.3f} ms)")

    wall_ms, kernels = profile_ms(step128)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"profile ({smi}): one train step at B={COHORT} H=128 C=16: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} "
          "kernel names; top: " + "; ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, (ms, n) in top))
    report["train_step_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": kernels}

    entries = [
        {"name": "fused_rk4_fwd", "route": "cuda",
         "source": "hybrid_ode_torch/csrc/fused_rk4_fwd.cu",
         "replaces": "hybrid_ode_tpu/ops/pallas_rk4.py:253",
         "launches": launches + train_launches[0], "max_abs_err": max(max_abs.values()),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None},
        {"name": "fused_rk4_bwd", "route": "cuda",
         "source": "hybrid_ode_torch/csrc/fused_rk4_bwd.cu",
         "replaces": "hybrid_ode_tpu/ops/pallas_rk4.py:414",
         "launches": train_launches[1], "max_abs_err": max(bwd_max_abs.values()),
         "ms": bwd_ms, "plain_ms": bwd_plain_s * 1e3, "plain_batch": BWD_B,
         "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by, "library_ms": None},
    ]
    report.update(kernels=entries, flops={"fwd": fwd_ops, "bwd": bwd_ops},
                  bytes={"fwd": fwd_bytes, "bwd": bwd_bytes}, substeps=steps,
                  train_step_ms={"H128_C16": step_ms, "H64": step64_ms},
                  train_step_bound_ms=train_bounds)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1, default=float))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
