"""Figure: counterfactual dosing intervention, confounded vs causal routing.

Copy of `hybrid_ode_tpu/plots/intervention.py` (matplotlib, imported when the
figure is drawn). It draws the dose-response artifacts that
`benchmarks/intervention.py` writes (results/intervention_dose_response*.json):

  A. Dose-response: per-arm mean glucose shift against the factual protocol,
     model-predicted per routing beside the simulator's truth.
  B. Per-window predicted-vs-true policy effect (the withheld-insulin arm),
     with the identity line.

Series colours are fixed (causal blue, confounded orange), truth in ink.

    python -m hybrid_ode_torch.plots.intervention
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

CAUSAL = "#2a78d6"      # series 1 (blue)
CONFOUNDED = "#eb6834"  # series 2 (orange)
INK = "#0b0b0b"
MUTED = "#52514e"


def fig_intervention(
    nn_path: str = "results/intervention_dose_response.json",
    mech_path: Optional[str] = "results/intervention_dose_response_mech.json",
    save_path: str = "results/figures/fig_intervention.png",
):
    """Render the intervention figure from whichever artifacts exist."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing figures needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    arms = {}
    nn = json.loads(Path(nn_path).read_text())
    arms["NN routing (confounded)"] = (nn, CONFOUNDED)
    if mech_path and Path(mech_path).exists():
        mech = json.loads(Path(mech_path).read_text())
        arms["mechanistic routing (causal)"] = (mech, CAUSAL)

    fig, (ax_a, ax_b) = plt.subplots(1, 2, figsize=(11, 4.4))
    for ax in (ax_a, ax_b):
        ax.grid(True, alpha=0.25, linewidth=0.6)
        ax.spines[["top", "right"]].set_visible(False)

    # ---- panel A: dose-response of the mean glucose shift -----------------
    ref = next(iter(arms.values()))[0]
    scales = sorted(float(s) for s in ref["arms"])
    factual = ref["arms"].get("1.0") or ref["arms"][str(1.0)]
    true_shift = [ref["arms"][f"{s:g}" if f"{s:g}" in ref["arms"] else str(s)]
                  ["true_mean_glucose"] - factual["true_mean_glucose"]
                  for s in scales]
    ax_a.plot(scales, true_shift, color=INK, ls="--", marker="o", ms=5,
              lw=1.6, label="simulator truth", zorder=3)
    for name, (r, color) in arms.items():
        fac = r["arms"].get("1.0") or r["arms"][str(1.0)]
        pred = [r["arms"][f"{s:g}" if f"{s:g}" in r["arms"] else str(s)]
                ["pred_mean_glucose"] - fac["pred_mean_glucose"]
                for s in scales]
        ax_a.plot(scales, pred, color=color, marker="o", ms=5, lw=2,
                  label=name)
    ax_a.axhline(0.0, color=MUTED, lw=0.8)
    ax_a.axvline(1.0, color=MUTED, lw=0.8, ls=":")
    ax_a.text(1.02, ax_a.get_ylim()[1] * 0.9, "factual", color=MUTED,
              fontsize=8)
    ax_a.set_xlabel("insulin dose scale (× deployed protocol gain)")
    ax_a.set_ylabel("mean glucose shift vs factual (mmol/L)")
    ax_a.set_title("A  Counterfactual dose-response", loc="left",
                   fontsize=11, color=INK)
    ax_a.legend(frameon=False, fontsize=8)

    # ---- panel B: per-window effect scatter, withheld-insulin arm ---------
    key0 = "0.0"
    plotted = False
    lims = [0.0, 0.0]
    for name, (r, color) in arms.items():
        eff = r["policy_effects_vs_factual"].get(key0, {})
        if "e_true" not in eff:
            continue
        e_t = np.asarray(eff["e_true"])
        e_m = np.asarray(eff["e_model"])
        ax_b.scatter(e_t, e_m, s=9, alpha=0.45, color=color, edgecolors="none",
                     label=f"{name}  (r={eff['pearson_r']:.2f}, "
                           f"sign {eff['sign_agreement_pct']:.0f}%)")
        lims = [min(lims[0], e_t.min(), e_m.min()),
                max(lims[1], e_t.max(), e_m.max())]
        plotted = True
    if plotted:
        pad = 0.1 * (lims[1] - lims[0] + 1e-9)
        lo, hi = lims[0] - pad, lims[1] + pad
        ax_b.plot([lo, hi], [lo, hi], color=MUTED, lw=1.0, ls="--")
        ax_b.text(hi, hi, " identity", color=MUTED, fontsize=8,
                  ha="left", va="center")
        ax_b.set_xlim(lo, hi)
        ax_b.legend(frameon=False, fontsize=8)
    else:
        ax_b.text(0.5, 0.5, "per-window effects not in artifact\n"
                  "(re-run benchmarks/intervention.py)", ha="center",
                  va="center", color=MUTED, transform=ax_b.transAxes)
    ax_b.set_xlabel("true policy effect per window (mmol/L)")
    ax_b.set_ylabel("model-predicted effect (mmol/L)")
    ax_b.set_title("B  Withheld-insulin arm: per-window transport",
                   loc="left", fontsize=11, color=INK)

    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


if __name__ == "__main__":
    print(fig_intervention())
