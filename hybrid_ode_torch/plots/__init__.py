"""Figures, tables and Sobol sensitivity (matplotlib and pandas imported when used)."""

from hybrid_ode_torch.plots.figures import (
    generate_performance_tables,
    plot_fig1_predictions,
    plot_fig2_sensitivity,
    plot_fig3_posterior_bands,
)
from hybrid_ode_torch.plots.sobol import saltelli_sample, sobol_analyze, sobol_sensitivity

__all__ = [
    "saltelli_sample",
    "sobol_analyze",
    "sobol_sensitivity",
    "plot_fig1_predictions",
    "plot_fig2_sensitivity",
    "plot_fig3_posterior_bands",
    "generate_performance_tables",
]
