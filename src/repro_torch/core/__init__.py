"""Core: the paper's contribution — one-shot sufficient-statistic fusion."""
from repro_torch.core.sufficient_stats import (
    SuffStats,
    compute_stats,
    compute_stats_streaming,
    distributed_stats,
    fuse_stats,
    streaming_update,
    zeros_like_stats,
)
from repro_torch.core.privacy import (
    advanced_composition,
    central_dp_stats,
    clip_rows,
    gaussian_tau,
    make_dp_noise_fn,
    per_round_budget,
    privatize_stats,
    psd_repair,
)
from repro_torch.core.features import FeatureMap, feature_hash
from repro_torch.core.projection import (
    error_bound,
    lift,
    make_projection,
    project_data,
    projected_stats,
    upload_floats,
)
from repro_torch.core.rff import RFFMap, kernel_gram_exact, make_rff, rff_stats
from repro_torch.core.fusion import (
    condition_number,
    coverage,
    dropout_fusion,
    loco_cv,
    mse,
    one_shot_fusion,
    solve_ridge,
)
from repro_torch.core.equilibrium import (
    equilibrium_residual,
    residual_bound,
    solve_cg,
)
from repro_torch.core.probe import (
    ProbeResult,
    one_shot_probe,
    probe_mse,
    solve_head,
)

__all__ = [
    "SuffStats", "compute_stats", "compute_stats_streaming",
    "distributed_stats", "fuse_stats",
    "streaming_update", "zeros_like_stats",
    "condition_number", "coverage", "dropout_fusion", "loco_cv", "mse",
    "one_shot_fusion", "solve_ridge",
    "advanced_composition", "central_dp_stats", "clip_rows", "gaussian_tau",
    "make_dp_noise_fn", "per_round_budget", "privatize_stats", "psd_repair",
    "FeatureMap", "feature_hash",
    "error_bound", "lift", "make_projection", "project_data",
    "projected_stats", "upload_floats",
    "RFFMap", "kernel_gram_exact", "make_rff", "rff_stats",
    "equilibrium_residual", "residual_bound", "solve_cg",
    "ProbeResult", "one_shot_probe", "probe_mse", "solve_head",
]
