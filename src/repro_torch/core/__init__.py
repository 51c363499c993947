"""Core: the paper's contribution — one-shot sufficient-statistic fusion."""
from repro_torch.core.sufficient_stats import (
    SuffStats,
    compute_stats,
    compute_stats_streaming,
    fuse_stats,
    streaming_update,
    zeros_like_stats,
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

__all__ = [
    "SuffStats", "compute_stats", "compute_stats_streaming", "fuse_stats",
    "streaming_update", "zeros_like_stats",
    "condition_number", "coverage", "dropout_fusion", "loco_cv", "mse",
    "one_shot_fusion", "solve_ridge",
    "FeatureMap", "feature_hash",
    "error_bound", "lift", "make_projection", "project_data",
    "projected_stats", "upload_floats",
    "RFFMap", "kernel_gram_exact", "make_rff", "rff_stats",
]
