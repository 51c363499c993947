"""Core: the paper's contribution — one-shot sufficient-statistic fusion."""
from repro_torch.core.sufficient_stats import (
    SuffStats,
    compute_stats,
    compute_stats_streaming,
    fuse_stats,
    streaming_update,
    zeros_like_stats,
)
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
]
