from repro_torch.fed import chaos, transport, wire
from repro_torch.fed.comm import (
    CommRecord,
    ShardedCommRecord,
    crossover_rounds,
    fedavg_comm,
    measured_one_shot,
    one_shot_comm,
    sharded_oneshot_record,
)
from repro_torch.fed.protocol import (
    PackedStats,
    RunResult,
    client_phase,
    run_centralized,
    run_loco_cv,
    run_one_shot,
    run_one_shot_projected,
)
from repro_torch.fed.fedavg import IterativeConfig, one_gradient_step, run_iterative

__all__ = [
    "CommRecord", "ShardedCommRecord", "crossover_rounds", "fedavg_comm",
    "measured_one_shot", "one_shot_comm", "sharded_oneshot_record",
    "PackedStats", "RunResult", "client_phase", "run_centralized",
    "run_loco_cv", "run_one_shot", "run_one_shot_projected",
    "IterativeConfig", "one_gradient_step", "run_iterative",
    "wire", "transport", "chaos",
]
