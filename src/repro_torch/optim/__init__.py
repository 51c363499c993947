from repro_torch.optim.adamw import AdamWConfig, apply, init, schedule

__all__ = ["AdamWConfig", "apply", "init", "schedule"]
