from repro_torch.checkpoint.checkpoint import latest_step, load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree", "latest_step"]
