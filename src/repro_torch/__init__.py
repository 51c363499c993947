"""PyTorch / CUDA port of the one-shot federated ridge system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``server/``, ``fed/``, ``data/``) and its public
names, argument order and layouts, so each function has an obvious
counterpart. It imports neither ``jax`` nor anything of ``repro``.

Devices: entry points that create tensors (``zeros_like_stats``,
``DenseBackend``, ``FusionEngine``, ``data.synthetic.generate``) default to
``device="cuda"``; everything else runs on the device of the tensors it is
given. There is no kernel on/off switch: a CUDA tensor always goes through
the hand-written CUDA kernel (``csrc/``), a CPU tensor through the kernel's
plain PyTorch version.

Precision: float32 matrix products outside the kernels (Cholesky, triangular
solves, ``eigh``, query predictions) run in full float32. TF32 is switched
off here explicitly for cuBLAS and cuDNN, because TF32 keeps about three
decimal digits and the engine's exactness contracts assume float32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["core", "kernels", "server", "fed", "data", "checkpoint", "convert"]
