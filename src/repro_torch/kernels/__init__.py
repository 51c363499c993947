"""Hand-written CUDA kernels for the system's hot spots, and their plain versions.

gram   — ctypes wrappers of the CUDA kernels in ``csrc/`` (launch counters,
         argument checks, error checks after each launch)
ops    — public entry points: dispatch by device (CUDA kernel / plain torch),
         plus the Theorem-4 triangular codec and bucketing helpers
ref    — plain PyTorch versions of every kernel (CPU path and card-side oracle)
_build — compiles ``csrc/*.cu`` with nvcc for sm_90a on first use
"""
