"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

The port knows the reference's ten architecture ids (``ARCH_IDS``) and
builds them all (``PORTED``); any other id raises ``KeyError``. ``RIDGE``
is the paper's own ridge configuration (§V-A defaults).
"""
from repro_torch.configs import (
    gemma3_27b,
    hubert_xlarge,
    jamba_15_large,
    minitron_8b,
    mixtral_8x22b,
    phi35_moe,
    pixtral_12b,
    qwen2_72b,
    ridge,
    rwkv6_16b,
    yi_9b,
)
from repro_torch.models.config import ArchConfig

ARCH_IDS = ("gemma3-27b", "qwen2-72b", "yi-9b", "phi3.5-moe-42b-a6.6b",
            "jamba-1.5-large-398b", "mixtral-8x22b", "hubert-xlarge",
            "rwkv6-1.6b", "minitron-8b", "pixtral-12b")
_MODULES = {
    "gemma3-27b": gemma3_27b,
    "qwen2-72b": qwen2_72b,
    "yi-9b": yi_9b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "jamba-1.5-large-398b": jamba_15_large,
    "mixtral-8x22b": mixtral_8x22b,
    "minitron-8b": minitron_8b,
    "hubert-xlarge": hubert_xlarge,
    "rwkv6-1.6b": rwkv6_16b,
    "pixtral-12b": pixtral_12b,
}
PORTED = tuple(_MODULES)
RIDGE = ridge.CONFIG


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return _MODULES[arch_id]


def get(arch_id: str) -> ArchConfig:
    """Full-size config for ``--arch <id>``."""
    cfg = _module(arch_id).CONFIG
    cfg.validate()
    return cfg


def get_reduced(arch_id: str) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests."""
    cfg = _module(arch_id).REDUCED
    cfg.validate()
    return cfg
