"""Model configurations of the port: the MF configs (``heat_mf.py``) and the
LM architecture registry.

``get_config(name)`` accepts the reference's architecture ids (hyphenated)
or module names, as ``src/repro/configs/__init__.py`` does.  The dense and
MoE architectures are registered (copies of the reference's configs, field
for field); the SSM, hybrid, audio and VLM ones raise, naming the slice of
the port that brings their family.
"""
from __future__ import annotations

import importlib

#: architectures the port trains, id -> module under ``repro_torch.configs``.
ARCH_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "minitron-4b": "minitron_4b",
    "granite-8b": "granite_8b",
    "smollm-360m": "smollm_360m",
    "command-r-35b": "command_r_35b",
}

#: the reference's other architectures, id -> the family the port still lacks.
WAITING = {
    "mamba2-370m": "ssm",
    "zamba2-2.7b": "hybrid",
    "whisper-medium": "audio",
    "qwen2-vl-2b": "vlm",
}

ARCH_NAMES = list(ARCH_MODULES)


def get_config(name: str):
    """The named architecture's ``CONFIG`` (an
    :class:`~repro_torch.models.config.ArchConfig`); raises ``ValueError``
    for an architecture the port does not train yet."""
    key = name if name in ARCH_MODULES or name in WAITING else next(
        (k for k, m in ARCH_MODULES.items() if m == name), name)
    if key in WAITING:
        from repro_torch.models.lm import WAITING_FAMILIES
        raise ValueError(
            f"architecture {name!r} ({WAITING[key]}) waits for "
            f"{WAITING_FAMILIES[WAITING[key]]}")
    if key not in ARCH_MODULES:
        raise ValueError(f"unknown architecture {name!r}; available: "
                         f"{ARCH_NAMES}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[key]}").CONFIG
