"""Model configurations of the port: the MF configs (``heat_mf.py``) and the
LM architecture registry.

``get_config(name)`` accepts the reference's architecture ids (hyphenated)
or module names, as ``src/repro/configs/__init__.py`` does.  Every
architecture of the reference is registered (copies of its configs, field
for field).
"""
from __future__ import annotations

import importlib

#: architectures the port trains, id -> module under ``repro_torch.configs``.
ARCH_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2p7b",
    "minitron-4b": "minitron_4b",
    "granite-8b": "granite_8b",
    "smollm-360m": "smollm_360m",
    "command-r-35b": "command_r_35b",
    "whisper-medium": "whisper_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

ARCH_NAMES = list(ARCH_MODULES)


def get_config(name: str):
    """The named architecture's ``CONFIG`` (an
    :class:`~repro_torch.models.config.ArchConfig`); raises ``ValueError``
    for an unknown name."""
    key = name if name in ARCH_MODULES else next(
        (k for k, m in ARCH_MODULES.items() if m == name), name)
    if key not in ARCH_MODULES:
        raise ValueError(f"unknown architecture {name!r}; available: "
                         f"{ARCH_NAMES}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[key]}").CONFIG
