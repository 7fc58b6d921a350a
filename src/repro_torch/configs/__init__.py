"""Model configurations of the port: the MF configs (``heat_mf.py``) and the
LM architecture registry.

``get_config(name)`` accepts the reference's architecture ids (hyphenated)
or module names, as ``src/repro/configs/__init__.py`` does.  Only the
architectures whose family the port trains are registered; the others raise
with the ``ROADMAP.md`` item that brings their family.
"""
from __future__ import annotations

import importlib

#: architectures the port trains, id -> module under ``repro_torch.configs``.
ARCH_MODULES = {
    "smollm-360m": "smollm_360m",
}

#: the reference's other architectures, id -> the family the port still lacks.
WAITING = {
    "llama4-maverick-400b-a17b": "moe",
    "moonshot-v1-16b-a3b": "moe",
    "mamba2-370m": "ssm",
    "zamba2-2.7b": "hybrid",
    "minitron-4b": "dense (config not yet copied)",
    "granite-8b": "dense (config not yet copied)",
    "command-r-35b": "dense (config not yet copied)",
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
        raise ValueError(
            f"architecture {name!r} ({WAITING[key]}) waits for the "
            "remaining LM families and configs (ROADMAP.md, queue A, "
            "'Rest of the LM side')")
    if key not in ARCH_MODULES:
        raise ValueError(f"unknown architecture {name!r}; available: "
                         f"{ARCH_NAMES}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[key]}").CONFIG
