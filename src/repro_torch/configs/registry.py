"""Architecture registry of the port: ``--arch <id>`` -> config.

Only the dense LM architectures are ported so far; any other id of the
reference's registry raises ``KeyError``.
"""
from __future__ import annotations

from typing import Any

from . import codeqwen1_5_7b, qwen3_8b, yi_6b

_MODULES = {m.ARCH_ID: m for m in (yi_6b, codeqwen1_5_7b, qwen3_8b)}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"architecture {arch_id!r} is not ported yet; ported: "
                       f"{', '.join(ARCH_IDS)}")
    return _MODULES[arch_id]


def get_config(arch_id: str, *, smoke: bool = False) -> Any:
    m = _module(arch_id)
    return m.smoke_config() if smoke else m.full_config()
