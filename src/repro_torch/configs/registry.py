"""Architecture registry of the port: ``--arch <id>`` -> config.

Ported so far: the dense LM architectures and the four recsys models; any
other id of the reference's registry raises ``KeyError``.
"""
from __future__ import annotations

from typing import Any

from . import bst, codeqwen1_5_7b, din, mind, qwen3_8b, two_tower_retrieval, yi_6b

_MODULES = {m.ARCH_ID: m for m in (yi_6b, codeqwen1_5_7b, qwen3_8b, din, bst, mind,
                                   two_tower_retrieval)}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"architecture {arch_id!r} is not ported yet; ported: "
                       f"{', '.join(ARCH_IDS)}")
    return _MODULES[arch_id]


def get_config(arch_id: str, *, smoke: bool = False) -> Any:
    m = _module(arch_id)
    return m.smoke_config() if smoke else m.full_config()


def family(arch_id: str) -> str:
    """"lm" or "recsys"."""
    return _module(arch_id).FAMILY
