"""Config registry of the port: ``get_config("deepseek-7b")``.

Only the architectures the port serves are registered; the others join
with the slices that port their block kinds."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import deepseek_7b
from repro_torch.configs.base import (ATTN_GLOBAL, ModelConfig, QuantConfig,
                                      reduce_for_smoke)

_REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in (deepseek_7b.CONFIG,)}


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") \
            from None


__all__ = ["ATTN_GLOBAL", "ModelConfig", "QuantConfig", "get_config",
           "reduce_for_smoke"]
