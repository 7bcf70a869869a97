"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Only the architectures whose model code the port runs are registered; the
JAX package's other ids raise ``KeyError`` naming them as not ported yet.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

#: ids the JAX package knows whose families the port does not run yet.
NOT_PORTED = ("seamless-m4t-large-v2", "qwen2-vl-2b")

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        if arch_id in NOT_PORTED:
            raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                           f"{sorted(_MODULES)}")
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
