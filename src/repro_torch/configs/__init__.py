"""Architecture registry of the port: ``--arch <id>`` resolution.

The dense family
(``qwen1.5-0.5b``, ``starcoder2-3b``, ``olmo-1b``, ``gemma2-2b``),
``mamba2-780m`` (the model whose prefill runs the SSD kernels), the
MoE family with FISH expert routing (``deepseek-v2-lite-16b`` with MLA,
``kimi-k2-1t-a32b`` with GQA) and the Griffin hybrid
(``recurrentgemma-9b``: RG-LRU blocks and local MQA), and the two
frontend-stub models: ``qwen2-vl-2b`` (embedding input, M-RoPE) and
``whisper-large-v3`` (encoder-decoder with cross attention): the JAX
package's registry, in its order.
"""

import importlib
from typing import List

from .base import (MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SHAPES,
                   ShapeConfig, SSMConfig, reduced_config)

_ARCH_MODULES = {
    "mamba2-780m": "mamba2_780m",
    "qwen1.5-0.5b": "qwen15_05b",
    "starcoder2-3b": "starcoder2_3b",
    "olmo-1b": "olmo_1b",
    "gemma2-2b": "gemma2_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-large-v3": "whisper_large_v3",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        mod_name = _ARCH_MODULES[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; one of {list_archs()}")
    return importlib.import_module(f".{mod_name}", __package__).CONFIG


__all__ = [
    "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
    "ShapeConfig", "SHAPES", "reduced_config", "list_archs", "get_config",
]
