"""Registry of assigned architectures (+ the paper's own clustering workload).

``get_config(arch_id)`` returns the full published config;
``get_reduced(arch_id)`` returns the family-preserving smoke-test config.
"""

from __future__ import annotations

from repro_torch.configs import (
    codeqwen1_5_7b,
    deepseek_v3_671b,
    gemma2_27b,
    gemma3_4b,
    internvl2_76b,
    mamba2_2_7b,
    qwen2_moe_a2_7b,
    qwen3_4b,
    recurrentgemma_9b,
    seamless_m4t_medium,
)

_MODULES = {
    "internvl2-76b": internvl2_76b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "gemma2-27b": gemma2_27b,
    "gemma3-4b": gemma3_4b,
    "qwen3-4b": qwen3_4b,
    "mamba2-2.7b": mamba2_2_7b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "seamless-m4t-medium": seamless_m4t_medium,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str):
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str):
    return _MODULES[arch_id].reduced()
