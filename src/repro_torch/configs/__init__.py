"""Config registry: ``get_config("<arch-id>")``, mirroring ``repro.configs``.

Every architecture the reference builds is ported (``PORTED`` is
``ARCH_IDS``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "internvl2_1b",
    "xlstm_125m",
    "h2o_danube_3_4b",
    "qwen15_32b",
    "granite_3_2b",
    "phi3_mini_38b",
    "olmoe_1b_7b",
    "deepseek_moe_16b",
    "whisper_base",
    "hymba_15b",
    # the paper's own models
    "gpt_36b",
    "gpt_20b",
    "gpt_175b",
]

ALIASES: Dict[str, str] = {
    "internvl2-1b": "internvl2_1b",
    "xlstm-125m": "xlstm_125m",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen1.5-32b": "qwen15_32b",
    "granite-3-2b": "granite_3_2b",
    "phi3-mini-3.8b": "phi3_mini_38b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-base": "whisper_base",
    "hymba-1.5b": "hymba_15b",
    "gpt-3.6b": "gpt_36b",
    "gpt-20b": "gpt_20b",
    "gpt-175b": "gpt_175b",
}

PORTED: List[str] = list(ARCH_IDS)


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
