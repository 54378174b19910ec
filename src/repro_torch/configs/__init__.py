"""Config registry: ``get_config("<arch-id>")``, mirroring ``repro.configs``.

The dense decoder, MoE, VLM and hybrid configs are ported so far; the
other families' configs come with the port of their model code.
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

PORTED: List[str] = ["granite_3_2b", "phi3_mini_38b", "qwen15_32b", "h2o_danube_3_4b",
                     "gpt_36b", "gpt_20b", "gpt_175b", "olmoe_1b_7b", "deepseek_moe_16b",
                     "internvl2_1b", "hymba_15b"]


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {', '.join(ARCH_IDS)}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{mod_name} is not ported yet: the port serves the dense, MoE, VLM "
            f"and hybrid decoders {', '.join(PORTED)}; the other model families come "
            "with a later PR (ROADMAP Queue 1, item 4: other families)")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
