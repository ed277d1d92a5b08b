"""Architecture registry: ``--arch <id>`` resolves here. Port of
``repro/configs``; the port serves the dense decoder family (qwen3-1.7b,
deepseek-coder-33b, minitron-8b, gemma3-12b), the mixture-of-experts
mixtral-8x22b and deepseek-v2-lite (MLA), the encoder-decoder
seamless-m4t-large-v2, the vision-prefix paligemma-3b, the
attention-free SSM falcon-mamba-7b and the RG-LRU + local-attention
hybrid recurrentgemma-9b."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.shapes import ArchSpec  # noqa: F401

ARCH_IDS: List[str] = ["seamless_m4t_large_v2", "paligemma_3b", "gemma3_12b", "qwen3_1_7b",
                       "minitron_8b", "deepseek_coder_33b", "mixtral_8x22b",
                       "deepseek_v2_lite_16b", "falcon_mamba_7b", "recurrentgemma_9b"]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({"qwen3-1.7b": "qwen3_1_7b", "deepseek-v2-lite": "deepseek_v2_lite_16b",
                "seamless-m4t-large-v2": "seamless_m4t_large_v2"})


def get_arch(name: str) -> ArchSpec:
    key = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}").ARCH
