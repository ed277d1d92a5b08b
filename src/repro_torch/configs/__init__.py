"""Architecture registry: ``--arch <id>`` resolves here. Port of
``repro/configs``; the port serves the dense decoder family (qwen3-1.7b,
deepseek-coder-33b, minitron-8b) and the mixture-of-experts mixtral-8x22b
and deepseek-v2-lite (MLA)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.shapes import ArchSpec  # noqa: F401

ARCH_IDS: List[str] = ["qwen3_1_7b", "minitron_8b", "deepseek_coder_33b",
                       "mixtral_8x22b", "deepseek_v2_lite_16b"]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({"qwen3-1.7b": "qwen3_1_7b", "deepseek-v2-lite": "deepseek_v2_lite_16b"})


def get_arch(name: str) -> ArchSpec:
    key = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}").ARCH
