"""Architecture spec: the published (full) config and its reduced smoke
config. Port of the part of ``repro/configs/shapes.py`` the serving
slice needs (the dry-run input specs wait)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One architecture: exact full config + reduced smoke config."""

    name: str
    full: object   # ModelConfig
    smoke: object  # ModelConfig
    notes: str = ""
