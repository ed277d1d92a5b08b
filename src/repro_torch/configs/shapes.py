"""Architecture spec: the published (full) config and its reduced smoke
config, and an encoder-decoder arch's source length (a vision arch's
patch count is its config's ``vision_tokens``, as in the reference). Port
of the part of ``repro/configs/shapes.py`` the serving slice needs (the
dry-run input specs wait)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One architecture: exact full config + reduced smoke config."""

    name: str
    full: object   # ModelConfig
    smoke: object  # ModelConfig
    # encoder source length (encoder-decoder archs): the frames the stub provides
    enc_src_len: int = 0
    notes: str = ""
