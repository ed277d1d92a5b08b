"""Logical sharding rules of the port (``repro.sharding``'s counterpart):
parameter and cache path patterns resolved to a placement on a port
``Mesh`` (``launch/mesh.py``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    CACHE_RULES,
    PARAM_RULES,
    batch_shardings,
    cache_shardings,
    match_rule,
    param_shardings,
    replicated,
    resolve_spec,
    serve_tp_shardable,
    tree_shardings,
    unmatched_large_leaves,
)
