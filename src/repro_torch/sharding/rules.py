"""Logical sharding rules: parameter/cache/batch path patterns -> a
placement, resolved against a mesh. Port of ``repro/sharding/rules.py``.

Axes convention (``launch/mesh.py``):
  dp axes — ("data",) single-pod, ("pod", "data") multi-pod: batch dim.
  tp axis — "model": attention heads / MLP hidden / expert ff / vocab.

Rules are written for the *trailing* dims of each leaf; leading stacked
dims (scan groups) are padded with None. A spec axis is dropped (-> None)
when the dim size is not divisible by the mesh axis size.

A placement is a tuple with one entry per dimension: None (replicated),
an axis name, or a tuple of axis names — the entries of the reference's
``PartitionSpec``, which compares equal to ``tuple(spec)``. ``()`` is
fully replicated.

The reference's ``logical_axes``, ``shard_hint`` and its ambient-mesh
lookup steer XLA's partitioner inside jitted bodies. The port runs its
ranks eagerly (``substrate.ShardedPrepared`` gathers its columns itself),
so they have no counterpart here.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from repro_torch import tree as tree_lib

Pytree = Any
Spec = Tuple  # one entry per dim: None | axis name | tuple of axis names

# (regex on leaf path, spec for trailing dims). First match wins.
# "D" -> dp axes, "T" -> tp axis, None -> replicated dim.
PARAM_RULES: Sequence[Tuple[str, Tuple]] = (
    (r"embed/embedding$", ("T", None)),
    (r"lm_head/w$", (None, "T")),
    # attention projections
    (r"mixer/(q|k|v|k_up|v_up)/w$", (None, "T")),
    (r"mixer/kv_down/w$", (None, None)),  # tiny MLA latent projection
    (r"mixer/o/w$", ("T", None)),
    # serve-time fused leaves (substrate/prepared.py concatenates
    # same-input siblings over N): columns stay column-parallel. The
    # _q_kvd fusion drags the tiny kv_down columns along — harmless,
    # column independence makes any contiguous partition exact.
    (r"mixer/(_qkv|_q_kvd|_kup_vup)/w$", (None, "T")),
    (r"ffn(/shared)?/_gate_up/w$", (None, "T")),
    (r"xattn/(q|k|v)/w$", (None, "T")),
    (r"xattn/o/w$", ("T", None)),
    # dense MLP
    (r"ffn/(gate|up)/w$", (None, "T")),
    (r"ffn/down/w$", ("T", None)),
    # MoE expert stacks (E, d, f) / (E, f, d): expert-parallel over the
    # model axis when E divides it; otherwise 2D (d over data, ff over
    # model)
    (r"ffn/(gate_w|up_w)$", ("EP", "D", "T")),
    (r"ffn/down_w$", ("EP", "T", "D")),
    (r"ffn/router/w$", (None, None)),
    (r"ffn/shared/(gate|up)/w$", (None, "T")),
    (r"ffn/shared/down/w$", ("T", None)),
    # Mamba SSM
    (r"mixer/in_proj/w$", (None, "T")),
    (r"mixer/x_proj/w$", ("T", None)),
    (r"mixer/dt_proj/w$", (None, "T")),
    (r"mixer/out_proj/w$", ("T", None)),
    (r"mixer/a_log$", ("T", None)),
    (r"mixer/(conv_b|d_skip|dt_bias)$", ("T",)),
    (r"mixer/conv_w$", (None, "T")),
    # RG-LRU
    (r"mixer/(in_x|in_y|gate_a|gate_x)/w$", (None, "T")),
    (r"mixer/out/w$", ("T", None)),
    (r"mixer/lambda_p$", ("T",)),
    # norms: EXPLICITLY replicated — stacked-over-layers scale/bias grow
    # past the large-leaf threshold on deep configs, and an explicit rule
    # keeps unmatched_large_leaves() meaning "rules-table gap", not
    # "known-replicated peripheral"
    (r"norm\d*/(scale|bias)$", ()),
    # adapters (lora_a/lora_b/dora_m) + everything else: replicated
)

CACHE_RULES: Sequence[Tuple[str, Tuple]] = (
    # KV cache (B, L, kvh, hd): the SEQUENCE dim over the model axis
    (r"/(k|v)$", ("D", "T", None, None)),
    (r"/c_kv$", ("D", "T", None)),  # MLA latent cache
    (r"/k_rope$", ("D", "T", None)),
    (r"/h$", ("D", "T", None)),  # SSM state (B, d_inner, N)
    (r"/conv$", ("D", None, "T")),
    (r"/enc_out$", ("D", None, None)),
)
# RG-LRU h is (B, d_rnn) — 2D; the ("D","T",None) rule is trimmed to rank.


def _as_tuple(a):
    return a if isinstance(a, tuple) else (a,)


def _path_str(path) -> str:
    """A port tree path (a tuple of str, ``tree.map_with_path``) spelled as
    the reference spells a jax key path: "body/0/mixer/q/w"."""
    return tree_lib.path_str(path)


def match_rule(rules, path: str) -> Optional[Tuple]:
    """First rule spec whose pattern matches `path`, else None."""
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return None


def serve_tp_shardable(path: str, rules=PARAM_RULES) -> bool:
    """True when `path` matches a rule that tensor-parallelises ("T"
    anywhere in the spec): the serve-TP wrap policy's test of which
    prepared leaves to column-shard."""
    spec = match_rule(rules, path)
    return spec is not None and "T" in spec


def resolve_spec(
    path: str,
    shape: Tuple[int, ...],
    axis_sizes,
    rules=PARAM_RULES,
    *,
    dp: Tuple[str, ...] = ("data",),
    tp: str = "model",
) -> Spec:
    """A leaf path and shape resolved to a placement against a mapping of
    mesh axis name -> size (``Mesh.shape`` or a plain dict)."""
    spec = match_rule(rules, path)
    if spec is None:
        return ()  # replicated
    if spec and spec[0] == "EP":
        # expert-parallel preferred: shard E over tp; fall back to the 2D
        # (D, T) layout when E doesn't divide the model axis. Stacked scan
        # bodies carry a leading group axis -> 4D.
        e = shape[-3] if len(shape) >= 3 else 0
        if e and e % axis_sizes[tp] == 0:
            spec = ("T", None, None)
        else:
            spec = (None,) + tuple(spec[1:])
    spec = spec[-len(shape):] if len(spec) > len(shape) else spec
    pad = len(shape) - len(spec)
    axes = [None] * pad + [
        (dp if s == "D" else tp if s == "T" else None) for s in spec
    ]
    # divisibility guard per dim
    out = []
    for dim, a in zip(shape, axes):
        if a is None:
            out.append(None)
            continue
        size = int(np.prod([axis_sizes[x] for x in _as_tuple(a)]))
        out.append(a if dim % size == 0 else None)
    return tuple(out)


def _leaves_with_path(tree):
    """``(path string, leaf)`` of every leaf with a ``shape`` (tensors,
    arrays, meta tensors)."""
    out = []
    tree_lib.map_with_path(lambda path, x: out.append((_path_str(path), x)), tree)
    return [(p, x) for p, x in out if hasattr(x, "shape")]


def unmatched_large_leaves(abstract_tree: Pytree, *, min_size: int = 65536, rules=PARAM_RULES):
    """Leaf paths with >= min_size elements that match no rule — weights
    that would silently replicate: a rules-table gap."""
    return [(p, tuple(x.shape)) for p, x in _leaves_with_path(abstract_tree)
            if int(np.prod(x.shape)) >= min_size and match_rule(rules, p) is None]


def tree_shardings(abstract_tree: Pytree, mesh, rules=PARAM_RULES, *,
                   dp: Tuple[str, ...] = ("data",), tp: str = "model") -> Pytree:
    """The placement of every leaf of ``abstract_tree`` on ``mesh``."""
    return tree_lib.map_with_path(
        lambda path, x: resolve_spec(_path_str(path), tuple(x.shape), mesh.shape, rules,
                                     dp=dp, tp=tp),
        abstract_tree)


def param_shardings(abstract_params: Pytree, mesh, *, dp=("data",), tp="model"):
    return tree_shardings(abstract_params, mesh, PARAM_RULES, dp=dp, tp=tp)


def cache_shardings(abstract_cache: Pytree, mesh, *, dp=("data",), tp="model"):
    return tree_shardings(abstract_cache, mesh, CACHE_RULES, dp=dp, tp=tp)


def batch_shardings(abstract_batch: Pytree, mesh, *, dp=("data",), tp="model"):
    """Inputs: the leading batch dim over dp (when divisible)."""

    def leaf(path, x):
        if len(x.shape) == 0:
            return ()
        size = int(np.prod([mesh.shape[a] for a in dp]))
        first = dp if x.shape[0] % size == 0 else None
        return (first,) + (None,) * (len(x.shape) - 1)

    return tree_lib.map_with_path(leaf, abstract_batch)


def replicated(tree: Pytree, mesh) -> Pytree:
    del mesh  # every placement is () whatever the mesh
    return tree_lib.map_with_path(lambda path, x: (), tree)
