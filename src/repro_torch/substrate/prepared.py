"""Serve-time operand preparation for the codes fast path. Port of
``repro/substrate/prepared.py``.

* ``PreparedCrossbar`` — the codes plus the baked adapter operands (A,
  B, per-column scale, merged gamma) of one leaf or of several fused
  same-input leaves.
* ``prepare_crossbar`` / ``fuse_crossbars`` — build one from a single
  leaf, or concatenate same-input leaves over N (codes, scale, gamma),
  A over r, and block-diagonalize B: exact math, one launch instead of
  two or three.
* ``prepare_base_for_serve`` — swap every servable leaf of a model tree
  for its prepared form, fusing q/k/v and gate/up; ``xattn`` subtrees
  never fuse.
* ``rimc_linear_prepared`` — the hot-path dispatch.
* ``ShardedPrepared`` / ``shard_prepared_for_serve`` /
  ``place_serve_params`` — tensor-parallel serving: a rank holds the
  column block of each column-shardable leaf for its place on the mesh's
  ``"model"`` axis, runs the kernel on it and all-gathers the columns
  (``tp_column_allgather``).

The CUDA kernel masks ragged edges itself, so ``serve_alignment`` is
(1, 1) on every device and prepared operands are never padded.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.rram import CrossbarWeight
from repro_torch.substrate import exec as X


@dataclasses.dataclass
class PreparedCrossbar:
    """Adapter-baked serving form of one (possibly fused) RimcLinear.
    Arrays may carry leading stack dims (scan groups)."""

    g_pos: torch.Tensor    # (..., K, N) u8
    g_neg: torch.Tensor    # (..., K, N) u8
    scale: torch.Tensor    # (..., 1, N) f32 per-column code scale
    lora_a: torch.Tensor   # (..., K, R) f32 (R = sum of fused ranks)
    lora_b: torch.Tensor   # (..., R, N) f32 (block-diagonal when fused)
    gamma: torch.Tensor    # (..., 1, N) f32 merged DoRA magnitude
    k: int                 # K
    n: int                 # N (all fused segments)
    splits: Tuple[int, ...] = ()  # per-segment N widths when fused


def serve_alignment() -> Tuple[int, int]:
    """(K, N) padding granules of prepared operands: none, because the
    kernel masks its ragged tiles."""
    return (1, 1)


def _operand_arrays(xw: CrossbarWeight, adapter: Optional[dict], acfg):
    """(gp, gn, scale, a, b, gamma) for one leaf, adapters baked."""
    batch = tuple(xw.g_pos.shape[:-2])
    k, n = xw.g_pos.shape[-2:]
    dev = xw.g_pos.device
    adapter = adapter or {}
    if "lora_a" in adapter:
        a = adapter["lora_a"].to(torch.float32)
        b = adapter["lora_b"].to(torch.float32)
    else:
        a = torch.zeros(batch + (k, 1), dtype=torch.float32, device=dev)
        b = torch.zeros(batch + (1, n), dtype=torch.float32, device=dev)
    if "dora_m" in adapter:
        raise ValueError(
            "prepare expects merged adapters (merge_adapters_for_serve): "
            "got an unmerged dora_m"
        )
    if acfg.kind == "dora" and "dora_m_merged" in adapter:
        gamma = adapter["dora_m_merged"].to(torch.float32)[..., None, :]
    else:
        gamma = torch.ones(batch + (1, n), dtype=torch.float32, device=dev)
    return xw.g_pos, xw.g_neg, xw.scale.to(torch.float32), a, b, gamma


def _finish(gp, gn, scale, a, b, gamma, k, n, splits):
    """Contiguous operands, as the kernel takes them."""
    gp, gn, scale, a, b, gamma = (t.contiguous() for t in (gp, gn, scale, a, b, gamma))
    return PreparedCrossbar(gp, gn, scale, a, b, gamma, k=int(k), n=int(n),
                            splits=tuple(int(s) for s in splits))


def prepare_crossbar(
    xw: CrossbarWeight, adapter: Optional[dict], acfg,
) -> PreparedCrossbar:
    """One leaf -> its prepared serving form (no fusion)."""
    gp, gn, scale, a, b, gamma = _operand_arrays(xw, adapter, acfg)
    k, n = xw.g_pos.shape[-2:]
    return _finish(gp, gn, scale, a, b, gamma, k, n, (n,))


def fuse_crossbars(
    leaves: Sequence[Tuple[CrossbarWeight, Optional[dict]]], acfg,
) -> PreparedCrossbar:
    """Fuse same-input leaves into one launch over concatenated N:
    ``x @ A_cat @ B_blockdiag == concat_i(x @ A_i @ B_i)`` exactly."""
    parts = [_operand_arrays(xw, ad, acfg) for xw, ad in leaves]
    k = leaves[0][0].g_pos.shape[-2]
    widths = tuple(xw.g_pos.shape[-1] for xw, _ in leaves)
    ranks = [p[3].shape[-1] for p in parts]
    r_total = sum(ranks)
    gp = torch.cat([p[0] for p in parts], dim=-1)
    gn = torch.cat([p[1] for p in parts], dim=-1)
    scale = torch.cat([p[2] for p in parts], dim=-1)
    gamma = torch.cat([p[5] for p in parts], dim=-1)
    a = torch.cat([p[3] for p in parts], dim=-1)
    b_blocks = []
    off = 0
    for p, r in zip(parts, ranks):
        bi = p[4]
        blk = bi.new_zeros(bi.shape[:-2] + (r_total, bi.shape[-1]))
        blk[..., off:off + r, :] = bi
        b_blocks.append(blk)
        off += r
    b = torch.cat(b_blocks, dim=-1)
    return _finish(gp, gn, scale, a, b, gamma, k, sum(widths), widths)


def prepared_ref_forward(x: torch.Tensor, prep: PreparedCrossbar) -> torch.Tensor:
    """Plain PyTorch forward over a prepared leaf: the ``dequant``
    backend's view of a prepared tree."""
    w = (prep.g_pos.to(torch.float32) - prep.g_neg.to(torch.float32)) * prep.scale
    xf = x.to(torch.float32)
    y = xf @ w + (xf @ prep.lora_a) @ prep.lora_b
    return (y * prep.gamma).to(x.dtype)


def rimc_linear_prepared(x: torch.Tensor, prep: PreparedCrossbar, *,
                         accum: str = "f32", plan_n: Optional[int] = None) -> torch.Tensor:
    """Hot-path fused linear over a 2-D prepared leaf: flatten x to
    (M, K) and launch; the only per-call tensor work besides the kernel
    is the cast of the f32 result back to x's dtype. The int8 body reads
    the same uint8 codes (the reference bakes s8 recodes into the tree
    for it; here the kernel recodes in registers). ``plan_n`` is the
    width the launch is planned for: the whole leaf's for a column block
    (``ShardedPrepared.n_total``), so that the block's columns sum in the
    order the whole leaf's do."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).contiguous()
    y = X.launch(
        xf, prep.g_pos, prep.g_neg, prep.scale, prep.lora_a, prep.lora_b,
        prep.gamma, accum=accum, plan_n=plan_n,
    )
    return y.reshape(*lead, prep.n).to(x.dtype)


# same-input sibling groups the walker fuses, in precedence order; a key
# consumed by one group is not considered again. The MLA pairs are kept
# so the fusion rule matches the reference's tree for tree.
_FUSE_GROUPS = (
    ("_qkv", ("q", "k", "v")),          # self-attention (skipped under xattn)
    ("_q_kvd", ("q", "kv_down")),       # MLA: q + joint KV compression
    ("_kup_vup", ("k_up", "v_up")),     # MLA: latent -> K(nope) + V
    ("_gate_up", ("gate", "up")),       # gated MLP
)


def _servable(node) -> bool:
    """A ``{"w": CrossbarWeight}`` leaf with 2-D or scan-stacked 3-D codes."""
    return (
        isinstance(node, dict)
        and isinstance(node.get("w"), CrossbarWeight)
        and node["w"].g_pos.dim() in (2, 3)
    )


def _fusable(b: dict, keys: Tuple[str, ...]) -> bool:
    if not all(_servable(b.get(key)) for key in keys):
        return False
    lead_k = {tuple(b[key]["w"].g_pos.shape[:-1]) for key in keys}
    return len(lead_k) == 1


def prepare_base_for_serve(base, adapters, cfg, *, faults=None):
    """Swap every servable RRAM leaf of ``base`` for its
    ``PreparedCrossbar``, fusing same-input siblings. ``adapters`` must be
    the merged tree (``merge_adapters_for_serve``). Inputs are not
    mutated. ``faults`` (a composed ``FaultMap``) derives the faulty view
    of ``base`` before fusion, for a caller that prepares pristine codes;
    ``Deployment.serve`` passes its view, already faulted."""
    acfg = cfg.adapter
    base = X.faulted_codes(base, faults, cfg.rram)

    def walk(b, a, cross=False):
        if _servable(b):
            out = dict(b)
            out["w"] = prepare_crossbar(
                b["w"], a if isinstance(a, dict) else None, acfg
            )
            return out
        if isinstance(b, dict):
            a_d = a if isinstance(a, dict) else {}
            out = {}
            consumed: set = set()
            for fused_key, keys in _FUSE_GROUPS:
                if consumed.intersection(keys):
                    continue
                if fused_key == "_qkv" and (cross or "kv_down" in b):
                    continue
                if _fusable(b, keys):
                    out[fused_key] = {"w": fuse_crossbars(
                        [(b[key]["w"], a_d.get(key)) for key in keys], acfg,
                    )}
                    consumed.update(keys)
            for key, val in b.items():
                if key in consumed:
                    continue
                out[key] = walk(val, a_d.get(key), cross or key == "xattn")
            return out
        if isinstance(b, list):
            a_l = a if isinstance(a, (list, tuple)) else [None] * len(b)
            return [walk(v, a_l[i], cross) for i, v in enumerate(b)]
        return b

    return walk(base, adapters)


# ---------------------------------------------------------------------------
# tensor-parallel serving: column-sharded prepared leaves
# ---------------------------------------------------------------------------

_PREP_FIELDS = ("g_pos", "g_neg", "scale", "lora_a", "lora_b", "gamma")


@dataclasses.dataclass
class ShardedPrepared:
    """Column-parallel wrapper around one ``PreparedCrossbar``.

    ``local.n`` is the width of one rank's block, ``n_total`` the whole
    leaf's. Out of ``shard_prepared_for_serve`` the operands are still the
    whole leaf's; ``place_serve_params`` keeps this rank's contiguous
    column block of ``g_pos``, ``g_neg``, ``scale``, ``lora_b`` and
    ``gamma`` (``lora_a``, the K-side factor, is replicated) and binds
    ``group``, the rank's process subgroup along ``axis``. The codes
    backend runs the prepared kernel on the block, planned for
    ``n_total``, and ``tp_column_allgather`` rebuilds the whole output:
    every column comes from one rank's full K reduction, so the result is
    the unsharded launch's bit for bit."""

    local: PreparedCrossbar
    n_total: int
    axis: str = "model"
    group: object = None


def tp_column_allgather(y: torch.Tensor, n_total: int, group) -> torch.Tensor:
    """Gather every rank's column block of ``y`` over ``group`` and
    concatenate them on the last dimension, in rank order along the axis.
    The values are the reference's zero-scatter ``psum``'s: each column is
    one rank's, unchanged. On gloo a CUDA block is staged through host
    memory by the backend itself."""
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y.contiguous(), group=group)
    out = torch.cat(parts, dim=-1)
    if out.shape[-1] != n_total:
        raise ValueError(f"gathered {out.shape[-1]} columns of a {n_total}-column leaf")
    return out


def _prep_like(prep: PreparedCrossbar, fn) -> PreparedCrossbar:
    """``prep`` with each operand ``fn(name, operand)``."""
    return dataclasses.replace(prep, **{nm: fn(nm, getattr(prep, nm)) for nm in _PREP_FIELDS})


def shard_prepared_for_serve(params, mesh, *, tp: str = "model"):
    """Wrap every column-shardable ``PreparedCrossbar`` leaf of a serve
    params tree in ``ShardedPrepared``; return ``(params, stats)``.

    A leaf is shardable when its path matches a tensor-parallel rule of
    ``sharding.rules.PARAM_RULES`` ("T" anywhere in the spec: the columns
    of a linear are independent whatever the rule's orientation), it
    carries no N padding, and its N divides ``mesh.shape[tp]`` — the
    reference's policy, which reads nothing of the mesh but that size. MoE
    expert stacks are never prepared leaves and always replicate."""
    from repro_torch import tree as tree_lib
    from repro_torch.sharding import rules as R

    size = int(mesh.shape[tp])
    stats = {"sharded": 0, "replicated": 0}

    def leaf(path, v):
        if not isinstance(v, PreparedCrossbar):
            return v
        ok = (size > 1 and R.serve_tp_shardable(R._path_str(path))
              and v.g_pos.shape[-1] == v.n and v.n % size == 0)
        if not ok:
            stats["replicated"] += 1
            return v
        stats["sharded"] += 1
        n_local = v.n // size
        return ShardedPrepared(dataclasses.replace(v, n=n_local, splits=(n_local,)), v.n, tp)

    out = tree_lib.map_with_path(leaf, params,
                                 is_leaf=lambda v: isinstance(v, PreparedCrossbar))
    return out, stats


def serve_param_specs(params):
    """The placement of every leaf of a serve tree (``sharding.rules``'
    tuples): a ``ShardedPrepared``'s operands split their last dim over its
    axis, but ``lora_a``; everything else is replicated (``()``)."""
    from repro_torch import tree as tree_lib

    def leaf(path, v):
        if isinstance(v, ShardedPrepared):
            def spec(nm, t):
                return () if nm == "lora_a" else (None,) * (t.dim() - 1) + (v.axis,)

            return ShardedPrepared(_prep_like(v.local, spec), v.n_total, v.axis)
        if isinstance(v, PreparedCrossbar):
            return _prep_like(v, lambda nm, t: ())
        return ()

    return tree_lib.map_with_path(
        leaf, params, is_leaf=lambda v: isinstance(v, (ShardedPrepared, PreparedCrossbar)))


def place_serve_params(params, mesh):
    """This rank's serve tree on ``mesh`` (``serve_param_specs``): each
    ``ShardedPrepared`` keeps its rank's contiguous column blocks, made
    once here (the kernel takes contiguous operands only) and bound to the
    rank's subgroup along its axis; every replicated tensor is the tree's
    own, not copied."""
    from repro_torch import tree as tree_lib

    specs = serve_param_specs(params)

    def block(t, spec):
        for dim, axis in enumerate(spec):
            if axis is not None:
                width = t.shape[dim] // mesh.shape[axis]
                t = t.narrow(dim, mesh.index(axis) * width, width)
        return t.to(mesh.device).contiguous()

    def leaf(path, v):
        if not isinstance(v, ShardedPrepared):
            return v
        spec = specs
        for key in path:
            spec = spec[int(key)] if isinstance(spec, list) else spec[key]
        local = _prep_like(v.local, lambda nm, t: block(t, getattr(spec.local, nm)))
        return ShardedPrepared(local, v.n_total, v.axis, mesh.group(v.axis))

    return tree_lib.map_with_path(leaf, params, is_leaf=lambda v: isinstance(v, ShardedPrepared))
