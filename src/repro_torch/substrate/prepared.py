"""Serve-time operand preparation for the codes fast path. Port of
``repro/substrate/prepared.py`` (single device; ``ShardedPrepared`` and
tensor-parallel serving wait).

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

The CUDA kernel masks ragged edges itself, so ``serve_alignment`` is
(1, 1) on every device and prepared operands are never padded.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

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
                         accum: str = "f32") -> torch.Tensor:
    """Hot-path fused linear over a 2-D prepared leaf: flatten x to
    (M, K) and launch; the only per-call tensor work besides the kernel
    is the cast of the f32 result back to x's dtype. The int8 body reads
    the same uint8 codes (the reference bakes s8 recodes into the tree
    for it; here the kernel recodes in registers)."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).contiguous()
    y = X.launch(
        xf, prep.g_pos, prep.g_neg, prep.scale, prep.lora_a, prep.lora_b,
        prep.gamma, accum=accum,
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
