"""Mixture-of-Experts FFN (mixtral-8x22b). Port of ``repro/models/moe.py``.

Dispatch: each batch row's tokens are grouped by expert through a stable
argsort into a fixed ``(n_experts, capacity)`` layout, the expert FFNs
run as one batched product ``(B, E, C, d) x (E, d, ff)``, and the results
scatter-add back weighted by the router's gates. Tokens past an expert's
capacity are dropped (Switch-style): they land in a spare slot ``E * C``
that is cut off, and they fall back to the residual. The sort is stable,
so within an expert the earlier tokens win, and a chunk's padded tail,
whose indices come last, never takes capacity from a real token.

The router is itself a RimcLinear: its weights drift in RRAM and carry a
DoRA side-car like every other projection. It runs on f32 x, so under
``codes`` and ``codes_adc`` it reaches the kernels' f32-x bodies.

Expert stacks stay bare stacked ``CrossbarWeight`` leaves (never
prepared): ``_expert_matmul`` reads a stack back to the activations'
dtype and runs one batched product, as the reference does outside any
Pallas kernel. So under every backend, ``codes_adc`` included, the
experts bypass the kernels.

Decode (one token a row) uses dense gating: every expert runs on the
token and the outputs are gate-weighted. The dispatch combine, and the
dispatch's backward, sum a token's ``top_k`` slots by gathers added in
slot order (``_gather_sum``), never by a scatter-add: with more than two
adds a row (deepseek-v2-lite's top-6) atomics in a varying order would
change the last bits from run to run, and a CUDA graph's replay would
not repeat its eager step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import dora
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import CrossbarWeight, dequantize
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0  # always-on shared experts (deepseek-v2)
    capacity_factor: float = 1.25
    activation: str = "silu"
    routed_scale: float = 1.0  # deepseek multiplies the routed output


def _shared_cfg(cfg: MoeConfig) -> L.MlpConfig:
    return L.MlpConfig(cfg.d_model, cfg.d_ff * cfg.n_shared, gated=True,
                       activation=cfg.activation)


_STACKS = ("gate_w", "up_w", "down_w")


def init_moe(generator: Optional[torch.Generator], cfg: MoeConfig, acfg: AdapterConfig,
             dtype=torch.bfloat16, *,
             draws: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[Dict, Dict]:
    """The router (an f32 RimcLinear), the three expert stacks ``(E, d_in,
    d_out)`` in ``dtype`` with a DoRA side-car per expert stacked on the
    expert axis, and the shared experts' gated MLP. ``draws`` gives the
    draws instead of ``generator``: standard normals under ``"router"``
    (d, E) and each stack's name, A's U(0, 1) draws under
    ``"router/lora_a"`` (d, r) and ``"<stack>/lora_a"`` (E, d_in, r).
    Shared experts draw from ``generator``."""
    device = generator.device if draws is None else next(iter(draws.values())).device
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normals(name, shape):
        if draws is not None:
            return draws[name].to(torch.float32)
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def uniforms(name):
        return None if draws is None else draws.get(f"{name}/lora_a")

    base: Dict = {}
    adapters: Dict = {}
    w = (normals("router", (d, e)) * d ** -0.5).to(torch.float32)
    base["router"] = {"w": w}
    adapters["router"] = dora.init_adapter(generator, d, e, acfg, w_base=w,
                                           uniforms=uniforms("router"))
    shapes = {"gate_w": (d, ff, d ** -0.5), "up_w": (d, ff, d ** -0.5),
              "down_w": (ff, d, ff ** -0.5)}
    for name in _STACKS:
        d_in, d_out, scale = shapes[name]
        base[name] = (normals(name, (e, d_in, d_out)) * scale).to(dtype)
    for name in _STACKS:
        d_in, d_out, _ = shapes[name]
        adapters[name] = _stacked_adapter(generator, e, d_in, d_out, acfg, base[name],
                                          uniforms=uniforms(name))
    if cfg.n_shared:
        base["shared"], adapters["shared"] = L.init_mlp(generator, _shared_cfg(cfg), acfg,
                                                        dtype=dtype)
    return base, adapters


def _stacked_adapter(generator, n_experts: int, d: int, k: int, acfg: AdapterConfig,
                     w_stack: torch.Tensor, *, uniforms: Optional[torch.Tensor] = None):
    """Per-expert side-cars stacked on the expert axis (``uniforms``: the
    (E, d, r) U(0, 1) draws of the A's)."""
    if acfg.kind == "none":
        return {}
    ads = [dora.init_adapter(generator, d, k, acfg, w_base=w_stack[i],
                             uniforms=None if uniforms is None else uniforms[i])
           for i in range(n_experts)]
    return tree_lib.stack(ads)


def _expert_matmul(x: torch.Tensor, w, adapter: Optional[Dict],
                   acfg: AdapterConfig) -> torch.Tensor:
    """x (B, E, C, d_in) through a stack (E, d_in, d_out), float or a
    stacked ``CrossbarWeight`` read back to x's dtype, plus the stacked
    side-cars."""
    if isinstance(w, CrossbarWeight):
        w = dequantize(w, dtype=x.dtype)
    y = torch.einsum("becd,edf->becf", x, w.to(x.dtype))
    if not adapter:
        return y
    a = adapter["lora_a"].to(x.dtype)  # (E, d_in, r)
    b = adapter["lora_b"].to(x.dtype)  # (E, r, d_out)
    y = y + torch.einsum("becr,erf->becf", torch.einsum("becd,edr->becr", x, a), b)
    if acfg.kind == "dora":
        if "dora_m_merged" in adapter:
            scale = adapter["dora_m_merged"].to(torch.float32)
        else:
            norm = _column_norm_for_grad(w, adapter["lora_a"], adapter["lora_b"])
            scale = adapter["dora_m"].to(torch.float32) / norm
        y = y * scale[None, :, None, :].to(x.dtype)
    return y


def _stacked_column_norm(w, a, b, eps=1e-6):
    """``column_norm`` over a stack: w (E, d, k), a (E, d, r), b (E, r, k)
    -> (E, k)."""
    if isinstance(w, CrossbarWeight):
        w = dequantize(w)
    wf = w.to(torch.float32)
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    w_sq = torch.sum(wf * wf, dim=1)  # (E, d_out)
    wta = torch.einsum("edk,edr->ekr", wf, af)  # (E, d_out, r)
    cross = torch.einsum("ekr,erk->ek", wta, bf)
    ab = torch.einsum("edr,erk->edk", af, bf)
    ab_sq = torch.sum(ab * ab, dim=1)
    return torch.sqrt(torch.clamp_min(w_sq + 2.0 * cross + ab_sq, eps))


def _column_norm_for_grad(w, a, b):
    """``_stacked_column_norm`` that keeps no f32 copy of the stack for the
    backward: under autograd it is recomputed there from the stack the
    expert product keeps anyway (the same ops, the same values). At
    mixtral's width a stack's f32 read-back is 3 GiB, and a calibration
    step would otherwise keep six of them alive."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        from torch.utils.checkpoint import checkpoint

        return checkpoint(_stacked_column_norm, w, a, b, use_reentrant=False,
                          preserve_rng_state=False)
    return _stacked_column_norm(w, a, b)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s arithmetic: exp of the max-shifted logits over
    their sum, by division (``torch.softmax`` on the CPU multiplies by the
    reciprocal)."""
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort keeps equal entries in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(logits: torch.Tensor, cfg: MoeConfig):
    """(probs, top-k gates renormalized to sum 1, their expert indices)."""
    probs = _softmax(logits)
    gates, expert_idx = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp_min(torch.sum(gates, dim=-1, keepdim=True), 1e-9)
    return probs, gates, expert_idx


def _route_row(xrow: torch.Tensor, router_logits: torch.Tensor, cfg: MoeConfig,
               capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group one batch row's tokens (S, d) with logits (S, E) into
    ``E * capacity`` slots: the token each slot holds (S, an index past the
    row, where empty) and its gate (0 where empty). Leading batch dims of
    both are kept (the reference vmaps this over rows)."""
    s = router_logits.shape[-2]
    lead = router_logits.shape[:-2]
    k, e = cfg.top_k, cfg.n_experts
    dev = router_logits.device
    _, gates, expert_idx = _gates(router_logits, cfg)
    flat_expert = expert_idx.reshape(*lead, s * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, -1, order)
    first = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    pos_in_group = torch.arange(s * k, device=dev) - first
    slot = torch.where(pos_in_group < capacity, sorted_expert * capacity + pos_in_group,
                       e * capacity)
    # every dropped entry lands in the spare slot E*C, which is cut off
    slot_token = torch.full((*lead, e * capacity + 1), s, dtype=torch.int32, device=dev)
    slot_token.scatter_(-1, slot, (order // k).to(torch.int32))
    slot_gate = torch.zeros((*lead, e * capacity + 1), dtype=torch.float32, device=dev)
    slot_gate.scatter_(-1, slot, torch.gather(gates.reshape(*lead, s * k), -1, order))
    return slot_token[..., :-1], slot_gate[..., :-1]


def _token_slots(slot_token: torch.Tensor, s: int, k: int) -> torch.Tensor:
    """The inverse of ``_route_row``'s layout: for each of a row's ``s``
    tokens the slots that hold it, ascending, padded with the empty index
    ``E * C`` (..., s, k); a token holds at most ``k`` slots, fewer where
    it was dropped."""
    n = slot_token.shape[-1]
    lead = slot_token.shape[:-1]
    order = torch.argsort(slot_token, dim=-1, stable=True)  # by token, slots ascending
    tokens = torch.gather(slot_token, -1, order)
    want = torch.arange(s, dtype=slot_token.dtype, device=slot_token.device)
    want = want.expand(*lead, s).contiguous()
    start = torch.searchsorted(tokens, want)
    pos = start[..., None] + torch.arange(k, device=slot_token.device)  # (..., s, k)
    at = pos.clamp(max=n - 1).reshape(*lead, s * k)
    held = (pos < n) & (torch.gather(tokens, -1, at).reshape(*lead, s, k) == want[..., None])
    return torch.where(held, torch.gather(order, -1, at).reshape(*lead, s, k), n)


def _gather_sum(v: torch.Tensor, token_slots: torch.Tensor) -> torch.Tensor:
    """(B, S, d): each token's sum of ``v``'s slot rows (B, n, d) at
    ``token_slots`` (B, S, k), added onto zero in slot order (the
    reference's sequential scatter-add). Gathers and adds in a fixed order
    give the same bits on every run, where a scatter-add onto the token's
    row would add its ``top_k`` values with atomics in a varying order."""
    bsz, s, k = token_slots.shape
    d = v.shape[-1]
    v_pad = torch.cat([v, v.new_zeros((bsz, 1, d))], dim=1)  # the empty index reads zeros
    y = v.new_zeros((bsz, s, d))
    for j in range(k):
        y = y + torch.gather(v_pad, 1, token_slots[:, :, j, None].expand(bsz, s, d))
    return y


class _Dispatch(torch.autograd.Function):
    """The slots' tokens: ``x_pad`` (B, S + 1, d; row S zeros) gathered by
    ``slot_token`` (B, n). Its backward sums each token's slot gradients by
    ``_gather_sum``, so calibration's gradients repeat bitwise, where
    autograd's gather backward scatter-adds up to ``top_k`` of them onto a
    token with atomics."""

    @staticmethod
    def forward(ctx, x_pad, slot_token, token_slots):
        ctx.save_for_backward(token_slots)
        idx = slot_token.to(torch.int64)[..., None].expand(*slot_token.shape, x_pad.shape[-1])
        return torch.gather(x_pad, 1, idx)

    @staticmethod
    def backward(ctx, grad):
        (token_slots,) = ctx.saved_tensors
        g = _gather_sum(grad, token_slots)
        return torch.cat([g, g.new_zeros((g.shape[0], 1, g.shape[2]))], dim=1), None, None


def capacity_of(s: int, cfg: MoeConfig) -> int:
    """Slots per expert for ``s`` tokens a row: ``ceil(s * top_k *
    capacity_factor / E)``, at least 1 (the reference's float arithmetic).
    A Python int of the static sequence width: nothing is read on the
    host."""
    return int(max(1, -(-s * cfg.top_k * cfg.capacity_factor // cfg.n_experts)))


def can_drop(cfg: MoeConfig) -> bool:
    """Whether a row's tokens can overflow an expert: with ``top_k *
    capacity_factor >= n_experts`` every expert has a slot for each token
    of the row, so which tokens share a row changes nothing."""
    return cfg.top_k * cfg.capacity_factor < cfg.n_experts


def moe_block(x: torch.Tensor, base: Dict, adapters: Optional[Dict], cfg: MoeConfig,
              acfg: AdapterConfig) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): dispatch for S > 1, dense gating for S = 1."""
    a_ = adapters or {}
    bsz, s, d = x.shape
    if s == 1:
        return _moe_decode_dense(x, base, a_, cfg, acfg)
    capacity = capacity_of(s, cfg)
    logits = L.linear(x.to(torch.float32), base["router"], a_.get("router"), acfg)
    slot_token, slot_gate = _route_row(x, logits, cfg, capacity)  # (B, E*C) each
    token_slots = _token_slots(slot_token, s, cfg.top_k)           # (B, S, k)
    x_pad = torch.cat([x, x.new_zeros((bsz, 1, d))], dim=1)
    xg = _Dispatch.apply(x_pad, slot_token, token_slots)
    xg = xg.reshape(bsz, cfg.n_experts, capacity, d)
    gate_h = _expert_matmul(xg, base["gate_w"], a_.get("gate_w"), acfg)
    up_h = _expert_matmul(xg, base["up_w"], a_.get("up_w"), acfg)
    h = L._act(gate_h, cfg.activation) * up_h
    out_g = _expert_matmul(h, base["down_w"], a_.get("down_w"), acfg)
    out_flat = out_g.reshape(bsz, cfg.n_experts * capacity, d).to(torch.float32)
    out_flat = out_flat * slot_gate[..., None]
    y = _gather_sum(out_flat, token_slots) * cfg.routed_scale
    if cfg.n_shared:
        y = y + L.mlp(x, base["shared"], a_.get("shared"), _shared_cfg(cfg),
                      acfg).to(torch.float32)
    return y.to(x.dtype)


def _moe_decode_dense(x, base, a_, cfg: MoeConfig, acfg):
    bsz, _, d = x.shape  # one token a row
    logits = L.linear(x.to(torch.float32), base["router"], a_.get("router"), acfg)[:, 0]
    probs, gates, expert_idx = _gates(logits, cfg)
    # dense (B, E) combine weights, 0 off the top-k
    combine = torch.zeros_like(probs).scatter_(-1, expert_idx, gates)
    xg = x[:, None].expand(bsz, cfg.n_experts, 1, d)
    gate_h = _expert_matmul(xg, base["gate_w"], a_.get("gate_w"), acfg)
    up_h = _expert_matmul(xg, base["up_w"], a_.get("up_w"), acfg)
    h = L._act(gate_h, cfg.activation) * up_h
    out_g = _expert_matmul(h, base["down_w"], a_.get("down_w"), acfg)
    # (B, E, 1, d) x (B, E) -> (B, 1, d)
    y = torch.sum(out_g.to(torch.float32) * combine[:, :, None, None], dim=1)
    y = y * cfg.routed_scale
    if cfg.n_shared:
        y = y + L.mlp(x, base["shared"], a_.get("shared"), _shared_cfg(cfg),
                      acfg).to(torch.float32)
    return y.to(x.dtype)


def load_balancing_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss (for pre-deployment training; the
    calibration step trains the router's side-car only)."""
    probs = _softmax(logits)
    density = torch.mean(probs, dim=0)
    one_hot = torch.nn.functional.one_hot(expert_idx[..., 0].to(torch.int64),
                                          n_experts).to(probs.dtype)
    usage = torch.mean(one_hot, dim=0)
    return n_experts * torch.sum(density * usage)
