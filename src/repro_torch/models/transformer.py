"""Model assembly, decoder path. Port of ``repro/models/transformer.py``
(attention mixers, MLA among them, with MLP or MoE FFNs, the forward, the
feature-KD calibration loss and the serving steps; SSM, RG-LRU,
encoder-decoder and vision prefix wait).

The parameter layout is the reference's: ``prologue`` (list) + ``body``
(a list of ``scan_period`` layer trees whose leaves are stacked on axis
0 over the scan groups) + ``epilogue`` (list). Where the reference runs
the body under ``lax.scan``, the port loops over the stacked axis.

Decode and chunk steps update the KV cache in place and return it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import CrossbarWeight, DEFAULT_RRAM, RramConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

_ATTN = ("attn", "local", "swa")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab: int
    attn: Optional[A.AttentionConfig] = None
    mlp: Optional[L.MlpConfig] = None
    moe: Optional[M.MoeConfig] = None
    mixer_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 1024
    ffn_pattern: Tuple[str, ...] = ("mlp",)
    prologue_layers: int = 0
    prologue_ffn: str = "mlp"
    norm: str = "rms"
    embed_scale: bool = False
    tie_lm_head: bool = True
    adapter: AdapterConfig = AdapterConfig()
    rram: RramConfig = DEFAULT_RRAM
    dtype: Any = torch.bfloat16
    unroll: bool = False

    @property
    def scan_period(self) -> int:
        return len(self.mixer_pattern)

    def layer_kinds(self) -> List[Tuple[str, str]]:
        kinds = []
        for i in range(self.n_layers):
            mixer = self.mixer_pattern[i % len(self.mixer_pattern)]
            if i < self.prologue_layers:
                ffn = self.prologue_ffn
            else:
                ffn = self.ffn_pattern[i % len(self.ffn_pattern)]
            kinds.append((mixer, ffn))
        return kinds

    def body_layout(self) -> Tuple[int, int, int]:
        """(prologue, n_groups, epilogue) layer counts."""
        body = self.n_layers - self.prologue_layers
        p = self.scan_period
        if self.unroll or len(self.ffn_pattern) not in (1, p) or body < 2 * p:
            return (self.n_layers, 0, 0)
        return (self.prologue_layers, body // p, body % p)


def _check_supported(cfg: ModelConfig) -> None:
    """Attention mixers (MLA ones global) with MLP, MoE or no FFN; the
    other kinds (SSM, RG-LRU, encoder, vision) are not ported."""
    for attr in ("ssm", "rglru", "encoder_layers", "vision_tokens"):
        if getattr(cfg, attr, None):
            raise NotImplementedError(f"{cfg.name}: {attr} is not ported")
    mla = cfg.attn is not None and cfg.attn.mla
    for mixer, ffn in cfg.layer_kinds():
        if mixer not in _ATTN or ffn not in ("mlp", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer kind ({mixer}, {ffn}) is not ported"
            )
        if mla and mixer != "attn":
            raise NotImplementedError(f"{cfg.name}: MLA with a sliding window ({mixer}) "
                                      "is not supported")


def _norm_init(cfg: ModelConfig, device):
    if cfg.norm == "rms":
        return L.init_rmsnorm(cfg.d_model, device)
    return L.init_layernorm(cfg.d_model, device)


def _norm(x, p, cfg: ModelConfig):
    return L.rms_norm(x, p) if cfg.norm == "rms" else L.layer_norm(x, p)


def _attn_cfg(cfg: ModelConfig, kind: str) -> A.AttentionConfig:
    window = cfg.local_window if kind in ("local", "swa") else None
    return dataclasses.replace(cfg.attn, window=window)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(generator: torch.Generator, cfg: ModelConfig, mixer: str,
               ffn: str) -> Tuple[Dict, Dict]:
    device = generator.device
    base: Dict = {"norm1": _norm_init(cfg, device)}
    adapters: Dict = {}
    base["mixer"], adapters["mixer"] = A.init_attention(
        generator, _attn_cfg(cfg, mixer), cfg.adapter, cfg.dtype)
    if ffn == "mlp":
        base["norm2"] = _norm_init(cfg, device)
        base["ffn"], adapters["ffn"] = L.init_mlp(
            generator, cfg.mlp, cfg.adapter, cfg.dtype)
    elif ffn == "moe":
        base["norm2"] = _norm_init(cfg, device)
        base["ffn"], adapters["ffn"] = M.init_moe(
            generator, cfg.moe, cfg.adapter, cfg.dtype)
    return base, adapters


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Dict:
    """{"base": ..., "adapters": ...} with mirrored structure, drawn from
    ``generator`` on its device."""
    _check_supported(cfg)
    device = generator.device
    kinds = cfg.layer_kinds()
    pro, n_groups, epi = cfg.body_layout()
    p = cfg.scan_period
    base: Dict = {
        "embed": L.init_embedding(generator, cfg.vocab, cfg.d_model, cfg.dtype),
        "final_norm": _norm_init(cfg, device),
    }
    adapters: Dict = {}
    if not cfg.tie_lm_head:
        base["lm_head"], adapters["lm_head"] = L.init_linear(
            generator, cfg.d_model, cfg.vocab, cfg.adapter, dtype=cfg.dtype)

    def make(i):
        return init_layer(generator, cfg, *kinds[i])

    base["prologue"], adapters["prologue"] = [], []
    for i in range(pro):
        b, a_ = make(i)
        base["prologue"].append(b)
        adapters["prologue"].append(a_)
    if n_groups:
        groups = [[make(pro + g * p + j) for j in range(p)] for g in range(n_groups)]
        base["body"] = tree_lib.stack([[lay[0] for lay in grp] for grp in groups])
        adapters["body"] = tree_lib.stack([[lay[1] for lay in grp] for grp in groups])
    base["epilogue"], adapters["epilogue"] = [], []
    for i in range(cfg.n_layers - epi, cfg.n_layers):
        b, a_ = make(i)
        base["epilogue"].append(b)
        adapters["epilogue"].append(a_)
    return {"base": base, "adapters": adapters}


def _empty_adapters(tree):
    if isinstance(tree, dict):
        return {k: _empty_adapters(v) for k, v in tree.items()
                if isinstance(v, (dict, list))}
    if isinstance(tree, list):
        return [_empty_adapters(v) for v in tree]
    return {}


def _layers(base: Dict, adapters: Dict, cfg: ModelConfig):
    """(index, base, adapters) per layer in order: the body's stacked
    leaves are viewed one scan group at a time."""
    kinds = cfg.layer_kinds()
    pro, n_groups, epi = cfg.body_layout()
    p = cfg.scan_period
    for i in range(pro):
        yield i, base["prologue"][i], adapters["prologue"][i], kinds[i]
    for g in range(n_groups):
        bs = tree_lib.index(base["body"], g)
        as_ = tree_lib.index(adapters.get("body") or [{}] * p, g)
        for j in range(p):
            i = pro + g * p + j
            yield i, bs[j], as_[j], kinds[i]
    for j, i in enumerate(range(cfg.n_layers - epi, cfg.n_layers)):
        yield i, base["epilogue"][j], adapters["epilogue"][j], kinds[i]


def _adapters_or_empty(params: Dict) -> Dict:
    return params.get("adapters") or _empty_adapters(params["base"])


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------


def _ffn(h, base, a_, cfg: ModelConfig, ffn: str):
    """The residual stream after the block's FFN (MLP or MoE), if any."""
    if ffn == "mlp":
        x = _norm(h, base["norm2"], cfg)
        return h + L.mlp(x, base["ffn"], a_.get("ffn"), cfg.mlp, cfg.adapter)
    if ffn == "moe":
        x = _norm(h, base["norm2"], cfg)
        return h + M.moe_block(x, base["ffn"], a_.get("ffn"), cfg.moe, cfg.adapter)
    return h


def block_forward(h, base, adapters, cfg: ModelConfig, mixer: str, ffn: str, *,
                  positions=None, mask=None):
    a_ = adapters or {}
    x = _norm(h, base["norm1"], cfg)
    h = h + A.attention(x, base["mixer"], a_.get("mixer"), _attn_cfg(cfg, mixer),
                        cfg.adapter, positions=positions, mask=mask)
    return _ffn(h, base, a_, cfg, ffn)


def forward(params: Dict, batch: Dict, cfg: ModelConfig, *,
            use_adapters: bool = True) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab); ``use_adapters=False``
    runs the base alone (the teacher, or the drifted array without its
    side-cars)."""
    base = params["base"]
    adapters = _adapters_or_empty(params) if use_adapters else _empty_adapters(base)
    h = L.embed(batch["tokens"], base["embed"], scale_by_sqrt_dim=cfg.embed_scale)
    positions = torch.arange(h.shape[1], device=h.device)[None]
    for _, b, a_, (mixer, ffn) in _layers(base, adapters, cfg):
        h = block_forward(h, b, a_, cfg, mixer, ffn, positions=positions)
    h = _norm(h, base["final_norm"], cfg)
    return _lm_head(h, base, adapters, cfg)


def _lm_head(h, base, adapters, cfg: ModelConfig):
    if cfg.tie_lm_head:
        return h @ base["embed"]["embedding"].to(h.dtype).T
    return L.linear(h, base["lm_head"], adapters.get("lm_head"), cfg.adapter)


# ---------------------------------------------------------------------------
# feature-based layer-wise calibration loss (paper Algorithm 1 + 2)
# ---------------------------------------------------------------------------
#
# The student block receives the *teacher's* block input, so gradients
# w.r.t. a block's DoRA parameters never cross a block boundary —
# "layer-wise, no backpropagation" (§III-B) as one loss. Summing the
# per-block MSEs gives exactly the per-layer gradients of Algorithm 1's
# inner loop. The teacher side runs under ``torch.no_grad()``.


def feature_calibration_loss(teacher_base: Dict, student_base: Dict, adapters: Dict,
                             batch: Dict, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Mean over blocks (and the untied lm_head's logits) of the
    teacher/student MSE; returns ``(loss, {"feature_mse": loss})``."""
    with torch.no_grad():
        h = L.embed(batch["tokens"], teacher_base["embed"],
                    scale_by_sqrt_dim=cfg.embed_scale)
    positions = torch.arange(h.shape[1], device=h.device)[None]
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    n_terms = 0
    teacher = _layers(teacher_base, _empty_adapters(teacher_base), cfg)
    for (_, tb, _, (mixer, ffn)), (_, sb, sa, _) in zip(
            teacher, _layers(student_base, adapters, cfg)):
        with torch.no_grad():
            t_out = block_forward(h, tb, {}, cfg, mixer, ffn, positions=positions)
        s_out = block_forward(h, sb, sa, cfg, mixer, ffn, positions=positions)
        loss = loss + _mse(t_out, s_out)
        n_terms += 1
        h = t_out
    if not cfg.tie_lm_head:  # untied heads live in RRAM: align the logits too
        with torch.no_grad():
            hn = _norm(h, teacher_base["final_norm"], cfg)
            t_logits = L.linear(hn, teacher_base["lm_head"], {}, cfg.adapter)
        s_logits = L.linear(hn, student_base["lm_head"], adapters.get("lm_head"),
                            cfg.adapter)
        loss = loss + _mse(t_logits, s_logits)
        n_terms += 1
    loss = loss / n_terms
    return loss, {"feature_mse": loss}


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.mean(d * d)


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    kinds = cfg.layer_kinds()
    pro, n_groups, epi = cfg.body_layout()
    p = cfg.scan_period

    def layer_cache(mixer):
        return A.init_kv_cache(batch, max_len, _attn_cfg(cfg, mixer), device, cfg.dtype)

    cache: Dict = {"prologue": [layer_cache(kinds[i][0]) for i in range(pro)]}
    if n_groups:
        cache["body"] = tree_lib.stack([
            [layer_cache(kinds[pro + g * p + j][0]) for j in range(p)]
            for g in range(n_groups)
        ])
    cache["epilogue"] = [layer_cache(kinds[i][0])
                         for i in range(cfg.n_layers - epi, cfg.n_layers)]
    return cache


def init_flat_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device) -> Tuple[torch.Tensor, Dict]:
    """``init_cache``'s tree as views of ONE zeroed buffer, returned with
    it: a whole cache is then zeroed, saved or restored by one op."""
    like = init_cache(cfg, batch, max_len, "meta")
    leaves = tree_lib.tensors(like)
    flat = torch.zeros(sum(t.numel() for t in leaves), dtype=cfg.dtype, device=device)
    views, off = [], 0
    for t in leaves:
        views.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return flat, tree_lib.unflatten(like, views)


def _cache_layers(cache: Dict, cfg: ModelConfig):
    """Per-layer views into ``cache``, in layer order (writes land in
    the stacked buffers)."""
    pro, n_groups, epi = cfg.body_layout()
    out = list(cache["prologue"])
    for g in range(n_groups):
        out.extend(tree_lib.index(cache["body"], g))
    out.extend(cache["epilogue"])
    return out


def write_cache_slot(cache: Dict, one: Dict, slot: int) -> Dict:
    """Copy a batch-1 cache into row ``slot`` of a batched cache (in
    place). Stacked body leaves carry batch on axis 1."""
    for key, v in cache.items():
        ones = tree_lib.tensors(one[key])
        for big, o in zip(tree_lib.tensors(v), ones):
            if key == "body":
                big[:, slot] = o[:, 0]
            else:
                big[slot] = o[0]
    return cache


# ---------------------------------------------------------------------------
# fused prefill
# ---------------------------------------------------------------------------


def prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> Tuple[torch.Tensor, Dict]:
    """One forward over the whole prompt: last-position logits
    (B, 1, vocab) and a decode cache ready at ``pos = S``."""
    base = params["base"]
    adapters = _adapters_or_empty(params)
    b, s = tokens.shape
    h = L.embed(tokens, base["embed"], scale_by_sqrt_dim=cfg.embed_scale)
    positions = torch.arange(s, device=h.device)[None]
    cache = init_cache(cfg, b, max_len, h.device)
    layer_caches = _cache_layers(cache, cfg)
    for i, lb, la, (mixer, ffn) in _layers(base, adapters, cfg):
        acfg = _attn_cfg(cfg, mixer)
        x = _norm(h, lb["norm1"], cfg)
        mix, kv = A.attention(x, lb["mixer"], la.get("mixer"), acfg, cfg.adapter,
                              positions=positions, return_kv=True)
        layer = A.prefill_kv_cache(kv, b, max_len, acfg, cfg.dtype)
        for name, buf in layer_caches[i].items():
            buf.copy_(layer[name])
        h = _ffn(h + mix, lb, la, cfg, ffn)
    h = _norm(h, base["final_norm"], cfg)
    logits = _lm_head(h[:, -1:], base, adapters, cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# decode tick
# ---------------------------------------------------------------------------


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One batched decode tick; row ``b`` sits at clock ``pos[b]``."""
    base = params["base"]
    adapters = _adapters_or_empty(params)
    pos = A._as_pos_vector(pos, tokens.shape[0], tokens.device)
    h = L.embed(tokens, base["embed"], scale_by_sqrt_dim=cfg.embed_scale)
    layer_caches = _cache_layers(cache, cfg)
    for i, lb, la, (mixer, ffn) in _layers(base, adapters, cfg):
        x = _norm(h, lb["norm1"], cfg)
        mix, _ = A.decode_attention(x, layer_caches[i], pos, lb["mixer"],
                                    la.get("mixer"), _attn_cfg(cfg, mixer), cfg.adapter)
        h = _ffn(h + mix, lb, la, cfg, ffn)
    h = _norm(h, base["final_norm"], cfg)
    return _lm_head(h, base, adapters, cfg), cache


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


def _chunk_block(h, cache_l, pos0, n_valid, b, a_, cfg: ModelConfig, mixer: str,
                 ffn: str, *, max_len: int):
    a_ = a_ or {}
    x = _norm(h, b["norm1"], cfg)
    mix, new_kv = A.chunk_attention(x, cache_l, pos0, n_valid, b["mixer"],
                                    a_.get("mixer"), _attn_cfg(cfg, mixer),
                                    cfg.adapter, max_len=max_len)
    return _ffn(h + mix, b, a_, cfg, ffn), new_kv


def _chunk_stack(params, h, cache, pos0, n_valid, cfg: ModelConfig, max_len: int):
    """Walk the layer stack with ``_chunk_block``; final norm applied."""
    base = params["base"]
    adapters = _adapters_or_empty(params)
    layer_caches = _cache_layers(cache, cfg)
    for i, lb, la, kind in _layers(base, adapters, cfg):
        h, _ = _chunk_block(h, layer_caches[i], pos0, n_valid, lb, la, cfg,
                            *kind, max_len=max_len)
    return _norm(h, base["final_norm"], cfg), cache


def prefill_chunk(params: Dict, tokens: torch.Tensor, cache: Dict, pos0, n_valid,
                  cfg: ModelConfig, max_len: int) -> Tuple[torch.Tensor, Dict]:
    """Advance a decode cache by one prompt chunk (zero-padded tail):
    logits at the chunk's last valid position (B, 1, vocab)."""
    base = params["base"]
    b, _ = tokens.shape
    pos0 = A._as_pos_vector(pos0, b, tokens.device)
    n_valid = A._as_pos_vector(n_valid, b, tokens.device)
    h = L.embed(tokens, base["embed"], scale_by_sqrt_dim=cfg.embed_scale)
    h, cache = _chunk_stack(params, h, cache, pos0, n_valid, cfg, max_len)
    rows = torch.arange(b, device=h.device)
    h_last = h[rows, n_valid - 1][:, None]
    return _lm_head(h_last, base, _adapters_or_empty(params), cfg), cache


# ---------------------------------------------------------------------------
# parameter accounting
# ---------------------------------------------------------------------------


def count_params(params: Dict) -> Tuple[int, int]:
    """(base_params, adapter_params); a ``CrossbarWeight`` counts its
    logical weight count once."""

    def size(tree):
        total = 0

        def leaf(_, x):
            nonlocal total
            if isinstance(x, CrossbarWeight):
                total += x.g_pos.numel()
            elif isinstance(x, torch.Tensor):
                total += x.numel()
            return x

        tree_lib.map_with_path(leaf, tree,
                               is_leaf=lambda v: isinstance(v, CrossbarWeight))
        return total

    return size(params["base"]), size(params["adapters"])


def active_param_fraction(cfg: ModelConfig, params: Dict) -> float:
    """Fraction of the base parameters active per token: 1.0 for dense
    stacks; for MoE the routed expert stacks count ``top_k / n_experts``."""
    if cfg.moe is None:
        return 1.0
    base, _ = count_params(params)
    routed = sum(_tree_key_size(params["base"], k) for k in M._STACKS)
    active = base - routed * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    return active / base


def _tree_key_size(tree, key) -> int:
    """Logical weights under every ``key`` of ``tree``."""
    total = 0
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == key:
                total += count_params({"base": v, "adapters": {}})[0]
            else:
                total += _tree_key_size(v, key)
    elif isinstance(tree, list):
        total += sum(_tree_key_size(v, key) for v in tree)
    return total
