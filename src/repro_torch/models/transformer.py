"""Model assembly. Port of ``repro/models/transformer.py``: attention
mixers, MLA among them, with MLP or MoE FFNs, and the encoder-decoder
family (a bidirectional encoder over precomputed frame embeddings, then
decoder layers with cross-attention over its normed output), and the
prefix-LM vision prefix (paligemma: precomputed patch embeddings ahead of
the text, attending to each other bidirectionally); the forward, the
feature-KD calibration loss and the serving steps (the encoder admission
writes each decoder layer's cross-attention K/V into the cache once; the
vision admission writes the patches' K/V at positions [0, P)), and the
attention-free Mamba-1 stack (falcon-mamba: ``ssm`` mixers, no FFN),
and the RG-LRU hybrid (recurrentgemma: ``rglru`` mixers beside ``local``
attention with a rolling cache). A recurrent layer's decode cache is its
state ``h`` and conv window ``conv``, both f32.

The parameter layout is the reference's: ``prologue`` (list) + ``body``
(a list of ``scan_period`` layer trees whose leaves are stacked on axis
0 over the scan groups) + ``epilogue`` (list). Where the reference runs
the body under ``lax.scan``, the port loops over the stacked axis.

Decode and chunk steps update the KV cache (and the recurrent state) in
place and return it. Only attention stacks chunk: a stack with a
recurrent mixer is admitted by one exact-length fused prefill, as the
reference admits it.
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
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

_ATTN = ("attn", "local", "swa")
_RECURRENT = ("ssm", "rglru")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab: int
    attn: Optional[A.AttentionConfig] = None
    mlp: Optional[L.MlpConfig] = None
    moe: Optional[M.MoeConfig] = None
    ssm: Optional[S.SsmConfig] = None
    rglru: Optional[R.RglruConfig] = None
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
    # encoder-decoder (seamless-m4t): the encoder's input arrives as
    # precomputed frame embeddings (the audio frontend is a stub)
    encoder_layers: int = 0
    # prefix-LM (paligemma): the first ``vision_tokens`` positions are
    # precomputed patch embeddings attending bidirectionally
    vision_tokens: int = 0
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
    """Attention mixers (MLA ones global), SSM and RG-LRU mixers with MLP,
    MoE or no FFN, an encoder and a vision prefix; a recurrent mixer needs
    its config."""
    mla = cfg.attn is not None and cfg.attn.mla
    for mixer, ffn in cfg.layer_kinds():
        if mixer in _RECURRENT and getattr(cfg, mixer) is None:
            raise ValueError(f"{cfg.name}: an {mixer} mixer needs cfg.{mixer}")
        if mixer not in _ATTN + _RECURRENT or ffn not in ("mlp", "moe", "none"):
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


def _attn_cfg(cfg: ModelConfig, kind: str, cross: bool = False) -> A.AttentionConfig:
    window = cfg.local_window if kind in ("local", "swa") else None
    return dataclasses.replace(cfg.attn, window=window, is_cross=cross)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(generator: torch.Generator, cfg: ModelConfig, mixer: str,
               ffn: str, *, cross: bool = False) -> Tuple[Dict, Dict]:
    """One layer; ``cross`` adds a decoder layer's cross-attention
    (``"norm_x"``, ``"xattn"``) after its mixer."""
    device = generator.device
    base: Dict = {"norm1": _norm_init(cfg, device)}
    adapters: Dict = {}
    if mixer == "ssm":
        base["mixer"], adapters["mixer"] = S.init_ssm(generator, cfg.ssm, cfg.adapter,
                                                      cfg.dtype)
    elif mixer == "rglru":
        base["mixer"], adapters["mixer"] = R.init_rglru(generator, cfg.rglru, cfg.adapter,
                                                        cfg.dtype)
    else:
        base["mixer"], adapters["mixer"] = A.init_attention(
            generator, _attn_cfg(cfg, mixer), cfg.adapter, cfg.dtype)
    if cross:
        base["norm_x"] = _norm_init(cfg, device)
        base["xattn"], adapters["xattn"] = A.init_attention(
            generator, _attn_cfg(cfg, "attn", cross=True), cfg.adapter, cfg.dtype)
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
        return init_layer(generator, cfg, *kinds[i], cross=cfg.encoder_layers > 0)

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
    if cfg.encoder_layers:
        enc = [init_layer(generator, cfg, "attn", "mlp") for _ in range(cfg.encoder_layers)]
        enc_b, enc_a = [lay[0] for lay in enc], [lay[1] for lay in enc]
        # stacked on axis 0 as the reference's scan over the encoder stacks it
        base["encoder"] = enc_b if cfg.unroll else tree_lib.stack(enc_b)
        adapters["encoder"] = enc_a if cfg.unroll else tree_lib.stack(enc_a)
        base["enc_norm"] = _norm_init(cfg, device)
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


def _enc_layers(base: Dict, adapters: Dict, cfg: ModelConfig):
    """(base, adapters) per encoder layer in order: the stacked leaves
    (all but ``unroll``) viewed one layer at a time."""
    enc_a = adapters.get("encoder") or _empty_adapters(base["encoder"])
    for e in range(cfg.encoder_layers):
        if cfg.unroll:
            yield base["encoder"][e], enc_a[e]
        else:
            yield tree_lib.index(base["encoder"], e), tree_lib.index(enc_a, e)


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


def _cross(h, base, a_, cfg: ModelConfig, enc_out):
    """The residual stream after a decoder layer's cross-attention over
    ``enc_out``, if the layer has one."""
    if "xattn" not in base or enc_out is None:
        return h
    x = _norm(h, base["norm_x"], cfg)
    return h + A.attention(x, base["xattn"], a_.get("xattn"), _attn_cfg(cfg, "attn", cross=True),
                           cfg.adapter, kv_input=enc_out)


def block_forward(h, base, adapters, cfg: ModelConfig, mixer: str, ffn: str, *,
                  positions=None, mask=None, enc_out=None):
    a_ = adapters or {}
    x = _norm(h, base["norm1"], cfg)
    if mixer == "ssm":
        h = h + S.ssm_block(x, base["mixer"], a_.get("mixer"), cfg.ssm, cfg.adapter)
    elif mixer == "rglru":
        h = h + R.rglru_block(x, base["mixer"], a_.get("mixer"), cfg.rglru, cfg.adapter)
    else:
        h = h + A.attention(x, base["mixer"], a_.get("mixer"), _attn_cfg(cfg, mixer),
                            cfg.adapter, positions=positions, mask=mask)
    h = _cross(h, base, a_, cfg, enc_out)
    return _ffn(h, base, a_, cfg, ffn)


def _enc_inputs(enc_embeds):
    """The encoder's all-true mask and positions over ``enc_embeds``."""
    s = enc_embeds.shape[1]
    return (torch.ones((s, s), dtype=torch.bool, device=enc_embeds.device),
            torch.arange(s, device=enc_embeds.device)[None])


def encode(base: Dict, adapters: Dict, enc_embeds: torch.Tensor, cfg: ModelConfig):
    """The bidirectional encoder over precomputed frame embeddings
    (B, S_src, d), its final norm applied."""
    mask, positions = _enc_inputs(enc_embeds)
    h = enc_embeds
    for b, a_ in _enc_layers(base, adapters, cfg):
        h = block_forward(h, b, a_, cfg, "attn", "mlp", mask=mask, positions=positions)
    return _norm(h, base["enc_norm"], cfg)


def _prefix_mask(s: int, prefix: int, device=None) -> torch.Tensor:
    """Prefix-LM mask (s, s): bidirectional over [0, prefix), causal after."""
    q = torch.arange(s, device=device)[:, None]
    k = torch.arange(s, device=device)[None, :]
    return (k <= q) | (k < prefix)


def _batch_patches(batch: Dict, cfg: ModelConfig) -> Optional[torch.Tensor]:
    """A vision config's ``batch["patch_embeds"]`` (B, P, d), else None."""
    return batch.get("patch_embeds") if cfg.vision_tokens else None


def _with_patches(h, patches: Optional[torch.Tensor]):
    """``(h, mask, prefix)``: ``patches`` (B, P, d) concatenated ahead of
    the embedded tokens ``h``, with the prefix-LM mask over both; ``h``,
    None and 0 without patches."""
    if patches is None:
        return h, None, 0
    h = torch.cat([patches.to(h.dtype), h], dim=1)
    prefix = patches.shape[1]
    return h, _prefix_mask(h.shape[1], prefix, h.device), prefix


def forward(params: Dict, batch: Dict, cfg: ModelConfig, *,
            use_adapters: bool = True) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab); ``use_adapters=False``
    runs the base alone (the teacher, or the drifted array without its
    side-cars). An encoder-decoder config also takes ``batch["enc_embeds"]``
    (B, S_src, d); a vision config ``batch["patch_embeds"]`` (B, P, d),
    whose positions take no logits."""
    base = params["base"]
    adapters = _adapters_or_empty(params) if use_adapters else _empty_adapters(base)
    h = L.embed(batch["tokens"], base["embed"], scale_by_sqrt_dim=cfg.embed_scale)
    h, mask, prefix = _with_patches(h, _batch_patches(batch, cfg))
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode(base, adapters, batch["enc_embeds"].to(h.dtype), cfg)
    positions = torch.arange(h.shape[1], device=h.device)[None]
    for _, b, a_, (mixer, ffn) in _layers(base, adapters, cfg):
        h = block_forward(h, b, a_, cfg, mixer, ffn, positions=positions, mask=mask,
                          enc_out=enc_out)
    h = _norm(h, base["final_norm"], cfg)
    return _lm_head(h, base, adapters, cfg)[:, prefix:]


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
    """Mean over blocks (the encoder's first, then the decoder's, and the
    untied lm_head's logits) of the teacher/student MSE; returns ``(loss,
    {"feature_mse": loss})``. Every decoder block, the student's too, reads
    the teacher's normed encoder output; a vision config's blocks run over
    the patches and the tokens under the prefix-LM mask."""
    with torch.no_grad():
        h = L.embed(batch["tokens"], teacher_base["embed"],
                    scale_by_sqrt_dim=cfg.embed_scale)
        h, mask, _ = _with_patches(h, _batch_patches(batch, cfg))
    positions = torch.arange(h.shape[1], device=h.device)[None]
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    n_terms = 0
    enc_out = None
    if cfg.encoder_layers:
        h_enc = batch["enc_embeds"].to(h.dtype)
        enc_mask, enc_pos = _enc_inputs(h_enc)
        for (tb, _), (sb, sa) in zip(_enc_layers(teacher_base, {}, cfg),
                                     _enc_layers(student_base, adapters, cfg)):
            with torch.no_grad():
                t_out = block_forward(h_enc, tb, {}, cfg, "attn", "mlp", positions=enc_pos,
                                      mask=enc_mask)
            s_out = block_forward(h_enc, sb, sa, cfg, "attn", "mlp", positions=enc_pos,
                                  mask=enc_mask)
            loss = loss + _mse(t_out, s_out)
            h_enc = t_out
        with torch.no_grad():
            enc_out = _norm(h_enc, teacher_base["enc_norm"], cfg)
        n_terms += cfg.encoder_layers
    teacher = _layers(teacher_base, _empty_adapters(teacher_base), cfg)
    for (_, tb, _, (mixer, ffn)), (_, sb, sa, _) in zip(
            teacher, _layers(student_base, adapters, cfg)):
        with torch.no_grad():
            t_out = block_forward(h, tb, {}, cfg, mixer, ffn, positions=positions,
                                  mask=mask, enc_out=enc_out)
        s_out = block_forward(h, sb, sa, cfg, mixer, ffn, positions=positions, mask=mask,
                              enc_out=enc_out)
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, src_len: int = 0) -> Dict:
    """The decode cache. An SSM layer's is its state ``"h"`` (B, d_inner,
    N) and conv window ``"conv"`` (B, K-1, d_inner), both f32, whatever
    ``max_len``; an RG-LRU layer's ``"h"`` (B, d_rnn) and ``"conv"`` (B,
    K-1, d_rnn), both f32; a local layer's K/V only its window. An
    encoder-decoder config adds to each layer's cache its cross-attention
    lines over ``src_len`` source positions (``"xk"``/``"xv"``, written
    once at admission) and to the cache the per-slot valid source length
    ``"enc_len"`` (int32)."""
    kinds = cfg.layer_kinds()
    pro, n_groups, epi = cfg.body_layout()
    p = cfg.scan_period

    def layer_cache(mixer):
        if mixer == "ssm":
            return S.init_ssm_cache(batch, cfg.ssm, device)
        if mixer == "rglru":
            return R.init_rglru_cache(batch, cfg.rglru, device)
        c = A.init_kv_cache(batch, max_len, _attn_cfg(cfg, mixer), device, cfg.dtype)
        if cfg.encoder_layers:
            c.update(A.init_cross_cache(batch, max(src_len, 1),
                                        _attn_cfg(cfg, "attn", cross=True), device, cfg.dtype))
        return c

    cache: Dict = {"prologue": [layer_cache(kinds[i][0]) for i in range(pro)]}
    if n_groups:
        cache["body"] = tree_lib.stack([
            [layer_cache(kinds[pro + g * p + j][0]) for j in range(p)]
            for g in range(n_groups)
        ])
    cache["epilogue"] = [layer_cache(kinds[i][0])
                         for i in range(cfg.n_layers - epi, cfg.n_layers)]
    if cfg.encoder_layers:
        cache["enc_len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _flat_layout(like: Dict, unit: int):
    """(offset, elements) of each leaf of ``like`` in a buffer of
    ``unit``-byte elements, leaf after leaf; a leaf of wider elements (the
    int32 ``enc_len``) starts at an offset aligned to its element size."""
    spans, off = [], 0
    for t in tree_lib.tensors(like):
        ratio = max(t.element_size() // unit, 1)
        off = -(-off // ratio) * ratio
        n = -(-t.numel() * t.element_size() // unit)
        spans.append((off, n))
        off += n
    return spans, off


def flat_views(like: Dict, flat: torch.Tensor) -> Dict:
    """``like``'s tree (``init_cache``'s) as views of ``flat``; a leaf of
    another dtype than the buffer's is a view of its bytes there
    (``Tensor.view`` by dtype), so copying the buffer copies it too."""
    spans, _ = _flat_layout(like, flat.element_size())
    views = [flat[off:off + n].view(t.dtype).view(t.shape)
             for (off, n), t in zip(spans, tree_lib.tensors(like))]
    return tree_lib.unflatten(like, views)


def init_flat_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                    src_len: int = 0) -> Tuple[torch.Tensor, Dict]:
    """``init_cache``'s tree as views of ONE zeroed buffer, returned with
    it: a whole cache (the int32 ``enc_len`` and the f32 recurrent state
    included) is then zeroed, saved or restored by one op."""
    like = init_cache(cfg, batch, max_len, "meta", src_len)
    unit = torch.empty((), dtype=cfg.dtype).element_size()
    flat = torch.zeros(_flat_layout(like, unit)[1], dtype=cfg.dtype, device=device)
    return flat, flat_views(like, flat)


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
    place; ``enc_len`` and the cross lines included). Stacked body leaves
    carry batch on axis 1."""
    for key, v in cache.items():
        ones = tree_lib.tensors(one[key])
        for big, o in zip(tree_lib.tensors(v), ones):
            if key == "body":
                big[:, slot] = o[:, 0]
            else:
                big[slot] = o[0]
    return cache


def encode_into_cache(params: Dict, cache: Dict, enc_embeds: torch.Tensor,
                      cfg: ModelConfig) -> Dict:
    """Run the encoder once over ``enc_embeds`` (B, S_src, d) and write each
    decoder layer's cross-attention K/V into positions [0, S_src) of its
    ``"xk"``/``"xv"`` lines, and ``S_src`` into ``"enc_len"`` (in place).
    The lines past ``S_src`` keep what they held: they stay masked."""
    base = params["base"]
    adapters = _adapters_or_empty(params)
    enc_out = encode(base, adapters, enc_embeds.to(cfg.dtype), cfg)
    s_src = enc_out.shape[1]
    xcfg = _attn_cfg(cfg, "attn", cross=True)
    layer_caches = _cache_layers(cache, cfg)
    for i, lb, la, _ in _layers(base, adapters, cfg):
        k, v = A.cross_kv(enc_out, lb["xattn"], la.get("xattn"), xcfg, cfg.adapter)
        layer_caches[i]["xk"][:, :s_src] = k
        layer_caches[i]["xv"][:, :s_src] = v
    cache["enc_len"].fill_(s_src)
    return cache


# ---------------------------------------------------------------------------
# fused prefill
# ---------------------------------------------------------------------------


def prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, enc_embeds: Optional[torch.Tensor] = None,
            patch_embeds: Optional[torch.Tensor] = None, *,
            cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """One forward over the whole prompt: last-position logits
    (B, 1, vocab) and a decode cache ready at ``pos = S``. An
    encoder-decoder config runs its encoder over ``enc_embeds`` first; the
    cache then holds each layer's cross lines at the exact source length
    and ``enc_len``. ``patch_embeds`` (B, P, d) puts a prefix-LM vision
    prefix at positions [0, P); the decode clock then starts at ``P + S``.
    ``cache``, a tree of ``init_flat_cache``'s views at batch B and
    ``max_len`` (its cross lines may run past the source), is filled in
    place and returned, every byte of every leaf as a fresh cache would
    hold it (nothing it held before survives), with static shapes and no
    host sync, so a CUDA graph can capture the call. Without it the call
    allocates the cache."""
    base = params["base"]
    adapters = _adapters_or_empty(params)
    b = tokens.shape[0]
    h = L.embed(tokens, base["embed"], scale_by_sqrt_dim=cfg.embed_scale)
    h, mask, _ = _with_patches(h, patch_embeds)
    positions = torch.arange(h.shape[1], device=h.device)[None]
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode(base, adapters, enc_embeds.to(h.dtype), cfg)
    if cache is None:
        cache = init_cache(cfg, b, max_len, h.device,
                           0 if enc_out is None else enc_out.shape[1])
    if enc_out is not None:
        cache["enc_len"].fill_(enc_out.shape[1])
    layer_caches = _cache_layers(cache, cfg)
    xcfg = _attn_cfg(cfg, "attn", cross=True) if enc_out is not None else None
    for i, lb, la, (mixer, ffn) in _layers(base, adapters, cfg):
        x = _norm(h, lb["norm1"], cfg)
        if mixer == "ssm":
            mix, state = S.ssm_block(x, lb["mixer"], la.get("mixer"), cfg.ssm, cfg.adapter,
                                     return_state=True)
        elif mixer == "rglru":
            mix, state = R.rglru_block(x, lb["mixer"], la.get("mixer"), cfg.rglru,
                                       cfg.adapter, return_state=True)
        else:
            acfg = _attn_cfg(cfg, mixer)
            mix, kv = A.attention(x, lb["mixer"], la.get("mixer"), acfg, cfg.adapter,
                                  positions=positions, mask=mask, return_kv=True)
            A.prefill_kv_cache(kv, b, max_len, acfg, cfg.dtype, cache=layer_caches[i])
            state = {}
        for name, buf in state.items():
            layer_caches[i][name].copy_(buf)
        h = h + mix
        if enc_out is not None and "xattn" in lb:
            x = _norm(h, lb["norm_x"], cfg)
            xa, xkv = A.attention(x, lb["xattn"], la.get("xattn"), xcfg, cfg.adapter,
                                  kv_input=enc_out, return_kv=True)
            h = h + xa
            for name in ("k", "v"):  # zeros past the source, as a fresh cache's
                lines, n = layer_caches[i]["x" + name], enc_out.shape[1]
                lines[:, :n] = xkv[name]
                lines[:, n:].zero_()
        h = _ffn(h, lb, la, cfg, ffn)
    h = _norm(h, base["final_norm"], cfg)
    logits = _lm_head(h[:, -1:], base, adapters, cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# decode tick
# ---------------------------------------------------------------------------


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One batched decode tick; row ``b`` sits at clock ``pos[b]``. The
    cross-attention of an encoder-decoder config reads the cache's lines,
    masked per row by ``cache["enc_len"]``."""
    base = params["base"]
    adapters = _adapters_or_empty(params)
    pos = A._as_pos_vector(pos, tokens.shape[0], tokens.device)
    h = L.embed(tokens, base["embed"], scale_by_sqrt_dim=cfg.embed_scale)
    layer_caches = _cache_layers(cache, cfg)
    for i, lb, la, (mixer, ffn) in _layers(base, adapters, cfg):
        x = _norm(h, lb["norm1"], cfg)
        if mixer == "ssm":  # a recurrent state is per row: no clock
            mix, _ = S.ssm_decode(x, layer_caches[i], lb["mixer"], la.get("mixer"), cfg.ssm,
                                  cfg.adapter)
        elif mixer == "rglru":
            mix, _ = R.rglru_decode(x, layer_caches[i], lb["mixer"], la.get("mixer"),
                                    cfg.rglru, cfg.adapter)
        else:
            mix, _ = A.decode_attention(x, layer_caches[i], pos, lb["mixer"],
                                        la.get("mixer"), _attn_cfg(cfg, mixer), cfg.adapter)
        h = _cross_cached(h + mix, layer_caches[i], cache.get("enc_len"), lb, la, cfg)
        h = _ffn(h, lb, la, cfg, ffn)
    h = _norm(h, base["final_norm"], cfg)
    return _lm_head(h, base, adapters, cfg), cache


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


def _cross_cached(h, cache_l, enc_len, b, a_, cfg: ModelConfig):
    """The residual stream after a decoder layer's cross-attention against
    its cached lines, if the layer has one."""
    if "xattn" not in b or enc_len is None:
        return h
    x = _norm(h, b["norm_x"], cfg)
    return h + A.cross_attention_cached(x, cache_l, enc_len, b["xattn"], a_.get("xattn"),
                                        _attn_cfg(cfg, "attn", cross=True), cfg.adapter)


def _chunk_block(h, cache_l, pos0, n_valid, b, a_, cfg: ModelConfig, mixer: str,
                 ffn: str, *, max_len: int, enc_len=None, prefix: int = 0):
    a_ = a_ or {}
    if mixer not in _ATTN:  # a recurrence's scan regroups by length: no chunks
        raise ValueError(f"chunked prefill supports attention mixers only, got {mixer!r}")
    x = _norm(h, b["norm1"], cfg)
    mix, new_kv = A.chunk_attention(x, cache_l, pos0, n_valid, b["mixer"],
                                    a_.get("mixer"), _attn_cfg(cfg, mixer),
                                    cfg.adapter, max_len=max_len, prefix=prefix)
    h = _cross_cached(h + mix, cache_l, enc_len, b, a_, cfg)
    return _ffn(h, b, a_, cfg, ffn), new_kv


def _chunk_stack(params, h, cache, pos0, n_valid, cfg: ModelConfig, max_len: int,
                 prefix: int = 0):
    """Walk the layer stack with ``_chunk_block``; final norm applied.
    ``prefix`` (static) is the vision prefix's extent: keys below it are
    open to every query."""
    base = params["base"]
    adapters = _adapters_or_empty(params)
    layer_caches = _cache_layers(cache, cfg)
    for i, lb, la, kind in _layers(base, adapters, cfg):
        h, _ = _chunk_block(h, layer_caches[i], pos0, n_valid, lb, la, cfg,
                            *kind, max_len=max_len, enc_len=cache.get("enc_len"),
                            prefix=prefix)
    return _norm(h, base["final_norm"], cfg), cache


def prefill_chunk(params: Dict, tokens: torch.Tensor, cache: Dict, pos0, n_valid,
                  cfg: ModelConfig, max_len: int) -> Tuple[torch.Tensor, Dict]:
    """Advance a decode cache by one prompt chunk (zero-padded tail):
    logits at the chunk's last valid position (B, 1, vocab). A text chunk
    after a vision prefix sits at ``pos0 >= P``, where the causal mask
    already opens the patches to it."""
    base = params["base"]
    b, _ = tokens.shape
    pos0 = A._as_pos_vector(pos0, b, tokens.device)
    n_valid = A._as_pos_vector(n_valid, b, tokens.device)
    h = L.embed(tokens, base["embed"], scale_by_sqrt_dim=cfg.embed_scale)
    h, cache = _chunk_stack(params, h, cache, pos0, n_valid, cfg, max_len)
    rows = torch.arange(b, device=h.device)
    h_last = h[rows, n_valid - 1][:, None]
    return _lm_head(h_last, base, _adapters_or_empty(params), cfg), cache


def prefill_vision(params: Dict, patch_embeds: torch.Tensor, cache: Dict,
                   cfg: ModelConfig, max_len: int) -> Dict:
    """Admit a vision prefix into a decode cache (in place): the P patch
    positions (B, P, d), at [0, P), attend to each other bidirectionally;
    text chunks and decode ticks then start at ``pos0 = P``. No logits."""
    b, p_, _ = patch_embeds.shape
    h = patch_embeds.to(cfg.dtype)
    pos0 = torch.zeros((b,), dtype=torch.int64, device=h.device)
    n_valid = torch.full((b,), p_, dtype=torch.int64, device=h.device)
    _, cache = _chunk_stack(params, h, cache, pos0, n_valid, cfg, max_len, prefix=p_)
    return cache


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
