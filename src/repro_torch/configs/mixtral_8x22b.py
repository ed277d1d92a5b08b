"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, SWA. [arXiv:2401.04088; hf] Port of
``repro/configs/mixtral_8x22b.py``.

Sliding-window attention (window 4096) bounds the KV cache: every layer
keeps a rolling window cache, which chunked admission fills through an
absolute-position canvas (``models/attention.py::chunk_attention``).
"""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x22b",
    d_model=6144,
    n_layers=56,
    vocab=32768,
    attn=AttentionConfig(
        d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
        rope_theta=1e6,
    ),
    moe=MoeConfig(
        d_model=6144, d_ff=16384, n_experts=8, top_k=2, n_shared=0,
        capacity_factor=1.25, activation="silu",
    ),
    mixer_pattern=("swa",),
    ffn_pattern=("moe",),
    local_window=4096,
    norm="rms",
    tie_lm_head=False,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    d_model=64,
    n_layers=4,
    vocab=512,
    attn=AttentionConfig(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16),
    moe=MoeConfig(d_model=64, d_ff=128, n_experts=4, top_k=2, n_shared=0,
                  capacity_factor=2.0),
    mixer_pattern=("swa",),
    ffn_pattern=("moe",),
    local_window=16,
    tie_lm_head=False,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(
    name="mixtral-8x22b",
    full=FULL,
    smoke=SMOKE,
    notes="SWA rolling cache bounds memory at window=4096",
)
