"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA. Port of ``repro/configs/qwen3_1_7b.py``."""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import MlpConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen3-1.7b",
    d_model=2048,
    n_layers=28,
    vocab=151936,
    attn=AttentionConfig(
        d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
        rope_theta=1e6, qk_norm=True,
    ),
    mlp=MlpConfig(d_model=2048, d_ff=6144, gated=True, activation="silu"),
    mixer_pattern=("attn",),
    ffn_pattern=("mlp",),
    norm="rms",
    tie_lm_head=True,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    d_model=64,
    n_layers=4,
    vocab=512,
    attn=AttentionConfig(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True
    ),
    mlp=MlpConfig(d_model=64, d_ff=128, gated=True, activation="silu"),
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(name="qwen3-1.7b", full=FULL, smoke=SMOKE)
