"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global, 128k context.
[hf:google/gemma-3-1b-pt; unverified] Port of
``repro/configs/gemma3_12b.py``.

The reference's simplifications stand: one rope_theta for local and
global layers (gemma3 uses 10k local / 1M global), pre-norm only (no
post-norms)."""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import MlpConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b",
    d_model=3840,
    n_layers=48,
    vocab=262144,
    attn=AttentionConfig(
        d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
        rope_theta=1e6,
    ),
    mlp=MlpConfig(d_model=3840, d_ff=15360, gated=True, activation="gelu_tanh"),
    mixer_pattern=("local", "local", "local", "local", "local", "attn"),
    ffn_pattern=("mlp",),
    local_window=1024,
    norm="rms",
    embed_scale=True,
    tie_lm_head=True,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    d_model=64,
    n_layers=6,  # one full 5:1 local:global group
    vocab=512,
    attn=AttentionConfig(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16),
    mlp=MlpConfig(d_model=64, d_ff=128, gated=True, activation="gelu_tanh"),
    mixer_pattern=("local", "local", "local", "local", "local", "attn"),
    local_window=8,
    embed_scale=True,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(name="gemma3-12b", full=FULL, smoke=SMOKE)
