"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (MHA kv=16)
d_ff=8192 vocab=256206 — encoder-decoder, multimodal.
[arXiv:2308.11596; hf] Port of ``repro/configs/seamless_m4t_large_v2.py``.

The audio (conformer) frontend is a stub: the encoder takes precomputed
frame embeddings (up to ``enc_src_len`` frames); "24L" is read as 24
encoder + 24 decoder layers (the HF large-v2 layout), the decoder's with
cross-attention over the encoder's output."""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import MlpConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    d_model=1024,
    n_layers=24,
    vocab=256206,
    attn=AttentionConfig(
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        rope_theta=10000.0,
    ),
    mlp=MlpConfig(d_model=1024, d_ff=8192, gated=False, activation="gelu"),
    norm="layer",
    tie_lm_head=False,
    encoder_layers=24,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    d_model=64,
    n_layers=4,
    vocab=512,
    attn=AttentionConfig(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16),
    mlp=MlpConfig(d_model=64, d_ff=128, gated=False, activation="gelu"),
    norm="layer",
    tie_lm_head=False,
    encoder_layers=2,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(name="seamless-m4t-large-v2", full=FULL, smoke=SMOKE, enc_src_len=4096)
