"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch. [arXiv:2401.14196; hf] Port of
``repro/configs/deepseek_coder_33b.py``."""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import MlpConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="deepseek-coder-33b",
    d_model=7168,
    n_layers=62,
    vocab=32256,
    attn=AttentionConfig(
        d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
        rope_theta=100000.0,
    ),
    mlp=MlpConfig(d_model=7168, d_ff=19200, gated=True, activation="silu"),
    norm="rms",
    tie_lm_head=False,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="deepseek-coder-smoke",
    d_model=64,
    n_layers=4,
    vocab=512,
    attn=AttentionConfig(d_model=64, num_heads=8, num_kv_heads=2, head_dim=8),
    mlp=MlpConfig(d_model=64, d_ff=160, gated=True, activation="silu"),
    tie_lm_head=False,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(name="deepseek-coder-33b", full=FULL, smoke=SMOKE)
