"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron (ungated ReLU MLP, LayerNorm, untied
head). [arXiv:2407.14679; hf] Port of ``repro/configs/minitron_8b.py``."""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import MlpConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="minitron-8b",
    d_model=4096,
    n_layers=32,
    vocab=256000,
    attn=AttentionConfig(
        d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=10000.0,
    ),
    mlp=MlpConfig(d_model=4096, d_ff=16384, gated=False, activation="relu"),
    norm="layer",
    tie_lm_head=False,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    d_model=64,
    n_layers=4,
    vocab=512,
    attn=AttentionConfig(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16),
    mlp=MlpConfig(d_model=64, d_ff=128, gated=False, activation="relu"),
    norm="layer",
    tie_lm_head=False,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(name="minitron-8b", full=FULL, smoke=SMOKE)
