"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, pattern (rglru, rglru, local).
[arXiv:2402.19427; unverified] Port of ``repro/configs/recurrentgemma_9b.py``.

The recurrent state is O(1) per slot and the local layers keep a rolling
window-2048 cache. 38 layers = 12 x (rglru, rglru, local) + 2 epilogue
rglru layers."""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import MlpConfig
from repro_torch.models.rglru import RglruConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b",
    d_model=4096,
    n_layers=38,
    vocab=256000,
    attn=AttentionConfig(
        d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
        rope_theta=10000.0,
    ),
    mlp=MlpConfig(d_model=4096, d_ff=12288, gated=True, activation="gelu_tanh"),
    rglru=RglruConfig(d_model=4096, d_rnn=4096, conv_kernel=4),
    mixer_pattern=("rglru", "rglru", "local"),
    ffn_pattern=("mlp",),
    local_window=2048,
    norm="rms",
    embed_scale=True,
    tie_lm_head=True,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    d_model=64,
    n_layers=8,  # 2 groups + 2 epilogue, mirrors the 38-layer remainder
    vocab=512,
    attn=AttentionConfig(d_model=64, num_heads=4, num_kv_heads=1, head_dim=16),
    mlp=MlpConfig(d_model=64, d_ff=128, gated=True, activation="gelu_tanh"),
    rglru=RglruConfig(d_model=64, d_rnn=64, conv_kernel=4),
    mixer_pattern=("rglru", "rglru", "local"),
    local_window=8,
    embed_scale=True,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(name="recurrentgemma-9b", full=FULL, smoke=SMOKE)
