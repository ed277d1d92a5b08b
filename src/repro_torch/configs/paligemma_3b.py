"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma. [arXiv:2407.07726; hf] Port of
``repro/configs/paligemma_3b.py``.

The SigLIP vision tower is a stub, as in the reference: a request
carries 256 precomputed patch embeddings, which sit ahead of the text
and attend to each other bidirectionally (prefix-LM masking); the gemma
text backbone is modelled whole."""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import MlpConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="paligemma-3b",
    d_model=2048,
    n_layers=18,
    vocab=257216,
    attn=AttentionConfig(
        d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
        rope_theta=10000.0,
    ),
    mlp=MlpConfig(d_model=2048, d_ff=16384, gated=True, activation="gelu_tanh"),
    norm="rms",
    embed_scale=True,
    tie_lm_head=True,
    vision_tokens=256,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="paligemma-smoke",
    d_model=64,
    n_layers=4,
    vocab=512,
    attn=AttentionConfig(d_model=64, num_heads=4, num_kv_heads=1, head_dim=16),
    mlp=MlpConfig(d_model=64, d_ff=128, gated=True, activation="gelu_tanh"),
    embed_scale=True,
    vision_tokens=8,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(name="paligemma-3b", full=FULL, smoke=SMOKE)
