"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408(per-expert)
vocab=102400 — MLA kv_lora=512, 2 shared + 64 routed top-6 experts,
first layer dense (d_ff 10944). [arXiv:2405.04434; hf] Port of
``repro/configs/deepseek_v2_lite_16b.py``.

MLA caches the 512-wide latent and the 64-wide shared rope key per
position and up-projects the whole buffer through ``k_up``/``v_up`` at
every step (``models/attention.py``). The dense first layer is the
prologue; the 26 MoE layers are the stacked body.
"""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.layers import MlpConfig
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    d_model=2048,
    n_layers=27,
    vocab=102400,
    attn=AttentionConfig(
        d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        rope_theta=10000.0, mla=True, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    ),
    mlp=MlpConfig(d_model=2048, d_ff=10944, gated=True, activation="silu"),
    moe=MoeConfig(
        d_model=2048, d_ff=1408, n_experts=64, top_k=6, n_shared=2,
        capacity_factor=1.25, activation="silu",
    ),
    mixer_pattern=("attn",),
    ffn_pattern=("moe",),
    prologue_layers=1,
    prologue_ffn="mlp",
    norm="rms",
    tie_lm_head=False,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    d_model=64,
    n_layers=4,
    vocab=512,
    attn=AttentionConfig(
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        mla=True, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    mlp=MlpConfig(d_model=64, d_ff=256, gated=True, activation="silu"),
    moe=MoeConfig(d_model=64, d_ff=32, n_experts=4, top_k=2, n_shared=1,
                  capacity_factor=2.0),
    mixer_pattern=("attn",),
    ffn_pattern=("moe",),
    prologue_layers=1,
    prologue_ffn="mlp",
    tie_lm_head=False,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(
    name="deepseek-v2-lite-16b",
    full=FULL,
    smoke=SMOKE,
    notes="MLA latent cache; dense prologue layer before 26 MoE layers",
)
