"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16, the Mamba-1 architecture. [arXiv:2410.05355] Port of
``repro/configs/falcon_mamba_7b.py``.

The DoRA side-cars attach to the SSM projections (in/x/dt/out): the
paper's technique applies unchanged. The decode state is O(1) per slot
whatever the context length."""
from repro_torch.configs.shapes import ArchSpec
from repro_torch.core.dora import AdapterConfig
from repro_torch.core.rram import RramConfig
from repro_torch.models.ssm import SsmConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b",
    d_model=4096,
    n_layers=64,
    vocab=65024,
    ssm=SsmConfig(d_model=4096, d_inner=8192, state_dim=16, conv_kernel=4, chunk=256),
    mixer_pattern=("ssm",),
    ffn_pattern=("none",),
    norm="rms",
    tie_lm_head=False,
    adapter=AdapterConfig(rank=8, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    d_model=64,
    n_layers=4,
    vocab=512,
    ssm=SsmConfig(d_model=64, d_inner=128, state_dim=8, conv_kernel=4, chunk=16),
    mixer_pattern=("ssm",),
    ffn_pattern=("none",),
    tie_lm_head=False,
    adapter=AdapterConfig(rank=4, kind="dora"),
    rram=RramConfig(relative_drift=0.10),
)

ARCH = ArchSpec(name="falcon-mamba-7b", full=FULL, smoke=SMOKE)
