"""Unified crossbar substrate: one resident weight format (uint8
``CrossbarWeight`` codes), several execution backends. Port of
``repro/substrate``."""
from repro_torch.core.rram import CrossbarWeight, dequantize, program  # noqa: F401
from repro_torch.substrate.backends import (  # noqa: F401
    Backend,
    DEFAULT_BACKEND,
    active_backend_name,
    available_backends,
    crossbar_linear,
    get_backend,
    register_backend,
    use_backend,
)
from repro_torch.substrate.exec import (  # noqa: F401
    code_column_norms,
    dora_gamma,
    rimc_linear,
)
from repro_torch.substrate.prepared import (  # noqa: F401
    PreparedCrossbar,
    fuse_crossbars,
    prepare_base_for_serve,
    prepare_crossbar,
    prepared_ref_forward,
    rimc_linear_prepared,
)
