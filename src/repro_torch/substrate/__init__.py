"""Unified crossbar substrate: one resident weight format (uint8
``CrossbarWeight`` codes), several execution backends. Port of
``repro/substrate``."""
from repro_torch.core.rram import CrossbarWeight, dequantize, program  # noqa: F401
from repro_torch.substrate.backends import (  # noqa: F401
    Backend,
    DEFAULT_BACKEND,
    active_backend_key,
    active_backend_name,
    active_options,
    available_backends,
    crossbar_linear,
    get_backend,
    register_backend,
    resolve_adc_limits,
    use_backend,
)
from repro_torch.substrate.exec import (  # noqa: F401
    code_column_norms,
    dora_gamma,
    faulted_codes,
    faulted_view,
    rimc_linear,
    rimc_mvm_adc,
)
from repro_torch.substrate.prepared import (  # noqa: F401
    PreparedCrossbar,
    ShardedPrepared,
    fuse_crossbars,
    place_serve_params,
    prepare_base_for_serve,
    prepare_crossbar,
    prepared_ref_forward,
    rimc_linear_prepared,
    serve_param_specs,
    shard_prepared_for_serve,
    tp_column_allgather,
)
