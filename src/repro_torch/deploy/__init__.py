"""Deployment lifecycle API of the port (``repro.deploy``'s counterpart):

    from repro_torch.deploy import Deployment

    dep = Deployment.program(cfg, seed, backend="codes")  # on the card
    dep.advance(hours=24)          # drift clock: field time passes
    session = dep.serve()          # merged adapters + backend scope
    toks, dt = session.generate(prompt)
"""
from repro_torch.deploy.deployment import Deployment  # noqa: F401
from repro_torch.deploy.engine import Request, ServeEngine  # noqa: F401
from repro_torch.deploy.serving import (  # noqa: F401
    BACKENDS,
    ServeSession,
    backend_scope,
    generate,
    prefill_and_cache,
)
