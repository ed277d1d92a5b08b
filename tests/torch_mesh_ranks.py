"""Rank functions of ``test_torch_mesh.py``: each runs in a spawned
process (``launch.mesh.run_ranks``) and returns host values for the
parent to check. This module imports no jax, so the ranks start fast.

Every rank pins one intra-op thread: the CPU's BLAS sums a column block
of a product in another order than the whole product at several threads
(``x @ w[:, block]`` differs in bits from ``(x @ w)[:, block]``), at one
it does not. The single-device twins run in rank 0, at one thread too.
"""
import numpy as np
import torch

GEN = 5
PREFILL = (2, 40)          # 80 rows: the tiled launcher
ENGINE = dict(max_slots=2, max_len=32)
REMESH_PROMPTS = [np.arange(4), np.arange(7) * 3]
REMESH_NEW = 8
REMESH_AT = 3


def _deployment(case, device):
    """A codes deployment of the case: the reference's arrays carried
    across (``arrays``), or the port's own smoke programming, 24 h on."""
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment

    cfg = get_arch(case["arch"]).smoke
    if case.get("arrays") is not None:
        teacher, codes, adapters, hours = case["arrays"]
        return Deployment.from_arrays(cfg, teacher, codes, adapters, backend="codes",
                                      drift_hours=hours, device=device)
    return Deployment.program(cfg, 0, backend="codes", device=device).advance(24)


def _inputs(vocab):
    rng = np.random.default_rng(1)
    return (torch.as_tensor(rng.integers(0, vocab, (2, 6))),
            torch.as_tensor(rng.integers(0, vocab, PREFILL)))


def serve_rank(rank, world, device, cases):
    """Every case on a (1, world) mesh and both bodies: greedy streams,
    prefill logits, shard stats, the mesh registry's compile count over
    two engine drives; rank 0 also the single-device twins and the
    refusals."""
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, ServeEngine
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    mesh = make_host_mesh((1, world), device=device)
    out = {}
    for case in cases:
        dep = _deployment(case, device)
        prompt, tokens = _inputs(dep.cfg.vocab)
        for accum in ("f32", "int8"):
            session = dep.serve(accum=accum, mesh=mesh)
            got = {"stats": session.shard_stats,
                   "streams": session.generate(prompt, gen_len=GEN)[0],
                   "logits": session.prefill(tokens, 48)[0]}
            counts = []
            for _ in range(2):
                engine = ServeEngine(session, **ENGINE)
                for p in REMESH_PROMPTS:
                    engine.submit(p % dep.cfg.vocab, max_new=REMESH_NEW)
                engine.run()
                counts.append(session.compile_count())
                del engine
            got["compile_counts"] = counts
            got["step_kinds"] = sorted({s.key[0] for s in session.steps})
            got["eager"] = all(s.eager and s.graph is None for s in session.steps)
            if rank == 0:
                solo = dep.serve(accum=accum)
                got["solo_streams"] = solo.generate(prompt, gen_len=GEN)[0]
                got["solo_logits"] = solo.prefill(tokens, 48)[0]
            out[case["arch"], accum] = got
    if rank == 0:
        out["refusals"] = _refusals(mesh, device)
    return out


def _refusals(mesh, device):
    """The message of each refusal a mesh session makes (None: no raise)."""
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, ServeEngine

    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    def program(arch, backend="codes"):
        return Deployment.program(get_arch(arch).smoke, 0, backend=backend, device=device)

    out = {"dequant": message(lambda: program("qwen3_1_7b", "dequant").serve(mesh=mesh))}
    seamless = program("seamless_m4t_large_v2")
    out["encoder"] = message(lambda: seamless.serve(mesh=mesh))
    vlm = program("paligemma_3b")
    session = vlm.serve(mesh=mesh)
    cfg = vlm.cfg
    patches = np.zeros((1, cfg.vision_tokens, cfg.d_model), np.float32)
    prompt = np.arange(4)[None] % cfg.vocab
    out["vision_generate"] = message(
        lambda: session.generate(prompt, gen_len=2, patch_embeds=patches))
    out["vision_submit"] = message(
        lambda: ServeEngine(session, max_slots=1, max_len=512).submit(
            prompt[0], max_new=2, patch_embeds=patches[0]))
    out["vision_step"] = message(lambda: session.prefill_vision_fn(512))
    return out


def remesh_rank(rank, world, device, cases):
    """Each case's engine traffic on a (2, world / 2) mesh, degraded by one
    host at tick ``REMESH_AT``; rank 0 also the undisturbed single-device
    engine."""
    from repro_torch.deploy import ServeEngine
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    mesh = make_host_mesh((2, world // 2), device=device)

    def run(session, remesh_at=None):
        engine = ServeEngine(session, **ENGINE)
        reqs = [engine.submit(p % session.cfg.vocab, max_new=REMESH_NEW)
                for p in REMESH_PROMPTS]
        plan, n, emitted = None, 0, None
        while engine.step():
            n += 1
            if n == remesh_at:
                emitted = [len(r.tokens) for r in reqs]
                plan = engine.remesh()
                plan = (plan.failed_hosts, plan.new_mesh_shape)
        return {"streams": [list(r.tokens) for r in reqs], "plan": plan, "left": engine.left,
                "emitted_at_remesh": emitted,
                "mesh": None if session.mesh is None else session.mesh.shape}

    out = {}
    for case in cases:
        dep = _deployment(case, device)
        got = run(dep.serve(mesh=mesh), REMESH_AT)
        if rank == 0:
            got["solo"] = run(dep.serve())["streams"]
        out[case["arch"]] = got
    return out
