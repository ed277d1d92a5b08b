"""Tensor-parallel serving and the elastic re-mesh of the port, on the
CPU, in spawned gloo ranks (``launch.mesh.run_ranks``; the rank functions
are in ``torch_mesh_ranks.py``): the reference's ``tests/test_mesh.py``
claims, which its tier-1 run skips for want of devices.

* On a (1, 4) mesh, greedy generation and the fused prefill's logits
  (80 rows: the tiled launcher) are bitwise the single-device session's,
  for qwen3-1.7b (the reference's arrays carried across), deepseek-v2-lite
  and mixtral-8x22b smoke, through the f32 and the int8 body; the wrap
  policy sharded something; the mesh's steps run eagerly, built once
  (``compile_count`` flat over a second drive).
* The refusals: a ``dequant`` deployment ("codes"), an encoder-decoder
  config and a vision request ("decoder-only").
* A (2, 4) mesh that loses a host at tick 3 degrades to (1, 4)
  (``failed_hosts`` 1); the surviving row's streams are bitwise an
  undisturbed single-device engine's, for qwen3-1.7b (chunked admission)
  and falcon-mamba-7b (fused-prefill admission); the dropped row leaves
  the loop; qwen's streams are the reference's single-device engine's.

Every rank, and each single-device twin, runs at one intra-op thread:
the CPU's BLAS sums a column block of a product in another order than
the whole product at several threads. Each spawn is joined within
``TIMEOUT`` seconds, so a hang fails its tests instead of the suite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks_lib
from repro.configs import get_arch as j_arch
from repro.deploy import Deployment as JDeployment
from repro.deploy import ServeEngine as JEngine
from repro_torch.launch.mesh import run_ranks

from test_torch_model import np_tree, random_lora_b
from test_torch_serve import EMBED_SCALE, assert_streams_match

TIMEOUT = 240
SERVE_ARCHS = ("qwen3_1_7b", "deepseek_v2_lite_16b", "mixtral_8x22b")
REMESH_ARCHS = ("qwen3_1_7b", "falcon_mamba_7b")


@pytest.fixture(scope="module")
def reference():
    """The reference's qwen3-1.7b smoke codes deployment (24 h, a scaled
    embedding so that streams move, random non-zero B factors), its numpy
    arrays, and its single-device engine's streams on the re-mesh traffic."""
    cfg = j_arch("qwen3_1_7b").smoke
    dep = JDeployment.program(cfg, 0, backend="codes").advance(24)
    emb = dep.teacher_base["embed"]["embedding"] * EMBED_SCALE
    dep.teacher_base["embed"]["embedding"] = emb
    dep.codes["embed"]["embedding"] = emb
    adapters = random_lora_b(np_tree(dep.adapters), seed=5)
    dep.adapters = jax.tree_util.tree_map(jnp.asarray, adapters)
    dep._refresh_base()
    session = dep.serve()
    engine = JEngine(session, **ranks_lib.ENGINE)
    reqs = [engine.submit(p % cfg.vocab, max_new=ranks_lib.REMESH_NEW)
            for p in ranks_lib.REMESH_PROMPTS]
    engine.run()
    arrays = (np_tree(dep.teacher_base), np_tree(dep.codes), adapters, dep.drift_hours)
    return {"session": session, "arrays": arrays,
            "streams": [list(map(int, r.tokens)) for r in reqs]}


def _cases(archs, reference):
    return [{"arch": a, "arrays": reference["arrays"] if a == "qwen3_1_7b" else None}
            for a in archs]


@pytest.fixture(scope="module")
def served(reference):
    return run_ranks(ranks_lib.serve_rank, 4, device="cpu", timeout=TIMEOUT,
                     args=(_cases(SERVE_ARCHS, reference),))


@pytest.fixture(scope="module")
def remeshed(reference):
    return run_ranks(ranks_lib.remesh_rank, 8, device="cpu", timeout=TIMEOUT,
                     args=(_cases(REMESH_ARCHS, reference),))


@pytest.mark.parametrize("accum", ["f32", "int8"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_generate_is_bitwise_single_device(served, arch, accum):
    solo = served[0][arch, accum]
    assert solo["solo_streams"].shape == (2, ranks_lib.GEN)
    for got in (r[arch, accum] for r in served):
        assert got["stats"]["sharded"] > 0, got["stats"]
        np.testing.assert_array_equal(got["streams"], solo["solo_streams"])


@pytest.mark.parametrize("accum", ["f32", "int8"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_logits_are_bitwise_single_device(served, arch, accum):
    solo = served[0][arch, accum]["solo_logits"]
    assert torch.isfinite(solo.float()).all()
    for r in served:
        assert torch.equal(r[arch, accum]["logits"], solo)


def test_shard_stats_match_the_reference_policy(served):
    """qwen shards its four fused leaves; the MLA and MoE smokes keep their
    routers (and deepseek its unshardable leaf) replicated, as the
    reference's policy does (``test_torch_sharding``)."""
    stats = {arch: served[0][arch, "f32"]["stats"] for arch in SERVE_ARCHS}
    assert stats["qwen3_1_7b"] == {"sharded": 4, "replicated": 0}
    assert stats["deepseek_v2_lite_16b"]["replicated"] >= 1
    assert stats["mixtral_8x22b"]["replicated"] >= 1
    for r in served:
        assert all(r[arch, "int8"]["stats"] == stats[arch] for arch in SERVE_ARCHS)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_steps_are_eager_and_built_once(served, arch):
    for r in served:
        for accum in ("f32", "int8"):
            got = r[arch, accum]
            first, second = got["compile_counts"]
            assert first == second > 0, got["compile_counts"]
            assert got["eager"] and {"decode", "prefill_chunk"} <= set(got["step_kinds"])


def test_mesh_serve_requires_codes_backend(served):
    assert "codes" in served[0]["refusals"]["dequant"]


@pytest.mark.parametrize("what", ["encoder", "vision_generate", "vision_submit", "vision_step"])
def test_mesh_serving_is_decoder_only(served, what):
    message = served[0]["refusals"][what]
    assert message is not None and "decoder-only" in message, message


@pytest.mark.parametrize("arch", REMESH_ARCHS)
def test_engine_remesh_replays_inflight_slots_exactly(remeshed, arch):
    """Rows (0, 1, 2, 3) survive, bitwise the undisturbed single-device
    engine, with tokens already emitted at the re-mesh (so the replay fed
    them); rows (4, 5, 6, 7) leave the loop."""
    solo = remeshed[0][arch]["solo"]
    assert all(len(s) == ranks_lib.REMESH_NEW for s in solo)
    for rank, r in enumerate(remeshed):
        got = r[arch]
        assert got["plan"] == (1, (1, 4)), got["plan"]
        assert min(got["emitted_at_remesh"]) >= 2, got["emitted_at_remesh"]
        if rank < 4:
            assert not got["left"] and got["mesh"] == {"data": 1, "model": 4}
            assert got["streams"] == solo, (rank, got["streams"], solo)
        else:
            assert got["left"]


def test_remeshed_streams_are_the_reference_engines(remeshed, reference):
    got = remeshed[0]["qwen3_1_7b"]["streams"]
    for p, ref, mine in zip(ranks_lib.REMESH_PROMPTS, reference["streams"], got):
        assert_streams_match(reference["session"], p % reference["session"].cfg.vocab, ref, mine)
