"""The port's sharding rules, serve-TP wrap policy, fault runtime and
elastic mesh against the reference, in one process (no ranks):

* ``resolve_spec`` and ``serve_tp_shardable`` on every leaf of every zoo
  config at FULL, for ``{data: 2, model: 4}`` and ``{data: 1, model: 16}``,
  and ``unmatched_large_leaves`` of each, equal to the reference's; the
  paths and shapes come from ``jax.eval_shape`` of the reference's init;
* the port's ``param_shardings`` over its own smoke params, and
  ``cache_shardings`` over its decode caches, equal to the reference's
  ``resolve_spec`` over the reference's trees, path for path;
  ``batch_shardings`` and ``replicated``;
* ``shard_prepared_for_serve``'s wrap decision on every prepared leaf and
  its ``stats`` equal to the reference's at smoke (the reference's serve
  tree built abstractly; both read only ``mesh.shape[tp]``, so a stub mesh
  serves), and ``place_serve_params`` keeping each rank's blocks;
* ``runtime/fault.py`` value for value the reference's on the same
  step-time series, plans and signals;
* ``make_elastic_mesh``'s surviving rows and rank order, and its capacity
  error.
"""
import functools
import signal

import jax
import numpy as np
import pytest
import torch

from repro import substrate as jsub
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_arch as j_arch
from repro.core.calibrate import merge_adapters_for_serve, program_model
from repro.models import transformer as JT
from repro.runtime import fault as jfault
from repro.sharding import rules as JR
from repro.substrate.prepared import PreparedCrossbar as JPrepared
from repro.substrate.prepared import ShardedPrepared as JSharded
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.deploy import Deployment
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as TT
from repro_torch.runtime import fault as tfault
from repro_torch.sharding import rules as R
from repro_torch.substrate import prepared as P

AXES = ({"data": 2, "model": 4}, {"data": 1, "model": 16})
SERVE_ARCHS = ("qwen3_1_7b", "deepseek_v2_lite_16b", "mixtral_8x22b")


@functools.lru_cache(maxsize=None)
def _abstract_tree(arch, full=True):
    """The reference's init params of ``arch``, shapes only."""
    cfg = j_arch(arch).full if full else j_arch(arch).smoke
    return jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _abstract(arch, full=True):
    """(path, shape) of every leaf of the reference's init params."""
    params = _abstract_tree(arch, full)
    out = []
    jax.tree_util.tree_map_with_path(
        lambda path, x: out.append((JR._path_str(path), tuple(x.shape))), params)
    return out


def _spec(spec):
    """A placement as entries, a one-axis tuple as its name: jax's
    ``PartitionSpec`` keeps ``("data",)`` as ``"data"``."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def test_port_zoo_is_the_reference_zoo():
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_matches_reference_at_full(arch):
    leaves = _abstract(arch)
    assert leaves
    for axes in AXES:
        for path, shape in leaves:
            assert _spec(R.resolve_spec(path, shape, axes)) == _spec(
                JR.resolve_spec(path, shape, axes)), (path, shape, axes)
            assert R.serve_tp_shardable(path) == JR.serve_tp_shardable(path), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_unmatched_large_leaves_match_reference_at_full(arch):
    abstract = _abstract_tree(arch, True)
    shapes = {path: torch.empty(shape, device="meta") for path, shape in _abstract(arch)}
    # the port's walk over a tree of the same paths (meta tensors: no memory)
    tree = {}
    for path, t in shapes.items():
        node = tree
        parts = path.split("/")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    for min_size in (65536, 1 << 22):
        want = JR.unmatched_large_leaves(abstract, min_size=min_size)
        got = R.unmatched_large_leaves(tree, min_size=min_size)
        assert sorted(got) == sorted(want), min_size


def test_resolve_spec_edges():
    """The divisibility guard, the expert-parallel fallback, trimming to
    rank and the unmatched default, as the reference pins them."""
    axes = {"data": 2, "model": 4}
    assert R.resolve_spec("mixer/q/w", (16, 10), axes) == (None, None)
    assert R.resolve_spec("mixer/q/w", (16, 32), axes) == (None, "model")
    assert R.resolve_spec("ffn/down/w", (6, 32), {"pod": 2, "data": 2, "model": 4},
                          dp=("pod", "data")) == (None, None)
    big = {"data": 16, "model": 16}
    assert R.resolve_spec("ffn/gate_w", (64, 2048, 1408), big) == ("model", None, None)
    assert R.resolve_spec("ffn/gate_w", (8, 6144, 16384), big) == (None, ("data",), "model")
    for path, shape in (("body/0/rnn/h", (4, 256)), ("body/0/mixer/k", (2, 4, 64, 2, 16))):
        assert _spec(R.resolve_spec(path, shape, axes, R.CACHE_RULES)) == _spec(
            JR.resolve_spec(path, shape, axes, JR.CACHE_RULES))
    assert R.resolve_spec("adapters/x/lora_a", (64, 8), axes) == ()
    assert R.match_rule(R.PARAM_RULES, "body/0/norm2/bias") == ()


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_param_shardings_of_port_trees_match_reference(arch):
    cfg = get_arch(arch).smoke
    params = TT.init_params(torch.Generator().manual_seed(0), cfg)
    got = {}
    specs = R.param_shardings(params, mesh_lib.Mesh(np.arange(8).reshape(2, 4),
                                                    ("data", "model")))
    tree_lib.map_with_path(lambda path, s: got.__setitem__(tree_lib.path_str(path), _spec(s)),
                           specs, is_leaf=lambda v: isinstance(v, tuple))
    want = {path: _spec(JR.resolve_spec(path, shape, AXES[0]))
            for path, shape in _abstract(arch, full=False)}
    assert got == want


@pytest.mark.parametrize("arch", SERVE_ARCHS + ("falcon_mamba_7b", "recurrentgemma_9b"))
def test_cache_and_batch_shardings_match_reference(arch):
    """The port's decode cache (meta tensors) placed by ``CACHE_RULES`` as
    the reference's is, path for path; a batch's leading dim over "data"
    where it divides."""
    mesh = mesh_lib.Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    cache = TT.init_cache(get_arch(arch).smoke, 4, 16, "meta")
    got = {}
    tree_lib.map_with_path(lambda path, s: got.__setitem__(tree_lib.path_str(path), _spec(s)),
                           R.cache_shardings(cache, mesh),
                           is_leaf=lambda v: isinstance(v, tuple))
    ref_cache = jax.eval_shape(lambda: JT.init_cache(j_arch(arch).smoke, 4, 16))
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, x: want.__setitem__(JR._path_str(path), _spec(JR.resolve_spec(
            JR._path_str(path), x.shape, AXES[0], JR.CACHE_RULES))), ref_cache)
    assert got == want
    batch = {"tokens": torch.zeros(4, 8), "odd": torch.zeros(3, 8), "step": torch.zeros(())}
    assert R.batch_shardings(batch, mesh) == {
        "tokens": (("data",), None), "odd": (None, None), "step": ()}
    assert R.replicated(batch, mesh) == {"tokens": (), "odd": (), "step": ()}


class _StubMesh:
    shape = {"data": 1, "model": 4}


def _reference_wraps(arch):
    """path -> (wrapped, local n, n_total) of the reference's serve tree
    (built abstractly) under the wrap policy, and its stats."""
    cfg = j_arch(arch).smoke

    def serve_tree():
        p = JT.init_params(jax.random.PRNGKey(0), cfg)
        codes = program_model(p["base"], cfg.rram, jax.random.PRNGKey(1), mode="codes")
        merged = merge_adapters_for_serve(codes, p["adapters"])
        return {"base": jsub.prepare_base_for_serve(codes, merged, cfg), "adapters": merged}

    out, stats = jsub.shard_prepared_for_serve(jax.eval_shape(serve_tree), _StubMesh)
    wraps = {}

    def leaf(path, v):
        if isinstance(v, JSharded):
            wraps[JR._path_str(path)] = (True, v.local.n, v.n_total)
        elif isinstance(v, JPrepared):
            wraps[JR._path_str(path)] = (False, v.n, v.n)
        return v

    jax.tree_util.tree_map_with_path(leaf, out,
                                     is_leaf=lambda v: isinstance(v, (JSharded, JPrepared)))
    return wraps, stats


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_wrap_decisions_and_stats_match_reference(arch):
    want, want_stats = _reference_wraps(arch)
    session = Deployment.program(get_arch(arch).smoke, 0, backend="codes", device="cpu").serve()
    out, stats = P.shard_prepared_for_serve(session.params, _StubMesh)
    got = {}

    def leaf(path, v):
        if isinstance(v, P.ShardedPrepared):
            got[tree_lib.path_str(path)] = (True, v.local.n, v.n_total)
        elif isinstance(v, P.PreparedCrossbar):
            got[tree_lib.path_str(path)] = (False, v.n, v.n)
        return v

    tree_lib.map_with_path(leaf, out,
                           is_leaf=lambda v: isinstance(v, (P.ShardedPrepared, P.PreparedCrossbar)))
    assert stats == want_stats and stats["sharded"] > 0
    assert got == want


class _PlaceMesh:
    """A mesh of one axis as rank ``i`` of ``size`` sees it (no group)."""

    def __init__(self, i, size):
        self.shape, self.device, self._i = {"model": size}, torch.device("cpu"), i

    def index(self, axis):
        return self._i

    def group(self, axis):
        return f"group-{self._i}"


def test_place_serve_params_keeps_each_ranks_blocks():
    session = Deployment.program(get_arch("qwen3_1_7b").smoke, 0, backend="codes",
                                 device="cpu").serve()
    wrapped, _ = P.shard_prepared_for_serve(session.params, _PlaceMesh(0, 4))
    specs = P.serve_param_specs(wrapped)
    qkv = session.params["base"]["body"][0]["mixer"]["_qkv"]["w"]
    assert specs["base"]["body"][0]["mixer"]["_qkv"]["w"].local.g_pos == (None, None, "model")
    assert specs["base"]["body"][0]["mixer"]["_qkv"]["w"].local.lora_a == ()
    assert specs["base"]["embed"]["embedding"] == ()
    w = qkv.n // 4
    for i in range(4):
        placed = P.place_serve_params(wrapped, _PlaceMesh(i, 4))
        leaf = placed["base"]["body"][0]["mixer"]["_qkv"]["w"]
        assert isinstance(leaf, P.ShardedPrepared) and leaf.group == f"group-{i}"
        assert leaf.n_total == qkv.n and leaf.local.n == w
        for name in ("g_pos", "g_neg", "scale", "lora_b", "gamma"):
            t = getattr(leaf.local, name)
            assert t.is_contiguous() and torch.equal(t, getattr(qkv, name)[..., i * w:(i + 1) * w])
        assert leaf.local.lora_a is qkv.lora_a
        assert placed["base"]["embed"]["embedding"] is session.params["base"]["embed"]["embedding"]


def _series(seed, n=80):
    rng = np.random.default_rng(seed)
    t = 0.1 + 1e-3 * rng.standard_normal(n)
    t[rng.choice(n, 6, replace=False)] = rng.uniform(0.5, 2.0, 6)  # spikes
    t[-5:] = 1.5  # a throttled host at the end
    return t.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window,min_samples", [(64, 16), (16, 4)])
def test_straggler_detector_matches_reference(seed, window, min_samples):
    ours = tfault.StragglerDetector(window=window, min_samples=min_samples)
    ref = jfault.StragglerDetector(window=window, min_samples=min_samples)
    for step, t in enumerate(_series(seed)):
        a, b = ours.record(step, t), ref.record(step, t)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.step, a.step_time, a.median, a.mad, a.z, a.is_straggler) == (
                b.step, b.step_time, b.median, b.mad, b.z, b.is_straggler)
        for k, horizon in ((1, 4), (3, 8), (5, 16)):
            assert ours.persistent(k, horizon) == ref.persistent(k, horizon)
    assert [r.step for r in ours.reports] == [r.step for r in ref.reports]


@pytest.mark.parametrize("failed,latest,rows,cols", [
    (1, 7, 2, 4), (3, None, 16, 16), (0, 0, 1, 4), (15, 12, 16, 16)])
def test_elastic_plan_matches_reference(failed, latest, rows, cols):
    a = tfault.ElasticPlan.plan(failed, latest, rows=rows, cols=cols)
    b = jfault.ElasticPlan.plan(failed, latest, rows=rows, cols=cols)
    assert (a.failed_hosts, a.new_mesh_shape, a.restore_step, a.notes) == (
        b.failed_hosts, b.new_mesh_shape, b.restore_step, b.notes)


def test_elastic_plan_refuses_no_capacity_as_reference():
    for mod in (tfault, jfault):
        with pytest.raises(RuntimeError, match="capacity"):
            mod.ElasticPlan.plan(2, 0, rows=2, cols=4)


def test_preemption_guard_and_step_timer():
    for mod in (tfault, jfault):
        with mod.PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
            assert not guard.should_stop
            signal.raise_signal(signal.SIGUSR1)
            assert guard.should_stop
        with mod.StepTimer() as timer:
            pass
        assert timer.elapsed >= 0.0


def test_elastic_mesh_keeps_surviving_rows_in_rank_order():
    """A (2, 4) mesh loses its last row: the first row's ranks, in order;
    a (3, 2) mesh loses two. No capacity left raises as the reference."""
    base = mesh_lib.Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    degraded = mesh_lib.make_elastic_mesh(1, base_mesh=base)
    assert degraded.shape == {"data": 1, "model": 4}
    assert degraded.ranks.tolist() == [[0, 1, 2, 3]]
    assert degraded.member and degraded.coords == (0, 0)
    ragged = mesh_lib.Mesh(np.array([[4, 1], [0, 5], [3, 2]]), ("data", "model"))
    assert mesh_lib.make_elastic_mesh(2, base_mesh=ragged).ranks.tolist() == [[4, 1]]
    assert not mesh_lib.make_elastic_mesh(2, base_mesh=ragged).member  # rank 0 dropped
    with pytest.raises(ValueError, match="capacity"):
        mesh_lib.make_elastic_mesh(2, base_mesh=base)
    with pytest.raises(ValueError, match="data"):
        mesh_lib.make_elastic_mesh(1, base_mesh=mesh_lib.Mesh(np.arange(4), ("model",)))
    with pytest.raises(ValueError, match="capacity"):
        mesh_lib.make_elastic_mesh(16)


def test_mesh_axes_and_production_shape():
    mesh = mesh_lib.make_host_mesh((1, 1))
    assert mesh_lib.dp_axes(mesh) == ("data",) and mesh_lib.tp_axis(mesh) == "model"
    assert mesh.index("model") == 0 and mesh.axis_ranks("model") == (0,)
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_lib.make_production_mesh()
