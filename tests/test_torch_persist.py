"""Lifecycle persistence of the port (``repro_torch/checkpoint/``,
``Deployment.snapshot`` / ``Deployment.restore``) at smoke size on the
CPU, against the reference (``repro/checkpoint/manager.py``,
``repro/deploy/deployment.py``):

* the manager: a round trip over every leaf dtype (bf16 by its bits),
  JAX's flatten order and leaf names, the atomic rename, retention, the
  asynchronous save, and an in-place AdamW update right after an
  asynchronous save returns that does not reach the file;
* files across packages: the port's ``adapters``/``opt`` read bitwise by
  the reference's ``CheckpointManager.restore`` with the reference's
  trees as ``like``, and the reverse, with equal ``leaf_names``;
* a deployment programmed, drifted, calibrated, faulted and drifted again,
  snapshotted and restored bitwise (the twins of ``test_faults.py::
  test_snapshot_restore_replays_fault_events`` and ``test_deploy.py::
  test_snapshot_restore_reproduces_post_drift_post_calib_state``), the
  zero-hour replay and the backend override;
* the refusals: draws no seed replays (``from_arrays``, ``inject(draws=)``),
  a digest that differs, another device, a reference snapshot."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_arch as j_arch
from repro.deploy import Deployment as JDeployment
from repro.models import transformer as JT
from repro.optim.adam import AdamState as JAdamState
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager, as_manager
from repro_torch.checkpoint.manager import flatten_with_names
from repro_torch.configs import get_arch
from repro_torch.core.rram import CrossbarWeight
from repro_torch.deploy import Deployment, calibration_batch
from repro_torch.faults import default_spec
from repro_torch.faults.generators import leaf_draws, rram_leaves
from repro_torch.interop import from_reference
from repro_torch.models import transformer as T
from repro_torch.optim.adam import AdamState, AdamW, adamw_init, adamw_update_


def _cfg():
    return get_arch("qwen3_1_7b").smoke


def _equal(a, b):
    ta, tb = tree_lib.tensors(a), tree_lib.tensors(b)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(ta, tb))


def _opt_tensors(state):
    return [state.step] + tree_lib.tensors(state.mu) + tree_lib.tensors(state.nu)


def _mixed_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "z": [torch.randn((2, 3), generator=g), {"b": torch.arange(4, dtype=torch.int32)}],
        "a": {"u": torch.tensor([1, 2**32 - 1], dtype=torch.uint32),
              "i": torch.tensor(-5, dtype=torch.int64),
              "d": torch.tensor([0.1, 1e300], dtype=torch.float64),
              "h": torch.randn((3,), generator=g).to(torch.bfloat16)},
        "m": AdamState(step=torch.tensor(3, dtype=torch.int32),
                       mu={"y": torch.ones(2), "x": torch.zeros(1)},
                       nu={"y": torch.full((2,), 2.0), "x": torch.ones(1)}),
    }


def test_manager_round_trip_in_jax_order(tmp_path):
    tree = _mixed_tree()
    m = CheckpointManager(str(tmp_path))
    m.save(7, {"t": tree})
    names = m.leaf_names(7, "t")
    assert names == ["a/d", "a/h", "a/i", "a/u", "m/.step", "m/.mu/x", "m/.mu/y",
                     "m/.nu/x", "m/.nu/y", "z/0", "z/1/b"]
    with np.load(os.path.join(m.step_dir(7), "t.npz")) as data:
        assert data["a1"].dtype.str == "|V2"  # bf16 as the reference writes it
        assert data["a0"].dtype == np.float64 and data["a3"].dtype == np.uint32
    back = m.restore(7, {"t": tree}, device="cpu")["t"]
    assert _equal(back, tree) and isinstance(back["m"], AdamState)
    assert list(back) == list(tree)  # dicts keep their own order
    with pytest.raises(ValueError, match="holds leaves"):
        m.restore(7, {"t": {"other": torch.zeros(1)}}, device="cpu")
    with pytest.raises(ValueError, match="stored shape"):
        m.restore(7, {"t": tree_lib.map_tensors(lambda t: t.reshape(-1)[:1], tree)},
                  device="cpu")


def test_manager_commits_atomically_and_keeps_the_newest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "tmp.5")          # a crashed write of step 5
    (tmp_path / "tmp.5" / "junk").write_text("x")
    assert m.all_steps() == [] and m.latest_step() is None
    for step in (1, 5, 9):
        m.save(step, {"t": {"w": torch.full((2,), float(step))}})
    assert sorted(os.listdir(tmp_path)) == ["step_0000000005", "step_0000000009"]
    assert m.all_steps() == [5, 9] and m.latest_step() == 9
    got = m.restore(5, {"t": {"w": torch.zeros(2)}}, device="cpu")["t"]["w"]
    assert torch.equal(got, torch.full((2,), 5.0))
    assert as_manager(m) is m and as_manager(str(tmp_path)).directory == str(tmp_path)


def test_async_save_copies_before_it_returns(tmp_path):
    """``save(blocking=False)`` then an in-place ``adamw_update_`` (what the
    calibration graph replays) at once: the file holds the values at the
    call, and ``wait`` puts it on disk."""
    params = {"w": torch.ones(4), "v": torch.arange(3.0)}
    state = adamw_init(params)
    cfg = AdamW(lr=0.1)
    betas = tuple(torch.tensor(b) for b in (cfg.b1, cfg.b2))
    grads = {"w": torch.full((4,), 0.5), "v": torch.ones(3)}
    adamw_update_(grads, state, params, cfg, betas)
    want = [t.clone() for t in _opt_tensors(state)] + [t.clone() for t in params.values()]
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"opt": state, "params": params}, blocking=False)
    adamw_update_(grads, state, params, cfg, betas)  # writes every leaf in place
    m.wait()
    back = m.restore(1, {"opt": adamw_init(params), "params": params}, device="cpu")
    got = _opt_tensors(back["opt"]) + list(back["params"].values())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(back["params"]["w"], params["w"])


def test_async_writer_error_surfaces_at_wait(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"t": {"w": torch.ones(1)}}, blocking=False)
    m.wait()
    m.save(2, {"bad/name": {"w": torch.ones(1)}}, blocking=False)  # no such directory
    with pytest.raises(FileNotFoundError):
        m.wait()
    assert m.all_steps() == [1]


@pytest.fixture(scope="module")
def reference_trees():
    """The reference's adapter tree at smoke size with random values, an
    AdamState over it, and the port's copies of both."""
    cfg = j_arch("qwen3_1_7b").smoke
    adapters = JT.init_params(jax.random.PRNGKey(0), cfg)["adapters"]
    rng = np.random.default_rng(0)
    rand = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.asarray(x).dtype)), t)
    adapters = rand(adapters)
    opt = JAdamState(step=jnp.asarray(11, jnp.int32), mu=rand(adapters), nu=rand(adapters))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    port_adapters = from_reference(np_(adapters), "cpu")
    port_opt = AdamState(step=torch.tensor(11, dtype=torch.int32),
                         mu=from_reference(np_(opt.mu), "cpu"),
                         nu=from_reference(np_(opt.nu), "cpu"))
    return {"adapters": adapters, "opt": opt}, {"adapters": port_adapters, "opt": port_opt}


def _leaves_equal(ref_tree, port_tree):
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tree)]
    port = [x for _, x in flatten_with_names(port_tree)]
    return len(ref) == len(port) > 0 and all(
        a.dtype == np.dtype(str(b.dtype).removeprefix("torch.")) and
        np.array_equal(a, b.numpy()) for a, b in zip(ref, port))


def test_port_files_read_by_the_reference(tmp_path, reference_trees):
    ref, port = reference_trees
    CheckpointManager(str(tmp_path / "port")).save(3, port)
    JManager(str(tmp_path / "ref")).save(3, ref)
    back = JManager(str(tmp_path / "port")).restore(3, ref)
    for name in ("adapters", "opt"):
        assert _leaves_equal(back[name], port[name]), name
        names = [CheckpointManager(str(tmp_path / d)).leaf_names(3, name)
                 for d in ("port", "ref")]
        assert names[0] == names[1], name


def test_reference_files_read_by_the_port(tmp_path, reference_trees):
    ref, port = reference_trees
    JManager(str(tmp_path)).save(4, {**ref, "h": {"w": jnp.arange(5, dtype=jnp.bfloat16)}})
    like = {**tree_lib.map_tensors(torch.zeros_like, port),
            "h": {"w": torch.zeros(5, dtype=torch.bfloat16)}}
    like["opt"] = AdamState(torch.zeros((), dtype=torch.int32), like["opt"].mu, like["opt"].nu)
    back = CheckpointManager(str(tmp_path)).restore(4, like, device="cpu")
    for name in ("adapters", "opt"):
        assert _equal(back[name], port[name]), name
    # the reference's own restore fails at its astype on a bf16 leaf; the
    # port reads the leaf's bits
    assert torch.equal(back["h"]["w"], torch.arange(5, dtype=torch.bfloat16))


def test_port_adapter_tree_has_the_reference_leaf_names():
    cfg_t = _cfg()
    cfg_j = j_arch("qwen3_1_7b").smoke
    port = T.init_params(torch.Generator().manual_seed(0), cfg_t)["adapters"]
    ref = JT.init_params(jax.random.PRNGKey(0), cfg_j)["adapters"]
    names_ref = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [n for n, _ in flatten_with_names(port)] == names_ref
    assert [n for n, _ in flatten_with_names(adamw_init(port))][:2] == [".step", ".mu/" + names_ref[0]]


# -- Deployment.snapshot / restore ---------------------------------------------


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """program -> advance(24) -> calibrate 2 steps -> inject two classes ->
    advance(12), snapshotted."""
    cfg = _cfg()
    dep = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24.0)
    dep.calibrate(2, steps=2, seq_len=8)
    dep.inject([default_spec("stuck_at", 1), default_spec("retention", 11)])
    dep.advance(12.0)
    d = str(tmp_path_factory.mktemp("snap"))
    step = dep.snapshot(d)
    return cfg, dep, d, step


def test_snapshot_restore_is_bitwise(lifecycle):
    cfg, dep, d, step = lifecycle
    restored = Deployment.restore(cfg, d, device="cpu")
    assert restored.backend == "codes" and restored.step == step == 2
    assert restored.drift_hours == dep.drift_hours == [24.0, 12.0]
    assert [s.to_dict() for s in restored.fault_specs] == [
        s.to_dict() for s in dep.fault_specs]
    assert _equal(restored.codes, dep.codes)
    assert _equal(restored.codes_view, dep.codes_view)
    assert _equal(restored.adapters, dep.adapters)
    assert all(torch.equal(a, b) for a, b in zip(_opt_tensors(restored.opt_state),
                                                 _opt_tensors(dep.opt_state)))
    batch = calibration_batch(cfg, 2, 8)
    assert restored.logit_mse(batch) == dep.logit_mse(batch)
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (2, 4)))
    l1, _ = dep.serve().prefill(prompt, 6)
    l2, _ = restored.serve().prefill(prompt, 6)
    assert torch.equal(l1, l2)
    meta = json.load(open(os.path.join(d, "deployment.json")))
    assert {"format", "backend", "arch", "drift_events", "fault_events"} <= set(meta)
    assert (meta["device_type"], meta["device_name"], meta["drift_events"]) == ("cpu", "cpu", 2)
    assert CheckpointManager(d).leaf_names(step, "lifecycle") == [
        "drift_hours", "program_seed", "teacher_seed"]


def test_async_snapshot_restores_bitwise(tmp_path):
    cfg = _cfg()
    dep = Deployment.program(cfg, 3, backend="codes", device="cpu").advance(6.0)
    m = CheckpointManager(str(tmp_path))
    dep.snapshot(m, blocking=False)
    m.wait()
    restored = Deployment.restore(cfg, m, device="cpu")
    assert (restored.teacher_seed, restored.program_seed) == (3, 4)
    assert _equal(restored.codes, dep.codes) and _equal(restored.adapters, dep.adapters)


def test_restore_replays_zero_hour_events(tmp_path):
    """Twin of ``test_deploy.py::test_restore_replays_legacy_zero_hour_
    events``: a recorded 0.0 keeps its event index on replay."""
    cfg = _cfg()
    dep = Deployment.program(cfg, 0, backend="codes", device="cpu")
    dep.drift_hours.append(0.0)
    dep.advance(24.0)
    dep.snapshot(str(tmp_path))
    restored = Deployment.restore(cfg, str(tmp_path), device="cpu")
    assert restored.drift_hours == [0.0, 24.0]
    assert _equal(dep.codes, restored.codes)


def test_restore_backend_override(tmp_path):
    cfg = _cfg()
    dep = Deployment.program(cfg, 0, backend="dequant", device="cpu").advance(24.0)
    dep.snapshot(str(tmp_path))
    restored = Deployment.restore(cfg, str(tmp_path), backend="codes", device="cpu")
    assert restored.backend == "codes"
    assert _equal(dep.codes, restored.codes)


def _reference_layout(x):
    """A port tree as numpy in the reference's layout (``from_arrays``'s
    input); bf16 as ml_dtypes bf16, as ``np.asarray`` gives the reference's."""
    if isinstance(x, CrossbarWeight):
        return {"g_pos": x.g_pos.numpy(), "g_neg": x.g_neg.numpy(), "scale": x.scale.numpy()}
    if isinstance(x, dict):
        return {k: _reference_layout(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_reference_layout(v) for v in x]
    if x.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    return x.numpy()


def test_unreplayable_deployments_refuse_to_snapshot(tmp_path):
    cfg = _cfg()
    dep = Deployment.program(cfg, 0, backend="codes", device="cpu")
    adopted = Deployment.from_arrays(cfg, *(_reference_layout(t) for t in (
        dep.teacher_base, dep.codes, dep.adapters)), device="cpu")
    assert _equal(adopted.codes, dep.codes)
    with pytest.raises(ValueError, match="from_arrays"):
        adopted.snapshot(str(tmp_path / "a"))
    spec = default_spec("stuck_at", 1)
    draws = {p: leaf_draws(spec, p, tuple(x.g_pos.shape), "cpu")
             for p, x in rram_leaves(dep.codes)}
    given = Deployment.program(cfg, 0, backend="codes", device="cpu").inject(spec, draws=draws)
    with pytest.raises(ValueError, match=r"inject\(draws=...\)"):
        given.snapshot(str(tmp_path / "b"))
    own = Deployment.program(cfg, 0, backend="codes", device="cpu").inject(spec)
    assert _equal(own.codes_view, given.codes_view)  # the same draws, from the streams
    own.snapshot(str(tmp_path / "c"))


def _tamper(d, **fields):
    path = os.path.join(d, "deployment.json")
    meta = json.load(open(path))
    meta.update(fields)
    json.dump(meta, open(path, "w"))


def test_restore_refuses_a_digest_mismatch(tmp_path):
    cfg = _cfg()
    dep = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24.0)
    dep.inject(default_spec("retention", 2))
    for key in ("codes_digest", "view_digest"):
        d = str(tmp_path / key)
        dep.snapshot(d)
        meta = json.load(open(os.path.join(d, "deployment.json")))
        flipped = ("0" if meta[key][0] != "0" else "1") + meta[key][1:]
        _tamper(d, **{key: flipped})
        with pytest.raises(ValueError, match="differ from the snapshot"):
            Deployment.restore(cfg, d, device="cpu")
    d = str(tmp_path / "events")
    dep.snapshot(d)
    _tamper(d, fault_events=[])  # the view then lacks the retention cells
    with pytest.raises(ValueError, match="codes_view differ"):
        Deployment.restore(cfg, d, device="cpu")


def test_restore_refuses_another_device(tmp_path):
    cfg = _cfg()
    Deployment.program(cfg, 0, backend="codes", device="cpu").snapshot(str(tmp_path))
    _tamper(str(tmp_path), device_type="cuda", device_name="NVIDIA H100 80GB HBM3")
    with pytest.raises(ValueError, match="do not replay bitwise on cpu"):
        Deployment.restore(cfg, str(tmp_path), device="cpu")


def test_restore_refuses_a_reference_snapshot(tmp_path):
    cfg_j = j_arch("qwen3_1_7b").smoke
    JDeployment.program(cfg_j, 0, backend="codes").snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="written by the reference"):
        Deployment.restore(_cfg(), str(tmp_path), device="cpu")
