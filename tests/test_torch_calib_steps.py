"""The compiled calibration step on the CPU (``optim/adam.py::adamw_update_``,
``core/calibrate.py::CompiledCalibStep``, ``Deployment.calibrate``) at
smoke size, held bitwise against the port's own functional steps, which
``tests/test_torch_calibrate.py`` holds against the reference:

* ``adamw_update_`` writes exactly what ``adamw_update`` returns, into the
  same tensors, with its step count on the tensors' device;
* ``CompiledCalibStep`` gives ``make_cached_calib_step``'s and
  ``make_calib_step``'s losses, adapters and AdamW state over several
  steps, stacked and unrolled layouts, and refuses inputs that moved or a
  backend that changed (a CUDA graph would read stale operands);
* ``Deployment.calibrate`` leaves adapters that require no grad and share
  no storage with the step's static leaves, continues its optimizer
  across calls (two calls bitwise one longer call), and a stop at step 1
  calls the step once: on the card the capture comes with the second call.

On the CPU the step runs eagerly on every call; the graph is held on the
card by ``tests/test_torch_gpu.py``."""
import dataclasses

import pytest
import torch

from repro_torch import substrate
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch
from repro_torch.core import calibrate as C
from repro_torch.deploy import Deployment, calibration_batch
from repro_torch.deploy import deployment as D
from repro_torch.optim import adam as A

STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_trees_equal(want, got):
    w, g = tree_lib.tensors(want), tree_lib.tensors(got)
    assert len(w) == len(g) > 0
    for a, b in zip(w, g):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# adamw_update_
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_clip", [None, 1.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_in_place_adamw_is_bitwise_the_functional_one(dtype, grad_clip, weight_decay):
    """Five steps from the same params and gradients (norm ~10: clipping
    binds), params in ``dtype``, state f32: the in-place update writes
    what ``adamw_update`` returns, into the tensors it was given."""
    g = torch.Generator().manual_seed(0)

    def tree(scale=1.0):
        return {"a": {"lora_a": torch.randn(6, 3, generator=g) * scale,
                      "lora_b": torch.randn(3, 5, generator=g) * scale},
                "body": [torch.randn(2, 2, 4, generator=g) * scale]}

    cfg = A.AdamW(lr=1e-2, weight_decay=weight_decay, grad_clip=grad_clip)
    params = tree_lib.map_tensors(lambda t: t.to(dtype), tree())
    want_p, want_s = params, A.adamw_init(params)
    got_p = tree_lib.map_tensors(torch.clone, params)
    got_s = A.adamw_init(got_p)
    ptrs = [t.data_ptr() for t in tree_lib.tensors([got_p, *got_s])]
    betas = A.adam_betas(cfg, got_s.step.device)
    for _ in range(STEPS):
        grads = tree_lib.map_tensors(lambda t: t.to(dtype), tree(scale=3.0))
        want_p, want_s = A.adamw_update(grads, want_s, want_p, cfg)
        A.adamw_update_(grads, got_s, got_p, cfg, betas)
    assert [t.data_ptr() for t in tree_lib.tensors([got_p, *got_s])] == ptrs
    assert got_s.step.dtype == torch.int32 and int(got_s.step) == STEPS
    assert tree_lib.tensors(got_p)[0].dtype == dtype
    assert all(t.dtype == torch.float32 for t in tree_lib.tensors([got_s.mu, got_s.nu]))
    assert_trees_equal(want_p, got_p)
    assert_trees_equal([want_s.step, want_s.mu, want_s.nu], [got_s.step, got_s.mu, got_s.nu])


# ---------------------------------------------------------------------------
# CompiledCalibStep
# ---------------------------------------------------------------------------


def _setup(unroll=False, seed=0):
    """A smoke deployment (codes, 24 h of drift) and its device batch."""
    cfg = dataclasses.replace(get_arch("qwen3_1_7b").smoke, unroll=unroll)
    dep = Deployment.program(cfg, seed, backend="codes", device="cpu").advance(24)
    batch = D._device_batch(calibration_batch(cfg, 4, 16), dep.device)
    return cfg, dep, batch


@pytest.mark.parametrize("unroll", [False, True], ids=["stacked", "unroll"])
@pytest.mark.parametrize("cached", [True, False], ids=["cached", "fused"])
def test_compiled_step_is_bitwise_the_step_functions(cached, unroll):
    cfg, dep, batch = _setup(unroll)
    opt = A.AdamW(lr=1e-3)
    start = dep.calib_state()
    before = tree_lib.map_tensors(torch.clone, [start.adapters, *start.opt_state])
    with substrate.use_backend("dequant"):
        feats = C.teacher_features(dep.teacher_base, batch, cfg) if cached else None
        if cached:
            eager = C.make_cached_calib_step(cfg, opt)
            run = lambda s: eager(s, feats, batch)  # noqa: E731
        else:
            eager = C.make_calib_step(cfg, opt)
            run = lambda s: eager(s, batch)  # noqa: E731
        step = C.CompiledCalibStep(cfg, opt, start, batch, feats)
        assert set(step.metrics) == ({"loss"} if cached else {"feature_mse", "loss"})
        state, want, got = start, [], []
        for _ in range(STEPS):
            state, metrics = run(state)
            want.append({k: float(v) for k, v in metrics.items()})
            got.append({k: float(v) for k, v in step().items()})
    assert got == want and want[-1]["loss"] < want[0]["loss"]
    assert step.calls == STEPS and step.graph is None and step.stream is None
    out = step.state()
    assert out.step == state.step == STEPS
    assert_trees_equal(state.adapters, out.adapters)
    assert_trees_equal([*state.opt_state], [*out.opt_state])
    assert int(out.opt_state.step) == STEPS
    # the caller's state was read, never written
    assert_trees_equal(before, [start.adapters, *start.opt_state])
    assert all(l.requires_grad for l in step.leaves)
    assert not any(t.requires_grad for t in tree_lib.tensors(out.adapters))


@pytest.mark.parametrize("moved", ["batch", "student_base", "feats"])
def test_compiled_step_refuses_inputs_that_moved(moved):
    cfg, dep, batch = _setup()
    with substrate.use_backend("dequant"):
        feats = C.teacher_features(dep.teacher_base, batch, cfg)
        step = C.CompiledCalibStep(cfg, A.AdamW(), dep.calib_state(), batch, feats)
        step()
        if moved == "batch":
            batch["tokens"] = batch["tokens"].clone()
        elif moved == "feats":
            feats["dec"] = feats["dec"].clone()
        else:
            body = step.student_base["final_norm"]
            body["scale"] = body["scale"].clone()
        with pytest.raises(RuntimeError, match="moved"):
            step()
    assert step.calls == 1


def test_compiled_step_refuses_another_backend():
    cfg, dep, batch = _setup()
    with substrate.use_backend("dequant"):
        step = C.CompiledCalibStep(cfg, A.AdamW(), dep.calib_state(), batch)
        step()
    with substrate.use_backend("codes"):
        with pytest.raises(RuntimeError, match="built under"):
            step()
    assert step.calls == 1


# ---------------------------------------------------------------------------
# Deployment.calibrate through the compiled step
# ---------------------------------------------------------------------------


@pytest.fixture
def steps_built(monkeypatch):
    """Every ``CompiledCalibStep`` that ``Deployment.calibrate`` builds."""
    built = []

    class Recorded(C.CompiledCalibStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(D, "CompiledCalibStep", Recorded)
    return built


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_lib.tensors(tree)}


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "fused"])
def test_calibrate_adopts_copies_free_of_grad(cached, steps_built):
    cfg, dep, batch = _setup()
    report = dep.calibrate(batch, steps=3, cached_teacher=cached)
    (step,) = steps_built
    assert report.epochs_run == step.calls == 3 and step.graph is None
    assert not any(t.requires_grad or t.grad_fn is not None
                   for t in tree_lib.tensors(dep.adapters))
    assert not _storages(dep.adapters) & _storages(step.leaves)
    assert not _storages([*dep.opt_state]) & _storages([*step.opt_state])
    assert_trees_equal(step.adapters, dep.adapters)
    assert dep.step == 3 and int(dep.opt_state.step) == 3


def test_two_calls_are_bitwise_one_longer_call(steps_built):
    """The optimizer continues across calls: 3 + 2 steps in two calls give
    the losses, adapters and AdamW state of 5 steps in one."""
    cfg, dep, batch = _setup()
    _, once, _ = _setup()
    first = dep.calibrate(batch, steps=3)
    second = dep.calibrate(batch, steps=2)
    whole = once.calibrate(batch, steps=5)
    assert len(steps_built) == 3
    assert first.losses + second.losses == whole.losses
    assert dep.step == once.step == 5
    assert_trees_equal(once.adapters, dep.adapters)
    assert_trees_equal([*once.opt_state], [*dep.opt_state])


def test_stop_at_step_one_calls_the_step_once(steps_built):
    """A loss threshold met by the first step ends the call after one step:
    the eager first step alone, so on the card nothing is captured."""
    cfg, dep, batch = _setup()
    report = dep.calibrate(batch, steps=4, loss_threshold=1e9)
    (step,) = steps_built
    assert report.epochs_run == step.calls == 1 and step.graph is None
    assert dep.step == 1 and int(dep.opt_state.step) == 1
