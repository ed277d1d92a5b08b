"""Port parity: calibration with autograd (``repro_torch.optim.adam``,
``core/calibrate.py``'s calibration half, the feature-KD loss and
``Deployment.calibrate`` / ``logit_mse``) against ``repro`` on the same
numpy inputs, at the smoke config.

Tolerances, each relative where it says so:

* ``ADAM_TOL`` (rtol = atol = 1e-6): AdamW on identical f32 inputs; the
  two frameworks order nothing differently but may fuse ``b*m + c*g``.
* ``F32_RTOL`` / ``F32_ATOL`` (1e-4 / 1e-5): the float32 config — losses,
  logit MSEs and gradients. Only f32 summation orders differ.
* ``F32_ADAPTER_ATOL`` (5e-5, a twentieth of the default ``lr``): the f32
  adapters after 5 + 2 Adam steps (the reference's 7 in one call). Adam divides by ``sqrt(v)``, so an
  element whose gradient is a near-cancelling sum moves by a share of
  ``lr`` that rounding sets; measured up to 2.1e-5.
* ``BF16_LOSS_RTOL`` (1e-2): the bf16 config as shipped, per-step losses
  and logit MSEs (measured up to 1.2e-3). bf16 rounds at different places
  in the two frameworks, and near zero that flips a gradient's sign, so
  an adapter element may end up to ``2 * lr`` a step away: the adapters
  are held in f32 only.
* ``BF16_FEATURE_BOUND`` (``test_torch_model.BF16_BOUND``, of the absmax):
  bf16 teacher features, as the model test holds bf16 logits.

``column_norm`` floors ``||W + AB||^2`` with ``clamp_min`` where the
reference takes ``jnp.maximum``; their gradients differ only at the
floor (1e-6), which no column here comes near.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import substrate as jsub
from repro.configs import get_arch as j_arch
from repro.core import calibrate as jcal
from repro.core import dora as jdora
from repro.core import rram as jr
from repro.deploy import Deployment as JDeployment
from repro.deploy.deployment import calibration_batch as j_calibration_batch
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro_torch import substrate as tsub
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.core import dora as tdora
from repro_torch.data import pipeline as tdata
from repro_torch.deploy import CalibrationReport, Deployment, calibration_batch
from repro_torch.interop import from_reference
from repro_torch.models import transformer as TT
from repro_torch.optim import adam as tadam

from test_torch_model import BF16_BOUND, np_tree, random_lora_b

ADAM_TOL = 1e-6
F32_RTOL, F32_ATOL = 1e-4, 1e-5
F32_ADAPTER_ATOL = 5e-5
BF16_LOSS_RTOL = 1e-2
BF16_FEATURE_BOUND = BF16_BOUND
STEPS, MORE_STEPS = 5, 2          # a calibrate call, then one that continues it
N_SAMPLES, SEQ = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cfg_pair(dtype="float32", unroll=False):
    cfg_j = dataclasses.replace(j_arch("qwen3_1_7b").smoke, unroll=unroll)
    cfg_t = dataclasses.replace(t_arch("qwen3_1_7b").smoke, unroll=unroll)
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, dtype=torch.float32)
    return cfg_j, cfg_t


def port_np(tree):
    """Port tree -> numpy tree (f32 for floats)."""
    if isinstance(tree, dict):
        return {k: port_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [port_np(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def assert_trees_close(want, got, rtol, atol, path=""):
    """``want`` a numpy tree (reference), ``got`` a numpy tree (port)."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            assert_trees_close(want[k], got[k], rtol, atol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_trees_close(w, g, rtol, atol, f"{path}/{i}")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=atol, err_msg=path)


def to_port_batch(batch_j):
    return {"tokens": torch.from_numpy(np.array(batch_j["tokens"])).long()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adam_tree(rng):
    return {"a": {"lora_a": rng.standard_normal((6, 3)).astype(np.float32),
                  "lora_b": rng.standard_normal((3, 5)).astype(np.float32)},
            "body": [rng.standard_normal((2, 4)).astype(np.float32)]}


@pytest.mark.parametrize("grad_clip", [None, 1.0, 50.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_reference(grad_clip, weight_decay):
    """Several steps of AdamW from the same params and gradients: clipping
    off, binding (norm ~10 > 1) and not binding (> norm), weight decay on
    and off; params, both moments and the global norm."""
    rng = np.random.default_rng(0)
    params = _adam_tree(rng)
    cfg_j = jadam.AdamW(lr=1e-2, weight_decay=weight_decay, grad_clip=grad_clip)
    cfg_t = tadam.AdamW(lr=1e-2, weight_decay=weight_decay, grad_clip=grad_clip)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = from_reference(params, "cpu")
    sj, st = jadam.adamw_init(pj), tadam.adamw_init(pt)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for step in range(4):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 3).astype(np.float32), params)
        np.testing.assert_allclose(
            float(tadam.global_norm(from_reference(grads, "cpu"))),
            float(jadam.global_norm(jax.tree_util.tree_map(jnp.asarray, grads))),
            rtol=ADAM_TOL)
        pj, sj = jadam.adamw_update(jax.tree_util.tree_map(jnp.asarray, grads), sj, pj, cfg_j)
        pt, st = tadam.adamw_update(from_reference(grads, "cpu"), st, pt, cfg_t)
        assert int(st.step) == int(sj.step) == step + 1
        for want, got in ((pj, pt), (sj.mu, st.mu), (sj.nu, st.nu)):
            assert_trees_close(np_tree(want), port_np(got), ADAM_TOL, ADAM_TOL)


def test_adamw_keeps_param_dtype_and_f32_state():
    p = {"w": torch.ones((3, 2), dtype=torch.bfloat16, requires_grad=True)}
    st = tadam.adamw_init(p)
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.float32
    new, st = tadam.adamw_update({"w": torch.full((3, 2), 0.5)}, st, p, tadam.AdamW())
    assert new["w"].dtype == torch.bfloat16 and not new["w"].requires_grad
    assert torch.equal(p["w"].detach(), torch.ones((3, 2), dtype=torch.bfloat16))
    assert float(tadam.global_norm({})) == 0.0


# ---------------------------------------------------------------------------
# calibration data
# ---------------------------------------------------------------------------


def test_calibration_batch_is_deterministic_and_in_range():
    cfg = t_arch("qwen3_1_7b").smoke
    a = calibration_batch(cfg, 10, 32)
    b = calibration_batch(cfg, 10, 32)
    assert set(a) == {"tokens"} and a["tokens"].shape == (10, 32)
    assert a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab
    assert len({tuple(r.tolist()) for r in a["tokens"]}) == 10
    given = {"tokens": torch.zeros((2, 3), dtype=torch.int64)}
    assert calibration_batch(cfg, given, 32) is given


def test_batches_cycle_and_samples_keep_their_tokens():
    """Row ``i`` of step ``s`` is sample ``(s*B + i) % n``: rows past the
    calibration set repeat it, and a sample has the same tokens in every
    batch it lands in."""
    dcfg = tdata.DataConfig(vocab=97, seq_len=7, global_batch=5, n_calibration_samples=3)
    s0 = tdata.global_batch_at_step(dcfg, 0)["tokens"]
    s1 = tdata.global_batch_at_step(dcfg, 1)["tokens"]
    assert torch.equal(s0[3:], s0[:2])
    assert torch.equal(s1, s0[[2, 0, 1, 2, 0]])
    other = tdata.global_batch_at_step(dataclasses.replace(dcfg, seed=1), 0)["tokens"]
    assert not torch.equal(other, s0)
    unlimited = tdata.global_batch_at_step(
        dataclasses.replace(dcfg, n_calibration_samples=0), 0)["tokens"]
    assert torch.equal(unlimited[:3], s0[:3]) and len({tuple(r.tolist()) for r in unlimited}) == 5


# ---------------------------------------------------------------------------
# teacher features, the losses and their gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_program(dtype, unroll=False):
    """The reference's teacher params and codes from keys (0, 1): what
    ``JDeployment.program(cfg, 0)`` makes, built once per config."""
    cfg_j, cfg_t = cfg_pair(dtype, unroll)
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jcal.program_model(params["base"], cfg_j.rram, jax.random.PRNGKey(1),
                               mode="codes")
    return cfg_j, cfg_t, params, codes


def _model_pair(dtype):
    """Teacher, codes and random-B adapters from the reference, carried
    across; the batch is the reference's."""
    cfg_j, cfg_t, params, codes = _reference_program(dtype)
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=3)
    batch_j = j_calibration_batch(cfg_j, N_SAMPLES, SEQ)
    ref = (cfg_j, params["base"], codes, jax.tree_util.tree_map(jnp.asarray, adapters_np),
           batch_j)
    port = (cfg_t, from_reference(np_tree(params["base"]), "cpu"),
            from_reference(np_tree(codes), "cpu"), from_reference(adapters_np, "cpu"),
            to_port_batch(batch_j))
    return ref, port


@pytest.fixture(scope="module")
def f32_model():
    return _model_pair("float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_features_match_reference(dtype, f32_model):
    ref, port = f32_model if dtype == "float32" else _model_pair(dtype)
    cfg_j, tbase_j, _, _, batch_j = ref
    cfg_t, tbase_t, _, _, batch_t = port
    want = np.asarray(jcal.teacher_features(tbase_j, batch_j, cfg_j)["dec"], np.float32)
    got = tcal.teacher_features(tbase_t, batch_t, cfg_t)
    assert set(got) == {"dec"}  # tied head: no head_in / head_out
    assert got["dec"].dtype == cfg_t.dtype and not got["dec"].requires_grad
    assert got["dec"].shape == want.shape == (cfg_t.n_layers + 1, N_SAMPLES, SEQ, cfg_t.d_model)
    err = np.abs(got["dec"].float().numpy() - want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got["dec"].numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        assert err <= BF16_FEATURE_BOUND * np.abs(want).max(), err


def test_cached_loss_and_gradients_match_jax_grad(f32_model):
    """``make_cached_calib_loss`` value and its gradient w.r.t. every
    adapter leaf (lora_a, lora_b, dora_m; stacked body leaves included)
    against ``jax.value_and_grad``, under ``dequant`` over the codes."""
    (cfg_j, tbase_j, codes_j, ad_j, batch_j), (cfg_t, tbase_t, codes_t, ad_t, batch_t) = f32_model
    with jsub.use_backend("dequant"):
        feats_j = jcal.teacher_features(tbase_j, batch_j, cfg_j)
        loss_j, grads_j = jax.jit(jax.value_and_grad(jcal.make_cached_calib_loss(cfg_j)))(
            ad_j, codes_j, feats_j, batch_j)
    with tsub.use_backend("dequant"):
        feats_t = tcal.teacher_features(tbase_t, batch_t, cfg_t)
        loss_fn = tcal.make_cached_calib_loss(cfg_t)
        loss_t, grads_t = tcal.value_and_grad(
            lambda ad: loss_fn(ad, codes_t, feats_t, batch_t), ad_t)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=F32_RTOL)
    assert_trees_close(np_tree(grads_j), port_np(grads_t), F32_RTOL, F32_ATOL)
    assert not any(t.requires_grad for t in tree_lib.tensors(ad_t))


def test_feature_loss_matches_reference_and_cached_equals_fused(f32_model):
    """The fused loss against the reference's, and, inside the port, the
    cached loss equal to the fused one (the same ops on the same inputs),
    with the same gradients."""
    (cfg_j, tbase_j, codes_j, ad_j, batch_j), (cfg_t, tbase_t, codes_t, ad_t, batch_t) = f32_model
    with jsub.use_backend("dequant"):
        want, _ = jax.jit(JT.feature_calibration_loss, static_argnums=4)(
            tbase_j, codes_j, ad_j, batch_j, cfg_j)
    with tsub.use_backend("dequant"):
        fused, grads_f = tcal.value_and_grad(
            lambda ad: TT.feature_calibration_loss(tbase_t, codes_t, ad, batch_t, cfg_t)[0],
            ad_t)
        feats = tcal.teacher_features(tbase_t, batch_t, cfg_t)
        loss_fn = tcal.make_cached_calib_loss(cfg_t)
        cached, grads_c = tcal.value_and_grad(
            lambda ad: loss_fn(ad, codes_t, feats, batch_t), ad_t)
    np.testing.assert_allclose(float(fused), float(want), rtol=F32_RTOL)
    assert float(cached) == float(fused)
    assert_trees_close(port_np(grads_f), port_np(grads_c), 0, 0)


def test_untied_head_adds_a_logits_term():
    """An untied lm_head lives in RRAM: teacher_features keeps its input
    and logits, and both losses add the logits' MSE as one more term of
    the mean, the same divisor in the cached and the fused loss."""
    cfg = dataclasses.replace(t_arch("qwen3_1_7b").smoke, tie_lm_head=False,
                              dtype=torch.float32)
    dep = Deployment.program(cfg, 0, backend="dequant", device="cpu").advance(24)
    batch = {"tokens": torch.arange(24).reshape(2, 12)}
    feats = tcal.teacher_features(dep.teacher_base, batch, cfg)
    assert feats["head_out"].shape == (2, 12, cfg.vocab)
    loss_fn = tcal.make_cached_calib_loss(cfg)
    with torch.no_grad():
        cached = loss_fn(dep.adapters, dep.base, feats, batch)
        fused, _ = TT.feature_calibration_loss(dep.teacher_base, dep.base, dep.adapters,
                                               batch, cfg)
        head = TT._mse(feats["head_out"], TT.L.linear(
            feats["head_in"], dep.base["lm_head"], dep.adapters["lm_head"], cfg.adapter))
        blocks = sum(
            TT._mse(feats["dec"][i + 1], TT.block_forward(
                feats["dec"][i], b, a_, cfg, *kind,
                positions=torch.arange(12)[None]))
            for i, b, a_, kind in TT._layers(dep.base, dep.adapters, cfg))
    assert float(head) > 0
    assert float(cached) == float(fused)
    np.testing.assert_allclose(float(cached), float((blocks + head) / (cfg.n_layers + 1)),
                               rtol=1e-6)


def test_calibrate_layer_matches_reference():
    """Algorithm 1 on one drifted linear: per-epoch losses and the trained
    adapter against the reference's, from the same drifted weight, adapter
    and features."""
    rng = np.random.default_rng(0)
    d, k, n = 32, 16, 10
    w_t = (rng.standard_normal((d, k)) * 0.3).astype(np.float32)
    w_r = np.asarray(jr.drifted_weights(jnp.asarray(w_t), jr.RramConfig(relative_drift=0.2),
                                        jax.random.PRNGKey(1), jnp.float32))
    acfg_j = jdora.AdapterConfig(rank=4, kind="dora")
    acfg_t = tdora.AdapterConfig(rank=4, kind="dora")
    adapter = np_tree(jdora.init_adapter(jax.random.PRNGKey(2), d, k, acfg_j,
                                         w_base=jnp.asarray(w_r)))
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = x @ w_t
    kw = dict(max_epochs=40, batch_size=4)
    ad_j, res_j = jcal.calibrate_layer(
        lambda b, a, xx: jdora.adapted_forward(xx, b, a, acfg_j), jnp.asarray(w_r),
        jax.tree_util.tree_map(jnp.asarray, adapter), jnp.asarray(x), jnp.asarray(y),
        opt=jadam.AdamW(lr=1e-2), **kw)
    ad_t, res_t = tcal.calibrate_layer(
        lambda b, a, xx: tdora.adapted_forward(xx, b, a, acfg_t), torch.from_numpy(w_r),
        from_reference(adapter, "cpu"), torch.from_numpy(x), torch.from_numpy(y),
        opt=tadam.AdamW(lr=1e-2), **kw)
    assert res_t.epochs_run == res_j.epochs_run == 40
    assert res_t.losses[-1] < 0.5 * res_t.losses[0]
    np.testing.assert_allclose(res_t.losses, res_j.losses, rtol=F32_RTOL)
    assert_trees_close(np_tree(ad_j), port_np(ad_t), F32_RTOL, F32_ATOL)
    _, early = tcal.calibrate_layer(
        lambda b, a, xx: tdora.adapted_forward(xx, b, a, acfg_t), torch.from_numpy(w_r),
        from_reference(adapter, "cpu"), torch.from_numpy(x), torch.from_numpy(y),
        opt=tadam.AdamW(lr=1e-2), loss_threshold=res_t.losses[2], **kw)
    assert early.epochs_run <= 3


# ---------------------------------------------------------------------------
# Deployment.calibrate against the reference
# ---------------------------------------------------------------------------

# (backend, unroll, dtype): both backends, both layouts, both dtypes
CASES = [("codes", False, "float32"), ("dequant", True, "float32"),
         ("codes", False, "bfloat16")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(map(str, c)) for c in CASES])
def calibrated(request):
    """A reference deployment programmed and drifted 24 h, carried across
    before calibration. The reference then calibrates ``STEPS +
    MORE_STEPS`` steps in one call; the port in two calls, the second
    continuing the first's optimizer state, so its trajectory must be the
    reference's uninterrupted one."""
    backend, unroll, dtype = request.param
    cfg_j, cfg_t, params, codes = _reference_program(dtype, unroll)
    dep_j = JDeployment(cfg_j, backend, params["base"], codes, params["adapters"],
                        jax.random.PRNGKey(0), jax.random.PRNGKey(1)).advance(24)
    batch_j = j_calibration_batch(cfg_j, N_SAMPLES, SEQ)
    dep_t = Deployment.from_arrays(
        cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes), np_tree(dep_j.adapters),
        backend=backend, drift_hours=dep_j.drift_hours, device="cpu")
    batch_t = to_port_batch(batch_j)
    codes_before = [t.clone() for t in tree_lib.tensors(dep_t.codes)]
    return {"case": request.param, "dep_j": dep_j, "dep_t": dep_t, "batch_j": batch_j,
            "batch_t": batch_t, "codes_before": codes_before,
            "ref": dep_j.calibrate(batch_j, steps=STEPS + MORE_STEPS),
            "first": dep_t.calibrate(batch_t, steps=STEPS),
            "second": dep_t.calibrate(batch_t, steps=MORE_STEPS)}


def test_calibrate_matches_reference(calibrated):
    """Per-step losses over both calls (both dtypes) and the trained
    adapters (f32)."""
    rj, first, second = calibrated["ref"], calibrated["first"], calibrated["second"]
    f32 = calibrated["case"][2] == "float32"
    losses = first.losses + second.losses
    assert len(losses) == first.epochs_run + second.epochs_run == len(rj.losses)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, rj.losses, rtol=F32_RTOL if f32 else BF16_LOSS_RTOL)
    assert first.final_loss < first.initial_loss
    if f32:
        assert_trees_close(np_tree(calibrated["dep_j"].adapters),
                           port_np(calibrated["dep_t"].adapters), F32_RTOL, F32_ADAPTER_ATOL)


def test_second_call_continues_the_optimizer(calibrated):
    dep_j, dep_t = calibrated["dep_j"], calibrated["dep_t"]
    assert dep_t.step == int(dep_j.step) == STEPS + MORE_STEPS
    assert int(dep_t.opt_state.step) == STEPS + MORE_STEPS
    assert calibrated["second"].initial_loss < calibrated["first"].final_loss


def test_report_fields_match_reference_and_round_trip(calibrated):
    rj, rt = calibrated["ref"], calibrated["first"]
    for field in ("sram_bytes", "rram_bytes", "base_params", "adapter_params",
                  "backend", "drift_events", "warm_started", "warm_source"):
        assert getattr(rt, field) == getattr(rj, field), field
    assert rt.epochs_run == STEPS and rj.epochs_run == STEPS + MORE_STEPS
    assert rt.calibrated_fraction == pytest.approx(rj.calibrated_fraction, rel=1e-12)
    assert rt.initial_loss == rt.losses[0] and rt.final_loss == rt.losses[-1]
    back = CalibrationReport.from_json(rt.to_json())
    assert back == rt and back.to_json() == rt.to_json()
    assert set(rt.to_dict()) == set(rj.to_dict())
    assert "feature MSE" in rt.summary()


def test_calibrate_leaves_codes_and_grad_free_adapters(calibrated):
    dep_t = calibrated["dep_t"]
    after = tree_lib.tensors(dep_t.codes)
    assert len(after) == len(calibrated["codes_before"])
    assert all(torch.equal(a, b) for a, b in zip(after, calibrated["codes_before"]))
    assert not any(t.requires_grad or t.grad_fn is not None
                   for t in tree_lib.tensors(dep_t.adapters))
    assert tsub.active_backend_name() == tsub.DEFAULT_BACKEND


def test_logit_mse_matches_reference(calibrated):
    """With and without the side-cars, under the deployment's backend."""
    dep_j, dep_t = calibrated["dep_j"], calibrated["dep_t"]
    batch_j, batch_t = calibrated["batch_j"], calibrated["batch_t"]
    rtol = F32_RTOL if calibrated["case"][2] == "float32" else BF16_LOSS_RTOL
    for use in (False, True):
        want = dep_j.logit_mse(batch_j, use_adapters=use)
        got = dep_t.logit_mse(batch_t, use_adapters=use)
        np.testing.assert_allclose(got, want, rtol=rtol)
    assert dep_t.logit_mse(batch_t) < dep_t.logit_mse(batch_t, use_adapters=False)


def test_fused_teacher_calibrate_follows_the_cached_one():
    """``cached_teacher=False`` steps the fused loss: the same trajectory as
    the cached one inside the port."""
    cfg = dataclasses.replace(t_arch("qwen3_1_7b").smoke, dtype=torch.float32)
    runs = []
    for cached in (True, False):
        dep = Deployment.program(cfg, 1, backend="codes", device="cpu").advance(24)
        runs.append(dep.calibrate(3, steps=3, seq_len=8, cached_teacher=cached).losses)
    assert runs[0] == runs[1]


def test_loss_threshold_stops_early_and_reset_restores_init():
    cfg = t_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 2, backend="dequant", device="cpu").advance(24)
    fresh = port_np(dep.adapters)
    full = dep.calibrate(2, steps=4, seq_len=8)
    dep.reset_adapters()
    assert dep.opt_state is None and dep.step == 0
    assert_trees_close(fresh, port_np(dep.adapters), 0, 0)
    short = dep.calibrate(2, steps=4, seq_len=8, loss_threshold=full.losses[1])
    assert short.epochs_run == 2 and short.losses == full.losses[:2]
    state = dep.calib_state()
    assert state.step == 2 and state.student_base is dep.base
    dep.adopt(tcal.CalibState(state.teacher_base, state.student_base, state.adapters,
                              state.opt_state, 7))
    assert dep.step == 7


def test_quickstart_twin_runs_on_cpu(capsys):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "of the drift gap recovered" in out and "one week later, recalibrated" in out
