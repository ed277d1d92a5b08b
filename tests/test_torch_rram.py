"""Port parity: RRAM programming and drift (``repro_torch.core.rram``)
against ``repro.core.rram``. Integer results are held bitwise: the codes
and scales of ``program``, and ``apply_drift`` given the reference's own
normal draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rram as jr
from repro_torch.configs import get_arch
from repro_torch.core import rram as tr
from repro_torch.deploy import Deployment


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _codes_equal(xj, xt):
    np.testing.assert_array_equal(np.asarray(xj.g_pos), xt.g_pos.numpy())
    np.testing.assert_array_equal(np.asarray(xj.g_neg), xt.g_neg.numpy())
    np.testing.assert_array_equal(np.asarray(xj.scale), xt.scale.numpy())


@pytest.mark.parametrize("shape,dtype", [
    ((37, 29), np.float32), ((3, 64, 48), np.float32), ((96, 40), "bfloat16"),
])
def test_program_bitwise(shape, dtype):
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[0, 0] = 0.0  # exact-zero weight -> both codes 0
    wj = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    wt = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    _codes_equal(jr.program(wj, jr.RramConfig()), tr.program(wt, tr.RramConfig()))


def test_program_noise_bitwise_given_reference_normals():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    cj = jr.RramConfig(programming_sigma=0.02)
    key = jax.random.PRNGKey(5)
    kp, kn = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, w.shape)))
                  for k in (kp, kn))
    _codes_equal(jr.program(jnp.asarray(w), cj, key=key),
                 tr.program(torch.from_numpy(w), tr.RramConfig(programming_sigma=0.02),
                            noise=noise))


@pytest.mark.parametrize("hours,offset,event", [
    (None, 0.0, None), (24.0, 0.0, 0), (5.0, 24.0, 3),
])
def test_apply_drift_bitwise_given_reference_normals(hours, offset, event):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 128, 96)).astype(np.float32)
    cj, ct = jr.RramConfig(relative_drift=0.1), tr.RramConfig(relative_drift=0.1)
    xj = jr.program(jnp.asarray(w), cj)
    xt = tr.program(torch.from_numpy(w), ct)
    key = jax.random.PRNGKey(11)
    k = key if event is None else jax.random.fold_in(key, jnp.uint32(event))
    kp, kn = jax.random.split(k)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(kk, w.shape)))
                  for kk in (kp, kn))
    dj = jr.apply_drift(xj, cj, key, hours=hours, clock_offset=offset,
                        event_index=event)
    dt = tr.apply_drift(xt, ct, hours=hours, clock_offset=offset, noise=noise)
    _codes_equal(dj, dt)
    assert not np.array_equal(np.asarray(dj.g_pos), np.asarray(xj.g_pos))


@pytest.mark.parametrize("t0,hours", [(0.0, 24.0), (24.0, 1.0), (3.5, 100.0)])
def test_drift_sigma_values_equal(t0, hours):
    cj, ct = jr.RramConfig(relative_drift=0.13), tr.RramConfig(relative_drift=0.13)
    assert tr.drift_sigma(ct, t0 + hours) == jr.drift_sigma(cj, t0 + hours)
    assert (tr.drift_sigma_increment(ct, t0, hours)
            == jr.drift_sigma_increment(cj, t0, hours))


def test_port_program_and_advance_replay_bitwise_from_seed():
    cfg = get_arch("qwen3_1_7b").smoke

    def codes(seed):
        dep = Deployment.program(cfg, seed, backend="codes", device="cpu")
        dep.advance(24).advance(6)
        return dep.codes["body"][0]["mixer"]["q"]["w"]

    a, b, c = codes(0), codes(0), codes(1)
    assert torch.equal(a.g_pos, b.g_pos) and torch.equal(a.g_neg, b.g_neg)
    assert not torch.equal(a.g_pos, c.g_pos)


def test_port_drift_events_draw_independent_noise():
    """Each tick draws from its own stream: two 12 h ticks differ from one
    24 h tick in the codes but carry the same variance (the reference's
    slicing-invariance property)."""
    ct = tr.RramConfig(relative_drift=0.2)
    w = torch.randn((256, 256), generator=torch.Generator().manual_seed(0))
    xw = tr.program(w, ct)
    one = tr.apply_drift(xw, ct, tr.make_generator("cpu", 7, 0), hours=24.0)
    two = tr.apply_drift(xw, ct, tr.make_generator("cpu", 7, 1), hours=12.0)
    two = tr.apply_drift(two, ct, tr.make_generator("cpu", 7, 2), hours=12.0,
                         clock_offset=12.0)
    d1 = (tr.dequantize(one) - tr.dequantize(xw)).std()
    d2 = (tr.dequantize(two) - tr.dequantize(xw)).std()
    assert not torch.equal(one.g_pos, two.g_pos)
    assert abs(float(d1 / d2) - 1.0) < 0.05
