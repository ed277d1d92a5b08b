"""Port parity: the paper's own experiment (``core/resnet.py``,
``core/repro_experiments.py``, the conv half and int8 PTQ of
``core/dora.py``, ``mvm_reference``, ``drifted_weights`` and the Table I
model of ``core/rram.py``) against ``repro`` on the same numpy inputs, at
the reference's CI config (``tests/test_resnet_repro.py``: depth 8,
width 8, 8 classes, 16x16 images, DoRA rank 2).

Tolerances:

* ``CONV_RTOL`` (1e-5, of the output's absmax): one conv through the
  base and its side-car; only f32 summation orders differ (XLA's conv
  against PyTorch's).
* ``FWD_RTOL`` (1e-5, of each feature's absmax): the whole forward, its
  features, logits and BN statistics; the orders compound over 8 layers.
* ``GRAD_RTOL`` (1e-4, with ``GRAD_ATOL`` 1e-4 of the gradient's absmax):
  losses and gradients against ``jax.grad``, as
  ``test_torch_calibrate.py`` holds the LM's f32 gradients.
* ``ULP_RTOL`` (2.4e-7, two f32 ulps relative): a reduction XLA orders
  otherwise (``dora_m``, a column norm), and ``init_resnet`` against the
  reference under ``jax.jit``, where XLA folds the He scale into the
  normal's own ``sqrt(2)`` multiply.
* Bitwise: everything else given the reference's draws (the per-tap drift
  of ``make_student``, ``drifted_weights``, ``procedural_dataset``, A of
  ``init_conv_adapter``), the int8 PTQ, ``mvm_reference`` on
  integer-valued inputs (every current exact in f32), the counts and
  Table I.

The reference's experiment calls ``make_student`` and
``procedural_dataset`` eagerly. Under ``jax.jit`` XLA fuses their
arithmetic (the division by 255 of ``program`` becomes a multiply by its
reciprocal, the noise add a fused multiply-add), which moves last bits:
the bitwise checks run the reference eagerly, and the fixture's trees,
which only feed comparisons with a tolerance, come from ``jax.jit``.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dora as jdora
from repro.core import repro_experiments as jrx
from repro.core import resnet as jres
from repro.core import rram as jr
from repro.core.dora import AdapterConfig as JAdapterConfig
from repro_torch import tree as tree_lib
from repro_torch.core import dora as tdora
from repro_torch.core import repro_experiments as trx
from repro_torch.core import resnet as tres
from repro_torch.core import rram as tr
from repro_torch.core.dora import AdapterConfig as TAdapterConfig
from repro_torch.interop import from_reference
from repro_torch.kernels import crossbar_mvm as C
from repro_torch.kernels import dora_linear as K
from repro_torch.kernels.ref import crossbar_mvm_ref

from test_torch_model import np_tree

CONV_RTOL = 1e-5
FWD_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
ULP_RTOL = 2.4e-7

CI = dict(depth=8, width=8, classes=8, image_size=16)
J_CFG = jres.ResnetConfig(**CI, adapter=JAdapterConfig(rank=2, kind="dora"))
T_CFG = tres.ResnetConfig(**CI, adapter=TAdapterConfig(rank=2, kind="dora"))
N_DATA = 16


def cfg_pair(kind="dora", rank=2):
    return (dataclasses.replace(J_CFG, adapter=JAdapterConfig(rank=rank, kind=kind)),
            dataclasses.replace(T_CFG, adapter=TAdapterConfig(rank=rank, kind=kind)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(x):
    return torch.from_numpy(np.array(x))


def port(tree):
    return from_reference(np_tree(tree), "cpu")


def close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, (what, err)


def bitwise(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), what


def _lists(tree):
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lists(v) for v in tree]
    return tree


def leaves_with_paths(tree):
    out = {}
    tree_lib.map_with_path(lambda p, x: out.setdefault(tree_lib.path_str(p), x), _lists(tree))
    return out


def ref_leaves(tree):
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = x
    return out


def drift_normals(base, key):
    """The normals the reference's ``make_student(base, drift, key)``
    draws, per RRAM path: ``fold_in(key, crc32(path))``, then per tap of
    a conv leaf a key of ``split(.., taps)``, each split into (pos, neg).
    Draws only, so ``jax.jit`` leaves their bits as they are."""
    shapes = {p: w.shape for p, w in ref_leaves(base).items() if p.endswith("/w")}

    def draw(key):
        out = {}
        for path, shape in shapes.items():
            k = jax.random.fold_in(key, jnp.uint32(zlib.crc32(path.encode())))
            if len(shape) == 2:
                kp, kn = jax.random.split(k)
                out[path] = (jax.random.normal(kp, shape), jax.random.normal(kn, shape))
                continue
            pn = [jax.random.split(kk) for kk in jax.random.split(k, int(np.prod(shape[:-2])))]
            out[path] = tuple(jnp.stack([jax.random.normal(kk[j], shape[-2:]) for kk in pn])
                              .reshape(shape) for j in (0, 1))
        return out

    return {p: tuple(t(x) for x in pair) for p, pair in jax.jit(draw)(key).items()}


def ref_tree(tree):
    """Port tree -> the reference's (jnp leaves)."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.detach().numpy()), _lists(tree))


@pytest.fixture(scope="module")
def ref():
    """Trees at the CI config, made by the port and handed to both: a
    teacher with trained-looking BN statistics, its drifted student, and
    adapters with a nonzero B, so every term of the forward and of the
    losses is exercised."""
    rng = np.random.default_rng(0)

    def perturb(path, x):
        if path[-1] == "var":
            return t(rng.uniform(0.5, 1.5, x.shape).astype(np.float32))
        if path[-1] in ("mean", "bias", "lora_b"):
            return t(0.1 * rng.standard_normal(x.shape).astype(np.float32))
        return x

    g = tr.make_generator("cpu", 0, 1)
    base = tree_lib.map_with_path(perturb, tres.init_resnet(g, T_CFG))
    student = trx.make_student(base, 0.2, 5)
    adapters = tree_lib.map_with_path(perturb, tres.init_adapters(g, student, T_CFG))
    x, y = tres.procedural_dataset(g, N_DATA, T_CFG)
    return {"base": ref_tree(base), "student": ref_tree(student),
            "adapters": ref_tree(adapters),
            "data": (jnp.asarray(x.numpy()), jnp.asarray(y.numpy().astype(np.int32)))}


# ---------------------------------------------------------------------------
# core/dora.py: the conv half, int8 PTQ, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dora", "lora", "none"])
@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("stride", [1, 2])
def test_adapted_conv_forward(kind, k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 6)).astype(np.float32)
    acfg_j, acfg_t = JAdapterConfig(rank=2, kind=kind), TAdapterConfig(rank=2, kind=kind)
    ad = jdora.init_conv_adapter(jax.random.PRNGKey(1), k, k, 4, 6, acfg_j, jnp.asarray(w))
    if ad:
        ad["lora_b"] = jnp.asarray(0.3 * rng.standard_normal((2, 6)).astype(np.float32))
    want = jdora.adapted_conv_forward(jnp.asarray(x), jnp.asarray(w), ad, acfg_j,
                                      stride=(stride, stride))
    got = tdora.adapted_conv_forward(t(x), t(w), port(ad), acfg_t, stride=(stride, stride))
    assert tuple(got.shape) == (2, 8 // stride, 8 // stride, 6)
    close(got, want, CONV_RTOL, (kind, k, stride))


@pytest.mark.parametrize("size,k,s", [(8, 3, 2), (7, 3, 2), (8, 1, 2), (8, 3, 1), (9, 5, 3)])
def test_same_pads_are_jax_s(size, k, s):
    """The odd pixel goes after: a 3x3 stride-2 conv on an even input
    pads (0, 1); ``F.conv2d(padding=1)`` would pad (1, 1)."""
    rng = np.random.default_rng(size + k + s)
    x = rng.standard_normal((1, size, size, 2)).astype(np.float32)
    w = rng.standard_normal((k, k, 2, 3)).astype(np.float32)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    for padding in ("SAME", "VALID"):
        want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (s, s), padding,
                                            dimension_numbers=dn)
        close(tdora.conv2d_nhwc(t(x), t(w), (s, s), padding), want, CONV_RTOL, padding)
    if (size, k, s) == (8, 3, 2):
        assert tdora.same_pads(size, k, s) == (0, 1)


def test_conv_column_norm():
    rng = np.random.default_rng(1)
    w, a, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 3, 4, 6), (3, 3, 4, 2), (2, 6)))
    close(tdora.conv_column_norm(t(w), t(a), t(b)),
          jdora.conv_column_norm(jnp.asarray(w), jnp.asarray(a), jnp.asarray(b)), CONV_RTOL)


@pytest.mark.parametrize("kind", ["dora", "lora", "none"])
def test_init_conv_adapter_given_uniforms(kind):
    """Bitwise given A's U(0, 1) draws, for the conv and linear adapters."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    acfg_j, acfg_t = JAdapterConfig(rank=2, kind=kind), TAdapterConfig(rank=2, kind=kind)
    want = jdora.init_conv_adapter(key, 3, 3, 4, 6, acfg_j, jnp.asarray(w))
    u = t(jax.random.uniform(key, (3, 3, 4, 2)))
    got = tdora.init_conv_adapter(None, 3, 3, 4, 6, acfg_t, t(w), uniforms=u)
    assert set(got) == set(want)
    for name in want:
        (close(got[name], want[name], ULP_RTOL, name) if name == "dora_m"
         else bitwise(got[name], want[name], name))
    w2 = w.reshape(36, 6)
    want = jdora.init_adapter(key, 36, 6, acfg_j, w_base=jnp.asarray(w2))
    u = t(jax.random.uniform(key, (36, 2)))
    got = tdora.init_adapter(None, 36, 6, acfg_t, t(w2), uniforms=u)
    for name in want:
        (close(got[name], want[name], ULP_RTOL, name) if name == "dora_m"
         else bitwise(got[name], want[name], name))


@pytest.mark.parametrize("stride", [1, 2])
def test_fresh_conv_adapter_preserves_output(stride):
    """B = 0 and M = the base's column norms: the adapted conv is the
    plain conv."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((2, 8, 8, 4), generator=g), torch.randn((3, 3, 4, 6), generator=g)
    ad = tdora.init_conv_adapter(g, 3, 3, 4, 6, TAdapterConfig(rank=2), w)
    plain = tdora.conv2d_nhwc(x, w, (stride, stride))
    got = tdora.adapted_conv_forward(x, w, ad, TAdapterConfig(rank=2), stride=(stride, stride))
    torch.testing.assert_close(got, plain, rtol=CONV_RTOL, atol=CONV_RTOL)


def test_int8_ptq_codes_and_scales():
    rng = np.random.default_rng(3)
    ad = {"lora_a": rng.standard_normal((36, 2)).astype(np.float32) * 0.17,
          "lora_b": rng.standard_normal((2, 6)).astype(np.float32) * 1e-3,
          "dora_m": rng.uniform(0.5, 3.0, 6).astype(np.float32),
          "zero": np.zeros((4,), np.float32)}
    want = jdora.quantize_adapter_int8({k: jnp.asarray(v) for k, v in ad.items()})
    got = tdora.quantize_adapter_int8({k: t(v) for k, v in ad.items()})
    for name in ad:
        bitwise(got[name][0], want[name][0], name)
        bitwise(got[name][1], want[name][1], name)
    back_j = jdora.dequantize_adapter_int8(want)
    back_t = tdora.dequantize_adapter_int8(got)
    for name in ad:
        bitwise(back_t[name], back_j[name], name)


@pytest.mark.parametrize("kind", ["dora", "lora", "none"])
def test_adapter_param_count(kind):
    for d, k, r in ((144, 16, 1), (4608, 512, 2), (36, 6, 8)):
        assert (tdora.adapter_param_count(d, k, TAdapterConfig(rank=r, kind=kind))
                == jdora.adapter_param_count(d, k, JAdapterConfig(rank=r, kind=kind)))


# ---------------------------------------------------------------------------
# core/rram.py: mvm_reference, drifted_weights, Table I
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adc", [False, True])
@pytest.mark.parametrize("m,d,k", [(4, 300, 50), (200, 600, 33)])
def test_mvm_reference(adc, m, d, k):
    """Integer-valued x keeps every current exact in f32, so the ADC's
    rounding sees the same values: bitwise. With M > 128 the reference
    takes max|x| over all M rows of a block, unlike the kernels' 128-row
    tiles, and the port keeps it so."""
    rng = np.random.default_rng(m + d)
    x = rng.integers(-8, 9, (m, d)).astype(np.float32)
    x[128:] = np.clip(x[128:], -2, 2)   # rows past 128: a smaller max|x|
    w = rng.standard_normal((d, k)).astype(np.float32)
    cfg_j = jr.RramConfig(simulate_adc=adc)
    cfg_t = tr.RramConfig(simulate_adc=adc)
    xw_j = jr.program(jnp.asarray(w), cfg_j)
    xw_t = from_reference(np_tree(xw_j), "cpu")
    want = jr.mvm_reference(jnp.asarray(x), xw_j, cfg_j)
    got = tr.mvm_reference(t(x), xw_t, cfg_t)
    if adc:
        bitwise(got, want)
        kernel = crossbar_mvm_ref(t(x), xw_t.g_pos, xw_t.g_neg, xw_t.scale)
        assert torch.equal(kernel, got) == (m <= 128)
    else:
        close(got, want, CONV_RTOL)


@pytest.mark.parametrize("shape", [(64, 48), (3, 3, 8, 16)])
def test_drifted_weights_given_draws(shape):
    rng = np.random.default_rng(4)
    w = rng.standard_normal(shape).astype(np.float32)
    cfg_j, cfg_t = jr.RramConfig(relative_drift=0.2), tr.RramConfig(relative_drift=0.2)
    key = jax.random.PRNGKey(9)
    kp, kn = jax.random.split(key)
    want = jr.dequantize(jr.apply_drift(jr.program(jnp.asarray(w), cfg_j), cfg_j, key),
                         jnp.float32)
    noise = (t(jax.random.normal(kp, shape)), t(jax.random.normal(kn, shape)))
    got = tr.drifted_weights(t(w), cfg_t, dtype=torch.float32, noise=noise)
    bitwise(got, want)
    if len(shape) == 2:
        bitwise(got, jr.drifted_weights(jnp.asarray(w), cfg_j, key, dtype=jnp.float32))
    bf = tr.drifted_weights(t(w), cfg_t, noise=noise)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))


def test_table1_lifespan_and_speedup():
    for samples, on_rram in ((120, True), (10, False), (125, True), (1, False)):
        assert (tr.lifespan_calibrations(samples=samples, on_rram=on_rram)
                == jr.lifespan_calibrations(samples=samples, on_rram=on_rram))
    assert tr.calibration_speedup() == jr.calibration_speedup()
    bp = tr.lifespan_calibrations(samples=120, epochs=20, batch=1, on_rram=True)
    ours = tr.lifespan_calibrations(samples=10, epochs=20, batch=1, on_rram=False)
    assert abs(bp - 41_667) < 1          # paper: 41,667 calibrations
    assert ours == pytest.approx(5e13)   # paper: 5e13
    assert tr.calibration_speedup(base_samples=125, dora_samples=10) == pytest.approx(1250.0)


# ---------------------------------------------------------------------------
# core/resnet.py
# ---------------------------------------------------------------------------


def test_procedural_dataset_given_the_reference_s_draws():
    key = jax.random.PRNGKey(3)
    k_y, k_n, k_s = jax.random.split(key, 3)
    size = J_CFG.image_size
    draws = {"templates": t(jax.random.normal(jax.random.PRNGKey(1234), (8, 8, 8, 3))),
             "labels": t(jax.random.randint(k_y, (N_DATA,), 0, 8)),
             "shifts": t(jax.random.randint(k_s, (N_DATA, 2), -2, 3)),
             "noise": t(jax.random.normal(k_n, (N_DATA, size, size, 3)))}
    want_x, want_y = jres.procedural_dataset(key, N_DATA, J_CFG)   # eagerly, as run_cell
    x, y = tres.procedural_dataset(None, N_DATA, T_CFG, draws=draws)
    bitwise(x, want_x)
    assert torch.equal(y, t(want_y).to(torch.int64))


def test_procedural_dataset_streams():
    """Train and test draws share their class templates: a sample minus
    its noise is its class's template, rolled."""
    g = tr.make_generator("cpu", 0, 0)
    x, y = tres.procedural_dataset(g, 64, T_CFG, noise=0.0)
    x2, y2 = tres.procedural_dataset(tr.make_generator("cpu", 0, 0, 7), 64, T_CFG, noise=0.0)
    assert x.shape == (64, 16, 16, 3) and x.dtype == torch.float32 and y.dtype == torch.int64
    assert int(y.min()) >= 0 and int(y.max()) < 8
    for c in set(y.tolist()) & set(y2.tolist()):
        a, b = x[y == c][0], x2[y2 == c][0]
        assert any(torch.equal(torch.roll(a, (i, j), (0, 1)), b)
                   for i in range(-4, 5) for j in range(-4, 5))


def test_init_resnet_paths_and_shapes():
    want = ref_leaves(jax.eval_shape(lambda: jres.init_resnet(jax.random.PRNGKey(0), J_CFG)))
    got = leaves_with_paths(tres.init_resnet(torch.Generator().manual_seed(0), T_CFG))
    assert {p: (tuple(v.shape), str(v.dtype)) for p, v in want.items()} == {
        p: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for p, v in got.items()}
    ones = {p: torch.ones(s) for p, s in tres.conv_shapes(T_CFG).items()}
    he = leaves_with_paths(tres.init_resnet(None, T_CFG, normals=ones))
    for path, shape in tres.conv_shapes(T_CFG).items():
        fan_in = int(np.prod(shape[:-1]))
        scale = fan_in ** -0.5 if len(shape) == 2 else np.sqrt(2.0 / fan_in)
        assert torch.equal(he[path], torch.full(shape, scale, dtype=torch.float32)), path


def test_make_student_given_per_tap_normals(ref):
    """Bitwise the reference's eager ``make_student`` on one leaf of each
    kind (3x3 convs, the 1x1 proj, the fc) and the BN leaves beside them."""
    key = jax.random.PRNGKey(5)
    sub = {"blocks": [ref["base"]["blocks"][1]], "fc": ref["base"]["fc"]}
    assert "proj" in sub["blocks"][0]
    want = ref_leaves(jrx.make_student(sub, 0.2, key))
    got = leaves_with_paths(trx.make_student(port(sub), 0.2, 0, noise=drift_normals(sub, key)))
    assert sorted(want) == sorted(got)
    for path in want:
        bitwise(got[path], want[path], path)
    base = port(ref["base"])
    own = leaves_with_paths(trx.make_student(base, 0.2, 0))
    for path, x in leaves_with_paths(base).items():   # BN untouched, weights drifted
        assert torch.equal(own[path], x) == (not path.endswith("/w")), path


@pytest.mark.parametrize("training_bn", [False, True])
@pytest.mark.parametrize("kind", ["none", "dora", "lora"])
def test_forward(ref, training_bn, kind):
    cfg_j, cfg_t = cfg_pair(kind if kind != "none" else "dora")
    adapters = None if kind == "none" else ref["adapters"]
    if kind == "lora":
        adapters = lora_of(adapters)
    x = ref["data"][0][:6]
    logits, aux = jres.forward(ref["student"], x, cfg_j, adapters=adapters,
                               training_bn=training_bn, collect_features=True)
    tl, taux = tres.forward(port(ref["student"]), t(x), cfg_t,
                            adapters=None if adapters is None else port(adapters),
                            training_bn=training_bn, collect_features=True)
    close(tl, logits, FWD_RTOL, "logits")
    assert len(taux["features"]) == len(aux["features"]) == 3 * 2 + 2
    for i, (a, b) in enumerate(zip(taux["features"], aux["features"])):
        close(a, b, FWD_RTOL, f"feature {i}")
    ref_stats, got_stats = ref_leaves(aux["bn_stats"]), leaves_with_paths(taux["bn_stats"])
    assert sorted(ref_stats) == sorted(got_stats)
    for path in ref_stats:
        close(got_stats[path], ref_stats[path], FWD_RTOL, path)


def lora_of(adapters):
    """The DoRA adapter tree without its magnitudes."""
    def drop(ad):
        return {k: v for k, v in ad.items() if k != "dora_m"}

    return {"stem": drop(adapters["stem"]), "fc": drop(adapters["fc"]),
            "blocks": [{k: drop(v) for k, v in b.items()} for b in adapters["blocks"]]}


def test_apply_bn_stats(ref):
    base = port(ref["base"])
    x = t(ref["data"][0][:6])
    _, aux = tres.forward(base, x, T_CFG, training_bn=True)
    new = tres.apply_bn_stats(base, aux["bn_stats"])
    _, jaux = jres.forward(ref["base"], ref["data"][0][:6], J_CFG, training_bn=True)
    want = ref_leaves(jres.apply_bn_stats(ref["base"], jaux["bn_stats"]))
    got = leaves_with_paths(new)
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path], want[path], FWD_RTOL, path)
        if not path.endswith(("mean", "var")):
            assert got[path] is leaves_with_paths(base)[path]


def test_accuracy(ref):
    x, y = ref["data"]
    want = jres.accuracy(ref["student"], x, y, J_CFG, batch=8)
    assert tres.accuracy(port(ref["student"]), t(x), t(y).long(), T_CFG, batch=8) == want


@pytest.mark.parametrize("kind", ["dora", "lora"])
def test_trainable_fraction_counts(ref, kind):
    """Adapter elements over every teacher leaf, BN statistics included;
    14,162 / 279,792 at the full config with DoRA rank 2."""
    cfg_j, cfg_t = cfg_pair(kind)
    ads_j = jax.eval_shape(lambda b: jres.init_adapters(jax.random.PRNGKey(1), b, cfg_j),
                           ref["base"])
    ads_t = tres.init_adapters(torch.Generator().manual_seed(0), port(ref["base"]), cfg_t)
    n = lambda tr_: sum(x.size for x in jax.tree_util.tree_leaves(tr_))  # noqa: E731
    assert tres.param_count(ads_t) == n(ads_j)
    assert tres.param_count(port(ref["base"])) == n(ref["base"])
    full_j = dataclasses.replace(jres.ResnetConfig(),
                                 adapter=JAdapterConfig(rank=2, kind=kind))
    base_j = jax.eval_shape(lambda: jres.init_resnet(jax.random.PRNGKey(0), full_j))
    ads_full = jax.eval_shape(lambda b: jres.init_adapters(jax.random.PRNGKey(0), b, full_j),
                              base_j)
    full_t = dataclasses.replace(tres.ResnetConfig(), adapter=TAdapterConfig(rank=2, kind=kind))
    base_t = tres.init_resnet(torch.Generator().manual_seed(0), full_t)
    ads_t = tres.init_adapters(torch.Generator().manual_seed(0), base_t, full_t)
    assert (tres.param_count(ads_t), tres.param_count(base_t)) == (n(ads_full), n(base_j))
    if kind == "dora":
        assert (tres.param_count(ads_t), tres.param_count(base_t)) == (14_162, 279_792)


# ---------------------------------------------------------------------------
# core/repro_experiments.py: losses and gradients against jax.grad
# ---------------------------------------------------------------------------


def grads_close(got, want):
    ref_g, got_g = ref_leaves(want), leaves_with_paths(got)
    assert sorted(ref_g) == sorted(got_g)
    for path, w in ref_g.items():
        w = np.asarray(w)
        g = got_g[path].numpy()
        atol = GRAD_ATOL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=atol, err_msg=path)


@pytest.mark.parametrize("kind", ["dora", "lora"])
def test_calibration_loss_and_gradients(ref, kind):
    cfg_j, cfg_t = cfg_pair(kind)
    ads = ref["adapters"] if kind == "dora" else lora_of(ref["adapters"])
    x = ref["data"][0][:2]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda a: jrx.calibration_loss_resnet(ref["base"], ref["student"], a, x, cfg_j)))(ads)
    got, _, tg = trx._value_and_grad(
        lambda a: (trx.calibration_loss_resnet(port(ref["base"]), port(ref["student"]), a,
                                               t(x), cfg_t), None), port(ads))
    np.testing.assert_allclose(float(got), float(loss), rtol=GRAD_RTOL)
    grads_close(tg, grads)


def _ref_teacher_loss(params, x, y):
    logits, aux = jres.forward(params, x, J_CFG, training_bn=True)
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(x.shape[0]), y]), aux["bn_stats"]


def _ref_backprop_loss(params, x, y):
    logits, _ = jres.forward(params, x, J_CFG)
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(x.shape[0]), y])


def test_teacher_loss_and_gradients(ref):
    """The teacher's step: CE through batch statistics, the BN running
    statistics' gradients zeroed, the new statistics folded in."""
    x, y = ref["data"][0][:8], ref["data"][1][:8]
    (loss, stats), grads = jax.jit(jax.value_and_grad(_ref_teacher_loss, has_aux=True))(
        ref["base"], x, y)
    grads = jrx._zero_bn_stat_grads(grads)
    got, tstats, tg = trx._value_and_grad(
        lambda p: trx.teacher_loss(p, t(x), t(y).long(), T_CFG), port(ref["base"]))
    np.testing.assert_allclose(float(got), float(loss), rtol=GRAD_RTOL)
    grads_close(trx._zero_bn_stat_grads(tg), grads)
    for path, v in ref_leaves(stats).items():
        close(leaves_with_paths(tstats)[path], v, FWD_RTOL, path)


def test_backprop_loss_and_gradients(ref):
    x, y = ref["data"][0][:1], ref["data"][1][:1]
    loss, grads = jax.jit(jax.value_and_grad(_ref_backprop_loss))(ref["student"], x, y)
    grads = jrx._zero_bn_stat_grads(grads)
    got, _, tg = trx._value_and_grad(
        lambda p: (trx.backprop_loss(p, t(x), t(y).long(), T_CFG), None), port(ref["student"]))
    np.testing.assert_allclose(float(got), float(loss), rtol=GRAD_RTOL)
    grads_close(trx._zero_bn_stat_grads(tg), grads)


def test_backprop_calibrate_counts_updates(ref):
    x, y = t(ref["data"][0][:3]), t(ref["data"][1][:3]).long()
    student = port(ref["student"])
    out, updates = trx.backprop_calibrate(student, x, y, T_CFG, epochs=2)
    assert updates == 6
    moved = leaves_with_paths(out)
    for path, v in leaves_with_paths(student).items():   # weights move, BN stats do not
        if path.endswith(("mean", "var")):
            assert torch.equal(moved[path], v), path
    assert not torch.equal(moved["fc/w"], leaves_with_paths(student)["fc/w"])


# ---------------------------------------------------------------------------
# run_cell, port only, on the CPU
# ---------------------------------------------------------------------------


def _snap(tree):
    return {p: v.clone() for p, v in leaves_with_paths(tree).items()}


@pytest.fixture(scope="module")
def cell():
    """One DoRA ``run_cell`` on the CPU at the CI config, with the
    reference CI test's sizes and drift (``tests/test_resnet_repro.py``:
    512 train and 512 test images, drift 0.25), run twice from seed 0;
    ``feature_calibrate`` wrapped to snapshot the teacher and student
    before and after, and the kernels' launch counts read."""
    seen = []
    real = trx.feature_calibrate

    def recording(teacher, student, adapters, images, cfg, **kw):
        before = (_snap(teacher), _snap(student))
        out = real(teacher, student, adapters, images, cfg, **kw)
        seen.append((before, (_snap(teacher), _snap(student)), out[1]))
        return out

    def run():
        data = trx.cell_data(0, T_CFG, "cpu", n_train=512, n_test=512)
        return trx.run_cell(seed=0, cfg=T_CFG, drift=0.25, data=data, device="cpu")

    mp = pytest.MonkeyPatch()
    mp.setattr(trx, "feature_calibrate", recording)
    K.reset_launch_counts()
    C.reset_launch_counts()
    try:
        runs = [run(), run()]
    finally:
        mp.undo()
    counts = {**K.launch_counts(), **C.launch_counts()}
    return runs, seen, counts


def test_run_cell_drift_degrades_and_dora_restores(cell):
    (r, _), seen, counts = cell
    assert r.method == "dora" and r.samples == 10 and r.drift == 0.25
    assert r.teacher_acc > 0.7                       # the reference's CI bars
    assert r.drifted_acc < r.teacher_acc - 0.05
    assert r.calibrated_acc > r.drifted_acc + 0.3 * (r.teacher_acc - r.drifted_acc)
    losses = seen[0][2]
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert set(counts.values()) == {0}


def test_run_cell_writes_no_student_or_bn_leaf(cell):
    _, seen, _ = cell
    for (t0, s0), (t1, s1), _ in seen:
        for before, after in ((t0, t1), (s0, s1)):
            assert before.keys() == after.keys()
            for path in before:
                assert torch.equal(before[path], after[path]), path


def test_run_cell_replays_bitwise(cell):
    (a, b), seen, _ = cell
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert seen[0][2] == seen[1][2]
    base = tres.init_resnet(torch.Generator(), T_CFG)
    n_ad = tres.param_count(tres.init_adapters(torch.Generator(), base, T_CFG))
    assert a.trainable_fraction == n_ad / tres.param_count(base)
