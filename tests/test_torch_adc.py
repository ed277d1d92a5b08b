"""Port parity: the ADC-faithful crossbar MVM (``kernels/crossbar_mvm.py``)
and the ``codes_adc`` backend against the reference. On the CPU the port's
wrapper takes its plain version (``kernels/ref.py::crossbar_mvm_ref``);
the reference runs ``crossbar_mvm`` in interpret mode and its own
``ref.crossbar_mvm_ref``, both on operands zero-padded to whole tiles as
its ``rimc_mvm_adc`` pads them.

Tolerances:
* the exactness case (integer x in [-127, 127] with 127 in every
  (128-row, 256-row) block, so step = 4080 and every tile current is an
  exact integer below 2^24): bitwise;
* otherwise the f32 tile currents are summed in another order, which can
  move one across an ADC rounding boundary: every output within rtol 1e-4
  / atol 1e-6 of the reference's, or exactly one step times its column
  scale apart, in at most 0.1% of the outputs;
* after the ADC, ``codes_adc`` rounds to x's dtype and adds the digital
  DoRA path: rtol 1e-4 / atol 1e-5 of the output's absmax in f32.
Greedy streams of a ``codes_adc`` session are held as in
``tests/test_torch_serve.py``: equal, or a divergence at a near-tie of the
reference's logits. In the float32 config that is the same near-tie
(``F32_BOUND``), and the two packages' codes_adc logits agree to ~1e-6.
In bf16 the near-tie is ``ADC_BF16_BOUND`` = 20% of the absmax: the two
packages round bf16 activations at different places (their codes and
dequant logits differ by ~2% of the absmax, within ``BF16_BOUND``), and
the ADC amplifies that: one ulp more or less in a tile's max |x| moves the
step of the whole tile, which shifts many of its outputs by up to one
step (a 256-row tile current is worth only ~16 steps of an 8-bit ADC at
typical inputs). At smoke size the packages' bf16 codes_adc logits differ
by up to 16% of the absmax.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rram as jr
from repro.kernels import crossbar_mvm as jc
from repro.kernels import ref as jref
from repro.substrate import exec as jexec
from repro_torch import substrate as tsub
from repro_torch.core import dora as tdora
from repro_torch.core.rram import RramConfig
from repro_torch.deploy import serving as tserving
from repro_torch.kernels import autotune
from repro_torch.kernels import crossbar_mvm as tc
from repro_torch.kernels import ref as tref
from repro_torch.substrate import exec as texec

from test_torch_prepared import _leaf_pair
from test_torch_serve import GEN, _prompts, assert_streams_match, sessions  # noqa: F401

FLIP_SHARE = 1e-3
ADC_BF16_BOUND = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operands(m, k, n, seed, exact=False):
    rng = np.random.default_rng(seed)
    if exact:
        x = rng.integers(-127, 128, (m, k)).astype(np.float32)
        x[::128, ::256] = 127.0
        scale = np.ones((1, n), np.float32)
    else:
        x = (rng.standard_normal((m, k)) * rng.uniform(0.2, 3.0, (m, 1))).astype(np.float32)
        scale = (rng.uniform(0.5, 1.5, (1, n)) * 1e-3).astype(np.float32)
    gp = rng.integers(0, 256, (k, n), dtype=np.uint8)
    gn = rng.integers(0, 256, (k, n), dtype=np.uint8)
    return x, gp, gn, scale


def _reference(x, gp, gn, scale, **kw):
    """The reference's kernel (interpret mode) and its oracle, on operands
    zero-padded to whole (128-row, 256-row) tiles, cut back to (M, N)."""
    m, k = x.shape
    mp, kp = -(-m // 128) * 128, -(-k // 256) * 256
    xp = np.zeros((mp, kp), np.float32)
    xp[:m, :k] = x
    gpp, gnp = (np.zeros((kp, g.shape[1]), np.uint8) for g in (gp, gn))
    gpp[:k], gnp[:k] = gp, gn
    args = [jnp.asarray(a) for a in (xp, gpp, gnp, scale)]
    kern = np.array(jc.crossbar_mvm(*args, bn=gp.shape[1], interpret=True, **kw))[:m]
    oracle = np.array(jref.crossbar_mvm_ref(*args, **kw))[:m]
    return kern, oracle


def _assert_adc_close(got, want, x, scale, **kw):
    bad, flips = tref.adc_disagreement(*(torch.tensor(a) for a in (got, want, x, scale)),
                                       **kw)
    assert bad == 0 and flips <= FLIP_SHARE * got.size, (bad, flips)


@pytest.mark.parametrize("m,k,n", [(5, 300, 40), (130, 300, 24), (128, 512, 16), (3, 256, 7)])
def test_exactness_case_bitwise(m, k, n):
    x, gp, gn, scale = _operands(m, k, n, seed=m + k, exact=True)
    assert torch.all(tref.adc_steps(torch.from_numpy(x)) == 4080.0)
    kern, oracle = _reference(x, gp, gn, scale)
    got = tc.crossbar_mvm(*map(torch.from_numpy, (x, gp, gn, scale))).numpy()
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, kern)


# the narrow body's shapes (f32 x, N <= 64) too: N 8 and 64, K 700 (a
# partial last 256-row tile), M within one 128-row block and across two
@pytest.mark.parametrize("adc_bits", [8, 3])
@pytest.mark.parametrize("m,k,n", [(5, 300, 40), (130, 300, 24), (64, 777, 33),
                                   (4, 700, 8), (130, 700, 8), (4, 700, 64), (130, 700, 64)])
def test_crossbar_mvm_matches_reference(m, k, n, adc_bits):
    x, gp, gn, scale = _operands(m, k, n, seed=7 * m + k)
    kern, oracle = _reference(x, gp, gn, scale, adc_bits=adc_bits)
    got = tc.crossbar_mvm(*map(torch.from_numpy, (x, gp, gn, scale)), adc_bits=adc_bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    for want in (oracle, kern):
        _assert_adc_close(got.numpy(), want, x, scale, adc_bits=adc_bits)


def test_adc_bits_change_the_output():
    x, gp, gn, scale = [torch.from_numpy(a) for a in _operands(9, 300, 20, seed=1)]
    assert not torch.equal(tc.crossbar_mvm(x, gp, gn, scale),
                           tc.crossbar_mvm(x, gp, gn, scale, adc_bits=3))


def test_row_blocks_take_their_own_step():
    """max|x| is taken per 128-row block: scaling the rows of the second
    block leaves the first block's outputs bitwise unchanged."""
    x, gp, gn, scale = [torch.from_numpy(a) for a in _operands(200, 300, 16, seed=2)]
    y = tc.crossbar_mvm(x, gp, gn, scale)
    x2 = x.clone()
    x2[128:] *= 10.0
    y2 = tc.crossbar_mvm(x2, gp, gn, scale)
    assert torch.equal(y[:128], y2[:128]) and not torch.equal(y[128:], y2[128:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rimc_mvm_adc_matches_reference(dtype):
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((300, 24)) / np.sqrt(300)).astype(np.float32)
    xw_j = jr.program(jnp.asarray(w), jr.RramConfig())
    from test_torch_model import np_tree
    from repro_torch.interop import from_reference

    xw_t = from_reference(np_tree(xw_j), "cpu")
    x = rng.standard_normal((2, 70, 300)).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jexec.rimc_mvm_adc(xj, xw_j, interpret=True).astype(jnp.float32))
    got = texec.rimc_mvm_adc(xt, xw_t)
    assert got.dtype == xt.dtype and tuple(got.shape) == (2, 70, 24)
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        flat = got.reshape(-1, 24)
        _assert_adc_close(flat, want.reshape(-1, 24), x.reshape(-1, 300),
                          np.asarray(xw_j.scale).reshape(1, -1))
    else:  # a one-step flip then shows through the bf16 rounding
        share = np.mean(got != want)
        assert share <= FLIP_SHARE * 10, share


def test_codes_adc_backend_with_adapters_matches_reference():
    from repro import substrate as jsub
    from repro.core.dora import AdapterConfig as JCfg

    xw_j, ad_j, xw_t, ad_t = _leaf_pair(k=300, n=24, r=3, seed=6)
    x = np.random.default_rng(8).standard_normal((5, 300)).astype(np.float32)
    want = np.asarray(jsub.crossbar_linear(jnp.asarray(x), xw_j, ad_j, JCfg(rank=3),
                                           backend="codes_adc"))
    got = tsub.crossbar_linear(torch.from_numpy(x), xw_t, ad_t, tdora.AdapterConfig(rank=3),
                               backend="codes_adc").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_resolve_adc_limits():
    cfg = RramConfig(adc_bits=6)
    assert tsub.resolve_adc_limits(cfg, None, None) == (255, 6)
    assert tsub.resolve_adc_limits(cfg, 255, 6) == (255, 6)
    assert tsub.resolve_adc_limits(None, None, None) == (255, 8)
    assert tsub.resolve_adc_limits(None, 127, 4) == (127, 4)
    with pytest.raises(ValueError, match="conflicts"):
        tsub.resolve_adc_limits(cfg, None, 8)
    with pytest.raises(ValueError, match="conflicts"):
        tsub.resolve_adc_limits(cfg, 127, None)


def test_backend_scope_plumbs_the_rram_config():
    from repro_torch.configs import get_arch

    cfg = get_arch("qwen3_1_7b").smoke
    cfg = dataclasses.replace(cfg, rram=dataclasses.replace(cfg.rram, adc_bits=5))
    with tserving.backend_scope("codes_adc", cfg):
        assert tsub.active_backend_name() == "codes_adc"
        assert tsub.active_options() == {"code_max": 255, "adc_bits": 5}
    with pytest.raises(ValueError, match="conflicts"):
        with tserving.backend_scope("codes_adc", cfg, adc_bits=8):
            pass
    with tserving.backend_scope("codes", cfg, accum="int8"):
        assert tsub.active_options() == {"accum": "int8"}


def test_codes_adc_rejects_prepared_leaves():
    from repro_torch.substrate.prepared import prepare_crossbar

    _, _, xw_t, _ = _leaf_pair(k=16, n=8, r=2, seed=1)
    prep = prepare_crossbar(xw_t, None, tdora.AdapterConfig(rank=2))
    with pytest.raises(TypeError, match="raw per-leaf codes"):
        tsub.crossbar_linear(torch.zeros((1, 16)), prep, None, tdora.AdapterConfig(rank=2),
                             backend="codes_adc")


def test_cpu_path_launches_no_kernel():
    x, gp, gn, scale = [torch.from_numpy(a) for a in _operands(3, 40, 8, seed=0)]
    tc.reset_launch_counts()
    tc.crossbar_mvm(x, gp, gn, scale)
    assert tc.launch_counts() == {"crossbar_mvm": 0}


@pytest.mark.parametrize("grad_of", ["x", "scale"])
def test_wrapper_refuses_autograd(grad_of):
    """No backward: an operand that requires grad under grad mode raises on
    every device; under ``torch.no_grad()`` the plain result comes back."""
    ops = [torch.from_numpy(a) for a in _operands(3, 300, 8, seed=2)]
    want = tc.crossbar_mvm(*ops)
    ops[("x", "g_pos", "g_neg", "scale").index(grad_of)].requires_grad_(True)
    tc.reset_launch_counts()
    with pytest.raises(RuntimeError, match="crossbar_mvm has no backward.*dequant"):
        tc.crossbar_mvm(*ops)
    with torch.no_grad():
        got = tc.crossbar_mvm(*ops)
    assert torch.equal(got, want)
    assert tc.launch_counts() == {"crossbar_mvm": 0}


def test_codes_adc_forward_with_trainable_adapters_raises():
    """A loss through ``codes_adc`` would reach the ADC kernel with an
    input that requires grad: refused, so that calibration runs under
    ``dequant`` (as ``Deployment.calibrate`` does)."""
    x, gp, gn, scale = [torch.from_numpy(a) for a in _operands(4, 64, 8, seed=3)]
    xw = tsub.CrossbarWeight(g_pos=gp, g_neg=gn, scale=scale)
    acfg = tdora.AdapterConfig(rank=2)
    adapter = {"lora_a": torch.full((64, 2), 0.1, requires_grad=True),
               "lora_b": torch.zeros((2, 8), requires_grad=True),
               "dora_m": torch.ones((8,), requires_grad=True)}
    h = x @ adapter["lora_a"] @ torch.ones((2, 64))  # an input that requires grad
    with pytest.raises(RuntimeError, match="no backward"):
        tsub.crossbar_linear(h, xw, adapter, acfg, backend="codes_adc")
    y = tsub.crossbar_linear(h, xw, adapter, acfg, backend="dequant")
    y.sum().backward()
    assert adapter["lora_b"].grad is not None


# -- the tensor-core body's plan (autotune.adc_plan) ---------------------------

# qwen3-1.7b unfused leaves, what codes_adc runs: (K, N); the serving row
# counts (decode ticks of 1-16 slots, admission chunks of 32, phase 5's
# 96-row prefill, a 256-row prefill); ragged shapes (K not a multiple of
# 256, M over one 128-row block, N ragged)
ADC_LEAVES = {"q": (2048, 2048), "k": (2048, 1024), "v": (2048, 1024), "o": (2048, 2048),
              "gate": (2048, 6144), "up": (2048, 6144), "down": (6144, 2048)}
PLAN_SHAPES = [pytest.param(m, k, n, id=f"{leaf}-{m}")
               for leaf, (k, n) in ADC_LEAVES.items() for m in (1, 4, 8, 16, 32, 96, 256)]
PLAN_SHAPES += [pytest.param(m, k, n, id=f"ragged-{m}-{k}-{n}") for m, k, n in
                [(5, 300, 77), (130, 300, 65), (200, 1000, 999), (1, 33, 4097), (17, 257, 1024)]]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_adc_plan_parts_blocks_and_wave(m, k, n):
    """The plan's parts of K, bounded as the kernel bounds them (t0, t1 of
    adc_mma_kernel, checked in test_adc_constants_match_the_kernel), are
    whole 256-row tiles that partition [0, K) in order; a block holds
    whole 128-row blocks of x; the launch fits one wave, its shared memory
    an SM."""
    parts = autotune.adc_plan(m, k, n)
    tiles = -(-k // autotune.ADC_ARRAY_ROWS)
    assert isinstance(parts, int) and 1 <= parts <= tiles
    bounds = [(p * tiles // parts * autotune.ADC_ARRAY_ROWS,
               min(k, (p + 1) * tiles // parts * autotune.ADC_ARRAY_ROWS))
              for p in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi and lo % autotune.ADC_ARRAY_ROWS == 0 for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # the scratch's slots: part 0's running sum, then one per tile of the
    # later parts (the kernel's t - a1 + 1), each M x N
    a1 = tiles // parts
    assert parts == 1 or bounds[1][0] == a1 * autotune.ADC_ARRAY_ROWS
    rows = 8 * autotune.adc_row_tiles(m)
    assert rows >= min(m, autotune.ADC_BLOCK_ROWS) and rows <= autotune.ADC_BLOCK_ROWS
    assert autotune.adc_blocks(m, n, parts) <= autotune.adc_wave(m)
    assert autotune.adc_smem(rows // 8) + autotune.SMEM_PER_BLOCK_RESERVED <= \
        autotune.SMEM_PER_SM // autotune.adc_min_blocks(rows // 8)


# -- the narrow body's plan (autotune.adc_narrow_plan) ---------------------------

# the routers under codes_adc, f32 x: mixtral-8x22b (K 6144, N 8) and
# deepseek-v2-lite (K 2048, N 64) at the decode ticks, a chunk, the 96-row
# prefill, across two row blocks (130) and the 256-row prefill; K 6100 (a
# partial last tile) at N 60; one tile (K 40) and two (K 300)
ADC_NARROW_SHAPES = [pytest.param(m, k, n, id=f"{name}-{m}")
                     for name, k, n in (("mixtral", 6144, 8), ("deepseek", 2048, 64),
                                        ("ragged", 6100, 60))
                     for m in (1, 4, 32, 96, 130, 256)]
ADC_NARROW_SHAPES += [pytest.param(m, k, n, id=f"small-{m}-{k}-{n}")
                      for m, k, n in ((3, 40, 8), (1, 300, 64), (200, 257, 31))]


@pytest.mark.parametrize("m,k,n", ADC_NARROW_SHAPES)
def test_adc_narrow_plan_covers_whole_tiles_within_a_wave(m, k, n):
    """The parts, bounded as the kernel bounds them (t0, t1 of
    adc_narrow_kernel, checked in test_adc_constants_match_the_kernel), are
    whole 256-row tiles that cover [0, K) in order, one part a tile at the
    routers' K; the launch (row blocks x parts) fits one wave and a block's
    ring fits the shared memory of an SM."""
    parts = autotune.adc_narrow_plan(m, k, n)
    tiles = -(-k // autotune.ADC_ARRAY_ROWS)
    assert isinstance(parts, int) and 1 <= parts <= tiles
    bounds = [(p * tiles // parts * autotune.ADC_ARRAY_ROWS,
               min(k, (p + 1) * tiles // parts * autotune.ADC_ARRAY_ROWS))
              for p in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi and lo % autotune.ADC_ARRAY_ROWS == 0 for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    blocks = -(-m // autotune.ADC_BLOCK_ROWS) * parts
    assert blocks <= autotune.adc_narrow_wave(m, n) <= autotune.WAVE
    assert parts == tiles  # the routers' K gives every tile a part
    assert autotune.adc_narrow_smem(m, n) + autotune.SMEM_PER_BLOCK_RESERVED <= \
        autotune.SMEM_PER_SM


def test_adc_narrow_plan_stays_within_the_wave_at_large_m():
    """Where the row blocks alone come near the wave, the tiles are dealt
    to fewer parts, never fewer than one."""
    m, k, n = 128 * 100, 6144, 8
    parts = autotune.adc_narrow_plan(m, k, n)
    assert parts == autotune.adc_narrow_wave(m, n) // 100 == 1
    assert autotune.adc_narrow_plan(128 * 200, k, n) == 1


def test_adc_narrow_dispatch_rule():
    """f32 x at N <= NARROW_MAX_N runs the narrow body; bf16 x (the tensor-
    core body at any N) and f32 x at N = 65 (the SIMT body) do not."""
    assert autotune.NARROW_MAX_N == 64
    assert autotune.use_adc_narrow(8, True) and autotune.use_adc_narrow(64, True)
    assert autotune.use_adc_narrow(1, True)
    assert not autotune.use_adc_narrow(65, True)
    assert not autotune.use_adc_narrow(8, False) and not autotune.use_adc_narrow(64, False)
    src = tc.LIB.src.read_text()
    wrapper = tc._launch.__code__.co_names
    assert "use_adc_narrow" in wrapper and "rimc_crossbar_mvm_narrow" in wrapper
    assert "N > kNarrowMaxN" in src  # the C entry refuses wider calls


def test_adc_constants_match_the_kernel():
    """The plan's view of the tensor-core body (row tiles, warp columns,
    strip, stage rows and ring, the blocks an SM must hold, shared memory
    a block, the parts' tile bounds and scratch) is the kernel's."""
    import re

    src = tc.LIB.src.read_text()
    names = ("kBlockRows", "kArrayRows", "kMmaWarpCols", "kMmaN", "kMmaK", "kMmaStages")
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in names}
    assert const == {"kBlockRows": autotune.ADC_BLOCK_ROWS,
                     "kArrayRows": autotune.ADC_ARRAY_ROWS,
                     "kMmaWarpCols": autotune.ADC_WARP_COLS,
                     "kMmaN": autotune.ADC_STRIP,
                     "kMmaK": autotune.ADC_STAGE_ROWS,
                     "kMmaStages": autotune.ADC_STAGES}
    tiles = re.search(r"constexpr int kMmaRowTiles\[\] = \{([^}]*)\};", src).group(1)
    assert tuple(int(v) for v in tiles.split(",")) == autotune.ADC_ROW_TILES
    assert "constexpr int kMmaWarps = kMmaN / kMmaWarpCols;" in src
    assert "(NT >= 8 ? 1 : 2) * (8 / kMmaWarps)" in src
    assert "static constexpr int STAGE = 2 * C + X;" in src
    assert "static constexpr int RING = kMmaStages * STAGE;" in src
    assert src.count("const int t0 = part * T / parts, t1 = (part + 1) * T / parts;") == 2
    assert "return parts > 1 ? (long long)(T - T / parts + 1) * M * N : 0;" in src
    # the narrow body: its most columns, stage rows and ring, the shared
    # memory a block (autotune.adc_narrow_smem), its scratch (every tile's
    # partials, rimc_adc_part_scratch) and one ticket a row block
    narrow = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
              for name in ("kNarrowMaxN", "kNarrowK", "kNarrowStages")}
    assert narrow == {"kNarrowMaxN": autotune.NARROW_MAX_N,
                      "kNarrowK": autotune.ADC_NARROW_STAGE_ROWS,
                      "kNarrowStages": autotune.ADC_NARROW_STAGES}
    assert "constexpr int kNarrowXS = kNarrowK + 4;" in src
    assert "return rp * kNarrowXS * 4 + 2 * kNarrowK * np;" in src
    assert "const int rp = ((M < kBlockRows ? M : kBlockRows) + 3) & ~3, np = (N + 3) & ~3;" in src
    assert "const int smem = kNarrowStages * narrow_stage_bytes(rp, np);" in src
    assert "return (long long)((K + kArrayRows - 1) / kArrayRows) * M * N;" in src
    assert "int rimc_adc_narrow_sems(int M) { return (M + kBlockRows - 1) / kBlockRows; }" in src


def test_adc_binding_matches_the_c_signature():
    """The ctypes argument list of every C function of the ADC source has
    as many entries as its declaration has parameters."""
    import re
    from types import SimpleNamespace

    src = tc.LIB.src.read_text()
    names = ("rimc_crossbar_mvm", "rimc_crossbar_mvm_mma", "rimc_adc_mma_sems",
             "rimc_adc_mma_scratch", "rimc_adc_capture_id", "rimc_adc_step_scratch",
             "rimc_adc_part_scratch", "rimc_crossbar_mvm_narrow", "rimc_adc_narrow_sems")
    lib = SimpleNamespace(**{nm: SimpleNamespace() for nm in names})
    tc._bind(lib)
    for nm in names:
        params = re.search(rf"\b{nm}\(([^)]*)\)", src).group(1)
        assert len(getattr(lib, nm).argtypes) == params.count(",") + 1, nm


# -- serving ------------------------------------------------------------------


@pytest.fixture(scope="module")
def adc_sessions(sessions):  # noqa: F811
    from repro.deploy import Deployment as JDeployment
    from repro_torch.deploy import Deployment

    s_j, s_t = sessions
    dj, dt = s_j.deployment, s_t.deployment
    adc_j = JDeployment(dj.cfg, "codes_adc", dj.teacher_base, dj.codes, dj.adapters,
                        dj.teacher_key, dj.program_key)
    adc_t = Deployment(dt.cfg, "codes_adc", dt.teacher_base, dt.codes, dt.adapters,
                       dt.teacher_seed, dt.program_seed, dt.drift_hours)
    return adc_j.serve(), adc_t.serve()


def test_adc_session_reads_raw_codes(adc_sessions):
    from repro_torch.core.rram import CrossbarWeight

    _, s_t = adc_sessions
    assert s_t.options == {}
    assert isinstance(s_t.params["base"]["body"][0]["mixer"]["q"]["w"], CrossbarWeight)
    with s_t.scope():
        assert tsub.active_options() == {"code_max": 255, "adc_bits": 8}


def test_adc_session_generate_matches_reference(adc_sessions):
    s_j, s_t = adc_sessions
    prompt = np.random.default_rng(24).integers(0, s_j.cfg.vocab, (2, 6)).astype(np.int32)
    ref, _ = s_j.generate(jnp.asarray(prompt), gen_len=GEN)
    got, _ = s_t.generate(torch.as_tensor(prompt), gen_len=GEN)
    for i in range(2):
        assert_streams_match(s_j, prompt[i], np.asarray(ref)[i], got[i], ADC_BF16_BOUND)


def test_adc_engine_matches_reference(adc_sessions):
    from repro.deploy import ServeEngine as JEngine
    from repro_torch.deploy import ServeEngine

    s_j, s_t = adc_sessions
    prompts = _prompts(s_j.cfg.vocab)
    streams = []
    for engine_cls, session in ((JEngine, s_j), (ServeEngine, s_t)):
        engine = engine_cls(session, max_slots=2, max_len=64)
        reqs = []
        for p in prompts:
            reqs.append(engine.submit(p, max_new=GEN))
            engine.step()
        engine.run()
        streams.append([list(r.tokens) for r in reqs])
    for p, ref, got in zip(prompts, *streams):
        assert len(got) == GEN
        assert_streams_match(s_j, p, ref, got, ADC_BF16_BOUND)


def test_serve_cli_codes_adc_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-1.7b", "--smoke", "--backend", "codes_adc", "--device", "cpu",
                "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert "backend=codes_adc device=cpu rram_bytes=" in out
    assert "generated (2, 3)" in out
