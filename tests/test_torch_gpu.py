"""The port's CUDA kernels on the card (marker ``gpu``; each test skips
inside itself when no CUDA device is present). The kernels are held
against their plain PyTorch version (``kernels/ref.py``) at qwen3-1.7b's
full-width leaves and at ragged shapes:
* the fused linear's f32 body at rtol = atol = 1e-4 (exact f32 arithmetic
  in both; only the summation order differs), and both launchers'
  tensor-core bodies (bf16 x) at the same tolerance, bitwise equal to
  themselves when launched twice; f32 x still runs the SIMT bodies above
  64 columns, and the narrow body at N <= 64 (the routers: one split-K
  launch through either launcher, bitwise across launches, plans and
  graph replays, tickets left zero);
* its int8 body within 1e-4 of the output's absmax (the same row
  quantization and exact int32 sum; only f32 orders differ), bitwise on
  the exactness case (integer x with 127 in every row, scale = gamma = 1,
  A = B = 0); the GEMV launcher's int8 body (tensor cores, u8 x s8, one
  launch with bf16 or f32 x at the decode tick) bitwise equal to itself
  when launched twice, at the edges of its K split, under any plan (parts
  of K, row scales in the launch or before it) and when replayed from
  CUDA graphs, and bitwise on the exactness case where its plan splits K;
  the tiled launcher's int8 body (tensor cores, s8 x u8) at
  the same tolerance for every tiled shape of the f32 one, bitwise equal
  to itself when launched twice, and bitwise on the exactness case where
  its plan splits K;
* the ADC kernel within rtol 1e-4 / atol 1e-6 or one ADC step apart in at
  most 0.1% of the outputs, bitwise on its exactness case (integer x with
  127 in every (128-row, 256-row) block, so the step is 4080) with f32 and
  with bf16 x; its tensor-core body (bf16 x) bitwise equal to itself when
  launched twice, under any plan (splits of K, strips, stages) and when
  replayed from CUDA graphs; its narrow body (f32 x at N <= 64, the routers
  under codes_adc: one split-K launch) the same, x aligned or not, across
  two row blocks; f32 x still runs the SIMT body above 64 columns;
* calibration's compiled step (``CompiledCalibStep``): ``calibrate``
  through its CUDA graph bitwise the eager step functions on the same
  stream, cached and fused, with no launch and one capture a call; a
  second call after ``advance`` captures anew, and memory returns;
* the serving step registry (``deploy/serving.py``): for the f32, int8 and
  codes_adc sessions, the decode graph and the chunk graphs (8, 16, 32
  rows) replay bitwise equal to the eager step, logits and cache;
  ``compile_count`` flat on a second drive; launch counters after a run
  through the graphs equal to an eager run's; errors in warm-up or
  capture propagate; replays right with the rope cache cleared first;
* lifecycle persistence: a smoke deployment (drift, calibration, two fault
  classes, drift) snapshotted and restored bitwise on the card, a restore
  onto the CPU refused, an asynchronous save taken at the call;
* the shared prefix cache through the graphs, for each body: full and
  chunk-boundary hits bitwise the cold admission, an off-boundary hit
  within 1e-2 of the logits' absmax with equal tokens.
* MLA (deepseek-v2-lite): both tiled tensor-core bodies at the fused
  _kup_vup (M 512 and 128, K 512, N 4096, rank 16) and the ADC's at k_up
  (M 512, K 512, N 2048) against their plain versions and replayed from a
  CUDA graph bitwise equal to eager; the smoke decode and chunk graphs of
  each body replayed bitwise equal to the eager step;
* the paper's CNN experiment (``core/resnet.py``, no kernel of the
  port): the ResNet-20 forward on the card, with calibrated-looking
  adapters, within 1e-4 of absmax of the CPU's on the same parameters
  (TF32 off); the adapters' int8 PTQ bitwise the CPU's; ``run_cell`` on
  the card at the CI config with no kernel launch and the teacher and
  student unchanged by calibration;
* the encoder-decoder family (seamless-m4t-large-v2): both tiled
  tensor-core bodies at the encoder's leaves for its 4096- and 333-row
  admissions (K up to 8192) against their plain versions, the ADC at its
  unfused leaves there, and an engine drive of the full-width model at 2 +
  2 layers with encoder inputs of four lengths on each body: exact
  launches, ``compile_count`` 8 and flat.
* the vision prefix (paligemma-3b): both tiled tensor-core bodies at its
  fused leaves for a vision admission's 256 rows (``down`` at K 16384)
  against their plain versions, the ADC at its unfused leaves at 4 and
  256 rows, and an engine drive of the full-width model at 2 layers with
  three image requests and a text-only one on each body: exact launches,
  ``compile_count`` 5 and flat, every graph (the vision admission's
  included) replayed bitwise equal to its eager step.
* the selective SSM (falcon-mamba-7b) at smoke: an engine drive on each
  body (every admission one eager fused prefill, ``compile_count`` 1: the
  decode tick), the decode graph's replay bitwise its eager step (logits,
  and the f32 ``h`` and ``conv`` compared by their bytes), and
  ``calibrate``'s graph bitwise the eager steps (the SSM blocks recomputed
  in the backward).

This file imports no jax, so it runs where only PyTorch is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import math

import pytest
import torch

from repro_torch.core.rram import program
from repro_torch.kernels import autotune
from repro_torch.kernels import crossbar_mvm as C
from repro_torch.kernels import dora_linear as K
from repro_torch.kernels import ref
from repro_torch.kernels.ref import dora_linear_ref

pytestmark = pytest.mark.gpu

# qwen3-1.7b fused serve leaves: (name, K, N, fused rank)
LEAVES = [("qkv", 2048, 4096, 24), ("o", 2048, 2048, 8),
          ("gate_up", 2048, 12288, 16), ("down", 6144, 2048, 8)]
RAGGED = [(7, 1000, 999, 3), (65, 130, 77, 12), (1, 33, 4097, 1), (130, 257, 31, 5),
          (5, 300, 200, 4), (9, 96, 4096, 2), (17, 1000, 1024, 3)]
# qwen3-1.7b unfused leaves, what codes_adc runs: (name, K, N)
ADC_LEAVES = [("q", 2048, 2048), ("k", 2048, 1024), ("o", 2048, 2048),
              ("gate", 2048, 6144), ("down", 6144, 2048)]
ADC_RAGGED = [(5, 300, 77), (130, 300, 65), (200, 1000, 999), (17, 257, 1024)]
# the ADC kernel's plans at their edges (autotune.adc_plan): shapes whose
# plan splits K: a tile a part (K of 8 and 9 tiles), two (24 tiles),
# uneven parts with a ragged last tile (K = 300, 600, 1000), M over one
# 128-row block, N ragged
ADC_SPLITS = [(4, 2048, 1024), (4, 6144, 2048), (32, 2304, 2048), (200, 1000, 999),
              (1, 300, 77), (96, 2048, 2048), (17, 600, 4097)]
# the tensor-core tiled body: rows around its 128-row tile, and shapes on
# every masked edge (K not a multiple of 8 or 32, N not a multiple of 16 or
# 64, M not a multiple of the tile)
TILED_M = [65, 96, 128, 200, 256, 512]
MASKED = [(96, 130, 77, 8), (200, 257, 31, 5), (150, 300, 999, 3), (65, 2048, 999, 8),
          (100, 257, 4096, 4), (130, 2048, 31, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def operands(m, k, n, r, device, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    xw = program(torch.randn((k, n), generator=g, device=device) * k ** -0.5)
    x = torch.randn((m, k), generator=g, device=device).to(dtype)
    a = (torch.rand((k, r), generator=g, device=device) * 2 - 1) * k ** -0.5
    b = torch.randn((r, n), generator=g, device=device) * 0.05
    gamma = torch.rand((1, n), generator=g, device=device) * 1.5 + 0.5
    return x, xw.g_pos, xw.g_neg, xw.scale, a, b, gamma


def _check(launcher, ops):
    y = launcher(*ops)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, dora_linear_ref(*ops), rtol=1e-4, atol=1e-4)


# every GEMV row bucket: decode ticks and the engine's 8/16/32-row chunks
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_gemv_full_width(cuda, leaf, m):
    _, k, n, r = leaf
    _check(K.dora_linear_gemv, operands(m, k, n, r, cuda))


# the tensor-core GEMV's K split (autotune.gemv_plan) at its edges: a
# single part shorter than a stage (K < 64), parts of unequal length, a
# short last stage, K not a multiple of 8 (masked copies), N ragged or not
# a multiple of the 128-column strip, M ragged in its bucket
GEMV_EDGES = [(4, 40, 4096, 8), (5, 1000, 2048, 8), (9, 2050, 999, 3), (17, 6144, 2049, 8),
              (33, 2048, 2064, 4), (64, 100, 300, 24), (1, 300, 130, 1)]


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_tensor_core_gemv_is_bitwise_repeatable(cuda, leaf, m):
    _, k, n, r = leaf
    ops = operands(m, k, n, r, cuda, seed=m + 1)
    assert torch.equal(K.dora_linear_gemv(*ops), K.dora_linear_gemv(*ops))


@pytest.mark.parametrize("shape", GEMV_EDGES)
def test_tensor_core_gemv_k_split_edges(cuda, shape):
    m, k, n, r = shape
    ops = operands(m, k, n, r, cuda, seed=k + n)
    _check(K.dora_linear_gemv, ops)
    assert torch.equal(K.dora_linear_gemv(*ops), K.dora_linear_gemv(*ops))


def _kernels_of_one_call(fn, calls=3, window_s=0.02):
    """Names of the kernels one call ``fn()`` launches, in launch order
    (torch.profiler, after a warm-up call), or None where the profiler
    recorded no whole call. Deep in this file's run the profiler has been
    seen to start late, missing the first kernels of a window
    (``adc_sum_kernel`` alone of three) or all of them; so one window runs
    calls for ``window_s`` seconds (at least ``calls`` of them), each
    between two marker kernels (int16 fills), synchronized, and the kernels
    read are those between the last two markers it recorded."""
    import re
    import time

    from torch.profiler import ProfilerActivity, profile

    mark = torch.empty(1, dtype=torch.int16, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, done = time.perf_counter(), 0
        while done < calls or time.perf_counter() - t0 < window_s:
            mark.fill_(7)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            done += 1
        mark.fill_(7)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "FillFunctor<short>" in e.name]
    if len(marks) < 2:
        return None
    names = [re.search(r"(\w+_kernel)", e.name) for e in events[marks[-2] + 1:marks[-1]]]
    return [n.group(1) if n else "?" for n in names]


def _gemv_kernels(ops, accum, launcher=K.dora_linear_gemv):
    """Names of the kernels one call of ``launcher`` (the GEMV by default)
    launches (torch.profiler), or None where it records nothing."""
    return _kernels_of_one_call(lambda: launcher(*ops, accum=accum))


@pytest.mark.parametrize("dtype,accum,shape,kernels", [
    (torch.bfloat16, "f32", (2048, 2048), ["dora_gemv_mma_kernel"]),
    (torch.float32, "f32", (2048, 2048), ["prep_kernel", "dora_gemv_kernel"]),
    (torch.bfloat16, "int8", (2048, 2048), ["dora_gemv_int8_kernel"]),
    (torch.float32, "int8", (2048, 2048), ["dora_gemv_int8_kernel"]),
    (torch.float32, "f32", (6144, 8), ["dora_narrow_kernel"]),
    (torch.float32, "f32", (2048, 64), ["dora_narrow_kernel"]),
])
def test_gemv_body_per_x_type(cuda, dtype, accum, shape, kernels):
    """At the decode tick (M = 4), bf16 x with the f32 body runs the
    tensor-core GEMV alone (one launch, X @ A included), and so does the
    int8 body with bf16 or f32 x (row scales in the launch too); f32 x
    with the f32 body keeps the SIMT body behind its prologue at N = 2048
    and runs the narrow body alone at the routers' shapes (N = 8, 64);
    each call counts one launch."""
    assert not autotune.gemv_int8_prescale(4)
    ops = operands(4, *shape, 8, cuda, dtype=dtype)
    names = _gemv_kernels(ops, accum)
    if names is None:
        pytest.skip("the profiler recorded no device activity")
    assert names == kernels
    K.reset_launch_counts()
    K.dora_linear_gemv(*ops, accum=accum)
    assert K.launch_counts()[K.counter("dora_linear_gemv", accum)] == 1
    assert sum(K.launch_counts().values()) == 1


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64])
def test_int8_gemv_prescale_runs_its_pass_first(cuda, m):
    """From GEMV_INT8_PRESCALE_ROWS rows the int8 GEMV runs the row-scale
    pass, then its kernel; below, the kernel alone."""
    names = _gemv_kernels(operands(m, 2048, 2048, 8, cuda), "int8")
    if not names:
        pytest.skip("the profiler recorded no device activity")
    pre = ["row_scale_kernel"] if autotune.gemv_int8_prescale(m) else []
    assert names == pre + ["dora_gemv_int8_kernel"]


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_int8_tensor_core_gemv_is_bitwise_repeatable(cuda, leaf, m):
    _, k, n, r = leaf
    ops = operands(m, k, n, r, cuda, seed=m + 1)
    assert torch.equal(K.dora_linear_gemv(*ops, accum="int8"),
                       K.dora_linear_gemv(*ops, accum="int8"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GEMV_EDGES)
def test_int8_tensor_core_gemv_k_split_edges(cuda, shape, dtype):
    m, k, n, r = shape
    ops = operands(m, k, n, r, cuda, dtype=dtype, seed=k + n)
    _check_int8(K.dora_linear_gemv, ops)
    assert torch.equal(K.dora_linear_gemv(*ops, accum="int8"),
                       K.dora_linear_gemv(*ops, accum="int8"))


@pytest.mark.parametrize("m,k,n", [(4, 6144, 2048), (32, 2048, 4096), (64, 512, 300)])
def test_int8_gemv_exactness_with_split_k(cuda, m, k, n):
    assert autotune.gemv_plan(m, n, k, "int8") > 1
    ops = _exact_int8(m, k, n, cuda)
    assert torch.equal(K.dora_linear_gemv(*ops, accum="int8"), ref.dora_linear_int8_ref(*ops))


@pytest.mark.parametrize("shape", [(4, 2048, 4096, 24), (4, 6144, 2048, 8), (32, 2048, 2048, 8),
                                   (17, 1000, 999, 3), (1, 300, 130, 1)])
def test_int8_gemv_result_is_independent_of_the_plan(cuda, shape, monkeypatch):
    """Parts of K, and row scales taken inside the launch or by a pass
    before it, give the same bits: the int32 sums are exact and the row
    scales the same in every block."""
    m, k, n, r = shape
    ops = operands(m, k, n, r, cuda, seed=k)
    want = K.dora_linear_gemv(*ops, accum="int8")
    stages = -(-k // autotune.GEMV_MMA_STAGE)
    for parts in sorted({1, 2, min(3, stages), stages}):
        for pre in (False, True):
            monkeypatch.setattr(autotune, "gemv_plan", lambda *_, p=parts: p)
            monkeypatch.setattr(autotune, "gemv_int8_prescale", lambda *_, q=pre: q)
            assert torch.equal(K.dora_linear_gemv(*ops, accum="int8"), want), (parts, pre)


def test_int8_gemv_leaves_its_tickets_zero_and_replays(cuda):
    """The int8 GEMV's tickets are zero after every launch, so a CUDA graph
    of the call replays to the eager result."""
    ops = operands(4, 2048, 4096, 24, cuda, seed=3)
    want = K.dora_linear_gemv(*ops, accum="int8")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        K.dora_linear_gemv(*ops, accum="int8")
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = K.dora_linear_gemv(*ops, accum="int8")
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert all(int(sem.abs().sum()) == 0 for _, sem in K._SEMS.values())


def test_int8_gemv_graphs_hold_tickets_of_their_own(cuda):
    """Two int8 GEMV graphs captured after a wider eager call replay at
    once on two streams, each to its eager result."""
    K.dora_linear_gemv(*operands(4, 2048, 12288, 16, cuda, seed=5), accum="int8")
    leaves = [operands(4, 2048, 2048, 8, cuda, seed=6), operands(4, 6144, 2048, 8, cuda, seed=7)]
    wants = [K.dora_linear_gemv(*ops, accum="int8") for ops in leaves]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for ops in leaves:
            K.dora_linear_gemv(*ops, accum="int8")
    torch.cuda.current_stream().wait_stream(side)
    graphs, gots = [], []
    for ops in leaves:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            gots.append(K.dora_linear_gemv(*ops, accum="int8"))
    K.dora_linear_gemv(*operands(4, 2048, 12288, 16, cuda, seed=8), accum="int8")
    streams = [torch.cuda.Stream() for _ in graphs]
    for _ in range(5):
        for stream, graph in zip(streams, graphs):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(gots, wants):
            assert torch.equal(got, want)


def test_tensor_core_gemv_leaves_its_tickets_zero_and_replays(cuda):
    """The tickets are zero after every launch, so a CUDA graph of the call
    replays to the eager result."""
    ops = operands(4, 2048, 4096, 24, cuda, seed=3)
    want = K.dora_linear_gemv(*ops)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        K.dora_linear_gemv(*ops)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = K.dora_linear_gemv(*ops)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert all(int(sem.abs().sum()) == 0 for _, sem in K._SEMS.values())


def test_tensor_core_gemv_graphs_hold_tickets_of_their_own(cuda):
    """Two graphs captured the default way (one capture stream) after a
    wider eager call replay at once on two streams, each to its eager
    result: every capture holds its own tickets, and the eager tickets,
    widened first, are not the graphs'."""
    K.dora_linear_gemv(*operands(4, 2048, 12288, 16, cuda, seed=5))
    leaves = [operands(4, 2048, 2048, 8, cuda, seed=6), operands(4, 2048, 4096, 24, cuda, seed=7)]
    wants = [K.dora_linear_gemv(*ops) for ops in leaves]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for ops in leaves:
            K.dora_linear_gemv(*ops)
    torch.cuda.current_stream().wait_stream(side)
    graphs, gots = [], []
    for ops in leaves:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            gots.append(K.dora_linear_gemv(*ops))
    K.dora_linear_gemv(*operands(4, 2048, 12288, 16, cuda, seed=8))  # eager, after capture
    streams = [torch.cuda.Stream() for _ in graphs]
    for _ in range(5):
        for stream, graph in zip(streams, graphs):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(gots, wants):
            assert torch.equal(got, want)


@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_tiled_full_width(cuda, leaf):
    _, k, n, r = leaf
    _check(K.dora_linear, operands(256, k, n, r, cuda))


@pytest.mark.parametrize("m", TILED_M)
@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_tensor_core_tiled_full_width(cuda, leaf, m):
    _, k, n, r = leaf
    _check(K.dora_linear, operands(m, k, n, r, cuda, seed=m))


@pytest.mark.parametrize("shape", MASKED)
def test_tensor_core_tiled_masked_edges(cuda, shape):
    m, k, n, r = shape
    _check(K.dora_linear, operands(m, k, n, r, cuda, seed=k + n))


@pytest.mark.parametrize("shape", [(96, 2048, 2048, 8), (256, 6144, 2048, 8),
                                   (512, 2048, 4096, 24), (150, 300, 999, 3)])
def test_tensor_core_tiled_is_bitwise_repeatable(cuda, shape):
    ops = operands(*shape, cuda)
    assert torch.equal(K.dora_linear(*ops), K.dora_linear(*ops))


@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_f32_x_tiled_full_width(cuda, leaf):
    _, k, n, r = leaf
    _check(K.dora_linear, operands(256, k, n, r, cuda, dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RAGGED)
def test_ragged_shapes(cuda, shape, dtype):
    m, k, n, r = shape
    ops = operands(m, k, n, r, cuda, dtype=dtype, seed=m)
    _check(K.dora_linear, ops)
    if autotune.use_gemv(m):
        _check(K.dora_linear_gemv, ops)


def test_cuda_tensor_never_reaches_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(K, "dora_linear_ref", refuse)
    ops = operands(3, 64, 96, 2, cuda)
    K.reset_launch_counts()
    K.dora_linear_gemv(*ops)
    K.dora_linear(*ops)
    torch.cuda.synchronize()
    assert K.launch_counts() == {"dora_linear_gemv": 1, "dora_linear": 1,
                                 "dora_linear_gemv/int8": 0, "dora_linear/int8": 0}


def test_wrapper_rejects_bad_operands(cuda):
    x, gp, gn, scale, a, b, gamma = operands(2, 64, 32, 2, cuda)
    with pytest.raises(ValueError, match="g_pos"):
        K.dora_linear(x, gp.to(torch.int32), gn, scale, a, b, gamma)
    with pytest.raises(ValueError, match="contiguous"):
        K.dora_linear(x.t().contiguous().t(), gp, gn, scale, a, b, gamma)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.dora_linear(x.half(), gp, gn, scale, a, b, gamma)


def test_serving_on_card_runs_both_launchers(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, ServeEngine

    cfg = get_arch("qwen3_1_7b").smoke
    session = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24).serve()
    K.reset_launch_counts()
    engine = ServeEngine(session, max_slots=2, max_len=64, prefix_cache_entries=0)
    reqs = [engine.submit(torch.arange(n) % cfg.vocab, max_new=6) for n in (3, 40)]
    engine.run()
    logits, _ = session.prefill(torch.randint(0, cfg.vocab, (3, 30), device=cuda), 40)
    counts = K.launch_counts()
    assert all(len(r.tokens) == 6 for r in reqs)
    assert torch.isfinite(logits.float()).all()
    assert counts["dora_linear_gemv"] > 0 and counts["dora_linear"] > 0


def _check_int8(launcher, ops):
    y = launcher(*ops, accum="int8")
    torch.cuda.synchronize()
    want = ref.dora_linear_int8_ref(*ops)
    assert float((y - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_int8_gemv_full_width(cuda, leaf, m):
    _, k, n, r = leaf
    _check_int8(K.dora_linear_gemv, operands(m, k, n, r, cuda))


@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_int8_tiled_full_width(cuda, leaf):
    _, k, n, r = leaf
    _check_int8(K.dora_linear, operands(256, k, n, r, cuda))


@pytest.mark.parametrize("shape", RAGGED)
def test_int8_ragged_shapes(cuda, shape):
    m, k, n, r = shape
    ops = operands(m, k, n, r, cuda, dtype=torch.float32, seed=m)
    _check_int8(K.dora_linear, ops)
    if autotune.use_gemv(m):
        _check_int8(K.dora_linear_gemv, ops)


def _exact_int8(m, k, n, device):
    g = torch.Generator(device=device).manual_seed(m)
    x = torch.randint(-127, 128, (m, k), generator=g, device=device).to(torch.float32)
    x[:, 0] = 127.0
    gp, gn = (torch.randint(0, 256, (k, n), generator=g, device=device, dtype=torch.uint8)
              for _ in range(2))
    one = torch.ones((1, n), device=device)
    return x, gp, gn, one, torch.zeros((k, 1), device=device), torch.zeros((1, n), device=device), one


@pytest.mark.parametrize("m,k,n", [(4, 512, 256), (64, 512, 300), (100, 300, 77), (256, 512, 2048)])
def test_int8_exactness_case(cuda, m, k, n):
    ops = _exact_int8(m, k, n, cuda)
    want = ref.dora_linear_int8_ref(*ops)
    assert torch.equal(K.dora_linear(*ops, accum="int8"), want)
    if autotune.use_gemv(m):
        assert torch.equal(K.dora_linear_gemv(*ops, accum="int8"), want)


@pytest.mark.parametrize("m", TILED_M)
@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_int8_tensor_core_tiled_full_width(cuda, leaf, m):
    _, k, n, r = leaf
    _check_int8(K.dora_linear, operands(m, k, n, r, cuda, seed=m))


@pytest.mark.parametrize("shape", MASKED)
def test_int8_tensor_core_tiled_masked_edges(cuda, shape):
    m, k, n, r = shape
    _check_int8(K.dora_linear, operands(m, k, n, r, cuda, seed=k + n))


@pytest.mark.parametrize("shape", [(96, 2048, 2048, 8), (256, 6144, 2048, 8),
                                   (512, 2048, 4096, 24), (150, 300, 999, 3)])
def test_int8_tensor_core_tiled_is_bitwise_repeatable(cuda, shape):
    ops = operands(*shape, cuda)
    assert torch.equal(K.dora_linear(*ops, accum="int8"), K.dora_linear(*ops, accum="int8"))


@pytest.mark.parametrize("m,k,n", [(100, 300, 77), (256, 512, 2048), (130, 6144, 2048)])
def test_int8_tensor_core_exactness_with_split_k(cuda, m, k, n):
    assert autotune.tiled_tiles(m, n, k, "int8").splits(k) > 1
    ops = _exact_int8(m, k, n, cuda)
    assert torch.equal(K.dora_linear(*ops, accum="int8"), ref.dora_linear_int8_ref(*ops))


def _check_adc(x, gp, gn, scale):
    y = C.crossbar_mvm(x, gp, gn, scale)
    torch.cuda.synchronize()
    bad, flips = ref.adc_disagreement(y, ref.crossbar_mvm_ref(x, gp, gn, scale), x, scale)
    assert bad == 0 and flips <= 1e-3 * y.numel(), (bad, flips)


@pytest.mark.parametrize("m", [1, 4, 32, 96, 256])
@pytest.mark.parametrize("leaf", ADC_LEAVES, ids=[lf[0] for lf in ADC_LEAVES])
def test_adc_full_width(cuda, leaf, m):
    _, k, n = leaf
    _check_adc(*operands(m, k, n, 1, cuda, seed=m + k)[:4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ADC_RAGGED)
def test_adc_ragged_shapes(cuda, shape, dtype):
    m, k, n = shape
    _check_adc(*operands(m, k, n, 1, cuda, dtype=dtype, seed=m)[:4])


@pytest.mark.parametrize("m,k,n", [(4, 2048, 512), (130, 300, 65), (256, 6144, 300)])
def test_adc_exactness_case(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randint(-127, 128, (m, k), generator=g, device=cuda).to(torch.float32)
    x[::128, ::256] = 127.0
    gp, gn = (torch.randint(0, 256, (k, n), generator=g, device=cuda, dtype=torch.uint8)
              for _ in range(2))
    one = torch.ones((1, n), device=cuda)
    assert torch.all(ref.adc_steps(x) == 4080.0)
    assert torch.equal(C.crossbar_mvm(x, gp, gn, one), ref.crossbar_mvm_ref(x, gp, gn, one))


def _exact_adc(m, k, n, device):
    g = torch.Generator(device=device).manual_seed(k)
    x = torch.randint(-127, 128, (m, k), generator=g, device=device).to(torch.float32)
    x[::128, ::256] = 127.0
    gp, gn = (torch.randint(0, 256, (k, n), generator=g, device=device, dtype=torch.uint8)
              for _ in range(2))
    return x, gp, gn, torch.ones((1, n), device=device)


@pytest.mark.parametrize("m,k,n", [(4, 2048, 512), (130, 300, 65), (96, 2048, 1024),
                                   (256, 6144, 300)])
def test_adc_exactness_case_bf16(cuda, m, k, n):
    """Integer x in [-127, 127] is exact in bf16 and every tile current is
    an integer below 2^24: the tensor-core body is bitwise exact."""
    x, gp, gn, one = _exact_adc(m, k, n, cuda)
    x = x.to(torch.bfloat16)
    assert torch.all(ref.adc_steps(x) == 4080.0)
    assert torch.equal(C.crossbar_mvm(x, gp, gn, one), ref.crossbar_mvm_ref(x, gp, gn, one))


@pytest.mark.parametrize("m", [1, 4, 32, 96, 256])
@pytest.mark.parametrize("leaf", ADC_LEAVES, ids=[lf[0] for lf in ADC_LEAVES])
def test_adc_tensor_core_is_bitwise_repeatable(cuda, leaf, m):
    _, k, n = leaf
    ops = operands(m, k, n, 1, cuda, seed=m + n)[:4]
    assert torch.equal(C.crossbar_mvm(*ops), C.crossbar_mvm(*ops))


@pytest.mark.parametrize("shape", ADC_SPLITS)
def test_adc_result_is_independent_of_the_plan(cuda, shape, monkeypatch):
    """Splits of K on 256-row tiles give the same bits: each tile's
    current is summed the same way by whichever block owns it, and the
    digitized partials are added in tile order."""
    m, k, n = shape
    ops = operands(m, k, n, 1, cuda, seed=k)[:4]
    assert autotune.adc_plan(m, k, n) > 1
    want = C.crossbar_mvm(*ops)
    tiles = -(-k // autotune.ADC_ARRAY_ROWS)
    for parts in (1, min(tiles, 2), min(tiles, 3), tiles):
        monkeypatch.setattr(autotune, "adc_plan", lambda *_, p=parts: p)
        assert torch.equal(C.crossbar_mvm(*ops), want), parts


def test_adc_graphs_replay_with_tickets_of_their_own(cuda):
    """Two ADC calls whose plans split K, each captured in its own CUDA
    graph, replay at once on two streams to their eager results, and the
    tickets are zero again after every launch."""
    leaves = [operands(4, 2048, 2048, 1, cuda, seed=5)[:4],
              operands(4, 6144, 2048, 1, cuda, seed=6)[:4]]
    assert all(autotune.adc_plan(4, o[1].shape[0], o[1].shape[1]) > 1 for o in leaves)
    wants = [C.crossbar_mvm(*ops) for ops in leaves]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for ops in leaves:
            C.crossbar_mvm(*ops)
    torch.cuda.current_stream().wait_stream(side)
    graphs, gots = [], []
    for ops in leaves:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            gots.append(C.crossbar_mvm(*ops))
    streams = [torch.cuda.Stream() for _ in graphs]
    for _ in range(5):
        for stream, graph in zip(streams, graphs):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(gots, wants):
            assert torch.equal(got, want)
    assert all(int(sem.abs().sum()) == 0 for _, sem in C._SEMS.values())


@pytest.mark.parametrize("dtype,shape,kernels", [
    (torch.bfloat16, (2048, 2048), ["adc_mma_kernel"]),
    (torch.float32, (2048, 2048), ["adc_step_kernel", "adc_tile_kernel", "adc_sum_kernel"]),
    (torch.float32, (6144, 8), ["adc_narrow_kernel"]),
    (torch.float32, (2048, 64), ["adc_narrow_kernel"]),
])
def test_adc_body_per_x_type(cuda, dtype, shape, kernels):
    """bf16 x runs the tensor-core body alone (one launch); f32 x keeps the
    three-launch SIMT body at N = 2048 and runs the narrow body alone at the
    routers' shapes (N = 8, 64); each call counts one launch."""
    ops = operands(4, *shape, 1, cuda, dtype=dtype)[:4]
    names = _kernels_of_one_call(lambda: C.crossbar_mvm(*ops))
    if names is None:
        pytest.skip("the profiler recorded no device activity")
    assert names == kernels
    C.reset_launch_counts()
    C.crossbar_mvm(*ops)
    assert C.launch_counts() == {"crossbar_mvm": 1}


def test_adc_cuda_tensor_never_reaches_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(C, "crossbar_mvm_ref", refuse)
    monkeypatch.setattr(K, "dora_linear_int8_ref", refuse)
    x, gp, gn, scale, a, b, gamma = operands(3, 300, 96, 2, cuda)
    K.reset_launch_counts()
    C.reset_launch_counts()
    C.crossbar_mvm(x, gp, gn, scale)
    K.dora_linear_gemv(x, gp, gn, scale, a, b, gamma, accum="int8")
    K.dora_linear(x, gp, gn, scale, a, b, gamma, accum="int8")
    torch.cuda.synchronize()
    assert C.launch_counts() == {"crossbar_mvm": 1}
    assert K.launch_counts() == {"dora_linear_gemv": 0, "dora_linear": 0,
                                 "dora_linear_gemv/int8": 1, "dora_linear/int8": 1}


def test_int8_and_adc_serving_on_card(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, ServeEngine

    cfg = get_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    adc = Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes, dep.adapters,
                     dep.teacher_seed, dep.program_seed, dep.drift_hours)
    for session, key in ((dep.serve(accum="int8"), "dora_linear_gemv/int8"),
                         (adc.serve(), "crossbar_mvm")):
        K.reset_launch_counts()
        C.reset_launch_counts()
        engine = ServeEngine(session, max_slots=2, max_len=64, prefix_cache_entries=0)
        reqs = [engine.submit(torch.arange(n) % cfg.vocab, max_new=6) for n in (3, 40)]
        engine.run()
        counts = {**K.launch_counts(), **C.launch_counts()}
        assert all(len(r.tokens) == 6 for r in reqs)
        assert counts[key] > 0 and sum(counts.values()) == counts[key], counts


# -- calibration on the card (autograd under dequant, then serving) ------------

# per-step calibration losses, card vs CPU, relative: the bf16 config as
# shipped; cuBLAS and the CPU round bf16 matmuls differently (the port vs
# the reference on the CPU: up to 1.2e-3, tests/test_torch_calibrate.py)
CALIB_LOSS_RTOL = 1e-2
# calibrated logits through the kernels (card) vs dequant (CPU), of the
# absmax: bf16 activations over 4 layers (tests/test_torch_model.py's bound)
CALIB_LOGITS_BOUND = 3e-2


def _twin_deployments(cuda):
    """The same smoke deployment (codes, 24 h of drift) on the CPU and on
    the card."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment

    cfg = get_arch("qwen3_1_7b").smoke
    cpu = Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24)
    on = lambda t: tree_lib.map_tensors(lambda v: v.to(cuda), t)  # noqa: E731
    card = Deployment(cfg, "codes", on(cpu.teacher_base), on(cpu.codes), on(cpu.adapters),
                      cpu.teacher_seed, cpu.program_seed, cpu.drift_hours)
    return cfg, cpu, card


def test_calibrate_on_card_matches_cpu_and_launches_nothing(cuda):
    from repro_torch import tree as tree_lib
    from repro_torch.deploy import calibration_batch

    cfg, cpu, card = _twin_deployments(cuda)
    batch = calibration_batch(cfg, 4, 16)
    codes = [t.clone() for t in tree_lib.tensors(card.codes)]
    K.reset_launch_counts()
    C.reset_launch_counts()
    got = card.calibrate(batch, steps=5)
    torch.cuda.synchronize()
    assert set(K.launch_counts().values()) == {0}
    assert C.launch_counts() == {"crossbar_mvm": 0}
    assert all(torch.equal(a, b) for a, b in zip(codes, tree_lib.tensors(card.codes)))
    assert all(t.device.type == "cuda" and not t.requires_grad
               for t in tree_lib.tensors(card.adapters))
    want = cpu.calibrate(batch, steps=5)
    assert got.final_loss < got.initial_loss
    torch.testing.assert_close(torch.tensor(got.losses), torch.tensor(want.losses),
                               rtol=CALIB_LOSS_RTOL, atol=0)


def test_calibrated_deployment_served_through_kernels_matches_dequant(cuda):
    """After calibration on the card, the side-cars (trained B, gamma off
    the clean norm) served through the kernels, f32 and int8 bodies, GEMV
    and tiled launchers, against dequant on the CPU over the same codes
    and adapters."""
    from repro_torch import tree as tree_lib
    from repro_torch.deploy import Deployment, calibration_batch

    cfg, cpu, card = _twin_deployments(cuda)
    card.calibrate(calibration_batch(cfg, 4, 16), steps=5)
    ref = Deployment(cfg, "dequant", cpu.teacher_base, cpu.codes,
                     tree_lib.map_tensors(lambda t: t.cpu(), card.adapters),
                     cpu.teacher_seed, cpu.program_seed, cpu.drift_hours).serve()
    g = torch.Generator().manual_seed(3)
    for rows, launcher in ((3, "dora_linear_gemv"), (30, "dora_linear")):
        tokens = torch.randint(0, cfg.vocab, (3, rows), generator=g)
        want, _ = ref.prefill(tokens, rows + 8)
        for accum in ("f32", "int8"):
            K.reset_launch_counts()
            got, _ = card.serve(accum=accum).prefill(tokens.to(cuda), rows + 8)
            torch.cuda.synchronize()
            key = launcher if accum == "f32" else f"{launcher}/int8"
            assert K.launch_counts()[key] > 0, (accum, K.launch_counts())
            err = float((got.float().cpu() - want.float()).abs().max())
            bound = CALIB_LOGITS_BOUND if accum == "f32" else 0.25  # int8: chip_smoke's bound
            assert err <= bound * float(want.float().abs().max()), (rows, accum, err)


def _eager_calibration(dep, start, batch, steps, cached, stream):
    """``steps`` eager steps (``make_cached_calib_step`` or ``make_calib_step``)
    from the ``(adapters, opt_state)`` copies ``start`` on ``stream``, under
    dequant: (losses, final CalibState)."""
    from repro_torch import substrate
    from repro_torch.core import calibrate as calib
    from repro_torch.optim.adam import AdamW

    cfg, opt = dep.cfg, AdamW(lr=1e-3)
    state = calib.CalibState(dep.teacher_base, dep.base, *start, 0)
    stream.wait_stream(torch.cuda.current_stream())
    losses = []
    with torch.cuda.stream(stream), substrate.use_backend("dequant"):
        if cached:
            feats = calib.teacher_features(dep.teacher_base, batch, cfg)
            step = calib.make_cached_calib_step(cfg, opt)
            run = lambda s: step(s, feats, batch)  # noqa: E731
        else:
            step = calib.make_calib_step(cfg, opt)
            run = lambda s: step(s, batch)  # noqa: E731
        for _ in range(steps):
            state, metrics = run(state)
            losses.append(float(metrics["loss"]))
    torch.cuda.current_stream().wait_stream(stream)
    return losses, state


def _count_captures(monkeypatch):
    from repro_torch import graphs

    captures = []
    capture = graphs.capture

    def counted(*args, **kwargs):
        captures.append(1)
        return capture(*args, **kwargs)

    monkeypatch.setattr(graphs, "capture", counted)
    return captures


def _allocated():
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "fused"])
def test_calibrate_graph_is_bitwise_the_eager_steps(cuda, cached, monkeypatch):
    """``calibrate`` through its CUDA graph (step 1 eager, one capture, then
    replays) against the eager step functions run on the same stream from
    the same start: losses, adapters and AdamW state bitwise; no kernel
    launch; one capture."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, calibration_batch
    from repro_torch.deploy import deployment as D
    from repro_torch.optim.adam import adamw_init

    cfg = get_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    batch = calibration_batch(cfg, 4, 16)
    start = tree_lib.map_tensors(torch.clone, dep.adapters)
    start = (start, adamw_init(start))
    captures = _count_captures(monkeypatch)
    K.reset_launch_counts()
    C.reset_launch_counts()
    report = dep.calibrate(batch, steps=6, cached_teacher=cached)
    torch.cuda.synchronize()
    assert set(K.launch_counts().values()) == {0} and C.launch_counts() == {"crossbar_mvm": 0}
    assert len(captures) == 1
    losses, state = _eager_calibration(dep, start, D._device_batch(batch, cuda), 6, cached,
                                       dep._calib_stream())
    assert report.losses == losses, (report.losses, losses)
    for want, got in ((state.adapters, dep.adapters), ([*state.opt_state], [*dep.opt_state])):
        assert all(torch.equal(a, b) for a, b in zip(tree_lib.tensors(want),
                                                     tree_lib.tensors(got)))
    assert not any(t.requires_grad for t in tree_lib.tensors(dep.adapters))


def test_second_calibrate_after_advance_captures_anew(cuda, monkeypatch):
    """After ``advance`` the codes are new tensors: the next call captures a
    graph of its own and continues the optimizer; the memory allocated
    after a call is back within the adapters' and the AdamW state's bytes
    (the graph's pool released)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, calibration_batch

    cfg = get_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    batch = calibration_batch(cfg, 4, 16)
    captures = _count_captures(monkeypatch)
    first = dep.calibrate(batch, steps=4)
    dep.advance(24)
    before = _allocated()
    second = dep.calibrate(batch, steps=4)
    after = _allocated()
    assert len(captures) == 2
    assert dep.step == 8 and int(dep.opt_state.step) == 8
    assert second.drift_events == 2 and all(map(math.isfinite, first.losses + second.losses))
    held = sum(t.numel() * t.element_size()
               for t in tree_lib.tensors([dep.adapters, *dep.opt_state]))
    assert abs(after - before) <= held, (before, after, held)


# -- the compiled-step registry: CUDA graphs of the decode tick and chunks ----


def _smoke_sessions(cuda):
    """f32 codes, int8 codes and codes_adc over one smoke deployment (24 h
    of drift) on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment

    cfg = get_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    adc = Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes, dep.adapters,
                     dep.teacher_seed, dep.program_seed, dep.drift_hours)
    return {"f32": dep.serve(), "int8": dep.serve(accum="int8"), "codes_adc": adc.serve()}


# ragged prompts whose chunks fill every bucket: 5 -> 8, 9 -> 16, 17 -> 32
# and 40 -> 32 + 8 rows (two chunks)
STEP_PROMPTS = (5, 9, 17, 40)


def _drive(session, max_new=6):
    """STEP_PROMPTS through a 4-slot engine, one submit a tick; the
    requests and the kernels' launch counts of the run. The prompts share
    prefixes (``arange``), so the prefix cache is off: every admission is
    cold and fills its bucket."""
    from repro_torch.deploy import ServeEngine

    engine = ServeEngine(session, max_slots=4, max_len=64, prefix_cache_entries=0)
    K.reset_launch_counts()
    C.reset_launch_counts()
    reqs = []
    for n in STEP_PROMPTS:
        reqs.append(engine.submit(torch.arange(n) % session.cfg.vocab, max_new=max_new))
        engine.step()
    engine.run()
    torch.cuda.synchronize()
    assert all(r.done and len(r.tokens) == max_new for r in reqs)
    return [list(r.tokens) for r in reqs], {**K.launch_counts(), **C.launch_counts()}, engine


def _replay_equals_eager(step, host):
    """Replay the captured ``step`` on ``host`` inputs, then run its
    function eagerly from a copy of the same cache: (logits equal, cache
    equal), bitwise."""
    assert step.graph is not None
    saved = step.flat.clone()
    got = step(host).clone()
    got_cache = step.flat.clone()
    step.flat.copy_(saved)
    want = step.fn()
    torch.cuda.synchronize()
    return torch.equal(got, want), torch.equal(got_cache, step.flat)


def _steps_by_kind(session):
    return {(s.key[0], s.key[3]): s for s in session.steps}


def _check_replays(session, seed=0):
    g = torch.Generator().manual_seed(seed)
    steps = _steps_by_kind(session)
    assert set(steps) == {("decode", 1), ("prefill_chunk", 8), ("prefill_chunk", 16),
                          ("prefill_chunk", 32)}, set(steps)
    vocab = session.cfg.vocab
    for (kind, width), step in steps.items():
        if kind == "decode":
            host = torch.stack([torch.randint(0, vocab, (4,), generator=g),
                                torch.tensor([3, 17, 40, 62])])
        else:
            host = torch.cat([torch.randint(0, vocab, (width,), generator=g),
                              torch.tensor([64 - width // 2 - 1, width // 2 + 1])])
        assert _replay_equals_eager(step, host) == (True, True), (kind, width)


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_step_replays_are_bitwise_the_eager_step(cuda, body):
    """The decode graph and the chunk graphs (8, 16, 32 rows) replay
    bitwise equal to the eager step, logits and cache, on copies of the
    same cache and inputs (a chunk bucket that overruns the cache too)."""
    session = _smoke_sessions(cuda)[body]
    _drive(session)
    _check_replays(session)


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_compile_count_is_flat_on_a_second_drive(cuda, body):
    session = _smoke_sessions(cuda)[body]
    streams, counts, engine = _drive(session)
    warm = session.compile_count()
    assert warm == 4  # the decode tick and the buckets 8, 16, 32
    del engine
    again, counts_again, engine = _drive(session)
    assert session.compile_count() == engine.stats()["compile_count"] == warm
    assert again == streams and counts_again == counts


@pytest.mark.parametrize("body,key", [("f32", "dora_linear_gemv"),
                                      ("int8", "dora_linear_gemv/int8"),
                                      ("codes_adc", "crossbar_mvm")])
def test_graph_launch_counts_equal_the_eager_run(cuda, body, key, monkeypatch):
    """The launch counters after a run through the graphs (the first call
    of each step eager, replays counted) equal a run that issues every step
    eagerly, and the streams agree."""
    from repro_torch.deploy import serving

    session = _smoke_sessions(cuda)[body]
    streams, counts, engine = _drive(session)
    steps = engine.stats()["prefill_chunks"] + engine.stats()["decode_steps"]
    per_step = session.cfg.n_layers * (7 if body == "codes_adc" else 4)
    assert counts[key] == per_step * steps and sum(counts.values()) == counts[key], counts

    def eager(self, host):
        self.inputs.copy_(host)
        return self.fn()

    monkeypatch.setattr(serving.CompiledStep, "__call__", eager)
    eager_streams, eager_counts, _ = _drive(session)
    assert eager_counts == counts and eager_streams == streams


def test_error_inside_a_captured_function_propagates(cuda):
    """An error in the eager first call or in the capture propagates; a
    step whose capture failed raises on every later call (nothing runs on
    eagerly) and counts as no compilation; a sync inside a capture is the
    card's error, raised too."""
    from repro_torch.deploy.serving import CompiledStep, StepRegistry

    reg = StepRegistry(cuda, lambda: {})
    x = torch.ones(8, device=cuda)
    calls = []

    def fn():
        calls.append(len(calls))
        if len(calls) in (1, 3):
            raise ValueError(f"call {len(calls)}")
        return x * 2

    inputs = torch.zeros(1, dtype=torch.int64, device=cuda)
    step = reg.get(("boom",), lambda: CompiledStep(reg, ("boom",), fn, inputs))
    host = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="call 1"):  # the eager first call
        step(host)
    with pytest.raises(ValueError, match="call 3"):  # warm-up (2) passed, capture (3) raised
        step(host)
    with pytest.raises(RuntimeError, match="failed to capture"):
        step(host)
    assert len(calls) == 3 and reg.compile_count() == 0 and step.graph is None

    def sync():
        return x * float(x.sum())  # reads the card on the host: not capturable

    bad = reg.get(("sync",), lambda: CompiledStep(reg, ("sync",), sync, inputs.clone()))
    with pytest.raises(RuntimeError):
        bad(host)
    assert reg.compile_count() == 0
    torch.cuda.synchronize()
    assert float((x * 3).sum()) == 24.0  # the card still works


def test_replays_equal_eager_with_rope_cache_cleared_first(cuda):
    """``rope_frequencies`` is cached per device: cleared before the
    session's first step, it is filled by the eager first call, never
    inside a capture, and the replays still equal the eager step."""
    from repro_torch.models import layers as L

    session = _smoke_sessions(cuda)["f32"]
    L.rope_frequencies.cache_clear()
    streams, _, _ = _drive(session)
    assert L.rope_frequencies.cache_info().currsize > 0
    _check_replays(session, seed=1)
    again, _, _ = _drive(session)
    assert again == streams


# -- device faults: the card's view and draws ----------------------------------

FAULT_CASES = ("stuck_at", "saturated", "retention", "iv_nonlinearity", "composite")


def _faulted_smoke(cuda, kinds):
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment
    from repro_torch.faults import default_spec

    cfg = get_arch("qwen3_1_7b").smoke
    specs = [default_spec(k, 1) for k in kinds]
    return Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24), specs


@pytest.mark.parametrize("case", FAULT_CASES)
def test_card_fault_view_is_the_cpu_view_from_the_same_draws(cuda, case):
    """Each leaf's uniforms drawn from its stream on the card and moved to
    the host: the CPU's map and view from those draws equal the card's,
    field by field and code by code."""
    from repro_torch import tree as tree_lib
    from repro_torch.faults import FAULT_CLASSES, compose_maps
    from repro_torch.faults import generators as G
    from repro_torch.faults.map import apply_fault_map

    dep, specs = _faulted_smoke(cuda, FAULT_CLASSES if case == "composite" else (case,))
    dep.inject(specs)
    cpu_codes = tree_lib.map_tensors(lambda t: t.cpu(), dep.codes)
    draws = [None if s.key_data is None else {
        path: tuple(t.cpu() for t in G.leaf_draws(s, path, xw.g_pos.shape, cuda))
        for path, xw in G.rram_leaves(dep.codes)} for s in specs]
    cpu_map = compose_maps(G.build_map(cpu_codes, s, dep.cfg.rram, draws=d)
                           for s, d in zip(specs, draws))
    for path, lf in cpu_map.leaves.items():
        card = dep._fault_map.leaves[path].fields()
        assert set(card) == set(lf.fields()), path
        assert all(torch.equal(card[f].cpu(), t) for f, t in lf.fields().items()), path
    cpu_view = apply_fault_map(cpu_codes, cpu_map, dep.cfg.rram)
    got = [t.cpu() for t in tree_lib.tensors(dep.codes_view)]
    assert all(torch.equal(a, b) for a, b in zip(got, tree_lib.tensors(cpu_view)))
    assert any(not torch.equal(a.cpu(), b) for a, b in
               zip(tree_lib.tensors(dep.codes), got))


def test_card_fault_draws_replay_from_the_spec(cuda):
    """The card's draws replay from the spec alone: the same uniforms on a
    second call, the same map and view on a second deployment whatever
    the order of injection; stuck cells stay pinned through drift."""
    from repro_torch import tree as tree_lib
    from repro_torch.faults import FAULT_CLASSES
    from repro_torch.faults import generators as G

    a, specs = _faulted_smoke(cuda, FAULT_CLASSES)
    b, _ = _faulted_smoke(cuda, FAULT_CLASSES)
    path, xw = G.rram_leaves(a.codes)[0]
    first = G.leaf_draws(specs[0], path, xw.g_pos.shape, cuda)
    again = G.leaf_draws(specs[0], path, xw.g_pos.shape, cuda)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    a.inject(specs)
    for s in reversed(specs):
        b.inject(s)
    views = [tree_lib.tensors(d.codes_view) for d in (a, b)]
    assert all(torch.equal(x, y) for x, y in zip(*views))
    lf = a._fault_map.leaves[path]
    a.advance(300)
    view = dict(G.rram_leaves(a.codes_view))[path]
    mask = lf.stuck_mask_pos
    assert mask.any() and torch.equal(view.g_pos[mask], lf.stuck_val_pos[mask])


# -- lifecycle persistence and the shared prefix cache on the card ------------


def test_snapshot_restore_on_card_is_bitwise(cuda, tmp_path):
    """Twin of ``test_torch_persist.py::test_snapshot_restore_is_bitwise``
    on the card: the replay is bitwise on the card it was taken on, and a
    restore onto the CPU is refused before any work."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, calibration_batch
    from repro_torch.faults import default_spec

    cfg = get_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24.0)
    dep.calibrate(2, steps=2, seq_len=8)
    dep.inject([default_spec("stuck_at", 1), default_spec("retention", 11)])
    dep.advance(12.0)
    step = dep.snapshot(str(tmp_path))
    restored = Deployment.restore(cfg, str(tmp_path), device=cuda)
    assert restored.step == step and restored.drift_hours == dep.drift_hours
    for a, b in ((dep.codes, restored.codes), (dep.codes_view, restored.codes_view),
                 (dep.adapters, restored.adapters), (list(dep.opt_state), list(restored.opt_state))):
        ta, tb = tree_lib.tensors(a), tree_lib.tensors(b)
        assert len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))
    batch = calibration_batch(cfg, 2, 8)
    assert restored.logit_mse(batch) == dep.logit_mse(batch)
    with pytest.raises(ValueError, match="do not replay bitwise on cpu"):
        Deployment.restore(cfg, str(tmp_path), device="cpu")


def test_async_save_on_card_is_taken_at_the_call(cuda, tmp_path):
    """The host copy is made before ``save(blocking=False)`` returns: an
    in-place AdamW update on the card right after it does not reach the
    file."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim.adam import AdamW, adam_betas, adamw_init, adamw_update_

    params = {"w": torch.ones(4096, device=cuda), "v": torch.arange(3.0, device=cuda)}
    state = adamw_init(params)
    cfg = AdamW(lr=0.1)
    betas = adam_betas(cfg, cuda)
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    adamw_update_(grads, state, params, cfg, betas)
    want = [state.step.clone(), *(t.clone() for t in state.mu.values()),
            *(t.clone() for t in params.values())]
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"opt": state, "params": params}, blocking=False)
    adamw_update_(grads, state, params, cfg, betas)
    m.wait()
    back = m.restore(1, {"opt": adamw_init(params), "params": params}, device=cuda)
    got = [back["opt"].step, *back["opt"].mu.values(), *back["params"].values()]
    assert all(a.device.type == "cuda" and torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_prefix_hits_on_card_equal_cold_admission(cuda, body):
    """Through the graphs: a full hit and a partial hit at the 4-token
    chunk boundary give the cold admission's staged cache, admission
    logits and tokens bitwise; a hit off the boundary gives its tokens,
    and logits within 1e-2 of their absmax."""
    import numpy as np

    from repro_torch.deploy import ServeEngine

    session = _smoke_sessions(cuda)[body]
    g = torch.Generator().manual_seed(7)
    shared, tail, p, more = (torch.randint(0, session.cfg.vocab, (n,), generator=g).numpy()
                             for n in (8, 5, 5, 3))
    prompts = [shared, shared, np.concatenate([shared, tail]), p, np.concatenate([p, more])]

    def run(entries):
        engine = ServeEngine(session, max_slots=1, max_len=32, prefill_chunk=4,
                             min_bucket=4, prefix_cache_entries=entries)
        admitted = []
        finalize = engine._finalize_admission

        def record(slot, req):
            admitted.append((req.prefix_hit_tokens, engine._staging_flat.clone(),
                             req._logits.clone()))
            finalize(slot, req)

        engine._finalize_admission = record
        reqs = []
        for prompt in prompts:
            reqs.append(engine.submit(prompt, max_new=4))
            engine.run()
        torch.cuda.synchronize()
        return admitted, [list(r.tokens) for r in reqs], engine.stats()

    hit, hit_tokens, st = run(16)
    cold, cold_tokens, _ = run(0)
    # codes_adc resumes P + 3 at the chunk boundary 4, not at 5
    assert [h[0] for h in hit] == [0, 8, 8, 0, 4 if body == "codes_adc" else 5]
    assert (st["prefix_lookups"], st["prefix_hits"], st["prefix_partial_hits"]) == (5, 1, 2)
    assert hit_tokens == cold_tokens
    for i, ((reused, cache, logits), (_, cold_cache, cold_logits)) in enumerate(zip(hit, cold)):
        if reused % 4 == 0:  # cold, the full hit of 8 tokens, the hit at 8
            assert torch.equal(cache, cold_cache) and torch.equal(logits, cold_logits), i
        else:
            diff = float((logits.float() - cold_logits.float()).abs().max())
            assert diff <= 1e-2 * float(cold_logits.float().abs().max()), (i, diff)


# ---------------------------------------------------------------------------
# the paper's CNN experiment (core/resnet.py, core/repro_experiments.py)
# ---------------------------------------------------------------------------

RESNET_CARD_VS_CPU = 1e-4   # of absmax: f32 on both, TF32 off; summation orders differ


def _resnet_trees(cfg, seed=0):
    """A teacher with trained-looking BN statistics, its drifted student
    and adapters with a nonzero B, on the CPU."""
    from repro_torch import tree as tree_lib
    from repro_torch.core import repro_experiments as rx
    from repro_torch.core import resnet

    g = torch.Generator().manual_seed(seed)

    def perturb(path, x):
        if path[-1] == "var":
            return torch.rand(x.shape, generator=g) + 0.5
        if path[-1] in ("mean", "bias", "lora_b"):
            return 0.1 * torch.randn(x.shape, generator=g)
        return x

    teacher = tree_lib.map_with_path(perturb, resnet.init_resnet(g, cfg))
    student = rx.make_student(teacher, 0.2, seed)
    adapters = tree_lib.map_with_path(perturb, resnet.init_adapters(g, student, cfg))
    return teacher, student, adapters


@pytest.mark.parametrize("kind", ["dora", "lora"])
def test_resnet_forward_on_card_is_the_cpu_s(cuda, kind):
    from repro_torch import tree as tree_lib
    from repro_torch.core import resnet
    from repro_torch.core.dora import AdapterConfig

    cfg = resnet.ResnetConfig(adapter=AdapterConfig(rank=2, kind=kind))
    _, student, adapters = _resnet_trees(cfg)
    x = torch.randn((8, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    on = lambda tree: tree_lib.map_tensors(lambda t: t.to(cuda), tree)  # noqa: E731
    with resnet.f32_convs():
        _, host = resnet.forward(student, x, cfg, adapters=adapters, collect_features=True)
        _, card = resnet.forward(on(student), x.to(cuda), cfg, adapters=on(adapters),
                                 collect_features=True)
    assert len(card["features"]) == len(host["features"]) == 3 * 3 * 2 + 2
    for i, (a, b) in enumerate(zip(card["features"], host["features"])):
        diff = float((a.cpu() - b).abs().max())
        assert diff <= RESNET_CARD_VS_CPU * float(b.abs().max()), (i, diff)


def test_adapter_int8_ptq_on_card_is_bitwise_the_cpu_s(cuda):
    from repro_torch.core import dora

    g = torch.Generator().manual_seed(2)
    ad = {"lora_a": torch.randn((144, 2), generator=g) * 0.07,
          "lora_b": torch.randn((2, 16), generator=g) * 1e-3,
          "dora_m": torch.rand((16,), generator=g) * 3 + 0.5}
    host = dora.quantize_adapter_int8(ad)
    card = dora.quantize_adapter_int8({k: v.to(cuda) for k, v in ad.items()})
    for name in ad:
        assert torch.equal(card[name][0].cpu(), host[name][0]), name
        assert torch.equal(card[name][1].cpu(), host[name][1]), name


def test_run_cell_on_card_launches_no_kernel_and_writes_no_weight(cuda, monkeypatch):
    from repro_torch import tree as tree_lib
    from repro_torch.core import repro_experiments as rx
    from repro_torch.core import resnet

    cfg = resnet.ResnetConfig(depth=8, width=8, classes=8, image_size=16)
    seen = []
    real = rx.feature_calibrate

    def snap(tree):
        return [t.clone() for t in tree_lib.tensors(tree)]

    def recording(teacher, student, adapters, images, cfg_, **kw):
        before = snap(teacher) + snap(student)
        out = real(teacher, student, adapters, images, cfg_, **kw)
        after = tree_lib.tensors(teacher) + tree_lib.tensors(student)
        seen.append(all(torch.equal(a, b) for a, b in zip(before, after)))
        return out

    monkeypatch.setattr(rx, "feature_calibrate", recording)
    K.reset_launch_counts()
    C.reset_launch_counts()
    data = rx.cell_data(0, cfg, cuda, n_train=512, n_test=512)
    r = rx.run_cell(seed=0, cfg=cfg, drift=0.25, data=data, device=cuda)
    assert set(K.launch_counts().values()) == {0} and C.launch_counts() == {"crossbar_mvm": 0}
    assert seen == [True]
    assert all(0 <= a <= 1 for a in (r.teacher_acc, r.drifted_acc, r.calibrated_acc))


# ---------------------------------------------------------------------------
# the MoE slice (models/moe.py, the rolling chunk path, the router's f32 x)
# ---------------------------------------------------------------------------

MOE_ORACLE_BOUND = 1e-2   # of absmax: bf16 expert products, M = C vs M = 1 shapes
# the router's f32-x launches at mixtral-8x22b's width: K = 6144, N = 8 (one
# column per expert, narrower than a 128-column strip), r = 8
ROUTER_K, ROUTER_N, ROUTER_R = 6144, 8, 8


@pytest.mark.parametrize("m", [1, 4, 32, 96])
@pytest.mark.parametrize("accum", ["f32", "int8"])
def test_router_f32x_launches_at_n8(cuda, accum, m):
    """The fused linear with f32 x at the router's shape: the SIMT GEMV
    (f32) or the int8 GEMV up to 64 rows, the tiled bodies above, against
    the plain version (f32 at 1e-4, int8 within 1e-4 of absmax), each
    launch counted once and in the f32-x tally."""
    ops = operands(m, ROUTER_K, ROUTER_N, ROUTER_R, cuda, dtype=torch.float32, seed=m)
    launcher = K.dora_linear_gemv if autotune.use_gemv(m) else K.dora_linear
    kind = "dora_linear_gemv" if autotune.use_gemv(m) else "dora_linear"
    K.reset_launch_counts()
    y = launcher(*ops, accum=accum)
    torch.cuda.synchronize()
    if accum == "f32":
        torch.testing.assert_close(y, dora_linear_ref(*ops), rtol=1e-4, atol=1e-4)
    else:
        want = ref.dora_linear_int8_ref(*ops)
        assert float((y - want).abs().max()) <= 1e-4 * float(want.abs().max())
    key = K.counter(kind, accum)
    assert K.launch_counts()[key] == 1 and sum(K.launch_counts().values()) == 1
    assert K.f32x_launch_counts() == {k: int(k == key + K.F32X)
                                      for k in K.f32x_launch_counts()}


@pytest.mark.parametrize("m", [1, 4, 32, 96])
def test_router_f32x_adc_at_n8(cuda, m):
    """The ADC's narrow body (f32 x) at the router's shape, against its plain
    version (0 outputs off, at most 0.1% one-step flips); counted once and
    in the f32-x tally."""
    x, gp, gn, scale = operands(m, ROUTER_K, ROUTER_N, 1, cuda, dtype=torch.float32,
                                seed=m)[:4]
    C.reset_launch_counts()
    _check_adc(x, gp, gn, scale)
    assert C.launch_counts() == {"crossbar_mvm": 1}
    assert C.f32x_launch_counts() == {"crossbar_mvm/f32x": 1}


def test_moe_dispatch_matches_dense_oracle_on_card(cuda):
    """A mid-width MoE block (d 1024, ff 2048, 8 experts, top-2, bf16,
    codes-resident stacks, the router through the f32-x GEMV) with
    capacity_factor = E / top_k, so no token is dropped: the dispatch path
    within ``MOE_ORACLE_BOUND`` of absmax of the dense gate-weighted sum
    over every expert, token by token."""
    from repro_torch import substrate
    from repro_torch.core.calibrate import merge_adapters_for_serve, program_model
    from repro_torch.core.dora import AdapterConfig
    from repro_torch.core.rram import RramConfig
    from repro_torch.models import moe as M

    cfg = M.MoeConfig(d_model=1024, d_ff=2048, n_experts=8, top_k=2, capacity_factor=4.0)
    acfg = AdapterConfig(rank=8, kind="dora")
    g = torch.Generator(device=cuda).manual_seed(0)
    base, adapters = M.init_moe(g, cfg, acfg)
    codes = program_model(base, RramConfig(relative_drift=0.1), 1, mode="codes")
    merged = merge_adapters_for_serve(codes, adapters)
    x = torch.randn((2, 24, 1024), generator=g, device=cuda).to(torch.bfloat16)
    K.reset_launch_counts()
    with substrate.use_backend("codes"), torch.no_grad():
        y = M.moe_block(x, codes, merged, cfg, acfg)
        dense = torch.cat([M.moe_block(x[:, i:i + 1], codes, merged, cfg, acfg)
                           for i in range(24)], dim=1)
    torch.cuda.synchronize()
    assert K.f32x_launch_counts()["dora_linear_gemv/f32x"] == 25  # router: dispatch + 24
    err = float((y.float() - dense.float()).abs().max())
    assert err <= MOE_ORACLE_BOUND * float(dense.float().abs().max()), err


def test_rolling_chunk_steps_replay_bitwise(cuda):
    """mixtral smoke (window 16) in a 40-token cache, so every chunk goes
    through the rolling canvas: a 36-token prompt in chunks of 32 and 4
    through the graphs, then each chunk graph replayed on inputs across the
    wrap (and past the window) bitwise equal to its eager step, logits and
    rolling buffer."""
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, ServeEngine

    cfg = get_arch("mixtral_8x22b").smoke
    session = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24).serve()
    engine = ServeEngine(session, max_slots=2, max_len=40, prefix_cache_entries=0)
    req = engine.submit(torch.arange(36) % cfg.vocab, max_new=4)
    engine.run()
    assert req.done and len(req.tokens) == 4
    assert session.compile_count() == 3  # decode, chunks 32 and 8 (4 tokens)
    g = torch.Generator().manual_seed(3)
    for step in session.steps:
        kind, _, _, width, *_ = step.key
        if kind != "prefill_chunk":
            continue
        for pos0, n in ((0, width), (12, min(width, 20)), (30, min(width, 9))):
            host = torch.cat([torch.randint(0, cfg.vocab, (width,), generator=g),
                              torch.tensor([pos0, n])])
            assert _replay_equals_eager(step, host) == (True, True), (width, pos0, n)


# ---------------------------------------------------------------------------
# the narrow body: f32 x with the f32 body at N <= 64 (the routers), either
# launcher, one split-K launch (autotune.narrow_plan)
# ---------------------------------------------------------------------------

# (M, K, N, R): the routers (mixtral-8x22b K 6144 N 8, deepseek-v2-lite K
# 2048 N 64) at every GEMV bucket and the tiled rows; then K ragged against
# the 128-row slab and the 32-row stage, N and R not multiples of 4, K
# within one slab, the most ranks the kernel takes, ragged row tiles; units
# of a tile past the threads (33 rows, R 256: 2 units a thread for some)
# and just under them (one lane each)
NARROW = [(m, k, n, 8) for k, n in ((6144, 8), (2048, 64))
          for m in (1, 2, 4, 8, 16, 32, 64, 96, 256)]
NARROW_RAGGED = [(5, 6100, 7, 8), (33, 6100, 60, 8), (96, 6100, 8, 5), (3, 40, 8, 1),
                 (4, 2048, 64, 256), (130, 257, 31, 5), (70, 1000, 64, 3),
                 (33, 1000, 64, 256), (20, 700, 64, 96)]


def _misaligned(ops):
    """The operands with x moved 4 bytes off a 16-byte boundary (a
    contiguous view at storage offset 1)."""
    x = ops[0]
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    moved = buf[1:].view(x.shape)
    moved.copy_(x)
    assert moved.data_ptr() % 16 != 0 and moved.is_contiguous()
    return (moved, *ops[1:])


def _narrow_launchers(m):
    return [K.dora_linear_gemv, K.dora_linear] if autotune.use_gemv(m) else [K.dora_linear]


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("shape", NARROW + NARROW_RAGGED)
def test_narrow_body_matches_plain(cuda, shape, misaligned):
    """The narrow body against the plain version at rtol = atol = 1e-4
    through each launcher that takes the rows, with x aligned and 4 bytes
    off, each call one launch counted under its launcher and in the f32-x
    tally."""
    m, k, n, r = shape
    ops = operands(m, k, n, r, cuda, dtype=torch.float32, seed=m + k + n)
    if misaligned:
        ops = _misaligned(ops)
    for launcher in _narrow_launchers(m):
        K.reset_launch_counts()
        _check(launcher, ops)
        key = launcher.__name__
        assert K.launch_counts()[key] == 1 and sum(K.launch_counts().values()) == 1
        assert K.f32x_launch_counts()[key + K.F32X] == 1


def _fresh_tickets():
    """Drop the tickets earlier tests left (a graph that was captured but
    never replayed holds tickets its zeroing node never cleared), so that
    a check sees only the tickets of the launches that follow."""
    torch.cuda.synchronize()
    K._SEMS.clear()


@pytest.mark.parametrize("shape", NARROW + NARROW_RAGGED)
def test_narrow_body_is_bitwise_repeatable(cuda, shape):
    """Two launches of the same call are bitwise equal (no atomics on data),
    and leave every ticket zero."""
    ops = operands(*shape, cuda, dtype=torch.float32, seed=1)
    _fresh_tickets()
    for launcher in _narrow_launchers(shape[0]):
        assert torch.equal(launcher(*ops), launcher(*ops))
    torch.cuda.synchronize()
    assert all(int(sem.abs().sum()) == 0 for _, sem in K._SEMS.values())


@pytest.mark.parametrize("shape", [(1, 6144, 8, 8), (4, 6144, 8, 8), (96, 6144, 8, 8),
                                   (32, 2048, 64, 8), (256, 2048, 64, 8), (33, 6100, 60, 8)])
def test_narrow_result_is_independent_of_the_plan(cuda, shape, monkeypatch):
    """Every block writes one sum a slab and the last block adds them in
    slab order, so the parts of K change no bit of the result: one part,
    two, three, the policy's, and one a slab."""
    m, k, n, r = shape
    ops = operands(m, k, n, r, cuda, dtype=torch.float32, seed=2)
    slabs = -(-k // autotune.MIN_SPLIT_ROWS)
    plans = sorted({1, 2, 3, autotune.narrow_plan(m, n, k), slabs})
    got = {}
    for parts in plans:
        monkeypatch.setattr(autotune, "narrow_plan", lambda *_, p=parts: p)
        got[parts] = K.dora_linear(*ops)
    torch.cuda.synchronize()
    assert all(torch.equal(got[1], y) for y in got.values()), plans
    torch.testing.assert_close(got[1], dora_linear_ref(*ops), rtol=1e-4, atol=1e-4)


def test_narrow_tiled_runs_one_kernel(cuda):
    """The tiled launcher at the router's 96-row prefill runs the narrow
    body alone: one kernel, no prologue, one launch counted."""
    ops = operands(96, 6144, 8, 8, cuda, dtype=torch.float32)
    names = _gemv_kernels(ops, "f32", launcher=K.dora_linear)
    if names is None:
        pytest.skip("the profiler recorded no device activity")
    assert names == ["dora_narrow_kernel"]
    K.reset_launch_counts()
    K.dora_linear(*ops)
    assert K.launch_counts() == {"dora_linear": 1, "dora_linear_gemv": 0,
                                 "dora_linear_gemv/int8": 0, "dora_linear/int8": 0}


def test_narrow_graphs_hold_tickets_of_their_own(cuda):
    """Graphs of narrow calls (the GEMV at the decode tick, the tiled
    launcher at the prefill, deepseek-v2-lite's router), each captured
    after an eager call, replay at once on three streams, each to its
    eager result; the tickets are zero afterwards."""
    calls = [(K.dora_linear_gemv, operands(4, 6144, 8, 8, cuda, dtype=torch.float32, seed=3)),
             (K.dora_linear, operands(96, 6144, 8, 8, cuda, dtype=torch.float32, seed=4)),
             (K.dora_linear_gemv, operands(32, 2048, 64, 8, cuda, dtype=torch.float32,
                                           seed=5))]
    _fresh_tickets()
    wants = [fn(*ops) for fn, ops in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn, ops in calls:
            fn(*ops)
    torch.cuda.current_stream().wait_stream(side)
    graphs, gots = [], []
    for fn, ops in calls:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            gots.append(fn(*ops))
    streams = [torch.cuda.Stream() for _ in graphs]
    for _ in range(5):
        for stream, graph in zip(streams, graphs):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(gots, wants):
            assert torch.equal(got, want)
    assert all(int(sem.abs().sum()) == 0 for _, sem in K._SEMS.values())


# ---------------------------------------------------------------------------
# the ADC's narrow body: f32 x at N <= 64 (the routers under codes_adc), one
# split-K launch (autotune.adc_narrow_plan)
# ---------------------------------------------------------------------------

# (M, K, N): the routers (mixtral-8x22b K 6144 N 8, deepseek-v2-lite K 2048
# N 64) at every GEMV bucket, the prefill's 96 rows, across two 128-row
# blocks (130) and at 256; then K ragged against the 256-row tile and the
# 32-row stage, N not a multiple of 4, K within one tile, M across row blocks
ADC_NARROW = [(m, k, n) for k, n in ((6144, 8), (2048, 64))
              for m in (1, 2, 4, 8, 16, 32, 64, 96, 130, 256)]
ADC_NARROW_RAGGED = [(5, 6100, 7), (33, 6100, 60), (96, 6100, 8), (3, 40, 8), (130, 257, 31),
                     (1, 300, 64), (200, 1000, 64)]


def _adc_fresh_tickets():
    """Drop the tickets earlier tests left (a graph captured but never
    replayed holds tickets its zeroing node never cleared)."""
    torch.cuda.synchronize()
    C._SEMS.clear()


def _adc_tickets_zero():
    torch.cuda.synchronize()
    return all(int(sem.abs().sum()) == 0 for _, sem in C._SEMS.values())


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("shape", ADC_NARROW + ADC_NARROW_RAGGED)
def test_adc_narrow_matches_plain(cuda, shape, misaligned):
    """The narrow body against the plain version (0 outputs off, at most 0.1%
    one-step flips), x aligned and 4 bytes off; one launch counted, in the
    f32-x tally."""
    m, k, n = shape
    ops = operands(m, k, n, 1, cuda, dtype=torch.float32, seed=m + k + n)[:4]
    if misaligned:
        ops = _misaligned(ops)
    C.reset_launch_counts()
    _check_adc(*ops)
    assert C.launch_counts() == {"crossbar_mvm": 1}
    assert C.f32x_launch_counts() == {"crossbar_mvm/f32x": 1}


@pytest.mark.parametrize("shape", ADC_NARROW + ADC_NARROW_RAGGED)
def test_adc_narrow_is_bitwise_repeatable(cuda, shape):
    """Two launches of the same call are bitwise equal (no atomics on data)
    and leave every ticket zero."""
    ops = operands(*shape, 1, cuda, dtype=torch.float32, seed=1)[:4]
    _adc_fresh_tickets()
    assert torch.equal(C.crossbar_mvm(*ops), C.crossbar_mvm(*ops))
    assert _adc_tickets_zero()


@pytest.mark.parametrize("shape", [(1, 6144, 8), (4, 6144, 8), (96, 6144, 8), (256, 6144, 8),
                                   (32, 2048, 64), (130, 2048, 64), (33, 6100, 60)])
def test_adc_narrow_result_is_independent_of_the_plan(cuda, shape, monkeypatch):
    """Every tile's digitized partial is written and the row block's last
    block adds them in tile order, so the parts of K change no bit: one
    part, two, three, the policy's, and one a tile."""
    m, k, n = shape
    ops = operands(m, k, n, 1, cuda, dtype=torch.float32, seed=2)[:4]
    tiles = -(-k // autotune.ADC_ARRAY_ROWS)
    plans = sorted({1, 2, 3, autotune.adc_narrow_plan(m, k, n), tiles})
    got = {}
    for parts in plans:
        monkeypatch.setattr(autotune, "adc_narrow_plan", lambda *_, p=parts: p)
        got[parts] = C.crossbar_mvm(*ops)
    torch.cuda.synchronize()
    assert all(torch.equal(got[1], y) for y in got.values()), plans
    bad, flips = ref.adc_disagreement(got[1], ref.crossbar_mvm_ref(*ops), ops[0], ops[3])
    assert bad == 0 and flips <= 1e-3 * got[1].numel(), (bad, flips)


@pytest.mark.parametrize("m,k,n", [(4, 6144, 8), (130, 2048, 64), (256, 6100, 60)])
def test_adc_narrow_exactness_case(cuda, m, k, n):
    """Integer x in [-127, 127] with 127 in every (128-row, 256-row) block:
    every step is 4080 and every current an exact integer below 2^24, so
    the narrow body is bitwise the plain version, a partial last tile and
    two row blocks included."""
    x, gp, gn, one = _exact_adc(m, k, n, cuda)
    assert torch.all(ref.adc_steps(x) == 4080.0)
    assert torch.equal(C.crossbar_mvm(x, gp, gn, one), ref.crossbar_mvm_ref(x, gp, gn, one))


def test_adc_narrow_steps_of_zero_and_ragged_tiles(cuda):
    """A row block of zeros takes the 1e-8 floor's step (its outputs 0),
    and the max |x| of a partial last tile is its own rows' (the zero-fill
    past K changes nothing): the other row block and tiles as the plain
    version has them."""
    m, k, n = 200, 6100, 60
    x, gp, gn, scale = operands(m, k, n, 1, cuda, dtype=torch.float32, seed=9)[:4]
    x[128:] = 0.0
    x[:, 6000:] *= 50.0  # the last, partial tile's step far above the others'
    y = C.crossbar_mvm(x, gp, gn, scale)
    torch.cuda.synchronize()
    assert torch.all(y[128:] == 0)
    bad, flips = ref.adc_disagreement(y, ref.crossbar_mvm_ref(x, gp, gn, scale), x, scale)
    assert bad == 0 and flips <= 1e-3 * y.numel(), (bad, flips)


def test_adc_narrow_graphs_hold_tickets_of_their_own(cuda):
    """Graphs of narrow ADC calls (mixtral's decode tick, its 96-row prefill,
    256 rows over two row blocks, deepseek-v2-lite's chunk), each captured
    after an eager call, replay at once on four streams, each to its eager
    result; the tickets are zero afterwards."""
    calls = [operands(4, 6144, 8, 1, cuda, dtype=torch.float32, seed=3)[:4],
             operands(96, 6144, 8, 1, cuda, dtype=torch.float32, seed=4)[:4],
             operands(256, 6144, 8, 1, cuda, dtype=torch.float32, seed=5)[:4],
             operands(32, 2048, 64, 1, cuda, dtype=torch.float32, seed=6)[:4]]
    _adc_fresh_tickets()
    wants = [C.crossbar_mvm(*ops) for ops in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for ops in calls:
            C.crossbar_mvm(*ops)
    torch.cuda.current_stream().wait_stream(side)
    graphs, gots = [], []
    for ops in calls:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            gots.append(C.crossbar_mvm(*ops))
    streams = [torch.cuda.Stream() for _ in graphs]
    for _ in range(5):
        for stream, graph in zip(streams, graphs):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(gots, wants):
            assert torch.equal(got, want)
    assert _adc_tickets_zero()


@pytest.mark.parametrize("m", [4, 96])
def test_adc_narrow_runs_one_kernel(cuda, m):
    """At the router's decode tick and 96-row prefill the narrow body runs
    alone: one kernel, no step prologue, no sum pass."""
    ops = operands(m, 6144, 8, 1, cuda, dtype=torch.float32)[:4]
    names = _kernels_of_one_call(lambda: C.crossbar_mvm(*ops))
    if names is None:
        pytest.skip("the profiler recorded no device activity")
    assert names == ["adc_narrow_kernel"]


def test_adc_narrow_never_reaches_simt_or_plain(cuda, monkeypatch):
    """A call with f32 x at N <= 64 reaches neither the SIMT body's C entry
    nor the plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("a narrow f32-x call left the narrow body")

    lib = C.build()
    monkeypatch.setattr(C, "crossbar_mvm_ref", refuse)
    monkeypatch.setattr(lib, "rimc_crossbar_mvm", refuse)
    C.reset_launch_counts()
    for m, k, n in ((1, 6144, 8), (96, 6144, 8), (32, 2048, 64), (5, 6100, 7)):
        C.crossbar_mvm(*operands(m, k, n, 1, cuda, dtype=torch.float32)[:4])
    torch.cuda.synchronize()
    assert C.launch_counts() == {"crossbar_mvm": 4}


# ---------------------------------------------------------------------------
# MLA (deepseek-v2-lite): the up-projection of the whole latent cache every
# decode tick and chunk puts the tiled bodies inside the decode graphs
# ---------------------------------------------------------------------------

# _kup_vup at full width: (K kv_lora, N 16 heads x (128 + 128), fused rank)
KUP_VUP = (512, 4096, 16)


def _graph_equals_eager(call):
    """``call`` captured in a CUDA graph after a warm-up on a side stream
    (as the serving registry captures a step), replayed three times: each
    replay bitwise equal to the eager result."""
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            return False
    return True


# a decode tick's rows (4 slots x a 128-token cache) and a chunk's (the
# batch-1 staging cache)
@pytest.mark.parametrize("m", [512, 128])
@pytest.mark.parametrize("accum", ["f32", "int8"])
def test_tiled_kup_vup_replays_bitwise_in_a_graph(cuda, accum, m):
    """Both tensor-core tiled bodies at deepseek-v2-lite's fused _kup_vup:
    against their plain versions, and captured in a CUDA graph (the
    launcher's scratch from the graph's pool, its K split chosen by M)
    replayed bitwise equal to the eager call."""
    k, n, r = KUP_VUP
    ops = operands(m, k, n, r, cuda, seed=m)
    (_check if accum == "f32" else _check_int8)(K.dora_linear, ops)
    assert _graph_equals_eager(lambda: K.dora_linear(*ops, accum=accum))


def test_adc_kup_replays_bitwise_in_a_graph(cuda):
    """The ADC's tensor-core body at k_up under codes_adc (M 512, K 512, N
    2048): against its plain version, and replayed from a CUDA graph
    bitwise equal to the eager call."""
    ops = operands(512, 512, 2048, 1, cuda, seed=3)[:4]
    _check_adc(*ops)
    assert _graph_equals_eager(lambda: C.crossbar_mvm(*ops))


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_mla_decode_tick_replays_bitwise(cuda, body):
    """deepseek-v2-lite smoke at 2 layers (the dense layer and one MoE
    layer): the decode graph (its _kup_vup over 4 slots x 64 positions
    tiled) and the chunk graphs replay bitwise equal to the eager step,
    logits and latent cache; the tiled launcher ran in the engine."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment

    cfg = dataclasses.replace(get_arch("deepseek-v2-lite").smoke, n_layers=2)
    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    if body == "codes_adc":
        session = Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes, dep.adapters,
                             dep.teacher_seed, dep.program_seed, dep.drift_hours).serve()
    else:
        session = dep.serve(accum=body)
    _, counts, _ = _drive(session)
    if body != "codes_adc":
        assert counts[K.counter("dora_linear", body)] > 0, counts
    _check_replays(session)


def test_moe_dispatch_top6_repeats_bitwise(cuda):
    """deepseek-v2-lite's routing (64 experts, top-6, capacity 1.25) at a
    narrow width: the dispatch path's output and its gradients w.r.t. the
    input and the side-cars bitwise equal over two runs (no scatter-add of
    a token's six slots with atomics)."""
    from repro_torch.core.dora import AdapterConfig
    from repro_torch.models import moe as M

    cfg = M.MoeConfig(d_model=64, d_ff=32, n_experts=64, top_k=6, n_shared=1,
                      capacity_factor=1.25)
    acfg = AdapterConfig(rank=4, kind="dora")
    base, ad = M.init_moe(torch.Generator(device=cuda).manual_seed(0), cfg, acfg)
    for leaf in ad.values():
        if "lora_b" in leaf:
            leaf["lora_b"].normal_(0.0, 0.05)
    x = torch.randn((4, 32, 64), device=cuda).to(torch.bfloat16)
    leaves = [t for t in _leaves(ad)]
    runs = []
    for _ in range(2):
        xr = x.clone().requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
        y = M.moe_block(xr, base, ad, cfg, acfg)
        grads = torch.autograd.grad(y.float().square().sum(), [xr, *leaves])
        runs.append((y.detach(), grads))
    (y0, g0), (y1, g1) = runs
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield tree


# -- seamless-m4t-large-v2: the encoder's leaves at its admission rows and
# an engine drive of the encoder-decoder model at 2 + 2 layers ---------------

# its fused encoder leaves (name, K, N, fused rank) and unfused ones (ADC);
# the cross-attention's k and v over the encoder's output have the o shape
SEAMLESS_LEAVES = [("qkv", 1024, 3072, 24), ("o", 1024, 1024, 8), ("up", 1024, 8192, 8),
                   ("down", 8192, 1024, 8)]
SEAMLESS_ADC = [("qkvo", 1024, 1024), ("up", 1024, 8192), ("down", 8192, 1024)]
# an encoder admission's rows: the reference ArchSpec's 4096 frames, a ragged count
SEAMLESS_ENC_M = [4096, 333]


@pytest.mark.parametrize("accum", ["f32", "int8"])
@pytest.mark.parametrize("m", SEAMLESS_ENC_M)
@pytest.mark.parametrize("leaf", SEAMLESS_LEAVES, ids=[lf[0] for lf in SEAMLESS_LEAVES])
def test_tiled_at_the_encoder_admission(cuda, leaf, m, accum):
    """Both tensor-core tiled bodies at the encoder's rows (K up to 8192)
    against their plain versions, and bitwise repeatable."""
    _, k, n, r = leaf
    ops = operands(m, k, n, r, cuda, seed=m + k)
    (_check if accum == "f32" else _check_int8)(K.dora_linear, ops)
    assert torch.equal(K.dora_linear(*ops, accum=accum), K.dora_linear(*ops, accum=accum))


@pytest.mark.parametrize("m", SEAMLESS_ENC_M)
@pytest.mark.parametrize("leaf", SEAMLESS_ADC, ids=[lf[0] for lf in SEAMLESS_ADC])
def test_adc_at_the_encoder_admission(cuda, leaf, m):
    _, k, n = leaf
    _check_adc(*operands(m, k, n, 1, cuda, seed=m + k)[:4])


SEAMLESS_ENC_LENS = (128, 100, 33, 64)  # one per STEP_PROMPTS request


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_seamless_engine_drive_exact_launches(cuda, body):
    """seamless-m4t-large-v2 at its widths and 2 + 2 layers: STEP_PROMPTS
    with encoder inputs of 128, 100, 33 and 64 frames (cross lines of 128)
    through a 4-slot engine, twice: exact launches (a step: 2 x (qkv, o,
    cross q, cross o, up, down) + the head through the GEMV; an encoder
    admission: 2 x (qkv, o, up, down) + 2 x (cross k, v), tiled above 64
    frames; codes_adc every leaf unfused), ``compile_count`` 8 (decode,
    three chunk buckets, an encoder admission a length) and flat, the same
    streams and launches on the second drive."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, ServeEngine

    cfg = dataclasses.replace(get_arch("seamless-m4t-large-v2").full, n_layers=2,
                              encoder_layers=2)
    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    if body == "codes_adc":
        dep = Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes, dep.adapters,
                         dep.teacher_seed, dep.program_seed, dep.drift_hours)
    session = dep.serve(accum="int8") if body == "int8" else dep.serve()
    g = torch.Generator().manual_seed(1)
    encs = [torch.randn((n, cfg.d_model), generator=g).numpy() for n in SEAMLESS_ENC_LENS]
    runs = []
    for _ in range(2):
        engine = ServeEngine(session, max_slots=4, max_len=64, src_len=128,
                             prefix_cache_entries=0)
        K.reset_launch_counts()
        C.reset_launch_counts()
        reqs = []
        for n, e in zip(STEP_PROMPTS, encs):
            reqs.append(engine.submit(torch.arange(n) % cfg.vocab, max_new=6, enc_embeds=e))
            engine.step()
        engine.run()
        torch.cuda.synchronize()
        assert all(r.done and len(r.tokens) == 6 for r in reqs)
        steps = engine.stats()["prefill_chunks"] + engine.stats()["decode_steps"]
        runs.append(([list(r.tokens) for r in reqs], {**K.launch_counts(), **C.launch_counts()},
                     session.compile_count()))
        del engine
    short = sum(autotune.use_gemv(n) for n in SEAMLESS_ENC_LENS)
    if body == "codes_adc":
        want = {"crossbar_mvm": steps * (8 * 2 + 1) + 4 * (6 * 2 + 2 * 2)}
    else:
        sfx = "" if body == "f32" else "/int8"
        want = {f"dora_linear_gemv{sfx}": steps * (6 * 2 + 1) + short * (4 * 2 + 2 * 2),
                f"dora_linear{sfx}": (4 - short) * (4 * 2 + 2 * 2)}
    counts = runs[0][1]
    assert counts == {name: want.get(name, 0) for name in counts}, (counts, want)
    assert runs[0][2] == 8 and runs[1] == runs[0]


# -- paligemma-3b: its leaves at a vision admission's rows, and an engine
# drive of the vision-prefix model at 2 layers -------------------------------

# its fused leaves (name, K, N, fused rank): down at K 16384, gate_up at N
# 32768; and its unfused ones (ADC)
PALIGEMMA_LEAVES = [("qkv", 2048, 2560, 24), ("o", 2048, 2048, 8), ("gate_up", 2048, 32768, 16),
                    ("down", 16384, 2048, 8)]
PALIGEMMA_ADC = [("qo", 2048, 2048), ("kv", 2048, 256), ("gate", 2048, 16384),
                 ("down", 16384, 2048)]
VISION_M = 256  # a vision admission's rows: the 256 patches


@pytest.mark.parametrize("accum", ["f32", "int8"])
@pytest.mark.parametrize("leaf", PALIGEMMA_LEAVES, ids=[lf[0] for lf in PALIGEMMA_LEAVES])
def test_tiled_at_the_vision_admission(cuda, leaf, accum):
    """Both tensor-core tiled bodies at the vision admission's 256 rows (K
    up to 16384) against their plain versions, and bitwise repeatable."""
    _, k, n, r = leaf
    ops = operands(VISION_M, k, n, r, cuda, seed=k + n)
    (_check if accum == "f32" else _check_int8)(K.dora_linear, ops)
    assert torch.equal(K.dora_linear(*ops, accum=accum), K.dora_linear(*ops, accum=accum))


@pytest.mark.parametrize("m", [4, VISION_M])
@pytest.mark.parametrize("leaf", PALIGEMMA_ADC, ids=[lf[0] for lf in PALIGEMMA_ADC])
def test_adc_at_the_vision_admission(cuda, leaf, m):
    _, k, n = leaf
    _check_adc(*operands(m, k, n, 1, cuda, seed=m + k)[:4])


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_vision_engine_drive_replays_and_exact_launches(cuda, body):
    """paligemma-3b at its widths and 2 layers: STEP_PROMPTS, the first
    three behind an image of 256 patches and the last text-only, through a
    4-slot engine of 320 positions, twice: exact launches (a tick or text
    chunk: 2 x (qkv, o, gate_up, down) through the GEMV; a vision
    admission the same tiled; codes_adc every leaf unfused),
    ``compile_count`` 5 (decode, three chunk buckets, the vision
    admission) and flat, the same streams and launches on the second
    drive; then every graph, the vision admission's included, replayed
    bitwise equal to its eager step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, ServeEngine

    cfg = dataclasses.replace(get_arch("paligemma-3b").full, n_layers=2)
    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    if body == "codes_adc":
        dep = Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes, dep.adapters,
                         dep.teacher_seed, dep.program_seed, dep.drift_hours)
    session = dep.serve(accum="int8") if body == "int8" else dep.serve()
    g = torch.Generator().manual_seed(1)
    pes = [torch.randn((cfg.vision_tokens, cfg.d_model), generator=g).numpy() for _ in range(3)]
    pes.append(None)
    runs = []
    for _ in range(2):
        engine = ServeEngine(session, max_slots=4, max_len=320, prefix_cache_entries=0)
        K.reset_launch_counts()
        C.reset_launch_counts()
        reqs = []
        for n, pe in zip(STEP_PROMPTS, pes):
            reqs.append(engine.submit(torch.arange(n) % cfg.vocab, max_new=6, patch_embeds=pe))
            engine.step()
        engine.run()
        torch.cuda.synchronize()
        assert all(r.done and len(r.tokens) == 6 for r in reqs)
        stats = engine.stats()
        runs.append(([list(r.tokens) for r in reqs], {**K.launch_counts(), **C.launch_counts()},
                     session.compile_count(), stats["prefill_chunks"]))
        del engine
    steps = runs[0][3] - 3 + stats["decode_steps"]
    assert runs[0][3] == 3 + 5  # three vision units, chunks 5 -> 8, 9 -> 16, 17 -> 32, 40 -> 32 + 8
    if body == "codes_adc":
        want = {"crossbar_mvm": (steps + 3) * 7 * 2}
    else:
        sfx = "" if body == "f32" else "/int8"
        want = {f"dora_linear_gemv{sfx}": steps * 4 * 2, f"dora_linear{sfx}": 3 * 4 * 2}
    counts = runs[0][1]
    assert counts == {name: want.get(name, 0) for name in counts}, (counts, want)
    assert runs[0][2] == 5 and runs[1] == runs[0]
    for step in session.steps:
        kind, width, max_len = step.key[0], step.key[3], step.key[4]
        if kind == "decode":
            host = torch.stack([torch.randint(0, cfg.vocab, (4,), generator=g),
                                torch.tensor([261, 290, 300, max_len - 1])])
        elif kind == "prefill_vision":
            host = torch.randn(tuple(step.inputs.shape), generator=g)
        else:
            host = torch.cat([torch.randint(0, cfg.vocab, (width,), generator=g),
                              torch.tensor([max_len - width // 2 - 1, width // 2 + 1])])
        assert _replay_equals_eager(step, host) == (True, True), step.key


# -- falcon-mamba-7b at smoke: the decode graph and the calibration graph --


def _bytes_equal(a, b):
    """Bitwise, by bytes: the f32 SSM state in a bf16 buffer reads as NaNs
    there, which never compare equal as bf16."""
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _recurrent_session(cfg, body, cuda):
    """A recurrent smoke stack's session on the card (24 h of drift): f32
    codes, int8 codes or codes_adc."""
    from repro_torch.deploy import Deployment

    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    if body == "codes_adc":
        dep = Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes, dep.adapters,
                         dep.teacher_seed, dep.program_seed, dep.drift_hours)
    return dep.serve(accum="int8") if body == "int8" else dep.serve()


def _recurrent_decode_graph(cfg, body, cuda, counts, pos):
    """A recurrent smoke stack's drive: STEP_PROMPTS through a 4-slot
    engine (each admission one fused prefill, the step of its prompt
    length: the first of a length eager, then captured; no chunk), greedy,
    twice: launches equal to ``counts(ticks, admissions)`` (a replay adds
    the launches its capture recorded), ``compile_count`` 1 + the distinct
    prompt lengths, the same streams on the second drive; then the decode
    graph, from a random cache with the slots at clocks ``pos``, replayed
    bitwise equal to its eager step, logits and cache (the recurrent state
    by its bytes)."""
    from repro_torch.deploy import ServeEngine
    from repro_torch.models import transformer as T

    session = _recurrent_session(cfg, body, cuda)
    runs = []
    for _ in range(2):
        engine = ServeEngine(session, max_slots=4, max_len=64, prefix_cache_entries=0)
        K.reset_launch_counts()
        C.reset_launch_counts()
        reqs = []
        for n in STEP_PROMPTS:
            reqs.append(engine.submit(torch.arange(n) % cfg.vocab, max_new=6))
            engine.step()
        engine.run()
        torch.cuda.synchronize()
        assert all(r.done and len(r.tokens) == 6 for r in reqs)
        stats = engine.stats()
        assert stats["prefill_chunks"] == 0
        runs.append(([list(r.tokens) for r in reqs], {**K.launch_counts(), **C.launch_counts()},
                     session.compile_count()))
        ticks = stats["decode_steps"]
        del engine
    want = counts(ticks, len(STEP_PROMPTS))
    launched = runs[0][1]
    assert launched == {name: want.get(name, 0) for name in launched}, (launched, want)
    assert runs[0][2] == 1 + len(set(STEP_PROMPTS)) and runs[1] == runs[0]
    (step,) = [s for s in session.steps if s.key[0] == "decode"]
    g = torch.Generator().manual_seed(2)
    host = torch.stack([torch.randint(0, cfg.vocab, (4,), generator=g), torch.tensor(pos)])
    step.flat.copy_(torch.randn(step.flat.shape, generator=g).to(step.flat.dtype))
    for c in T._cache_layers(step.cache, cfg):
        for name in ("h", "conv"):  # a finite state: random f32 values, not bf16 bits read as f32
            if name in c:
                c[name].copy_(torch.randn(c[name].shape, generator=g))
    saved = step.flat.clone()
    got = step(host).clone()
    got_cache = step.flat.clone()
    assert not _bytes_equal(got_cache, saved)  # the tick advanced the state in place
    step.flat.copy_(saved)
    want = step.fn()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and _bytes_equal(got_cache, step.flat)


def _recurrent_prefill_graphs(cfg, body, cuda, counts):
    """A recurrent smoke stack's admissions: STEP_PROMPTS through a 4-slot
    engine capture one fused-prefill step per prompt length; then each
    step, on a staging cache of random values (the dirt it must
    overwrite), replayed bitwise equal to its eager function from a copy
    of the same cache (logits and every byte of the cache), a replay
    launching one forward's kernels (``counts(0, 1)``)."""
    from repro_torch.deploy import ServeEngine

    session = _recurrent_session(cfg, body, cuda)
    engine = ServeEngine(session, max_slots=4, max_len=64, prefix_cache_entries=0)
    for n in STEP_PROMPTS:
        engine.submit(torch.arange(n) % cfg.vocab, max_new=2)
        engine.step()
    engine.run()
    steps = {s.key[3]: s for s in session.steps if s.key[0] == "prefill"}
    assert sorted(steps) == sorted(set(STEP_PROMPTS)), steps
    want_counts = counts(0, 1)
    g = torch.Generator().manual_seed(3)
    for n, step in steps.items():
        assert step.graph is not None and step.key[4] == 64, step.key
        host = torch.randint(0, cfg.vocab, (1, n), generator=g)
        step.flat.copy_(torch.randn(step.flat.shape, generator=g).to(step.flat.dtype))
        saved = step.flat.clone()
        K.reset_launch_counts()
        C.reset_launch_counts()
        got = step(host).clone()
        torch.cuda.synchronize()
        launched = {**K.launch_counts(), **C.launch_counts()}
        got_cache = step.flat.clone()
        assert not _bytes_equal(got_cache, saved), n
        step.flat.copy_(saved)
        want = step.fn()
        torch.cuda.synchronize()
        assert torch.equal(got, want) and _bytes_equal(got_cache, step.flat), n
        assert launched == {name: want_counts.get(name, 0) for name in launched}, (
            n, launched, want_counts)


def _ssm_counts(cfg, body):
    """falcon-mamba's smoke launches: a forward is 4 x 4 leaves at its rows
    and the untied head at its last ones, through one body."""
    per = 4 * cfg.n_layers + 1

    def counts(ticks, admissions):
        if body == "codes_adc":
            return {"crossbar_mvm": (ticks + admissions) * per}
        sfx = "" if body == "f32" else "/int8"
        return {f"dora_linear_gemv{sfx}": (ticks + admissions) * per}
    return counts


def _rglru_counts(cfg, body):
    """recurrentgemma's smoke launches: a forward is an rglru layer's 5
    leaves (unfused) and the MLP's ``gate_up`` and ``down``, a local
    layer's ``qkv``, ``o``, ``gate_up`` and ``down`` (the ADC 5 + 3 and 4
    + 3 unfused); the tied head runs ``torch.matmul``."""
    kinds = [m for m, _ in cfg.layer_kinds()]
    fused = sum(5 + 2 if m == "rglru" else 2 + 2 for m in kinds)
    unfused = sum(5 + 3 if m == "rglru" else 4 + 3 for m in kinds)
    assert (fused, unfused) == (50, 62)

    def counts(ticks, admissions):
        if body == "codes_adc":
            return {"crossbar_mvm": (ticks + admissions) * unfused}
        sfx = "" if body == "f32" else "/int8"
        return {f"dora_linear_gemv{sfx}": (ticks + admissions) * fused}
    return counts


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_ssm_decode_graph_replays_bitwise(cuda, body):
    """falcon-mamba's smoke stack through ``_recurrent_decode_graph``:
    exact launches (an admission 4 x 4 leaves at its rows and the head at
    one; a tick 4 x 4 + 1 at 4 rows), ``compile_count`` 1 + 4 prompt
    lengths, the same streams on a second drive; the decode graph replayed
    bitwise equal to its eager step, logits and cache (``h`` and ``conv``
    included)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("falcon-mamba-7b").smoke
    _recurrent_decode_graph(cfg, body, cuda, _ssm_counts(cfg, body), [3, 17, 40, 62])


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_rglru_decode_graph_replays_bitwise_across_the_window(cuda, body):
    """recurrentgemma's smoke stack (6 rglru and 2 local layers, window 8,
    a tied head through ``torch.matmul``) through
    ``_recurrent_decode_graph``: exact launches (``_rglru_counts``: a
    forward per tick and per admission), ``compile_count`` 1 + 4 prompt
    lengths; the streams run past the window, so the rolling buffers wrap;
    the decode graph, its slots at clocks 3, 17, 40 and 62 (three past the
    window), replayed bitwise equal to its eager step, logits and cache
    (``h`` and ``conv`` by their bytes, the rolling ``k``/``v``)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("recurrentgemma-9b").smoke
    _recurrent_decode_graph(cfg, body, cuda, _rglru_counts(cfg, body), [3, 17, 40, 62])


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_ssm_prefill_graphs_replay_bitwise(cuda, body):
    """falcon-mamba's smoke stack through ``_recurrent_prefill_graphs``:
    the 17- and 40-token steps run two scan chunks of 16 and three."""
    from repro_torch.configs import get_arch

    cfg = get_arch("falcon-mamba-7b").smoke
    _recurrent_prefill_graphs(cfg, body, cuda, _ssm_counts(cfg, body))


@pytest.mark.parametrize("body", ["f32", "int8", "codes_adc"])
def test_rglru_prefill_graphs_replay_bitwise_across_the_window(cuda, body):
    """recurrentgemma's smoke stack through ``_recurrent_prefill_graphs``:
    the 9-, 17- and 40-token steps wrap the local layers' rolling buffers
    of 8; the 5-token one leaves 3 of their slots zero."""
    from repro_torch.configs import get_arch

    cfg = get_arch("recurrentgemma-9b").smoke
    _recurrent_prefill_graphs(cfg, body, cuda, _rglru_counts(cfg, body))


def _recurrent_calibration(cfg, cuda, monkeypatch, seq):
    """A recurrent smoke deployment: ``calibrate`` (4 samples of ``seq``
    tokens, 6 steps) through its CUDA graph against the eager cached step
    functions from the same start: losses, adapters and AdamW state
    bitwise; no kernel launch; one capture; the loss falls."""
    from repro_torch import tree as tree_lib
    from repro_torch.deploy import Deployment, calibration_batch
    from repro_torch.deploy import deployment as D
    from repro_torch.optim.adam import adamw_init

    dep = Deployment.program(cfg, 0, backend="codes", device=cuda).advance(24)
    batch = calibration_batch(cfg, 4, seq)
    start = tree_lib.map_tensors(torch.clone, dep.adapters)
    start = (start, adamw_init(start))
    captures = _count_captures(monkeypatch)
    K.reset_launch_counts()
    C.reset_launch_counts()
    report = dep.calibrate(batch, steps=6)
    torch.cuda.synchronize()
    assert set(K.launch_counts().values()) == {0} and C.launch_counts() == {"crossbar_mvm": 0}
    assert len(captures) == 1 and report.final_loss < report.initial_loss
    losses, state = _eager_calibration(dep, start, D._device_batch(batch, cuda), 6, True,
                                       dep._calib_stream())
    assert report.losses == losses, (report.losses, losses)
    for want, got in ((state.adapters, dep.adapters), ([*state.opt_state], [*dep.opt_state])):
        assert all(torch.equal(a, b) for a, b in zip(tree_lib.tensors(want),
                                                     tree_lib.tensors(got)))


def test_ssm_calibrate_graph_is_bitwise_the_eager_steps(cuda, monkeypatch):
    """falcon-mamba's smoke deployment through ``_recurrent_calibration``,
    24 tokens a sample: two scan chunks of 16."""
    from repro_torch.configs import get_arch

    _recurrent_calibration(get_arch("falcon-mamba-7b").smoke, cuda, monkeypatch, 24)


def test_rglru_calibrate_graph_is_bitwise_the_eager_steps(cuda, monkeypatch):
    """recurrentgemma's smoke deployment through ``_recurrent_calibration``,
    20 tokens a sample: past the local window of 8."""
    from repro_torch.configs import get_arch

    _recurrent_calibration(get_arch("recurrentgemma-9b").smoke, cuda, monkeypatch, 20)


# ---------------------------------------------------------------------------
# the fleet and the calibration registry
# ---------------------------------------------------------------------------


def _tensors_bitwise(a, b):
    from repro_torch import tree as tree_lib

    ta, tb = tree_lib.tensors(a), tree_lib.tensors(b)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and _bytes_equal(x.reshape(-1), y.reshape(-1)) for x, y in zip(ta, tb))


def _fleet_and_solos(cuda, chips=(0, 2)):
    """A smoke fleet of 3 chips on the card, programmed and aged 24, 168
    and 6 h, and solo deployments of ``chips`` with the same seeds and
    history."""
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment
    from repro_torch.fleet import Fleet

    cfg = get_arch("qwen3-1.7b").smoke
    fleet = Fleet.program(cfg, 0, n_chips=3, backend="codes", device=cuda)
    hours = [24.0, 168.0, 6.0]
    solos = {i: Deployment.program(cfg, (fleet.teacher_seed, fleet.chip_seed(i)),
                                   backend="codes", device=cuda) for i in chips}
    for i, dep in solos.items():
        assert _tensors_bitwise(dep.codes, fleet.chip(i).codes), i
        dep.advance(hours[i])
    fleet.advance(hours)
    for i, dep in solos.items():
        assert _tensors_bitwise(dep.codes, fleet.chip(i).codes), i
    return fleet, solos


def test_fleet_chip_is_its_solo_deployment_on_the_card(cuda):
    """Chip ``i`` of a fleet on the card is bitwise the solo deployment
    with its seeds: codes after programming and heterogeneous drift, then
    every calibration loss, the adapters and the AdamW state."""
    import numpy as np

    fleet, solos = _fleet_and_solos(cuda)
    report = fleet.calibrate(4, steps=4, seq_len=16)
    for i, dep in solos.items():
        solo = dep.calibrate(4, steps=4, seq_len=16)
        assert np.asarray(solo.losses, np.float32).tolist() == report.losses[:, i].tolist()
        chip = fleet.chip(i)
        assert _tensors_bitwise(dep.adapters, chip.adapters), i
        assert _tensors_bitwise([*dep.opt_state], [*chip.opt_state]), i
        assert chip.step == dep.step == 4


def test_fleet_calibration_graph_is_bitwise_the_eager_steps(cuda, monkeypatch):
    """``Fleet.calibrate`` builds one step over its chips and captures it
    once; every chip's losses, adapters and AdamW state equal the eager
    step functions run from the same start on the fleet's stream; no
    kernel launches."""
    from repro_torch.deploy import calibration_batch
    from repro_torch.deploy import deployment as D
    from repro_torch.fleet import fleet as F

    fleet, _ = _fleet_and_solos(cuda, chips=())
    batch = calibration_batch(fleet.cfg, 4, 16)
    starts = [(F._clone(F._rows(fleet.adapters, c)),
               F._clone(F._rows(fleet.optimizer_state(), c))) for c in range(3)]
    captures = _count_captures(monkeypatch)
    K.reset_launch_counts()
    C.reset_launch_counts()
    report = fleet.calibrate(batch, steps=5)
    torch.cuda.synchronize()
    assert set(K.launch_counts().values()) == {0} and C.launch_counts() == {"crossbar_mvm": 0}
    assert len(captures) == 1
    for c in range(3):
        dep = fleet.chip(c)
        dep.base = F._take(fleet.base, c)
        losses, state = _eager_calibration(dep, starts[c], D._device_batch(batch, cuda), 5,
                                           True, fleet._calib_stream())
        assert losses == report.losses[:, c].tolist(), (c, losses)
        got = fleet.chip(c)
        assert _tensors_bitwise(state.adapters, got.adapters), c
        assert _tensors_bitwise([*state.opt_state], [*got.opt_state]), c


def test_fleet_serve_prefill_is_the_solo_sessions(cuda):
    """``fleet.serve(i)``'s prefill logits through the kernels bitwise the
    solo deployment's session's, after calibration, for both launchers."""
    fleet, solos = _fleet_and_solos(cuda)
    fleet.calibrate(4, steps=3, seq_len=16)
    for dep in solos.values():
        dep.calibrate(4, steps=3, seq_len=16)
    g = torch.Generator().manual_seed(4)
    for rows, launcher in ((3, "dora_linear_gemv"), (30, "dora_linear")):
        tokens = torch.randint(0, fleet.cfg.vocab, (3, rows), generator=g).to(cuda)
        for i, dep in solos.items():
            K.reset_launch_counts()
            got, _ = fleet.serve(i).prefill(tokens, rows + 8)
            torch.cuda.synchronize()
            assert K.launch_counts()[launcher] > 0, K.launch_counts()
            want, _ = dep.serve().prefill(tokens, rows + 8)
            assert _bytes_equal(want, got), (i, rows)


def test_fleet_warm_start_on_the_card_names_its_source(cuda, tmp_path):
    """A fleet recorded into a registry, aged and reset, warm-starts every
    chip on the card from the nearest reference (named: one of the
    recorded keys, none of them the chip's current one), its calibration's
    mean loss over the chips below the cold start's at the same codes. A
    chip's nearest reference may be a sibling's (the device features of
    two chips can lie closer than a chip's own drift states): per chip the
    warm start is not always the lower."""
    import numpy as np

    from repro_torch.registry import CalibrationRegistry

    fleet, _ = _fleet_and_solos(cuda, chips=())
    reg = CalibrationRegistry(str(tmp_path))
    fleet.calibrate(4, steps=6, seq_len=16, registry=reg)
    recorded = {reg.key_for(fleet.cfg, fleet.backend, fleet.chip_signature(c)).name
                for c in range(3)}
    fleet.advance(24.0)
    fleet.reset_adapters()
    cold = fleet.calibrate(4, steps=3, seq_len=16, record=False)
    fleet.reset_adapters()
    warm = fleet.calibrate(4, steps=3, seq_len=16, registry=reg, warm_start=True)
    assert warm.warm_started_chips == [0, 1, 2] and cold.warm_started_chips == []
    for c, name in zip(warm.chips, warm.warm_sources):
        key = reg.key_for(fleet.cfg, fleet.backend, fleet.chip_signature(c))
        source, version = name.split("@")
        assert version == "v1" and source in recorded and source != key.name
    assert warm.initial_loss.mean() < cold.initial_loss.mean()
    assert warm.final_loss.mean() < cold.final_loss.mean()


# tensor-parallel serving (substrate.ShardedPrepared): a rank launches the
# kernel on its contiguous column block of a leaf, planned for the whole
# leaf (plan_n), and must produce the unsharded launch's columns bit for
# bit; the blocks of a (., 2) and a (., 4) mesh
BLOCK_M = [("gemv", 1), ("gemv", 4), ("gemv", 32), ("tiled", 1), ("tiled", 4), ("tiled", 32),
           ("tiled", 96), ("tiled", 256)]


def _column_block(ops, i, size):
    """Operands of block ``i`` of ``size``: contiguous column slices of the
    codes, scale, B and gamma; x and A whole."""
    x, gp, gn, scale, a, b, gamma = ops
    w = gp.shape[-1] // size
    cut = [t[:, i * w:(i + 1) * w].contiguous() for t in (gp, gn, scale)]
    return (x, *cut, a, b[:, i * w:(i + 1) * w].contiguous(),
            gamma[:, i * w:(i + 1) * w].contiguous())


@pytest.mark.parametrize("accum", autotune.ACCUMS)
@pytest.mark.parametrize("launcher,m", BLOCK_M, ids=[f"{k}-{m}" for k, m in BLOCK_M])
@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_column_block_is_the_whole_leafs_columns(cuda, leaf, launcher, m, accum):
    _, k, n, r = leaf
    fn = K.dora_linear_gemv if launcher == "gemv" else K.dora_linear
    ops = operands(m, k, n, r, cuda, seed=m)
    whole = fn(*ops, accum=accum)
    for size in (2, 4):
        w = n // size
        for i in range(size):
            got = fn(*_column_block(ops, i, size), accum=accum, plan_n=n)
            torch.cuda.synchronize()
            assert torch.equal(got, whole[:, i * w:(i + 1) * w]), (size, i)


@pytest.mark.parametrize("accum", autotune.ACCUMS)
@pytest.mark.parametrize("launcher,m", [("gemv", 4), ("tiled", 96)])
def test_column_block_plans_for_the_whole_leaf(cuda, launcher, m, accum, monkeypatch):
    """The launch policy of a block is asked about the whole leaf's N: the
    narrow test, the GEMV's parts of K and the tiled body's tiles."""
    _, k, n, r = LEAVES[2]
    seen = []
    for name in ("use_narrow", "gemv_plan", "tiled_tiles"):
        real = getattr(autotune, name)

        def spy(*args, _real=real, _name=name):
            seen.append((_name, args[0] if _name == "use_narrow" else args[1]))
            return _real(*args)

        monkeypatch.setattr(autotune, name, spy)
    fn = K.dora_linear_gemv if launcher == "gemv" else K.dora_linear
    fn(*_column_block(operands(m, k, n, r, cuda), 1, 2), accum=accum, plan_n=n)
    torch.cuda.synchronize()
    assert seen and all(width == n for _, width in seen), seen
    assert {"gemv_plan" if launcher == "gemv" else "tiled_tiles"} <= {s for s, _ in seen}


def _mesh_rank(rank, world, device, accum):
    """One rank of a (1, 2) mesh on the card: the qwen3-1.7b smoke session
    sharded over both ranks; rank 0 also serves it single-device."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device=device).advance(24)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 6)))
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (3, 30)))
    session = dep.serve(accum=accum, mesh=make_host_mesh((1, 2), device=device))
    K.reset_launch_counts()
    out = {"stats": session.shard_stats, "streams": session.generate(prompt, gen_len=6)[0],
           "logits": session.prefill(tokens.to(device), 40)[0].cpu(),
           "launches": K.launch_counts(), "compile_count": session.compile_count()}
    if rank == 0:
        solo = dep.serve(accum=accum)
        out["solo_streams"] = solo.generate(prompt, gen_len=6)[0]
        out["solo_logits"] = solo.prefill(tokens.to(device), 40)[0].cpu()
    return out


@pytest.mark.parametrize("accum", autotune.ACCUMS)
def test_two_rank_mesh_on_one_card_is_the_single_device_session(cuda, accum):
    """Two ranks on cuda:0 over gloo: greedy streams and prefill logits
    (90 rows: the tiled launcher) bitwise the single-device session's, the
    kernels launched, the mesh's steps eager (compile_count: the steps
    built, no graph)."""
    from repro_torch.launch.mesh import run_ranks

    ranks = run_ranks(_mesh_rank, 2, device="cuda", timeout=600, args=(accum,))
    solo = ranks[0]
    for got in ranks:
        assert got["stats"]["sharded"] > 0 and got["stats"]["replicated"] == 0, got["stats"]
        assert (got["streams"] == solo["solo_streams"]).all()
        assert torch.equal(got["logits"], solo["solo_logits"])
        suffix = "" if accum == "f32" else "/int8"
        assert got["launches"]["dora_linear_gemv" + suffix] > 0, got["launches"]
        assert got["launches"]["dora_linear" + suffix] > 0, got["launches"]
        assert got["compile_count"] > 0
