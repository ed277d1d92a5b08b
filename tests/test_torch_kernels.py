"""Port parity: the fused crossbar + DoRA linear. On the CPU the port's
launchers take their plain PyTorch version; they are held against the
reference's Pallas launchers (interpret mode, whole-extent blocks so no
operand is padded) and ``repro.kernels.ref.dora_linear_ref`` at
rtol = atol = 1e-4, the tolerance ``tests/test_kernels.py`` sets for the
f32 kernel. The adapters carry random non-zero A, B and gamma so the
low-rank path and the epilogue are exercised."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dora_linear as jk
from repro.kernels import ref as jref
from repro_torch.kernels import autotune
from repro_torch.kernels import dora_linear as tk

TOL = dict(rtol=1e-4, atol=1e-4)

# ragged M (both sides of GEMV_MAX_M), K and N multiples of nothing, r in
# {1, 4, 12}; then M at the engine's admission-chunk buckets 8, 16 and 32;
# then the tiled range with the edges its tensor-core body masks on the
# card (K not a multiple of 8, N not a multiple of 16, M not a multiple of
# the tile)
CASES = [
    (1, 37, 53, 1), (2, 100, 77, 4), (7, 129, 61, 12),
    (64, 45, 130, 4), (65, 77, 33, 12), (130, 31, 97, 1),
    (8, 50, 64, 4), (16, 33, 96, 1), (32, 70, 48, 12),
    (96, 130, 77, 8), (128, 257, 31, 5), (200, 300, 999, 3),
    # narrow N (the MoE routers' f32 x on the card): N = 8 and 64 with K
    # over two slabs, N = 7 with R = 3 (neither a multiple of 4)
    (4, 260, 8, 8), (96, 300, 64, 8), (33, 150, 7, 3),
]

# qwen3-1.7b fused serve leaves: (K, N)
LEAVES = {"qkv": (2048, 4096), "o": (2048, 2048), "gate_up": (2048, 12288),
          "down": (6144, 2048)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operands(m, k, n, r, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    gp = rng.integers(0, 256, (k, n), dtype=np.uint8)
    gn = rng.integers(0, 256, (k, n), dtype=np.uint8)
    scale = (rng.uniform(0.5, 1.5, (1, n)) * 1e-3).astype(np.float32)
    a = (rng.standard_normal((k, r)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal((r, n)) * 0.05).astype(np.float32)
    gamma = rng.uniform(0.5, 2.0, (1, n)).astype(np.float32)
    return x, gp, gn, scale, a, b, gamma


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", CASES)
def test_launchers_match_reference(m, k, n, r, dtype):
    x, *ops = _operands(m, k, n, r, seed=m + k + n + r)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ops_j = [jnp.asarray(o) for o in ops]
    ops_t = [torch.from_numpy(o) for o in ops]
    y_ref = np.asarray(jref.dora_linear_ref(xj, *ops_j))
    y_tiled = tk.dora_linear(xt, *ops_t)
    assert y_tiled.dtype == torch.float32 and tuple(y_tiled.shape) == (m, n)
    np.testing.assert_allclose(y_tiled.numpy(), y_ref, **TOL)
    y_jt = jk.dora_linear(xj, *ops_j, bm=m, bn=n, bk=k, interpret=True)
    np.testing.assert_allclose(y_tiled.numpy(), np.asarray(y_jt), **TOL)
    if m <= autotune.GEMV_MAX_M:
        y_gemv = tk.dora_linear_gemv(xt, *ops_t)
        y_jg = jk.dora_linear_gemv(xj, *ops_j, bn=n, bk=k, interpret=True)
        np.testing.assert_allclose(y_gemv.numpy(), np.asarray(y_jg), **TOL)
        np.testing.assert_allclose(y_gemv.numpy(), y_ref, **TOL)
    else:
        with pytest.raises(ValueError, match="at most"):
            tk.dora_linear_gemv(xt, *ops_t)


def test_cpu_path_launches_no_kernel():
    x, *ops = _operands(3, 16, 8, 2, seed=0)
    tk.reset_launch_counts()
    tk.dora_linear_gemv(torch.from_numpy(x), *map(torch.from_numpy, ops))
    tk.dora_linear(torch.from_numpy(x), *map(torch.from_numpy, ops))
    assert tk.launch_counts() == {"dora_linear_gemv": 0, "dora_linear": 0,
                                  "dora_linear_gemv/int8": 0, "dora_linear/int8": 0}


@pytest.mark.parametrize("grad_of", ["x", "scale", "a", "b", "gamma"])
@pytest.mark.parametrize("accum", autotune.ACCUMS)
@pytest.mark.parametrize("launcher", [tk.dora_linear, tk.dora_linear_gemv],
                         ids=["dora_linear", "dora_linear_gemv"])
def test_wrappers_refuse_autograd(launcher, accum, grad_of):
    """The kernels have no backward: an operand that requires grad under
    grad mode raises, on the CPU as on the card; under ``torch.no_grad()``
    the same call returns the plain result, and nothing counts a launch."""
    names = ("x", "g_pos", "g_neg", "scale", "a", "b", "gamma")
    ops = [torch.from_numpy(o) for o in _operands(5, 24, 16, 3, seed=1)]
    want = launcher(*ops, accum=accum)
    ops[names.index(grad_of)].requires_grad_(True)
    tk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward.*dequant"):
        launcher(*ops, accum=accum)
    with torch.no_grad():
        got = launcher(*ops, accum=accum)
    assert torch.equal(got, want) and not got.requires_grad
    assert set(tk.launch_counts().values()) == {0}


@pytest.mark.parametrize("m,expect", [(1, 1), (3, 4), (33, 64), (64, 64)])
def test_gemv_row_bucket(m, expect):
    assert autotune.use_gemv(m)
    assert autotune.gemv_rows(m) == expect


def test_dispatch_rule_at_gemv_max_m():
    assert autotune.use_gemv(autotune.GEMV_MAX_M)
    assert not autotune.use_gemv(autotune.GEMV_MAX_M + 1)
    with pytest.raises(ValueError):
        autotune.gemv_rows(autotune.GEMV_MAX_M + 1)


@pytest.mark.parametrize("m", [96, 256])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
@pytest.mark.parametrize("accum", autotune.ACCUMS)
def test_tiled_tiles_fill_the_card(accum, leaf, m):
    """At the phase-5 prefill (96 rows) and at 256 rows every full-width
    leaf launches at least one block per SM, counting K splits; K is split
    only while the blocks fit one wave. For each tensor-core body."""
    k, n = LEAVES[leaf]
    plan = autotune.tiled_tiles(m, n, k, accum)
    assert plan.blocks(m, n, k) >= autotune.SMS
    assert plan.splits(k) == 1 or plan.blocks(m, n, k) <= autotune.WAVE


@pytest.mark.parametrize("m,k,n", [
    (65, 2048, 4096), (96, 2048, 2048), (200, 6144, 2048), (512, 2048, 12288),
    (96, 130, 77), (128, 257, 31), (200, 300, 999), (1, 33, 4097), (70, 31, 9),
])
@pytest.mark.parametrize("accum", autotune.ACCUMS)
def test_tiled_tiles_cover_each_element_once(accum, m, k, n):
    """The tiles cover M and N, and the K splits are whole stages of the
    body that partition [0, K): consecutive, none empty, none past K."""
    plan = autotune.tiled_tiles(m, n, k, accum)
    stage = autotune.MMA_BODIES[accum]
    assert plan.bm in autotune.MMA_TILE_M and plan.k_split % stage == 0
    assert plan.bm * -(-m // plan.bm) >= m > plan.bm * (-(-m // plan.bm) - 1)
    parts = [(s * plan.k_split, min(k, (s + 1) * plan.k_split)) for s in range(plan.splits(k))]
    assert parts[0][0] == 0 and parts[-1][1] == k
    assert all(lo < hi for lo, hi in parts)
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert plan.k_split >= min(k, autotune.MIN_SPLIT_ROWS) or plan.splits(k) == 1


@pytest.mark.parametrize("m", autotune.GEMV_ROW_BUCKETS)
@pytest.mark.parametrize("leaf", sorted(LEAVES))
@pytest.mark.parametrize("accum", autotune.ACCUMS)
def test_gemv_plan_fills_the_card(accum, leaf, m):
    """At every row bucket, every full-width leaf's launch fits one wave,
    so its blocks run at once. f32: at least one block of column strip and
    K part per SM, the whole launch (X @ A blocks included) within two an
    SM. int8: the whole launch within the blocks the SMs hold at once
    (gemv_int8_wave), with the most parts that keep it there."""
    k, n = LEAVES[leaf]
    parts = autotune.gemv_plan(m, n, k, accum)
    blocks = autotune.gemv_blocks(m, n, k, parts, accum)
    if accum == "f32":
        assert -(-n // autotune.GEMV_MMA_COLS) * parts >= autotune.SMS
        assert blocks <= autotune.WAVE
    else:
        wave = autotune.gemv_int8_wave(m)
        assert blocks <= wave
        assert autotune.gemv_blocks(m, n, k, 0, accum) <= autotune.GEMV_XA_CHUNKS
        assert (parts == -(-k // autotune.GEMV_MMA_STAGE)
                or autotune.gemv_blocks(m, n, k, parts + 1, accum) > wave)



@pytest.mark.parametrize("m,k,n", [
    (4, 2048, 4096), (32, 6144, 2048), (1, 2048, 12288), (64, 2048, 2048),
    (4, 40, 4096), (5, 1000, 2048), (9, 2050, 999), (17, 6144, 2049), (1, 33, 4097),
    (64, 6144, 20480),
])
@pytest.mark.parametrize("accum", autotune.ACCUMS)
def test_gemv_plan_parts_partition_k(accum, m, k, n):
    """The K parts of either tensor-core GEMV body, bounded as the kernels
    bound them (kb, ke of dora_gemv_mma_kernel and dora_gemv_int8_kernel,
    checked in test_tile_constants_match_the_kernel), are whole stages
    that partition [0, K) in order: consecutive, none empty, none past K."""
    parts = autotune.gemv_plan(m, n, k, accum)
    stages = -(-k // autotune.GEMV_MMA_STAGE)
    assert 1 <= parts <= stages
    ranges = [(p * stages // parts * autotune.GEMV_MMA_STAGE,
               min(k, (p + 1) * stages // parts * autotune.GEMV_MMA_STAGE)) for p in range(parts)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_tiled_binding_matches_the_c_signature():
    """The ctypes argument list of every C function has as many entries as
    its declaration in csrc/dora_linear.cu has parameters."""
    import re
    from types import SimpleNamespace

    src = tk.LIB.src.read_text()
    names = ("rimc_dora_linear_gemv", "rimc_dora_linear_gemv_mma", "rimc_dora_linear_gemv_int8",
             "rimc_dora_linear_tiled", "rimc_dora_linear_narrow", "rimc_xa_scratch",
             "rimc_gemv_mma_sems", "rimc_capture_id")
    lib = SimpleNamespace(**{nm: SimpleNamespace() for nm in names})
    tk._bind(lib)
    for nm in names:
        params = re.search(rf"int {nm}\(([^)]*)\)", src).group(1)
        assert len(getattr(lib, nm).argtypes) == params.count(",") + 1, nm


def test_tile_constants_match_the_kernel():
    """The policy's stage depths and tile widths per tensor-core body, and
    the GEMVs' X @ A tiling that their plans count, are the kernels'; both
    tensor-core GEMVs (f32 and int8) take the same strip and stage and
    bound their K parts as test_gemv_plan_parts_partition_k does."""
    import re

    src = tk.LIB.src.read_text()
    for name, value in (("kMmaK", autotune.MMA_BODIES["f32"]),
                        ("kMmaKInt8", autotune.MMA_BODIES["int8"]),
                        ("kMmaN", autotune.MMA_TILE_N),
                        ("kGemvMmaN", autotune.GEMV_MMA_COLS),
                        ("kGemvMmaK", autotune.GEMV_MMA_STAGE),
                        ("kGemvXaChunks", autotune.GEMV_XA_CHUNKS),
                        ("kPrepRows", autotune.XA_SLAB),
                        ("kPrepRowTile", autotune.XA_ROW_TILE),
                        ("kNarrowMaxN", autotune.NARROW_MAX_N),
                        ("kNarrowM", autotune.NARROW_ROWS),
                        ("kNarrowSlab", autotune.MIN_SPLIT_ROWS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value
    # the narrow body bounds its parts as test_narrow_plan_parts_partition_k
    # does, and its C entry refuses more parts than slabs and wider N
    for line in ("const int sb = part * slabs / parts, se = (part + 1) * slabs / parts;",
                 "const int kb = sb * kNarrowSlab, ke = min(K, se * kNarrowSlab);",
                 "const int m0 = tile * kNarrowM, rows = min(kNarrowM, M - m0);",
                 "N > kNarrowMaxN",
                 "parts > (K + kNarrowSlab - 1) / kNarrowSlab"):
        assert src.count(line) == 1, line
    # the int8 GEMV's wave: two blocks an SM below 8 tiles of rows (64
    # rows), one at 64, by its launch bounds, its shared memory held to
    # that; and its X @ A blocks, at most kGemvXaChunks in all
    assert "__launch_bounds__(kGemvThreads, NT < 8 ? 2 : 1)" in src
    assert 'static_assert(NT == 8 || 2 * (BYTES + 1024 + 512) <= 233472' in src
    assert [autotune.gemv_int8_wave(m) // autotune.SMS for m in autotune.GEMV_ROW_BUCKETS] == [
        2, 2, 2, 2, 2, 2, 1]
    assert "const int slabs = prep_chunks(o.K), chunks = kGemvXaChunks / XT;" in src
    # each line twice: dora_gemv_mma_kernel and dora_gemv_int8_kernel, or
    # the C entries of both, which refuse more parts than the plan gives
    for line in ("const int stages = (K + kGemvMmaK - 1) / kGemvMmaK;",
                 "const int kb = part * stages / parts * kGemvMmaK;",
                 "const int ke = min(K, (part + 1) * stages / parts * kGemvMmaK);",
                 "const int n0 = strip * kGemvMmaN;",
                 "parts > (K + kGemvMmaK - 1) / kGemvMmaK"):
        assert src.count(line) == 2, line


@pytest.mark.parametrize("m", autotune.GEMV_ROW_BUCKETS)
def test_int8_gemv_row_scales_in_the_launch_at_the_decode_tick(m):
    """The int8 GEMV takes its row scales inside its one launch below
    GEMV_INT8_PRESCALE_ROWS rows (every decode tick of up to 4 slots among
    them), and in a pass of their own from there up."""
    assert autotune.gemv_int8_prescale(m) == (autotune.gemv_rows(m)
                                              >= autotune.GEMV_INT8_PRESCALE_ROWS)
    if m <= 4:
        assert not autotune.gemv_int8_prescale(m)


# the routers (mixtral-8x22b K 6144 N 8; deepseek-v2-lite K 2048 N 64) at
# every GEMV row bucket and the tiled rows, then ragged K and M, K within
# one slab, and K of one row
NARROW_SHAPES = [(m, k, n) for k, n in ((6144, 8), (2048, 64))
                 for m in (1, 2, 4, 8, 16, 32, 64, 96, 256)]
NARROW_SHAPES += [(5, 6100, 7), (33, 6100, 60), (200, 1000, 64), (1, 40, 8), (3, 1, 5),
                  (4096, 2048, 64)]


@pytest.mark.parametrize("m,k,n", NARROW_SHAPES)
def test_narrow_plan_parts_partition_k(m, k, n):
    """The narrow body's parts, bounded as dora_narrow_kernel bounds them
    (checked in test_tile_constants_match_the_kernel), are whole slabs of
    MIN_SPLIT_ROWS rows that partition [0, K) in order: consecutive, none
    empty, none past K, each of at least MIN_SPLIT_ROWS rows but the last,
    which ends at K's ragged last slab."""
    parts = autotune.narrow_plan(m, n, k)
    slabs = -(-k // autotune.MIN_SPLIT_ROWS)
    assert 1 <= parts <= slabs
    ranges = [(p * slabs // parts * autotune.MIN_SPLIT_ROWS,
               min(k, (p + 1) * slabs // parts * autotune.MIN_SPLIT_ROWS)) for p in range(parts)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi - lo >= autotune.MIN_SPLIT_ROWS for lo, hi in ranges[:-1])
    assert all(lo % autotune.MIN_SPLIT_ROWS == 0 for lo, _ in ranges)
    assert ranges[-1][0] < k


@pytest.mark.parametrize("m,k,n", NARROW_SHAPES)
def test_narrow_plan_fills_one_wave(m, k, n):
    """The launch (row tiles x parts) fits one wave of two blocks an SM,
    and takes every part it may: one more would need a part of fewer
    slabs, which puts more blocks on the card than that wave (or more
    parts than slabs)."""
    parts = autotune.narrow_plan(m, n, k)
    tiles = -(-m // autotune.NARROW_ROWS)
    slabs = -(-k // autotune.MIN_SPLIT_ROWS)
    assert autotune.WAVE == 2 * autotune.SMS
    assert tiles * parts <= autotune.WAVE or parts == 1
    per = max(-(-slabs // parts) - 1, 1)
    assert parts == slabs or tiles * -(-slabs // per) > autotune.WAVE
    if (m, k, n) in ((1, 6144, 8), (4, 6144, 8), (32, 6144, 8)):
        assert parts == 48  # one slab a block at the router's decode rows


@pytest.mark.parametrize("n,accum,f32_x,narrow", [
    (8, "f32", True, True), (64, "f32", True, True), (1, "f32", True, True),
    (65, "f32", True, False), (8, "f32", False, False), (8, "int8", True, False),
    (64, "int8", False, False), (2048, "f32", True, False),
])
def test_narrow_dispatch_rule(n, accum, f32_x, narrow):
    """f32 x with the f32 body at N <= NARROW_MAX_N runs the narrow body
    (either launcher); bf16 x, the int8 body and N = 65 do not."""
    assert autotune.NARROW_MAX_N == 64
    assert autotune.use_narrow(n, accum, f32_x) is narrow
