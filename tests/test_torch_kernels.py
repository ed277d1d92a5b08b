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
# {1, 4, 12}; then M at the engine's admission-chunk buckets 8, 16 and 32
CASES = [
    (1, 37, 53, 1), (2, 100, 77, 4), (7, 129, 61, 12),
    (64, 45, 130, 4), (65, 77, 33, 12), (130, 31, 97, 1),
    (8, 50, 64, 4), (16, 33, 96, 1), (32, 70, 48, 12),
]


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
    assert tk.launch_counts() == {"dora_linear_gemv": 0, "dora_linear": 0}


@pytest.mark.parametrize("m,expect", [(1, 1), (3, 4), (33, 64), (64, 64)])
def test_gemv_row_bucket(m, expect):
    assert autotune.use_gemv(m)
    assert autotune.gemv_rows(m) == expect


def test_dispatch_rule_at_gemv_max_m():
    assert autotune.use_gemv(autotune.GEMV_MAX_M)
    assert not autotune.use_gemv(autotune.GEMV_MAX_M + 1)
    with pytest.raises(ValueError):
        autotune.gemv_rows(autotune.GEMV_MAX_M + 1)
