"""Port parity: the int8 body of the fused crossbar linear
(``accum="int8"``) against the reference. On the CPU the port's launchers
take their plain version (``kernels/ref.py``); the reference runs its
Pallas launchers in interpret mode.

Tolerances:
* row quantization (``quantize_rows``: xq, xs), the offset recode and the
  int32 accumulator are integer or exactly rounded results: bitwise;
* the exactness case (integer x in [-127, 127] with 127 in every row, so
  xs = 1 and xq = x; scale = gamma = 1, A = B = 0, K <= 512) makes the
  output the int32 sum itself, |acc| < 2^24: bitwise;
* otherwise the same xq, xs and int32 sum meet f32 products whose order
  differs (Xq @ A, the epilogue): within 1e-4 of the output's absmax;
* against the f32 body, the reference's own int8 tolerance: 2% of the
  output's absmax (``tests/test_kernels.py``).
Greedy streams of ``serve(accum="int8")`` are held as in
``tests/test_torch_serve.py`` (equal, or a divergence at a bf16 near-tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dora_linear as jk
from repro.substrate import exec as jexec
from repro_torch.kernels import dora_linear as tk
from repro_torch.kernels import ref as tref
from repro_torch.substrate import exec as texec

from test_torch_kernels import _operands
from test_torch_prepared import _leaf_pair
from test_torch_serve import GEN, _prompts, assert_streams_match, sessions  # noqa: F401

INT8_REL = 1e-4
INT8_VS_F32_REL = 2e-2

# M on both sides of GEMV_MAX_M (the engine's 8-row chunk bucket, a
# decode-sized 2, a 70-row and a 128-row prefill); ragged K and N
CASES = [(2, 37, 53, 1), (8, 100, 77, 4), (70, 129, 61, 12), (128, 45, 130, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _exact_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.float32)
    x[np.arange(m), rng.integers(0, k, m)] = 127.0
    gp = rng.integers(0, 256, (k, n), dtype=np.uint8)
    gn = rng.integers(0, 256, (k, n), dtype=np.uint8)
    one = np.ones((1, n), np.float32)
    return x, gp, gn, one, np.zeros((k, 1), np.float32), np.zeros((1, n), np.float32), one


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k", [(3, 50), (70, 257), (8, 512)])
def test_quantize_rows_and_recode_bitwise(m, k, dtype):
    rng = np.random.default_rng(m + k)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.01, 10, (m, 1))).astype(np.float32)
    x[0] = 0.0  # an all-zero row: xs = 1e-30 / 127
    xq_j, xs_j = jk._quantize_rows(jnp.asarray(x, jnp.dtype(dtype)))
    xq_t, xs_t = tref.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert xq_t.dtype == torch.int8 and xs_t.dtype == torch.float32
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))
    g = rng.integers(0, 256, (k, 9), dtype=np.uint8)
    np.testing.assert_array_equal(tref.recode_s8(torch.from_numpy(g)).numpy(),
                                  np.asarray(jk.recode_s8(jnp.asarray(g))))
    s8 = tref.recode_s8(torch.from_numpy(g))
    assert tref.recode_s8(s8) is s8


@pytest.mark.parametrize("m,k,n", [(4, 512, 33), (70, 300, 64)])
def test_int32_accumulator_bitwise(m, k, n):
    x, gp, gn, *_ = _operands(m, k, n, 1, seed=k)
    xq, _ = jk._quantize_rows(jnp.asarray(x))
    gp8, gn8 = jk.recode_s8(jnp.asarray(gp)), jk.recode_s8(jnp.asarray(gn))
    want = (jax.lax.dot(xq, gp8, preferred_element_type=jnp.int32)
            - jax.lax.dot(xq, gn8, preferred_element_type=jnp.int32))
    got = tref.int8_dot(torch.from_numpy(np.array(xq)), torch.from_numpy(gp),
                        torch.from_numpy(gn))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(4, 512, 40), (64, 300, 17), (90, 256, 24)])
def test_exactness_case_bitwise(m, k, n):
    ops = _exact_operands(m, k, n, seed=m)
    ops_j = [jnp.asarray(o) for o in ops]
    ops_t = [torch.from_numpy(o) for o in ops]
    want = np.asarray(jk.dora_linear(*ops_j, bm=m, bn=n, bk=k, interpret=True, accum="int8"))
    got = tk.dora_linear(*ops_t, accum="int8")
    np.testing.assert_array_equal(got.numpy(), want)
    xq, xs = tref.quantize_rows(ops_t[0])
    assert torch.all(xs == 1.0) and torch.equal(xq.to(torch.float32), ops_t[0])
    np.testing.assert_array_equal(
        got.numpy(), tref.int8_dot(xq, ops_t[1], ops_t[2]).to(torch.float32).numpy())
    if m <= 64:
        want_g = jk.dora_linear_gemv(*ops_j, bn=n, bk=k, interpret=True, accum="int8")
        np.testing.assert_array_equal(tk.dora_linear_gemv(*ops_t, accum="int8").numpy(),
                                      np.asarray(want_g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", CASES)
def test_launchers_match_reference(m, k, n, r, dtype):
    x, *ops = _operands(m, k, n, r, seed=m * k + n)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ops_j = [jnp.asarray(o) for o in ops]
    ops_t = [torch.from_numpy(o) for o in ops]
    want = np.asarray(jk.dora_linear(xj, *ops_j, bm=m, bn=n, bk=k, interpret=True,
                                     accum="int8"))
    tol = INT8_REL * np.abs(want).max()
    got = tk.dora_linear(xt, *ops_t, accum="int8")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if m <= 64:
        want_g = jk.dora_linear_gemv(xj, *ops_j, bn=n, bk=k, interpret=True, accum="int8")
        np.testing.assert_allclose(tk.dora_linear_gemv(xt, *ops_t, accum="int8").numpy(),
                                   np.asarray(want_g), rtol=0, atol=tol)
    f32 = tk.dora_linear(xt, *ops_t)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=0,
                               atol=INT8_VS_F32_REL * np.abs(f32.numpy()).max())


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_rimc_linear_int8_matches_reference(lead):
    xw_j, ad_j, xw_t, ad_t = _leaf_pair(k=40, n=24, r=3, seed=4)
    x = np.random.default_rng(3).standard_normal(lead + (40,)).astype(np.float32)
    want = np.asarray(jexec.rimc_linear(jnp.asarray(x), xw_j, ad_j, interpret=True,
                                        accum="int8"))
    got = texec.rimc_linear(torch.from_numpy(x), xw_t, ad_t, accum="int8")
    assert tuple(got.shape) == lead + (24,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=INT8_REL * np.abs(want).max())


def test_unknown_accum_raises():
    ops = [torch.from_numpy(o) for o in _operands(2, 8, 4, 1, seed=0)]
    with pytest.raises(ValueError, match="accum"):
        tk.dora_linear(*ops, accum="int4")


def test_cpu_int8_launches_no_kernel():
    ops = [torch.from_numpy(o) for o in _operands(3, 16, 8, 2, seed=0)]
    tk.reset_launch_counts()
    tk.dora_linear_gemv(*ops, accum="int8")
    tk.dora_linear(*ops, accum="int8")
    assert set(tk.launch_counts().values()) == {0}


# -- serving ------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_sessions(sessions):  # noqa: F811
    s_j, s_t = sessions
    return s_j.deployment.serve(accum="int8"), s_t.deployment.serve(accum="int8")


def test_serve_int8_options(int8_sessions):
    from repro_torch import substrate as tsub

    s_j, s_t = int8_sessions
    assert s_t.options == {"accum": "int8"} == s_j.options
    with s_t.scope():
        assert tsub.active_options() == {"accum": "int8"}
    with pytest.raises(ValueError, match="accum"):
        s_t.deployment.serve(accum="bf16")


def test_int8_session_generate_matches_reference(int8_sessions):
    s_j, s_t = int8_sessions
    prompt = np.random.default_rng(14).integers(0, s_j.cfg.vocab, (2, 6)).astype(np.int32)
    ref, _ = s_j.generate(jnp.asarray(prompt), gen_len=GEN)
    got, _ = s_t.generate(torch.as_tensor(prompt), gen_len=GEN)
    for i in range(2):
        assert_streams_match(s_j, prompt[i], np.asarray(ref)[i], got[i])


def test_int8_engine_matches_reference(int8_sessions):
    from repro.deploy import ServeEngine as JEngine
    from repro_torch.deploy import ServeEngine

    s_j, s_t = int8_sessions
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
        assert_streams_match(s_j, p, ref, got)
