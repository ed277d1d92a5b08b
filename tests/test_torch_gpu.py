"""The port's CUDA kernels on the card (marker ``gpu``; each test skips
inside itself when no CUDA device is present). The kernels are held
against their plain PyTorch version at qwen3-1.7b's full-width fused
leaves and at ragged shapes, rtol = atol = 1e-4 (exact f32 arithmetic
in both; only the summation order differs).

This file imports no jax, so it runs where only PyTorch is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core.rram import program
from repro_torch.kernels import autotune
from repro_torch.kernels import dora_linear as K
from repro_torch.kernels.ref import dora_linear_ref

pytestmark = pytest.mark.gpu

# qwen3-1.7b fused serve leaves: (name, K, N, fused rank)
LEAVES = [("qkv", 2048, 4096, 24), ("o", 2048, 2048, 8),
          ("gate_up", 2048, 12288, 16), ("down", 6144, 2048, 8)]
RAGGED = [(7, 1000, 999, 3), (65, 130, 77, 12), (1, 33, 4097, 1), (130, 257, 31, 5),
          (5, 300, 200, 4), (9, 96, 4096, 2), (17, 1000, 1024, 3)]


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


@pytest.mark.parametrize("leaf", LEAVES, ids=[lf[0] for lf in LEAVES])
def test_tiled_full_width(cuda, leaf):
    _, k, n, r = leaf
    _check(K.dora_linear, operands(256, k, n, r, cuda))


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
    assert K.launch_counts() == {"dora_linear_gemv": 1, "dora_linear": 1}


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
    engine = ServeEngine(session, max_slots=2, max_len=64)
    reqs = [engine.submit(torch.arange(n) % cfg.vocab, max_new=6) for n in (3, 40)]
    engine.run()
    logits, _ = session.prefill(torch.randint(0, cfg.vocab, (3, 30), device=cuda), 40)
    counts = K.launch_counts()
    assert all(len(r.tokens) == 6 for r in reqs)
    assert torch.isfinite(logits.float()).all()
    assert counts["dora_linear_gemv"] > 0 and counts["dora_linear"] > 0
