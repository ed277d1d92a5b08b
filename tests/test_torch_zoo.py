"""Port parity: the dense configs of the zoo that need no new layer kind,
deepseek-coder-33b (llama-arch: GQA 8 / 2 heads of 8, gated SiLU MLP,
untied head) and minitron-8b (LayerNorm, ungated ReLU MLP, untied head),
against ``repro`` at their smoke configs on the reference's teacher
params (key 0) carried across: the full forward, and a token-by-token
``decode_step`` loop against the reference's loop. The FULL configs
carry the published widths; those of mixtral-8x22b and deepseek-v2-lite
(whose models ``test_torch_moe`` and ``test_torch_mla`` hold) too.

Bounds (``test_torch_model``'s, relative to the reference's absmax):
``F32_BOUND`` in f32 (only summation orders differ) and ``BF16_BOUND``
in bf16 as shipped."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_arch as t_arch
from repro_torch.interop import from_reference
from repro_torch.models import transformer as TT

from test_torch_model import BF16_BOUND, F32_BOUND, np_tree

ARCHS = ("deepseek_coder_33b", "minitron_8b")
B, S = 2, 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", ARCHS + ("mixtral_8x22b", "deepseek_v2_lite_16b"))
def test_full_config_is_the_reference_s(arch):
    """Registered under both spellings, with the reference's FULL and
    SMOKE fields (the reference's ``remat`` and the layer kinds the port
    has no field for aside)."""
    assert arch in ARCH_IDS
    assert t_arch(arch.replace("_", "-")) is t_arch(arch)
    for size in ("full", "smoke"):
        _same_fields(getattr(j_arch(arch), size), getattr(t_arch(arch), size), size)


def _same_fields(want, got, path):
    """Every field of the port's dataclass equals the reference's (dtypes
    by name, nested configs field by field)."""
    for f in dataclasses.fields(got):
        a, b = getattr(want, f.name), getattr(got, f.name)
        where = f"{path}.{f.name}"
        if isinstance(b, torch.dtype):
            assert jnp.dtype(a).name == str(b).removeprefix("torch."), where
        elif dataclasses.is_dataclass(b):
            _same_fields(a, b, where)
        else:
            assert a == b, where


def _pair(arch, dtype):
    cfg_j, cfg_t = j_arch(arch).smoke, t_arch(arch).smoke
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, dtype=torch.float32)
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, params, from_reference(np_tree(params), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_loop_match_reference(arch, dtype):
    cfg_j, cfg_t, pj, pt = _pair(arch, dtype)
    bound = F32_BOUND if dtype == "float32" else BF16_BOUND
    tokens = np.random.default_rng(1).integers(0, cfg_j.vocab, (B, S)).astype(np.int32)
    want = np.asarray(JT.forward(pj, {"tokens": jnp.asarray(tokens)}, cfg_j), np.float32)
    with torch.no_grad():
        got = TT.forward(pt, {"tokens": torch.from_numpy(tokens).long()}, cfg_t)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= bound * np.abs(want).max()

    step = jax.jit(lambda p, c, tok, i: JT.decode_step(p, c, tok, i, cfg_j))
    cache_j = JT.init_cache(cfg_j, B, S)
    cache_t = TT.init_cache(cfg_t, B, S, "cpu")
    for i in range(S):
        lj, cache_j = step(pj, cache_j, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        with torch.no_grad():
            lt, cache_t = TT.decode_step(pt, cache_t, torch.from_numpy(tokens[:, i:i + 1]).long(),
                                         i, cfg_t)
        lj = np.asarray(lj, np.float32)
        assert np.abs(lt.float().numpy() - lj).max() <= bound * np.abs(lj).max(), i
