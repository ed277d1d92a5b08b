"""Port parity: the Mixture-of-Experts slice (``repro_torch.models.moe``,
its branches in ``models/transformer.py``, the rolling chunk path of
``models/attention.py::chunk_attention``, per-matrix programming and the
(G, E, r, k) merge in ``core/calibrate.py``, the engine and the
deployment lifecycle) against ``repro`` at the mixtral smoke config
(d 64, 4 layers, 4 experts, top-2, window 16), on numpy inputs made from
a seed and params carried across with ``repro_torch.interop``.

Bounds, relative to the reference's absmax where they say so:

* routing (``_route_row``): ``slot_token`` bitwise always; ``slot_gate``
  bitwise where every softmax exponent is exact in both frameworks
  (logits of 0 and -200: ties, drops, a padded tail of zero logits), and
  within ``GATE_RTOL`` (a few f32 ulps) on random logits, since XLA's
  f32 ``exp`` and PyTorch's differ in the last bit on ~9% of inputs;
* ``F32_BOUND`` (1e-5, ``test_torch_model``'s): f32 tensors whose only
  difference is the summation order;
* ``BF16_BOUND`` (3e-2, ``test_torch_model``'s): bf16 as shipped;
* ``NORM_RTOL`` (1e-5): merged DoRA magnitudes, f32 einsums over 64-128
  rows in another order;
* the whole bf16 model (``test_forward_matches_reference``): per-position
  max differences within ``BF16_BOUND`` at the median and a relative
  Frobenius error within ``MOE_BF16_FROB`` (0.1). bf16 rounding differs
  between the frameworks, and a token whose router has a near-tie
  between its second and third expert may go to another expert, which
  moves that position's logits by up to ~0.15 of absmax and, through
  attention, later ones a little; the f32 case holds the same model
  (routing included) to ``F32_BOUND``;
* decode against forward: the reference's own bound for that check,
  rtol = atol = 0.15 (``tests/test_models.py``);
* calibration losses: ``test_torch_calibrate``'s ``F32_RTOL`` (1e-4).

The reference's threefry draws cannot be reproduced in torch, so
``program_model`` is given them (``ref_program_draws``). Greedy streams
are equal, or split at a reference near-tie
(``test_torch_serve.assert_streams_match``).
"""
import dataclasses
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import substrate as jsub
from repro.configs import get_arch as j_arch
from repro.core import calibrate as jcal
from repro.core.dora import AdapterConfig as JAdapterConfig
from repro.deploy import Deployment as JDeployment
from repro.deploy import ServeEngine as JEngine
from repro.deploy.deployment import calibration_batch as j_calibration_batch
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import substrate as tsub
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.core.dora import AdapterConfig as TAdapterConfig
from repro_torch.deploy import Deployment, ServeEngine
from repro_torch.interop import from_reference
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

from test_torch_calibrate import F32_RTOL, port_np, to_port_batch
from test_torch_model import BF16_BOUND, F32_BOUND, np_tree, random_lora_b
from test_torch_serve import assert_streams_match

GATE_RTOL = 5e-7
MOE_BF16_FROB = 0.1
NORM_RTOL = 1e-5
DECODE_TOL = 0.15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cfg_pair(dtype="bfloat16", **moe):
    cfg_j, cfg_t = j_arch("mixtral_8x22b").smoke, t_arch("mixtral_8x22b").smoke
    if moe:
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe, **moe))
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe, **moe))
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, dtype=torch.float32)
    return cfg_j, cfg_t


def t(x):
    return torch.from_numpy(np.array(x))


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def ref_program_draws(base_j, key):
    """Per RRAM leaf path, the normals the reference's ``program_model``
    draws for it (``fold_in(key, crc32(path))``; a stacked leaf splits
    that key per matrix, and each matrix's drift splits it into (kp, kn)),
    in the leaf's shape."""
    out = {}

    def leaf(path, x):
        if jcal._is_rram_leaf(path):
            k = jax.random.fold_in(key, jnp.uint32(zlib.crc32(jcal._path_str(path).encode())))
            mats = x.shape[-2:]
            n = math.prod(x.shape[:-2])
            keys = k[None] if x.ndim == 2 else jax.random.split(k, n)
            draw = jax.vmap(lambda kk, i: jax.random.normal(jax.random.split(kk)[i], mats),
                            in_axes=(0, None))
            out[jcal._path_str(path)] = tuple(
                t(np.asarray(draw(keys, i)).reshape(x.shape)) for i in (0, 1))
        return x

    jax.tree_util.tree_map_with_path(leaf, base_j)
    return out


@pytest.fixture(scope="module")
def model():
    """The reference's f32 mixtral smoke: teacher params (key 0), codes
    (key 1), random non-zero B factors; carried across."""
    cfg_j, cfg_t = cfg_pair("float32")
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jcal.program_model(params["base"], cfg_j.rram, jax.random.PRNGKey(1),
                               mode="codes")
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=3)
    return {"cfg": (cfg_j, cfg_t), "params": params, "codes": codes,
            "adapters_np": adapters_np,
            "base_t": from_reference(np_tree(params["base"]), "cpu"),
            "codes_t": from_reference(np_tree(codes), "cpu"),
            "adapters_t": from_reference(adapters_np, "cpu")}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

ROUTE_CASES = {
    # (logits kind, capacity factor): capacity = ceil(S * k * cf / E)
    "random": ("random", 2.0),
    "random-drops": ("random", 0.5),
    "ties": ("ties", 2.0),
    "ties-drops": ("ties", 0.5),
    "padded-tail-drops": ("padded", 0.75),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_row_bitwise(case):
    kind, cf = ROUTE_CASES[case]
    s, e = 12, 4
    cfg_j = JM.MoeConfig(d_model=8, d_ff=16, n_experts=e, top_k=2, capacity_factor=cf)
    cfg_t = TM.MoeConfig(d_model=8, d_ff=16, n_experts=e, top_k=2, capacity_factor=cf)
    rng = np.random.default_rng(len(case))
    if kind == "random":
        logits = (rng.standard_normal((s, e)) * 2).astype(np.float32)
    else:  # every exponent exactly 1 or 0: probabilities 1/m, exact ties
        logits = rng.choice(np.float32([0.0, -200.0]), (s, e)).astype(np.float32)
        logits[np.arange(s), rng.integers(0, e, s)] = 0.0
        if kind == "padded":  # a chunk's zero-padded tail: router logits all 0
            logits[-4:] = 0.0
    x = rng.standard_normal((s, 8)).astype(np.float32)
    capacity = TM.capacity_of(s, cfg_t)
    assert capacity == int(max(1, -(-s * 2 * cf // e)))
    tok_j, gate_j = JM._route_row(jnp.asarray(x), jnp.asarray(logits), cfg_j, capacity)
    tok_t, gate_t = TM._route_row(t(x), t(logits), cfg_t, capacity)
    assert tok_t.dtype == torch.int32 and tok_t.shape == (e * capacity,)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    if kind == "random":
        np.testing.assert_allclose(gate_t.numpy(), np.asarray(gate_j), rtol=GATE_RTOL)
    else:
        np.testing.assert_array_equal(gate_t.numpy(), np.asarray(gate_j))
    if cf < 1:  # some token dropped: fewer filled slots than s * top_k
        assert int((tok_t < s).sum()) < s * 2
    if kind == "padded":  # the tail loses capacity before any real token
        kept = set(tok_t[tok_t < s].tolist())
        assert kept & set(range(s - 4)) == set(range(s - 4)) or not kept & {s - 4, s - 3}


def test_route_row_batched_is_per_row():
    cfg = TM.MoeConfig(d_model=8, d_ff=16, n_experts=4, top_k=2, capacity_factor=1.0)
    rng = np.random.default_rng(5)
    logits = t(rng.standard_normal((3, 10, 4)).astype(np.float32))
    x = torch.zeros((3, 10, 8))
    tok, gate = TM._route_row(x, logits, cfg, 5)
    for b in range(3):
        tb, gb = TM._route_row(x[b], logits[b], cfg, 5)
        assert torch.equal(tok[b], tb) and torch.equal(gate[b], gb)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------


def _moe_params(cfg_j, dtype_j, stacks):
    acfg = JAdapterConfig(rank=4, kind="dora")
    base, adapters = JM.init_moe(jax.random.PRNGKey(4), cfg_j, acfg, dtype=dtype_j)
    adapters_np = random_lora_b(np_tree(adapters), seed=8)
    if stacks == "codes":
        base = jcal.program_model(base, jcal.RramConfig(relative_drift=0.1),
                                  jax.random.PRNGKey(5), mode="codes")
    return acfg, base, adapters_np


MOE_CASES = ([(path, dtype, False, "float") for path in ("dispatch", "chunk", "decode")
              for dtype in ("float32", "bfloat16")]
             + [(path, "float32", True, "float") for path in ("dispatch", "decode")]
             + [(path, "float32", False, "codes") for path in ("chunk", "decode")])


@pytest.mark.parametrize("path,dtype,shared,stacks", MOE_CASES,
                         ids=["-".join(map(str, c)) for c in MOE_CASES])
def test_moe_block_matches_reference(path, dtype, shared, stacks):
    """The dispatch path (a prompt, a chunk with a zero-padded tail) and
    the dense decode path, unmerged DoRA side-cars with non-zero B, the
    stacks as floats or codes (the router then runs through the codes
    backend); ``n_shared=1`` with ``routed_scale`` 2.5 for the shared
    experts."""
    extra = dict(n_shared=1, routed_scale=2.5) if shared else {}
    cfg_j = JM.MoeConfig(d_model=32, d_ff=48, n_experts=4, top_k=2, capacity_factor=1.0,
                         **extra)
    cfg_t = TM.MoeConfig(d_model=32, d_ff=48, n_experts=4, top_k=2, capacity_factor=1.0,
                         **extra)
    dtype_j, dtype_t = ((jnp.float32, torch.float32) if dtype == "float32"
                        else (jnp.bfloat16, torch.bfloat16))
    acfg_j, base_j, adapters_np = _moe_params(cfg_j, dtype_j, stacks)
    acfg_t = TAdapterConfig(rank=4, kind="dora")
    base_t = from_reference(np_tree(base_j), "cpu")
    adapters_t = from_reference(adapters_np, "cpu")
    adapters_j = jax.tree_util.tree_map(jnp.asarray, adapters_np)
    rng = np.random.default_rng(11)
    s = 1 if path == "decode" else 10
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    if path == "chunk":
        x[:, -3:] = 0.0  # the padded tail of a chunk (zero rows)
    xj, xt = jnp.asarray(x).astype(dtype_j), t(x).to(dtype_t)
    with jsub.use_backend("codes"):
        want = JM.moe_block(xj, base_j, adapters_j, cfg_j, acfg_j)
    with tsub.use_backend("codes"), torch.no_grad():
        got = TM.moe_block(xt, base_t, adapters_t, cfg_t, acfg_t)
    assert got.dtype == dtype_t and got.shape == x.shape
    bound = F32_BOUND if dtype == "float32" else BF16_BOUND
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) <= bound


def test_moe_matches_dense_oracle_no_drops():
    """The dispatch path with capacity_factor = E / top_k (no token can be
    dropped) is the gate-weighted sum over every expert: the port's
    dispatch against its own dense decode path, token by token (f32)."""
    cfg = TM.MoeConfig(d_model=16, d_ff=32, n_experts=4, top_k=2, capacity_factor=2.0)
    acfg = TAdapterConfig(kind="none")
    base, _ = TM.init_moe(torch.Generator().manual_seed(0), cfg, acfg, dtype=torch.float32)
    x = torch.randn((2, 6, 16), generator=torch.Generator().manual_seed(1))
    y = TM.moe_block(x, base, None, cfg, acfg)
    dense = torch.cat([TM.moe_block(x[:, i:i + 1], base, None, cfg, acfg)
                       for i in range(6)], dim=1)
    assert torch.allclose(y, dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("top_k,n_experts,cf", [(2, 4, 1.0), (6, 16, 1.25), (3, 4, 0.5)])
def test_gather_combine_is_the_scatter_add_bitwise(top_k, n_experts, cf):
    """The dispatch path's combine (``_gather_sum`` over ``_token_slots``)
    and its dispatch backward equal the scatter-add they replace bitwise on
    the CPU (adds in slot order onto zero), at top-2, deepseek-v2-lite's
    top-6 and with dropped tokens (f32)."""
    cfg = TM.MoeConfig(d_model=16, d_ff=24, n_experts=n_experts, top_k=top_k,
                       capacity_factor=cf)
    acfg = TAdapterConfig(rank=2, kind="dora")
    base, ad = TM.init_moe(torch.Generator().manual_seed(1), cfg, acfg, dtype=torch.float32)
    x = torch.randn((2, 12, 16), generator=torch.Generator().manual_seed(2), requires_grad=True)
    bsz, s, d = x.shape
    capacity = TM.capacity_of(s, cfg)
    logits = TM.L.linear(x.float(), base["router"], ad["router"], acfg)
    slot_token, slot_gate = TM._route_row(x, logits, cfg, capacity)
    slots = TM._token_slots(slot_token, s, top_k)
    held = slots < n_experts * capacity
    assert (held.sum(-1) <= top_k).all() and int(held.sum()) == int((slot_token < s).sum())
    idx = slot_token.long()[..., None].expand(bsz, n_experts * capacity, d)
    x_pad = torch.cat([x, x.new_zeros((bsz, 1, d))], dim=1)
    v = torch.randn((bsz, n_experts * capacity, d), generator=torch.Generator().manual_seed(3))
    want = torch.zeros((bsz, s + 1, d)).scatter_add_(1, idx, v)[:, :s]
    assert torch.equal(TM._gather_sum(v, slots), want)
    g = torch.randn((bsz, n_experts * capacity, d), generator=torch.Generator().manual_seed(4))
    (want_grad,) = torch.autograd.grad(torch.gather(x_pad, 1, idx), x, g)
    (got_grad,) = torch.autograd.grad(TM._Dispatch.apply(x_pad, slot_token, slots), x, g)
    assert torch.equal(got_grad, want_grad)


def test_load_balancing_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((20, 4)) * 2).astype(np.float32)
    idx = rng.integers(0, 4, (20, 2)).astype(np.int32)
    want = float(JM.load_balancing_loss(jnp.asarray(logits), jnp.asarray(idx), 4))
    got = float(TM.load_balancing_loss(t(logits), t(idx), 4))
    assert got == pytest.approx(want, rel=1e-6)


def test_init_moe_given_the_reference_draws():
    """``init_moe(draws=)``: the reference's normals and A's uniforms give
    its base bitwise (bf16 stacks, f32 router) and its side-cars."""
    cfg_j = JM.MoeConfig(d_model=16, d_ff=24, n_experts=3, top_k=2)
    cfg_t = TM.MoeConfig(d_model=16, d_ff=24, n_experts=3, top_k=2)
    acfg_j, acfg_t = JAdapterConfig(rank=4, kind="dora"), TAdapterConfig(rank=4, kind="dora")
    key = jax.random.PRNGKey(3)
    base_j, ad_j = JM.init_moe(key, cfg_j, acfg_j)
    keys = jax.random.split(key, 5)
    kw, ka = jax.random.split(keys[0])
    draws = {"router": t(jax.random.normal(kw, (16, 3))),
             "router/lora_a": t(jax.random.uniform(ka, (16, 4)))}
    ka3 = jax.random.split(keys[4], 3)
    for i, (name, shape) in enumerate((("gate_w", (3, 16, 24)), ("up_w", (3, 16, 24)),
                                       ("down_w", (3, 24, 16)))):
        draws[name] = t(jax.random.normal(keys[1 + i], shape))
        ke = jax.random.split(ka3[i], 3)
        draws[f"{name}/lora_a"] = t(np.stack([np.asarray(jax.random.uniform(
            ke[j], shape[1:2] + (4,))) for j in range(3)]))
    base_t, ad_t = TM.init_moe(None, cfg_t, acfg_t, draws=draws)
    for name in ("gate_w", "up_w", "down_w"):
        assert base_t[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(base_t[name].float().numpy(),
                                      np.asarray(base_j[name], np.float32))
    np.testing.assert_array_equal(base_t["router"]["w"].numpy(),
                                  np.asarray(base_j["router"]["w"]))
    for name in ("router", "gate_w", "up_w", "down_w"):
        np.testing.assert_array_equal(ad_t[name]["lora_a"].float().numpy(),
                                      np.asarray(ad_j[name]["lora_a"], np.float32))
        np.testing.assert_allclose(ad_t[name]["dora_m"].float().numpy(),
                                   np.asarray(ad_j[name]["dora_m"], np.float32), rtol=1e-6)


# ---------------------------------------------------------------------------
# programming, merging, counting
# ---------------------------------------------------------------------------


def _codes_equal(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _codes_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        for i, (a, b) in enumerate(zip(want, got)):
            _codes_equal(a, b, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def test_program_model_expert_stacks_bitwise_given_draws(model):
    """Every leaf, the (G, E, d, k) expert stacks (programmed one matrix
    at a time) and the router included, bitwise the reference's codes."""
    cfg_j, cfg_t = model["cfg"]
    noise = ref_program_draws(model["params"]["base"], jax.random.PRNGKey(1))
    got = tcal.program_model(model["base_t"], cfg_t.rram, 0, mode="codes", noise=noise)
    assert got["body"][0]["ffn"]["gate_w"].g_pos.shape == (4, 4, 64, 128)
    _codes_equal(np_tree(model["codes"]), port_np_codes(got))
    deq = tcal.program_model(model["base_t"], cfg_t.rram, 0, mode="dequant", noise=noise)
    want = jcal.program_model(model["params"]["base"], cfg_j.rram, jax.random.PRNGKey(1),
                              mode="dequant")
    _codes_equal(np_tree(want), port_np(deq))


def port_np_codes(tree):
    from repro_torch.core.rram import CrossbarWeight

    if isinstance(tree, CrossbarWeight):
        return {k: getattr(tree, k).numpy() for k in ("g_pos", "g_neg", "scale")}
    if isinstance(tree, dict):
        return {k: port_np_codes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [port_np_codes(v) for v in tree]
    return port_np(tree)


def test_port_expert_stacks_replay_from_seed_one_draw_per_matrix():
    """The port's own streams: programming and drift of a (G, E, d, k)
    stack replay bitwise from the seed, and each matrix draws its own
    noise (no two matrices of the stack drift alike)."""
    cfg = t_arch("mixtral_8x22b").smoke
    base = TT.init_params(torch.Generator().manual_seed(0), cfg)["base"]

    def codes():
        c = tcal.program_model(base, cfg.rram, 7, mode="codes")
        return tcal.drift_model(c, cfg.rram, 7, hours=24.0, event_index=0)

    a, b = codes(), codes()
    xa, xb = a["body"][0]["ffn"]["up_w"], b["body"][0]["ffn"]["up_w"]
    assert torch.equal(xa.g_pos, xb.g_pos) and torch.equal(xa.g_neg, xb.g_neg)
    undrifted = tcal.program_model(base, cfg.rram, 7, mode="codes")["body"][0]["ffn"]["up_w"]
    moved = (xa.g_pos.int() - undrifted.g_pos.int()).flatten(2)
    assert not torch.equal(moved[0, 0], moved[0, 1]) and not torch.equal(moved[0, 0], moved[1, 0])


def test_merge_adapters_for_serve_on_expert_stacks(model):
    """``dora_m_merged`` over the whole tree: (G, E, r, k) expert side-cars
    per scan group, the (G, r, k) attention and router side-cars, the
    untied head."""
    codes_j = model["codes"]
    adapters_j = jax.tree_util.tree_map(jnp.asarray, model["adapters_np"])
    want = jcal.merge_adapters_for_serve(codes_j, adapters_j)
    got = tcal.merge_adapters_for_serve(model["codes_t"], model["adapters_t"])
    lb = got["body"][0]["ffn"]["gate_w"]["lora_b"]
    assert lb.dim() == 4 and "dora_m" not in got["body"][0]["ffn"]["gate_w"]

    def walk(w, g, path=""):
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                walk(w[k], g[k], f"{path}/{k}")
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(w, g)):
                walk(a, b, f"{path}/{i}")
        else:
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       rtol=NORM_RTOL, err_msg=path)

    walk(want, got)


def test_counts_match_reference(model):
    cfg_j, cfg_t = model["cfg"]
    pj = {"base": model["params"]["base"], "adapters": model["params"]["adapters"]}
    pt = {"base": model["base_t"], "adapters": model["adapters_t"]}
    assert TT.count_params(pt) == JT.count_params(pj)
    assert TT.active_param_fraction(cfg_t, pt) == pytest.approx(
        JT.active_param_fraction(cfg_j, pj), rel=1e-12)
    codes = {"base": model["codes_t"], "adapters": {}}
    assert TT.count_params(codes)[0] == TT.count_params(pt)[0]


def test_unported_kinds_still_raise():
    """MoE, MLA (deepseek-v2-lite), the encoder (seamless-m4t), the vision
    prefix (paligemma), the SSM (falcon-mamba) and RG-LRU (recurrentgemma)
    are ported: an ssm or rglru mixer is accepted with its config and
    refused without it (``ValueError``), and a config that carries the
    ``rglru`` field is accepted. A mixer or FFN kind the port does not know
    still raises ``NotImplementedError``."""
    cfg = t_arch("mixtral_8x22b").smoke
    TT._check_supported(cfg)
    ssm = t_arch("falcon-mamba-7b").smoke.ssm
    TT._check_supported(dataclasses.replace(cfg, mixer_pattern=("ssm",), ssm=ssm))
    rglru = t_arch("recurrentgemma-9b").smoke.rglru
    TT._check_supported(dataclasses.replace(cfg, mixer_pattern=("rglru",), rglru=rglru))
    TT._check_supported(dataclasses.replace(cfg, rglru=rglru))
    with pytest.raises(ValueError, match="an rglru mixer needs cfg.rglru"):
        TT._check_supported(dataclasses.replace(cfg, mixer_pattern=("rglru",)))
    for kinds in ({"mixer_pattern": ("mamba2",)}, {"ffn_pattern": ("glu",)}):
        with pytest.raises(NotImplementedError, match="not ported"):
            TT._check_supported(dataclasses.replace(cfg, **kinds))

    for size in ("full", "smoke"):  # deepseek-v2-lite, seamless-m4t, paligemma accepted
        mla = getattr(t_arch("deepseek-v2-lite"), size)
        assert mla.attn.mla
        TT._check_supported(mla)
        TT._check_supported(dataclasses.replace(cfg, encoder_layers=2))
        TT._check_supported(getattr(t_arch("seamless-m4t-large-v2"), size))
        TT._check_supported(dataclasses.replace(cfg, vision_tokens=2))
        TT._check_supported(getattr(t_arch("paligemma-3b"), size))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(model, dtype):
    """Teacher forward and the codes deployment's forward (dequant and
    codes backends, merged side-cars)."""
    cfg_j, cfg_t = cfg_pair(dtype)
    params = model["params"]
    if dtype == "bfloat16":  # the f32 teacher in the bf16 config's leaf dtypes
        like = jax.eval_shape(lambda k: JT.init_params(k, cfg_j), jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(lambda x, s: x.astype(s.dtype), params, like)
    base_t = from_reference(np_tree(params["base"]), "cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg_j.vocab, (2, 20)).astype(np.int32)
    want = JT.forward(params, {"tokens": jnp.asarray(tokens)}, cfg_j)
    got = TT.forward({"base": base_t, "adapters": from_reference(
        np_tree(params["adapters"]), "cpu")}, {"tokens": t(tokens).long()}, cfg_t)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "bfloat16":
        per_position = np.abs(got - want).max(-1) / np.abs(want).max()
        assert np.median(per_position) <= BF16_BOUND
        assert np.linalg.norm(got - want) <= MOE_BF16_FROB * np.linalg.norm(want)
    else:
        assert rel_err(got, want) <= F32_BOUND
        adapters_j = jax.tree_util.tree_map(jnp.asarray, model["adapters_np"])
        merged_j = jcal.merge_adapters_for_serve(model["codes"], adapters_j)
        merged_t = tcal.merge_adapters_for_serve(model["codes_t"], model["adapters_t"])
        for backend in ("dequant", "codes"):
            pj = {"base": model["codes"], "adapters": merged_j}
            pt = {"base": model["codes_t"], "adapters": merged_t}
            if backend == "codes":
                pj["base"] = jsub.prepare_base_for_serve(model["codes"], merged_j, cfg_j)
                pt["base"] = tsub.prepare_base_for_serve(model["codes_t"], merged_t, cfg_t)
            with jsub.use_backend(backend):
                want = JT.forward(pj, {"tokens": jnp.asarray(tokens)}, cfg_j)
            with tsub.use_backend(backend), torch.no_grad():
                got = TT.forward(pt, {"tokens": t(tokens).long()}, cfg_t)
            assert rel_err(got.numpy(), want) <= F32_BOUND, backend


def test_feature_loss_and_gradients_match_reference(model):
    """``feature_calibration_loss`` over the drifted codes (read back under
    ``dequant``) and its gradients w.r.t. every side-car, the experts'
    stacked (G, E, ...) ones included, against ``jax.grad`` (f32)."""
    cfg_j, cfg_t = model["cfg"]
    adapters_j = jax.tree_util.tree_map(jnp.asarray, model["adapters_np"])
    batch_j = j_calibration_batch(cfg_j, 2, 16)
    with jsub.use_backend("dequant"):
        (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
            lambda ad: JT.feature_calibration_loss(model["params"]["base"], model["codes"],
                                                   ad, batch_j, cfg_j), has_aux=True))(adapters_j)
    with tsub.use_backend("dequant"):
        loss_t, grads_t = tcal.value_and_grad(
            lambda ad: TT.feature_calibration_loss(model["base_t"], model["codes_t"], ad,
                                                   to_port_batch(batch_j), cfg_t)[0],
            model["adapters_t"])
    assert float(loss_t) == pytest.approx(float(loss_j), rel=F32_RTOL)
    gj, gt = np_tree(grads_j), port_np(grads_t)
    assert gt["body"][0]["ffn"]["down_w"]["lora_b"].shape == (4, 4, 4, 64)

    def walk(w, g, path=""):
        if isinstance(w, dict):
            for k in w:
                walk(w[k], g[k], f"{path}/{k}")
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(w, g)):
                walk(a, b, f"{path}/{i}")
        else:
            scale = max(np.abs(w).max(), 1e-12)
            assert np.abs(g - w).max() <= 1e-4 * scale, path

    walk(gj, gt)


def test_decode_steps_match_forward():
    """Token-by-token decode logits against the full forward (teacher, no
    drift), through the rolling window cache: the reference's check and
    bound, with the sequence past the window."""
    cfg = t_arch("mixtral_8x22b").smoke
    params = TT.init_params(torch.Generator().manual_seed(0), cfg)
    p = {"base": params["base"], "adapters": TT._empty_adapters(params["adapters"])}
    s = 24  # > window 16: the cache wraps
    tokens = torch.randint(0, cfg.vocab, (2, s), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = TT.forward(p, {"tokens": tokens}, cfg, use_adapters=False).float()
        cache = TT.init_cache(cfg, 2, s, "cpu")
        assert cache["body"][0]["k"].shape[2] == 16
        dec = torch.cat([TT.decode_step(p, cache, tokens[:, i:i + 1], i, cfg)[0]
                         for i in range(s)], dim=1).float()
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=DECODE_TOL, atol=DECODE_TOL)


# ---------------------------------------------------------------------------
# the rolling chunk path
# ---------------------------------------------------------------------------

# (pos0, n_valid, width) chunks in order on one rolling cache (window 16,
# max_len 40): one longer than the window, then chunks across the wrap,
# one with a padded tail
ROLLING_CHUNKS = [(0, 20, 32), (20, 5, 8), (25, 8, 8), (33, 3, 8)]


def test_rolling_chunk_attention_matches_reference():
    acfg_j, acfg_t = JAdapterConfig(rank=4, kind="dora"), TAdapterConfig(rank=4, kind="dora")
    cj = JA.AttentionConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, window=16)
    ct = TA.AttentionConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, window=16)
    base_j, ad_j = JA.init_attention(jax.random.PRNGKey(0), cj, acfg_j, jnp.float32)
    ad_np = random_lora_b(np_tree(ad_j), seed=1)
    base_t, ad_t = from_reference(np_tree(base_j), "cpu"), from_reference(ad_np, "cpu")
    ad_j = jax.tree_util.tree_map(jnp.asarray, ad_np)
    max_len = 40
    ref_chunk = jax.jit(lambda x, c, p0, n: JA.chunk_attention(
        x, c, p0, n, base_j, ad_j, cj, acfg_j, max_len=max_len))
    cache_j = JA.init_kv_cache(1, max_len, cj, jnp.float32)
    cache_t = TA.init_kv_cache(1, max_len, ct, "cpu", torch.float32)
    assert cache_t["k"].shape[1] == 16 < max_len
    rng = np.random.default_rng(4)
    for pos0, n, width in ROLLING_CHUNKS:
        x = rng.standard_normal((1, width, 32)).astype(np.float32)
        x[:, n:] = 0.0
        y_j, cache_j = ref_chunk(jnp.asarray(x), cache_j, jnp.asarray([pos0]),
                                 jnp.asarray([n]))
        k_before = cache_t["k"]
        with torch.no_grad():
            y_t, new = TA.chunk_attention(t(x), cache_t, torch.tensor([pos0]),
                                          torch.tensor([n]), base_t, ad_t, ct, acfg_t,
                                          max_len=max_len)
        assert new["k"] is k_before  # written in place
        assert rel_err(y_t[:, :n].numpy(), np.asarray(y_j)[:, :n]) <= F32_BOUND
        for name in ("k", "v"):
            np.testing.assert_allclose(new[name].numpy(), np.asarray(cache_j[name]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} at {pos0}")


def test_rolling_chunks_match_the_fused_forward():
    """A prompt admitted in rolling chunks gives the full forward's logits
    at each chunk's last position (window 16, max_len 40, f32)."""
    cfg = dataclasses.replace(t_arch("mixtral_8x22b").smoke, dtype=torch.float32)
    params = TT.init_params(torch.Generator().manual_seed(2), cfg)
    tokens = torch.randint(0, cfg.vocab, (1, 37), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full = TT.forward(params, {"tokens": tokens}, cfg)
        cache = TT.init_cache(cfg, 1, 40, "cpu")
        for a, b in ((0, 20), (20, 28), (28, 37)):
            chunk = torch.zeros((1, 32), dtype=torch.int64)
            chunk[0, :b - a] = tokens[0, a:b]
            logits, _ = TT.prefill_chunk(params, chunk, cache, a, b - a, cfg, 40)
            err = (logits[0, 0] - full[0, b - 1]).abs().max()
            assert err <= 1e-4 * full[0, b - 1].abs().max(), (a, b)


# ---------------------------------------------------------------------------
# engine and lifecycle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deployments(model):
    """The reference deployment over the f32 model's teacher, codes and
    side-cars, drifted 24 h, and the port's carried across before it
    calibrates."""
    cfg_j, cfg_t = model["cfg"]
    adapters_j = jax.tree_util.tree_map(jnp.asarray, model["adapters_np"])
    dep_j = JDeployment(cfg_j, "codes", model["params"]["base"], model["codes"], adapters_j,
                        jax.random.PRNGKey(0), jax.random.PRNGKey(1)).advance(24)
    dep_t = Deployment.from_arrays(cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes),
                                   np_tree(dep_j.adapters), backend="codes",
                                   drift_hours=dep_j.drift_hours, device="cpu")
    return dep_j, dep_t


@pytest.mark.parametrize("backend", ["dequant", "codes"])
def test_engine_sliding_window_wraparound_matches_reference(deployments, backend):
    """The twin of the reference's ``test_ragged_parity_sliding_window_
    wraparound``: max_len 40 (window 16, so the cache rolls), prompts of
    14 and 20 tokens, 8 greedy tokens, staggered submits on 2 slots."""
    dep_j, dep_t = deployments
    dep_j.backend = dep_t.backend = backend
    dep_j._refresh_base()
    dep_t._refresh_base()
    try:
        s_j, s_t = dep_j.serve(), dep_t.serve()
        rng = np.random.default_rng(12)
        prompts = [rng.integers(0, s_j.cfg.vocab, (n,)).astype(np.int32) for n in (14, 20)]
        streams = []
        for engine_cls, session in ((JEngine, s_j), (ServeEngine, s_t)):
            engine = engine_cls(session, max_slots=2, max_len=40)
            reqs = []
            for p in prompts:
                reqs.append(engine.submit(p, max_new=8))
                engine.step()
                engine.step()
            engine.run()
            assert all(r.done and len(r.tokens) == 8 for r in reqs)
            streams.append([list(r.tokens) for r in reqs])
        for p, ref, got in zip(prompts, *streams):
            assert_streams_match(s_j, p, ref, got)
    finally:
        dep_j.backend = dep_t.backend = "codes"
        dep_j._refresh_base()
        dep_t._refresh_base()


def test_deployment_calibrate_and_serve_match_reference(deployments):
    """``program(codes)`` -> ``advance(24)`` -> ``calibrate`` -> ``serve``:
    per-step losses and the trained side-cars against the reference's
    (f32), then greedy streams through the engine."""
    dep_j, dep_t = deployments
    batch_j = j_calibration_batch(dep_j.cfg, 4, 16)
    rj = dep_j.calibrate(batch_j, steps=4)
    rt = dep_t.calibrate(to_port_batch(batch_j), steps=4)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=F32_RTOL)
    assert rt.final_loss < rt.initial_loss
    assert (rt.base_params, rt.adapter_params) == (rj.base_params, rj.adapter_params)
    for name in ("gate_w", "router"):
        np.testing.assert_allclose(
            dep_t.adapters["body"][0]["ffn"][name]["lora_b"].numpy(),
            np.asarray(dep_j.adapters["body"][0]["ffn"][name]["lora_b"]), atol=5e-5)
    s_j, s_t = dep_j.serve(), dep_t.serve()
    prompt = np.random.default_rng(13).integers(0, s_j.cfg.vocab, (1, 18)).astype(np.int32)
    ref, _ = s_j.generate(jnp.asarray(prompt), gen_len=6)
    got, _ = s_t.generate(torch.as_tensor(prompt), gen_len=6)
    assert_streams_match(s_j, prompt[0], np.asarray(ref)[0], got[0])
