"""Port parity: the vision prefix (``repro_torch.models.transformer``'s
prefix-LM mask, forward, fused prefill, vision admission and chunks, the
calibration features and losses, ``Deployment.calibrate``, the engine's
vision slots, its counters and its hash chain) against ``repro`` at the
paligemma-3b smoke config (d 64, 4 layers of 4 heads of 16 and one KV
head, a gated tanh-GELU MLP of 128, RMSNorm, ``embed_scale``, a tied head
of 512, 8 patches), on the reference's params (key 0), codes (key 1) and
random non-zero adapter B factors, carried across with
``repro_torch.interop``, and patch embeddings drawn as the reference's
engine tests draw theirs (bf16 values).

Bounds, relative to the reference's absmax:

* ``F32_BOUND`` (1e-5, ``test_torch_model``'s): f32 tensors whose only
  difference is the summation order (the model, the caches, the
  features);
* ``BF16_BOUND`` (3e-2, ``test_torch_model``'s): the bf16 model as
  shipped;
* the losses ``F32_RTOL`` (1e-4, ``test_torch_calibrate``'s) and their
  gradients 1e-4 of each leaf's absmax; ``Deployment.calibrate``'s losses
  ``F32_RTOL`` per step;
* the engine's greedy tokens (f32): equal, or split at a near-tie of the
  reference's logits within ``F32_BOUND``;
* the prefix mask, the hash chain, the refusals' messages, the engine's
  counters and admission ticks, and a prefix hit against cold admission:
  exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.core import calibrate as jcal
from repro.deploy import Deployment as JDeployment
from repro.deploy import ServeEngine as JEngine
from repro.deploy import serving as jserving
from repro.deploy.deployment import calibration_batch as j_calibration_batch
from repro.deploy.engine import Request as JRequest
from repro.models import transformer as JT
from repro import substrate as jsub
from repro_torch import substrate as tsub
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import calibrate as tcal
from repro_torch.deploy import Deployment, ServeEngine, calibration_batch
from repro_torch.deploy import serving as tserving
from repro_torch.deploy.engine import Request
from repro_torch.interop import from_reference, to_tensor
from repro_torch.models import transformer as TT
from repro_torch.substrate import prepared as tprep

from test_torch_calibrate import F32_RTOL, port_np
from test_torch_model import BF16_BOUND, F32_BOUND, np_tree, random_lora_b
from test_torch_prefix import _bitwise, _engine, _serve

ARCH = "paligemma_3b"
B, S, P, D, GEN = 2, 10, 8, 64, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(x):
    return to_tensor(np.asarray(x), "cpu")


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def cfg_pair(dtype="float32"):
    cfg_j, cfg_t = j_arch(ARCH).smoke, t_arch(ARCH).smoke
    if dtype == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, dtype=torch.float32)
    return cfg_j, cfg_t


def patches(seed, n=P):
    """Patch embeddings (n, D), bf16 values in f32 as the reference's
    ``jax.random.normal(..., bfloat16)`` draws are."""
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def model():
    """The reference's f32 smoke: teacher params (key 0), codes (key 1),
    random non-zero B factors; carried across."""
    cfg_j, cfg_t = cfg_pair()
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jax.jit(lambda b: jcal.program_model(b, cfg_j.rram, jax.random.PRNGKey(1),
                                                 mode="codes"))(params["base"])
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=3)
    rng = np.random.default_rng(4)
    return {"cfg": (cfg_j, cfg_t), "params": params, "codes": codes,
            "adapters_np": adapters_np,
            "tokens": rng.integers(0, cfg_j.vocab, (B, S)).astype(np.int32),
            "patches": np.stack([patches(5 + i) for i in range(B)]),
            "params_t": {"base": from_reference(np_tree(params["base"]), "cpu"),
                         "adapters": from_reference(adapters_np, "cpu")},
            "params_j": {"base": params["base"],
                         "adapters": jax.tree_util.tree_map(jnp.asarray, adapters_np)}}


def test_config_registry_and_rolling_refusal():
    """Both spellings resolve; the published widths; the layer tree the
    reference's; a rolling (sliding-window) cache refuses a prefix, as the
    reference's chunk does."""
    arch = t_arch("paligemma-3b")
    assert arch is t_arch(ARCH)
    full = arch.full
    assert (full.n_layers, full.d_model, full.vision_tokens, full.vocab) == (18, 2048, 256,
                                                                               257216)
    params = TT.init_params(torch.Generator().manual_seed(0), arch.smoke)
    want = jax.eval_shape(lambda k: JT.init_params(k, j_arch(ARCH).smoke), jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_map(lambda x: tuple(x.shape), params)
            == jax.tree_util.tree_map(lambda x: tuple(x.shape), want))
    windowed = dataclasses.replace(cfg_pair()[1], mixer_pattern=("local",), local_window=4)
    pt = TT.init_params(torch.Generator().manual_seed(0), windowed)
    cache = TT.init_cache(windowed, 1, 16, "cpu")
    with pytest.raises(ValueError, match="non-rolling"), torch.no_grad():
        TT.prefill_vision(pt, torch.zeros((1, P, D)), cache, windowed, 16)


@pytest.mark.parametrize("s,prefix", [(5, 0), (12, 8), (8, 8), (9, 3)])
def test_prefix_mask_is_the_reference_s(s, prefix):
    np.testing.assert_array_equal(TT._prefix_mask(s, prefix).numpy(),
                                  np.asarray(JT._prefix_mask(s, prefix)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(model, dtype):
    """The forward over patches and tokens (the prefix-LM mask, logits
    for the text positions only) on the teacher with its side-cars; in f32
    also the codes deployment under ``codes`` (merged side-cars, the
    prepared tree: the kernels' plain versions here, the reference's
    Pallas kernels in interpret mode)."""
    cfg_j, cfg_t = cfg_pair(dtype)
    params = model["params_j"]
    if dtype == "bfloat16":
        like = jax.eval_shape(lambda k: JT.init_params(k, cfg_j), jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(lambda x, s: x.astype(s.dtype), params, like)
    batch_j = {"tokens": jnp.asarray(model["tokens"]),
               "patch_embeds": jnp.asarray(model["patches"])}
    batch_t = {"tokens": t(model["tokens"]).long(), "patch_embeds": t(model["patches"])}
    want = jax.jit(lambda p, b: JT.forward(p, b, cfg_j))(params, batch_j)
    with torch.no_grad():
        got = TT.forward({"base": from_reference(np_tree(params["base"]), "cpu"),
                          "adapters": from_reference(np_tree(params["adapters"]), "cpu")},
                         batch_t, cfg_t)
    assert tuple(got.shape) == (B, S, cfg_t.vocab)
    bound = F32_BOUND if dtype == "float32" else BF16_BOUND
    assert rel_err(got.float().numpy(), want) <= bound
    if dtype == "bfloat16":
        return
    merged_j = jcal.merge_adapters_for_serve(model["codes"], params["adapters"])
    prep_j = jsub.prepare_base_for_serve(model["codes"], merged_j, cfg_j)
    codes_t = from_reference(np_tree(model["codes"]), "cpu")
    merged_t = tcal.merge_adapters_for_serve(codes_t, model["params_t"]["adapters"])
    prep_t = tprep.prepare_base_for_serve(codes_t, merged_t, cfg_t)
    with jsub.use_backend("codes"):  # the backend is chosen at trace time
        want = jax.jit(lambda p, b: JT.forward(p, b, cfg_j))(
            {"base": prep_j, "adapters": merged_j}, batch_j)
    with tsub.use_backend("codes"), torch.no_grad():
        got = TT.forward({"base": prep_t, "adapters": merged_t}, batch_t, cfg_t)
    assert rel_err(got.numpy(), want) <= F32_BOUND


def test_prefill_and_decode_loop_match_reference(model):
    """The fused ``prefill`` behind the patches (last-position logits, the
    K/V of all P + S positions) and a ``decode_step`` loop from clock
    ``P + S``, against the reference's (f32); the plain ``generate`` loop
    behind the patches gives the reference's tokens."""
    cfg_j, cfg_t = model["cfg"]
    pj, pt = model["params_j"], model["params_t"]
    max_len = P + S + GEN
    toks, pe = model["tokens"], model["patches"]
    lj, cache_j = jax.jit(lambda p, x, v: JT.prefill(p, x, cfg_j, max_len, patch_embeds=v))(
        pj, jnp.asarray(toks), jnp.asarray(pe))
    with torch.no_grad():
        lt, cache_t = TT.prefill(pt, t(toks).long(), cfg_t, max_len, patch_embeds=t(pe))
    assert rel_err(lt.numpy(), lj) <= F32_BOUND
    ref_layers = [jax.tree_util.tree_map(lambda x: x[g], cache_j["body"])[0]
                  for g in range(cfg_j.n_layers)]
    for got, want in zip(TT._cache_layers(cache_t, cfg_t), ref_layers):
        for name in ("k", "v"):
            assert not got[name][:, P + S:].any()
            assert rel_err(got[name].numpy(), want[name]) <= F32_BOUND, name
    step = jax.jit(lambda p, c, tok, i: JT.decode_step(p, c, tok, i, cfg_j))
    nxt = np.random.default_rng(6).integers(0, cfg_j.vocab, (B, GEN)).astype(np.int32)
    for i in range(GEN):
        lj, cache_j = step(pj, cache_j, jnp.asarray(nxt[:, i:i + 1]), jnp.int32(P + S + i))
        with torch.no_grad():
            lt, cache_t = TT.decode_step(pt, cache_t, t(nxt[:, i:i + 1]).long(), P + S + i,
                                         cfg_t)
        assert rel_err(lt.numpy(), lj) <= F32_BOUND, i
    want, _ = jserving.generate(pj, jnp.asarray(toks), cfg_j, gen_len=GEN,
                                patch_embeds=jnp.asarray(pe))
    got, _ = tserving.generate(pt, t(toks).long(), cfg_t, gen_len=GEN, patch_embeds=t(pe))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_prefill_vision_then_chunks_match_reference(model):
    """``prefill_vision`` into a fresh cache (the K/V at [0, P), the rest
    untouched), then chunks with padded tails at ``P + a``: each chunk's
    logits and the caches against the reference's same calls, the last
    chunk's logits against the fused prefill's and each chunk's against
    the forward's at its last position (f32)."""
    cfg_j, cfg_t = model["cfg"]
    pj, pt = model["params_j"], model["params_t"]
    max_len = 24
    toks, pe = model["tokens"][:1], model["patches"][:1]
    vision = jax.jit(lambda p, v, c: JT.prefill_vision(p, v, c, cfg_j, max_len))
    chunk = jax.jit(lambda p, x, c, a, n: JT.prefill_chunk(p, x, c, a, n, cfg_j, max_len))
    cache_j = vision(pj, jnp.asarray(pe), JT.init_cache(cfg_j, 1, max_len))
    cache_t = TT.init_cache(cfg_t, 1, max_len, "cpu")
    with torch.no_grad():
        assert TT.prefill_vision(pt, t(pe), cache_t, cfg_t, max_len) is cache_t
        full = TT.forward(pt, {"tokens": t(toks).long(), "patch_embeds": t(pe)}, cfg_t)
        fused, _ = TT.prefill(pt, t(toks).long(), cfg_t, max_len, patch_embeds=t(pe))

    def same_caches():
        want_layers = [jax.tree_util.tree_map(lambda x: x[g], cache_j["body"])[0]
                       for g in range(cfg_j.n_layers)]
        for got, want in zip(TT._cache_layers(cache_t, cfg_t), want_layers):
            for name in ("k", "v"):
                assert rel_err(got[name].numpy(), want[name]) <= F32_BOUND, name

    same_caches()
    assert not any(c[name][:, P:].any() for c in TT._cache_layers(cache_t, cfg_t)
                   for name in ("k", "v"))
    for a, b in ((0, 3), (3, 8), (8, S)):
        x = np.zeros((1, 8), np.int32)
        x[0, :b - a] = toks[0, a:b]
        lj, cache_j = chunk(pj, jnp.asarray(x), cache_j, jnp.asarray([P + a], jnp.int32),
                            jnp.asarray([b - a], jnp.int32))
        with torch.no_grad():
            lt, _ = TT.prefill_chunk(pt, t(x).long(), cache_t, P + a, b - a, cfg_t, max_len)
        assert rel_err(lt.numpy(), lj) <= F32_BOUND, (a, b)
        assert rel_err(lt[0, 0].numpy(), full[0, b - 1].numpy()) <= F32_BOUND, (a, b)
        same_caches()
    assert rel_err(lt.numpy(), fused.numpy()) <= F32_BOUND


def test_teacher_features_and_losses_match_reference(model):
    """On the reference's calibration batch (tokens and bf16 patches):
    ``teacher_features``'s ``dec`` over P + S positions; the cached loss,
    the fused ``feature_calibration_loss`` and the cached loss's
    gradients over every side-car (f32, the codes read back under
    ``dequant``), the features and gradients against the reference's."""
    cfg_j, cfg_t = model["cfg"]
    batch_j = j_calibration_batch(cfg_j, 3, 8)
    assert batch_j["patch_embeds"].shape == (3, P, D)
    batch_t = {"tokens": t(batch_j["tokens"]).long(),
               "patch_embeds": t(batch_j["patch_embeds"])}
    assert batch_t["patch_embeds"].dtype == torch.bfloat16
    base_j, base_t = model["params"]["base"], model["params_t"]["base"]
    feats_j = jax.jit(lambda b, x: jcal.teacher_features(b, x, cfg_j))(base_j, batch_j)
    feats_t = tcal.teacher_features(base_t, batch_t, cfg_t)
    assert set(feats_t) == set(feats_j) == {"dec"}
    assert tuple(feats_t["dec"].shape) == (cfg_t.n_layers + 1, 3, P + 8, D)
    assert rel_err(feats_t["dec"].numpy(), feats_j["dec"]) <= F32_BOUND
    codes_t = from_reference(np_tree(model["codes"]), "cpu")
    ad_j, ad_t = model["params_j"]["adapters"], model["params_t"]["adapters"]
    loss_j = jcal.make_cached_calib_loss(cfg_j)
    with jsub.use_backend("dequant"):
        lj, gj = jax.jit(jax.value_and_grad(
            lambda ad: loss_j(ad, model["codes"], feats_j, batch_j)))(ad_j)
        fj = jax.jit(lambda ad: JT.feature_calibration_loss(
            base_j, model["codes"], ad, batch_j, cfg_j)[0])(ad_j)
    with tsub.use_backend("dequant"):
        loss_t = tcal.make_cached_calib_loss(cfg_t)
        lt, gt = tcal.value_and_grad(lambda ad: loss_t(ad, codes_t, feats_t, batch_t), ad_t)
        ft, aux = TT.feature_calibration_loss(base_t, codes_t, ad_t, batch_t, cfg_t)
    assert float(lt) == pytest.approx(float(lj), rel=F32_RTOL)
    assert float(ft) == pytest.approx(float(fj), rel=F32_RTOL)
    assert float(ft) == pytest.approx(float(lj), rel=F32_RTOL) and aux["feature_mse"] is ft
    gj, gt = np_tree(gj), port_np(gt)
    for path in (("body", 0, "mixer", "q"), ("body", 0, "mixer", "k"),
                 ("body", 0, "ffn", "gate"), ("body", 0, "ffn", "down")):
        w, g = gj, gt
        for key in path:
            w, g = w[key], g[key]
        for leaf in w:
            scale = max(np.abs(w[leaf]).max(), 1e-12)
            assert np.abs(g[leaf] - w[leaf]).max() <= 1e-4 * scale, (path, leaf)


def test_calibration_batch_carries_patches():
    """The port's calibration batch: bf16 patches of ``vision_tokens``
    rows, drawn again equal, independent of the tokens' stream; a config
    without a vision prefix gets none."""
    cfg = t_arch(ARCH).smoke
    batch = calibration_batch(cfg, 4, 8)
    assert tuple(batch["patch_embeds"].shape) == (4, P, D)
    assert batch["patch_embeds"].dtype == torch.bfloat16
    assert torch.equal(batch["patch_embeds"], calibration_batch(cfg, 4, 8)["patch_embeds"])
    assert not torch.equal(batch["patch_embeds"][0], batch["patch_embeds"][1])
    assert "patch_embeds" not in calibration_batch(t_arch("qwen3_1_7b").smoke, 2, 8)


def test_deployment_calibrate_matches_reference(model):
    """``Deployment.calibrate`` under ``codes`` at smoke on the reference's
    batch with patches (programmed, 24 h of drift, carried across): the
    per-step losses (through ``CompiledCalibStep``) against the
    reference's, and ``logit_mse`` with and without the side-cars (the
    forward's text logits)."""
    cfg_j, cfg_t = model["cfg"]
    params = model["params"]
    dep_j = JDeployment(cfg_j, "codes", params["base"], model["codes"], params["adapters"],
                        jax.random.PRNGKey(0), jax.random.PRNGKey(1)).advance(24)
    dep_t = Deployment.from_arrays(
        cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes), np_tree(dep_j.adapters),
        backend="codes", drift_hours=dep_j.drift_hours, device="cpu")
    batch_j = j_calibration_batch(cfg_j, 4, 8)
    batch_t = {"tokens": t(batch_j["tokens"]).long(),
               "patch_embeds": t(batch_j["patch_embeds"])}
    drifted = dep_t.logit_mse(batch_t)
    np.testing.assert_allclose(drifted, dep_j.logit_mse(batch_j), rtol=F32_RTOL)
    rj, rt = dep_j.calibrate(batch_j, steps=3), dep_t.calibrate(batch_t, steps=3)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=F32_RTOL)
    assert rt.final_loss < rt.initial_loss
    np.testing.assert_allclose(dep_t.logit_mse(batch_t), dep_j.logit_mse(batch_j),
                               rtol=F32_RTOL)
    assert dep_t.logit_mse(batch_t) < drifted


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _deployments(model, backend, vision=True):
    cfg_j, cfg_t = model["cfg"]
    if not vision:  # the same gemma stack without its vision prefix
        cfg_j = dataclasses.replace(cfg_j, vision_tokens=0)
        cfg_t = dataclasses.replace(cfg_t, vision_tokens=0)
    dep_j = JDeployment(cfg_j, backend, model["params"]["base"], model["codes"],
                        model["params_j"]["adapters"], jax.random.PRNGKey(0),
                        jax.random.PRNGKey(1))
    dep_t = Deployment.from_arrays(cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes),
                                   model["adapters_np"], backend=backend, device="cpu")
    return dep_j, dep_t


def _near_tie(session_j, prompt, pe, ref, got):
    """Equal streams, or a split where the reference's top-2 logits lie
    within ``F32_BOUND`` of their absmax."""
    if list(got) == list(ref):
        return
    j = next(i for i, (a, b) in enumerate(zip(ref, got)) if a != b)
    seq = np.concatenate([prompt, np.asarray(ref[:j], np.int32)])[None]
    batch = {"tokens": jnp.asarray(seq)}
    if pe is not None:
        batch["patch_embeds"] = jnp.asarray(pe)[None]
    with session_j.scope():
        logits = np.asarray(JT.forward(session_j.params, batch, session_j.cfg)[0, -1],
                            np.float32)
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] <= F32_BOUND * np.abs(logits).max(), (ref, got)


# two image requests and a text-only one, as the reference's
# ``test_ragged_staggered_parity_vision`` draws its prompts and patches
PROMPT_LENS, IMAGES = (6, 10, 5), (True, True, False)


@pytest.mark.parametrize("backend", ["dequant", "codes"])
def test_engine_ragged_staggered_matches_reference(model, backend):
    """Ragged, staggered traffic (max_len 32, 2 slots, chunks of 4,
    prompts of 6, 10 and 5 tokens, the first two behind 8 patches, 5
    greedy tokens each) on both engines over the same deployment: the
    same tokens; the same counters (ticks, admission units with each
    vision unit a tick of its own, first and decode tokens, prefix
    lookups) and each request's admission tick, so its time to first
    token in ticks (wall-clock TTFTs hold the reference's jit compiles);
    and each stream the
    request's served alone through ``ServeSession.generate``."""
    dep_j, dep_t = _deployments(model, backend)
    s_j, s_t = dep_j.serve(), dep_t.serve()
    vocab = model["cfg"][0].vocab
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(50 + i), (n,), 0, vocab))
               for i, n in enumerate(PROMPT_LENS)]
    pes = [patches(300 + i) if img else None for i, img in enumerate(IMAGES)]
    runs = []
    for engine_cls, session in ((JEngine, s_j), (ServeEngine, s_t)):
        engine = engine_cls(session, max_slots=2, max_len=32, prefill_chunk=4, min_bucket=4)
        reqs = []
        for p, pe in zip(prompts, pes):
            reqs.append(engine.submit(p, max_new=5, patch_embeds=pe))
            engine.step()
            engine.step()
        engine.run()
        assert all(r.done and len(r.tokens) == 5 for r in reqs)
        stats = engine.stats()
        runs.append(([list(r.tokens) for r in reqs], [r.admitted_tick for r in reqs],
                     {k: stats[k] for k in ("ticks", "prefill_chunks", "first_tokens",
                                            "decode_tokens", "completed", "prefix_lookups",
                                            "prefix_hits")}))
    (ref, ref_ticks, ref_stats), (got, got_ticks, got_stats) = runs
    assert got_stats == ref_stats and got_ticks == ref_ticks
    assert got_stats["prefill_chunks"] == sum(IMAGES) + sum(-(-n // 4) for n in PROMPT_LENS)
    for p, pe, r, g in zip(prompts, pes, ref, got):
        _near_tie(s_j, p, pe, r, g)
    for p, pe, g in zip(prompts, pes, got):
        alone, _ = s_t.generate(torch.from_numpy(p.copy())[None], gen_len=5,
                                patch_embeds=None if pe is None else pe[None])
        assert list(alone[0]) == g


def test_engine_vision_unit_is_a_tick_of_its_own(model):
    """An image request of one chunk: admitted over two ticks (the vision
    unit, then the chunk at ``P``), its slot's clock at ``P + prompt_len``,
    its K/V at [0, P) bitwise ``prefill_vision`` of its patches alone, and
    its first token the fused prefill's argmax. The vision step is one
    compiled step more, and a second request compiles nothing."""
    _, dep_t = _deployments(model, "codes")
    session = dep_t.serve()
    cfg = session.cfg
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (3,))
    pe = patches(8)
    engine = ServeEngine(session, max_slots=1, max_len=16, prefill_chunk=4, min_bucket=4,
                         prefix_cache_entries=0)
    before = engine.compile_count()
    req = engine.submit(prompt, max_new=2, patch_embeds=pe)
    assert engine.prefill_chunks == 1 and req._vision_pending is False and not req.tokens
    assert engine.compile_count() == before + 1
    engine.step()
    assert req.admitted_tick == 0 and engine.pos[0] == P + len(prompt) + 1
    want = TT.init_cache(cfg, 1, 16, "cpu")
    with session.scope(), torch.no_grad():
        TT.prefill_vision(session.params, t(pe)[None], want, cfg, 16)
        logits, _ = TT.prefill(session.params, torch.as_tensor(prompt)[None], cfg, 16,
                               patch_embeds=t(pe)[None])
    for got, ref in zip(TT._cache_layers(engine.cache, cfg), TT._cache_layers(want, cfg)):
        for name in ("k", "v"):
            assert torch.equal(got[name][0, :P], ref[name][0, :P]), name
    assert req.tokens[0] == int(torch.argmax(logits[0, -1]))
    engine.run()
    count = engine.compile_count()
    engine.submit(prompt[:2], max_new=2, patch_embeds=patches(9))
    engine.run()
    assert engine.compile_count() == count


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_chain_with_patch_bytes_is_the_reference_s(dtype):
    """The chain seeded with the patches' bytes in the dtype given (numpy
    f32, or ml_dtypes bf16) is the reference's, byte for byte; it differs
    from the chain of the same prompt with other patches or none."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 512, (9,))
    pe = np.asarray(jnp.asarray(rng.standard_normal((P, D)), getattr(jnp, dtype)))
    ref = JEngine._hash_chain(None, JRequest(rid=0, prompt=prompt.astype(np.int32), max_new=1,
                                             patch_embeds=pe))
    got = ServeEngine._hash_chain(Request(rid=0, prompt=prompt, max_new=1, patch_embeds=pe))
    assert got == ref and len(got) == 10
    other = pe.copy()
    other[7, 63] = -other[7, 63] if other[7, 63] else 1
    for e in (other, None):
        chain = ServeEngine._hash_chain(Request(rid=0, prompt=prompt, max_new=1, patch_embeds=e))
        assert not set(chain) & set(got)


def test_prefix_hits_are_bitwise_cold_admission(model):
    """A prompt resubmitted whole with the same patches runs no vision
    unit and no chunk, and equals its cold admission bitwise (the staged
    cache, the admission logits, the slot's cache row after the run,
    every token; 4-token chunks); a longer prompt sharing its first 8
    tokens and patches resumes at 8 with the patches' rows in the
    snapshot (no vision unit), bitwise its cold admission; the same
    prompt with other patches misses and runs its vision unit."""
    _, dep_t = _deployments(model, "codes")
    session = dep_t.serve()
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, session.cfg.vocab, (8,))
    longer = np.concatenate([prompt, rng.integers(0, session.cfg.vocab, (5,))])
    pe = patches(9)

    def serve(engine, p, e=pe):
        submit = type(engine).submit
        engine.submit = lambda q, **k: submit(engine, q, patch_embeds=e, **k)
        return _serve(engine, p)

    cold = serve(_engine(session, entries=0), prompt)
    cold_long = serve(_engine(session, entries=0), longer)
    engine = _engine(session)
    visions = []
    vision = engine._vision
    engine._vision = lambda req: visions.append(req.rid) or vision(req)
    first = serve(engine, prompt)
    units = engine.prefill_chunks
    full = serve(engine, prompt)
    assert full[0].prefix_hit_tokens == len(prompt) and engine.prefill_chunks == units
    assert _bitwise(first, cold) and _bitwise(full, cold)
    part = serve(engine, longer)
    assert part[0].prefix_hit_tokens == 8 and engine.prefill_chunks == units + 2
    assert _bitwise(part, cold_long)
    assert visions == [first[0].rid]
    miss = serve(engine, prompt, patches(10))
    assert miss[0].prefix_hit_tokens == 0 and visions == [first[0].rid, miss[0].rid]


def test_submit_refusals_are_the_reference_s(model):
    """The reference's ``test_engine_submit_validation`` vision cases, with
    its messages: patches to a config without a vision prefix, a wrong
    patch count, and the prefix counted against ``max_len`` (8 + 5 + 4 >
    16); a text-only request to a vision config is admitted."""
    engines, texts = [], []
    for vision, out in ((True, engines), (False, texts)):
        dep_j, dep_t = _deployments(model, "dequant", vision)
        out += [JEngine(dep_j.serve(), max_slots=1, max_len=16),
                ServeEngine(dep_t.serve(), max_slots=1, max_len=16)]
    cases = ((1, np.zeros(2, np.int32), 2, np.zeros((4, D), np.float32)),
             (0, np.zeros(2, np.int32), 2, np.zeros((3, D), np.float32)),
             (0, np.zeros(5, np.int32), 4, np.zeros((P, D), np.float32)))
    for (which, prompt, max_new, pe), want in zip(cases, ("without vision_tokens",
                                                         "expected 8 vision tokens, got 3",
                                                         "prompt (13) + max_new (4)")):
        messages = []
        for engine in (texts if which else engines):
            with pytest.raises(ValueError) as err:
                engine.submit(prompt, max_new=max_new, patch_embeds=pe)
            messages.append(str(err.value))
        assert messages[0] == messages[1] and want in messages[1], messages
    req = engines[1].submit(np.zeros(5, np.int32), max_new=4)
    engines[1].run()
    assert req.done and req.vision_len == 0
