"""The fused prefill as a compiled step: ``transformer.prefill(cache=)``
(and ``attention.prefill_kv_cache(cache=)`` under it) filling a cache the
caller owns, ``ServeSession.prefill_fn`` (one step per prompt length, the
twin of the reference's jitted ``prefill_fn``) and the unchunked engine
admission through it, at the smoke configs.

* ``prefill(cache=)`` into a cache dirtied by a longer prompt is bitwise
  the allocating call: the logits and every byte of the flat buffer (the
  f32 recurrent state in the bf16 buffer compared by its bytes), for the
  SSM (falcon-mamba), RG-LRU beside local attention (recurrentgemma, its
  window of 8 wrapped), local and global attention (gemma3), MLA latents
  (deepseek-v2-lite) and cross lines longer than the source
  (seamless); the session's ``prefill_fn`` step likewise on its staging
  cache.
* The engine's admissions of the recurrent stacks (f32 configs, the
  ``dequant`` backend over the reference's params, codes and random B
  factors carried across) against the reference engine on the same requests:
  each slot's row as admitted and the admission logits bitwise the
  port's ``prefill`` of the prompt alone; the tokens equal or split at a
  near-tie (``F32_BOUND``); ``ServeEngine.compile_count()`` rising as
  the reference's ``serving.compile_count`` does (one per new prompt
  length, none on a repeat). The prompt lengths and ``max_len`` are used
  by no other test, so the reference's jit caches start empty for them.
* ``prefill_fn`` refuses an encoder-decoder config, a vision config and a
  prompt that does not fit."""
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
from repro.models import transformer as JT
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch as t_arch
from repro_torch.deploy import Deployment, ServeEngine
from repro_torch.models import transformer as TT

from test_torch_model import np_tree, random_lora_b
from test_torch_serve import assert_streams_match

MAX_LEN = 24
ENGINE_MAX_LEN = 36
# the engine's traffic in rounds: two new lengths, the same lengths again
# (fresh tokens: cold admissions), one new length; all past recurrentgemma's
# window of 8 and falcon's scan chunk of 16 but the first
ROUNDS = ((13, 19), (13, 19), (23,))
GEN = 6
RECURRENT = ("falcon_mamba_7b", "recurrentgemma_9b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.fixture(scope="module")
def sessions():
    """``arch -> session`` of a smoke codes deployment (24 h of drift),
    each programmed once."""
    made = {}

    def get(arch):
        if arch not in made:
            cfg = t_arch(arch).smoke
            made[arch] = Deployment.program(cfg, 0, backend="codes",
                                            device="cpu").advance(24).serve()
        return made[arch]
    return get


def _extra_inputs(cfg, b, frames, seed):
    """An encoder-decoder config's ``enc_embeds`` (B, frames, d), or none."""
    if not cfg.encoder_layers:
        return {}
    rng = np.random.default_rng(seed)
    return {"enc_embeds": torch.from_numpy(rng.standard_normal((b, frames, cfg.d_model))
                                           .astype(np.float32)).to(cfg.dtype)}


# (arch, the dirtying prompt's length, the prompt's length): recurrentgemma's
# and gemma3's 11 tokens wrap their window of 8, their 5 leave slots of it
# unfilled; falcon's 5 run one scan chunk, its 17 two
CASES = [("falcon_mamba_7b", 20, 5), ("falcon_mamba_7b", 20, 17),
         ("recurrentgemma_9b", 20, 5), ("recurrentgemma_9b", 20, 11),
         ("gemma3_12b", 20, 5), ("gemma3_12b", 20, 11),
         ("deepseek_v2_lite_16b", 20, 7), ("seamless_m4t_large_v2", 20, 7)]


@pytest.mark.parametrize("arch,dirty,n", CASES)
def test_prefill_into_a_dirty_cache_is_bitwise_the_allocating_call(sessions, arch, dirty, n):
    """A batch-2 flat cache (for seamless, cross lines of 8 source
    positions) first filled by a ``dirty``-token prompt (behind 8 source
    frames), then by an ``n``-token one (behind 5): the logits and the flat buffer's
    every byte equal the allocating ``prefill``'s, its leaves copied into
    a zeroed flat buffer; the cache returned is the one given."""
    session = sessions(arch)
    cfg = session.cfg
    rng = np.random.default_rng(n)
    src_len = 8 if cfg.encoder_layers else 0
    flat, views = TT.init_flat_cache(cfg, 2, MAX_LEN, "cpu", src_len)
    long = torch.from_numpy(rng.integers(0, cfg.vocab, (2, dirty)))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, n)))
    with session.scope(), torch.no_grad():
        TT.prefill(session.params, long, cfg, MAX_LEN, cache=views,
                   **_extra_inputs(cfg, 2, src_len, 1))
        dirty_bytes = _bytes(flat).clone()
        logits, got = TT.prefill(session.params, tokens, cfg, MAX_LEN, cache=views,
                                 **_extra_inputs(cfg, 2, 5, 2))
        want_logits, want = TT.prefill(session.params, tokens, cfg, MAX_LEN,
                                       **_extra_inputs(cfg, 2, 5, 2))
    fresh, fresh_views = TT.init_flat_cache(cfg, 2, MAX_LEN, "cpu", src_len)
    for dst, src in zip(tree_lib.tensors(fresh_views), tree_lib.tensors(want)):
        # the allocating call's cross lines end at the source: zeros past it
        axis = next((i for i, (x, y) in enumerate(zip(dst.shape, src.shape)) if x != y), 0)
        dst.narrow(axis, 0, src.shape[axis]).copy_(src)
    assert got is views
    assert not torch.equal(dirty_bytes, _bytes(fresh))  # the dirt was there to overwrite
    assert torch.equal(logits, want_logits)
    assert torch.equal(_bytes(flat), _bytes(fresh))


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_step_fills_its_staging_cache_bitwise(sessions, arch):
    """``prefill_fn(n, max_len)``: one step per prompt length, keyed
    ``("prefill", backend, 1, n, max_len, 0)`` and shared; on the
    staging cache dirtied by a longer prompt's step its logits and every
    byte of the staging cache equal the allocating ``prefill``'s; a second
    lookup returns the same step."""
    session = sessions(arch)
    cfg = session.cfg
    rng = np.random.default_rng(5)
    long, short = (rng.integers(0, cfg.vocab, (1, n)) for n in (20, 11))
    session.prefill_fn(20, MAX_LEN)(torch.from_numpy(long))
    step = session.prefill_fn(11, MAX_LEN)
    assert step is session.prefill_fn(11, MAX_LEN) and step.compiled
    assert step.key[0] == "prefill" and step.key[2:] == (1, 11, MAX_LEN, 0)
    assert step.flat is session.staging_cache(MAX_LEN)[0]
    logits = step(torch.from_numpy(short))
    with session.scope(), torch.no_grad():
        want_logits, want = TT.prefill(session.params, torch.from_numpy(short), cfg, MAX_LEN)
    fresh, fresh_views = TT.init_flat_cache(cfg, 1, MAX_LEN, "cpu")
    for dst, src in zip(tree_lib.tensors(fresh_views), tree_lib.tensors(want)):
        dst.copy_(src)
    assert logits.shape == (1, 1, cfg.vocab) and torch.equal(logits, want_logits)
    assert torch.equal(_bytes(step.flat), _bytes(fresh))


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "paligemma_3b"])
def test_prefill_fn_refuses_chunked_families(sessions, arch):
    """An encoder-decoder or vision config admits in chunks: no fused
    prefill step, and nothing is registered."""
    session = sessions(arch)
    before = session.compile_count()
    with pytest.raises(ValueError, match="admits in chunks"):
        session.prefill_fn(5, MAX_LEN)
    assert session.compile_count() == before


@pytest.mark.parametrize("seq", [0, MAX_LEN + 1])
def test_prefill_fn_refuses_a_prompt_that_does_not_fit(sessions, seq):
    with pytest.raises(ValueError, match="does not fit"):
        sessions("falcon_mamba_7b").prefill_fn(seq, MAX_LEN)


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------


def _traffic_run(engine_cls, session, prompts, admitted=None):
    """``ROUNDS`` through a 2-slot engine (two steps between submits):
    per round the tokens, and the compile count before the engine was
    built and after each round. With ``admitted``, a dict, each admission
    of the port's engine is recorded there: the slot's cache row and the
    logits as admitted."""
    counts = []
    if engine_cls is ServeEngine:
        counts.append(session.compile_count())
    engine = engine_cls(session, max_slots=2, max_len=ENGINE_MAX_LEN)
    if engine_cls is JEngine:  # the reference compiles its decode tick at the first tick
        counts.append(engine.compile_count())
    if admitted is not None:
        finalize = engine._finalize_admission

        def record(slot, req):
            logits = req._logits.clone()
            finalize(slot, req)
            admitted[req.rid] = ([t[slot].clone() for layer in
                                  TT._cache_layers(engine.cache, session.cfg)
                                  for t in layer.values()], logits)
        engine._finalize_admission = record
    tokens = []
    for group in prompts:
        reqs = []
        for p in group:
            reqs.append(engine.submit(p, max_new=GEN))
            engine.step()
            engine.step()
        engine.run()
        assert all(r.done and len(r.tokens) == GEN for r in reqs)
        assert engine.prefix_hits == 0 and engine.prefill_chunks == 0
        tokens.append([list(r.tokens) for r in reqs])
        counts.append(engine.compile_count())
    return tokens, counts


@pytest.fixture(scope="module", params=RECURRENT)
def traffic(request):
    """The reference's f32 smoke of the arch (key 0 params, key 1 codes,
    random B factors), carried across; ``ROUNDS`` through both engines
    under ``dequant`` (the sessions of ``sessions`` run the kernels' plain
    versions under ``codes``), the port's admissions recorded."""
    arch = request.param
    cfg_j = dataclasses.replace(j_arch(arch).smoke, dtype=jnp.float32)
    cfg_t = dataclasses.replace(t_arch(arch).smoke, dtype=torch.float32)
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    codes = jax.jit(lambda b: jcal.program_model(b, cfg_j.rram, jax.random.PRNGKey(1),
                                                 mode="codes"))(params["base"])
    adapters_np = random_lora_b(np_tree(params["adapters"]), seed=3)
    dep_j = JDeployment(cfg_j, "dequant", params["base"], codes,
                        jax.tree_util.tree_map(jnp.asarray, adapters_np),
                        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    dep_t = Deployment.from_arrays(cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes),
                                   adapters_np, backend="dequant", device="cpu")
    s_j, s_t = dep_j.serve(), dep_t.serve()
    rng = np.random.default_rng(7)
    prompts = [[rng.integers(0, cfg_t.vocab, (n,)) for n in group] for group in ROUNDS]
    admitted = {}
    ref = _traffic_run(JEngine, s_j, [[p.astype(np.int32) for p in g] for g in prompts])
    got = _traffic_run(ServeEngine, s_t, prompts, admitted)
    return {"s_j": s_j, "s_t": s_t, "prompts": prompts, "ref": ref, "got": got,
            "admitted": admitted}


def test_engine_streams_match_the_reference_engine(traffic):
    """Every request's tokens equal the reference engine's or split at a
    near-tie."""
    (ref, _), (got, _) = traffic["ref"], traffic["got"]
    for group, r_group, g_group in zip(traffic["prompts"], ref, got):
        for p, r, g in zip(group, r_group, g_group):
            assert_streams_match(traffic["s_j"], p.astype(np.int32), r, g)


def test_admitted_rows_are_bitwise_the_prompt_alone(traffic):
    """Each slot's cache row as admitted through the prefill step (every
    layer's state, conv window and rolling K/V, by their bytes) and the
    admission logits equal the allocating ``prefill`` of its prompt alone;
    the slots are recycled, so an admission overwrites an older row."""
    s_t = traffic["s_t"]
    prompts = [p for group in traffic["prompts"] for p in group]
    assert sorted(traffic["admitted"]) == list(range(len(prompts)))
    for rid, p in enumerate(prompts):
        with s_t.scope(), torch.no_grad():
            logits, cache = TT.prefill(s_t.params, torch.from_numpy(p)[None], s_t.cfg,
                                       ENGINE_MAX_LEN)
        want = [t[0] for layer in TT._cache_layers(cache, s_t.cfg) for t in layer.values()]
        rows, got_logits = traffic["admitted"][rid]
        assert len(rows) == len(want)
        assert all(torch.equal(_bytes(a), _bytes(b)) for a, b in zip(rows, want)), rid
        assert torch.equal(got_logits, logits), rid


def test_compile_count_rises_as_the_reference(traffic):
    """Over the same traffic the port's ``ServeEngine.compile_count()``
    rises as the reference's ``serving.compile_count`` does: the decode
    tick and two new prompt lengths, nothing on their repeat, one for a
    new length; the port's steps are the decode tick and one ``"prefill"``
    step per length."""
    (_, ref), (_, got) = traffic["ref"], traffic["got"]
    rises = [np.diff(ref).tolist(), np.diff(got).tolist()]
    assert rises[0] == rises[1] == [3, 0, 1], rises
    keys = sorted((s.key[0], s.key[3]) for s in traffic["s_t"].steps)
    assert keys == [("decode", 1), ("prefill", 13), ("prefill", 19), ("prefill", 23)]
