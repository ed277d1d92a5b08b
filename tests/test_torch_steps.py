"""The port's compiled-step registry on the CPU (``repro_torch/deploy/
serving.py``: ``StepRegistry``, ``CompiledStep``, ``ServeSession.
decode_step_fn`` / ``prefill_chunk_fn`` / ``compile_count``) at smoke size,
against the reference where the reference has a twin:

* the fixed-shape K/V write of ``attention.chunk_attention`` (a dense blend
  a CUDA graph can hold) is bitwise the boolean-mask write it replaced,
  cache and output, over random ``pos0``/``n_valid`` and buckets that
  overrun the cache;
* twins of ``tests/test_engine.py``'s compile-count tests: a second
  ``generate`` builds no step, every backend builds as many steps for one
  request mix, unseen prompt lengths in warm buckets build none;
* engines alive at once on one session lease decode steps of their own and
  both give the reference's streams;
* ``active_backend_key`` is the reference's, and separates
  ``accum="int8"`` from the f32 body.

On the CPU a step runs its function on its static buffers, and
``compile_count`` counts steps built; on the card it counts CUDA graphs
captured (``tests/test_torch_gpu.py``)."""
import gc

import numpy as np
import pytest
import torch

from repro import substrate as jsub
from repro.deploy import ServeEngine as JEngine
from repro_torch import substrate
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch as t_arch
from repro_torch.core.dora import AdapterConfig
from repro_torch.deploy import Deployment, ServeEngine
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

from test_torch_serve import _one_thread, _prompts, assert_streams_match, sessions  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]


def _mask_write(cache, new, pos0, n_valid):
    """The boolean-mask write ``chunk_attention`` had: the oracle."""
    b_, c = next(iter(new.values())).shape[:2]
    i = torch.arange(c)[None, :]
    positions = pos0[:, None] + i
    live = i < n_valid[:, None]
    rows = torch.arange(b_)[:, None].expand(b_, c)
    for name, val in new.items():
        cache[name][rows[live], positions[live]] = val[live].to(cache[name].dtype)


def _chunk_case(seed, b_, c, length):
    """Random clocks with ``pos0 + n_valid <= length``; row 0's bucket
    overruns the cache's end (``pos0 + c > length``) unless c > length."""
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, min(c, length) + 1, b_)
    pos0 = np.array([rng.integers(0, length - n + 1) for n in n_valid])
    pos0[0] = length - n_valid[0]
    return torch.as_tensor(pos0), torch.as_tensor(n_valid)


# the leaves a chunk writes: (B, C, KVH, hd) K/V, or MLA's (B, C, kv_lora)
# latent and (B, C, rope) shared key
LEAF_SHAPES = {"kv": {"k": (2, 4), "v": (2, 4)}, "mla": {"c_kv": (12,), "k_rope": (4,)}}


@pytest.mark.parametrize("leaves", list(LEAF_SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("seed,c,length", [(0, 8, 20), (1, 8, 8), (2, 16, 12), (3, 4, 33),
                                           (4, 32, 48)])
def test_chunk_write_is_the_mask_write(seed, c, length, dtype, leaves):
    b_ = 3
    pos0, n_valid = _chunk_case(seed, b_, c, length)
    g = torch.Generator().manual_seed(seed)
    shapes = LEAF_SHAPES[leaves]
    new = {n: torch.randn((b_, c, *tail), generator=g).to(dtype) for n, tail in shapes.items()}
    cache = {n: torch.randn((b_, length, *tail), generator=g).to(torch.bfloat16)
             for n, tail in shapes.items()}
    want = {n: t.clone() for n, t in cache.items()}
    A._chunk_write(cache, new, pos0, n_valid)
    _mask_write(want, new, pos0, n_valid)
    for n in shapes:
        assert torch.equal(cache[n], want[n]), n


@pytest.mark.parametrize("seed,c,length", [(5, 8, 20), (6, 16, 16), (7, 32, 40)])
def test_chunk_attention_is_bitwise_the_mask_write(seed, c, length, monkeypatch):
    """Cache and output of ``chunk_attention`` with the dense write equal
    those of the mask write, a bucket running past ``max_len`` included."""
    cfg = A.AttentionConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                            qk_norm=True)
    acfg = AdapterConfig(rank=2, kind="dora")
    g = torch.Generator().manual_seed(seed)
    base, adapters = A.init_attention(g, cfg, acfg)
    b_ = 2
    pos0, n_valid = _chunk_case(seed, b_, c, length)
    x = torch.randn((b_, c, cfg.d_model), generator=g).to(torch.bfloat16)
    fresh = A.init_kv_cache(b_, length, cfg, "cpu")
    out = {}
    for name, write in (("dense", A._chunk_write), ("mask", _mask_write)):
        monkeypatch.setattr(A, "_chunk_write", write)
        cache = {n: t.clone() for n, t in fresh.items()}
        with torch.no_grad():
            y, cache = A.chunk_attention(x, cache, pos0, n_valid, base, adapters, cfg, acfg,
                                         max_len=length)
        out[name] = (y, cache)
    assert torch.equal(out["dense"][0], out["mask"][0])
    for n in ("k", "v"):
        assert torch.equal(out["dense"][1][n], out["mask"][1][n])


def _session(backend="codes", accum="f32"):
    cfg = t_arch("qwen3_1_7b").smoke
    return Deployment.program(cfg, 0, backend=backend, device="cpu").serve(accum=accum)


def _prompt(vocab, shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, vocab, shape))


def test_second_generate_call_builds_no_new_step():
    """Twin of ``test_engine.py::test_second_generate_call_triggers_zero_
    new_compilations``: ``generate``'s throwaway engines reuse the steps
    (the next engine takes over the decode step of one that is gone)."""
    session = _session()
    prompt = _prompt(session.cfg.vocab, (2, 8), 0)
    session.generate(prompt, gen_len=4)
    warm = session.compile_count()
    assert warm > 0
    for _ in range(3):
        session.generate(prompt, gen_len=4)
    assert session.compile_count() == warm
    engine = ServeEngine(session, max_slots=2, max_len=12)
    engine.submit(prompt[0], max_new=4)
    engine.run()
    warm = engine.compile_count()
    engine.submit(prompt[0], max_new=4)
    engine.run()
    assert engine.compile_count() == warm == engine.stats()["compile_count"]


def test_compile_count_warm_parity_across_backends():
    """Twin of ``test_engine.py::test_compile_count_warm_parity_codes_vs_
    dequant``: every backend (and the int8 body) builds as many steps for
    the same request mix, each in its own session's registry."""
    counts = {}
    for backend, accum in (("dequant", "f32"), ("codes", "f32"), ("codes", "int8"),
                           ("codes_adc", "f32")):
        session = _session(backend, accum)
        for plen in (4, 7, 4):
            session.generate(_prompt(session.cfg.vocab, (1, plen), plen), gen_len=3)
        counts[(backend, accum)] = session.compile_count()
    assert len(set(counts.values())) == 1 and counts[("codes", "f32")] > 0, counts


def test_chunk_bucketing_pins_compile_ceiling():
    """Twin of ``test_engine.py::test_chunk_bucketing_pins_compile_
    ceiling``: once buckets {4, 8} are warm, unseen prompt lengths (in
    either slot) build nothing."""
    session = _session()
    engine = ServeEngine(session, max_slots=2, max_len=64, prefill_chunk=8, min_bucket=4)
    for n in (3, 12):
        engine.submit(_prompt(session.cfg.vocab, (n,), n), max_new=2)
    engine.run()
    warm = engine.compile_count()
    assert warm == 3  # the decode tick and the chunk buckets 4 and 8
    for n in (2, 5, 7, 9, 17, 23):
        engine.submit(_prompt(session.cfg.vocab, (n,), 100 + n), max_new=2)
    engine.run()
    assert engine.compile_count() == warm
    keys = sorted(key[0] + str(key[3]) for key in session.steps._steps)
    assert keys == ["decode1", "prefill_chunk4", "prefill_chunk8"]


def test_live_engines_lease_their_own_decode_steps(sessions):
    """Two engines alive at once on one session hold distinct decode
    steps and caches, interleaved tick by tick, and both give the
    reference engine's streams; a third engine built after one is gone
    takes over its step (zeroed) and builds nothing."""
    s_j, s_t = sessions
    prompts = _prompts(s_j.cfg.vocab)
    ref_engine = JEngine(s_j, max_slots=2, max_len=64)
    ref = [ref_engine.submit(p, max_new=6) for p in prompts]
    ref_engine.run()
    e1, e2 = (ServeEngine(s_t, max_slots=2, max_len=64) for _ in range(2))
    assert e1._decode is not e2._decode and e1.cache is not e2.cache
    got = [[e.submit(p, max_new=6) for p in prompts] for e in (e1, e2)]
    while e1.step() | e2.step():
        pass
    for reqs in got:
        for p, r_ref, r in zip(prompts, ref, reqs):
            assert r.done and len(r.tokens) == 6
            assert_streams_match(s_j, p, r_ref.tokens, r.tokens)
    warm = s_t.compile_count()
    held = e2._decode
    del e2, got
    gc.collect()
    e3 = ServeEngine(s_t, max_slots=2, max_len=64)
    assert e3._decode is held and e3._decode is not e1._decode
    assert not held.flat.any()  # the lease zeroed the cache
    assert s_t.compile_count() == warm


def test_step_is_the_plain_step_on_its_buffers():
    """A decode step's call is ``transformer.decode_step`` over its own
    cache and inputs, bitwise; a chunk step's is ``prefill_chunk`` over the
    staging cache."""
    session = _session()
    cfg = session.cfg
    owner = ServeEngine(session, max_slots=3, max_len=16)
    step = owner._decode
    g = torch.Generator().manual_seed(0)
    step.flat.copy_(torch.randn(step.flat.shape, generator=g).to(step.flat.dtype))
    cache = tree_lib.map_tensors(torch.clone, step.cache)
    toks = torch.randint(0, cfg.vocab, (3, 1), generator=g)
    pos = torch.tensor([0, 5, 15])
    with session.scope(), torch.no_grad():
        want, cache = T.decode_step(session.params, cache, toks, pos, cfg)
    got = step(torch.stack([toks[:, 0], pos]))
    assert torch.equal(got, want)
    for a, b in zip(tree_lib.tensors(step.cache), tree_lib.tensors(cache)):
        assert torch.equal(a, b)
    chunk = session.prefill_chunk_fn(8, 16)
    assert chunk.cache is session.staging_cache(16)[1]
    cache = tree_lib.map_tensors(torch.clone, chunk.cache)
    toks = torch.randint(0, cfg.vocab, (1, 8), generator=g)
    with session.scope(), torch.no_grad():
        want, cache = T.prefill_chunk(session.params, toks, cache, torch.tensor([10]),
                                      torch.tensor([5]), cfg, 16)
    got = chunk(torch.cat([toks[0], torch.tensor([10, 5])]))
    assert torch.equal(got, want)
    for a, b in zip(tree_lib.tensors(chunk.cache), tree_lib.tensors(cache)):
        assert torch.equal(a, b)


def test_moved_params_are_refused():
    """A session whose params are rebound after its steps were built
    raises at the next lookup instead of serving stale operands."""
    session = _session()
    prompt = _prompt(session.cfg.vocab, (1, 5), 1)
    session.generate(prompt, gen_len=2)
    session.params = tree_lib.map_tensors(torch.clone, session.params)
    with pytest.raises(RuntimeError, match="params moved"):
        session.generate(prompt, gen_len=2)


def test_active_backend_key_is_the_reference_key():
    """The key holds the name and the sorted options: ``accum="int8"``
    and the f32 body are different steps; the default binding is the
    reference's."""
    keys = {}
    for accum in ("f32", "int8"):
        with substrate.use_backend("codes", accum=accum):
            keys[accum] = substrate.active_backend_key()
        with jsub.use_backend("codes", accum=accum):
            assert jsub.active_backend_key() == keys[accum]
    assert keys["int8"] != keys["f32"]
    assert keys["int8"] == ("codes", (("accum", "int8"),))
    assert substrate.active_backend_key() == jsub.active_backend_key() == ("codes", ())
    dep = Deployment.program(t_arch("qwen3_1_7b").smoke, 0, backend="codes", device="cpu")
    s32, s8 = dep.serve(), dep.serve(accum="int8")
    assert s32._key("decode", 4, 1, 128) != s8._key("decode", 4, 1, 128)
    with substrate.use_backend("codes_adc", code_max=255, adc_bits=8):
        assert substrate.active_backend_key() == (
            "codes_adc", (("adc_bits", 8), ("code_max", 255)))


def test_multi_chunk_admissions_keep_their_own_caches():
    """Two prompts of several chunks in admission at once (one chunk each
    a tick, through one staging cache) give the streams each gives alone."""
    session = _session()
    prompts = [_prompt(session.cfg.vocab, (n,), 30 + n).numpy() for n in (19, 27)]
    alone = []
    for p in prompts:
        engine = ServeEngine(session, max_slots=1, max_len=40, prefill_chunk=8)
        r = engine.submit(p, max_new=5)
        engine.run()
        alone.append(r.tokens)
    engine = ServeEngine(session, max_slots=2, max_len=40, prefill_chunk=8)
    reqs = [engine.submit(p, max_new=5) for p in prompts]
    assert all(r._cache is not None for r in reqs)  # both mid-admission
    engine.run()
    assert [r.tokens for r in reqs] == alone
