"""The port engine's shared prefix cache (``repro_torch/deploy/engine.py``)
at smoke size on the CPU, against cold admission and against the
reference engine (``repro/deploy/engine.py``):

* the hash chain is the reference's, byte for byte;
* the reference's ``test_prefix_cache_hit_is_bitwise_and_counted`` on the
  port: a full hit and a partial hit at a chunk boundary equal cold
  admission bitwise (the staged cache and logits at admission, the slot's
  cache row after the run, every token), with the reference test's
  counters;
* the same traffic's counters and ``prefix_hit_tokens`` equal the
  reference engine's on the reference's codes (``from_arrays``);
* a partial hit off a chunk boundary runs other chunks than a cold
  admission: greedy tokens equal and admission logits within
  ``OFF_BOUNDARY_BOUND`` of their absmax (the rule on the card too);
* under ``codes_adc`` an off-boundary snapshot is passed over (the ADC's
  step tracks a tile's max |x| over the chunk's rows, so resuming there
  changes the digitization); a boundary one is used, bitwise; so it is
  at mixtral smoke with a capacity that drops tokens (a chunk's rows
  compete for each expert's slots), where resuming off the boundary
  breaks the rule; with a capacity that cannot drop, it resumes there;
* snapshots stay as stored while later admissions write the staging
  cache and ``Request._cache``; eviction is LRU."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.deploy import ServeEngine as JEngine
from repro.deploy.engine import Request as JRequest
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch
from repro_torch.deploy import Deployment, ServeEngine

from test_torch_serve import _one_thread, assert_streams_match, sessions  # noqa: F401

# admission logits of a partial hit off a chunk boundary vs cold admission,
# relative to their absmax: other chunk widths and positions reorder f32
# sums (the card: other GEMV K plans and cuBLAS choices)
OFF_BOUNDARY_BOUND = 1e-2
GEN = 5


@pytest.fixture(scope="module")
def session():
    cfg = get_arch("qwen3_1_7b").smoke
    return Deployment.program(cfg, 0, backend="codes", device="cpu").advance(24).serve()


def _tokens(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (n,))


def _engine(session, entries=16, **kw):
    kw = {"max_slots": 1, "max_len": 32, "prefill_chunk": 4, "min_bucket": 4, **kw}
    engine = ServeEngine(session, prefix_cache_entries=entries, **kw)
    engine.admitted = {}  # rid -> (staged cache, admission logits) at finalize
    finalize = engine._finalize_admission

    def record(slot, req):
        engine.admitted[req.rid] = (engine._staging_flat.clone(), req._logits.clone())
        finalize(slot, req)

    engine._finalize_admission = record
    return engine


def _serve(engine, prompt):
    """One request run to its end: the request, its staged cache and
    logits at admission, and the slot's cache row after the run."""
    req = engine.submit(prompt, max_new=GEN)
    engine.run()
    row = [t[:, 0].clone() if key == "body" else t[0].clone()  # body: batch on axis 1
           for key, v in engine.cache.items() for t in tree_lib.tensors(v)]
    return req, engine.admitted[req.rid], row


def _cold(session, prompt, **kw):
    return _serve(_engine(session, entries=0, **kw), prompt)


def _bitwise(a, b):
    (ra, (ca, la), rowa), (rb, (cb, lb), rowb) = a, b
    return (ra.tokens == rb.tokens and torch.equal(ca, cb) and torch.equal(la, lb)
            and all(torch.equal(x, y) for x, y in zip(rowa, rowb)))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 8), (2, 13), (3, 40)])
def test_hash_chain_is_the_reference_chain(seed, n):
    prompt = _tokens(151936, n, seed)
    ref = JEngine._hash_chain(None, JRequest(rid=0, prompt=prompt.astype(np.int32),
                                             max_new=1))
    got = ServeEngine._hash_chain(
        type("R", (), {"prompt": prompt.astype(np.int64)})())
    assert got == ref and len(got) == n + 1


def test_prefix_cache_hit_is_bitwise_and_counted(session):
    """Twin of ``test_engine.py::test_prefix_cache_hit_is_bitwise_and_
    counted``: an 8-token shared prompt and a 5-token tail, 4-token chunks."""
    vocab = session.cfg.vocab
    shared, tail = _tokens(vocab, 8, 8), _tokens(vocab, 5, 9)
    long = np.concatenate([shared, tail])
    cold = {"shared": _cold(session, shared), "long": _cold(session, long)}
    engine = _engine(session)
    first = _serve(engine, shared)
    assert first[0].prefix_hit_tokens == 0 and _bitwise(first, cold["shared"])
    chunks_cold = engine.prefill_chunks
    full = _serve(engine, shared)     # exact resubmission: no chunk runs
    assert full[0].prefix_hit_tokens == len(shared)
    assert engine.prefix_hits == 1 and engine.prefill_chunks == chunks_cold
    assert _bitwise(full, cold["shared"])
    part = _serve(engine, long)       # partial hit at the chunk boundary 8
    assert part[0].prefix_hit_tokens == len(shared)
    assert engine.prefix_partial_hits == 1
    assert engine.prefill_chunks == chunks_cold + 2  # (8, 12), (12, 13)
    assert _bitwise(part, cold["long"])
    st = engine.stats()
    assert st["prefix_lookups"] == 3 and st["prefix_hits"] == 1
    assert st["prefix_partial_hits"] == 1


def test_off_boundary_hit_keeps_the_rule(session):
    """P = 5 tokens is stored at 5, off the 4-token boundary; P + 3 then
    resumes at 5 with the chunk (5, 8) where a cold admission runs (0, 4)
    and (4, 8). Greedy tokens equal, admission logits within the bound.
    On the CPU the plain path gives it bitwise: the smoke model's ops are
    row-independent here, so the rows at positions 5-7 come out the same
    from either chunk."""
    vocab = session.cfg.vocab
    p = _tokens(vocab, 5, 11)
    longer = np.concatenate([p, _tokens(vocab, 3, 12)])
    engine = _engine(session)
    _serve(engine, p)
    hit = _serve(engine, longer)
    cold = _cold(session, longer)
    assert hit[0].prefix_hit_tokens == 5 and engine.prefix_partial_hits == 1
    assert hit[0].tokens == cold[0].tokens
    got, want = hit[1][1].float(), cold[1][1].float()
    assert float((got - want).abs().max()) <= OFF_BOUNDARY_BOUND * float(want.abs().max())
    assert _bitwise(hit, cold)


def test_codes_adc_resumes_only_at_chunk_boundaries(session):
    """P = 5 tokens is stored at 4 and 5. Under ``codes_adc`` P + 3 passes
    the snapshot at 5 over and resumes at 4, bitwise the cold admission;
    resuming at 5 (the reference's choice) digitizes rows 5-7 in a chunk
    without row 4 and changes the logits."""
    dep = session.deployment
    adc = Deployment(dep.cfg, "codes_adc", dep.teacher_base, dep.codes, dep.adapters,
                     dep.teacher_seed, dep.program_seed, dep.drift_hours).serve()
    p = _tokens(adc.cfg.vocab, 5, 13)
    longer = np.concatenate([p, _tokens(adc.cfg.vocab, 3, 14)])
    engine = _engine(adc)
    _serve(engine, p)
    hit = _serve(engine, longer)
    cold = _cold(adc, longer)
    assert hit[0].prefix_hit_tokens == 4 and _bitwise(hit, cold)
    anywhere = _engine(adc)
    anywhere._resume_off_boundary = True
    _serve(anywhere, p)
    off = _serve(anywhere, longer)
    assert off[0].prefix_hit_tokens == 5
    assert not torch.equal(off[1][1], cold[1][1])


def test_counters_equal_the_reference_engine(sessions):
    """The same traffic (a cold admission, a full hit, a partial hit at a
    chunk boundary, a short prompt, a partial hit off the boundary)
    through both engines over the same codes: equal counters and
    ``prefix_hit_tokens``, and streams equal up to a reference near-tie."""
    s_j, s_t = sessions
    vocab = s_j.cfg.vocab
    shared, p = _tokens(vocab, 8, 20), _tokens(vocab, 5, 21)
    prompts = [shared, shared, np.concatenate([shared, _tokens(vocab, 5, 22)]), p,
               np.concatenate([p, _tokens(vocab, 3, 23)])]
    out = {}
    for name, cls, session in (("ref", JEngine, s_j), ("port", ServeEngine, s_t)):
        engine = cls(session, max_slots=1, max_len=32, prefill_chunk=4, min_bucket=4)
        reqs = []
        for prompt in prompts:
            reqs.append(engine.submit(prompt.astype(np.int32), max_new=GEN))
            engine.run()
        st = engine.stats()
        out[name] = ({k: st[k] for k in ("prefix_lookups", "prefix_hits",
                                         "prefix_partial_hits", "prefill_chunks",
                                         "first_tokens", "completed")},
                     [r.prefix_hit_tokens for r in reqs], [list(r.tokens) for r in reqs])
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1] == [0, 8, 8, 0, 5]
    for prompt, ref, got in zip(prompts, out["ref"][2], out["port"][2]):
        assert_streams_match(s_j, prompt, ref, got)


def test_snapshots_are_not_written_by_later_admissions(session):
    """A stored snapshot is a copy: later multi-chunk admissions (the
    staging cache, ``Request._cache``) and a partial hit resuming from it
    (its own copy in ``Request._cache``) leave it as it was."""
    vocab = session.cfg.vocab
    engine = _engine(session)
    first = _tokens(vocab, 9, 30)
    _serve(engine, first)
    stored = {k: (c.clone(), lg.clone()) for k, (_, c, lg) in engine._prefix_cache.items()}
    assert len(stored) == 3  # after 4, 8 and 9 tokens
    _serve(engine, _tokens(vocab, 11, 31))                          # other tokens
    _serve(engine, np.concatenate([first, _tokens(vocab, 6, 32)]))  # resumes at 9
    assert engine.prefix_partial_hits == 1
    for key, (cache, logits) in stored.items():
        _, c, lg = engine._prefix_cache[key]
        assert torch.equal(c, cache) and torch.equal(lg, logits)
    assert engine.prefix_cache_bytes() == len(engine._prefix_cache) * (
        c.numel() * c.element_size() + lg.numel() * lg.element_size())


def test_prefix_cache_evicts_least_recently_used(session):
    vocab = session.cfg.vocab
    a, b, c, d = (_tokens(vocab, 3, 40 + i) for i in range(4))
    engine = _engine(session, entries=2, prefill_chunk=32)
    for prompt in (a, b, c):      # one chunk each: one entry each; a goes
        _serve(engine, prompt)
    assert _serve(engine, b)[0].prefix_hit_tokens == 3   # b becomes the newest
    _serve(engine, d)             # evicts c, the least recently used
    assert _serve(engine, b)[0].prefix_hit_tokens == 3
    assert _serve(engine, a)[0].prefix_hit_tokens == 0   # evicted by c; evicts d
    assert _serve(engine, c)[0].prefix_hit_tokens == 0
    assert len(engine._prefix_cache) == 2
    st = engine.stats()
    assert (st["prefix_lookups"], st["prefix_hits"]) == (8, 2)


def test_disabled_cache_counts_nothing(session):
    engine = _engine(session, entries=0)
    prompt = _tokens(session.cfg.vocab, 6, 50)
    for _ in range(2):
        assert _serve(engine, prompt)[0].prefix_hit_tokens == 0
    st = engine.stats()
    assert (st["prefix_lookups"], st["prefix_hits"], st["prefill_chunks"]) == (0, 0, 4)
    assert not engine._prefix_cache


@pytest.mark.parametrize("seed", [11, 21])
def test_moe_with_drops_resumes_only_at_chunk_boundaries(seed):
    """mixtral smoke at capacity_factor 0.5 (one slot an expert in a
    4-token chunk): P = 5 tokens is stored at 4 and 5; P + 3 resumes at
    4, bitwise the cold admission. Resuming at 5 (the reference's choice)
    runs rows 5-7 in a chunk without row 4, so other tokens are dropped:
    the rule fails there (tokens differ, or logits beyond the bound). At
    the smoke's own capacity_factor 2.0 (= E / top_k, nothing dropped)
    the engine resumes at 5 and stays bitwise on the CPU."""
    cfg = get_arch("mixtral_8x22b").smoke
    out = {}
    for cf in (0.5, 2.0):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        s = Deployment.program(c, 0, backend="codes", device="cpu").advance(24).serve()
        p = _tokens(c.vocab, 5, seed)
        longer = np.concatenate([p, _tokens(c.vocab, 3, seed + 1)])
        engine = _engine(s)
        _serve(engine, p)
        hit = _serve(engine, longer)
        cold = _cold(s, longer)
        out[cf] = (engine, hit, cold)
        if cf == 0.5:
            anywhere = _engine(s)
            anywhere._resume_off_boundary = True
            _serve(anywhere, p)
            off = _serve(anywhere, longer)
            assert off[0].prefix_hit_tokens == 5
            got, want = off[1][1].float(), cold[1][1].float()
            assert (off[0].tokens != cold[0].tokens or float((got - want).abs().max())
                    > OFF_BOUNDARY_BOUND * float(want.abs().max()))
    engine, hit, cold = out[0.5]
    assert not engine._resume_off_boundary
    assert hit[0].prefix_hit_tokens == 4 and _bitwise(hit, cold)
    engine, hit, cold = out[2.0]
    assert engine._resume_off_boundary
    assert hit[0].prefix_hit_tokens == 5 and _bitwise(hit, cold)
