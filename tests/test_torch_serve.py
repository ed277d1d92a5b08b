"""Port parity end to end: a reference deployment programmed, drifted
24 h and given random non-zero adapter B factors is carried across with
``Deployment.from_arrays``; both sides then serve greedily through
``ServeSession.generate``, a ``ServeEngine`` with ragged prompts (one
longer than a 32-token admission chunk) and staggered submits, and the
fused-prefill ``serving.generate`` loop, once with the config's dtype
set to float32 and once in bf16 as shipped.

Token streams must be equal. A near-tie may flip one token (in bf16,
logits of magnitude ~2 are spaced 2^-6 apart, so exact ties are
common); then the reference's top-2 logit gap at that position must
lie below the model test's bound for the dtype and the streams are
compared up to it.

The tied embedding is scaled by ``EMBED_SCALE`` on both sides before
carrying across: at random init the token's own embedding dominates the
tied head's logits and every stream just repeats its last prompt token,
which would make stream parity vacuous."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.deploy import Deployment as JDeployment
from repro.deploy import ServeEngine as JEngine
from repro.deploy import serving as jserving
from repro.models import transformer as JT
from repro_torch.configs import get_arch as t_arch
from repro_torch.deploy import Deployment, ServeEngine
from repro_torch.deploy import serving as tserving

from test_torch_model import BF16_BOUND, F32_BOUND, np_tree, random_lora_b

PROMPT_LENS = (5, 40, 11)
GEN = 8
EMBED_SCALE = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def sessions(request):
    cfg_j = j_arch("qwen3_1_7b").smoke
    cfg_t = t_arch("qwen3_1_7b").smoke
    if request.param == "float32":
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        cfg_t = dataclasses.replace(cfg_t, dtype=torch.float32)
    dep_j = JDeployment.program(cfg_j, 0, backend="codes").advance(24)
    emb = dep_j.teacher_base["embed"]["embedding"] * EMBED_SCALE
    dep_j.teacher_base["embed"]["embedding"] = emb
    dep_j.codes["embed"]["embedding"] = emb
    adapters_np = random_lora_b(np_tree(dep_j.adapters), seed=5)
    dep_j.adapters = jax.tree_util.tree_map(jnp.asarray, adapters_np)
    dep_j._refresh_base()
    dep_t = Deployment.from_arrays(
        cfg_t, np_tree(dep_j.teacher_base), np_tree(dep_j.codes), adapters_np,
        backend="codes", drift_hours=dep_j.drift_hours, device="cpu")
    assert dep_t.field_hours == dep_j.field_hours == 24.0
    return dep_j.serve(), dep_t.serve()


def _prompts(vocab):
    rng = np.random.default_rng(9)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in PROMPT_LENS]


def logits_dtype(session_j):
    return jnp.dtype(session_j.cfg.dtype).name


def assert_streams_match(session_j, prompt, ref, got, bf16_bound=BF16_BOUND):
    """Equal streams, or a divergence at a reference near-tie (a top-2
    gap below ``bf16_bound`` of the absmax in bf16)."""
    if list(got) == list(ref):
        return
    j = next(i for i, (a, b) in enumerate(zip(ref, got)) if a != b)
    seq = np.concatenate([prompt, np.asarray(ref[:j], np.int32)])[None]
    with session_j.scope():
        logits = np.asarray(JT.forward(session_j.params, {"tokens": jnp.asarray(seq)},
                                       session_j.cfg)[0, -1], np.float32)
    bound = F32_BOUND if logits_dtype(session_j) == "float32" else bf16_bound
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] <= bound * np.abs(logits).max(), (
        f"streams diverge at {j} without a near-tie: {ref} vs {got}")


def test_session_generate_matches_reference(sessions):
    s_j, s_t = sessions
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, s_j.cfg.vocab, (2, 6)).astype(np.int32)
    ref, _ = s_j.generate(jnp.asarray(prompt), gen_len=GEN)
    got, dt = s_t.generate(torch.as_tensor(prompt), gen_len=GEN)
    assert got.shape == (2, GEN) and dt >= 0.0
    for i in range(2):
        assert_streams_match(s_j, prompt[i], np.asarray(ref)[i], got[i])


def test_engine_ragged_staggered_matches_reference(sessions):
    s_j, s_t = sessions
    prompts = _prompts(s_j.cfg.vocab)
    streams = []
    for engine_cls, session in ((JEngine, s_j), (ServeEngine, s_t)):
        engine = engine_cls(session, max_slots=2, max_len=64)
        reqs = []
        for p in prompts:
            reqs.append(engine.submit(p, max_new=GEN))
            engine.step()
            engine.step()
        engine.run()
        assert all(r.done for r in reqs)
        assert engine.generated_tokens == engine.first_tokens + engine.decode_tokens
        assert engine.generated_tokens == sum(len(r.tokens) for r in reqs)
        streams.append([list(r.tokens) for r in reqs])
    for p, ref, got in zip(prompts, *streams):
        assert len(got) == GEN
        assert_streams_match(s_j, p, ref, got)


def test_fused_prefill_generate_matches_reference(sessions):
    """B*S > 64 rows: the port's prefill takes the tiled launcher."""
    s_j, s_t = sessions
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, s_j.cfg.vocab, (3, 24)).astype(np.int32)
    with s_j.scope():
        ref, _ = jserving.generate(s_j.params, jnp.asarray(prompt), s_j.cfg, gen_len=4)
    with s_t.scope():
        got, _ = tserving.generate(s_t.params, torch.as_tensor(prompt, dtype=torch.int64),
                                   s_t.cfg, gen_len=4)
    for i in range(3):
        assert_streams_match(s_j, prompt[i], np.asarray(ref)[i], got[i])


def test_engine_eos_and_slot_recycling(sessions):
    """EOS retires the request with the token included and frees its slot
    for the queue. The EOS id is the first stream value first seen at
    index >= 1 (or the first token, if the stream repeats one value), so
    one always exists."""
    _, s_t = sessions
    p = _prompts(s_t.cfg.vocab)[0]
    ref = ServeEngine(s_t, max_slots=1, max_len=32)
    r0 = ref.submit(p, max_new=GEN)
    ref.run()
    toks = r0.tokens
    stop = next((i for i in range(1, len(toks)) if toks[i] not in toks[:i]), 0)
    engine = ServeEngine(s_t, max_slots=1, max_len=32)
    r1 = engine.submit(p, max_new=GEN, eos_id=toks[stop])
    r2 = engine.submit(p, max_new=3)
    assert (r2.slot is None) == (stop > 0)  # queued while r1 holds the slot
    engine.run()
    assert r1.done and r1.tokens == toks[:stop + 1]
    assert r2.done and r2.tokens == r0.tokens[:3]
    assert engine.num_active == 0 and not engine.pending
    assert engine.completed == 2
    assert engine.generated_tokens == engine.first_tokens + engine.decode_tokens


def test_engine_rejects_bad_requests(sessions):
    _, s_t = sessions
    engine = ServeEngine(s_t, max_slots=1, max_len=16)
    with pytest.raises(ValueError):
        engine.submit(np.arange(12), max_new=8)
    with pytest.raises(ValueError):
        engine.submit(np.asarray([s_t.cfg.vocab]), max_new=2)
    with pytest.raises(ValueError):
        engine.submit(np.asarray([1, 2]), max_new=2, temperature=1.0)


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-1.7b", "--smoke", "--backend", "codes", "--device", "cpu",
                "--batch", "2", "--prompt-len", "5", "--gen", "3", "--drift-hours", "24"])
    out = capsys.readouterr().out
    assert "backend=codes device=cpu rram_bytes=" in out
    assert "generated (2, 3)" in out


def test_sampled_generate_replays_from_generator(sessions):
    """Temperature sampling draws from the caller's generator: the same
    seed replays the same streams, another seed gives other streams."""
    _, s_t = sessions
    prompt = torch.as_tensor(np.random.default_rng(8).integers(0, s_t.cfg.vocab, (2, 4)))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return s_t.generate(prompt, gen_len=6, temperature=1.5, key=g)[0]

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((0 <= a) & (a < s_t.cfg.vocab)).all()
