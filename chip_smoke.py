"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``): builds the
port's CUDA kernels from this checkout, holds each against its plain
PyTorch version on the card, times them, then serves qwen3-1.7b at full
width from resident RRAM codes and checks that the serving path went
through the kernels.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (any failure exits non-zero; no failure is caught):
  1. card     — name and power limit (nvidia-smi), torch's device name;
  2. build    — nvcc for sm_90a, build seconds and the -Xptxas -v report;
  3. kernels  — both launchers vs ``dora_linear_ref`` at rtol=atol=1e-4,
                full-width fused leaves at every GEMV row bucket M in
                {1, 2, 4, 8, 16, 32, 64} (decode ticks and the engine's
                admission chunks), the tiled launcher at M=256, ragged
                shapes;
  4. timing   — CUDA events around CUDA-graph replays over operand copies
                rotated past the L2: the kernel, the plain version, and
                torch.matmul of x by the pre-dequantized bf16 weight
                (``library_ms``; the port never calls it), beside the
                bound: bytes moved over 3.35 TB/s or operations over the
                bf16 tensor-core rate of 989 TFLOP/s, whichever is larger
                (H100 SXM data sheet);
  5. serving  — Deployment.program(FULL, codes) -> advance(24) -> serve()
                -> ServeEngine (ragged greedy requests, one chunked) and
                one fused prefill with B*S > 64; launch counters reset
                just before and read just after; then codes vs dequant
                logits of the fused prefill and of one admission chunk
                per row bucket 8, 16 and 32;
  6. trace    — torch.profiler over a few steady decode ticks: device busy
                share, kernels per tick, the largest kernels.
The last line is the JSON result; the line before it the kernel table.
Needs one CUDA card; without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# The inputs are bf16 x and u8 codes, and G+ - G- in [-255, 255] is exact
# in bf16, so the card's peak for this work is its dense bf16 tensor-core
# rate (data sheet). The kernels' exact-f32 SIMT arithmetic (67 TFLOP/s)
# is their own choice, not a limit of the card.
BF16_FLOP_PER_S = 989e12
TOL = 1e-4                  # the reference's f32 kernel tolerance
# codes-vs-dequant prefill logits at full width, relative to their absmax:
# both run bf16 activations between layers, and bf16 rounding flips from
# the two f32 summation orders compound over 28 layers.
LOGITS_BOUND = 5e-2

# qwen3-1.7b fused serve leaves: (name, K, N, fused rank)
LEAVES = [("qkv", 2048, 4096, 24), ("o", 2048, 2048, 8),
          ("gate_up", 2048, 12288, 16), ("down", 6144, 2048, 8)]
# ragged M, K and N; M = 5, 9 and 17 fill part of the 8-, 16- and 32-row
# buckets with N a multiple of the vector width (vector code loads)
RAGGED = [(7, 1000, 999, 3), (65, 130, 77, 12), (1, 33, 4097, 1), (130, 257, 31, 5),
          (5, 300, 200, 4), (9, 96, 4096, 2), (17, 1000, 1024, 3)]
# every GEMV row bucket: decode ticks (1-4 slots, up to 64) and the
# engine's admission chunks, padded to 8, 16 or 32 rows
DECODE_M = (1, 2, 4, 8, 16, 32, 64)
PREFILL_M = 256
SLOTS = 4                   # engine slots: the decode batch of phase 5
# timed row counts: a single stream, the phase-5 decode tick, a full
# 32-token admission chunk, and a fused prefill
TIMED_M = (1, SLOTS, 32, PREFILL_M)


def log(*args):
    print(*args, flush=True)


def phase_card():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from repro_torch.kernels import dora_linear as K

    K.build()
    info = K.build_info
    log(f"[build] {os.path.relpath(info['path'], HERE)} compiled={info['compiled']} "
        f"in {info['seconds']:.2f} s")
    for line in str(info["log"]).strip().splitlines():
        log(f"[build] {line}")


def operands(m, k, n, r, device, seed=0):
    """Realistic operands: codes programmed from a normal weight, bf16 x,
    random non-zero A, B and gamma."""
    from repro_torch.core.rram import program

    g = torch.Generator(device=device).manual_seed(seed)
    xw = program(torch.randn((k, n), generator=g, device=device) * k ** -0.5)
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    a = (torch.rand((k, r), generator=g, device=device) * 2 - 1) * k ** -0.5
    b = torch.randn((r, n), generator=g, device=device) * 0.05
    gamma = torch.rand((1, n), generator=g, device=device) * 1.5 + 0.5
    return x, xw.g_pos, xw.g_neg, xw.scale, a, b, gamma


def phase_kernels(device):
    """Each launcher vs the plain version; returns max |err| per launcher."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import dora_linear as K
    from repro_torch.kernels.ref import dora_linear_ref

    worst = {"dora_linear_gemv": 0.0, "dora_linear": 0.0}
    cases = [(m, k, n, r, name) for name, k, n, r in LEAVES for m in DECODE_M]
    cases += [(PREFILL_M, k, n, r, name) for name, k, n, r in LEAVES]
    cases += [(m, k, n, r, "ragged") for m, k, n, r in RAGGED]
    for m, k, n, r, name in cases:
        ops = operands(m, k, n, r, device, seed=m + n)
        want = dora_linear_ref(*ops)
        launchers = [("dora_linear", K.dora_linear)]
        if autotune.use_gemv(m):
            launchers.insert(0, ("dora_linear_gemv", K.dora_linear_gemv))
        for kind, fn in launchers:
            got = fn(*ops)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
            log(f"[kernels] {kind:17s} {name:8s} M={m:4d} K={k:5d} N={n:5d} r={r:2d} "
                f"max|err|={err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} disagrees with the plain version at "
                                     f"{(m, k, n, r)}: max|err| {err}")
            worst[kind] = max(worst[kind], err)
    return worst


def bound(m, k, n, r, x_bytes=2):
    """(bound_ms, bound_by): each input read once, each output written
    once, against the operations at the bf16 tensor-core rate."""
    nbytes = 2 * k * n + m * k * x_bytes + 4 * (k * r + r * n + 2 * n) + 4 * m * n
    flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


L2_BYTES = 50 * 2 ** 20


def time_ms(fns, reps=5):
    """Mean device time of one call, from CUDA events around replays of a
    CUDA graph that runs every closure in ``fns`` ``reps`` times. The
    closures hold distinct operand copies totalling more than twice the
    50 MB L2, so every call streams its operands from HBM; the graph keeps
    host launch overhead out of the measurement."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(fns))
    del graph
    return ms


def phase_timing(device):
    from repro_torch.kernels import dora_linear as K
    from repro_torch.kernels.ref import dora_linear_ref

    rows = []
    for name, k, n, r in LEAVES:
        for m in TIMED_M:
            per_copy = 2 * k * n + 2 * m * k + 4 * m * n
            copies = max(2, -(-2 * L2_BYTES // per_copy))
            ops = [operands(m, k, n, r, device, seed=i) for i in range(copies)]
            w16 = [((o[1].float() - o[2].float()) * o[3]).to(torch.bfloat16) for o in ops]
            kind = "dora_linear_gemv" if m <= 64 else "dora_linear"
            fn = getattr(K, kind)
            row = dict(
                kernel=kind, leaf=name, m=m, k=k, n=n, r=r, copies=copies,
                ms=time_ms([lambda o=o: fn(*o) for o in ops]),
                plain_ms=time_ms([lambda o=o: dora_linear_ref(*o) for o in ops[:2]], reps=2),
                library_ms=time_ms([lambda o=o, w=w: torch.matmul(o[0], w)
                                    for o, w in zip(ops, w16)]),
            )
            row["bound_ms"], row["bound_by"] = bound(m, k, n, r)
            rows.append(row)
            log(f"[timing] {kind:17s} {name:8s} M={m:4d} K={k:5d} N={n:5d} "
                f"kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
                f"bf16 matmul {row['library_ms']:.4f} ms | bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}) | {row['bound_ms'] / row['ms']:.1%} of bound")
            del ops, w16
    return rows


def phase_serving(device, seed):
    from repro_torch import substrate
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, ServeEngine
    from repro_torch.kernels import dora_linear as K
    from repro_torch.models import transformer as T

    cfg = get_arch("qwen3-1.7b").full
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dep = Deployment.program(cfg, seed, backend="codes", device=device)
    dep.advance(24)
    session = dep.serve()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    log(f"[serve] {session.describe()}")
    log(f"[serve] program + advance(24) + serve: {t_setup:.2f} s")

    g = torch.Generator().manual_seed(seed)
    prompt_lens, max_new = (5, 40, 17, 9), 16
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g) for n in prompt_lens]
    engine = ServeEngine(session, max_slots=SLOTS, max_len=128)
    reqs = []
    t0 = time.perf_counter()
    for p in prompts:
        reqs.append(engine.submit(p.numpy(), max_new=max_new))
        engine.step()
    engine.run()
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    ticks = engine.tick
    after_engine = K.launch_counts()
    # fused prefill: B*S = 3*32 = 96 > 64 rows -> the tiled launcher
    tokens = torch.randint(0, cfg.vocab, (3, 32), generator=g).to(device)
    logits, _ = session.prefill(tokens, 48)
    torch.cuda.synchronize()
    counts = K.launch_counts()

    for r in reqs:
        assert r.done and len(r.tokens) == max_new, r
        assert all(0 <= t < cfg.vocab for t in r.tokens), r.tokens
    assert torch.isfinite(logits.float()).all()
    stats = engine.stats()
    assert stats["generated_tokens"] == stats["first_tokens"] + stats["decode_tokens"]
    n_leaves = 4 * cfg.n_layers  # fused qkv, o, gate_up, down per layer
    # every admission chunk (<= 32 rows) and every decode tick (4 rows)
    # runs each fused leaf once through the GEMV launcher
    want_gemv = n_leaves * (stats["prefill_chunks"] + stats["decode_steps"])
    assert after_engine["dora_linear_gemv"] == want_gemv, (after_engine, want_gemv)
    assert after_engine["dora_linear"] == 0, after_engine
    assert counts["dora_linear"] == n_leaves, counts
    assert counts["dora_linear_gemv"] > 0 and counts["dora_linear"] > 0

    with substrate.use_backend("dequant"), torch.no_grad():
        ref_logits, _ = T.prefill(session.params, tokens, cfg, 48)
    a, b = logits.float(), ref_logits.float()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[serve] codes vs dequant prefill logits: max|diff| {err:.4f} of absmax "
        f"{scale:.4f} ({err / scale:.2e}; bound {LOGITS_BOUND:.0e}), top-1 agree {top1:.3f}")
    assert err <= LOGITS_BOUND * scale, (err, scale)

    # one admission chunk per GEMV row bucket the engine pads to (5, 9 and
    # 17 valid tokens -> 8, 16 and 32 rows), codes vs dequant
    chunk_errs = {}
    for n in (5, 9, 17):
        width = next(w for w in (8, 16, 32) if w >= n)
        toks = torch.zeros((1, width), dtype=torch.int64, device=device)
        toks[0, :n] = torch.randint(0, cfg.vocab, (n,), generator=g)
        out = {}
        for backend in ("codes", "dequant"):
            cache = T.init_cache(cfg, 1, 48, device)
            with substrate.use_backend(backend), torch.no_grad():
                out[backend], _ = T.prefill_chunk(
                    session.params, toks, cache, torch.tensor([0], device=device),
                    torch.tensor([n], device=device), cfg, 48)
        a, b = out["codes"].float(), out["dequant"].float()
        assert torch.isfinite(a).all()
        c_err, c_scale = float((a - b).abs().max()), float(b.abs().max())
        chunk_errs[width] = c_err / c_scale
        log(f"[serve] codes vs dequant admission chunk of {n} tokens ({width} rows): "
            f"max|diff| {c_err:.4f} of absmax {c_scale:.4f} ({c_err / c_scale:.2e}; "
            f"bound {LOGITS_BOUND:.0e}), same top-1 {bool(a.argmax() == b.argmax())}")
        assert c_err <= LOGITS_BOUND * c_scale, (n, c_err, c_scale)

    ttft = [r.ttft_seconds for r in reqs]
    result = {
        "engine_seconds": t_engine, "ticks": ticks, "setup_seconds": t_setup,
        "decode_steps": stats["decode_steps"], "prefill_chunks": stats["prefill_chunks"],
        "decode_tok_per_s": stats["decode_tok_per_s"],
        "decode_tokens": stats["decode_tokens"], "decode_seconds": stats["decode_seconds"],
        "tick_ms": 1e3 * stats["decode_seconds"] / stats["decode_steps"],
        "ttft_s": ttft, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "rram_bytes": dep.rram_bytes(), "sram_bytes": dep.sram_bytes(),
        "calibrated_fraction": dep.calibrated_fraction(),
        "launches": counts, "gemv_launches_per_tick": n_leaves,
        "logits_max_abs_diff": err, "logits_absmax": scale, "top1_agree": top1,
        "chunk_logits_rel_diff": chunk_errs,
    }
    log(f"[serve] decode {stats['decode_tokens']} tok in {stats['decode_seconds']:.3f} s "
        f"= {stats['decode_tok_per_s']:.1f} tok/s ({SLOTS} slots, "
        f"{result['tick_ms']:.2f} ms per tick) | TTFT "
        f"min {min(ttft):.3f} s max {max(ttft):.3f} s | peak mem "
        f"{result['peak_mem_bytes'] / 2**30:.2f} GiB | rram_bytes {result['rram_bytes']} "
        f"sram_bytes {result['sram_bytes']} calibrated {result['calibrated_fraction']:.2%}")
    log(f"[serve] launches {counts} ({n_leaves} GEMV launches per decode tick)")
    return counts, result, session


def phase_trace(session, ticks=4):
    """Profile a steady window of decode ticks (4 slots, full width):
    device busy share of the wall time, kernels launched per tick, and the
    kernels that take the most device time. ``None`` where the profiler
    records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.deploy import ServeEngine

    g = torch.Generator().manual_seed(1)
    engine = ServeEngine(session, max_slots=SLOTS, max_len=128)
    for _ in range(SLOTS):
        engine.submit(torch.randint(0, session.cfg.vocab, (8,), generator=g).numpy(),
                      max_new=ticks + 4)
    while not engine.active.all():
        engine.step()
    engine.step()  # one untraced tick with every slot live
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e6  # us -> s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    result = {
        "ticks": ticks, "wall_ms_per_tick": 1e3 * wall / ticks,
        "device_busy_ms_per_tick": 1e3 * busy / ticks if kernels else None,
        "device_busy_share": busy / wall if kernels else None,
        "kernels_per_tick": len(kernels) / ticks if kernels else None,
        "top_kernels_ms_per_tick": [(name[:80], ms / ticks) for name, ms in top],
    }
    if kernels:
        log(f"[trace] {ticks} decode ticks: {result['wall_ms_per_tick']:.2f} ms per tick wall, "
            f"{result['device_busy_ms_per_tick']:.3f} ms device busy "
            f"({result['device_busy_share']:.1%}), {result['kernels_per_tick']:.0f} kernels per tick")
        for name, ms in result["top_kernels_ms_per_tick"]:
            log(f"[trace]   {ms:8.3f} ms/tick  {name}")
    else:
        log("[trace] the profiler recorded no device activity: busy share not measured")
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    smi = phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in exact f32
    device = torch.device("cuda")
    phase_build()
    worst = phase_kernels(device)
    rows = phase_timing(device)
    counts, serving, session = phase_serving(device, args.seed)
    serving["trace"] = phase_trace(session)
    del session

    kernels = []
    for kind, line, m in (("dora_linear_gemv", 194, SLOTS), ("dora_linear", 129, PREFILL_M)):
        mine = [r for r in rows if r["kernel"] == kind and r["m"] == m]
        kernels.append({
            "name": kind, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dora_linear.cu",
            "replaces": f"src/repro/kernels/dora_linear.py:{line}",
            "launches": counts[kind], "max_abs_err": worst[kind],
            # one transformer layer at the decode tick (gemv) or the fused
            # prefill (tiled): the four fused leaves, summed
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in mine)
            else "operations",
            "library_ms": sum(r["library_ms"] for r in mine),
        })
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "timing": rows, "serving": serving,
                       "kernels": kernels}, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
