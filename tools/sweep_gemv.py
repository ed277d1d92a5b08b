"""Sweep the plan of a GEMV launcher's tensor-core body on the card: the
f32 body (bf16 x) or the int8 body (``--accum int8``, bf16 x). For each
qwen3-1.7b fused leaf and row count it times the kernel under the policy
(``autotune.gemv_plan``) and with K in 1, 2, 3, 4, 6, 8, 9, 12 and 16 parts
(at most one part a stage of ``GEMV_MMA_STAGE`` rows, within one wave),
checking each split against the plain version (f32: rtol = atol = 1e-4;
int8: within 1e-4 of the output's absmax). For the int8 body it also
times the policy's parts with its row scales taken the other way
(``autotune.gemv_int8_prescale``: inside the launch, or by a pass before
it). Times are CUDA events around CUDA-graph replays over operand copies
rotated past the L2 (``chip_smoke.time_ms``), at the decode tick and a
full admission chunk (f32), or at every row bucket the engine uses (int8).

    python3 tools/sweep_gemv.py [--accum f32|int8] [--out sweep.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import dora_linear as K  # noqa: E402

PARTS = (1, 2, 3, 4, 6, 8, 9, 12, 16)
ROWS = {"f32": (S.SLOTS, 32), "int8": (1, S.SLOTS, 8, 16, 32, 64)}


def candidates(m, n, k, accum):
    """The policy's parts, then each count in PARTS whose launch fits the
    body's wave."""
    stages = -(-k // autotune.GEMV_MMA_STAGE)
    wave = autotune.gemv_int8_wave(m) if accum == "int8" else autotune.WAVE
    splits = {"policy": autotune.gemv_plan(m, n, k, accum)}
    for parts in PARTS:
        if parts <= stages and autotune.gemv_blocks(m, n, k, parts, accum) <= wave:
            splits[str(parts)] = parts
    return splits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--accum", choices=autotune.ACCUMS, default="f32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    accum = args.accum
    smi = S.phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    K.build()
    policy = autotune.gemv_plan, autotune.gemv_int8_prescale
    result = {"card": smi, "accum": accum, "rows": []}
    call = lambda *o: K.dora_linear_gemv(*o, accum=accum)  # noqa: E731
    try:
        for m in ROWS[accum]:
            layer = {}
            for leaf, k, n, r in S.LEAVES:
                ops = [S.operands(m, k, n, r, device, seed=i)
                       for i in range(S._copies(2 * k * n + 2 * m * k + 4 * m * n))]
                plans = {label: (parts, policy[1](m))
                         for label, parts in candidates(m, n, k, accum).items()}
                if accum == "int8":
                    plans["policy, row scales " + ("in the launch" if policy[1](m) else
                                                   "before it")] = (
                        policy[0](m, n, k, accum), not policy[1](m))
                times = {}
                for label, (parts, pre) in plans.items():
                    autotune.gemv_plan = lambda *_, p=parts: p
                    autotune.gemv_int8_prescale = lambda *_, q=pre: q
                    got = call(*ops[0])
                    torch.cuda.synchronize()
                    err, ok, _ = S._vs_plain(got, ops[0], accum)
                    assert ok, (leaf, m, label, err)
                    times[label] = S.time_ms([lambda o=o: call(*o) for o in ops])
                    autotune.gemv_plan, autotune.gemv_int8_prescale = policy
                    layer[label] = layer.get(label, 0.0) + times[label]
                best = min((t, lab) for lab, t in times.items() if lab[0].isdigit())
                layer["best parts of each leaf"] = layer.get("best parts of each leaf", 0.0) + best[0]
                result["rows"].append({"m": m, "leaf": leaf, "ms": times})
                S.log(f"[sweep] {accum} M={m:2d} {leaf:8s} policy "
                      f"{policy[0](m, n, k, accum)} parts {times['policy']:.4f} ms | "
                      f"best {best[1]} parts {best[0]:.4f} ms | "
                      + ", ".join(f"{lab}: {t:.4f}" for lab, t in times.items()
                                  if lab != "policy"))
                del ops
            S.log(f"[sweep] {accum} M={m:2d} layer    policy {layer['policy']:.4f} ms"
                  + "".join(f" | {lab} {t:.4f}" for lab, t in layer.items()
                            if not lab[0].isdigit() and lab != "policy"))
    finally:
        autotune.gemv_plan, autotune.gemv_int8_prescale = policy
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
