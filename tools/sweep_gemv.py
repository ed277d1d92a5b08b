"""Sweep the K split of the GEMV launcher's tensor-core body (f32 body,
bf16 x) on the card. For each qwen3-1.7b fused leaf and row count it
times the kernel under the policy (``autotune.gemv_plan``) and with K in
1, 2, 3, 4, 6, 8, 9, 12 and 16 parts (at most one part a stage of
``GEMV_MMA_STAGE`` rows, within one wave), checking each split against
the plain version (rtol = atol = 1e-4). Times are CUDA events
around CUDA-graph replays over operand copies rotated past the L2
(``chip_smoke.time_ms``), at the decode tick and a full admission chunk
(``ROWS``).

    python3 tools/sweep_gemv.py [--out sweep.json]
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
from repro_torch.kernels import autotune, ref  # noqa: E402
from repro_torch.kernels import dora_linear as K  # noqa: E402

PARTS = (1, 2, 3, 4, 6, 8, 9, 12, 16)
ROWS = (S.SLOTS, 32)


def candidates(m, n, k):
    """The policy's parts, then each count in PARTS that fits a wave."""
    stages = -(-k // autotune.GEMV_MMA_STAGE)
    splits = {"policy": autotune.gemv_plan(m, n, k)}
    for parts in PARTS:
        if parts <= stages and autotune.gemv_blocks(m, n, k, parts) <= autotune.WAVE:
            splits[str(parts)] = parts
    return splits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = S.phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    K.build()
    policy = autotune.gemv_plan
    result = {"card": smi, "rows": []}
    try:
        for m in ROWS:
            for leaf, k, n, r in S.LEAVES:
                ops = [S.operands(m, k, n, r, device, seed=i)
                       for i in range(S._copies(2 * k * n + 2 * m * k + 4 * m * n))]
                want = ref.dora_linear_ref(*ops[0])
                times = {}
                for label, parts in candidates(m, n, k).items():
                    autotune.gemv_plan = lambda *_, p=parts: p
                    got = K.dora_linear_gemv(*ops[0])
                    torch.cuda.synchronize()
                    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (leaf, m, label)
                    times[label] = S.time_ms([lambda o=o: K.dora_linear_gemv(*o) for o in ops])
                    autotune.gemv_plan = policy
                best = min((t, lab) for lab, t in times.items() if lab != "policy")
                result["rows"].append({"m": m, "leaf": leaf, "ms": times})
                S.log(f"[sweep] M={m:2d} {leaf:8s} policy "
                      f"{autotune.gemv_plan(m, n, k)} parts {times['policy']:.4f} ms | "
                      f"best {best[1]} parts {best[0]:.4f} ms | "
                      + ", ".join(f"{lab}: {t:.4f}" for lab, t in times.items() if lab != "policy"))
                del ops
    finally:
        autotune.gemv_plan = policy
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
