"""The ADC kernel (``crossbar_mvm``, bf16 x) on the card, per qwen3-1.7b
unfused leaf and per layer (the seven leaves summed):

* at the row counts of ``chip_smoke.TIMED_M_ADC`` (the decode tick, a
  full admission chunk, phase 5's prefill, a 256-row prefill): CUDA
  events around CUDA-graph replays over operand copies rotated past the L2
  (``chip_smoke.time_ms``), beside the bound (``chip_smoke.adc_bound``);
* the time per kernel at the decode tick and at 256 rows
  (``chip_smoke.adc_breakdown``: torch.profiler, L2 warm), which names the
  kernels each call launches.

Uses only the kernel's public wrapper, so it times any checkout of the
port against the same inputs; run it on two checkouts in one call, in
turns (parent, change, change, parent), to compare them on one card:

    python3 tools/adc_breakdown.py [--src other/checkout/src] [--out result.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.kernels import crossbar_mvm as C

    smi = S.phase_card()
    S.log(f"[card] repro_torch from {C.__file__}")
    device = torch.device("cuda")
    C.build()
    result = {"card": smi, "src": os.path.abspath(args.src), "layers": [], "breakdown": {}}
    for m in S.TIMED_M_ADC:
        layer = {"m": m, "leaves": {}}
        for leaf, k, n in S.ADC_LEAVES:
            ops = [S.operands(m, k, n, 1, device, seed=i)[:4]
                   for i in range(S._copies(2 * k * n + 2 * m * k + 4 * m * n))]
            layer["leaves"][leaf] = {
                "ms": S.time_ms([lambda o=o: C.crossbar_mvm(*o) for o in ops]),
                "bound_ms": S.adc_bound(m, k, n)[0]}
            del ops
        for key in ("ms", "bound_ms"):
            layer[key] = sum(row[key] for row in layer["leaves"].values())
        result["layers"].append(layer)
        S.log(f"[adc] M={m:3d} per layer {layer['ms']:.4f} ms | bound {layer['bound_ms']:.4f} ms "
              f"({layer['bound_ms'] / layer['ms']:.1%}) | "
              + ", ".join(f"{leaf} {row['ms']:.4f}" for leaf, row in layer["leaves"].items()))
    for m in S.ADC_BREAKDOWN_M:
        result["breakdown"][str(m)] = S.adc_breakdown(device, m)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
