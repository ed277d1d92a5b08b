"""The GEMV launcher (``dora_linear_gemv``) on the card, per qwen3-1.7b
fused leaf and per layer (the four leaves summed):

* the f32 body (bf16 x) and the int8 body (bf16 x) at every row
  bucket: CUDA events around
  CUDA-graph replays over operand copies rotated past the L2
  (``chip_smoke.time_ms``), beside the bound (``chip_smoke.linear_bound``)
  and, for f32, one ``torch.matmul`` of x by the pre-dequantized bf16
  weight (the yardstick of ``chip_smoke.py`` phase 4);
* each body's time per kernel at M = 4 and 32 (``chip_smoke.
  linear_breakdown``: torch.profiler, L2 warm).

Uses only the kernels' public wrappers, so it times any checkout of the
port against the same inputs; run it on two checkouts in one call to
compare them on one card:

    python3 tools/gemv_breakdown.py [--src other/checkout/src] [--out result.json]
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

BREAKDOWN_M = (S.SLOTS, 32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.kernels import dora_linear as K

    smi = S.phase_card()
    S.log(f"[card] repro_torch from {K.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    K.build()
    result = {"card": smi, "src": os.path.abspath(args.src), "layers": [], "breakdown": {}}
    timed = [(accum, m) for accum in ("f32", "int8") for m in S.DECODE_M]
    for accum, m in timed:
        layer = {"accum": accum, "m": m, "leaves": {}}
        for leaf, k, n, r in S.LEAVES:
            ops = [S.operands(m, k, n, r, device, seed=i)
                   for i in range(S._copies(2 * k * n + 2 * m * k + 4 * m * n))]
            rate = S.BF16_FLOP_PER_S if accum == "f32" else S.INT8_OP_PER_S
            row = {"ms": S.time_ms([lambda o=o: K.dora_linear_gemv(*o, accum=accum)
                                    for o in ops]),
                   "bound_ms": S.linear_bound(m, k, n, r, rate)[0], "library_ms": None}
            if accum == "f32":
                w16 = [((o[1].float() - o[2].float()) * o[3]).to(torch.bfloat16) for o in ops]
                row["library_ms"] = S.time_ms(
                    [lambda o=o, w=w: torch.matmul(o[0], w) for o, w in zip(ops, w16)])
                del w16
            layer["leaves"][leaf] = row
            del ops
        for key in ("ms", "bound_ms"):
            layer[key] = sum(row[key] for row in layer["leaves"].values())
        libs = [row["library_ms"] for row in layer["leaves"].values()]
        layer["library_ms"] = None if None in libs else sum(libs)
        result["layers"].append(layer)
        lib = "none" if layer["library_ms"] is None else f"{layer['library_ms']:.4f} ms"
        S.log(f"[gemv] {accum:4s} M={m:2d} per layer {layer['ms']:.4f} ms | library {lib} | "
              f"bound {layer['bound_ms']:.4f} ms ({layer['bound_ms'] / layer['ms']:.1%}) | "
              + ", ".join(f"{leaf} {row['ms']:.4f}" for leaf, row in layer["leaves"].items()))
    for accum in ("f32", "int8"):
        for m in BREAKDOWN_M:
            result["breakdown"][f"{accum}/{m}"] = S.linear_breakdown(
                device, "dora_linear_gemv", accum, m, f"GEMV {accum}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
