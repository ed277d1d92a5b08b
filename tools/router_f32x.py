"""The MoE routers' f32-x launches on the card: mixtral-8x22b's router (K
6144, N 8) at M = 1, 4, 8, 32, 96 and deepseek-v2-lite's (K 2048, N 64) at
M = 4, 32, through the public wrappers as the serving path calls them:

* the fused linear's f32 body, DoRA rank 8 (``dora_linear_gemv`` up to 64
  rows, ``dora_linear`` above), beside its bound
  (``chip_smoke.router_bound``: bytes over 3.35 TB/s or f32 operations
  over 67 TFLOP/s) and one ``torch.matmul`` of x by the pre-dequantized
  f32 weight (TF32 off), the yardstick of ``chip_smoke.py`` phase 4;
* the ADC (``crossbar_mvm``, codes_adc's router), beside its bound
  (``chip_smoke.adc_f32x_bound``); no PyTorch call digitizes per tile, so
  it has no yardstick;

each timed by CUDA events around CUDA-graph replays over operand copies
rotated past the L2 (``chip_smoke.time_ms``), with the kernels one call
launches and their device times (torch.profiler, L2 warm).

Uses only the kernels' public wrappers, so it times any checkout of the
port against the same inputs; run it on two checkouts in one call to
compare them on one card:

    python3 tools/router_f32x.py [--src other/checkout/src] [--out result.json]
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

# (router, K, N, R, rows)
ROUTERS = (("mixtral-8x22b", 6144, 8, 8, (1, 4, 8, 32, 96)),
           ("deepseek-v2-lite", 2048, 64, 8, (4, 32)))


def log_row(result, row, library):
    """Keep ``row`` and log it beside its bound and yardstick (``library``
    names it; None: there is none)."""
    result["rows"].append(row)
    per = ("not measured" if row["kernels"] is None else
           ", ".join(f"{name} {t:.4f}" for name, t in row["kernels"].items()))
    lib = ("none" if library is None else f"{library} {row['library_ms']:.4f} ms "
           f"({row['ms'] / row['library_ms']:.2f}x)")
    S.log(f"[router] {row['router']:16s} {row['launcher']:16s} M={row['m']:3d} "
          f"K={row['k']:5d} N={row['n']:3d} kernel {row['ms']:.4f} ms | {lib} | bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}) | kernels: {per}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.kernels import crossbar_mvm as C
    from repro_torch.kernels import dora_linear as K

    smi = S.phase_card()
    S.log(f"[card] repro_torch from {K.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    K.build()
    C.build()
    result = {"card": smi, "src": os.path.abspath(args.src), "rows": []}
    for router, k, n, r, ms in ROUTERS:
        for m in ms:
            kind = "dora_linear_gemv" if m <= 64 else "dora_linear"
            fn = getattr(K, kind)
            ops = [S.router_operands(m, device, seed=i, shape=(k, n, r))
                   for i in range(S._copies(2 * k * n + 4 * m * k + 4 * m * n))]
            w32 = [(o[1].float() - o[2].float()) * o[3] for o in ops]
            bound_ms, bound_by = S.router_bound(m, k, n, r, S.F32_FLOP_PER_S)
            row = {"router": router, "launcher": kind, "m": m, "k": k, "n": n, "r": r,
                   "ms": S.time_ms([lambda o=o: fn(*o) for o in ops]),
                   "library_ms": S.time_ms([lambda o=o, w=w: torch.matmul(o[0], w)
                                            for o, w in zip(ops, w32)]),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "kernels": S.kernel_ms(lambda: fn(*ops[0]))}
            log_row(result, row, "torch.matmul f32")
            bound_ms, bound_by = S.adc_f32x_bound(m, k, n)
            row = {"router": router, "launcher": "crossbar_mvm", "m": m, "k": k, "n": n,
                   "ms": S.time_ms([lambda o=o: C.crossbar_mvm(*o[:4]) for o in ops]),
                   "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                   "kernels": S.kernel_ms(lambda: C.crossbar_mvm(*ops[0][:4]))}
            log_row(result, row, None)
            del ops, w32
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
