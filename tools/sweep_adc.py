"""Sweep the ADC kernel's tensor-core body (bf16 x) on the card: its plan,
the ordered parts of K (``autotune.adc_plan``), and its tile shape, which
``crossbar_mvm.cu`` fixes (``kMmaN`` columns a strip, ``kMmaK`` rows a
stage, ``kMmaStages`` stages in the copy ring). It builds the source once
per tile shape in ``TILES`` (in parallel, ``tools/adc_costs.build``) and,
for each distinct qwen3-1.7b unfused leaf shape (q = o, k = v, gate = up,
down) and row count in ``ROWS``, times the policy (the source as it is,
parts from ``adc_plan``) and every (tile shape, parts in ``PARTS``, at
most one a 256-row tile) whose launch fits one wave. Every output must
equal the policy's bitwise (the result depends on neither), and the
policy's must hold the ADC contract against the plain version. Times are
CUDA events around CUDA-graph replays over operand copies rotated past
the L2 (``chip_smoke.time_ms``).

    python3 tools/sweep_adc.py [--out sweep.json]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from adc_costs import build  # noqa: E402
from repro_torch.kernels import autotune, ref  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import crossbar_mvm as C  # noqa: E402

ROWS = (S.SLOTS, 32, S.PREFILL_ROWS, S.PREFILL_M)
SHAPES = [("q,o", 2048, 2048), ("k,v", 2048, 1024), ("gate,up", 2048, 6144), ("down", 6144, 2048)]
# (strip columns, stage rows, stages)
TILES = [(tn, bk, stages) for tn in (64, 128) for bk in (32, 64) for stages in (3, 4, 6)]
PARTS = (1, 2, 3, 4, 6, 8, 12, 16, 24)


def variant(src, tn, bk, stages):
    """The source with another tile shape."""
    for name, value in (("kMmaN", tn), ("kMmaK", bk), ("kMmaStages", stages)):
        src, hits = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                            src)
        assert hits == 1, name
    return src


def wave(m, tn, bk, stages):
    """Blocks the card holds at once for a tile shape (autotune.adc_wave,
    which takes the source's)."""
    nt = autotune.adc_row_tiles(m)
    blocks = (1 if nt >= 8 else 2) * (8 // (tn // autotune.ADC_WARP_COLS))
    smem = stages * (2 * bk * tn + 16 * nt * bk) + autotune.SMEM_PER_BLOCK_RESERVED
    return autotune.SMS * min(blocks, autotune.SMEM_PER_SM // smem)


def summary(m, rows):
    """Log one layer (each leaf shape times its leaves) under the policy,
    under the best plan of each leaf, and under the best tile shape (its
    best parts a leaf) among those timed at every leaf."""
    def layer(pick):
        return sum(len(row["leaf"].split(",")) * pick(row) for row in rows)

    def best(row, shape=None):
        return min(t for lab, t in row["ms"].items()
                   if lab != "policy" and (shape is None or lab.rsplit("/", 1)[0] == shape))

    policy = layer(lambda row: row["ms"]["policy"])
    per_leaf = layer(best)
    shapes = set.intersection(*({lab.rsplit("/", 1)[0] for lab in row["ms"] if lab != "policy"}
                                for row in rows))
    per_shape = {shape: layer(lambda row, s=shape: best(row, s)) for shape in shapes}
    top = min(per_shape, key=per_shape.get)
    S.log(f"[sweep] M={m:3d} layer policy {policy:.4f} ms | best plan a leaf {per_leaf:.4f} "
          f"({policy / per_leaf - 1:+.1%}) | best tile shape {top} {per_shape[top]:.4f} "
          f"({policy / per_shape[top] - 1:+.1%})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = S.phase_card()
    device = torch.device("cuda")
    src = (B.CSRC / "crossbar_mvm.cu").read_text()
    libs = build({tile: variant(src, *tile) for tile in TILES}, tag="sweep_adc")
    policy, policy_build = autotune.adc_plan, C.build
    result = {"card": smi, "rows": []}
    try:
        for m in ROWS:
            for leaf, k, n in SHAPES:
                ops = [S.operands(m, k, n, 1, device, seed=i)[:4]
                       for i in range(S._copies(2 * k * n + 2 * m * k + 4 * m * n))]
                x, gp, gn, scale = ops[0]
                want = C.crossbar_mvm(*ops[0])
                bad, flips = ref.adc_disagreement(want, ref.crossbar_mvm_ref(*ops[0]), x, scale)
                assert bad == 0 and flips <= S.ADC_FLIP_SHARE * want.numel(), (leaf, m, bad, flips)
                times = {"policy": S.time_ms([lambda o=o: C.crossbar_mvm(*o) for o in ops])}
                tiles = -(-k // autotune.ADC_ARRAY_ROWS)
                for (tn, bk, stages), lib in libs.items():
                    C.build = lib.load
                    for parts in PARTS:
                        blocks = -(-m // autotune.ADC_BLOCK_ROWS) * -(-n // tn) * parts
                        if parts > tiles or blocks > wave(m, tn, bk, stages):
                            continue
                        autotune.adc_plan = lambda *_, p=parts: p
                        label = f"{tn}/{bk}/{stages}/{parts}"
                        got = C.crossbar_mvm(*ops[0])
                        torch.cuda.synchronize()
                        assert torch.equal(got, want), (leaf, m, label)
                        times[label] = S.time_ms([lambda o=o: C.crossbar_mvm(*o) for o in ops])
                    autotune.adc_plan, C.build = policy, policy_build
                best = sorted((t, lab) for lab, t in times.items() if lab != "policy")[:5]
                result["rows"].append({"m": m, "leaf": leaf, "k": k, "n": n,
                                       "parts": policy(m, k, n), "ms": times})
                S.log(f"[sweep] M={m:3d} {leaf:8s} policy {autotune.ADC_STRIP}/"
                      f"{autotune.ADC_STAGE_ROWS}/{autotune.ADC_STAGES}/{policy(m, k, n)} "
                      f"{times['policy']:.4f} ms | best (tn/bk/stages/parts): "
                      + ", ".join(f"{lab} {t:.4f}" for t, lab in best))
                del ops
    finally:
        autotune.adc_plan, C.build = policy, policy_build
    for m in ROWS:
        summary(m, [row for row in result["rows"] if row["m"] == m])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
