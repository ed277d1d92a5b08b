"""Wall time of ``chip_smoke.py``'s phase-5 fused prefill (qwen3-1.7b at
full width over drifted codes from seed 0, its 3 x 32 tokens) for the
f32 and the int8 serving session, timed as phase 5 times it
(``chip_smoke.time_prefill``), after one warm-up call. Uses only the
public serving API, so it times any checkout of the port against the
same inputs:

    python3 tools/prefill_wall.py [--src other/checkout/src] [--out result.json]

``--src`` points at the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's). Prints the card, then per session every
repeat and the median.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402

SEED = 0
REPS = 5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment
    from repro_torch.kernels import dora_linear as K

    smi = S.phase_card()
    S.log(f"[card] repro_torch from {K.__file__}")
    device = torch.device("cuda")
    cfg = get_arch("qwen3-1.7b").full
    dep = Deployment.program(cfg, SEED, backend="codes", device=device)
    dep.advance(24)
    _, tokens, _ = S.serving_inputs(cfg.vocab, SEED, device)
    result = {"card": smi, "rows": int(tokens.numel())}
    for body, session in (("f32", dep.serve()), ("int8", dep.serve(accum="int8"))):
        S.time_prefill(session, tokens)  # warm-up: first-call set-up
        K.reset_launch_counts()
        times, _ = S.time_prefill(session, tokens, REPS)
        counts = {k: v // REPS for k, v in K.launch_counts().items() if v}
        result[body] = {"ms": times, "median_ms": statistics.median(times),
                        "launches_per_prefill": counts}
        S.log(f"[prefill] {body}: {tuple(tokens.shape)} tokens, median "
              f"{statistics.median(times):.3f} ms over {REPS} "
              f"({', '.join(f'{t:.3f}' for t in times)}); launches per prefill {counts}")
        del session
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
