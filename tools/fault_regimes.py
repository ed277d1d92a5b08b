"""Where a fault lands against drift, on the port:

1. the fault-recovery study at the smoke config with ``BENCH_faults.json``'s
   own arguments (that file is the reference's study, run by
   ``benchmarks/faults_bench.py``, which always passes ``smoke=True``: its
   "full" mode is the paper's calibration scale, not the full model), class
   by class beside the file's numbers;
2. one Gaussian matrix per column height (the smoke model's 64 and 128 rows,
   the full model's 2048 and 6144) programmed as a deployment programs it
   (``programmed_codes``: the programming event drifts at
   ``relative_drift``, 0.10), then drifted 0, 24 and 300 h and given the
   study's saturation fault: the squared error of the weights read back
   against the float weights, clean and faulted, and the cells the cap
   clamps; also without the programming event's drift. Drift is
   multiplicative (sigma 0.26 of each code over 300 h), so a cap at 153
   also clips the drift of codes that were programmed near it.

    python3 tools/fault_regimes.py [--device cpu]

Both parts take about 15 s on a CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import rram  # noqa: E402
from repro_torch.faults import FAULT_CLASSES, default_spec, fault_recovery_study  # noqa: E402
from repro_torch.faults import generators as G  # noqa: E402

HEIGHTS = (64, 128, 2048, 6144)
HOURS = (0.0, 24.0, 300.0)
COLUMNS = 512


def study_beside_reference(device):
    ref = json.loads((ROOT / "BENCH_faults.json").read_text())
    got = fault_recovery_study(ref["arch"], smoke=True, samples=ref["samples"],
                               steps=ref["steps"], seq_len=ref["seq_len"],
                               hours=ref["hours"], seed=ref["seed"], device=device)
    print(f"study at the smoke config, {ref['samples']} samples x {ref['seq_len']} tokens, "
          f"{ref['steps']} steps, {ref['hours']:g} h: port | BENCH_faults.json")
    for kind in FAULT_CLASSES:
        p, r = got[kind], ref["classes"][kind]
        print(f"  {kind:>16}: " + " | ".join(
            f"clean {d['clean_mse']:.4f} faulted {d['faulted_mse']:.4f} calibrated "
            f"{d['calibrated_mse']:.4f} recovered {d['recovered_fraction']:.4f}"
            for d in (p, r)))


def cap_against_drift(device, seed=0):
    cfg = rram.RramConfig(relative_drift=0.10)
    spec = default_spec("saturated", seed + 1)
    print(f"saturated (rate 0.10, cap 153) on one {COLUMNS}-column Gaussian matrix: "
          "squared error of the weights read back, faulted / clean (clamped cells)")
    for programmed, rows in [(p, r) for p in (True, False) for r in HEIGHTS]:
        w = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (rows, COLUMNS)).astype(np.float32)).to(device)
        path = f"probe/{rows}"
        g = rram.make_generator(device, seed, zlib.crc32(path.encode()))
        xw = rram.programmed_codes(w, cfg, g) if programmed else rram.program(w, cfg)
        lf = G.leaf_fault(spec, G.leaf_draws(spec, path, tuple(w.shape), device),
                          tuple(w.shape), cfg, device)
        row = []
        for hours in HOURS:
            g = rram.make_generator(device, seed, zlib.crc32(path.encode()), 1)
            d = rram.apply_drift(xw, cfg, g, hours=hours)
            f = lf.apply(d, cfg)
            clean = float(((rram.dequantize(d) - w).double() ** 2).sum())
            faulted = float(((rram.dequantize(f) - w).double() ** 2).sum())
            clamped = int((f.g_pos != d.g_pos).sum() + (f.g_neg != d.g_neg).sum())
            row.append(f"{hours:g} h {faulted / clean:.4f} ({clamped})")
        how = "programmed_codes" if programmed else "program alone"
        print(f"  {how}, {rows:>5} rows: " + ", ".join(row))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.set_num_threads(min(torch.get_num_threads(), 8))
    study_beside_reference(args.device)
    cap_against_drift(args.device)


if __name__ == "__main__":
    main()
