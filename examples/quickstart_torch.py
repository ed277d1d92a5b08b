"""Quickstart on the PyTorch port: the paper's device lifetime in one
object, the twin of ``examples/quickstart.py``.

1. ``Deployment.program``  — deploy a small LM onto the simulated
   crossbar codes (programming event; the array is now fixed).
2. ``dep.advance(hours)``  — the drift clock: conductances relax.
3. ``dep.calibrate``       — feature-based DoRA (Algorithm 1+2): only the
   SRAM side-cars train, under the ``dequant`` backend; zero RRAM writes.
4. ``dep.serve``           — serve the calibrated student from the codes
   through the fused CUDA kernel (DoRA magnitudes merged).

...and drift keeps happening, so steps 2-3 repeat on the same array.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--smoke] [--device cpu]
(the default device is the CUDA card; ``--smoke`` takes the reduced
same-family config).
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.deploy import Deployment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = get_arch("qwen3-1.7b")
    cfg = spec.smoke if args.smoke else spec.full
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=g)}

    # 1. programming event: teacher trained elsewhere, deployed onto RRAM codes
    dep = Deployment.program(cfg, 0, backend="codes", device=args.device)
    gap0 = dep.logit_mse(batch, use_adapters=False)
    print(f"teacher/student logit MSE after programming: {gap0:.5f}")

    # 2. a day in the field: conductance relaxation, no reprogramming
    dep.advance(hours=24)
    gap1 = dep.logit_mse(batch, use_adapters=False)
    print(f"after 24h of drift:                          {gap1:.5f}")

    # 3. calibration: only the SRAM side-cars train (~2-3% of params)
    report = dep.calibrate(batch, steps=20, lr=3e-3)
    print(report.summary())
    gap2 = dep.logit_mse(batch)
    print(f"after calibration:                           {gap2:.5f} "
          f"({100 * (1 - gap2 / gap1):.1f}% of the drift gap recovered, "
          "zero RRAM writes)")

    # 4. serve the calibrated deployment from the codes
    session = dep.serve()
    print(session.describe())
    toks, dt = session.generate(batch["tokens"][:, :8].to(dep.device), gen_len=8)
    print(f"served {toks.shape} (decode steps: {dt:.2f}s); first row: {toks[0].tolist()}")

    # ...time keeps passing: drift again, recalibrate again — same array
    dep.advance(hours=168)
    report2 = dep.calibrate(batch, steps=20, lr=3e-3)
    print(f"one week later, recalibrated: feature MSE "
          f"{report2.initial_loss:.6f} -> {report2.final_loss:.6f}")


if __name__ == "__main__":
    main()
