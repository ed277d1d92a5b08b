"""The paper's tables and figures from the port. Port of
``benchmarks/paper_tables.py``: each function returns CSV rows ``(name,
value, derived)`` under the reference's names.

  fig2_drift_sweep     — Fig. 2: accuracy vs relative drift
  fig4_dataset_size    — Fig. 4: calib-set size, feature-DoRA vs backprop
  fig5_rank_sweep      — Fig. 5: post-calibration accuracy vs rank r
  fig6_lora_vs_dora    — Fig. 6: LoRA vs DoRA at drift 0.15 / 0.20
  table1_lifespan      — Table I: lifespan + speed analytical model
  eq7_param_ratio      — Eq. 7: gamma for ResNet-20/-50 and each LM arch

    python -m repro_torch.launch.paper_tables [--full] [--only NAME,...] [--device cuda]

Quick settings (ResNet-8, 20 classes, 1024 train images, teacher 8
epochs, calibration 10 epochs) or ``--full`` (ResNet-20, 100 classes,
2048 train images, teacher 15 epochs, calibration 20 epochs), the
reference's. One teacher and data set per setting are shared by every
cell (``_shared_setup``). Runs on the card unless ``--device`` says
otherwise, with TF32 off; a failed table stops the run.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import List, Tuple

import torch

from repro_torch.core import repro_experiments as rx
from repro_torch.core import resnet, rram
from repro_torch.core.dora import param_ratio
from repro_torch.core.repro_experiments import ReproResult, run_cell
from repro_torch.core.resnet import ResnetConfig

Row = Tuple[str, float, str]


def _quick_cfg(quick: bool) -> ResnetConfig:
    # depth 8 (n=1) for quick runs; depth 20 (the paper's CIFAR model) for full
    return ResnetConfig(depth=8 if quick else 20, classes=20 if quick else 100)


@functools.lru_cache(maxsize=4)
def _shared_setup(quick: bool, device: str, seed: int = 0):
    """Teacher + data shared across cells (the paper holds them fixed)."""
    from repro_torch.deploy.deployment import resolve_device

    dev = resolve_device(device)
    cfg = _quick_cfg(quick)
    data = rx.cell_data(seed, cfg, dev, n_train=1024 if quick else 2048)
    with resnet.f32_convs():
        teacher = rx.train_teacher(rram.make_generator(dev, seed, rx.TEACHER), cfg,
                                   *data[:2], epochs=8 if quick else 15)
        acc = resnet.accuracy(teacher, *data[2:], cfg)
    return cfg, teacher, data, acc


def _cell(quick, device, **kw) -> ReproResult:
    cfg, teacher, data, _ = _shared_setup(quick, device)
    return run_cell(cfg=cfg, teacher=teacher, data=data, calib_epochs=10 if quick else 20,
                    device=device, **kw)


def fig2_drift_sweep(quick=True, device="cuda") -> List[Row]:
    cfg, teacher, data, teacher_acc = _shared_setup(quick, device)
    rows = [("fig2/teacher_acc", teacher_acc, "clean accuracy")]
    with resnet.f32_convs():
        for drift in (0.05, 0.10, 0.15, 0.20):
            student = rx.make_student(teacher, drift, int(drift * 100))
            acc = resnet.accuracy(student, data[2], data[3], cfg)
            rows.append((f"fig2/drifted_acc@{drift:.2f}", acc,
                         "accuracy after conductance drift, no calibration"))
    return rows


def fig4_dataset_size(quick=True, device="cuda") -> List[Row]:
    rows = []
    for n in ((1, 10, 100) if quick else (1, 10, 100, 500)):
        r = _cell(quick, device, method="dora", rank=2, drift=0.20, samples=n)
        rows.append((f"fig4/feature_dora@{n}", r.calibrated_acc,
                     f"drifted={r.drifted_acc:.3f} teacher={r.teacher_acc:.3f}"))
        b = _cell(quick, device, method="backprop", drift=0.20, samples=n)
        rows.append((f"fig4/backprop@{n}", b.calibrated_acc,
                     "full-parameter CE fine-tune (would write RRAM)"))
    return rows


def fig5_rank_sweep(quick=True, device="cuda") -> List[Row]:
    rows = []
    for r_ in (1, 2, 4, 8):
        r = _cell(quick, device, method="dora", rank=r_, drift=0.20, samples=10)
        rows.append((f"fig5/dora_r{r_}", r.calibrated_acc,
                     f"trainable_frac={r.trainable_fraction:.4f}"))
    return rows


def fig6_lora_vs_dora(quick=True, device="cuda") -> List[Row]:
    rows = []
    for drift in (0.15, 0.20):
        for method in ("lora", "dora"):
            for r_ in ((1, 8) if quick else (1, 2, 4, 8)):
                r = _cell(quick, device, method=method, rank=r_, drift=drift, samples=10)
                rows.append((f"fig6/{method}_r{r_}@{drift:.2f}", r.calibrated_acc,
                             f"drifted={r.drifted_acc:.3f}"))
    return rows


def table1_lifespan(quick=True, device="cuda") -> List[Row]:
    """The analytical model: the paper's arithmetic exactly."""
    bp = rram.lifespan_calibrations(samples=120, epochs=20, batch=1, on_rram=True)
    ours = rram.lifespan_calibrations(samples=10, epochs=20, batch=1, on_rram=False)
    speed = rram.calibration_speedup(base_samples=125, dora_samples=10)
    return [
        ("table1/backprop_lifespan", bp, "paper: 41667 calibrations"),
        ("table1/dora_lifespan", ours, "paper: 5e13 calibrations"),
        ("table1/speedup", speed, "paper: 1250x"),
    ]


def eq7_param_ratio(quick=True, device="cuda") -> List[Row]:
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.models import transformer as T

    rows = [
        ("eq7/resnet20_r1_proxy", param_ratio(144, 16, 1),
         "paper: 4.46% overall for ResNet-20 r=1 (per-layer proxy: 3x3x16 conv)"),
        ("eq7/resnet50_r1_proxy", param_ratio(4608, 512, 1),
         "paper: 0.585% overall for ResNet-50 r=1"),
    ]
    r = _cell(quick, device, method="dora", rank=4, drift=0.10, samples=10)
    rows.append(("eq7/measured_fraction_r4", r.trainable_fraction,
                 "adapter params / base params, whole model"))
    for arch_id in ARCH_IDS:
        params = T.init_params(torch.Generator().manual_seed(0), get_arch(arch_id).smoke)
        nb, na = T.count_params(params)
        rows.append((f"eq7/{arch_id}_smoke", na / nb,
                     "adapter fraction (smoke cfg); the reference's nine other "
                     "archs are not yet in the port"))
    return rows


ALL = {
    "fig2_drift_sweep": fig2_drift_sweep,
    "fig4_dataset_size": fig4_dataset_size,
    "fig5_rank_sweep": fig5_rank_sweep,
    "fig6_lora_vs_dora": fig6_lora_vs_dora,
    "table1_lifespan": table1_lifespan,
    "eq7_param_ratio": eq7_param_ratio,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="the paper-scale settings")
    ap.add_argument("--only", default=None, help="comma-separated table names")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)
    tables = ALL
    if args.only:
        unknown = set(args.only.split(",")) - set(ALL)
        if unknown:
            raise SystemExit(f"unknown tables {sorted(unknown)}; known: {sorted(ALL)}")
        tables = {k: v for k, v in ALL.items() if k in args.only.split(",")}
    print("name,value,derived", flush=True)
    for name, fn in tables.items():
        t0 = time.time()
        for rname, val, derived in fn(quick=not args.full, device=args.device):
            print(f'{rname},{val},"{derived}"', flush=True)
        print(f"# {name} took {time.time() - t0:.1f}s", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
