"""The paper's experiment on the PyTorch port, the twin of
``examples/calibrate_resnet.py``: ResNet + drift + DoRA feature
calibration vs LoRA vs backprop (the Fig. 4/6 protocol), through the
deployment API's CNN-lifecycle entry (``repro_torch.deploy.resnet_cell``).

Run:  PYTHONPATH=src python examples/calibrate_resnet_torch.py [--device cpu]
(the default device is the CUDA card).
"""
import argparse

from repro_torch.deploy import resnet_cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("running 3 calibration methods at drift=0.20, 10 samples "
          "(ResNet-20, procedural data)...")
    for method in ("dora", "lora", "backprop"):
        r = resnet_cell(method=method, rank=2, drift=0.20, samples=10,
                        calib_epochs=10, device=args.device)
        print(
            f"{method:9s} teacher={r.teacher_acc:.3f} "
            f"drifted={r.drifted_acc:.3f} calibrated={r.calibrated_acc:.3f} "
            f"trainable={r.trainable_fraction:.2%}"
        )


if __name__ == "__main__":
    main()
