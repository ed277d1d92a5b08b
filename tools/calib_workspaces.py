"""What a calibration stream leaves allocated on the card: cuBLAS keeps a
workspace per (handle, stream), and autograd runs the backward on a
thread of its own with a handle of its own, so a fresh stream that runs
a forward and its backward holds two. Then whether a CUDA graph's
private pool is released with the graph, and what ``Deployment.calibrate``
leaves allocated on a smoke deployment over three calls (one stream per
deployment):

    python3 tools/calib_workspaces.py

Prints the card, each allocated-memory delta (bytes read after a
synchronize and ``empty_cache``) and, per (pool, stream), the segments
that ``torch.cuda.memory_snapshot`` shows.
"""
from __future__ import annotations

import gc
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def allocated():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def segments(tag):
    by = {}
    for seg in torch.cuda.memory_snapshot():
        active = sum(b["size"] for b in seg["blocks"] if b["state"] == "active_allocated")
        key = (tuple(seg["segment_pool_id"]), seg["stream"])
        row = by.setdefault(key, [0, 0, 0])
        row[0] += 1
        row[1] += seg["total_size"]
        row[2] += active
    for (pool, stream), (n, total, active) in sorted(by.items(), key=str):
        print(f"  {tag}: pool {pool} stream {stream}: {n} segments, {total / 2**20:.2f} MiB, "
              f"{active / 2**20:.2f} MiB active")


def main():
    if not torch.cuda.is_available():
        sys.exit("calib_workspaces: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    dev = torch.device("cuda")
    a = torch.randn(256, 2048, device=dev, dtype=torch.bfloat16)
    w = torch.randn(2048, 2048, device=dev, dtype=torch.bfloat16, requires_grad=True)
    stream = torch.cuda.Stream()
    base = allocated()
    with torch.cuda.stream(stream):
        a @ w.detach()
    print(f"a bf16 matmul on a new stream: +{(allocated() - base) / 2**20:.2f} MiB")
    base = allocated()
    with torch.cuda.stream(stream):
        torch.autograd.grad((a @ w).float().square().sum(), [w])
    print(f"a matmul and its backward on it: +{(allocated() - base) / 2**20:.2f} MiB")
    segments("before a capture")
    base = allocated()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        torch.autograd.grad((a @ w).float().square().sum(), [w])
    print(f"a captured matmul and backward, graph alive: {(allocated() - base) / 2**20:+.2f} MiB")
    segments("graph alive")
    graph.replay()
    del graph
    print(f"graph deleted: {(allocated() - base) / 2**20:+.2f} MiB")
    segments("graph deleted")

    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment, calibration_batch

    cfg = get_arch("qwen3_1_7b").smoke
    dep = Deployment.program(cfg, 0, backend="codes", device=dev).advance(24)
    batch = calibration_batch(cfg, 4, 16)
    for i in range(3):
        base = allocated()
        dep.calibrate(batch, steps=3)
        print(f"smoke calibrate, call {i + 1}: {(allocated() - base) / 2**20:+.2f} MiB")
    segments("after the calibrate calls")


if __name__ == "__main__":
    main()
