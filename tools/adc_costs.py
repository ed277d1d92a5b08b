"""Where the time of the ADC kernel's tensor-core body (bf16 x) goes, on
the card. Builds variants of ``src/repro_torch/kernels/csrc/crossbar_mvm.cu``
whose ``adc_mma_kernel`` does less, and times each per qwen3-1.7b unfused
leaf under the policy's plan at the row counts of
``chip_smoke.TIMED_M_ADC``; the differences between neighbours are the cost
of each step:

* ``empty``      — every block returns at once: the launch alone;
* ``copies``     — the copy ring alone (no max |x|, no MMAs, no tile ends),
  then return;
* ``+mma``       — with the G+ - G- conversion, the MMAs and max |x|, then
  return (no tile ends);
* ``+tile ends`` — with each tile's step, digitization, running sum and
  (parts > 1) partials written, then return (no ticket, no ordered sum);
* ``full``       — the kernel as it is.

Only ``full`` computes the product; the others are timing variants. Times
are CUDA events around CUDA-graph replays over operand copies rotated past
the L2 (``chip_smoke.time_ms``). Each variant's registers, stack frame and
spills per instantiation (NT tiles of 8 rows, 16-byte copies VEC) are
logged from its ``-Xptxas -v`` report.

    python3 tools/adc_costs.py [--out costs.json]

Needs one CUDA card and nvcc; the variants are built into the git-ignored
``src/repro_torch/kernels/_build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import crossbar_mvm as C  # noqa: E402

# the lines each variant cuts at (each must appear once in the source)
START = "  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);\n"
WORK = "    fold_absmax(j);\n    mma_stage(j);\n"
TILE_END = "    if ((j + 1) % SPT != 0 && j != nst - 1) continue;\n"
LOOP_END = "  cp_async_wait<0>();\n\n  const float sc0"


def variants(src):
    for cut in (START, WORK, TILE_END, LOOP_END):
        assert src.count(cut) == 1, cut
    stop = src.replace(LOOP_END, LOOP_END.replace("\n\n", "\n  if (M > 0) return;\n\n"))
    no_tiles = stop.replace(TILE_END, "    if (M > 0) continue;\n")
    return {
        "empty": src.replace(START, START + "  if (M > 0) return;\n"),
        "copies": no_tiles.replace(WORK, ""),
        "+mma": no_tiles,
        "+tile ends": stop,
        "full": src,
    }


def build(sources, tag="adc_costs"):
    """{name: CudaLibrary} of the ADC source's variants {name: text}, built
    in parallel under ``_build/<tag>``."""
    out = B.BUILD_DIR / tag
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = out / f"crossbar_mvm_{i}.cu"
        path.write_text(text)
        lib = B.CudaLibrary("crossbar_mvm.cu", C._bind)
        lib.src = path
        libs[name] = lib
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.load) for lib in libs.values()]:
            future.result()
    return libs


def ptxas(lib):
    """{"NT=n VEC=v": "<registers> | <stack and spills>"} of the variant's
    adc_mma_kernel instantiations."""
    lines = str(lib.info["log"]).splitlines()
    found = {}
    for i, line in enumerate(lines):
        hit = re.search(r"adc_mma_kernelILi(\d+)ELb(\d)E", line)
        if hit and "Compiling entry" in line:
            near = lines[i + 1:i + 4]
            regs = next((m.group(0) for ln in near
                         for m in [re.search(r"\d+ registers", ln)] if m), "")
            spill = next((ln.strip() for ln in near if "spill" in ln), "")
            nt, vec = hit.groups()
            found[f"NT={nt} VEC={vec}"] = f"{regs} | {spill}"
    return found


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = S.phase_card()
    device = torch.device("cuda")
    libs = build(variants((B.CSRC / "crossbar_mvm.cu").read_text()))
    result = {"card": smi, "ptxas": {name: ptxas(lib) for name, lib in libs.items()}, "rows": []}
    for name, kernels in result["ptxas"].items():
        for inst, report in kernels.items():
            S.log(f"[ptxas] {name:10s} {inst}: {report}")
    for m in S.TIMED_M_ADC:
        layer = {name: 0.0 for name in libs}
        for leaf, k, n in S.ADC_LEAVES:
            ops = [S.operands(m, k, n, 1, device, seed=i)[:4]
                   for i in range(S._copies(2 * k * n + 2 * m * k + 4 * m * n))]
            row = {"m": m, "leaf": leaf, "parts": autotune.adc_plan(m, k, n), "us": {}}
            for name, lib in libs.items():
                C.build = lib.load
                C._SEMS.clear()  # a variant may leave its tickets set
                row["us"][name] = 1e3 * S.time_ms([lambda o=o: C.crossbar_mvm(*o) for o in ops])
                layer[name] += row["us"][name]
            result["rows"].append(row)
            S.log(f"[costs] M={m:3d} {leaf:5s} parts {row['parts']:2d} "
                  + " | ".join(f"{name} {us:.1f} us" for name, us in row["us"].items()))
            del ops
        S.log(f"[costs] M={m:3d} layer "
              + " | ".join(f"{name} {us:.1f} us" for name, us in layer.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
