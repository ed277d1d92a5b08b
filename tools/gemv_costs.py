"""Where the time of a GEMV launcher's tensor-core body goes, on the card:
the f32 body (bf16 x, ``dora_gemv_mma_kernel``) or the int8 body
(``--accum int8``, bf16 x, ``dora_gemv_int8_kernel``). Builds variants of
``src/repro_torch/kernels/csrc/dora_linear.cu`` whose kernel stops early,
and times each per qwen3-1.7b fused leaf at the row counts of ``ROWS``;
the differences between neighbours are the cost of each step. f32:

* ``full``       — the kernel as it is;
* ``no X@A wait`` — the strip's last block does not wait for the X @ A
  blocks (it reads whatever partials are there: wrong output, same work);
* ``no epilogue`` — every block stops after its ticket (no ordered sum of
  the parts, no X @ A, B, scale or gamma);
* ``no ticket``  — every block stops after its main loop (no raw sums
  written, no ticket); the X @ A blocks still run;
* ``empty``      — every block returns at once: the launch alone.

int8 (the X @ A blocks run in every variant but ``empty``):

* ``full``, ``no epilogue`` (the strips' last blocks) and ``no ticket``
  (raw sums and ticket) as for f32;
* ``no MMAs``    — the main loop without its MMAs (nor the shared loads
  and transposes of the codes that feed them): copies, row scales and
  quantization;
* ``copies only`` — nor the row scales or the quantization: the copy ring
  alone;
* ``empty``      — the launch alone (and, from GEMV_INT8_PRESCALE_ROWS
  rows, the row-scale pass before it, which every variant keeps).

Only ``full`` computes the product; the others are timing variants. Times
are CUDA events around CUDA-graph replays over operand copies rotated past
the L2 (``chip_smoke.time_ms``). Each variant's registers, stack frame and
spills per instantiation (rows of 8 NT, 16-byte copies VEC, x type) are
logged from its ``-Xptxas -v`` report.

    python3 tools/gemv_costs.py [--accum f32|int8] [--out costs.json]

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
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import dora_linear as K  # noqa: E402

# the decode tick and a full admission chunk; for the int8 body also a
# single stream and the smallest chunk bucket
ROWS = {"f32": (S.SLOTS, 32), "int8": (1, S.SLOTS, 8, 32)}
KERNELS = {"f32": "dora_gemv_mma_kernel", "int8": "dora_gemv_int8_kernel"}
# the lines each variant cuts at (each must appear once in the kernel)
WAIT = "    while (*count < xa_blocks) __nanosleep(128);\n"
TICKET = "  if (!last) return;\n"
LOOP_END = "  cp_async_wait<0>();\n  __syncthreads();\n\n  // the second K half's sums onto the first"
START = "  const int XT = (M + kPrepRowTile - 1) / kPrepRowTile, xa_blocks = XT * G;\n"
MMA = "    mma_tile(j);\n"
QUANT = ("    if (j + 1 < tiles) quantize(j + 1);\n", "  quantize(0);\n",
         "    gemv_row_scales<VEC>(x, M, K, 0, 8 * NT, xs_s);\n")


def _cut(src, kernel, *edits):
    """``src`` with each (old, new) of ``edits`` applied inside the
    definition of ``kernel`` only (each old text once there)."""
    head = src.index(f"    {kernel}(")
    end = src.index("\n}\n", head)
    body = src[head:end]
    for old, new in edits:
        assert body.count(old) == 1, (kernel, old)
        body = body.replace(old, new)
    return src[:head] + body + src[end:]


def variants(src, accum):
    kernel = KERNELS[accum]
    stop = (LOOP_END, LOOP_END.replace("  __syncthreads();\n", "  if (M > 0) return;\n"))
    if accum == "f32":
        return {
            "full": src,
            "no X@A wait": _cut(src, kernel, (WAIT, "")),
            "no epilogue": _cut(src, kernel, (TICKET, "  return;\n")),
            "no ticket": _cut(src, kernel, stop),
            "empty": _cut(src, kernel, (START, START + "  if (M > 0) return;\n")),
        }
    no_mma = (stop, (MMA, ""))
    return {
        "full": src,
        "no epilogue": _cut(src, kernel, (TICKET, "  return;\n")),
        "no ticket": _cut(src, kernel, stop),
        "no MMAs": _cut(src, kernel, *no_mma),
        "copies only": _cut(src, kernel, *no_mma, *((q, "") for q in QUANT)),
        "empty": _cut(src, kernel, (START, START + "  if (M > 0) return;\n")),
    }


def build(sources):
    out = B.BUILD_DIR / "costs"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = out / f"dora_linear_{i}.cu"
        path.write_text(text)
        lib = B.CudaLibrary("dora_linear.cu", K._bind)
        lib.src = path
        libs[name] = lib
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.load) for lib in libs.values()]:
            future.result()
    return libs


def ptxas(lib, kernel):
    """{"NT=n VEC=v [x type]": "<registers> | <stack and spills>"} of the
    variant's ``kernel`` instantiations."""
    lines = str(lib.info["log"]).splitlines()
    found = {}
    for i, line in enumerate(lines):
        hit = re.search(kernel + r"ILi(\d+)ELb(\d)E(?:(13__nv_bfloat16|f)E)?", line)
        if hit and "Compiling entry" in line:
            near = lines[i + 1:i + 4]
            regs = next((m.group(0) for ln in near
                         for m in [re.search(r"\d+ registers", ln)] if m), "")
            spill = next((ln.strip() for ln in near if "spill" in ln), "")
            x = {"13__nv_bfloat16": " x bf16", "f": " x f32"}.get(hit.group(3), "")
            found[f"NT={hit.group(1)} VEC={hit.group(2)}{x}"] = f"{regs} | {spill}"
    return found


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--accum", choices=tuple(KERNELS), default="f32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    accum = args.accum
    smi = S.phase_card()
    device = torch.device("cuda")
    libs = build(variants((B.CSRC / "dora_linear.cu").read_text(), accum))
    result = {"card": smi, "accum": accum, "rows": [],
              "ptxas": {name: ptxas(lib, KERNELS[accum]) for name, lib in libs.items()}}
    for name, kernels in result["ptxas"].items():
        for inst, report in kernels.items():
            S.log(f"[ptxas] {name:11s} {inst}: {report}")
    for m in ROWS[accum]:
        layer = {name: 0.0 for name in libs}
        for leaf, k, n, r in S.LEAVES:
            ops = [S.operands(m, k, n, r, device, seed=i)
                   for i in range(S._copies(2 * k * n + 2 * m * k + 4 * m * n))]
            row = {"m": m, "leaf": leaf, "us": {}}
            for name, lib in libs.items():
                K.build = lib.load
                K._SEMS.clear()  # a variant may leave its tickets set
                row["us"][name] = 1e3 * S.time_ms(
                    [lambda o=o: K.dora_linear_gemv(*o, accum=accum) for o in ops])
                layer[name] += row["us"][name]
            result["rows"].append(row)
            S.log(f"[costs] {accum} M={m:2d} {leaf:8s} "
                  + " | ".join(f"{name} {us:.1f} us" for name, us in row["us"].items()))
            del ops
        S.log(f"[costs] {accum} M={m:2d} layer    "
              + " | ".join(f"{name} {us:.1f} us" for name, us in layer.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
