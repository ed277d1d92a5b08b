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

With ``--narrow`` the same for the narrow body (``adc_narrow_kernel``: f32
x at N <= 64, the routers under codes_adc), at mixtral-8x22b's router (K
6144, N 8; M = 1, 4, 32, 96, 256) and deepseek-v2-lite's (K 2048, N 64; M =
4, 32):

* ``empty``        — every block returns at once: the launch alone;
* ``copies only``  — the copy ring alone (no max |x|, no products, no tile
  ends), then return;
* ``+products``    — with the max |x| and the products, then return (no
  tile ends);
* ``+tile ends``   — with each tile's step, butterfly, digitization and
  partials written, then return (no fence, no ticket);
* ``+ticket``      — with the fence and the ticket, then every block
  returns (no last block: the output is not written);
* ``full``         — the kernel as it is;
* ``32-row stages``, ``128-row stages`` — the whole kernel with a ring of
  9 stages of 32 rows (a tile in flight, 8 barriers a tile), or of 2
  stages of 128 rows (half a tile in flight, 2 barriers);
* ``2 tiles a part``, ``1 part`` — the kernel as it is under other plans
  (the result is the same, bit for bit).

    python3 tools/adc_costs.py [--narrow] [--out costs.json]

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

# the lines each variant cuts at (each must appear once in its kernel)
START = "  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);\n"
WORK = "    fold_absmax(j);\n    mma_stage(j);\n"
TILE_END = "    if ((j + 1) % SPT != 0 && j != nst - 1) continue;\n"
LOOP_END = "  cp_async_wait<0>();\n\n  const float sc0"
# the narrow body's
N_START = "  const int tid = threadIdx.x;\n"
N_MAX = "    for (int p = tid; p < RG * kNarrowK; p += kNarrowThreads) {\n"
N_PRODUCTS = "      for (int kk = lane; kk < kNarrowK; kk += lanes) {\n"
N_LOOP_END = "  cp_async_wait<0>();  // only empty groups are left\n"
N_TAIL = "  if (!last) return;\n"


def _cut(src, kernel, *edits):
    """``src`` with each (old, new) of ``edits`` applied inside the
    definition of ``kernel`` only (each old text once there)."""
    head = src.index(f"    {kernel}(")
    end = src.index("\n}\n", head)
    body = src[head:end]
    for old, new in edits:
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    return src[:head] + body + src[end:]


def _const(src, name, value):
    """``src`` with ``constexpr int name`` set to ``value``."""
    line = re.search(rf"constexpr int {name} = [^;]+;", src).group(0)
    return src.replace(line, f"constexpr int {name} = {value};", 1)


def variants(src):
    def cut(*edits):
        return _cut(src, "adc_mma_kernel", *edits)

    stop = (LOOP_END, LOOP_END.replace("\n\n", "\n  if (M > 0) return;\n\n"))
    no_tiles = (TILE_END, "    if (M > 0) continue;\n")
    return {
        "empty": cut((START, START + "  if (M > 0) return;\n")),
        "copies": cut(stop, no_tiles, (WORK, "")),
        "+mma": cut(stop, no_tiles),
        "+tile ends": cut(stop),
        "full": src,
    }


def narrow_variants(src):
    """{name: (source, stage rows, ring stages)} of the narrow body."""
    def cut(*edits):
        return _cut(src, "adc_narrow_kernel", *edits)

    stop = (N_LOOP_END, N_LOOP_END + "  if (M > 0) return;\n")
    no_tiles = (TILE_END, "    if (M > 0) continue;\n")
    none = lambda line: (line, line.replace("kNarrowThreads) {", "kNarrowThreads) { break;")
                         .replace("lanes) {", "lanes) { break;"))
    rows, ring = autotune.ADC_NARROW_STAGE_ROWS, autotune.ADC_NARROW_STAGES
    return {
        "empty": (cut((N_START, N_START + "  if (M > 0) return;\n")), rows, ring),
        "copies only": (cut(stop, no_tiles, none(N_MAX), none(N_PRODUCTS)), rows, ring),
        "+products": (cut(stop, no_tiles), rows, ring),
        "+tile ends": (cut(stop), rows, ring),
        "+ticket": (cut((N_TAIL, "  return;\n")), rows, ring),
        "full": (src, rows, ring),
        "32-row stages": (_const(_const(src, "kNarrowStages", 9), "kNarrowK", 32), 32, 9),
        "128-row stages": (_const(_const(src, "kNarrowStages", 2), "kNarrowK", 128), 128, 2),
    }


# the checkout's own build, which the narrow body's variants replace in turn
LOAD = C.build
# the narrow body's rows: (router, K, N, rows)
NARROW_ROWS = (("mixtral-8x22b", 6144, 8, (1, 4, 32, 96, 256)),
               ("deepseek-v2-lite", 2048, 64, (4, 32)))
# plans timed with the full kernel: {name: parts(m, k, n)}
NARROW_PLANS = {"2 tiles a part": lambda m, k, n: -(-k // (2 * autotune.ADC_ARRAY_ROWS)),
                "1 part": lambda m, k, n: 1}


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


def ptxas(lib, pattern=r"adc_mma_kernelILi(\d+)ELb(\d)E"):
    """{instantiation: "<registers> | <stack and spills>"} of the variant's
    kernels whose mangled name matches ``pattern`` (by default
    adc_mma_kernel's, keyed "NT=n VEC=v")."""
    lines = str(lib.info["log"]).splitlines()
    found = {}
    for i, line in enumerate(lines):
        hit = re.search(pattern, line)
        if hit and "Compiling entry" in line:
            near = lines[i + 1:i + 4]
            regs = next((m.group(0) for ln in near
                         for m in [re.search(r"\d+ registers", ln)] if m), "")
            spill = next((ln.strip() for ln in near if "spill" in ln), "")
            key = "NT={} VEC={}".format(*hit.groups()) if hit.groups() else hit.group(0)
            found[key] = f"{regs} | {spill}"
    return found


def narrow_main(smi, device):
    """The narrow body's cut at the routers' rows (``--narrow``)."""
    sources = narrow_variants((B.CSRC / "crossbar_mvm.cu").read_text())
    libs = build({name: text for name, (text, _, _) in sources.items()}, "adc_narrow_costs")
    result = {"card": smi, "rows": [],
              "ptxas": {name: ptxas(lib, r"adc_narrow_kernel") for name, lib in libs.items()}}
    for name, report in result["ptxas"].items():
        S.log(f"[ptxas] {name:14s} {report}")
    keep = (autotune.ADC_NARROW_STAGE_ROWS, autotune.ADC_NARROW_STAGES, autotune.adc_narrow_plan)
    for router, k, n, ms in NARROW_ROWS:
        for m in ms:
            ops = [S.router_operands(m, device, seed=i, shape=(k, n, 1))[:4]
                   for i in range(S._copies(2 * k * n + 4 * m * k + 4 * m * n))]
            want = C.crossbar_mvm(*ops[0])
            row = {"router": router, "m": m, "k": k, "n": n,
                   "parts": autotune.adc_narrow_plan(m, k, n), "us": {}, "bitwise": {}}
            try:
                for name, lib in libs.items():
                    C.build = lib.load
                    autotune.ADC_NARROW_STAGE_ROWS, autotune.ADC_NARROW_STAGES = sources[name][1:]
                    C._SEMS.clear()  # a variant may leave its tickets set
                    row["us"][name] = 1e3 * S.time_ms([lambda o=o: C.crossbar_mvm(*o) for o in ops])
                    if name in ("full", "32-row stages", "128-row stages"):
                        row["bitwise"][name] = bool(torch.equal(C.crossbar_mvm(*ops[0]), want))
                C.build = libs["full"].load
                autotune.ADC_NARROW_STAGE_ROWS, autotune.ADC_NARROW_STAGES = keep[:2]
                for name, parts in NARROW_PLANS.items():
                    autotune.adc_narrow_plan = parts
                    C._SEMS.clear()
                    row["us"][name] = 1e3 * S.time_ms([lambda o=o: C.crossbar_mvm(*o) for o in ops])
                    row["bitwise"][name] = bool(torch.equal(C.crossbar_mvm(*ops[0]), want))
                    autotune.adc_narrow_plan = keep[2]
            finally:
                C.build = LOAD
                (autotune.ADC_NARROW_STAGE_ROWS, autotune.ADC_NARROW_STAGES,
                 autotune.adc_narrow_plan) = keep
            result["rows"].append(row)
            S.log(f"[costs] {router:16s} M={m:3d} parts {row['parts']:2d} "
                  + " | ".join(f"{name} {us:.2f} us" for name, us in row["us"].items())
                  + f" | bitwise the checkout's {row['bitwise']}")
            del ops
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--narrow", action="store_true",
                    help="cut the narrow body (f32 x, N <= 64) instead")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = S.phase_card()
    device = torch.device("cuda")
    if args.narrow:
        result = narrow_main(smi, device)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return
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
