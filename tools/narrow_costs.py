"""Where the time of the narrow body (``dora_narrow_kernel``: the f32 body
with f32 x at N <= 64, the MoE routers) goes, on the card. Builds variants
of ``src/repro_torch/kernels/csrc/dora_linear.cu`` whose kernel stops
early, or whose tile or lanes differ, and times each at the routers' rows
(mixtral-8x22b K 6144 N 8, deepseek-v2-lite K 2048 N 64) through the
public wrappers; the differences between neighbours are the cost of each
step:

* ``full``        — the kernel as it is;
* ``no tail``     — every block stops after its ticket (no sum over the
  slabs, no epilogue: the output is not written);
* ``no ticket``   — every block stops after its main loop (the slabs' sums
  written, no fence, no ticket);
* ``no sums``     — nor are the slabs' sums reduced over the lanes or
  written;
* ``copies only`` — nor the products: the copy ring alone;
* ``empty``       — every block returns at once: the launch alone;
* ``rows 8``, ``rows 16``, ``rows 32`` — the whole kernel with tiles of 8,
  16 or 32 rows of x (``kNarrowM``, with ``autotune.NARROW_ROWS`` to
  match), each but the policy's;
* ``lanes 16``, ``lanes 8`` — the whole kernel with at most 16 or 8 lanes
  over a unit's rows (``kNarrowLanes``);
* ``stages 9``    — the whole kernel with a ring of 9 stages (two slabs
  and one stage ahead; ``kNarrowStages``; fits the shared memory of these
  rows' ranks, not of every rank);
* ``2 a SM``, ``a slab a part`` — the kernel as it is under other plans:
  as many parts as keep the launch within two blocks an SM, and one part
  a slab (the result is the same, bit for bit).

Only ``full`` and the tile and lane variants compute the product (each to
its own f32 order); the others are timing variants. Times are CUDA events
around CUDA-graph replays over operand copies rotated past the L2
(``chip_smoke.time_ms``); each variant's registers and spills are logged
from its ``-Xptxas -v`` report.

    python3 tools/narrow_costs.py [--out costs.json]

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
from repro_torch.kernels import dora_linear as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

KERNEL = "dora_narrow_kernel"
# (router, K, N, R, rows)
ROWS = (("mixtral-8x22b", 6144, 8, 8, (1, 4, 32, 64, 96)),
        ("deepseek-v2-lite", 2048, 64, 8, (4, 32, 256)))
# the lines each variant cuts at (each must appear once in the kernel)
TAIL = "  if (!last) return;\n"
LOOP_END = "  cp_async_wait<0>();  // only empty groups are left\n"
SLAB_END = ("    if ((j + 1) % (kNarrowSlab / kNarrowK) != 0 && j != T - 1) continue;\n")
PRODUCTS = "      for (int kk = lane; kk < kNarrowK; kk += lanes) {\n"
START = "  const int tid = threadIdx.x;\n"


def _cut(src, *edits):
    """``src`` with each (old, new) of ``edits`` applied inside the
    definition of the narrow kernel only (each old text once there)."""
    head = src.index(f"    {KERNEL}(")
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
    """{name: (source, rows of a tile)}"""
    stop = (LOOP_END, LOOP_END + "  if (M > 0) return;\n")
    rows = autotune.NARROW_ROWS
    return {
        "full": (src, rows),
        "no tail": (_cut(src, (TAIL, "  return;\n")), rows),
        "no ticket": (_cut(src, stop), rows),
        "no sums": (_cut(src, stop, (SLAB_END, "    continue;\n")), rows),
        "copies only": (_cut(src, stop, (SLAB_END, "    continue;\n"),
                             (PRODUCTS, "      for (int kk = lane; M < 0; kk += lanes) {\n")),
                        rows),
        "empty": (_cut(src, (START, START + "  if (M > 0) return;\n")), rows),
        **{f"rows {bm}": (_const(src, "kNarrowM", bm), bm) for bm in (8, 16, 32) if bm != rows},
        "lanes 16": (_const(src, "kNarrowLanes", 16), rows),
        "lanes 8": (_const(src, "kNarrowLanes", 8), rows),
        "stages 9": (_const(src, "kNarrowStages", 9), rows),
    }


def _two_a_sm(m, n, k):
    """narrow_plan with two blocks an SM in place of one."""
    tiles = -(-m // autotune.NARROW_ROWS)
    slabs = -(-k // autotune.MIN_SPLIT_ROWS)
    per = -(-slabs // max(1, 2 * autotune.SMS // tiles))
    return -(-slabs // per)


# plans timed with the full kernel: {name: parts(m, n, k)}
PLANS = {"2 a SM": _two_a_sm,
         "a slab a part": lambda m, n, k: -(-k // autotune.MIN_SPLIT_ROWS)}


def build(sources):
    out = B.BUILD_DIR / "narrow_costs"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, (text, _)) in enumerate(sources.items()):
        path = out / f"dora_linear_{i}.cu"
        path.write_text(text)
        lib = B.CudaLibrary("dora_linear.cu", K._bind)
        lib.src = path
        libs[name] = lib
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.load) for lib in libs.values()]:
            future.result()
    return libs


def ptxas(lib):
    """"<registers> | <stack and spills>" of the variant's narrow kernel."""
    lines = str(lib.info["log"]).splitlines()
    for i, line in enumerate(lines):
        if KERNEL in line and "Compiling entry" in line:
            near = lines[i + 1:i + 4]
            regs = next((m.group(0) for ln in near
                         for m in [re.search(r"\d+ registers", ln)] if m), "")
            spill = next((ln.strip() for ln in near if "spill" in ln), "")
            return f"{regs} | {spill}"
    return ""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = S.phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    sources = variants((B.CSRC / "dora_linear.cu").read_text())
    libs = build(sources)
    result = {"card": smi, "rows": [], "ptxas": {name: ptxas(lib) for name, lib in libs.items()}}
    for name, report in result["ptxas"].items():
        S.log(f"[ptxas] {name:11s} {report}")
    policy, plan = autotune.NARROW_ROWS, autotune.narrow_plan
    for router, k, n, r, ms in ROWS:
        for m in ms:
            kind = "dora_linear_gemv" if autotune.use_gemv(m) else "dora_linear"
            fn = getattr(K, kind)
            ops = [S.router_operands(m, device, seed=i, shape=(k, n, r))
                   for i in range(S._copies(2 * k * n + 4 * m * k + 4 * m * n))]
            want = ref.dora_linear_ref(*ops[0])
            row = {"router": router, "m": m, "k": k, "n": n, "us": {}, "right": {}}
            try:
                for name, lib in libs.items():
                    K.build = lib.load
                    autotune.NARROW_ROWS = sources[name][1]
                    K._SEMS.clear()  # a variant may leave its tickets set
                    row["us"][name] = 1e3 * S.time_ms([lambda o=o: fn(*o) for o in ops])
                    if name == "full" or name.startswith(("rows", "lanes", "stages")):
                        K._SEMS.clear()
                        got = fn(*ops[0])
                        row["right"][name] = bool(torch.allclose(got, want, rtol=S.TOL,
                                                                 atol=S.TOL))
                        if name == "full":
                            got_full = got
                K.build = libs["full"].load
                autotune.NARROW_ROWS = policy
                for name, parts in PLANS.items():
                    autotune.narrow_plan = parts
                    K._SEMS.clear()
                    row["us"][name] = 1e3 * S.time_ms([lambda o=o: fn(*o) for o in ops])
                    row["right"][name] = bool(torch.equal(fn(*ops[0]), got_full))
                    autotune.narrow_plan = plan
            finally:
                autotune.NARROW_ROWS, autotune.narrow_plan = policy, plan
            result["rows"].append(row)
            S.log(f"[costs] {router:16s} M={m:3d} "
                  + " | ".join(f"{name} {us:.2f} us" for name, us in row["us"].items())
                  + f" | right {row['right']}")
            del ops
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
