"""Sweep the stage depth of the tiled launcher's int8 tensor-core body on
the card, at the fused prefill's rows and at 256 rows. For each candidate
(rows of K per pipeline stage) it builds a variant of
``src/repro_torch/kernels/csrc/dora_linear.cu`` with that ``kMmaKInt8``,
holds it against the plain version (within 1e-4 of the output's absmax,
bitwise repeatable, bitwise on the exactness cases), then times it per
qwen3-1.7b fused leaf and per layer (the four leaves summed):

* under the policy (``autotune.tiled_tiles``) with 2, 3 and 4 blocks an
  SM assumed for the wave it fills;
* at fixed K splits (1, 2, 3, 4, 6, 8 parts).

Beside them, the f32 body (bf16 x) and two ``torch._int_mm`` on
pre-recoded s8 codes on the same operands. Times are CUDA events around
CUDA-graph replays over operand copies rotated past the L2
(``chip_smoke.time_ms``).

    python3 tools/sweep_tiled_int8.py [--out sweep.json]

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
from repro_torch.kernels import autotune, ref  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import dora_linear as K  # noqa: E402

# rows of K per stage; each fits two blocks an SM
VARIANTS = (64, 32)
PER_SM = (2, 3, 4)
SPLITS = (1, 2, 3, 4, 6, 8)
EXACT = ((100, 300, 77), (256, 512, 2048), (130, 6144, 2048))
CHOSEN = autotune.MMA_BODIES["int8"]  # the policy's stage depth, one of VARIANTS
WAVE = autotune.WAVE


def build_variants():
    """One library per variant, built in parallel; logs each int8 main
    kernel's registers and spills (-Xptxas -v)."""
    src = (B.CSRC / "dora_linear.cu").read_text()
    out = B.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for bk in VARIANTS:
        text = re.sub(r"constexpr int kMmaKInt8 = \d+;", f"constexpr int kMmaKInt8 = {bk};", src)
        path = out / f"dora_linear_k{bk}.cu"
        path.write_text(text)
        lib = B.CudaLibrary("dora_linear.cu", K._bind)
        lib.src = path
        libs[bk] = lib
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.load) for lib in libs.values()]:
            future.result()
    for bk, lib in libs.items():
        lines = str(lib.info["log"]).splitlines()
        for i, line in enumerate(lines):
            # the int8 instantiations of dora_mma_kernel<BM, BN, BK, VEC, true>
            hit = re.search(r"dora_mma_kernelILi(\d+)ELi\d+ELi\d+ELb(\d)ELb1E", line)
            if hit and "Compiling entry" in line:
                regs = next((ln.strip() for ln in lines[i + 1:i + 4] if "registers" in ln), "")
                spill = next((ln.strip() for ln in lines[i + 1:i + 4] if "spill" in ln), "")
                S.log(f"[ptxas] {bk} BM={hit.group(1)} vec={hit.group(2)}: {regs} | {spill}")
        S.log(f"[build] variant {bk} in {lib.info['seconds']:.1f} s")
    return libs


def use(libs, bk, per_sm=WAVE // autotune.SMS):
    """Launch the variant with ``bk``-row stages; the policy fills a wave
    of ``per_sm`` blocks an SM."""
    K.build = libs[bk].load
    autotune.MMA_BODIES["int8"] = bk
    autotune.WAVE = per_sm * autotune.SMS


def check(libs, device):
    for bk in libs:
        use(libs, bk)
        worst = 0.0
        shapes = [(m, k, n, r) for _, k, n, r in S.LEAVES for m in (65, 96, 256)] + S.MASKED
        for m, k, n, r in shapes:
            ops = S.operands(m, k, n, r, device, seed=m + k)
            want = ref.dora_linear_int8_ref(*ops)
            got, again = K.dora_linear(*ops, accum="int8"), K.dora_linear(*ops, accum="int8")
            torch.cuda.synchronize()
            rel = float((got - want).abs().max()) / float(want.abs().max())
            assert rel <= S.INT8_TOL and torch.equal(got, again), (bk, (m, k, n, r), rel)
            worst = max(worst, rel)
        for m, k, n in EXACT:
            ops = S.exact_operands(m, k, n, device, seed=m)
            got = K.dora_linear(*ops, accum="int8")
            assert torch.equal(got, ref.dora_linear_int8_ref(*ops)), (bk, (m, k, n))
        S.log(f"[check] variant {bk}: max |err| {worst:.2e} of absmax, exactness bitwise")


def sweep(libs, device, m):
    """Per leaf: every variant under the policy and at fixed splits; the
    f32 body and the library beside them. Returns the rows."""
    rows = []
    real_tiles = autotune.tiled_tiles
    for name, k, n, r in S.LEAVES:
        ops = [S.operands(m, k, n, r, device, seed=i)
               for i in range(S._copies(2 * k * n + 2 * m * k + 4 * m * n))]
        fns = [lambda o=o: K.dora_linear(*o, accum="int8") for o in ops]
        for bk in libs:
            for per_sm in PER_SM:
                use(libs, bk, per_sm)
                plan = autotune.tiled_tiles(m, n, k, "int8")
                rows.append(dict(leaf=name, m=m, variant=bk, per_sm=per_sm,
                                 splits=plan.splits(k), blocks=plan.blocks(m, n, k),
                                 ms=S.time_ms(fns)))
            use(libs, bk)
            k_steps = -(-k // bk)
            seen = set()
            for splits in SPLITS:
                steps = max(-(-k_steps // splits), -(-autotune.MIN_SPLIT_ROWS // bk))
                plan = autotune.TilePlan(128 if m > 64 else 64, min(steps, k_steps) * bk)
                if plan.k_split in seen:
                    continue
                seen.add(plan.k_split)
                autotune.tiled_tiles = lambda *_a, p=plan: p
                try:
                    ms = S.time_ms(fns)
                finally:
                    autotune.tiled_tiles = real_tiles
                rows.append(dict(leaf=name, m=m, variant=bk, per_sm=None,
                                 splits=plan.splits(k), blocks=plan.blocks(m, n, k), ms=ms))
        use(libs, CHOSEN)
        f32 = S.time_ms([lambda o=o: K.dora_linear(*o) for o in ops])
        s8 = [(ref.quantize_rows(o[0])[0], ref.recode_s8(o[1]), ref.recode_s8(o[2])) for o in ops]
        library = S.time_ms([lambda q=q: (torch._int_mm(q[0], q[1]), torch._int_mm(q[0], q[2]))
                             for q in s8])
        rows.append(dict(leaf=name, m=m, variant="f32 body", ms=f32))
        rows.append(dict(leaf=name, m=m, variant="library", ms=library))
        mine = sorted((rw for rw in rows if rw["leaf"] == name and rw["m"] == m
                       and isinstance(rw["variant"], int)), key=lambda rw: rw["ms"])
        S.log(f"[sweep] {name} M={m}: f32 body {f32:.4f} ms, library {library:.4f} ms; fastest:")
        for rw in mine[:6]:
            how = f"policy {rw['per_sm']}/SM" if rw["per_sm"] else "fixed"
            S.log(f"[sweep]     {rw['ms']:.4f} ms {rw['variant']}-row stages {how} "
                  f"splits {rw['splits']} blocks {rw['blocks']}")
        del ops, s8, fns
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write every row to this JSON file")
    args = ap.parse_args()
    smi = S.phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    libs = build_variants()
    check(libs, device)
    rows = []
    for m in (S.PREFILL_ROWS, S.PREFILL_M):
        rows += sweep(libs, device, m)
        layer = {}
        for rw in rows:
            if rw["m"] == m and rw.get("per_sm"):
                key = (rw["variant"], rw["per_sm"])
                layer[key] = layer.get(key, 0.0) + rw["ms"]
        S.log(f"[sweep] per layer at M={m} under the policy (4 leaves summed):")
        for (variant, per_sm), ms in sorted(layer.items(), key=lambda kv: kv[1]):
            S.log(f"[sweep]     {ms:.4f} ms {variant}-row stages, {per_sm} blocks/SM")
        for what in ("f32 body", "library"):
            total = sum(rw["ms"] for rw in rows if rw["m"] == m and rw["variant"] == what)
            S.log(f"[sweep]     {total:.4f} ms {what}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
