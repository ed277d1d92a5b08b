"""Batched serving driver over the port's deployment lifecycle. Port of
``repro/launch/serve.py`` with ``--device`` (default ``cuda``; a missing
card raises).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --backend codes \
        --drift-hours 24
    python -m repro_torch.launch.serve --arch qwen3-1.7b --backend codes_adc
    python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu
    python -m repro_torch.launch.serve --arch mixtral-8x22b --layers 2 \
        --backend codes --drift-hours 24
    python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v2-lite --layers 3 \
        --backend codes
    python -m repro_torch.launch.serve --arch deepseek-v2-lite --smoke --device cpu

``--layers`` cuts the depth and keeps every width: mixtral-8x22b's 56
layers (141 G weights) do not fit one 80 GB card; 2 layers take ~22 GB.
deepseek-v2-lite's 27 layers (15.7 G weights) fit as codes but leave no
room for a teacher and calibration; 3 layers (the dense first layer and
two MoE layers) take ~1.7 G weights.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import deploy
from repro_torch.configs import get_arch
from repro_torch.core.rram import make_generator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--drift-hours", type=float, default=0.0,
                    help="advance the drift clock this many hours before serving")
    ap.add_argument("--backend", default="dequant", choices=deploy.BACKENDS,
                    help="substrate execution backend (see repro_torch/substrate)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    args = ap.parse_args(argv)
    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.full
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    dep = deploy.Deployment.program(cfg, args.seed, backend=args.backend,
                                    device=args.device)
    if args.drift_hours > 0:
        dep.advance(args.drift_hours)
    session = dep.serve()
    print(session.describe())

    g = make_generator("cpu", args.seed, 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=g)
    toks, dt = session.generate(prompt, gen_len=args.gen,
                                temperature=args.temperature)
    # dt times exactly the decode ticks; first tokens come from prefill
    decode_toks = args.batch * max(args.gen - 1, 0)
    tps = decode_toks / dt if dt > 0 else float("nan")
    print(f"backend={args.backend} generated {toks.shape} "
          f"(decode: {decode_toks} tok in {dt:.2f}s = {tps:.1f} tok/s)")
    print(toks[:2])


if __name__ == "__main__":
    main()
