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
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --backend codes
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --smoke --device cpu
    python -m repro_torch.launch.serve --arch paligemma-3b --backend codes
    python -m repro_torch.launch.serve --arch paligemma-3b --smoke --device cpu
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --layers 16 \
        --backend codes
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --smoke --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --layers 8 \
        --backend codes
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --smoke --device cpu
    python -m repro_torch.launch.serve --arch qwen3-1.7b --backend codes --mesh-model 2
    python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --backend codes \
        --mesh-model 4 --device cpu

``--layers`` cuts the depth and keeps every width: mixtral-8x22b's 56
layers (141 G weights) do not fit one 80 GB card; 2 layers take ~22 GB.
deepseek-v2-lite's 27 layers (15.7 G weights) fit as codes but leave no
room for a teacher and calibration; 3 layers (the dense first layer and
two MoE layers) take ~1.7 G weights. seamless-m4t-large-v2 (24 encoder
and 24 decoder layers, 1.63 G weights) fits whole; its requests carry
random encoder inputs of ``--prompt-len`` frames, drawn from a stream of
their own, as the reference's driver draws them.
paligemma-3b (18 layers, 1.98 G weights) fits whole; each of its
requests carries a random image of 256 patch embeddings, drawn from a
third stream.
falcon-mamba-7b's 64 layers (7.26 G weights) fit one card as codes, but
not beside a teacher, three sessions and calibration; 16 layers take
~2.2 G weights. Its engine admits each prompt by one exact-length fused
prefill (an SSM stack does not chunk).
recurrentgemma-9b's 38 layers (8.35 G weights) fit as codes but not beside
a teacher and calibration; 8 layers (two (rglru, rglru, local) groups and
the two epilogue rglru layers) take 1.78 G weights beside the 1.05 G tied
embedding. Its engine admits by one fused prefill too (a recurrent stack
does not chunk); the local layers keep a rolling window of 2048.

``--mesh-model N`` serves tensor-parallel: N ranks (spawned processes,
``launch.mesh.run_ranks``) on a (1, N) ("data", "model") mesh, each
holding its column block of every column-shardable leaf, all on the card
(``cuda:0`` over gloo when there is one card) or on the CPU with
``--device cpu``. Codes backend only; rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
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
    ap.add_argument("--mesh-model", type=int, default=0,
                    help="tensor-parallel degree: serve on a (1, N) ('data', 'model') "
                         "mesh of N ranks (codes backend only)")
    args = ap.parse_args(argv)
    if args.mesh_model > 1:
        if args.backend != "codes":
            raise SystemExit("--mesh-model serves the codes backend only")
        from repro_torch.launch.mesh import rank_device, run_ranks

        rank_device(args.device, 0)  # no card: raise here, before any rank starts
        outs = run_ranks(_serve, args.mesh_model, device=args.device, args=(args,))
        print(outs[0])
        return
    print(_serve(0, 1, args.device, args))


def _serve(rank, world, device, args) -> str:
    """Program, drift and serve (one rank of a mesh when ``world`` > 1);
    returns the report, which rank 0 of a mesh prints."""
    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.full
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = None
    if world > 1:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh((1, world), device=device)

    dep = deploy.Deployment.program(cfg, args.seed, backend=args.backend, device=device)
    if args.drift_hours > 0:
        dep.advance(args.drift_hours)
    session = dep.serve(mesh=mesh)
    lines = [session.describe()]
    if mesh is not None:
        lines.append(f"mesh {mesh.shape} over {world} ranks: {session.shard_stats}")

    g = make_generator("cpu", args.seed, 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=g)
    enc = None
    if cfg.encoder_layers:  # bf16 frames, kept in f32 numpy for the request's bytes
        g_enc = make_generator("cpu", args.seed, 2)
        enc = torch.randn((args.batch, args.prompt_len, cfg.d_model), generator=g_enc)
        enc = enc.to(torch.bfloat16).float().numpy()
    patches = None
    if cfg.vision_tokens:  # the vision tower's stub: bf16 patches, likewise
        g_patch = make_generator("cpu", args.seed, 3)
        patches = torch.randn((args.batch, cfg.vision_tokens, cfg.d_model), generator=g_patch)
        patches = patches.to(torch.bfloat16).float().numpy()
    toks, dt = session.generate(prompt, gen_len=args.gen, temperature=args.temperature,
                                enc_embeds=enc, patch_embeds=patches)
    # dt times exactly the decode ticks; first tokens come from prefill
    decode_toks = args.batch * max(args.gen - 1, 0)
    tps = decode_toks / dt if dt > 0 else float("nan")
    lines.append(f"backend={args.backend} generated {toks.shape} "
                 f"(decode: {decode_toks} tok in {dt:.2f}s = {tps:.1f} tok/s)")
    lines.append(np.array2string(toks[:2]))
    return "\n".join(lines)


if __name__ == "__main__":
    main()
