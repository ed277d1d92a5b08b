"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``): builds the
port's CUDA kernels from this checkout, holds each against its plain
PyTorch version on the card, times them, then serves qwen3-1.7b at full
width from resident RRAM codes three ways (f32 codes, int8 codes, the
ADC-faithful ``codes_adc`` backend) and checks that each serving path
went through its kernels; then it calibrates the drifted deployment's
DoRA side-cars (autograd under ``dequant``, no kernel) and serves the
calibrated side-cars through the kernels again, faults it, snapshots
it, restores it bitwise and serves the restored deployment
with the engine's shared prefix cache; then it runs the paper's own CNN
experiment (ResNet-20, drift, DoRA / LoRA / backprop calibration); last
it programs, drifts, calibrates and serves mixtral-8x22b (mixture of
experts, sliding window) at its full widths and 1 layer, then
deepseek-v2-lite (multi-head latent attention, a dense first layer,
shared experts) at its full widths and 3 layers.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (any failure exits non-zero; no failure is caught):
  1. card     — name and power limit (nvidia-smi), torch's device name;
  2. build    — nvcc for sm_90a, both sources at once, build seconds and
                the -Xptxas -v reports;
  3. kernels  — each kernel vs its plain version (``kernels/ref.py``):
                * the fused linear, both launchers, f32 body at rtol = atol
                  = 1e-4 and int8 body within 1e-4 of the output's absmax,
                  at the full-width fused leaves for every GEMV row bucket
                  M in {1, 2, 4, 8, 16, 32, 64} (decode ticks and the
                  engine's admission chunks), the tiled launcher at M=256,
                  ragged shapes; the int8 exactness case bitwise; the
                  GEMV's tensor-core bodies, f32 (bf16 x) and int8 (any x),
                  launched twice and bitwise equal at every bucket, and at
                  the edges of their K split; the int8 GEMV's exactness
                  cases bitwise where its plan splits K, its result bitwise
                  independent of the plan (``GEMV_INT8_PLANS``: parts of K,
                  row scales in the launch or a pass before it), two CUDA
                  graphs of it replayed at once on two streams bitwise equal
                  to eager; the f32 SIMT body (f32 x) and the int8 GEMV
                  with f32 x once per leaf;
                * the tiled launcher's tensor-core bodies, f32 (bf16 x)
                  and int8 (s8 x u8), at the full-width leaves for M in
                  {65, 96, 128, 200, 256, 512}, the ragged shapes with
                  M > 64 and shapes that hit every masked edge (K, N
                  ragged, M not a multiple of the tile), each launched
                  twice and the two results bitwise equal; the int8
                  exactness case where the plan splits K; the f32 body's
                  SIMT kernel (f32 x) once per leaf;
                * the narrow body (f32 x with the f32 body at N <= 64: the
                  MoE routers, either launcher, one split-K launch) at
                  rtol = atol = 1e-4 at mixtral-8x22b's router (K 6144, N
                  8) and deepseek-v2-lite's (K 2048, N 64) for M in {1, 2,
                  4, 8, 16, 32, 64, 96, 256} and ragged shapes (K 6100, N 7
                  and 60), x aligned and 4 bytes off: each call twice,
                  bitwise equal; each shape's calls from CUDA graphs
                  replayed at once on several streams, bitwise equal to
                  eager, the tickets zero after; bitwise equal under
                  several parts of K (``NARROW_PLANS``); one kernel a call
                  through both launchers (profiler);
                * the ADC kernel's tensor-core body (bf16 x) at the seven
                  unfused leaves for M in {1, 4, 32, 96, 256} and ragged
                  shapes: every output within rtol 1e-4 / atol 1e-6 or one
                  ADC step apart (at most 0.1% of them), each launched twice
                  and bitwise equal; the exactness case bitwise with f32 and
                  bf16 x; shapes whose plan splits K bitwise equal to
                  unsplit and other splits (``ADC_SPLITS``); CUDA-graph
                  replays bitwise equal to the eager result, two graphs
                  replayed at once on two streams; its SIMT body (f32 x,
                  N > 64) once per leaf;
                * the ADC kernel's narrow body (f32 x at N <= 64: the MoE
                  routers under codes_adc, one split-K launch) at the
                  narrow body's routers and rows (M up to 256: two 128-row
                  blocks) and ragged shapes, x aligned and 4 bytes off:
                  every output within rtol 1e-4 / atol 1e-6 or one ADC step
                  apart (at most 0.1%), each call twice, bitwise equal; each
                  shape's calls from CUDA graphs replayed at once on several
                  streams, bitwise equal to eager, the tickets zero after;
                  bitwise equal under several parts of K
                  (``ADC_NARROW_PLANS``); its exactness cases bitwise; one
                  kernel a call at M = 4 and 96 (profiler);
                * deepseek-v2-lite's up-projection of the whole latent
                  cache (phase 12's decode tick and chunks): the fused
                  _kup_vup (K 512, N 4096, rank 16) through both tiled
                  bodies at M = 512 and 128, k_up (K 512, N 2048) through
                  the ADC at M = 512, each against its plain version,
                  twice bitwise equal, and replayed from a CUDA graph
                  bitwise equal to the eager call;
  4. timing   — (the tiled f32 and int8 bodies also at M=96, the phase-5
                prefill; both GEMV bodies also at M = 8, 16, 64, the int8
                one also at M=1; the routers' f32-x launches: mixtral's
                through every body at M = 1, 4, 32, 96, deepseek-v2-lite's
                through the f32 body and the ADC at M = 4, 32; the ADC at
                M = 4, 32, 96, 256; deepseek-v2-lite's _kup_vup at M = 512
                through both tiled bodies and its k_up through the ADC;
                the time per kernel from torch.profiler
                of both tiled bodies at M = 96, 256, of both GEMV bodies at
                M = 4, 32 and of the ADC at M = 4, 256, per layer and per
                leaf against its bound)
                CUDA events around CUDA-graph replays over operand copies
                rotated past the L2: the kernel, the plain version, and one
                PyTorch call for the same work where there is one
                (``library_ms``; the port never calls it): torch.matmul of
                x by the pre-dequantized bf16 weight for f32, two
                torch._int_mm on pre-recoded s8 codes for int8 (where that
                call takes the shape), none for the ADC. Beside it the
                bound: bytes moved over 3.35 TB/s or operations over the
                dense rate for the types (989 TFLOP/s bf16, 1979 TOPS s8),
                whichever is larger (H100 SXM data sheet);
  5. serving  — Deployment.program(FULL, codes) -> advance(24), then three
                sessions over the same codes: serve() (f32), serve(accum=
                "int8"), and a codes_adc Deployment over the same teacher,
                codes and adapters. Each runs the same traffic through
                ServeEngine (ragged greedy requests, one chunked) and one
                fused prefill with B*S > 64, with the launch counters reset
                just before and read just after (asserted exactly; the
                engine's decode tick and admission chunks are the session's
                compiled steps, CUDA graphs whose replays count the launches
                their capture recorded); then codes vs dequant logits
                (prefill and one admission chunk per row bucket 8, 16, 32),
                int8 vs f32 logits (gated), and ADC vs f32 logits
                (reported: the fidelity of the ADC model); the fused
                prefill's wall time from CUDA events, per session. Per
                session also: ``compile_count`` (4: the decode tick, chunk
                buckets 8, 16, 32) flat over a second identical drive
                through the warm graphs, and a third drive with every step
                issued eagerly, both with the first drive's exact launches
                and streams; each graph's replay bitwise equal to its step
                run eagerly from a copy of the same cache (logits and
                cache); the decode tick captured vs eager (the same static
                inputs, alternated in one call), decode tok/s and TTFT
                captured vs eager; the memory the registry holds;
  6. trace    — torch.profiler over a few steady decode ticks of each
                session, through the graphs and then issued eagerly: device
                busy share, kernels and graph launches per tick, the largest
                kernels;
  7. calibrate — on phase 5's deployment (its sessions freed):
                dep.calibrate(10, steps=20) (10 samples x 32 tokens, lr
                1e-3) through its compiled step (step 1 eager, step 2
                captures one CUDA graph, the rest replay it) with the launch
                counters reset just before and read just after (every one
                0), one capture, the codes bitwise unchanged, every loss
                finite and the last below the first, the adapters without
                grad and apart from the step's static tensors, the graph
                released, memory allocated after the call back at the level
                before it plus the AdamW state it made; then the eager step
                functions (make_cached_calib_step) from the same start on
                the same stream: losses, adapters and AdamW state bitwise
                the graph's (else losses within CALIB_LOSS_RTOL, reported);
                the same for the fused step (cached_teacher=False, on a twin
                deployment over the same teacher and codes); the logit MSE
                drift gap recovered on the calibration batch and a held-out
                one (reported, not gated: random weights); teacher-feature
                seconds, step ms captured vs eager (step 1, step 2 with the
                capture, medians), calibrate seconds, peak memory;
                torch.profiler over two replays and two eager steps
                (kernels and graph launches per step, device busy); then
                serve() and serve(accum="int8") over phase 5's traffic with
                the calibrated side-cars, through the compiled steps with
                phase 5's per-session checks: exact launch counts, codes vs
                dequant logits (prefill and one chunk per bucket 8, 16, 32)
                within LOGITS_BOUND, int8 vs f32 within INT8_LOGITS_BOUND.
  8. faults   — on phase 7's calibrated deployment: the logit MSE on the
                calibration batch healthy, then inject the study's four
                classes at once, each default_spec(kind, seed + 1 + i) with
                a key of its own (inject seconds, the map's bytes, peak
                memory): the pristine codes bitwise unchanged, a re-injected
                spec leaves the view bitwise as it was, the card's view
                bitwise the CPU's from the same draws (each leaf's uniforms
                regenerated from its stream on the card and moved to the
                host; first and last layer of each stacked leaf), the
                saturation caps clamping cells the other classes left above
                the cap; the faulted logit MSE above the healthy one; then
                serve_checked (phase 5's per-session checks: exact launch
                counts, graph replays bitwise eager, compile_count 4 and
                flat, codes vs dequant within LOGITS_BOUND, int8 vs f32
                within INT8_LOGITS_BOUND, ADC vs f32 reported) over serve(),
                serve(accum="int8") and a codes_adc deployment given the
                same specs (its view bitwise dep.codes_view), the f32
                session's prepared tree bitwise prepare_base_for_serve(
                dep.codes, merged, cfg, faults=dep._fault_map), the captured
                tick beside phase 5's healthy one (reported); advance(300):
                every stuck cell still pinned while the pristine codes moved;
                calibrate(10, steps=20) on the faulted base: no launch, one
                capture, the faulted logit MSE reduced; last, with that
                deployment freed, fault_recovery_study at full width (10
                samples x 32 tokens, 20 steps) after 0, 24 and 300 h, with
                the weights' squared error against the teacher's, clean and
                faulted, per class: calibrated below faulted and faulted
                above clean exactly where the fault raised the weights'
                error, for every class and age; at 0 and 24 h faulted above
                clean for every class (the study runs after phase 9).
  9. persist  — on phase 8's deployment (programmed, 24 h, calibrated, four
                fault classes, 300 h, calibrated again): snapshot (seconds,
                bytes on disk beside 3 f32 trees of the adapter count),
                Deployment.restore on the card (seconds: program, drift
                replay, inject), bitwise the original in pristine codes,
                codes_view, adapters, AdamW state, step, drift history,
                fault specs and backend, its logit MSE on the calibration
                batch ==; refusals: a restore onto the CPU (before any work)
                and, with the original freed, a second snapshot whose codes
                digest is tampered with (after its replay); then the
                restored deployment through serve_faulted (phase 5's checks,
                all three bodies) and, on each body's warm session, prefix
                traffic (a 32-token shared prompt S and a 17-token P: S+8,
                S+8 again, S+17, P, P+23) through an engine with the prefix
                cache and one without it: counters, reused tokens, exact
                launch counts, compile_count 4 and flat, the full hit and
                the hit at 32 bitwise the cold admission (staged cache,
                admission logits, slot row after the run, tokens), the hit
                at 17 with equal tokens and logits within 1e-2 of their
                absmax (bitwise or not, reported; codes_adc admits P+23
                cold: it resumes only at chunk boundaries); TTFT with and without a
                hit, the cache's bytes, peak memory. Phase 5's engines see
                distinct random prompts, so they run the cache and never hit.
  10. paper  — the paper's own experiment (ResNet-20, 100 classes, 32x32,
                DoRA rank 2; ``core/resnet.py``, ``core/repro_experiments.py``)
                on the card with TF32 off: 2048 / 1024 procedural images, a
                teacher from ``train_teacher``'s defaults (12 epochs, batch
                128, lr 1e-3), then ``resnet_cell`` at drift 0.20 with 10
                calibration samples and 20 epochs at batch 1 for DoRA r=2,
                LoRA r=2 and backprop on that teacher. Gated: teacher above
                0.5, drifted at least 0.05 below it, each adapter cell's last
                loss below its first, DoRA calibrated above drifted, the
                teacher and the student (its RRAM leaves and every BN tensor)
                bitwise unchanged by DoRA and LoRA calibration, 200 backprop
                updates, no kernel launch over the phase (no TPU kernel lies
                on this path: the convs are cuDNN's), 14,162 / 279,792
                trainable, Table I at 41,666.67, 5e13 and 1250x, the card
                within 1e-4 of absmax of the port's CPU path on the same
                parameters (the forward's features and logits; the
                calibration loss and its gradients). Reported: the accuracies
                and recovered fraction per cell beside the reference's own
                (``examples/calibrate_resnet.py`` on a CPU), seconds of data, teacher
                training, each calibration and each evaluation, the median
                step, peak memory; torch.profiler over three DoRA steps
                (device busy share, kernels a step, the largest kernels).
  11. moe    — mixtral-8x22b at its published widths (d 6144, 48 / 8 KV
                heads of 128, 8 experts top-2 of d_ff 16384, window 4096,
                vocab 32768, untied head, DoRA rank 8), 1 of its 56 layers:
                Deployment.program(codes) -> advance(24) -> calibrate(10,
                steps=20) through its graph (no launch, one capture, the
                codes' digest unchanged, the loss falling, bitwise the eager
                step functions) -> serve(), serve(accum="int8") and a
                codes_adc deployment, each through phase 5's drive with 4
                greedy requests of 5, 40, 17 and 4160 tokens in a 4224-token
                cache (the long prompt in 130 chunks of 32 through the rolling
                canvas, its generation across position 4096): exact launch
                counts with the router's f32-x launches apart (``/f32x``),
                compile_count 3 (decode, chunks 8 and 32) and flat, every
                replay bitwise its eager step (logits and the rolling buffer,
                the decode tick at clocks across the wrap), codes vs dequant
                within LOGITS_BOUND, int8 vs f32 within INT8_LOGITS_BOUND;
                one layer's dispatch path against the dense oracle
                (capacity_factor = E / top_k) within MOE_ORACLE_BOUND; on a
                copy with capacity_factor = E / top_k, the long prompt's
                engine tokens the greedy tokens of a token-by-token
                decode_step loop (or, where they differ, at a near-tie of
                the loop's logits within LOGITS_BOUND of absmax) and its
                admission logits within LOGITS_BOUND. Reported: the
                tick captured vs eager and tok/s per session, the long
                prompt's TTFT, a profile of the captured tick by class
                (router, tensor-core GEMVs, expert products, expert
                read-back) and the read-back timed alone, calibrate seconds
                and step ms captured vs eager, peak and retained memory.
                Phase 3 holds the router's f32-x launches at N = 8 (every
                body, M in {1, 4, 32, 96}) against their plain versions and
                phase 4 times them; the f32 body's run the narrow body, the
                ADC's its narrow body.
  12. mla    — deepseek-v2-lite at its published widths (d 2048, 16 heads,
                MLA kv_lora 512, nope 128, rope 64, v 128; a dense first
                layer of d_ff 10944; 64 experts top-6 of d_ff 1408, 2
                shared, capacity 1.25; vocab 102400, untied head, DoRA rank
                8), 3 of its 27 layers (the dense layer, then a scan group
                stack of two MoE layers): phase 11's lifecycle and checks
                with phase 5's traffic (4 greedy requests of 5, 40, 17 and 9
                tokens in a 128-token cache, compile_count 4): exact launch
                counts (per decode tick 15 GEMV launches, 2 of them the
                routers', and 3 tiled ones, _kup_vup over the whole latent
                cache of 4 slots x 128; 27 ADC launches under codes_adc),
                every replay bitwise its eager step (the tiled launches
                inside the decode and chunk graphs included), codes vs
                dequant within LOGITS_BOUND, int8 vs f32 within
                INT8_LOGITS_BOUND, the dense oracle on the first MoE layer;
                on a copy with capacity_factor = E / top_k the 40-token
                prompt's chunked admission against the token-by-token loop
                (logits within LOGITS_BOUND, tokens equal or split at a
                near-tie). Reported as phase 11's, the tick by class with
                the tiled _kup_vup launches apart.
The last line is the contract line; the line before it the kernel table,
where ``dora_linear_narrow`` is the fused linear's narrow body: its
launches are the f32 body's f32-x launches of phases 5, 11 and 12 (the
routers'), which the rows of ``dora_linear_gemv`` and ``dora_linear`` do not
count, and its times are mixtral's router at the decode tick (M = 4);
``crossbar_mvm_narrow`` is the ADC's narrow body, likewise: its launches
are the ``crossbar_mvm`` f32-x launches of phases 5, 11 and 12, which the
``crossbar_mvm`` row does not count. The launches of ``dora_linear`` and
``dora_linear/int8`` include phase 12's tiled _kup_vup launches in every
decode tick and chunk.
Needs one CUDA card; without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# The inputs are bf16 x and u8 codes, and G+ - G- in [-255, 255] is exact
# in bf16, so the card's peak for the f32 body and the ADC is its dense
# bf16 tensor-core rate; for the int8 body (s8 x, s8-recodable codes) its
# dense int8 rate (data sheet). The kernels' SIMT arithmetic (67 TFLOP/s
# f32) is their own choice, not a limit of the card.
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
TOL = 1e-4                  # the reference's f32 kernel tolerance
# int8 body vs its plain version, relative to the output's absmax: the
# same row quantization and the same exact int32 sum; only the f32 orders
# of Xq @ A and of the epilogue differ
INT8_TOL = 1e-4
# ADC kernel vs its plain version: within rtol/atol, or (a tile current
# summed in another f32 order crossing an ADC rounding boundary) one step
# times the column scale apart, in at most this share of the outputs
ADC_RTOL, ADC_ATOL, ADC_FLIP_SHARE = 1e-4, 1e-6, 1e-3
# codes-vs-dequant prefill logits at full width, relative to their absmax:
# both run bf16 activations between layers, and bf16 rounding flips from
# the two f32 summation orders compound over 28 layers.
LOGITS_BOUND = 5e-2
# int8-vs-f32 codes logits, relative to their absmax: per-row s8
# quantization of every linear's input (a step of max|x| / 127, an error
# of ~1-2% of a row's RMS for activations whose max is 4-8 times their
# RMS) compounds through 28 layers of 7 linears; a broken body gives
# differences of the order of the logits themselves.
INT8_LOGITS_BOUND = 0.25

# qwen3-1.7b fused serve leaves: (name, K, N, fused rank)
LEAVES = [("qkv", 2048, 4096, 24), ("o", 2048, 2048, 8),
          ("gate_up", 2048, 12288, 16), ("down", 6144, 2048, 8)]
# its unfused leaves, what codes_adc runs: (name, K, N)
ADC_LEAVES = [("q", 2048, 2048), ("k", 2048, 1024), ("v", 2048, 1024),
              ("o", 2048, 2048), ("gate", 2048, 6144), ("up", 2048, 6144),
              ("down", 6144, 2048)]
# ragged M, K and N; M = 5, 9 and 17 fill part of the 8-, 16- and 32-row
# buckets with N a multiple of the vector width (vector code loads)
RAGGED = [(7, 1000, 999, 3), (65, 130, 77, 12), (1, 33, 4097, 1), (130, 257, 31, 5),
          (5, 300, 200, 4), (9, 96, 4096, 2), (17, 1000, 1024, 3)]
# ragged ADC shapes: K not a multiple of 256, M > 128 (two row blocks, one
# partial), N not a multiple of the 128-column tile or of 4
ADC_RAGGED = [(5, 300, 77), (130, 300, 65), (200, 1000, 999), (1, 33, 4097), (17, 257, 1024)]
# every GEMV row bucket: decode ticks (1-4 slots, up to 64) and the
# engine's admission chunks, padded to 8, 16 or 32 rows
DECODE_M = (1, 2, 4, 8, 16, 32, 64)
PREFILL_M = 256
ADC_M = (1, 4, 32, 96, 256)  # 96: phase 5's fused prefill (PREFILL_ROWS)
# the ADC kernel's plans at their edges (autotune.adc_plan): shapes whose
# plan splits K: a tile a part (K of 8 and 9 tiles), two (24 tiles),
# uneven parts with a ragged last tile (K = 300, 600, 1000), M over one
# 128-row block, N ragged; each checked against one part and other splits
ADC_SPLITS = [(4, 2048, 1024), (4, 6144, 2048), (32, 2304, 2048), (200, 1000, 999),
              (1, 300, 77), (96, 2048, 2048), (17, 600, 4097)]
# the tensor-core tiled bodies (f32 with bf16 x, int8): row counts around
# their 128-row tile (65 and 200 leave a partial tile), and shapes on every
# masked edge: K not a multiple of 8 (16 for s8) or of the 32- or 64-row
# stage, N not a multiple of 16 or of the 64-column tile, M not a multiple
# of the tile
TILED_M = (65, 96, 128, 200, 256, 512)
MASKED = [(96, 130, 77, 8), (200, 257, 31, 5), (150, 300, 999, 3), (65, 2048, 999, 8),
          (100, 257, 4096, 4), (130, 2048, 31, 2)]
# the tensor-core GEMV's K split at its edges (autotune.gemv_plan): one part
# shorter than a stage, a short last part, K not a multiple of 8, N ragged
# or not a multiple of the 128-column strip, M ragged in its bucket
GEMV_EDGES = [(4, 40, 4096, 8), (5, 1000, 2048, 8), (9, 2050, 999, 3), (17, 6144, 2049, 8),
              (33, 2048, 2064, 4), (64, 100, 300, 24), (1, 300, 130, 1)]
# the int8 GEMV's exactness cases: the decode tick's largest K and a full
# admission chunk, both with a plan that splits K, and two small shapes
GEMV_INT8_EXACT = ((4, 6144, 2048), (32, 2048, 4096), (4, 512, 256), (64, 512, 300))
# the int8 GEMV's plan at its edges, each shape run under several parts of
# K and with the row scales taken in the launch and in a pass before it
GEMV_INT8_PLANS = [(4, 2048, 4096, 24), (4, 6144, 2048, 8), (32, 2048, 2048, 8),
                   (64, 2048, 12288, 16), (17, 1000, 999, 3), (1, 300, 130, 1)]
SLOTS = 4                   # engine slots: the decode batch of phase 5
PREFILL_ROWS = 96           # phase 5's fused prefill: 3 x 32 tokens
PROMPT_LENS = (5, 40, 17, 9)  # phase 5's ragged engine requests
MAX_NEW = 16                # greedy tokens per request
ENGINE_MAX_LEN = 128        # phase 5's engine cache length
PREFILL_MAX_LEN = 48        # the fused prefill's and the single chunks' cache length
# the steps phase 5's traffic compiles per session: the decode tick and the
# admission chunk buckets 8 (5 and 40 - 32 tokens), 16 (9) and 32 (17, 40)
COMPILED_STEPS = 4
# timed row counts: a single stream, the phase-5 decode tick, a full
# 32-token admission chunk, phase 5's fused prefill and a larger one
TIMED_M = (1, SLOTS, 32, PREFILL_M)
TIMED_M_INT8 = (1, SLOTS, 8, 16, 32, 64, PREFILL_ROWS, PREFILL_M)  # every GEMV bucket too
TIMED_M_ADC = (SLOTS, 32, PREFILL_ROWS, PREFILL_M)
TIMED_M_TILED = (PREFILL_ROWS,)  # also timed for the tiled f32 body
TIMED_M_GEMV = (8, 16, 64)       # also timed for the f32 GEMV: chunk buckets, 64
# the MoE router of phase 11 (mixtral-8x22b): f32 x at K = 6144 and N = 8,
# one column per expert, narrower than one 128-column strip; DoRA rank 8.
# Its rows: a single stream, the decode tick, a full admission chunk, and
# the fused prefill (tiled)
ROUTER_K, ROUTER_N, ROUTER_R = 6144, 8, 8
ROUTER_M = (1, SLOTS, 32, PREFILL_ROWS)
# the narrow body (f32 x with the f32 body at N <= 64: every router of the
# zoo, either launcher): mixtral-8x22b's router and deepseek-v2-lite's (K
# 2048, N 64, rank 8) at every GEMV row bucket and the tiled rows; ragged:
# K 6100 (neither whole 128-row slabs nor 32-row stages), N 7 and 60, R 5;
# a tile's units past the block's threads (R 256) and one lane a unit (R
# 96); each also with x 4 bytes off a 16-byte boundary (masked loads)
NARROW_ROUTERS = (("router", ROUTER_K, ROUTER_N, ROUTER_R), ("router64", 2048, 64, 8))
NARROW_M = (1, 2, 4, 8, 16, 32, 64, PREFILL_ROWS, PREFILL_M)
NARROW_RAGGED = [(5, 6100, 7, 8), (33, 6100, 60, 8), (96, 6100, 7, 5), (256, 6100, 60, 8),
                 (33, 1000, 64, 256), (20, 700, 64, 96)]
# the narrow body's plans: shapes run under several parts of K, bitwise equal
NARROW_PLANS = [(1, 6144, 8, 8), (SLOTS, 6144, 8, 8), (PREFILL_ROWS, 6144, 8, 8),
                (32, 2048, 64, 8), (33, 6100, 60, 8)]
# deepseek-v2-lite's router rows also timed (phase 4)
ROUTER64_M = (SLOTS, 32)
# the ADC's narrow body (f32 x at N <= 64): the narrow body's routers at its
# rows (NARROW_M: up to 256, two 128-row blocks) and ragged shapes (its
# NARROW_RAGGED; R unused), x aligned and misaligned; its plans, shapes run
# under several parts of K (whole 256-row tiles), bitwise equal; its
# exactness cases (a partial last tile, two row blocks)
ADC_NARROW_PLANS = [(1, 6144, 8), (SLOTS, 6144, 8), (PREFILL_ROWS, 6144, 8), (PREFILL_M, 6144, 8),
                    (32, 2048, 64), (130, 2048, 64), (33, 6100, 60)]
ADC_NARROW_EXACT = [(SLOTS, 6144, 8), (130, 2048, 64), (PREFILL_M, 6100, 60)]
# f32 arithmetic outside the tensor cores (data sheet): the f32 body and
# the ADC multiply f32 x exactly
F32_FLOP_PER_S = 67e12
# phase 11: mixtral-8x22b at its published widths, the depth cut from 56
# layers to 1 (no scan group: the layer is the prologue, its expert leaves
# (8, d, ff) stacks); 4 greedy requests on 4 slots in a cache of 4224 >
# the 4096 window, so the cache rolls: the long prompt is admitted in 130
# chunks of 32 and its generation crosses position 4096
MOE_LAYERS = 1
MOE_MAX_LEN = 4224
MOE_PROMPT_LENS = (5, 40, 17, 4160)
# the steps phase 11's traffic compiles per session: the decode tick and
# the admission chunk buckets 8 (5, and 40 - 32) and 32 (17, 40, 4160)
MOE_COMPILED_STEPS = 3
# the decode graph's replay vs eager at clocks on both sides of the wrap
MOE_DECODE_POS = (4090, 4095, 4100, 4200)
# one layer's dispatch path vs the dense gate-weighted sum over all
# experts (capacity_factor = E / top_k: nothing dropped), of absmax:
# bf16 expert products at M = C rows vs M = 1 row (other cuBLAS tilings)
MOE_ORACLE_BOUND = 1e-2
MOE_ORACLE_TOKENS = 64
# phase 12: deepseek-v2-lite at its published widths, the depth cut from 27
# layers to 3: the dense first layer (the prologue) and a scan group stack
# of two MoE layers, so each expert leaf is a (2, 64, d, ff) stack; phase
# 5's traffic (4 slots, a 128-token cache), the decode tick's replay at
# clocks up to the cache's last position
MLA_LAYERS = 3
MLA_DECODE_POS = (40, 57, 90, ENGINE_MAX_LEN - 1)
# its fused up-projection _kup_vup (K kv_lora 512, N 16 heads x (128 + 128),
# fused rank 16), run over the whole latent cache every step: at the decode
# tick's rows (4 slots x 128) and a chunk's on the batch-1 staging cache
# (128); under codes_adc k_up and v_up unfused, each (K 512, N 2048)
KUP_VUP = ("kup_vup", 512, 4096, 16)
KUP_VUP_M = (SLOTS * ENGINE_MAX_LEN, ENGINE_MAX_LEN)
ADC_KUP = ("k_up", 512, 2048)
# phase 7: the paper's calibration set (10 samples of 32 tokens) and the
# reference's calibrate defaults (20 steps, lr 1e-3)
CALIB_SAMPLES, CALIB_SEQ, CALIB_STEPS = 10, 32, 20
# the compiled calibration step vs the eager step functions where they are
# not bitwise: per-step losses, relative (tests/test_torch_gpu.py's bound
# for calibration on the card vs the CPU)
CALIB_LOSS_RTOL = 1e-2
# phase 8: the study's four fault classes at their default severities,
# keyed as the study keys them (seed + 1), and the study's field hours
FAULT_HOURS = 300.0
STUDY_HOURS = (0.0, 24.0, FAULT_HOURS)
# phase 9: a 32-token shared prompt S (one chunk at the engine's 32-token
# chunks) and a 17-token prompt P: S+8 cold, S+8 again (a full hit), S+17
# (a partial hit at 32, a chunk boundary), P cold, P+23 (a partial hit at
# 17, off the boundary), each run to its end before the next
PREFIX_SHARED, PREFIX_OFF = 32, 17
PREFIX_TRAFFIC = (("S+8", "S", 8), ("S+8", "S", 8), ("S+17", "S", 17), ("P", "P", 0),
                  ("P+23", "P", 23))
PREFIX_HIT_TOKENS = [0, 40, 32, 0, 17]   # what each request reuses (codes_adc: 0 for P+23)
PREFIX_NEW = 8                           # greedy tokens per prefix request
# a partial hit off a chunk boundary vs cold admission: admission logits
# within this share of their absmax (other chunk widths: other GEMV K
# plans and cuBLAS choices); greedy tokens equal
OFF_BOUNDARY_BOUND = 1e-2
# phase 10: the paper's experiment at ResnetConfig() (ResNet-20, 100
# classes, DoRA rank 2) with run_cell's protocol: 2048 / 1024 procedural
# images, the teacher from train_teacher's defaults, drift 0.20, 10
# calibration samples, 20 epochs at batch 1; three cells
PAPER_DRIFT, PAPER_SAMPLES, PAPER_EPOCHS = 0.20, 10, 20
PAPER_METHODS = ("dora", "lora", "backprop")
PAPER_FRACTION = (14_162, 279_792)   # adapter / teacher elements, DoRA rank 2
# the card against the port's CPU path on the same parameters, of absmax:
# f32 on both (TF32 off), only the summation orders of cuDNN and the CPU
PAPER_CARD_VS_CPU = 1e-4
PAPER_PROBE_IMAGES = 8   # test images of the forward compared card vs CPU
# the reference's own at this config and seed 0, on a CPU: the teacher's
# and the drifted student's test accuracy that examples/calibrate_resnet.py
# prints (its run_cell trains the teacher and drifts it as phase 10 does)
PAPER_REFERENCE_ACC = {"teacher": 1.0, "drifted": 0.3759765625}


def log(*args):
    print(*args, flush=True)


def phase_card():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    """Build every CUDA source at once (one nvcc each, in threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import crossbar_mvm as C
    from repro_torch.kernels import dora_linear as K

    libs = (K.LIB, C.LIB)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.load) for lib in libs]:
            future.result()
    log(f"[build] {len(libs)} sources in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        info = lib.info
        log(f"[build] {os.path.relpath(info['path'], HERE)} compiled={info['compiled']} "
            f"in {info['seconds']:.2f} s")
        for line in str(info["log"]).strip().splitlines():
            log(f"[build] {line}")


def operands(m, k, n, r, device, seed=0):
    """Realistic operands: codes programmed from a normal weight, bf16 x,
    random non-zero A, B and gamma."""
    from repro_torch.core.rram import program

    g = torch.Generator(device=device).manual_seed(seed)
    xw = program(torch.randn((k, n), generator=g, device=device) * k ** -0.5)
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    a = (torch.rand((k, r), generator=g, device=device) * 2 - 1) * k ** -0.5
    b = torch.randn((r, n), generator=g, device=device) * 0.05
    gamma = torch.rand((1, n), generator=g, device=device) * 1.5 + 0.5
    return x, xw.g_pos, xw.g_neg, xw.scale, a, b, gamma


def exact_operands(m, k, n, device, seed, every=(1 << 30, 1 << 30)):
    """The exactness cases: integer-valued x in [-127, 127] with 127 in
    every (``every[0]``-row, ``every[1]``-column) block, random codes,
    scale = gamma = 1, A = B = 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=g, device=device).to(torch.float32)
    for r0 in range(0, m, every[0]):
        for c0 in range(0, k, every[1]):
            x[r0, c0] = 127.0
    gp, gn = (torch.randint(0, 256, (k, n), generator=g, device=device, dtype=torch.uint8)
              for _ in range(2))
    one = torch.ones((1, n), device=device)
    return x, gp, gn, one, torch.zeros((k, 1), device=device), torch.zeros((1, n), device=device), one


def adc_plans(m, k, n):
    """Parts of K of the ADC kernel for one shape: one (unsplit), the
    policy's, two, three, and every tile a part."""
    from repro_torch.kernels import autotune

    tiles = -(-k // autotune.ADC_ARRAY_ROWS)
    return sorted({1, autotune.adc_plan(m, k, n), min(tiles, 2), min(tiles, 3), tiles})


def graph_replays(calls, replays=5):
    """Kernel calls (closures), each captured in its own CUDA graph (with
    tickets of its own) after a warm-up on a side stream, replayed
    ``replays`` times at once on one stream each: whether every replay
    equals the eager result bitwise."""
    wants = [call() for call in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graphs, gots = [], []
    for call in calls:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            gots.append(call())
    streams = [torch.cuda.Stream() for _ in graphs]
    same = True
    for _ in range(replays):
        for stream, graph in zip(streams, graphs):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(got, want) for got, want in zip(gots, wants))
    return same


def adc_graph_replays(device):
    """``graph_replays`` of two ADC calls whose plans split K."""
    from repro_torch.kernels import crossbar_mvm as C

    leaves = [operands(SLOTS, 2048, 2048, 1, device, seed=5)[:4],
              operands(SLOTS, 6144, 2048, 1, device, seed=6)[:4]]
    return graph_replays([lambda o=o: C.crossbar_mvm(*o) for o in leaves])


def int8_gemv_graph_replays(device):
    """``graph_replays`` of two int8 GEMV calls at the decode tick whose
    plans split K, and whether every ticket is zero again after them."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import dora_linear as K

    leaves = [operands(SLOTS, 2048, 4096, 24, device, seed=5),
              operands(SLOTS, 6144, 2048, 8, device, seed=6)]
    assert all(autotune.gemv_plan(SLOTS, o[1].shape[1], o[1].shape[0], "int8") > 1
               for o in leaves)
    same = graph_replays([lambda o=o: K.dora_linear_gemv(*o, accum="int8") for o in leaves])
    return same and all(int(sem.abs().sum()) == 0 for _, sem in K._SEMS.values())


def int8_gemv_plans(m, k, n):
    """(parts, prescale) plans of the int8 GEMV for one shape: the policy's
    parts, one, two, three and one a stage, each with the row scales in the
    launch and in a pass before it."""
    from repro_torch.kernels import autotune

    stages = -(-k // autotune.GEMV_MMA_STAGE)
    parts = {1, autotune.gemv_plan(m, n, k, "int8"), min(stages, 2), min(stages, 3), stages}
    return [(p, pre) for p in sorted(parts) for pre in (False, True)]


def _fail(what, got):
    raise AssertionError(f"{what} disagrees with the plain version: {got}")


def _vs_plain(got, ops, accum):
    """(max |err|, ok, note) of a fused-linear result against its plain
    version: rtol = atol = TOL for the f32 body, within INT8_TOL of the
    output's absmax for the int8 body."""
    from repro_torch.kernels import ref

    if accum == "f32":
        want = ref.dora_linear_ref(*ops)
        err = float((got - want).abs().max())
        return err, bool(torch.allclose(got, want, rtol=TOL, atol=TOL)), ""
    want = ref.dora_linear_int8_ref(*ops)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    return err, rel <= INT8_TOL, f" ({rel:.2e} of absmax)"


def phase_kernels(device):
    """Each kernel vs its plain version; returns max |err| per entry of the
    kernel table."""
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import crossbar_mvm as C
    from repro_torch.kernels import dora_linear as K

    worst = {name: 0.0 for name in K.launch_counts()}
    worst["crossbar_mvm"] = worst["dora_linear_narrow"] = worst["crossbar_mvm_narrow"] = 0.0
    cases = [(m, k, n, r, name) for name, k, n, r in LEAVES for m in DECODE_M]
    cases += [(PREFILL_M, k, n, r, name) for name, k, n, r in LEAVES]
    cases += [(m, k, n, r, "ragged") for m, k, n, r in RAGGED]
    for m, k, n, r, name in cases:
        ops = operands(m, k, n, r, device, seed=m + n)
        launchers = [("dora_linear", K.dora_linear)]
        if autotune.use_gemv(m):
            launchers.insert(0, ("dora_linear_gemv", K.dora_linear_gemv))
        for kind, fn in launchers:
            for accum in autotune.ACCUMS:
                got = fn(*ops, accum=accum)
                torch.cuda.synchronize()
                err, ok, note = _vs_plain(got, ops, accum)
                if kind == "dora_linear_gemv":  # the tensor-core GEMVs, twice
                    same = torch.equal(got, fn(*ops, accum=accum))
                    ok = ok and same
                    note += f" repeat {'bitwise' if same else 'DIFFERS'}"
                key = K.counter(kind, accum)
                log(f"[kernels] {key:22s} {name:8s} M={m:4d} K={k:5d} N={n:5d} r={r:2d} "
                    f"max|err|={err:.3e}{note} {'ok' if ok else 'FAIL'}")
                if not ok:
                    _fail(f"{key} at {(m, k, n, r)}", f"max|err| {err}")
                worst[key] = max(worst[key], err)

    # int8 exactness: y = f32(int32 acc) * xs with the reference's xs,
    # bitwise; the tiled cases with M > 64 split K on the tensor cores
    exact = GEMV_INT8_EXACT + ((100, 300, 77), (256, 512, 2048), (130, 6144, 2048))
    assert any(m > autotune.GEMV_MAX_M and autotune.tiled_tiles(m, n, k, "int8").splits(k) > 1
               for m, k, n in exact)
    assert all(autotune.gemv_plan(m, n, k, "int8") > 1 for m, k, n in GEMV_INT8_EXACT[:2])
    for m, k, n in exact:
        ops = exact_operands(m, k, n, device, seed=m)
        want = ref.dora_linear_int8_ref(*ops)
        launchers = [("dora_linear", K.dora_linear)]
        if autotune.use_gemv(m):
            launchers.insert(0, ("dora_linear_gemv", K.dora_linear_gemv))
        for kind, fn in launchers:
            got = fn(*ops, accum="int8")
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            splits = (f" parts {autotune.gemv_plan(m, n, k, 'int8')}" if kind == "dora_linear_gemv"
                      else f" splits {autotune.tiled_tiles(m, n, k, 'int8').splits(k)}")
            log(f"[kernels] {K.counter(kind, 'int8'):22s} exact    M={m:4d} K={k:5d} N={n:5d}"
                f"{splits} bitwise {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"int8 exactness case {kind} at {(m, k, n)}",
                      f"max|err| {float((got - want).abs().max())}")

    # both tensor-core tiled bodies: bf16 x, twice each (bitwise repeatable)
    mma = [(m, k, n, r, name) for name, k, n, r in LEAVES for m in TILED_M]
    mma += [(m, k, n, r, "ragged") for m, k, n, r in RAGGED if m > autotune.GEMV_MAX_M]
    mma += [(m, k, n, r, "masked") for m, k, n, r in MASKED]
    for m, k, n, r, name in mma:
        ops = operands(m, k, n, r, device, seed=m + k + n)
        for accum in autotune.ACCUMS:
            got, again = K.dora_linear(*ops, accum=accum), K.dora_linear(*ops, accum=accum)
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            err, ok, note = _vs_plain(got, ops, accum)
            ok = ok and same
            plan = autotune.tiled_tiles(m, n, k, accum)
            key = K.counter("dora_linear", accum)
            log(f"[kernels] {key + ' mma':22s} {name:8s} M={m:4d} K={k:5d} N={n:5d} r={r:2d} "
                f"tile {plan.bm}x{autotune.MMA_TILE_N} splits {plan.splits(k)} "
                f"max|err|={err:.3e}{note} "
                f"repeat {'bitwise' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"{key} (tensor cores) at {(m, k, n, r)}",
                      f"max|err| {err}, repeat bitwise {same}")
            worst[key] = max(worst[key], err)
    # the tensor-core GEMVs where their K split leaves a short or a single
    # part, K or N is ragged: twice each, bitwise repeatable
    for m, k, n, r in GEMV_EDGES:
        ops = operands(m, k, n, r, device, seed=k + n)
        for accum in autotune.ACCUMS:
            got = K.dora_linear_gemv(*ops, accum=accum)
            again = K.dora_linear_gemv(*ops, accum=accum)
            torch.cuda.synchronize()
            err, ok, note = _vs_plain(got, ops, accum)
            same = torch.equal(got, again)
            ok = ok and same
            key = K.counter("dora_linear_gemv", accum)
            log(f"[kernels] {key + ' mma':22s} edge     M={m:4d} K={k:5d} N={n:5d} r={r:2d} "
                f"parts {autotune.gemv_plan(m, n, k, accum)} max|err|={err:.3e}{note} "
                f"repeat {'bitwise' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"{key} (tensor cores) at {(m, k, n, r)}",
                      f"max|err| {err}, repeat bitwise {same}")
            worst[key] = max(worst[key], err)

    # the int8 GEMV's result does not depend on its plan: parts of K, and
    # row scales in the launch or in a pass before it
    for m, k, n, r in GEMV_INT8_PLANS:
        ops = operands(m, k, n, r, device, seed=m + k)
        policy = (autotune.gemv_plan, autotune.gemv_int8_prescale)
        got = {}
        try:
            for parts, pre in int8_gemv_plans(m, k, n):
                autotune.gemv_plan = lambda *_, p=parts: p
                autotune.gemv_int8_prescale = lambda *_, q=pre: q
                got[(parts, pre)] = K.dora_linear_gemv(*ops, accum="int8")
        finally:
            autotune.gemv_plan, autotune.gemv_int8_prescale = policy
        torch.cuda.synchronize()
        base = got[(1, False)]
        same = all(torch.equal(base, y) for y in got.values())
        err, ok, note = _vs_plain(base, ops, "int8")
        ok = ok and same
        log(f"[kernels] dora_linear_gemv/int8  plans    M={m:4d} K={k:5d} N={n:5d} r={r:2d} "
            f"parts {sorted({p for p, _ in got})} (policy {autotune.gemv_plan(m, n, k, 'int8')}) "
            f"x row scales in the launch and before it{note} "
            f"{'bitwise equal' if same else 'DIFFER'} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"dora_linear_gemv/int8 plans at {(m, k, n, r)}", f"bitwise {same}, {note}")

    # CUDA graphs of the int8 GEMV: each replay bitwise equal to the eager
    # call; two graphs replayed at once on two streams
    same = int8_gemv_graph_replays(device)
    log(f"[kernels] dora_linear_gemv/int8  graphs   two captures on two streams, 5 replays "
        f"{'bitwise equal to eager, tickets zero' if same else 'DIFFER'} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        _fail("dora_linear_gemv/int8 graph replay", "differs from the eager result")

    # f32 x, once per leaf: the SIMT bodies of the f32 body, and the int8
    # GEMV (its tensor-core body takes either x)
    for name, k, n, r in LEAVES:
        for kind, accum, m in (("dora_linear", "f32", PREFILL_M),
                               ("dora_linear_gemv", "f32", SLOTS),
                               ("dora_linear_gemv", "int8", SLOTS)):
            x, *rest = operands(m, k, n, r, device, seed=k + n)
            ops = (x.float(), *rest)
            got = getattr(K, kind)(*ops, accum=accum)
            torch.cuda.synchronize()
            err, ok, note = _vs_plain(got, ops, accum)
            key = K.counter(kind, accum)
            log(f"[kernels] {key + ' f32 x':22s} {name:8s} M={m:4d} K={k:5d} N={n:5d} "
                f"r={r:2d} max|err|={err:.3e}{note} {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"{key} (f32 x) at {(m, k, n, r)}", f"max|err| {err}")
            worst[key] = max(worst[key], err)

    # the ADC kernel's tensor-core body (bf16 x), twice each (bitwise repeatable)
    adc_cases = [(m, k, n, name) for name, k, n in ADC_LEAVES for m in ADC_M]
    adc_cases += [(m, k, n, "ragged") for m, k, n in ADC_RAGGED]
    for m, k, n, name in adc_cases:
        x, gp, gn, scale, *_ = operands(m, k, n, 1, device, seed=m + k + n)
        want = ref.crossbar_mvm_ref(x, gp, gn, scale)
        got, again = C.crossbar_mvm(x, gp, gn, scale), C.crossbar_mvm(x, gp, gn, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        bad, flips = ref.adc_disagreement(got, want, x, scale, rtol=ADC_RTOL, atol=ADC_ATOL)
        same = torch.equal(got, again)
        ok = bad == 0 and flips <= ADC_FLIP_SHARE * got.numel() and same
        log(f"[kernels] crossbar_mvm           {name:8s} M={m:4d} K={k:5d} N={n:5d} "
            f"parts {autotune.adc_plan(m, k, n)} max|err|={err:.3e} one-step flips "
            f"{flips}/{got.numel()} repeat {'bitwise' if same else 'DIFFERS'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"crossbar_mvm at {(m, k, n)}",
                  f"{bad} outputs off, {flips} flips, repeat bitwise {same}")
        worst["crossbar_mvm"] = max(worst["crossbar_mvm"], err)

    # ADC exactness: 127 in every (128-row, 256-row) block, so step = 4080
    # and every current is an exact integer below 2^24; f32 x (SIMT body)
    # and the same x in bf16 (exact: integers in [-127, 127])
    for m, k, n in ((4, 2048, 512), (130, 300, 65), (96, 2048, 1024), (256, 6144, 300)):
        x, gp, gn, one, *_ = exact_operands(
            m, k, n, device, seed=k, every=(autotune.ADC_BLOCK_ROWS, autotune.ADC_ARRAY_ROWS))
        assert torch.all(ref.adc_steps(x) == 4080.0)
        for xd in (x, x.to(torch.bfloat16)):
            want = ref.crossbar_mvm_ref(xd, gp, gn, one)
            got = C.crossbar_mvm(xd, gp, gn, one)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            log(f"[kernels] crossbar_mvm           exact    M={m:4d} K={k:5d} N={n:5d} "
                f"x {str(xd.dtype)[6:]} bitwise {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"ADC exactness case at {(m, k, n)}, x {xd.dtype}",
                      f"max|err| {float((got - want).abs().max())}")

    # the result does not depend on the plan: the splits of K
    for m, k, n in ADC_SPLITS:
        x, gp, gn, scale, *_ = operands(m, k, n, 1, device, seed=k + n)
        policy, got = autotune.adc_plan, {}
        assert policy(m, k, n) > 1, (m, k, n)
        try:
            for parts in adc_plans(m, k, n):
                autotune.adc_plan = lambda *_, p=parts: p
                got[parts] = C.crossbar_mvm(x, gp, gn, scale)
        finally:
            autotune.adc_plan = policy
        torch.cuda.synchronize()
        base = got[1]
        same = all(torch.equal(base, y) for y in got.values())
        bad, flips = ref.adc_disagreement(base, ref.crossbar_mvm_ref(x, gp, gn, scale), x,
                                          scale, rtol=ADC_RTOL, atol=ADC_ATOL)
        ok = same and bad == 0 and flips <= ADC_FLIP_SHARE * base.numel()
        log(f"[kernels] crossbar_mvm           split    M={m:4d} K={k:5d} N={n:5d} "
            f"parts {sorted(got)} (policy {policy(m, k, n)}) "
            f"{'bitwise equal' if same else 'DIFFER'} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"crossbar_mvm plans at {(m, k, n)}", f"bitwise {same}, {bad} off, {flips} flips")

    # CUDA graphs: each replay bitwise equal to the eager call; two graphs
    # replayed at once on two streams
    same = adc_graph_replays(device)
    log(f"[kernels] crossbar_mvm           graphs   two captures on two streams, 5 replays "
        f"{'bitwise equal to eager' if same else 'DIFFER'} {'ok' if same else 'FAIL'}")
    if not same:
        _fail("crossbar_mvm graph replay", "differs from the eager result")

    # the SIMT body, which f32 x keeps above 64 columns, once per leaf
    for name, k, n in ADC_LEAVES:
        x, gp, gn, scale, *_ = operands(SLOTS, k, n, 1, device, seed=k + n)
        x = x.float()
        got = C.crossbar_mvm(x, gp, gn, scale)
        torch.cuda.synchronize()
        want = ref.crossbar_mvm_ref(x, gp, gn, scale)
        err = float((got - want).abs().max())
        bad, flips = ref.adc_disagreement(got, want, x, scale, rtol=ADC_RTOL, atol=ADC_ATOL)
        ok = bad == 0 and flips <= ADC_FLIP_SHARE * got.numel()
        log(f"[kernels] crossbar_mvm f32 x     {name:8s} M={SLOTS:4d} K={k:5d} N={n:5d} "
            f"max|err|={err:.3e} one-step flips {flips}/{got.numel()} {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"crossbar_mvm (f32 x, SIMT) at {(SLOTS, k, n)}", f"{bad} off, {flips} flips")
        worst["crossbar_mvm"] = max(worst["crossbar_mvm"], err)

    # the MoE router's launches (phase 11): f32 x at N = 8, every body
    for m in ROUTER_M:
        ops = router_operands(m, device, seed=m + 7)
        kind = "dora_linear_gemv" if autotune.use_gemv(m) else "dora_linear"
        for accum in autotune.ACCUMS:
            got = getattr(K, kind)(*ops, accum=accum)
            torch.cuda.synchronize()
            err, ok, note = _vs_plain(got, ops, accum)
            key = K.counter(kind, accum)
            log(f"[kernels] {key + ' f32 x':22s} router   M={m:4d} K={ROUTER_K:5d} "
                f"N={ROUTER_N:5d} r={ROUTER_R:2d} max|err|={err:.3e}{note} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"{key} (f32 x, router) at {(m, ROUTER_K, ROUTER_N)}", f"max|err| {err}")
            # the f32 body runs the narrow body here (N <= 64)
            key = "dora_linear_narrow" if accum == "f32" else key
            worst[key] = max(worst[key], err)
        x, gp, gn, scale = ops[:4]
        got = C.crossbar_mvm(x, gp, gn, scale)
        torch.cuda.synchronize()
        want = ref.crossbar_mvm_ref(x, gp, gn, scale)
        err = float((got - want).abs().max())
        bad, flips = ref.adc_disagreement(got, want, x, scale, rtol=ADC_RTOL, atol=ADC_ATOL)
        ok = bad == 0 and flips <= ADC_FLIP_SHARE * got.numel()
        log(f"[kernels] crossbar_mvm_narrow    router   M={m:4d} K={ROUTER_K:5d} "
            f"N={ROUTER_N:5d} max|err|={err:.3e} one-step flips {flips}/{got.numel()} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"crossbar_mvm (f32 x, router) at {(m, ROUTER_K, ROUTER_N)}",
                  f"{bad} off, {flips} flips")
        worst["crossbar_mvm_narrow"] = max(worst["crossbar_mvm_narrow"], err)
    narrow_checks(device, worst)
    adc_narrow_checks(device, worst)
    kup_vup_checks(device, worst)
    return worst


def kup_vup_checks(device, worst):
    """deepseek-v2-lite's up-projection of the whole latent cache (phase
    12): the fused ``_kup_vup`` through both tiled bodies at ``KUP_VUP_M``
    rows and ``k_up`` through the ADC at the decode tick's, each against
    its plain version, launched twice bitwise equal, and from a CUDA graph
    (captured as the decode graphs capture it) replayed bitwise equal to
    the eager call."""
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import crossbar_mvm as C
    from repro_torch.kernels import dora_linear as K

    name, k, n, r = KUP_VUP
    for m in KUP_VUP_M:
        ops = operands(m, k, n, r, device, seed=m + 11)
        for accum in autotune.ACCUMS:
            got, again = K.dora_linear(*ops, accum=accum), K.dora_linear(*ops, accum=accum)
            torch.cuda.synchronize()
            err, ok, note = _vs_plain(got, ops, accum)
            same = torch.equal(got, again)
            replays = graph_replays([lambda a=accum: K.dora_linear(*ops, accum=a)])
            ok = ok and same and replays
            key = K.counter("dora_linear", accum)
            log(f"[kernels] {key + ' mma':22s} {name:8s} M={m:4d} K={k:5d} N={n:5d} r={r:2d} "
                f"splits {autotune.tiled_tiles(m, n, k, accum).splits(k)} max|err|={err:.3e}"
                f"{note} repeat {'bitwise' if same else 'DIFFERS'}, graph replays "
                f"{'bitwise eager' if replays else 'DIFFER'} {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"{key} (tensor cores) at {(m, k, n, r)}",
                      f"max|err| {err}, repeat bitwise {same}, replays bitwise {replays}")
            worst[key] = max(worst[key], err)
    name, k, n = ADC_KUP
    m = KUP_VUP_M[0]
    x, gp, gn, scale, *_ = operands(m, k, n, 1, device, seed=m + k)
    want = ref.crossbar_mvm_ref(x, gp, gn, scale)
    got, again = C.crossbar_mvm(x, gp, gn, scale), C.crossbar_mvm(x, gp, gn, scale)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bad, flips = ref.adc_disagreement(got, want, x, scale, rtol=ADC_RTOL, atol=ADC_ATOL)
    same = torch.equal(got, again)
    replays = graph_replays([lambda: C.crossbar_mvm(x, gp, gn, scale)])
    ok = bad == 0 and flips <= ADC_FLIP_SHARE * got.numel() and same and replays
    log(f"[kernels] crossbar_mvm           {name:8s} M={m:4d} K={k:5d} N={n:5d} "
        f"parts {autotune.adc_plan(m, k, n)} max|err|={err:.3e} one-step flips "
        f"{flips}/{got.numel()} repeat {'bitwise' if same else 'DIFFERS'}, graph replays "
        f"{'bitwise eager' if replays else 'DIFFER'} {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"crossbar_mvm at {(m, k, n)}",
              f"{bad} off, {flips} flips, repeat bitwise {same}, replays bitwise {replays}")
    worst["crossbar_mvm"] = max(worst["crossbar_mvm"], err)


def router_operands(m, device, seed=0, shape=(ROUTER_K, ROUTER_N, ROUTER_R)):
    """A router's operands: f32 x (M, K), codes (K, N), rank R; mixtral's
    (6144, 8, 8) by default."""
    x, *rest = operands(m, *shape, device, seed=seed)
    return (x.float(), *rest)


def misaligned(ops):
    """``ops`` with x moved 4 bytes off a 16-byte boundary: a contiguous
    view at storage offset 1."""
    x = ops[0]
    moved = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    moved.copy_(x)
    assert moved.data_ptr() % 16 != 0 and moved.is_contiguous()
    return (moved, *ops[1:])


def profiled_kernels(fn, calls=3, window_s=0.02):
    """[(kernel, device ms)] of one call ``fn()``, in launch order
    (torch.profiler, after a warm-up call), or None where the profiler
    recorded no whole call. Deep in a long process the profiler has been
    seen to start late, missing the first kernels of a window or all of
    them (PERF.md §6); so one window runs calls for ``window_s`` seconds
    (at least ``calls`` of them), each between two marker kernels (int16
    fills), synchronized, and the kernels read are those between the last
    two markers it recorded."""
    import re

    from torch.profiler import ProfilerActivity, profile

    mark = torch.empty(1, dtype=torch.int16, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, done = time.perf_counter(), 0
        while done < calls or time.perf_counter() - t0 < window_s:
            mark.fill_(7)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            done += 1
        mark.fill_(7)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "FillFunctor<short>" in e.name]
    if len(marks) < 2:
        return None
    call = events[marks[-2] + 1:marks[-1]]
    names = [re.search(r"(\w+_kernel)", e.name) for e in call]
    return [(n.group(1) if n else "?", e.device_time_total / 1e3) for n, e in zip(names, call)]


def kernel_ms(fn):
    """{kernel: device ms} of one call ``fn()`` (``profiled_kernels``), or
    None where the profiler records nothing."""
    by = {}
    for name, ms in profiled_kernels(fn) or ():
        by[name] = by.get(name, 0.0) + ms
    return by or None


def launched_kernels(fn, ops):
    """Names of the kernels one call ``fn(*ops)`` launches
    (``profiled_kernels``), or None where the profiler records nothing."""
    kernels = profiled_kernels(lambda: fn(*ops))
    return None if kernels is None else [name for name, _ in kernels]


def narrow_checks(device, worst):
    """The narrow body (f32 x, f32 body, N <= 64) vs its plain version at
    rtol = atol = TOL through each launcher that takes the rows, at
    ``NARROW_ROUTERS`` x ``NARROW_M`` and ``NARROW_RAGGED``, x aligned and
    misaligned: each call twice, bitwise equal; each shape's calls from CUDA
    graphs replayed at once on several streams, bitwise equal to eager, and
    the tickets zero afterwards; ``NARROW_PLANS`` bitwise equal under
    several parts of K; one kernel a call through both launchers
    (profiler)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import dora_linear as K

    cases = [(m, k, n, r, name) for name, k, n, r in NARROW_ROUTERS for m in NARROW_M]
    cases += [(m, k, n, r, "ragged") for m, k, n, r in NARROW_RAGGED]
    for m, k, n, r, name in cases:
        base = router_operands(m, device, seed=m + k + n, shape=(k, n, r))
        calls = []
        K._SEMS.clear()  # only this shape's tickets are checked below
        for shift, ops in (("", base), (" misaligned x", misaligned(base))):
            kinds = ["dora_linear_gemv", "dora_linear"] if autotune.use_gemv(m) else ["dora_linear"]
            for kind in kinds:
                fn = getattr(K, kind)
                got, again = fn(*ops), fn(*ops)
                torch.cuda.synchronize()
                err, ok, _ = _vs_plain(got, ops, "f32")
                same = torch.equal(got, again)
                ok = ok and same
                log(f"[kernels] {'narrow ' + kind:22s} {name:8s} M={m:4d} K={k:5d} N={n:5d} "
                    f"r={r:2d}{shift} parts {autotune.narrow_plan(m, n, k)} max|err|={err:.3e} "
                    f"repeat {'bitwise' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
                if not ok:
                    _fail(f"narrow body via {kind}{shift} at {(m, k, n, r)}",
                          f"max|err| {err}, repeat bitwise {same}")
                worst["dora_linear_narrow"] = max(worst["dora_linear_narrow"], err)
                calls.append(lambda fn=fn, ops=ops: fn(*ops))
        same = graph_replays(calls)
        zero = all(int(sem.abs().sum()) == 0 for _, sem in K._SEMS.values())
        log(f"[kernels] narrow graphs          {name:8s} M={m:4d} K={k:5d} N={n:5d} "
            f"{len(calls)} captures on {len(calls)} streams, 5 replays "
            f"{'bitwise equal to eager' if same else 'DIFFER'}, tickets "
            f"{'zero' if zero else 'NOT ZERO'} {'ok' if same and zero else 'FAIL'}")
        if not (same and zero):
            _fail(f"narrow body graphs at {(m, k, n, r)}", f"bitwise {same}, tickets zero {zero}")

    # the result does not depend on the plan: the parts of K
    for m, k, n, r in NARROW_PLANS:
        ops = router_operands(m, device, seed=k + n, shape=(k, n, r))
        slabs = -(-k // autotune.MIN_SPLIT_ROWS)
        policy, got = autotune.narrow_plan, {}
        try:
            for parts in sorted({1, 2, 3, policy(m, n, k), slabs}):
                autotune.narrow_plan = lambda *_, p=parts: p
                got[parts] = K.dora_linear(*ops)
        finally:
            autotune.narrow_plan = policy
        torch.cuda.synchronize()
        same = all(torch.equal(got[1], y) for y in got.values())
        log(f"[kernels] narrow plans           M={m:4d} K={k:5d} N={n:5d} parts {sorted(got)} "
            f"(policy {policy(m, n, k)}) {'bitwise equal' if same else 'DIFFER'} "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            _fail(f"narrow body plans at {(m, k, n, r)}", "the parts of K change the result")

    # one kernel a call, no prologue, through both launchers
    for kind, m in (("dora_linear_gemv", SLOTS), ("dora_linear", PREFILL_ROWS)):
        names = launched_kernels(getattr(K, kind), router_operands(m, device, seed=1))
        if names is None:
            log(f"[kernels] narrow {kind} M={m}: the profiler recorded no device activity: "
                "not measured")
            continue
        ok = names == ["dora_narrow_kernel"]
        log(f"[kernels] narrow {kind} M={m} router: kernels of one call {names} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"narrow body via {kind} at M={m}", f"launched {names}")


def adc_narrow_checks(device, worst):
    """The ADC's narrow body (f32 x, N <= 64) vs its plain version (every
    output within ADC_RTOL / ADC_ATOL or one ADC step apart, at most
    ADC_FLIP_SHARE of them) at ``NARROW_ROUTERS`` x ``NARROW_M`` and
    ``NARROW_RAGGED``, x aligned and misaligned: each call twice, bitwise
    equal; each shape's calls from CUDA graphs replayed at once on several
    streams, bitwise equal to eager, and the tickets zero afterwards;
    ``ADC_NARROW_PLANS`` bitwise equal under several parts of K;
    ``ADC_NARROW_EXACT`` bitwise; one kernel a call at M = 4 and 96
    (profiler)."""
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import crossbar_mvm as C

    cases = [(m, k, n, name) for name, k, n, _ in NARROW_ROUTERS for m in NARROW_M]
    cases += [(m, k, n, "ragged") for m, k, n, _ in NARROW_RAGGED]
    for m, k, n, name in cases:
        base = router_operands(m, device, seed=m + k + n, shape=(k, n, 1))[:4]
        calls = []
        C._SEMS.clear()  # only this shape's tickets are checked below
        for shift, ops in (("", base), (" misaligned x", misaligned(base))):
            got, again = C.crossbar_mvm(*ops), C.crossbar_mvm(*ops)
            torch.cuda.synchronize()
            want = ref.crossbar_mvm_ref(*ops)
            err = float((got - want).abs().max())
            bad, flips = ref.adc_disagreement(got, want, ops[0], ops[3], rtol=ADC_RTOL,
                                              atol=ADC_ATOL)
            same = torch.equal(got, again)
            ok = bad == 0 and flips <= ADC_FLIP_SHARE * got.numel() and same
            log(f"[kernels] crossbar_mvm_narrow    {name:8s} M={m:4d} K={k:5d} N={n:5d}{shift} "
                f"parts {autotune.adc_narrow_plan(m, k, n)} max|err|={err:.3e} one-step flips "
                f"{flips}/{got.numel()} repeat {'bitwise' if same else 'DIFFERS'} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"ADC narrow body{shift} at {(m, k, n)}",
                      f"{bad} off, {flips} flips, repeat bitwise {same}")
            worst["crossbar_mvm_narrow"] = max(worst["crossbar_mvm_narrow"], err)
            calls.append(lambda ops=ops: C.crossbar_mvm(*ops))
        same = graph_replays(calls)
        zero = all(int(sem.abs().sum()) == 0 for _, sem in C._SEMS.values())
        log(f"[kernels] crossbar_mvm_narrow    graphs {name:8s} M={m:4d} K={k:5d} N={n:5d} "
            f"{len(calls)} captures on {len(calls)} streams, 5 replays "
            f"{'bitwise equal to eager' if same else 'DIFFER'}, tickets "
            f"{'zero' if zero else 'NOT ZERO'} {'ok' if same and zero else 'FAIL'}")
        if not (same and zero):
            _fail(f"ADC narrow body graphs at {(m, k, n)}", f"bitwise {same}, tickets zero {zero}")

    # the result does not depend on the plan: the parts of K
    for m, k, n in ADC_NARROW_PLANS:
        ops = router_operands(m, device, seed=k + n, shape=(k, n, 1))[:4]
        tiles = -(-k // autotune.ADC_ARRAY_ROWS)
        policy, got = autotune.adc_narrow_plan, {}
        try:
            for parts in sorted({1, 2, 3, policy(m, k, n), tiles}):
                autotune.adc_narrow_plan = lambda *_, p=parts: p
                got[parts] = C.crossbar_mvm(*ops)
        finally:
            autotune.adc_narrow_plan = policy
        torch.cuda.synchronize()
        same = all(torch.equal(got[1], y) for y in got.values())
        log(f"[kernels] crossbar_mvm_narrow    plans  M={m:4d} K={k:5d} N={n:5d} parts "
            f"{sorted(got)} (policy {policy(m, k, n)}) {'bitwise equal' if same else 'DIFFER'} "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            _fail(f"ADC narrow body plans at {(m, k, n)}", "the parts of K change the result")

    # exactness: 127 in every (128-row, 256-row) block, so step = 4080 and
    # every current is an exact integer below 2^24
    for m, k, n in ADC_NARROW_EXACT:
        x, gp, gn, one, *_ = exact_operands(
            m, k, n, device, seed=k, every=(autotune.ADC_BLOCK_ROWS, autotune.ADC_ARRAY_ROWS))
        assert torch.all(ref.adc_steps(x) == 4080.0)
        ok = torch.equal(C.crossbar_mvm(x, gp, gn, one), ref.crossbar_mvm_ref(x, gp, gn, one))
        log(f"[kernels] crossbar_mvm_narrow    exact  M={m:4d} K={k:5d} N={n:5d} bitwise "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"ADC narrow body exactness case at {(m, k, n)}", "not bitwise")

    # one kernel a call: no step prologue, no sum pass
    for m in (SLOTS, PREFILL_ROWS):
        names = launched_kernels(C.crossbar_mvm, router_operands(m, device, seed=1)[:4])
        if names is None:
            log(f"[kernels] crossbar_mvm_narrow    M={m}: the profiler recorded no device "
                "activity: not measured")
            continue
        ok = names == ["adc_narrow_kernel"]
        log(f"[kernels] crossbar_mvm_narrow    M={m} router: kernels of one call {names} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"ADC narrow body at M={m}", f"launched {names}")


def bound(nbytes, ops, rate):
    """(bound_ms, bound_by): ``nbytes`` over the HBM rate against ``ops``
    at ``rate``, whichever takes longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def linear_bound(m, k, n, r, rate):
    """The fused linear: bf16 x, both code arrays, the f32 side operands
    and the f32 output, each moved once."""
    nbytes = 2 * k * n + 2 * m * k + 4 * (k * r + r * n + 2 * n) + 4 * m * n
    return bound(nbytes, 2 * m * k * n + 2 * m * k * r + 2 * m * r * n, rate)


def adc_bound(m, k, n):
    """The ADC MVM: bf16 x, both code arrays, scale, the f32 output."""
    return bound(2 * k * n + 2 * m * k + 4 * n + 4 * m * n, 2 * m * k * n, BF16_FLOP_PER_S)


def adc_f32x_bound(m, k, n):
    """The ADC MVM with f32 x (the routers): x 4 bytes an element, both code
    arrays, scale, the f32 output; f32 operations outside the tensor cores."""
    return bound(2 * k * n + 4 * m * k + 4 * n + 4 * m * n, 2 * m * k * n, F32_FLOP_PER_S)


def int_mm_takes(m, k, n):
    """Whether torch._int_mm (cuBLASLt) accepts an (m, k) x (k, n) product."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


L2_BYTES = 50 * 2 ** 20


def time_ms(fns, reps=5):
    """Mean device time of one call, from CUDA events around replays of a
    CUDA graph that runs every closure in ``fns`` ``reps`` times. The
    closures hold distinct operand copies totalling more than twice the
    50 MB L2, so every call streams its operands from HBM; the graph keeps
    host launch overhead out of the measurement."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(fns))
    del graph
    return ms


def _timed_row(rows, kernel, leaf, shape, ops, fn, plain, library, bounds):
    """Time ``fn`` over every operand copy, ``plain`` over two and the
    ``library`` closures (or None); log and keep the row."""
    row = dict(
        kernel=kernel, leaf=leaf, m=shape[0], k=shape[1], n=shape[2], copies=len(ops),
        ms=time_ms([lambda o=o: fn(*o) for o in ops]),
        plain_ms=time_ms([lambda o=o: plain(*o) for o in ops[:2]], reps=2),
        library_ms=None if library is None else time_ms(library),
    )
    row["bound_ms"], row["bound_by"] = bounds
    rows.append(row)
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
    log(f"[timing] {kernel:22s} {leaf:8s} M={shape[0]:4d} K={shape[1]:5d} N={shape[2]:5d} "
        f"kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | library {lib} | "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) | "
        f"{row['bound_ms'] / row['ms']:.1%} of bound")


def _copies(per_copy):
    """Operand copies whose total is more than twice the L2."""
    return max(2, -(-2 * L2_BYTES // per_copy))


def phase_timing(device):
    from repro_torch.kernels import crossbar_mvm as C
    from repro_torch.kernels import dora_linear as K
    from repro_torch.kernels import ref

    rows = []
    # qwen3-1.7b's leaves at their rows, and deepseek-v2-lite's _kup_vup at
    # phase 12's decode tick (the whole latent cache of 4 slots)
    timed = [(leaf, sorted({*TIMED_M, *TIMED_M_INT8, *TIMED_M_TILED, *TIMED_M_GEMV}))
             for leaf in LEAVES] + [(KUP_VUP, KUP_VUP_M[:1])]
    for (name, k, n, r), row_counts in timed:
        kup = name == KUP_VUP[0]
        for m in row_counts:
            ops = [operands(m, k, n, r, device, seed=i)
                   for i in range(_copies(2 * k * n + 2 * m * k + 4 * m * n))]
            kind = "dora_linear_gemv" if m <= 64 else "dora_linear"
            fn = getattr(K, kind)
            if kup or m in TIMED_M or m in TIMED_M_TILED or m in TIMED_M_GEMV:
                w16 = [((o[1].float() - o[2].float()) * o[3]).to(torch.bfloat16) for o in ops]
                _timed_row(rows, kind, name, (m, k, n), ops, fn, ref.dora_linear_ref,
                           [lambda o=o, w=w: torch.matmul(o[0], w) for o, w in zip(ops, w16)],
                           linear_bound(m, k, n, r, BF16_FLOP_PER_S))
                del w16
            if kup or m in TIMED_M_INT8:
                library = None
                if int_mm_takes(m, k, n):
                    s8 = [(ref.quantize_rows(o[0])[0], ref.recode_s8(o[1]), ref.recode_s8(o[2]))
                          for o in ops]
                    library = [lambda q=q: (torch._int_mm(q[0], q[1]), torch._int_mm(q[0], q[2]))
                               for q in s8]
                _timed_row(rows, K.counter(kind, "int8"), name, (m, k, n), ops,
                           lambda *o, fn=fn: fn(*o, accum="int8"), ref.dora_linear_int8_ref,
                           library, linear_bound(m, k, n, r, INT8_OP_PER_S))
                library = None
            del ops
    for (name, k, n), row_counts in ([(leaf, TIMED_M_ADC) for leaf in ADC_LEAVES]
                                     + [(ADC_KUP, KUP_VUP_M[:1])]):
        for m in row_counts:
            ops = [operands(m, k, n, 1, device, seed=i)[:4]
                   for i in range(_copies(2 * k * n + 2 * m * k + 4 * m * n))]
            _timed_row(rows, "crossbar_mvm", name, (m, k, n), ops, C.crossbar_mvm,
                       ref.crossbar_mvm_ref, None, adc_bound(m, k, n))
            del ops
    # the MoE router (phase 11): f32 x at N = 8 through every body; the
    # library call is torch.matmul of f32 x by the pre-dequantized f32
    # weight (TF32 off)
    k, n, r = ROUTER_K, ROUTER_N, ROUTER_R
    for m in ROUTER_M:
        ops = [router_operands(m, device, seed=i)
               for i in range(_copies(2 * k * n + 4 * m * k + 4 * m * n))]
        kind = "dora_linear_gemv" if m <= 64 else "dora_linear"
        fn = getattr(K, kind)
        w32 = [(o[1].float() - o[2].float()) * o[3] for o in ops]
        _timed_row(rows, kind, "router", (m, k, n), ops, fn, ref.dora_linear_ref,
                   [lambda o=o, w=w: torch.matmul(o[0], w) for o, w in zip(ops, w32)],
                   router_bound(m, k, n, r, F32_FLOP_PER_S))
        library = None
        if int_mm_takes(m, k, n):
            s8 = [(ref.quantize_rows(o[0])[0], ref.recode_s8(o[1]), ref.recode_s8(o[2]))
                  for o in ops]
            library = [lambda q=q: (torch._int_mm(q[0], q[1]), torch._int_mm(q[0], q[2]))
                       for q in s8]
        _timed_row(rows, K.counter(kind, "int8"), "router", (m, k, n), ops,
                   lambda *o, fn=fn: fn(*o, accum="int8"), ref.dora_linear_int8_ref,
                   library, router_bound(m, k, n, r, INT8_OP_PER_S))
        _timed_row(rows, "crossbar_mvm_narrow", "router", (m, k, n), [o[:4] for o in ops],
                   C.crossbar_mvm, ref.crossbar_mvm_ref, None, adc_f32x_bound(m, k, n))
        del ops, w32, library
    # deepseek-v2-lite's router (K 2048, N 64, rank 8): the f32 body (the
    # narrow body) and the ADC (its narrow body) at the decode tick and a
    # full admission chunk
    _, k, n, r = NARROW_ROUTERS[1]
    for m in ROUTER64_M:
        ops = [router_operands(m, device, seed=i, shape=(k, n, r))
               for i in range(_copies(2 * k * n + 4 * m * k + 4 * m * n))]
        w32 = [(o[1].float() - o[2].float()) * o[3] for o in ops]
        _timed_row(rows, "dora_linear_gemv", "router64", (m, k, n), ops, K.dora_linear_gemv,
                   ref.dora_linear_ref,
                   [lambda o=o, w=w: torch.matmul(o[0], w) for o, w in zip(ops, w32)],
                   router_bound(m, k, n, r, F32_FLOP_PER_S))
        _timed_row(rows, "crossbar_mvm_narrow", "router64", (m, k, n), [o[:4] for o in ops],
                   C.crossbar_mvm, ref.crossbar_mvm_ref, None, adc_f32x_bound(m, k, n))
        del ops, w32
    return rows


def router_bound(m, k, n, r, rate):
    """The fused linear with f32 x: x (4 bytes an element), both code
    arrays, the f32 side operands and the f32 output, each moved once."""
    nbytes = 2 * k * n + 4 * m * k + 4 * (k * r + r * n + 2 * n) + 4 * m * n
    return bound(nbytes, 2 * m * k * n + 2 * m * k * r + 2 * m * r * n, rate)


def kernel_breakdown(device, fn, leaves, m):
    """Device time of each kernel that one call ``fn(*operands)`` launches
    (``m`` rows), per leaf of ``leaves`` ((name, K, N, rank) each), from
    ``kernel_ms`` (L2 warm): {leaf: {kernel: ms}}, ``None`` for a leaf
    where the profiler records nothing."""
    out = {}
    for leaf, k, n, r in leaves:
        ops = operands(m, k, n, r, device, seed=1)
        out[leaf] = kernel_ms(lambda: fn(*ops))
        del ops
    return out


def log_breakdown(label, m, per_leaf, bounds):
    """Log a ``kernel_breakdown``: per layer by kernel, and each leaf's
    total against its bound (``bounds``: leaf -> ms; L2 warm, so a leaf can
    beat its HBM bound)."""
    if None in per_leaf.values():
        log(f"[timing] {label} at M={m}: no device activity recorded: not measured")
        return
    layer = {}
    for by in per_leaf.values():
        for name, ms in by.items():
            layer[name] = layer.get(name, 0.0) + ms
    total = sum(layer.values())
    parts = ", ".join(f"{name} {ms:.4f} ms ({ms / total:.1%})"
                      for name, ms in sorted(layer.items(), key=lambda kv: -kv[1]))
    log(f"[timing] {label} per layer at M={m}, by kernel (profiler, L2 warm): "
        f"{total:.4f} ms = {parts}")
    leaves = [f"{leaf} {sum(by.values()):.4f} ms ({bounds[leaf] / sum(by.values()):.1%} of bound)"
              for leaf, by in per_leaf.items()]
    log(f"[timing] {label} per leaf at M={m}: {', '.join(leaves)}")


def linear_breakdown(device, kind, accum, m, label):
    """``kernel_breakdown`` of one fused-linear launcher and body over the
    fused leaves, logged against their bounds."""
    from repro_torch.kernels import dora_linear as K

    fn = getattr(K, kind)
    per_leaf = kernel_breakdown(device, lambda *o: fn(*o, accum=accum), LEAVES, m)
    rate = INT8_OP_PER_S if accum == "int8" else BF16_FLOP_PER_S
    log_breakdown(label, m, per_leaf,
                  {leaf: linear_bound(m, k, n, r, rate)[0] for leaf, k, n, r in LEAVES})
    return per_leaf


def adc_breakdown(device, m):
    """``kernel_breakdown`` of the ADC kernel (bf16 x) over the unfused
    leaves, logged against their bounds: one kernel a call."""
    from repro_torch.kernels import crossbar_mvm as C

    per_leaf = kernel_breakdown(device, lambda *o: C.crossbar_mvm(*o[:4]),
                                [(leaf, k, n, 1) for leaf, k, n in ADC_LEAVES], m)
    log_breakdown("ADC (bf16 x)", m, per_leaf,
                  {leaf: adc_bound(m, k, n)[0] for leaf, k, n in ADC_LEAVES})
    return per_leaf


# (launcher, body, label, rows) of phase 4's breakdowns: the tiled bodies
# at the phase-5 prefill and at PREFILL_M, the GEMV bodies at the decode
# tick and a full admission chunk; the ADC at the decode tick and PREFILL_M
BREAKDOWNS = [(kind, accum, f"{label} {body}", m)
              for kind, label, ms in (("dora_linear", "tiled", (PREFILL_ROWS, PREFILL_M)),
                                      ("dora_linear_gemv", "GEMV", (SLOTS, 32)))
              for accum, body in (("f32", "f32 body (bf16 x)"), ("int8", "int8 body"))
              for m in ms]
ADC_BREAKDOWN_M = (SLOTS, PREFILL_M)


def phase_breakdown(device):
    """Device time per kernel of each launcher and body in ``BREAKDOWNS``
    (for the int8 body the row scales; the X @ A prologue; the XA sum;
    the main kernel; the split-K pass, where the launcher has them), and
    of the ADC kernel at ``ADC_BREAKDOWN_M``."""
    out = {}
    for kind, accum, label, m in BREAKDOWNS:
        out[f"{kind}/{accum}/{m}"] = linear_breakdown(device, kind, accum, m, label)
    for m in ADC_BREAKDOWN_M:
        out[f"crossbar_mvm/{m}"] = adc_breakdown(device, m)
    return out


def reset_counts():
    from repro_torch.kernels import crossbar_mvm as C
    from repro_torch.kernels import dora_linear as K

    K.reset_launch_counts()
    C.reset_launch_counts()


def read_counts():
    """Every kernel's launch counter and its f32-x tally (``/f32x``)."""
    from repro_torch import graphs

    return graphs.launch_counts()


def serving_inputs(vocab, seed, device):
    """Phase 5's traffic, drawn from ``seed``: the ragged engine prompts,
    the fused prefill's tokens (3 x 32 = 96 > 64 rows, so the tiled
    launcher), and the generator, to draw more from."""
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, vocab, (n,), generator=g) for n in PROMPT_LENS]
    tokens = torch.randint(0, vocab, (3, PREFILL_ROWS // 3), generator=g).to(device)
    return prompts, tokens, g


def time_prefill(session, tokens, reps=1):
    """Wall time of each of ``reps`` fused prefills on the device's clock
    (CUDA events around the whole eager call, host launch gaps included),
    and the last one's logits."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        logits, _ = session.prefill(tokens, PREFILL_MAX_LEN)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, logits


@contextlib.contextmanager
def eager_steps():
    """Issue every compiled step eagerly (its function on its static
    buffers, no graph) while inside: the eager side of phase 5's and phase
    6's captured-vs-eager comparisons. The program is not changed; the
    patch is removed on exit."""
    from repro_torch.deploy import serving

    call = serving.CompiledStep.__call__

    def eager(self, host):
        self.inputs.copy_(host)
        return self.fn()

    serving.CompiledStep.__call__ = eager
    try:
        yield
    finally:
        serving.CompiledStep.__call__ = call


def engine_run(session, prompts, max_new, max_len=ENGINE_MAX_LEN):
    """Phase 5's engine traffic once: ragged greedy requests through a
    4-slot ServeEngine (submitted one per tick), the launch counters reset
    just before and read just after."""
    from repro_torch.deploy import ServeEngine

    engine = ServeEngine(session, max_slots=SLOTS, max_len=max_len)
    reqs = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for p in prompts:
        reqs.append(engine.submit(p.numpy(), max_new=max_new))
        engine.step()
    engine.run()
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    counts = read_counts()
    vocab = session.cfg.vocab
    for r in reqs:
        assert r.done and len(r.tokens) == max_new, r
        assert all(0 <= t < vocab for t in r.tokens), r.tokens
    stats = engine.stats()
    assert stats["generated_tokens"] == stats["first_tokens"] + stats["decode_tokens"]
    return {
        "engine_seconds": t_engine, "ticks": engine.tick,
        "decode_steps": stats["decode_steps"], "prefill_chunks": stats["prefill_chunks"],
        "decode_tok_per_s": stats["decode_tok_per_s"],
        "decode_tokens": stats["decode_tokens"], "decode_seconds": stats["decode_seconds"],
        "tick_ms": 1e3 * stats["decode_seconds"] / stats["decode_steps"],
        "ttft_s": [r.ttft_seconds for r in reqs], "launches": counts,
        "streams": [list(r.tokens) for r in reqs], "compile_count": stats["compile_count"],
    }


def replay_vs_eager(session, seed=3, decode_pos=None):
    """Every captured step of the session (the decode tick, the chunk
    buckets 8, 16 and 32) replayed on fresh inputs, then its function run
    eagerly from a copy of the same cache: logits and cache bitwise equal.
    The decode tick at clocks 40-70 (or ``decode_pos``); each chunk with a
    bucket that runs past max_len (pos0 + width > max_len, pos0 + n_valid
    = max_len)."""
    g = torch.Generator().manual_seed(seed)
    vocab = session.cfg.vocab
    out = {}
    for step in session.steps:
        kind, _, batch, width, max_len = step.key
        assert step.graph is not None, step.key
        if kind == "decode":
            pos = torch.arange(batch) * 10 + 40 if decode_pos is None else decode_pos
            host = torch.stack([torch.randint(0, vocab, (batch,), generator=g), pos])
        else:
            host = torch.cat([torch.randint(0, vocab, (width,), generator=g),
                              torch.tensor([max_len - width // 2 - 1, width // 2 + 1])])
        saved = step.flat.clone()
        got = step(host).clone()
        got_cache = step.flat.clone()
        step.flat.copy_(saved)
        want = step.fn()
        torch.cuda.synchronize()
        label = f"{kind}/{width}"
        out[label] = {"logits_equal": torch.equal(got, want),
                      "cache_equal": torch.equal(got_cache, step.flat),
                      "max_abs_diff": float((got.float() - want.float()).abs().max()),
                      "greedy_equal": torch.equal(got.argmax(-1), want.argmax(-1))}
        step.flat.copy_(saved)
        del saved, got, got_cache, want
    log(f"[serve] replay vs eager, {session.options or 'f32'} {session.backend}: " + ", ".join(
        f"{k} logits {'bitwise' if v['logits_equal'] else v['max_abs_diff']} cache "
        f"{'bitwise' if v['cache_equal'] else 'DIFFERS'}" for k, v in out.items()))
    assert all(v["logits_equal"] and v["cache_equal"] for v in out.values()), out
    return out


def tick_times(session, ticks=20, rounds=2, max_len=ENGINE_MAX_LEN):
    """The decode tick at 4 live slots, captured (a replay) and eager
    (``transformer.decode_step`` on the same static inputs), each ending
    in the greedy argmax's copy to the host as the engine's tick does: ms
    per tick on the host clock, in the order captured, eager, eager,
    captured per round (both medians over the rounds)."""
    from repro_torch.deploy import ServeEngine

    engine = ServeEngine(session, max_slots=SLOTS, max_len=max_len)  # leases the warm step
    step = engine._decode
    g = torch.Generator().manual_seed(2)
    host = torch.stack([torch.randint(0, session.cfg.vocab, (SLOTS,), generator=g),
                        torch.arange(SLOTS) * 10 + 40])

    def captured():
        torch.argmax(step(host)[:, -1], dim=-1).cpu()

    def eager():
        step.inputs.copy_(host)
        torch.argmax(step.fn()[:, -1], dim=-1).cpu()

    times = {"captured": [], "eager": []}
    captured()
    eager()
    for _ in range(rounds):
        for name, fn in (("captured", captured), ("eager", eager), ("eager", eager),
                         ("captured", captured)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ticks):
                fn()
            times[name].append(1e3 * (time.perf_counter() - t0) / ticks)
    out = {name: statistics.median(v) for name, v in times.items()}
    out["all"] = times
    log(f"[serve] decode tick ({SLOTS} slots), captured {out['captured']:.3f} ms vs eager "
        f"{out['eager']:.3f} ms ({out['eager'] / out['captured']:.2f}x; medians of "
        f"{2 * rounds} x {ticks} ticks: captured "
        f"{', '.join(f'{t:.3f}' for t in times['captured'])}, eager "
        f"{', '.join(f'{t:.3f}' for t in times['eager'])})")
    return out


def memory():
    """(allocated, reserved) device bytes once the allocator's free cached
    blocks are released: what live tensors and the graphs' private pools
    hold."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def drive(session, prompts, tokens, max_new, max_len=ENGINE_MAX_LEN, compiled=None,
          decode_pos=None):
    """The phase-5 traffic on one session: the engine traffic through the
    compiled steps (the first call of each step eager, then captured), then
    one fused prefill (eager), the launch counters reset before and read
    after each part; then the engine traffic again through the warm graphs
    (``compile_count`` flat, the same launches and streams) and issued
    eagerly (the same launches and streams), each step's replay vs eager,
    the decode tick captured vs eager, and the fused prefill again.
    ``max_len`` is the engines' cache length; ``compiled`` the steps the
    traffic compiles (phase 5's ``COMPILED_STEPS`` by default)."""
    compiled = COMPILED_STEPS if compiled is None else compiled
    mem0 = memory()
    cold = engine_run(session, prompts, max_new, max_len)
    mem1 = memory()
    reset_counts()
    (prefill_ms,), logits = time_prefill(session, tokens)
    prefill_counts = read_counts()
    counts = {k: cold["launches"][k] + n for k, n in prefill_counts.items()}
    # again, uncounted, now that every shape has been seen once
    warm_prefill, _ = time_prefill(session, tokens, reps=3)
    assert torch.isfinite(logits.float()).all()
    assert cold["compile_count"] == session.compile_count() == compiled

    warm = engine_run(session, prompts, max_new, max_len)
    with eager_steps():
        eager = engine_run(session, prompts, max_new, max_len)
    for name, run in (("warm", warm), ("eager", eager)):
        assert run["launches"] == cold["launches"], (name, run["launches"], cold["launches"])
        assert run["streams"] == cold["streams"], name
    assert warm["compile_count"] == eager["compile_count"] == cold["compile_count"]
    result = {
        **cold, "launches_engine": cold["launches"], "launches": counts,
        "warm": warm, "eager": eager,
        "registry_allocated_bytes": mem1[0] - mem0[0],
        "registry_reserved_bytes": mem1[1] - mem0[1],
        "replay_vs_eager": replay_vs_eager(session, decode_pos=decode_pos),
        "tick": tick_times(session, max_len=max_len),
        "prefill_rows": int(tokens.numel()), "prefill_ms": prefill_ms,
        "prefill_ms_warm": warm_prefill,
    }
    log(f"[serve] {session.describe()} {session.options}: compile_count "
        f"{cold['compile_count']} after the first drive, {warm['compile_count']} after the "
        f"second; the first drive left +{result['registry_allocated_bytes'] / 2**20:.1f} MiB "
        f"allocated (static caches, outputs) and +{result['registry_reserved_bytes'] / 2**20:.1f}"
        f" MiB reserved (those and the graphs' pool)")
    for name, run in (("first drive (captures)", cold), ("captured", warm),
                      ("eager", eager)):
        ttft = run["ttft_s"]
        log(f"[serve]   {name}: decode {run['decode_tokens']} tok in "
            f"{run['decode_seconds']:.3f} s = {run['decode_tok_per_s']:.1f} tok/s ({SLOTS} slots, "
            f"{run['tick_ms']:.2f} ms per tick, {run['decode_steps']} ticks, "
            f"{run['prefill_chunks']} admission chunks) | TTFT "
            f"{', '.join(f'{t:.4f}' for t in ttft)} s")
    log(f"[serve] fused prefill ({tokens.shape[0]} x {tokens.shape[1]} tokens) wall "
        f"{prefill_ms:.3f} ms (CUDA events; counted run), warm repeats "
        f"{', '.join(f'{t:.3f}' for t in warm_prefill)} ms")
    log(f"[serve] launches {counts}")
    return result, logits


def expect_counts(counts, want):
    """Every launch counter equals ``want`` (0 where not named)."""
    full = {name: want.get(name, 0) for name in counts}
    assert counts == full, (counts, full)


def compare_logits(label, a, b, bound=None):
    """max |a - b| relative to b's absmax and top-1 agreement; fails when
    a ``bound`` is given and exceeded."""
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[serve] {label}: max|diff| {err:.4f} of absmax {scale:.4f} ({err / scale:.2e}"
        f"{'' if bound is None else f'; bound {bound:g}'}), top-1 agree {top1:.3f}")
    if bound is not None:
        assert err <= bound * scale, (label, err, scale)
    return {"max_abs_diff": err, "absmax": scale, "rel": err / scale, "top1_agree": top1}


def codes_vs_dequant(session, logits, tokens, g, device):
    """The session's fused-prefill ``logits`` (codes) against the same
    prefill under ``dequant``, then one admission chunk per GEMV row bucket
    the engine pads to (5, 9 and 17 valid tokens -> 8, 16 and 32 rows),
    codes vs dequant, each within ``LOGITS_BOUND``."""
    from repro_torch import substrate
    from repro_torch.models import transformer as T

    cfg = session.cfg
    with substrate.use_backend("dequant"), torch.no_grad():
        ref_logits, _ = T.prefill(session.params, tokens, cfg, PREFILL_MAX_LEN)
    prefill = compare_logits("codes vs dequant prefill logits", logits, ref_logits,
                             LOGITS_BOUND)
    del ref_logits
    chunk_errs = {}
    for n in (5, 9, 17):
        width = next(w for w in (8, 16, 32) if w >= n)
        toks = torch.zeros((1, width), dtype=torch.int64, device=device)
        toks[0, :n] = torch.randint(0, cfg.vocab, (n,), generator=g)
        out = {}
        for backend in ("codes", "dequant"):
            cache = T.init_cache(cfg, 1, PREFILL_MAX_LEN, device)
            with substrate.use_backend(backend), torch.no_grad():
                out[backend], _ = T.prefill_chunk(
                    session.params, toks, cache, torch.tensor([0], device=device),
                    torch.tensor([n], device=device), cfg, PREFILL_MAX_LEN)
        chunk_errs[width] = compare_logits(
            f"codes vs dequant admission chunk of {n} tokens ({width} rows)",
            out["codes"], out["dequant"], LOGITS_BOUND)["rel"]
    return prefill, chunk_errs


def serve_checked(dep, seed, label, *, session=None, make_adc=None, check_session=None,
                  keep=False, also=None):
    """Phase 5's traffic and per-session checks on ``dep``: ``serve()``
    (exact launch counts; codes vs dequant within ``LOGITS_BOUND``), then
    ``serve(accum="int8")`` (exact counts; int8 vs f32 within
    ``INT8_LOGITS_BOUND``), then, when ``make_adc`` gives a codes_adc
    deployment, its session (exact counts; ADC vs f32 and its greedy
    tokens equal to f32's reported). ``session`` is the f32 session, if
    made already; ``check_session`` sees it before it serves; ``label``
    prefixes the logit comparisons; ``also(body, session)``, when given,
    runs on each session after its checks, its result under the run's
    ``"also"`` key.
    Each session is freed after its body unless ``keep``. Returns
    ``(runs, sessions)`` keyed by body; ``drive`` holds the graphs."""
    cfg, device = dep.cfg, dep.device
    prompts, tokens, g = serving_inputs(cfg.vocab, seed, device)
    n_leaves = 4 * cfg.n_layers  # fused qkv, o, gate_up, down per layer
    n_adc = 7 * cfg.n_layers     # q, k, v, o, gate, up, down per layer
    sessions = {}

    # f32 codes: every admission chunk (<= 32 rows) and every decode tick
    # (4 rows) runs each fused leaf once through the GEMV launcher
    session = dep.serve() if session is None else session
    if check_session is not None:
        check_session(session)
    f32, logits = drive(session, prompts, tokens, MAX_NEW)
    f32["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    steps = f32["prefill_chunks"] + f32["decode_steps"]
    expect_counts(f32["launches_engine"], {"dora_linear_gemv": n_leaves * steps})
    expect_counts(f32["launches"], {"dora_linear_gemv": n_leaves * steps,
                                    "dora_linear": n_leaves})
    f32["codes_vs_dequant"], f32["chunk_logits_rel_diff"] = codes_vs_dequant(
        session, logits, tokens, g, device)
    if also is not None:
        f32["also"] = also("f32", session)
    if keep:
        sessions["f32"] = session
    del session

    # int8 codes: the same codes and traffic through the int8 body
    session = dep.serve(accum="int8")
    int8, logits8 = drive(session, prompts, tokens, MAX_NEW)
    steps = int8["prefill_chunks"] + int8["decode_steps"]
    expect_counts(int8["launches_engine"], {"dora_linear_gemv/int8": n_leaves * steps})
    expect_counts(int8["launches"], {"dora_linear_gemv/int8": n_leaves * steps,
                                     "dora_linear/int8": n_leaves})
    int8["int8_vs_f32"] = compare_logits(f"{label}int8 vs f32 codes prefill logits",
                                         logits8, logits, INT8_LOGITS_BOUND)
    if also is not None:
        int8["also"] = also("int8", session)
    if keep:
        sessions["int8"] = session
    del session, logits8
    runs = {"f32": f32, "int8": int8}
    if make_adc is None:
        return runs, sessions

    # codes_adc: every unfused leaf of every forward runs the ADC kernel
    memory()
    session = make_adc().serve()
    adc, logits_adc = drive(session, prompts, tokens, MAX_NEW)
    steps = adc["prefill_chunks"] + adc["decode_steps"]
    expect_counts(adc["launches_engine"], {"crossbar_mvm": n_adc * steps})
    expect_counts(adc["launches"], {"crossbar_mvm": n_adc * (steps + 1)})
    adc["adc_vs_f32"] = compare_logits(f"{label}codes_adc vs f32 codes prefill logits",
                                       logits_adc, logits)
    same = sum(a == b for ra, rb in zip(adc["streams"], f32["streams"])
               for a, b in zip(ra, rb))
    adc["greedy_tokens_equal_f32"] = same / sum(len(r) for r in f32["streams"])
    log(f"[serve] {label}codes_adc greedy tokens equal to f32 codes: "
        f"{adc['greedy_tokens_equal_f32']:.3f}")
    if also is not None:
        adc["also"] = also("codes_adc", session)
    if keep:
        sessions["codes_adc"] = session
    del session, logits_adc, logits
    runs["codes_adc"] = adc
    return runs, sessions


def phase_serving(device, seed):
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment

    cfg = get_arch("qwen3-1.7b").full
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dep = Deployment.program(cfg, seed, backend="codes", device=device)
    dep.advance(24)
    session = dep.serve()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    log(f"[serve] {session.describe()}")
    log(f"[serve] program + advance(24) + serve: {t_setup:.2f} s")

    n_leaves = 4 * cfg.n_layers  # fused qkv, o, gate_up, down per layer
    runs, sessions = serve_checked(
        dep, seed, "", session=session, keep=True,
        # a second deployment over the same teacher, codes and adapters
        make_adc=lambda: Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes,
                                    dep.adapters, dep.teacher_seed, dep.program_seed,
                                    dep.drift_hours))
    del session
    result, int8, adc = runs["f32"], runs["int8"], runs["codes_adc"]
    peak_f32 = result["peak_mem_bytes"]
    result.update(
        setup_seconds=t_setup, rram_bytes=dep.rram_bytes(),
        sram_bytes=dep.sram_bytes(), calibrated_fraction=dep.calibrated_fraction(),
        gemv_launches_per_tick=n_leaves,
    )
    log(f"[serve] f32 codes: peak mem {peak_f32 / 2**30:.2f} GiB | rram_bytes "
        f"{result['rram_bytes']} sram_bytes {result['sram_bytes']} calibrated "
        f"{result['calibrated_fraction']:.2%} ({n_leaves} GEMV launches per decode tick)")
    result["int8"], result["codes_adc"] = int8, adc
    log("[serve] fused prefill wall (CUDA events, counted run | warm best): " + ", ".join(
        f"{body} {run['prefill_ms']:.3f} | {min(run['prefill_ms_warm']):.3f} ms"
        for body, run in (("f32", result), ("int8", int8), ("codes_adc", adc))))
    for body, run in (("f32", result), ("int8", int8), ("codes_adc", adc)):
        log(f"[serve] {body}: decode tick captured {run['warm']['tick_ms']:.3f} ms "
            f"({run['warm']['decode_tok_per_s']:.1f} tok/s) vs eager "
            f"{run['eager']['tick_ms']:.3f} ms ({run['eager']['decode_tok_per_s']:.1f} tok/s) in "
            f"the engine; {run['tick']['captured']:.3f} vs {run['tick']['eager']:.3f} ms alone; "
            f"TTFT max captured {max(run['warm']['ttft_s']):.4f} s vs eager "
            f"{max(run['eager']['ttft_s']):.4f} s; compile_count {run['compile_count']}")
    result["peak_mem_bytes_all"] = torch.cuda.max_memory_allocated()
    return result, sessions, dep


def phase_trace(session, ticks=4):
    """Profile a steady window of decode ticks (4 slots, full width), first
    through the captured graphs, then issued eagerly: device busy share of
    the wall time, kernels and graph launches per tick, and the kernels
    that take the most device time (``profile_window``). The engine leases
    the session's warm decode step and its prompts fill warm buckets:
    nothing is captured here."""
    from repro_torch.deploy import ServeEngine

    g = torch.Generator().manual_seed(1)
    warm = session.compile_count()
    engine = ServeEngine(session, max_slots=SLOTS, max_len=128)
    for _ in range(SLOTS):
        engine.submit(torch.randint(0, session.cfg.vocab, (8,), generator=g).numpy(),
                      max_new=2 * ticks + 6)
    while not engine.active.all():
        engine.step()
    engine.step()  # one untraced tick with every slot live
    torch.cuda.synchronize()
    out = {"captured": profile_window("trace", "tick", ticks, engine.step)}
    with eager_steps():
        engine.step()
        torch.cuda.synchronize()
        log("[trace] the same engine, every step issued eagerly:")
        out["eager"] = profile_window("trace", "tick", ticks, engine.step)
    assert engine.active.all() and session.compile_count() == warm
    return out


def profile_window(tag, unit, n, fn, classes=None):
    """torch.profiler over ``n`` calls of ``fn`` (each one ``unit``), ended
    by a synchronize: wall and device-busy ms per unit, the busy share,
    kernels and CUDA-graph launches per unit and the kernels that take the
    most device time; with ``classes`` (name -> regex over kernel names)
    also the device ms per unit of each class, a kernel counted in the
    first class it matches. ``None`` where the profiler records no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    graphs = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                 and e.name.startswith("cudaGraphLaunch"))
    busy = sum(e.device_time_total for e in kernels) / 1e6  # us -> s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    per = unit.replace(" ", "_")
    result = {
        f"{per}s": n, f"wall_ms_per_{per}": 1e3 * wall / n,
        f"device_busy_ms_per_{per}": 1e3 * busy / n if kernels else None,
        "device_busy_share": busy / wall if kernels else None,
        f"kernels_per_{per}": len(kernels) / n if kernels else None,
        f"graph_launches_per_{per}": graphs / n,
        f"top_kernels_ms_per_{per}": [(name[:80], ms / n) for name, ms in top],
    }
    if classes:
        import re

        split = dict.fromkeys([*classes, "other"], 0.0)
        for name, ms in by_name.items():
            cls = next((c for c, rx in classes.items() if re.search(rx, name)), "other")
            split[cls] += ms / n
        result[f"class_ms_per_{per}"] = split if kernels else None
        if kernels:
            log(f"[{tag}] device ms per {unit} by class: " + ", ".join(
                f"{c} {ms:.3f} ({ms / (1e3 * busy / n):.1%})" for c, ms in split.items()))
    if kernels:
        log(f"[{tag}] {n} {unit}s: {1e3 * wall / n:.2f} ms per {unit} wall, "
            f"{1e3 * busy / n:.3f} ms device busy ({busy / wall:.1%}), "
            f"{len(kernels) / n:.0f} kernels and {graphs / n:g} graph launches per {unit}")
        for name, ms in top:
            log(f"[{tag}]   {ms / n:8.3f} ms/{unit}  {name[:80]}")
    else:
        log(f"[{tag}] the profiler recorded no device activity: busy share not measured "
            f"({graphs / n:g} graph launches per {unit})")
    return result


@contextlib.contextmanager
def timed_calibration():
    """Time ``Deployment.calibrate``'s phases from outside: its
    ``teacher_features`` call (seconds) and each call of its compiled step
    (ms) and each capture (seconds), each closed by a synchronize; keep,
    per step built, the storages of its static leaves and AdamW state, its
    stream and a weak reference (holding the step would hold its memory).
    The program is not changed; the wrappers are removed on exit."""
    import weakref

    from repro_torch import graphs
    from repro_torch.core import calibrate as calib
    from repro_torch.deploy import deployment as D

    times = {"teacher_s": [], "step_ms": [], "capture_s": [], "steps": []}
    feats_fn, call, capture = D.teacher_features, calib.CompiledCalibStep.__call__, graphs.capture

    def timed(fn, key, unit):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(unit * (time.perf_counter() - t0))
            return out
        return run

    def first_call(step):
        if step.calls == 0:
            times["steps"].append({
                "ref": weakref.ref(step), "stream": step.stream,
                "storages": storages([step.leaves, *step.opt_state])})

    timed_call = timed(call, "step_ms", 1e3)
    counted = timed(capture, "capture_s", 1.0)
    D.teacher_features = timed(feats_fn, "teacher_s", 1.0)
    calib.CompiledCalibStep.__call__ = lambda self: first_call(self) or timed_call(self)
    graphs.capture = counted
    try:
        yield times
    finally:
        D.teacher_features, calib.CompiledCalibStep.__call__ = feats_fn, call
        graphs.capture = capture


def storages(tree):
    from repro_torch import tree as tree_lib

    return {t.untyped_storage().data_ptr() for t in tree_lib.tensors(tree)}


def tree_bytes(tree):
    from repro_torch import tree as tree_lib

    return sum(t.numel() * t.element_size() for t in tree_lib.tensors(tree))


def eager_calibration(dep, start, batch, cached, stream, steps):
    """The yardstick of the compiled step: ``steps`` eager steps
    (``make_cached_calib_step`` or ``make_calib_step``, the port's twins of
    the reference's step functions) from the ``(adapters, opt_state)``
    copies ``start``, on ``stream`` (the deployment's calibration stream:
    the same cuBLAS workspace) under dequant, each timed to a synchronize:
    (losses, final CalibState, ms per step)."""
    from repro_torch import substrate
    from repro_torch.core import calibrate as calib
    from repro_torch.deploy import deployment as D
    from repro_torch.optim.adam import AdamW

    cfg, opt = dep.cfg, AdamW(lr=1e-3)
    batch = D._device_batch(batch, dep.device)
    state = calib.CalibState(dep.teacher_base, dep.base, *start, 0)
    losses, ms = [], []
    torch.cuda.synchronize()
    with torch.cuda.stream(stream), substrate.use_backend("dequant"):
        if cached:
            feats = calib.teacher_features(dep.teacher_base, batch, cfg)
            step = calib.make_cached_calib_step(cfg, opt)
            run = lambda s: step(s, feats, batch)  # noqa: E731
        else:
            step = calib.make_calib_step(cfg, opt)
            run = lambda s: step(s, batch)  # noqa: E731
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = run(state)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    return losses, state, ms


def graph_vs_eager(label, report, dep, state, losses):
    """``calibrate``'s losses, adapters and AdamW state against the eager
    steps' (``state``, ``losses``): bitwise, else within CALIB_LOSS_RTOL
    (losses) with the tensors that differ reported; fails otherwise."""
    from repro_torch import tree as tree_lib

    pairs = [("adapters", state.adapters, dep.adapters),
             ("opt_state", [*state.opt_state], [*dep.opt_state])]
    differ = {}
    for name, want, got in pairs:
        for i, (a, b) in enumerate(zip(tree_lib.tensors(want), tree_lib.tensors(got))):
            assert a.shape == b.shape and a.dtype == b.dtype, (name, i)
            if not torch.equal(a, b):
                differ[f"{name}/{i}"] = float((a.float() - b.float()).abs().max())
    bitwise = report.losses == losses and not differ
    worst = max(abs(a - b) / abs(b) for a, b in zip(report.losses, losses))
    log(f"[calib] {label}: graph vs eager steps from one start, {len(losses)} steps: "
        + ("losses, adapters and AdamW state bitwise" if bitwise else
           f"NOT bitwise: losses rel {worst:.2e} (CALIB_LOSS_RTOL {CALIB_LOSS_RTOL:g}), "
           f"{len(differ)} tensors differ (max {max(differ.values(), default=0):.3e})"))
    assert len(report.losses) == len(losses) and worst <= CALIB_LOSS_RTOL, (
        report.losses, losses)
    return {"bitwise": bitwise, "loss_rel_diff": worst, "tensors_differ": differ}


def step_split(cfg, state, feats, batch, reps=3):
    """One cached calibration step cut into its parts, each closed by a
    synchronize (ms, the median of ``reps``): the loss's forward over the
    28 blocks, ``torch.autograd.grad`` over the adapter leaves, and
    ``adamw_update``. Run under ``dequant``; the results are discarded."""
    from repro_torch import tree as tree_lib
    from repro_torch.core import calibrate as calib
    from repro_torch.optim.adam import AdamW, adamw_update

    loss_fn = calib.make_cached_calib_loss(cfg)
    parts = {"forward": [], "backward": [], "adamw": []}
    for _ in range(reps):
        leaves = [t.detach().requires_grad_(True) for t in tree_lib.tensors(state.adapters)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(tree_lib.unflatten(state.adapters, leaves), state.student_base, feats,
                       batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adamw_update(tree_lib.unflatten(state.adapters, grads), state.opt_state,
                     state.adapters, AdamW(lr=1e-3))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(1e3 * dt)
        del loss, grads, leaves
    out = {key: statistics.median(v) for key, v in parts.items()}
    log("[calib] one step split (ms, median of %d): " % reps
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def phase_calibrate(dep, device, seed):
    """Calibrate the phase-5 deployment (qwen3-1.7b FULL, codes, 24 h of
    drift) at the paper's 10 samples x 32 tokens, 20 steps, through its
    compiled step (one CUDA graph a call), then hold it against the eager
    step functions from the same start, cached and fused, and serve the
    calibrated side-cars through the f32 and int8 bodies with phase 5's
    traffic and checks. Gated: no kernel launch during calibrate, one
    capture a call, the codes bitwise unchanged, every loss finite and
    falling; the graph's losses, adapters and AdamW state equal to the
    eager steps' (bitwise, else losses within ``CALIB_LOSS_RTOL``), its
    step faster than theirs (medians of steps 2-20); the
    adapters without grad and apart from the step's static tensors, the
    graph released; memory allocated after the call back at the level
    before it plus the AdamW state it made; serving's exact launch counts,
    codes vs dequant within ``LOGITS_BOUND``, int8 vs f32 within
    ``INT8_LOGITS_BOUND``. Reported: step ms captured vs eager (step 1,
    step 2 with the capture, the median of steps 2-20), calibrate seconds,
    peak memory, kernels and graph launches per step and the device-busy
    share (profiler over two replays and two eager steps), the logit MSE
    gap recovered (calibration batch and a held-out one)."""
    from repro_torch import substrate
    from repro_torch import tree as tree_lib
    from repro_torch.core import calibrate as calib
    from repro_torch.deploy import calibration_batch
    from repro_torch.deploy import deployment as D
    from repro_torch.optim.adam import AdamW, adamw_init

    t_phase = time.perf_counter()
    cfg = dep.cfg
    codes = [t.clone() for t in tree_lib.tensors(dep.codes)]
    batches = {"calibration": calibration_batch(cfg, CALIB_SAMPLES, CALIB_SEQ),
               "held_out": {"tokens": torch.randint(
                   0, cfg.vocab, (CALIB_SAMPLES, CALIB_SEQ),
                   generator=torch.Generator().manual_seed(seed + 1))}}
    gaps = {name: {"drift": dep.logit_mse(b, use_adapters=False), "before": dep.logit_mse(b)}
            for name, b in batches.items()}
    assert dep.opt_state is None  # the first calibrate of phase 5's deployment
    start = tree_lib.map_tensors(torch.clone, dep.adapters)
    start = (start, adamw_init(start))

    # cuBLAS's workspaces for the deployment's calibration stream (one per
    # thread that calls cuBLAS on it: this one for the forward, autograd's
    # for the backward), which outlive the call, made before the memory is
    # read
    workspace = memory()[0]
    with torch.cuda.stream(dep._calib_stream()):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.ones((8, 8), dtype=dtype, device=device, requires_grad=True)
            torch.autograd.grad((x @ x).float().sum(), [x])
    del x
    allocated_before, reserved_before = memory()
    workspace = allocated_before - workspace
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with timed_calibration() as times:
        t0 = time.perf_counter()
        report = dep.calibrate(CALIB_SAMPLES, steps=CALIB_STEPS, seq_len=CALIB_SEQ)
        torch.cuda.synchronize()
        t_calibrate = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    allocated_after, reserved_after = memory()
    log(f"[calib] {report.summary()}")
    log(f"[calib] losses {', '.join(f'{x:.6f}' for x in report.losses)}")
    expect_counts(counts, {})
    assert all(torch.equal(a, b) for a, b in zip(codes, tree_lib.tensors(dep.codes))), \
        "calibrate changed the codes"
    del codes
    assert all(math.isfinite(x) for x in report.losses), report.losses
    assert report.final_loss < report.initial_loss, report.losses
    assert not any(t.requires_grad for t in tree_lib.tensors(dep.adapters))
    (built,) = times["steps"]
    assert len(times["capture_s"]) == 1 and len(times["step_ms"]) == CALIB_STEPS, times
    step_left = built["ref"]()
    assert step_left is None or step_left.graph is None, "the graph outlived calibrate"
    assert not storages([dep.adapters, *dep.opt_state]) & built["storages"], \
        "the adapters or AdamW state alias the compiled step's static tensors"
    state_bytes = tree_bytes([*dep.opt_state])
    grown = allocated_after - allocated_before
    log(f"[calib] memory allocated {allocated_before / 2**30:.4f} -> "
        f"{allocated_after / 2**30:.4f} GiB (+{grown / 2**20:.2f} MiB; the AdamW state "
        f"made: {state_bytes / 2**20:.2f} MiB, the adapters: "
        f"{tree_bytes(dep.adapters) / 2**20:.2f} MiB; the stream's cuBLAS workspaces, made "
        f"before: {workspace / 2**20:.2f} MiB), reserved "
        f"{reserved_before / 2**30:.4f} -> {reserved_after / 2**30:.4f} GiB, peak "
        f"{peak / 2**30:.2f} GiB")
    assert 0 <= grown <= state_bytes + tree_bytes(dep.adapters), (grown, state_bytes)

    # the yardstick: the eager step functions from the same start, on the
    # deployment's calibration stream
    memory()
    torch.cuda.reset_peak_memory_stats()
    eager_losses, eager_state, eager_ms = eager_calibration(
        dep, start, batches["calibration"], True, built["stream"], CALIB_STEPS)
    eager_peak = torch.cuda.max_memory_allocated()
    cached = graph_vs_eager("cached step", report, dep, eager_state, eager_losses)
    del eager_state
    steps_ms = times["step_ms"]
    result = {
        "report": report.to_dict(), "launches": counts, "calibrate_seconds": t_calibrate,
        "teacher_features_seconds": times["teacher_s"][0], "step_ms": steps_ms,
        "step1_ms": steps_ms[0], "step2_capture_ms": steps_ms[1],
        "step_ms_median_2_on": statistics.median(steps_ms[1:]),
        "step_ms_median_3_on": statistics.median(steps_ms[2:]),
        "eager_step_ms": eager_ms, "eager_step_ms_median_2_on": statistics.median(eager_ms[1:]),
        "capture_seconds": times["capture_s"][0], "peak_mem_bytes": peak,
        "eager_peak_mem_bytes": eager_peak,
        "allocated_before": allocated_before, "allocated_after": allocated_after,
        "reserved_before": reserved_before, "reserved_after": reserved_after,
        "state_bytes": state_bytes, "stream_workspace_bytes": workspace,
        "graph_vs_eager": {"cached": cached},
    }
    log(f"[calib] {cfg.name}, {CALIB_SAMPLES} samples x {CALIB_SEQ} tokens, "
        f"{CALIB_STEPS} steps: calibrate {t_calibrate:.3f} s, teacher features "
        f"{result['teacher_features_seconds']:.3f} s; step captured vs eager (median of steps "
        f"2-{CALIB_STEPS}) {result['step_ms_median_2_on']:.2f} vs "
        f"{result['eager_step_ms_median_2_on']:.2f} ms "
        f"({result['eager_step_ms_median_2_on'] / result['step_ms_median_2_on']:.2f}x); "
        f"step 1 (eager) {steps_ms[0]:.2f} ms, step 2 (capture + replay) {steps_ms[1]:.2f} ms "
        f"(the capture {1e3 * result['capture_seconds']:.2f} ms), "
        f"steps 3-{CALIB_STEPS} median {result['step_ms_median_3_on']:.2f} (min "
        f"{min(steps_ms[2:]):.2f}, max {max(steps_ms[2:]):.2f}); peak mem "
        f"{peak / 2**30:.2f} GiB (eager steps {eager_peak / 2**30:.2f} GiB), launches {counts}")
    for name, b in batches.items():
        gap = gaps[name]
        gap["after"] = dep.logit_mse(b)
        gap["recovered"] = 1.0 - gap["after"] / gap["drift"]
        log(f"[calib] logit MSE on the {name} batch: drift gap {gap['drift']:.5f}, "
            f"fresh side-cars {gap['before']:.5f}, calibrated {gap['after']:.5f} "
            f"({gap['recovered']:.1%} of the drift gap recovered; not gated)")
    result["logit_mse"] = gaps
    assert result["step_ms_median_2_on"] < result["eager_step_ms_median_2_on"], result

    # the fused step (cached_teacher=False) from the same start, on a twin
    # deployment over the same teacher and codes
    twin = D.Deployment(cfg, dep.backend, dep.teacher_base, dep.codes,
                        tree_lib.map_tensors(torch.clone, start[0]), dep.teacher_seed,
                        dep.program_seed, dep.drift_hours)
    reset_counts()
    with timed_calibration() as fused_times:
        t0 = time.perf_counter()
        fused_report = twin.calibrate(CALIB_SAMPLES, steps=CALIB_STEPS, seq_len=CALIB_SEQ,
                                      cached_teacher=False)
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
    expect_counts(read_counts(), {})
    assert len(fused_times["capture_s"]) == 1, fused_times
    eager_losses, eager_state, fused_eager_ms = eager_calibration(
        twin, start, batches["calibration"], False, fused_times["steps"][0]["stream"],
        CALIB_STEPS)
    fused = graph_vs_eager("fused step", fused_report, twin, eager_state, eager_losses)
    del eager_state, twin, start
    fused_ms = fused_times["step_ms"]
    result["graph_vs_eager"]["fused"] = fused
    result["fused"] = {"calibrate_seconds": t_fused, "losses": fused_report.losses,
                       "capture_seconds": fused_times["capture_s"][0],
                       "step_ms": fused_ms, "step_ms_median_2_on": statistics.median(fused_ms[1:]),
                       "eager_step_ms": fused_eager_ms,
                       "eager_step_ms_median_2_on": statistics.median(fused_eager_ms[1:])}
    log(f"[calib] fused step (cached_teacher=False): calibrate {t_fused:.3f} s; step captured "
        f"vs eager (median of steps 2-{CALIB_STEPS}) "
        f"{result['fused']['step_ms_median_2_on']:.2f} vs "
        f"{result['fused']['eager_step_ms_median_2_on']:.2f} ms; step 1 {fused_ms[0]:.2f} ms, "
        f"step 2 (capture + replay) {fused_ms[1]:.2f} ms (the capture "
        f"{1e3 * result['fused']['capture_seconds']:.2f} ms)")
    assert result["fused"]["step_ms_median_2_on"] < result["fused"]["eager_step_ms_median_2_on"]

    # where a step's time goes: two replays of a compiled step and two eager
    # steps from the calibrated state, under dequant as calibrate runs them
    # (the results are discarded)
    batch = D._device_batch(batches["calibration"], device)
    feats = calib.teacher_features(dep.teacher_base, batch, cfg)
    eager_step = calib.make_cached_calib_step(cfg, AdamW(lr=1e-3))
    state = [dep.calib_state()]

    def one_eager_step():
        state[0], metrics = eager_step(state[0], feats, batch)
        float(metrics["loss"])

    with substrate.use_backend("dequant"):
        compiled = calib.CompiledCalibStep(cfg, AdamW(lr=1e-3), dep.calib_state(), batch, feats)
        for _ in range(2):  # the eager first step, then the capture
            float(compiled()["loss"])
        log("[calib] profile of two replays of the captured step:")
        traced = profile_window("calib", "step", 2, lambda: float(compiled()["loss"]))
        compiled.release()
        del compiled
        one_eager_step()
        log("[calib] profile of two eager steps:")
        result["trace"] = {"captured": traced,
                           "eager": profile_window("calib", "step", 2, one_eager_step)}
        result["step_split_ms"] = step_split(cfg, state[0], feats, batch)
    busy = traced["device_busy_ms_per_step"]
    if busy is not None:
        traced["device_busy_share_of_unprofiled_step"] = busy / result["step_ms_median_3_on"]
        log(f"[calib] device busy {busy:.3f} ms of the unprofiled captured step's "
            f"{result['step_ms_median_3_on']:.3f} ms "
            f"({traced['device_busy_share_of_unprofiled_step']:.1%})")
    del state, feats, batch

    # serve the calibrated side-cars through the kernels and the compiled
    # steps: phase 5's traffic and checks, the f32 body then the int8 body
    runs, _ = serve_checked(dep, seed, "calibrated ")
    f32, int8 = runs["f32"], runs["int8"]
    result.update(serving_f32=f32, serving_int8=int8,
                  phase_seconds=time.perf_counter() - t_phase)
    log(f"[calib] phase 7 took {result['phase_seconds']:.2f} s")
    return result


def trees_equal(a, b):
    """Two trees' tensors, pairwise bitwise equal (and as many)."""
    from repro_torch import tree as tree_lib

    ta, tb = tree_lib.tensors(a), tree_lib.tensors(b)
    return len(ta) == len(tb) > 0 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


def cpu_view_matches(dep, specs):
    """The card's ``codes_view`` against the CPU's from the same draws: per
    leaf and spec, the uniforms regenerated from the leaf's stream on the
    card (``leaf_draws``) and moved to the host; the CPU's records from
    them (``leaf_fault``), composed and applied to the CPU's copy of the
    pristine codes. The first and last layer of each stacked leaf (every
    stage is elementwise, so a layer's draws are the layer's slice).
    Returns the number of cells compared."""
    from repro_torch.core import rram
    from repro_torch.faults import generators as G
    from repro_torch.faults.map import LeafFaults

    cfg, cells = dep.cfg, 0
    views = dict(G.rram_leaves(dep.codes_view))
    for path, xw in G.rram_leaves(dep.codes):
        shape = tuple(xw.g_pos.shape)
        layers = (0, shape[0] - 1) if len(shape) == 3 else (Ellipsis,)
        records = {i: LeafFaults() for i in layers}
        for spec in specs:
            draws = None if spec.key_data is None else G.leaf_draws(spec, path, shape,
                                                                    dep.device)
            for i in layers:
                d = None if draws is None else tuple(t[i].cpu() for t in draws)
                records[i] = records[i].compose(G.leaf_fault(
                    spec, d, tuple(xw.g_pos[i].shape), cfg.rram, "cpu"))
            del draws
        for i, lf in records.items():
            want = lf.apply(rram.CrossbarWeight(xw.g_pos[i].cpu(), xw.g_neg[i].cpu(),
                                                xw.scale[i].cpu()), cfg.rram)
            got = views[path]
            assert torch.equal(got.g_pos[i].cpu(), want.g_pos), (path, i)
            assert torch.equal(got.g_neg[i].cpu(), want.g_neg), (path, i)
            cells += 2 * want.g_pos.numel()
    return cells


def cap_clamps(dep):
    """How many cells of ``dep``'s view the saturation caps change: each
    leaf's composite record applied with and without its caps (the
    capped cells: those whose cap is below ``code_max``)."""
    from repro_torch.faults.generators import rram_leaves

    views, cm = dict(rram_leaves(dep.codes_view)), dep.cfg.rram.code_max
    clamped = capped = 0
    for path, xw in rram_leaves(dep.codes):
        lf = dep._fault_map.leaves[path]
        if lf.cap_pos is None:
            continue
        free = dataclasses.replace(lf, cap_pos=None, cap_neg=None).apply(xw, dep.cfg.rram)
        for got, want, cap in ((views[path].g_pos, free.g_pos, lf.cap_pos),
                               (views[path].g_neg, free.g_neg, lf.cap_neg)):
            clamped += int((got != want).sum())
            capped += int((cap < cm).sum())
        del free
    return {"clamped_cells": clamped, "capped_cells": capped}


def serve_faulted(dep, seed, healthy, label="faulted", also=None):
    """``serve_checked`` on the faulted deployment: the f32 session's
    prepared tree held against ``prepare_base_for_serve(faults=)``, and a
    codes_adc deployment given the same specs, its view bitwise
    ``dep.codes_view``. ``healthy`` is phase 5's result, whose captured
    ticks are reported beside these; ``label`` names the deployment in the
    log, ``also`` is ``serve_checked``'s."""
    from repro_torch import substrate
    from repro_torch.deploy import Deployment

    cfg = dep.cfg

    def check_session(session):
        routed = substrate.prepare_base_for_serve(dep.codes, session.params["adapters"],
                                                  cfg, faults=dep._fault_map)
        assert trees_equal(session.params["base"], routed), \
            "the served tree differs from prepare_base_for_serve(faults=)"
        log("[faults] the f32 session's prepared tree is bitwise "
            "prepare_base_for_serve(dep.codes, merged, cfg, faults=dep._fault_map)")

    def make_adc():
        dep_adc = Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes, dep.adapters,
                             dep.teacher_seed, dep.program_seed, dep.drift_hours)
        dep_adc.inject(dep.fault_specs)
        assert trees_equal(dep_adc.codes_view, dep.codes_view), "codes_adc's view differs"
        log(f"[faults] codes_adc deployment: the same {len(dep.fault_specs)} specs injected, "
            f"its view bitwise dep.codes_view; two maps resident, allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        return dep_adc

    out, _ = serve_checked(dep, seed, f"{label} ", make_adc=make_adc,
                           check_session=check_session, also=also)
    for body, run in out.items():
        was = (healthy if body == "f32" else healthy[body])["tick"]["captured"]
        run["tick_ms_healthy"] = was
        log(f"[faults] {body}: captured tick {run['tick']['captured']:.3f} ms {label} vs "
            f"{was:.3f} ms healthy (phase 5; reported, not gated), engine "
            f"{run['warm']['decode_tok_per_s']:.1f} tok/s, compile_count "
            f"{run['compile_count']}")
    return out


def phase_faults(dep, device, seed, healthy):
    """Phase 8 on phase 7's calibrated deployment (qwen3-1.7b FULL, codes,
    24 h): inject the study's four fault classes at once, each with a key
    of its own, and hold the view (pristine codes, re-injection, the CPU's
    view from the same draws, the caps clamping), serve it through all
    three bodies with phase 5's checks, let 300 h pass (stuck cells stay
    pinned) and calibrate on the faulted base. Gated: every check named
    in the module's docstring."""
    from repro_torch import tree as tree_lib
    from repro_torch.deploy import calibration_batch
    from repro_torch.faults import FAULT_CLASSES, default_spec
    from repro_torch.faults.generators import rram_leaves

    t_phase = time.perf_counter()
    cfg = dep.cfg
    batch = calibration_batch(cfg, CALIB_SAMPLES, CALIB_SEQ)
    result = {"healthy_mse": dep.logit_mse(batch)}
    pristine = [t.clone() for t in tree_lib.tensors(dep.codes)]
    # a key of its own for each class: the draws depend on the key and the
    # leaf path only, so one key would put the saturation caps on the very
    # cells retention has already brought down to the cap
    specs = [default_spec(kind, seed + 1 + i) for i, kind in enumerate(FAULT_CLASSES)]
    allocated0 = memory()[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dep.inject(specs)
    torch.cuda.synchronize()
    result["inject_seconds"] = time.perf_counter() - t0
    result["inject_peak_bytes"] = torch.cuda.max_memory_allocated()
    result["map_bytes"] = sum(t.numel() * t.element_size()
                              for lf in dep._fault_map.leaves.values()
                              for t in lf.fields().values())
    result["view_bytes"] = sum(t.numel() * t.element_size()
                               for t in tree_lib.tensors(dep.codes_view)
                               if t.dtype == torch.uint8)
    result["allocated_growth_bytes"] = memory()[0] - allocated0
    result["rram_weights"] = dep.rram_bytes() // 2
    log(f"[faults] inject({', '.join(s.kind for s in specs)}): "
        f"{result['inject_seconds']:.3f} s; the map {result['map_bytes'] / 2**30:.2f} GiB "
        f"({result['map_bytes'] / result['rram_weights']:.2f} B a weight over "
        f"{result['rram_weights']} weights), the view {result['view_bytes'] / 2**30:.2f} GiB; "
        f"allocated +{result['allocated_growth_bytes'] / 2**30:.2f} GiB, peak "
        f"{result['inject_peak_bytes'] / 2**30:.2f} GiB")
    assert all(torch.equal(a, b) for a, b in zip(pristine, tree_lib.tensors(dep.codes))), \
        "inject changed the pristine codes"
    del pristine
    view = dep.codes_view
    t0 = time.perf_counter()
    dep.inject(specs[0])
    torch.cuda.synchronize()
    result["reinject_seconds"] = time.perf_counter() - t0
    assert trees_equal(view, dep.codes_view), "re-injecting a spec changed the view"
    del view
    t0 = time.perf_counter()
    result["cpu_cells_compared"] = cpu_view_matches(dep, specs)
    log(f"[faults] pristine codes bitwise unchanged; re-injecting {specs[0].kind} "
        f"({result['reinject_seconds']:.3f} s) left the view bitwise as it was; the card's "
        f"view bitwise the CPU's from the same draws over {result['cpu_cells_compared']} "
        f"cells (first and last layer of every leaf, {time.perf_counter() - t0:.1f} s)")
    result["cap"] = cap_clamps(dep)
    assert result["cap"]["clamped_cells"] > 0, result["cap"]
    log(f"[faults] the saturation caps clamp {result['cap']['clamped_cells']} cells of "
        f"{result['cap']['capped_cells']} capped (the view without the caps differs there)")
    result["faulted_mse"] = dep.logit_mse(batch)
    log(f"[faults] logit MSE on the calibration batch: healthy {result['healthy_mse']:.5f}, "
        f"faulted {result['faulted_mse']:.5f}")
    assert result["faulted_mse"] > result["healthy_mse"], result

    result["serving"] = serve_faulted(dep, seed, healthy)

    # the drift clock runs on the pristine codes; the view re-pins
    stuck = {path: ((lf.stuck_mask_pos, lf.stuck_val_pos),
                    (lf.stuck_mask_neg, lf.stuck_val_neg))
             for path, lf in dep._fault_map.leaves.items() if lf.stuck_mask_pos is not None}
    before = {path: (x.g_pos.clone(), x.g_neg.clone())
              for path, x in rram_leaves(dep.codes) if path in stuck}
    dep.advance(FAULT_HOURS)
    codes, views = dict(rram_leaves(dep.codes)), dict(rram_leaves(dep.codes_view))
    pinned = moved = moved_under = 0
    for path, sides in stuck.items():
        for side, (mask, val) in enumerate(sides):
            got = (views[path].g_pos, views[path].g_neg)[side]
            now = (codes[path].g_pos, codes[path].g_neg)[side]
            assert torch.equal(got[mask], val[mask]), (path, side)
            pinned += int(mask.sum())
            moved += int((now != before[path][side]).sum())
            moved_under += int((now[mask] != before[path][side][mask]).sum())
    del before
    assert moved > 0 and moved_under > 0, (moved, moved_under)
    result["advance"] = {"stuck_cells": pinned, "pristine_cells_moved": moved,
                         "stuck_cells_whose_pristine_code_moved": moved_under}
    log(f"[faults] advance({FAULT_HOURS:g}): {pinned} stuck cells all still pinned in the view; "
        f"the pristine codes moved in {moved} cells ({moved_under} of them under a stuck cell)")

    # calibrate on the faulted base: no kernel, one capture
    mse_before = dep.logit_mse(batch)
    reset_counts()
    with timed_calibration() as times:
        t0 = time.perf_counter()
        report = dep.calibrate(CALIB_SAMPLES, steps=CALIB_STEPS, seq_len=CALIB_SEQ)
        torch.cuda.synchronize()
        t_calibrate = time.perf_counter() - t0
    counts = read_counts()
    expect_counts(counts, {})
    assert len(times["capture_s"]) == 1, times
    mse_after = dep.logit_mse(batch)
    log(f"[faults] {report.summary()}")
    log(f"[faults] calibrate on the faulted base: {t_calibrate:.3f} s, launches {counts}; "
        f"logit MSE {mse_before:.5f} -> {mse_after:.5f}")
    assert mse_after < mse_before, (mse_before, mse_after)
    result["calibrate"] = {"seconds": t_calibrate, "mse_before": mse_before,
                           "mse_after": mse_after, "losses": report.losses,
                           "launches": counts}
    result["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[faults] phase 8 (on the deployment) took {result['phase_seconds']:.2f} s")
    return result


@contextlib.contextmanager
def timed_restore():
    """Time ``Deployment.restore``'s parts from outside: the programming
    event, the drift replay's ticks and the injection (seconds), each
    closed by a synchronize. The program is not changed; the wrappers are
    removed on exit."""
    from repro_torch.deploy import deployment as D

    times = {"program": 0.0, "drift": 0.0, "inject": 0.0}
    originals = (D._program_trees, D.Deployment.advance, D.Deployment.inject)

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key] += time.perf_counter() - t0
            return out
        return run

    D._program_trees = timed(originals[0], "program")
    D.Deployment.advance = timed(originals[1], "drift")
    D.Deployment.inject = timed(originals[2], "inject")
    try:
        yield times
    finally:
        D._program_trees, D.Deployment.advance, D.Deployment.inject = originals


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def restored_equal(dep, restored):
    """What restore must give back bitwise, each named."""
    from repro_torch import tree as tree_lib

    opt = lambda d: [d.opt_state.step, *tree_lib.tensors(d.opt_state.mu),  # noqa: E731
                     *tree_lib.tensors(d.opt_state.nu)]
    return {
        "codes": trees_equal(dep.codes, restored.codes),
        "codes_view": trees_equal(dep.codes_view, restored.codes_view),
        "adapters": trees_equal(dep.adapters, restored.adapters),
        "opt_state": all(a.dtype == b.dtype and torch.equal(a, b)
                         for a, b in zip(opt(dep), opt(restored))),
        "step": dep.step == restored.step,
        "drift_hours": dep.drift_hours == restored.drift_hours,
        "fault_specs": ([s.to_dict() for s in dep.fault_specs]
                        == [s.to_dict() for s in restored.fault_specs]),
        "backend": dep.backend == restored.backend,
    }


def phase_persist(dep, device, workdir):
    """Phase 9's first half on phase 8's deployment (programmed, 24 h,
    calibrated, four fault classes, 300 h, calibrated again): snapshot it
    (seconds, bytes on disk beside 3 f32 trees of the adapter count),
    restore it on the card (seconds: program, drift replay, inject), and
    hold the restored deployment bitwise against it (codes, view,
    adapters, AdamW state, step, drift history, fault specs, backend) and
    its logit MSE on the calibration batch ``==``; then a second snapshot
    for the tampered-digest refusal and the refusal of a restore onto the
    CPU. Returns the result and the restored deployment."""
    from repro_torch.deploy import Deployment, calibration_batch
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = dep.cfg
    batch = calibration_batch(cfg, CALIB_SAMPLES, CALIB_SEQ)
    adapter_params = T.count_params({"base": dep.base, "adapters": dep.adapters})[1]
    result = {"adapter_params": adapter_params, "mse": dep.logit_mse(batch)}
    snap = os.path.join(workdir, "snapshot")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result["step"] = dep.snapshot(snap)
    result["snapshot_seconds"] = time.perf_counter() - t0
    result["snapshot_bytes"] = dir_bytes(snap)
    log(f"[persist] snapshot of step {result['step']}: {result['snapshot_seconds']:.3f} s, "
        f"{result['snapshot_bytes']} bytes on disk ({adapter_params} adapter params x 3 f32 "
        f"trees = {12 * adapter_params} bytes)")
    allocated0 = memory()[0]
    torch.cuda.reset_peak_memory_stats()
    with timed_restore() as parts:
        t0 = time.perf_counter()
        restored = Deployment.restore(cfg, snap, device=device)
        torch.cuda.synchronize()
        result["restore_seconds"] = time.perf_counter() - t0
    result["restore_parts"] = parts
    result["restore_peak_bytes"] = torch.cuda.max_memory_allocated()
    result["restored_bytes"] = memory()[0] - allocated0
    log(f"[persist] restore on {torch.cuda.get_device_name(0)}: "
        f"{result['restore_seconds']:.3f} s (program {parts['program']:.3f}, drift replay "
        f"{parts['drift']:.3f} over {len(restored.drift_hours)} ticks, inject "
        f"{parts['inject']:.3f} of {len(restored.fault_specs)} specs; the rest the digests "
        f"and the load); the restored deployment holds "
        f"{result['restored_bytes'] / 2**30:.2f} GiB, peak "
        f"{result['restore_peak_bytes'] / 2**30:.2f} GiB")
    result["equal"] = restored_equal(dep, restored)
    assert all(result["equal"].values()), result["equal"]
    result["restored_mse"] = restored.logit_mse(batch)
    assert result["restored_mse"] == result["mse"], (result["restored_mse"], result["mse"])
    log(f"[persist] bitwise the original: {', '.join(result['equal'])}; logit MSE "
        f"{result['restored_mse']:.5f} == {result['mse']:.5f}")

    # the refusals: a second snapshot whose digest is tampered with is
    # restored after the original is freed (phase_persist_serve); a restore
    # onto the CPU is refused before any work
    tampered = os.path.join(workdir, "tampered")
    dep.snapshot(tampered)
    meta_path = os.path.join(tampered, "deployment.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["codes_digest"] = ("0" if meta["codes_digest"][0] != "0" else "1") + \
        meta["codes_digest"][1:]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    result["tampered_dir"] = tampered
    t0 = time.perf_counter()
    try:
        Deployment.restore(cfg, snap, device="cpu")
    except ValueError as e:
        result["refused_cpu"] = str(e)
    assert "refused_cpu" in result, "a restore onto the CPU was not refused"
    log(f"[persist] restore onto the CPU refused in {time.perf_counter() - t0:.3f} s: "
        f"{result['refused_cpu']}")
    result["phase_seconds"] = time.perf_counter() - t_phase
    return result, restored


def prefix_run(session, prompts, entries):
    """``prompts`` one after another through a 4-slot engine of
    ``max_len`` 128 (phase 5's decode step, leased) with
    ``prefix_cache_entries=entries``, each run to its end: per request the
    tokens, TTFT, reused tokens, the staged cache and logits at admission
    (taken inside ``_finalize_admission``, patched on the instance) and
    the slot's cache row after the run; the launch counts, stats, the
    bytes the prefix cache holds and the peak memory."""
    from repro_torch import tree as tree_lib
    from repro_torch.deploy import ServeEngine

    gc.collect()
    engine = ServeEngine(session, max_slots=SLOTS, max_len=128, prefix_cache_entries=entries)
    admitted = {}
    finalize = engine._finalize_admission

    def record(slot, req):
        admitted[req.rid] = (engine._staging_flat.clone(), req._logits.clone())
        finalize(slot, req)

    engine._finalize_admission = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = []
    for prompt in prompts:
        req = engine.submit(prompt, max_new=PREFIX_NEW)
        engine.run()
        row = [t[:, 0].clone() if key == "body" else t[0].clone()
               for key, v in engine.cache.items() for t in tree_lib.tensors(v)]
        out.append({"tokens": list(req.tokens), "ttft_s": req.ttft_seconds,
                    "hit": req.prefix_hit_tokens, "admitted": admitted.pop(req.rid),
                    "row": row})
    torch.cuda.synchronize()
    run = {"requests": out, "launches": read_counts(), "stats": engine.stats(),
           "cache_bytes": engine.prefix_cache_bytes(),
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del engine._finalize_admission, engine, record
    gc.collect()
    return run


def prefix_traffic(body, session, seed):
    """Phase 9's prefix traffic on one session, through its warm graphs:
    ``PREFIX_TRAFFIC`` with the prefix cache on, then the same prompts
    with it off (every admission cold). Gated: the counters (5 lookups, 1
    full hit, 2 partial; 1 under codes_adc, which resumes only at chunk
    boundaries), the reused tokens, exact launch counts, the full
    hit and the chunk-boundary hit bitwise the cold admission (staged
    cache, admission logits, slot row after the run, tokens), the
    off-boundary hit's tokens equal and its logits within
    ``OFF_BOUNDARY_BOUND`` of their absmax, ``compile_count`` flat."""
    per_step = session.cfg.n_layers * (7 if body == "codes_adc" else 4)
    key = {"f32": "dora_linear_gemv", "int8": "dora_linear_gemv/int8",
           "codes_adc": "crossbar_mvm"}[body]
    g = torch.Generator().manual_seed(seed + 9)
    draw = lambda n: torch.randint(0, session.cfg.vocab, (n,), generator=g)  # noqa: E731
    heads = {"S": draw(PREFIX_SHARED), "P": draw(PREFIX_OFF)}
    tails = {n: draw(n) for n in sorted({t for _, _, t in PREFIX_TRAFFIC if t})}
    prompts = [torch.cat([heads[h]] + ([tails[t]] if t else [])).numpy()
               for _, h, t in PREFIX_TRAFFIC]
    compiled = session.compile_count()
    hit = prefix_run(session, prompts, 16)
    cold = prefix_run(session, prompts, 0)
    assert session.compile_count() == compiled == COMPILED_STEPS, session.compile_count()
    for run in (hit, cold):
        st = run["stats"]
        expect_counts(run["launches"], {key: per_step * (st["prefill_chunks"]
                                                         + st["decode_steps"])})
    st = hit["stats"]
    counters = (st["prefix_lookups"], st["prefix_hits"], st["prefix_partial_hits"],
                st["prefill_chunks"], cold["stats"]["prefill_chunks"])
    # codes_adc resumes only at chunk boundaries: P+23 is admitted cold
    reused = PREFIX_HIT_TOKENS[:-1] + [0 if body == "codes_adc" else PREFIX_HIT_TOKENS[-1]]
    chunks = lambda n, k: -(-(n - k) // PREFIX_SHARED)  # noqa: E731
    want = (len(prompts), sum(k == len(p) for k, p in zip(reused, prompts)),
            sum(0 < k < len(p) for k, p in zip(reused, prompts)),
            sum(chunks(len(p), k) for k, p in zip(reused, prompts)),
            sum(chunks(len(p), 0) for p in prompts))
    assert counters == want, (counters, want)
    assert [r["hit"] for r in hit["requests"]] == reused
    rows = []
    for i, ((name, _, _), h, c) in enumerate(zip(PREFIX_TRAFFIC, hit["requests"],
                                               cold["requests"])):
        (hc, hl), (cc, cl) = h["admitted"], c["admitted"]
        bitwise = (h["tokens"] == c["tokens"] and torch.equal(hc, cc) and torch.equal(hl, cl)
                   and all(torch.equal(a, b) for a, b in zip(h["row"], c["row"])))
        diff = float((hl.float() - cl.float()).abs().max())
        scale = float(cl.float().abs().max())
        rows.append({"request": name, "reused": h["hit"], "bitwise": bitwise,
                     "tokens_equal": h["tokens"] == c["tokens"],
                     "logits_max_abs_diff": diff, "logits_absmax": scale,
                     "ttft_s": h["ttft_s"], "cold_ttft_s": c["ttft_s"]})
        if h["hit"] in (0, len(prompts[i])) or h["hit"] % PREFIX_SHARED == 0:
            assert bitwise, rows[-1]  # cold, a full hit, or a chunk-boundary hit
        else:
            assert h["tokens"] == c["tokens"] and diff <= OFF_BOUNDARY_BOUND * scale, rows[-1]
    log(f"[persist] {body} prefix traffic: lookups {counters[0]}, full hits {counters[1]}, "
        f"partial {counters[2]}; chunks {counters[3]} with the cache vs {counters[4]} cold; "
        f"the cache holds {hit['cache_bytes']} bytes ({len(prompts)} requests), peak "
        f"{hit['peak_mem_bytes'] / 2**30:.2f} GiB vs {cold['peak_mem_bytes'] / 2**30:.2f} "
        f"cold; compile_count {session.compile_count()}")
    for r in rows:
        log(f"[persist]   {r['request']:>5} reuses {r['reused']:>2}: "
            f"{'bitwise the cold admission' if r['bitwise'] else 'NOT bitwise'} (logits "
            f"max|diff| {r['logits_max_abs_diff']:.3g} of {r['logits_absmax']:.3g}, tokens "
            f"{'equal' if r['tokens_equal'] else 'DIFFER'}); TTFT {1e3 * r['ttft_s']:.3f} ms "
            f"vs {1e3 * r['cold_ttft_s']:.3f} ms cold")
    return {"requests": rows, "counters": dict(zip(
        ("lookups", "hits", "partial_hits", "chunks", "cold_chunks"), counters)),
        "cache_bytes": hit["cache_bytes"], "peak_mem_bytes": hit["peak_mem_bytes"],
        "cold_peak_mem_bytes": cold["peak_mem_bytes"],
        "launches": hit["launches"], "cold_launches": cold["launches"]}


def phase_persist_serve(restored, device, seed, healthy, result):
    """Phase 9's second half, with the original freed: the tampered
    snapshot's restore raises after its replay; then the restored
    deployment served through all three bodies with phase 5's checks
    (``serve_faulted``), and on each body's session the prefix traffic."""
    from repro_torch.deploy import Deployment

    t_phase = time.perf_counter()
    try:
        Deployment.restore(restored.cfg, result["tampered_dir"], device=device)
    except ValueError as e:
        result["refused_digest"] = str(e)
    assert "refused_digest" in result, "a tampered digest was not refused"
    log(f"[persist] the tampered snapshot refused after its replay in "
        f"{time.perf_counter() - t_phase:.3f} s: {result['refused_digest']}")
    memory()
    result["serving"] = serve_faulted(
        restored, seed, healthy, label="restored",
        also=lambda body, session: prefix_traffic(body, session, seed))
    result["serve_seconds"] = time.perf_counter() - t_phase
    result["phase_seconds"] += result["serve_seconds"]
    log(f"[persist] phase 9 took {result['phase_seconds']:.2f} s")
    return result


def weight_sq_err(dep):
    """Sum over the RRAM leaves of the squared difference between the read
    back of ``dep``'s view and the teacher's weights (f64, one matrix at a
    time), and the cells where the view differs from the pristine codes."""
    from repro_torch import tree as tree_lib
    from repro_torch.core import rram
    from repro_torch.faults.generators import rram_leaves

    teacher = {}
    tree_lib.map_with_path(lambda path, x: teacher.setdefault(tree_lib.path_str(path), x),
                           dep.teacher_base)
    codes = dict(rram_leaves(dep.codes))
    err, changed = 0.0, 0
    for path, xw in rram_leaves(dep.codes_view):
        w = teacher[path]
        changed += int((xw.g_pos != codes[path].g_pos).sum())
        changed += int((xw.g_neg != codes[path].g_neg).sum())
        for i in range(w.shape[0]) if w.dim() == 3 else (Ellipsis,):
            r = rram.dequantize(rram.CrossbarWeight(xw.g_pos[i], xw.g_neg[i], xw.scale[i]))
            err += float(((r - w[i].float()).double() ** 2).sum())
    return err, changed


def phase_study(device, seed):
    """The fault-recovery study at full width and the paper's scale (10
    samples x 32 tokens, 20 steps), one fresh deployment per class, after
    0, 24 and 300 h of drift. Beside it, per class and age, the squared
    error of the weights read back against the teacher's, clean and
    faulted, on a deployment programmed, aged and faulted as the study's.
    Gated per class at every age: calibrated below faulted (the reference
    bench's gate), and faulted above clean exactly where the fault raised
    the weights' error. At 0 and 24 h, faulted above clean for every
    class. At 300 h a saturation cap also clips drift: at full column
    height it lowers the weights' error (``tools/fault_regimes.py``), and
    its logit MSE must then fall with it."""
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment
    from repro_torch.faults import FAULT_CLASSES, default_spec, fault_recovery_study

    cfg = get_arch("qwen3_1_7b").full
    out = {}
    for hours in STUDY_HOURS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        study = fault_recovery_study("qwen3_1_7b", smoke=False, seed=seed, hours=hours,
                                     device=device)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for kind in FAULT_CLASSES:
            r = study[kind]
            dep = Deployment.program(cfg, seed, backend="codes", device=device)
            dep.advance(hours)
            r["clean_weight_sq_err"], _ = weight_sq_err(dep)
            dep.inject(default_spec(kind, seed + 1))
            r["faulted_weight_sq_err"], r["cells_changed"] = weight_sq_err(dep)
            del dep
            r["faulted_above_clean"] = r["faulted_mse"] > r["clean_mse"]
            r["weights_worse"] = r["faulted_weight_sq_err"] > r["clean_weight_sq_err"]
            log(f"[study] {hours:g} h {kind:>16}: clean {r['clean_mse']:.5f} faulted "
                f"{r['faulted_mse']:.5f} calibrated {r['calibrated_mse']:.5f} (recovered "
                f"{r['recovered_fraction']:.1%}; {r['seconds']:.2f} s) | weights' squared "
                f"error clean {r['clean_weight_sq_err']:.6e} faulted "
                f"{r['faulted_weight_sq_err']:.6e} (x{r['faulted_weight_sq_err'] / r['clean_weight_sq_err']:.5f}"
                f"), {r['cells_changed']} cells changed")
        log(f"[study] qwen3-1.7b FULL, 10 samples x 32 tokens, 20 steps, {hours:g} h: "
            f"{seconds:.2f} s, peak {peak / 2**30:.2f} GiB")
        for kind in FAULT_CLASSES:
            r = study[kind]
            assert r["calibrated_mse"] < r["faulted_mse"], (hours, kind, r)
            assert r["faulted_above_clean"] == r["weights_worse"], (hours, kind, r)
            if hours < FAULT_HOURS:
                assert r["faulted_above_clean"], (hours, kind, r)
        out[f"{hours:g}h"] = {"classes": study, "seconds": seconds, "peak_mem_bytes": peak}
    return out


@contextlib.contextmanager
def paper_probes():
    """Watch phase 10's cells from outside: every ``feature_calibrate`` and
    ``backprop_calibrate`` call (seconds, the teacher and student trees
    cloned before and compared after, the losses or update count, the
    returned adapters and the calibration images), every step of each
    (ms, closed by a synchronize) and every ``accuracy`` call (seconds).
    The program is not changed; the wrappers are removed on exit."""
    from repro_torch.core import repro_experiments as rx
    from repro_torch.core import resnet

    calls = []
    step_ms = []
    eval_s = []
    saved = {name: getattr(rx, name) for name in
             ("feature_calibrate", "backprop_calibrate", "_feature_step", "_backprop_step")}
    accuracy = resnet.accuracy

    def leaves(tree):
        from repro_torch import tree as tree_lib

        out = {}
        tree_lib.map_with_path(lambda p, x: out.setdefault(tree_lib.path_str(p), x), tree)
        return out

    def unchanged(before, tree):
        now = leaves(tree)
        return before.keys() == now.keys() and all(torch.equal(before[p], now[p])
                                                   for p in before)

    def calibration(name, trees):
        fn = saved[name]

        def run(*args, **kwargs):
            kept = [{p: x.clone() for p, x in leaves(args[i]).items()} for i in trees]
            step_ms.append([])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append({"fn": name, "seconds": time.perf_counter() - t0, "out": out,
                          "images": args[3] if name == "feature_calibrate" else args[1],
                          "trees": [args[i] for i in trees],
                          "unchanged": [unchanged(k, args[i]) for k, i in zip(kept, trees)],
                          "step_ms": step_ms[-1]})
            return out
        return run

    def step(name):
        fn = saved[name]

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            step_ms[-1].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    def timed_accuracy(*args, **kwargs):
        t0 = time.perf_counter()
        out = accuracy(*args, **kwargs)
        eval_s.append(time.perf_counter() - t0)
        return out

    rx.feature_calibrate = calibration("feature_calibrate", (0, 1))   # teacher, student
    rx.backprop_calibrate = calibration("backprop_calibrate", ())
    rx._feature_step, rx._backprop_step = step("_feature_step"), step("_backprop_step")
    resnet.accuracy = timed_accuracy
    try:
        yield {"calls": calls, "eval_s": eval_s}
    finally:
        for name, fn in saved.items():
            setattr(rx, name, fn)
        resnet.accuracy = accuracy


def card_vs_cpu(label, got, want):
    """``got`` (card) within PAPER_CARD_VS_CPU of ``want``'s (CPU) absmax."""
    got, want = got.detach().cpu().float(), want.detach().float()
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    assert got.shape == want.shape and diff <= PAPER_CARD_VS_CPU * max(scale, 1e-30), (
        label, diff, scale)
    return diff / max(scale, 1e-30)


def paper_card_vs_cpu(teacher, student, adapters, cfg, probe, cal_x):
    """The port on the card against its own CPU path on the same
    parameters: the forward's features and logits on ``probe`` (with the
    calibrated adapters), and the calibration loss and its gradients on
    one calibration image. Returns the worst share of absmax of each."""
    from repro_torch import tree as tree_lib
    from repro_torch.core import repro_experiments as rx
    from repro_torch.core import resnet

    cpu = lambda tree: tree_lib.map_tensors(lambda x: x.detach().cpu(), tree)  # noqa: E731
    worst = {}
    with torch.no_grad():
        logits, aux = resnet.forward(student, probe, cfg, adapters=adapters,
                                     collect_features=True)
        c_logits, c_aux = resnet.forward(cpu(student), probe.cpu(), cfg,
                                         adapters=cpu(adapters), collect_features=True)
    worst["forward"] = max(card_vs_cpu(f"feature {i}", a, b) for i, (a, b) in
                           enumerate(zip(aux["features"] + [logits],
                                         c_aux["features"] + [c_logits])))

    def loss_and_grads(t, s, a, x):
        loss, _, grads = rx._value_and_grad(
            lambda ad: (rx.calibration_loss_resnet(t, s, ad, x, cfg), None), a)
        return [loss] + tree_lib.tensors(grads)

    card = loss_and_grads(teacher, student, adapters, cal_x)
    host = loss_and_grads(cpu(teacher), cpu(student), cpu(adapters), cal_x.cpu())
    worst["loss"] = card_vs_cpu("calibration loss", card[0], host[0])
    worst["grads"] = max(card_vs_cpu(f"gradient {i}", a, b)
                         for i, (a, b) in enumerate(zip(card[1:], host[1:])))
    return worst


def phase_paper(device, seed):
    """Phase 10, the paper's own experiment on the card at ResnetConfig():
    procedural data (``cell_data``), a teacher from ``train_teacher``'s
    defaults, then ``resnet_cell`` for DoRA r=2, LoRA r=2 and backprop on
    that teacher at drift 0.20 (10 samples, 20 epochs at batch 1), TF32
    off. Gated: teacher above 0.5, drifted at least 0.05 below it, each
    adapter cell's last loss below its first, DoRA calibrated above
    drifted, the teacher and student bitwise unchanged by DoRA and LoRA
    calibration, 200 backprop updates, no kernel launch over the phase,
    the trainable fraction 14,162 / 279,792, Table I at the paper's
    numbers, the card within 1e-4 of absmax of the CPU path (forward
    features and logits; the calibration loss and its gradients)."""
    from repro_torch.core import repro_experiments as rx
    from repro_torch.core import resnet, rram
    from repro_torch.deploy import resnet_cell
    from repro_torch.optim.adam import AdamW, adamw_init

    memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_phase = time.perf_counter()
    cfg = resnet.ResnetConfig()
    result = {"config": dataclasses.asdict(cfg), "cells": {}}
    with resnet.f32_convs():
        t0 = time.perf_counter()
        data = rx.cell_data(seed, cfg, device)
        torch.cuda.synchronize()
        result["data_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        teacher = rx.train_teacher(rram.make_generator(device, seed, rx.TEACHER), cfg,
                                   *data[:2])
        torch.cuda.synchronize()
        result["teacher_seconds"] = time.perf_counter() - t0
        log(f"[paper] ResNet-{cfg.depth} ({cfg.classes} classes, {cfg.image_size}x"
            f"{cfg.image_size}), {data[0].shape[0]} / {data[2].shape[0]} "
            f"images in {result['data_seconds']:.3f} s; teacher: 12 epochs x "
            f"{data[0].shape[0] // 128} steps of 128 in {result['teacher_seconds']:.2f} s")
        with paper_probes() as probes:
            for method in PAPER_METHODS:
                t0 = time.perf_counter()
                r = resnet_cell(method=method, rank=2, drift=PAPER_DRIFT, samples=PAPER_SAMPLES,
                                calib_epochs=PAPER_EPOCHS, cfg=cfg, teacher=teacher, data=data,
                                seed=seed, device=device)
                call = probes["calls"][-1]
                evals = probes["eval_s"][-3:]
                gap = r.teacher_acc - r.drifted_acc
                cell = dict(dataclasses.asdict(r), seconds=time.perf_counter() - t0,
                            calibrate_seconds=call["seconds"], eval_seconds=evals,
                            recovered=(r.calibrated_acc - r.drifted_acc) / gap if gap else None,
                            step_ms_median=statistics.median(call["step_ms"]),
                            steps=len(call["step_ms"]))
                if method == "backprop":
                    cell["updates"] = call["out"][1]
                else:
                    cell["losses"] = call["out"][1]
                    cell["teacher_unchanged"], cell["student_unchanged"] = call["unchanged"]
                result["cells"][method] = cell
                log(f"[paper] {method:>8}: teacher {r.teacher_acc:.4f} drifted "
                    f"{r.drifted_acc:.4f} calibrated {r.calibrated_acc:.4f} (recovered "
                    f"{cell['recovered']:.1%}); trainable {r.trainable_fraction:.4%}; "
                    f"calibration {call['seconds']:.2f} s, {cell['steps']} steps, median "
                    f"{cell['step_ms_median']:.2f} ms; evaluation "
                    f"{', '.join(f'{e:.3f}' for e in evals)} s; cell {cell['seconds']:.2f} s")
            dora_call = next(c for c in probes["calls"] if c["fn"] == "feature_calibrate")
        adapters = dora_call["out"][0]
        _, student = dora_call["trees"]
        probe = data[2][:PAPER_PROBE_IMAGES]
        result["card_vs_cpu"] = paper_card_vs_cpu(teacher, student, adapters, cfg, probe,
                                                  dora_call["images"][:1])
        # where a DoRA step's time goes: a warm step, then three profiled
        opt = AdamW(lr=2e-3)
        state = adamw_init(adapters)
        one = lambda: rx._feature_step(teacher, student, adapters, state,  # noqa: E731
                                       dora_call["images"][:1], cfg, opt)
        one()
        result["dora_step_trace"] = profile_window("paper", "DoRA step", 3, one)
    torch.cuda.synchronize()
    result["launches"] = read_counts()
    result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    n_ad, n_total = (resnet.param_count(adapters), resnet.param_count(teacher))
    result["trainable"] = (n_ad, n_total)
    result["table1"] = {
        "backprop_lifespan": rram.lifespan_calibrations(samples=120, epochs=20, batch=1,
                                                        on_rram=True),
        "dora_lifespan": rram.lifespan_calibrations(samples=10, epochs=20, batch=1,
                                                    on_rram=False),
        "speedup": rram.calibration_speedup(base_samples=125, dora_samples=10)}
    result["reference_cpu"] = PAPER_REFERENCE_ACC
    result["phase_seconds"] = time.perf_counter() - t_phase
    cells = result["cells"]
    ref = PAPER_REFERENCE_ACC
    log(f"[paper] beside the reference's own at this config, seed {seed}, on a CPU: teacher "
        f"{ref['teacher']} drifted {ref['drifted']} (examples/calibrate_resnet.py)")
    log(f"[paper] card vs CPU (of absmax): forward {result['card_vs_cpu']['forward']:.3g}, "
        f"loss {result['card_vs_cpu']['loss']:.3g}, gradients "
        f"{result['card_vs_cpu']['grads']:.3g}; trainable {n_ad} / {n_total}; launches "
        f"{result['launches']}; Table I {result['table1']}; peak "
        f"{result['peak_mem_bytes'] / 2**30:.3f} GiB; phase 10 took "
        f"{result['phase_seconds']:.2f} s")
    dora = cells["dora"]
    assert dora["teacher_acc"] > 0.5, dora
    assert dora["drifted_acc"] <= dora["teacher_acc"] - 0.05, dora
    assert dora["calibrated_acc"] > dora["drifted_acc"], dora
    for method in ("dora", "lora"):
        c = cells[method]
        assert c["losses"][-1] < c["losses"][0], (method, c["losses"])
        assert c["teacher_unchanged"] and c["student_unchanged"], method
    assert cells["backprop"]["updates"] == PAPER_EPOCHS * PAPER_SAMPLES, cells["backprop"]
    assert set(result["launches"].values()) == {0}, result["launches"]
    assert (n_ad, n_total) == PAPER_FRACTION, (n_ad, n_total)
    assert dora["trainable_fraction"] == PAPER_FRACTION[0] / PAPER_FRACTION[1], dora
    t1 = result["table1"]
    assert math.isclose(t1["backprop_lifespan"], 41666.67, rel_tol=1e-3), t1
    assert math.isclose(t1["dora_lifespan"], 5e13, rel_tol=1e-6), t1
    assert math.isclose(t1["speedup"], 1250.0, rel_tol=1e-6), t1
    return result

# ---------------------------------------------------------------------------
# phases 11 and 12: mixture-of-experts at full width, mixtral-8x22b (sliding
# window) and deepseek-v2-lite (MLA, a dense first layer, shared experts)
# ---------------------------------------------------------------------------

# kernel classes of a decode tick's profile (first match wins): the tiled
# bodies (MLA's _kup_vup over the whole latent cache; the int8 body's
# row scales come only from them at the decode tick), the router's f32-x
# bodies (the fused linear's and the ADC's narrow bodies), the tensor-core
# GEMV bodies (attention, the shared experts and the head; under codes_adc
# every leaf, _kup_vup's k_up and v_up too), cuBLAS (the expert products and
# the attention's einsums), and the experts' read-back: (G+ - G-) in int16,
# then one multiply into bf16
MOE_TICK_CLASSES = {
    "tiled_kup_vup": r"dora_mma_kernel|prep_tile_kernel|xa_finish_kernel"
                     r"|splitk_epilogue_kernel|row_scale_kernel",
    "router_f32x": r"dora_narrow_kernel|adc_narrow_kernel",
    "gemv_tensor_core": r"dora_gemv_mma_kernel|dora_gemv_int8_kernel|adc_mma_kernel",
    # u8 -> int16, the int16 difference, and the int16 x f32 -> bf16 multiply
    # (mixed types: PyTorch's generic, unvectorized elementwise kernel)
    "expert_readback": r"<short>|\(short\)|gpu_kernel_impl<at::native::BinaryFunctor<float, "
                       r"float, float, at::native::binary_internal::MulFunctor",
    "expert_products": r"gemm|Gemm|xmma|cutlass|nvjet|sm90_",
}


def moe_counts(cfg, steps, prefill, body):
    """The exact launches of ``steps`` engine steps (decode ticks and
    admission chunks, each at most 32 rows) and, with ``prefill``, one fused
    prefill of 96 rows. Per attention layer the fused qkv and o, or under
    MLA ``_q_kvd`` and o, through the GEMV launcher, and MLA's ``_kup_vup``
    over the whole latent cache (a decode tick's slots x 128 rows, a chunk's
    128 on the staging cache: the tiled launcher); per dense layer the
    fused gate_up and down; per MoE layer the router (f32 x, counted apart
    in the ``/f32x`` tally) and the shared experts' gate_up and down; the
    untied head once a step (the prefill's at 3 rows). The 96-row prefill
    runs every other leaf tiled. codes_adc runs every leaf unfused."""
    mla = cfg.attn.mla
    n_moe = sum(ffn == "moe" for _, ffn in cfg.layer_kinds())
    n_mlp = cfg.n_layers - n_moe
    shared = 1 if cfg.moe.n_shared else 0  # the shared experts' gated MLP
    if body == "codes_adc":  # q, kv_down, k_up, v_up, o or q, k, v, o; gate, up, down
        attn = 5 if mla else 4
        per_step = attn * cfg.n_layers + 3 * n_mlp + (1 + 3 * shared) * n_moe + 1
        return {"crossbar_mvm": (steps + prefill) * per_step,
                "crossbar_mvm/f32x": (steps + prefill) * n_moe}
    sfx = "" if body == "f32" else "/int8"
    per_layer = 2 * cfg.n_layers + 2 * n_mlp + (1 + 2 * shared) * n_moe  # GEMV-sized leaves
    tiled = cfg.n_layers if mla else 0                               # _kup_vup
    want = {f"dora_linear_gemv{sfx}": steps * (per_layer + 1) + prefill,
            f"dora_linear_gemv{sfx}/f32x": steps * n_moe,
            f"dora_linear{sfx}": steps * tiled}
    if prefill:
        want[f"dora_linear{sfx}"] += per_layer + tiled
        want[f"dora_linear{sfx}/f32x"] = n_moe
    return want


@dataclasses.dataclass(frozen=True)
class MoeCell:
    """One mixture-of-experts phase: the arch at ``layers`` of its
    ``of_layers``, where its first expert leaf lies (``expert_at``: prologue
    or body, index) and its shape, the engine traffic (``prompt_lens`` in a
    ``max_len`` cache, the steps it compiles, the decode tick's replay
    clocks) and the prompt of the chunked-admission vs token-loop check."""
    phase: int
    tag: str
    arch: str
    of_layers: int
    layers: int
    layout: tuple
    expert_at: tuple
    expert_shape: tuple
    prompt_lens: tuple
    max_len: int
    compiled: int
    decode_pos: tuple
    loop_prompt: int


MOE_CELL = MoeCell(11, "moe", "mixtral-8x22b", 56, MOE_LAYERS, (MOE_LAYERS, 0, 0),
                   ("prologue", 0), (8, 6144, 16384), MOE_PROMPT_LENS, MOE_MAX_LEN,
                   MOE_COMPILED_STEPS, MOE_DECODE_POS, MOE_PROMPT_LENS[-1])
MLA_CELL = MoeCell(12, "mla", "deepseek-v2-lite", 27, MLA_LAYERS, (1, MLA_LAYERS - 1, 0),
                   ("body", 0), (MLA_LAYERS - 1, 64, 2048, 1408), PROMPT_LENS, ENGINE_MAX_LEN,
                   COMPILED_STEPS, MLA_DECODE_POS, PROMPT_LENS[1])


def expert_stacks(base):
    """Every expert stack of a codes tree as an (E, d, k) CrossbarWeight: a
    scan-stacked body leaf (G, E, d, k) split on its scan axis."""
    from repro_torch.core.rram import CrossbarWeight
    from repro_torch.models import moe as M

    out = []

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for key, v in node.items():
                if key in M._STACKS and isinstance(v, CrossbarWeight):
                    if v.g_pos.dim() == 3:
                        out.append(v)
                    else:
                        out.extend(CrossbarWeight(*(t[i] for t in (v.g_pos, v.g_neg, v.scale)))
                                   for i in range(v.g_pos.shape[0]))
                else:
                    walk(v)

    walk(base)
    return out


def moe_calibrate(dep, cell):
    """Phase 7's calibration on the cell's deployment: ``calibrate(10,
    steps=20)`` through its CUDA graph; gated: no launch, one capture, the
    codes unchanged (their digest), the last feature MSE below the first,
    the graph's losses, adapters and AdamW state bitwise the eager step
    functions' from the same start. Reported: seconds, step ms captured vs
    eager, peak memory."""
    from repro_torch import tree as tree_lib
    from repro_torch.deploy import calibration_batch
    from repro_torch.deploy.deployment import code_digest
    from repro_torch.optim.adam import adamw_init

    tag = cell.tag
    digest = code_digest(dep.codes)
    start = tree_lib.map_tensors(torch.clone, dep.adapters)
    start = (start, adamw_init(start))
    memory()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with timed_calibration() as times:
        t0 = time.perf_counter()
        report = dep.calibrate(CALIB_SAMPLES, steps=CALIB_STEPS, seq_len=CALIB_SEQ)
        torch.cuda.synchronize()
        t_calibrate = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {report.summary()}")
    log(f"[{tag}] losses {', '.join(f'{x:.6f}' for x in report.losses)}")
    expect_counts(counts, {})
    assert code_digest(dep.codes) == digest, "calibrate changed the codes"
    assert all(math.isfinite(x) for x in report.losses), report.losses
    assert report.final_loss < report.initial_loss, report.losses
    assert len(times["capture_s"]) == 1 and len(times["step_ms"]) == CALIB_STEPS, times
    (built,) = times["steps"]
    memory()
    torch.cuda.reset_peak_memory_stats()
    eager_losses, eager_state, eager_ms = eager_calibration(
        dep, start, calibration_batch(dep.cfg, CALIB_SAMPLES, CALIB_SEQ), True,
        built["stream"], CALIB_STEPS)
    eager_peak = torch.cuda.max_memory_allocated()
    versus = graph_vs_eager(f"{cell.arch} cached step", report, dep, eager_state, eager_losses)
    assert versus["bitwise"], versus
    del eager_state, start
    steps_ms = times["step_ms"]
    result = {
        "report": report.to_dict(), "launches": counts, "calibrate_seconds": t_calibrate,
        "teacher_features_seconds": times["teacher_s"][0], "step_ms": steps_ms,
        "step_ms_median_2_on": statistics.median(steps_ms[1:]),
        "step_ms_median_3_on": statistics.median(steps_ms[2:]),
        "capture_seconds": times["capture_s"][0], "eager_step_ms": eager_ms,
        "eager_step_ms_median_2_on": statistics.median(eager_ms[1:]),
        "peak_mem_bytes": peak, "eager_peak_mem_bytes": eager_peak, "graph_vs_eager": versus,
    }
    log(f"[{tag}] calibrate {t_calibrate:.3f} s (teacher features "
        f"{result['teacher_features_seconds']:.3f} s, the capture "
        f"{result['capture_seconds']:.3f} s); step captured vs eager (median of steps "
        f"2-{CALIB_STEPS}) {result['step_ms_median_2_on']:.2f} vs "
        f"{result['eager_step_ms_median_2_on']:.2f} ms; step 1 {steps_ms[0]:.2f} ms, step 2 "
        f"{steps_ms[1]:.2f} ms; peak {peak / 2**30:.2f} GiB (eager steps "
        f"{eager_peak / 2**30:.2f} GiB)")
    return result


def moe_dense_oracle(session, device, seed, cell):
    """The first MoE layer's ``moe_block`` on the card (the f32 session's
    params: codes-resident stacks, the prepared router through the f32-x
    GEMV, merged side-cars, the shared experts) with capacity_factor = E /
    top_k, so no token is dropped: the dispatch path over
    ``MOE_ORACLE_TOKENS`` tokens against the dense path (every expert on
    every token, gate-weighted) on the same tokens as rows of one, within
    ``MOE_ORACLE_BOUND`` of absmax."""
    from repro_torch import substrate
    from repro_torch import tree as tree_lib
    from repro_torch.models import moe as M

    cfg = session.cfg
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    assert not M.can_drop(mcfg)
    where, i = cell.expert_at
    params = {name: session.params[name][where] for name in ("base", "adapters")}
    if where == "body":
        params = {name: tree_lib.index(tree, i)[0] for name, tree in params.items()}
    else:
        params = {name: tree[i] for name, tree in params.items()}
    base, adapters = params["base"]["ffn"], params["adapters"]["ffn"]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, MOE_ORACLE_TOKENS, cfg.d_model), generator=g, device=device)
    x = x.to(torch.bfloat16)
    with substrate.use_backend("codes"), torch.no_grad():
        y = M.moe_block(x, base, adapters, mcfg, cfg.adapter)
        dense = M.moe_block(x.reshape(MOE_ORACLE_TOKENS, 1, cfg.d_model), base, adapters, mcfg,
                            cfg.adapter).reshape(y.shape)
    out = compare_logits(f"{cell.arch} moe dispatch vs dense oracle, one layer", y, dense,
                         MOE_ORACLE_BOUND)
    log(f"[{cell.tag}] dispatch path ({MOE_ORACLE_TOKENS} tokens, capacity "
        f"{M.capacity_of(MOE_ORACLE_TOKENS, mcfg)} an expert) vs dense over all "
        f"{cfg.moe.n_experts} experts: max|diff| {out['max_abs_diff']:.4e} of absmax "
        f"{out['absmax']:.4f} (bound {MOE_ORACLE_BOUND:g})")
    return out


def moe_tick_profile(session, label, cell):
    """The captured decode tick (4 live slots at the cell's replay clocks)
    profiled over a few replays: device time by class (``MOE_TICK_CLASSES``),
    and the experts' read-back timed alone (the dequantize of every expert
    stack, CUDA events)."""
    from repro_torch.core.rram import dequantize
    from repro_torch.deploy import ServeEngine

    gc.collect()  # the drive's engines hand their lease back
    engine = ServeEngine(session, max_slots=SLOTS, max_len=cell.max_len)  # the warm step
    step = engine._decode
    host = torch.stack([torch.arange(SLOTS) + 7, torch.tensor(cell.decode_pos)])
    for _ in range(2):
        step(host)
    torch.cuda.synchronize()
    log(f"[{cell.tag}] {label}: profile of 4 captured decode ticks")
    trace = profile_window(cell.tag, "tick", 4,
                           lambda: torch.argmax(step(host)[:, -1], -1).cpu(),
                           classes=MOE_TICK_CLASSES)
    stacks = expert_stacks(session.params["base"])
    readback = time_ms([lambda: [dequantize(w, torch.bfloat16) for w in stacks]], reps=2)
    trace["expert_readback_ms_per_tick"] = readback
    log(f"[{cell.tag}] {label}: the experts' read-back alone ({len(stacks)} stacks of "
        f"{tuple(stacks[0].g_pos.shape)}) {readback:.3f} ms a tick")
    del engine
    return trace


def moe_serve_checked(dep, seed, calibrated, cell):
    """Phase 5's per-session checks on the cell's deployment: ``serve()``,
    ``serve(accum="int8")`` and a codes_adc deployment over the same
    teacher, codes and side-cars, each through ``drive`` with the cell's
    prompts and cache (first drive captures, a warm drive and an eager one
    with the same launches and streams, ``compile_count`` the cell's and
    flat, every graph's replay bitwise its eager step at the cell's clocks,
    the tick captured vs eager), exact launch counts (``moe_counts``) with
    the router's apart, codes vs dequant within ``LOGITS_BOUND`` (the fused
    prefill and one chunk per bucket), int8 vs f32 within
    ``INT8_LOGITS_BOUND``, ADC vs f32 reported; a profile of each session's
    captured tick; the dense oracle on the f32 session's first MoE layer."""
    from repro_torch.deploy import Deployment

    cfg, device, tag = dep.cfg, dep.device, cell.tag
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g) for n in cell.prompt_lens]
    tokens = torch.randint(0, cfg.vocab, (3, PREFILL_ROWS // 3), generator=g).to(device)
    runs, logits = {}, {}
    makers = (("f32", lambda: dep.serve()), ("int8", lambda: dep.serve(accum="int8")),
              ("codes_adc", lambda: Deployment(cfg, "codes_adc", dep.teacher_base, dep.codes,
                                               dep.adapters, dep.teacher_seed,
                                               dep.program_seed, dep.drift_hours).serve()))
    for body, make in makers:
        memory()
        torch.cuda.reset_peak_memory_stats()
        session = make()
        run, logits[body] = drive(session, prompts, tokens, MAX_NEW, max_len=cell.max_len,
                                  compiled=cell.compiled,
                                  decode_pos=torch.tensor(cell.decode_pos))
        steps = run["prefill_chunks"] + run["decode_steps"]
        expect_counts(run["launches_engine"], moe_counts(cfg, steps, 0, body))
        expect_counts(run["launches"], moe_counts(cfg, steps, 1, body))
        assert run["prefill_chunks"] == sum(-(-n // 32) for n in cell.prompt_lens), run
        run["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        run["memory_after_first_drive"] = {
            "allocated": run["registry_allocated_bytes"], "reserved": run["registry_reserved_bytes"]}
        if body == "f32":
            run["codes_vs_dequant"], run["chunk_logits_rel_diff"] = codes_vs_dequant(
                session, logits["f32"], tokens, g, device)
            run["dense_oracle"] = moe_dense_oracle(session, device, seed, cell)
        elif body == "int8":
            run["int8_vs_f32"] = compare_logits(f"{cell.arch} {calibrated}int8 vs f32 codes "
                                                "prefill logits", logits["int8"], logits["f32"],
                                                INT8_LOGITS_BOUND)
        else:
            run["adc_vs_f32"] = compare_logits(f"{cell.arch} {calibrated}codes_adc vs f32 codes "
                                               "prefill logits", logits["codes_adc"],
                                               logits["f32"])
            same = sum(a == b for ra, rb in zip(run["streams"], runs["f32"]["streams"])
                       for a, b in zip(ra, rb))
            run["greedy_tokens_equal_f32"] = same / sum(len(r) for r in run["streams"])
        longest = max(range(len(cell.prompt_lens)), key=lambda i: cell.prompt_lens[i])
        run["long_prompt_ttft_s"] = {"first": run["ttft_s"][longest],
                                     "warm": run["warm"]["ttft_s"][longest],
                                     "eager": run["eager"]["ttft_s"][longest]}
        run["trace"] = moe_tick_profile(session, body, cell)
        busy = run["trace"]["device_busy_ms_per_tick"]
        if busy is not None:
            run["trace"]["device_busy_share_of_unprofiled_tick"] = busy / run["tick"]["captured"]
        log(f"[{tag}] {body}: tick captured {run['tick']['captured']:.3f} ms vs eager "
            f"{run['tick']['eager']:.3f} ms; engine {run['warm']['decode_tok_per_s']:.1f} tok/s "
            f"captured vs {run['eager']['decode_tok_per_s']:.1f} eager; TTFT of the "
            f"{cell.prompt_lens[longest]}-token prompt {run['long_prompt_ttft_s']['warm']:.3f} s "
            f"warm, {run['long_prompt_ttft_s']['eager']:.3f} s eager, "
            f"{run['long_prompt_ttft_s']['first']:.3f} s in the first drive; "
            f"peak {run['peak_mem_bytes'] / 2**30:.2f} GiB; launches {run['launches']}")
        runs[body] = run
        del session
    return runs


def chunked_vs_loop(dep, seed, cell):
    """Chunked admission at full width, on a copy of the config with
    capacity_factor = E / top_k (no path drops a token): the cell's loop
    prompt through an engine of one slot (chunks of 32; mixtral's through
    the rolling canvas, then 16 greedy tokens across position 4096),
    against a token-by-token ``decode_step`` loop through the session's
    batch-1 decode graph (the engine's, leased again with a zeroed cache):
    the admission logits within ``LOGITS_BOUND`` of absmax of the loop's at
    the prompt's last position, and the engine's tokens the loop's greedy
    ones. The two compute the cache in other orders (chunk rows vs single
    rows: other GEMV plans and cuBLAS tilings, bf16 caches that differ in
    their last bits), so where the loop's argmax differs from the engine's
    token, the engine's token must lie within ``LOGITS_BOUND`` of absmax
    below the loop's top logit (a near-tie), and the loop then follows the
    engine's token; the flips are reported."""
    from repro_torch.deploy import Deployment, ServeEngine
    from repro_torch.models import moe as M

    cfg, tag = dep.cfg, cell.tag
    cfg4 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    assert not M.can_drop(cfg4.moe)
    session = Deployment(cfg4, "codes", dep.teacher_base, dep.codes, dep.adapters,
                         dep.teacher_seed, dep.program_seed, dep.drift_hours).serve()
    g = torch.Generator().manual_seed(seed + 11)
    prompt = torch.randint(0, cfg.vocab, (cell.loop_prompt,), generator=g).numpy()
    engine = ServeEngine(session, max_slots=1, max_len=cell.max_len)
    admitted = []
    finalize = engine._finalize_admission

    def record(slot, req):
        admitted.append((req._logits.clone(), engine._staging_flat.clone()))
        finalize(slot, req)

    engine._finalize_admission = record
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    req = engine.submit(prompt, max_new=MAX_NEW)
    engine.run()
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    assert req.done and len(req.tokens) == MAX_NEW
    del engine, record, finalize
    gc.collect()

    class Loop:
        pass

    owner = Loop()
    step = session.decode_step_fn(1, cell.max_len, owner=owner)  # zeroed cache
    assert step.graph is not None  # the engine's tick, captured
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = torch.zeros((2, 1), dtype=torch.int64)
    for i, tok in enumerate(prompt):
        host[0, 0], host[1, 0] = int(tok), i
        logits = step(host)
    loop_admission = logits.clone()
    cache = caches_agree(cfg4, cell, admitted[0][1], step.flat)
    tokens, flips = [], []
    for i, want in enumerate(req.tokens):
        row = logits[0, -1].float()
        tok = int(torch.argmax(row))
        tokens.append(tok)
        if tok != want:
            gap = float(row[tok] - row[want])
            flips.append({"index": i, "loop": tok, "engine": want, "gap": gap,
                          "absmax": float(row.abs().max())})
            assert gap <= LOGITS_BOUND * float(row.abs().max()), flips[-1]
        if i + 1 < MAX_NEW:
            host[0, 0], host[1, 0] = want, len(prompt) + i
            logits = step(host)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    versus = compare_logits(f"{cell.arch}: engine admission vs the token-by-token loop, "
                            f"{len(prompt)}-token prompt", admitted[0][0], loop_admission,
                            LOGITS_BOUND)
    chunks = -(-len(prompt) // 32)
    log(f"[{tag}] chunked admission: engine tokens {req.tokens}; loop's argmax {tokens} "
        f"({MAX_NEW - len(flips)} of {MAX_NEW} equal; near-ties {flips}); engine "
        f"{t_engine:.2f} s ({chunks} chunks + {MAX_NEW - 1} ticks), "
        f"token-by-token loop {t_loop:.2f} s ({len(prompt) + MAX_NEW - 1} replays, "
        f"{1e3 * t_loop / (len(prompt) + MAX_NEW - 1):.2f} ms each)")
    return {"engine_tokens": list(req.tokens), "loop_argmax": tokens, "near_tie_flips": flips,
            "admission_logits": versus, "cache_after_prompt": cache,
            "engine_seconds": t_engine, "loop_seconds": t_loop,
            "ttft_s": req.ttft_seconds}


def caches_agree(cfg, cell, staged, looped):
    """The caches after the loop prompt: the engine's staged cache (mixtral:
    each chunk's canvas gathered back into the rolling buffer) against the
    loop's (one write a token), layer by layer, per cache position over
    every leaf (K/V, or MLA's latent and rope key). Layer 0's come from the
    tokens alone, so a position holding another one's would differ by the
    order of absmax: gated within ``LOGITS_BOUND`` of absmax. Later layers'
    depend on earlier MoE layers, where a token whose router has a near-tie
    may go to another expert in one of the two (their router GEMVs sum in
    other orders): their per-position differences and the positions beyond
    the bound are reported."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import transformer as T

    like = T.init_cache(cfg, 1, cell.max_len, "meta")

    def layers(flat):
        views, off = [], 0
        for t in tree_lib.tensors(like):
            views.append(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        return T._cache_layers(tree_lib.unflatten(like, views), cfg)

    out = []
    for layer, (got, want) in enumerate(zip(layers(staged), layers(looped))):
        scale = max(float(want[n][0].abs().max()) for n in want)
        per_slot = torch.stack([(got[n][0].float() - want[n][0].float()).abs().flatten(1).amax(1)
                                for n in want]).amax(0)  # (T,)
        far = int((per_slot > LOGITS_BOUND * scale).sum())
        row = {"max_abs_diff": float(per_slot.max()), "absmax": scale,
               "rel": float(per_slot.max()) / scale, "slots": int(per_slot.numel()),
               "slots_beyond_bound": far,
               "median_slot_rel": float(per_slot.median()) / scale}
        log(f"[{cell.tag}] caches after the prompt, layer {layer} ({', '.join(want)}): max|diff| "
            f"{row['max_abs_diff']:.4f} of absmax {scale:.4f} ({row['rel']:.2e}; median slot "
            f"{row['median_slot_rel']:.2e}), {far} of {row['slots']} slots beyond "
            f"{LOGITS_BOUND:g} of absmax{' (gated)' if layer == 0 else ''}")
        out.append(row)
    assert out[0]["rel"] <= LOGITS_BOUND, out[0]
    return out


def phase_moe(device, seed, cell):
    """Phases 11 and 12: the cell's arch at its FULL widths, its depth cut.
    ``Deployment.program(codes)`` -> ``advance(24)`` -> ``calibrate`` -> the
    three sessions' serving checks -> the dense oracle -> chunked admission
    against the token loop. Every check raises."""
    from repro_torch.configs import get_arch
    from repro_torch.deploy import Deployment
    from repro_torch.models import transformer as T

    tag = cell.tag
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(cell.arch).full, n_layers=cell.layers)
    assert cfg.body_layout() == cell.layout, cfg.body_layout()
    memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dep = Deployment.program(cfg, seed, backend="codes", device=device)
    torch.cuda.synchronize()
    t_program = time.perf_counter() - t0
    t0 = time.perf_counter()
    dep.advance(24)
    torch.cuda.synchronize()
    t_advance = time.perf_counter() - t0
    n_base, n_adapters = T.count_params({"base": dep.codes, "adapters": dep.adapters})
    allocated, reserved = memory()
    where, i = cell.expert_at
    expert = dep.codes[where][i]["ffn"]["gate_w"]
    assert tuple(expert.g_pos.shape) == cell.expert_shape, expert.g_pos.shape
    result = {
        "layers": cell.layers, "body_layout": cfg.body_layout(),
        "program_seconds": t_program, "advance_seconds": t_advance,
        "program_peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "resident_allocated_bytes": allocated, "resident_reserved_bytes": reserved,
        "base_params": n_base, "adapter_params": n_adapters,
        "active_param_fraction": T.active_param_fraction(cfg, {"base": dep.codes,
                                                                "adapters": {}}),
        "rram_bytes": dep.rram_bytes(), "sram_bytes": dep.sram_bytes(),
        "teacher_bytes": tree_bytes(dep.teacher_base),
    }
    log(f"[{tag}] {cfg.name} at {cell.layers} of {cell.of_layers} layers (layout "
        f"{cfg.body_layout()}, expert leaf {cell.expert_shape}): {n_base:,} weights "
        f"({result['active_param_fraction']:.2%} active a token), {n_adapters:,} side-car "
        f"parameters; program {t_program:.2f} s (peak "
        f"{result['program_peak_mem_bytes'] / 2**30:.2f} GiB), advance(24) {t_advance:.2f} s; "
        f"resident {allocated / 2**30:.2f} GiB (teacher {result['teacher_bytes'] / 2**30:.2f}, "
        f"codes {result['rram_bytes'] / 2**30:.2f})")
    result["calibration"] = moe_calibrate(dep, cell)
    result["serving"] = moe_serve_checked(dep, seed, "calibrated ", cell)
    memory()
    result["chunked_vs_loop"] = chunked_vs_loop(dep, seed, cell)
    result["retained_bytes"] = memory()
    result["peak_mem_bytes"] = max(result["calibration"]["peak_mem_bytes"],
                                   *(r["peak_mem_bytes"] for r in result["serving"].values()))
    del dep
    memory()
    result["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase {cell.phase} took {result['phase_seconds']:.2f} s; peak "
        f"{result['peak_mem_bytes'] / 2**30:.2f} GiB (calibration "
        f"{result['calibration']['peak_mem_bytes'] / 2**30:.2f}); retained after the "
        f"chunked-admission check {result['retained_bytes'][0] / 2**30:.2f} GiB allocated, "
        f"{result['retained_bytes'][1] / 2**30:.2f} reserved")
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    smi = phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in exact f32
    device = torch.device("cuda")
    phase_build()
    t0 = time.perf_counter()
    worst = phase_kernels(device)
    log(f"[kernels] phase 3 took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rows = phase_timing(device)
    log(f"[timing] phase 4 took {time.perf_counter() - t0:.2f} s")
    breakdown = phase_breakdown(device)
    serving, sessions, dep = phase_serving(device, args.seed)
    for body, run in (("f32", serving), ("int8", serving["int8"]),
                      ("codes_adc", serving["codes_adc"])):
        log(f"[trace] {body}")
        run["trace"] = trace = phase_trace(sessions.pop(body))
        # the profiler slows the captured tick's wall down about 2x: the
        # busy share against phase 5's unprofiled captured tick
        busy = trace["captured"]["device_busy_ms_per_tick"]
        if busy is not None:
            trace["captured"]["device_busy_share_of_unprofiled_tick"] = (
                busy / run["tick"]["captured"])
            log(f"[trace] {body}: device busy {busy:.3f} ms of the unprofiled captured tick's "
                f"{run['tick']['captured']:.3f} ms ({busy / run['tick']['captured']:.1%})")
    gc.collect()
    torch.cuda.empty_cache()
    calibration = phase_calibrate(dep, device, args.seed)
    faults = phase_faults(dep, device, args.seed, serving)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        persist, restored = phase_persist(dep, device, workdir)
        del dep
        memory()
        persist = phase_persist_serve(restored, device, args.seed, serving, persist)
        del restored
    finally:
        shutil.rmtree(workdir)
    memory()
    faults["study"] = phase_study(device, args.seed)
    memory()
    paper = phase_paper(device, args.seed)
    memory()
    moe = phase_moe(device, args.seed, MOE_CELL)
    memory()
    mla = phase_moe(device, args.seed, MLA_CELL)
    zoo = (moe, mla)

    # one transformer layer: the four fused leaves at the decode tick (GEMV)
    # or the fused prefill (tiled), the seven unfused leaves at the decode
    # tick for the ADC, summed; launches from each body's serving session
    session_of = {"dora_linear_gemv": serving, "dora_linear": serving,
                  "dora_linear_gemv/int8": serving["int8"],
                  "dora_linear/int8": serving["int8"], "crossbar_mvm": serving["codes_adc"]}
    # phase 5's main path and those of phases 11 and 12 (the mixtral and
    # deepseek sessions of each body)
    moe_of = {"dora_linear_gemv": "f32", "dora_linear": "f32", "dora_linear_gemv/int8": "int8",
              "dora_linear/int8": "int8", "crossbar_mvm": "codes_adc"}
    launches = {name: run["launches"][name] + sum(z["serving"][moe_of[name]]["launches"][name]
                                                  for z in zoo)
                for name, run in session_of.items()}
    # the f32 body's f32-x launches are the narrow body's (every one of them
    # a router's, N <= 64), not the launcher's own kernels'
    narrow = {name: serving["launches"][name + "/f32x"]
              + sum(z["serving"]["f32"]["launches"][name + "/f32x"] for z in zoo)
              for name in ("dora_linear_gemv", "dora_linear")}
    for name, n in narrow.items():
        launches[name] -= n
    launches["dora_linear_narrow"] = sum(narrow.values())
    assert launches["dora_linear_narrow"] > 0, narrow
    # likewise the ADC's f32-x launches are its narrow body's (the routers')
    adc_narrow = (serving["codes_adc"]["launches"]["crossbar_mvm/f32x"]
                  + sum(z["serving"]["codes_adc"]["launches"]["crossbar_mvm/f32x"] for z in zoo))
    launches["crossbar_mvm"] -= adc_narrow
    launches["crossbar_mvm_narrow"] = adc_narrow
    assert adc_narrow > 0, adc_narrow
    # (name, source, TPU kernel, rows, leaf of the timed rows, timed kernel)
    table = (
        ("dora_linear_gemv", "dora_linear.cu", "dora_linear.py:194", SLOTS, None, None),
        ("dora_linear", "dora_linear.cu", "dora_linear.py:129", PREFILL_M, None, None),
        ("dora_linear_gemv/int8", "dora_linear.cu", "dora_linear.py:77", SLOTS, None, None),
        ("dora_linear/int8", "dora_linear.cu", "dora_linear.py:77", PREFILL_M, None, None),
        ("crossbar_mvm", "crossbar_mvm.cu", "crossbar_mvm.py:60", SLOTS, None, None),
        # the router's decode tick through the GEMV launcher, and the ADC's
        ("dora_linear_narrow", "dora_linear.cu", "dora_linear.py:46", SLOTS, "router",
         "dora_linear_gemv"),
        ("crossbar_mvm_narrow", "crossbar_mvm.cu", "crossbar_mvm.py:60", SLOTS, "router",
         "crossbar_mvm_narrow"),
    )
    kernels = []
    for name, source, replaces, m, leaf, timed in table:
        timed = timed or name
        mine = [r for r in rows if r["kernel"] == timed and r["m"] == m
                and (r["leaf"] == leaf if leaf else not r["leaf"].startswith("router"))]
        library = [r["library_ms"] for r in mine]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in mine)
            else "operations",
            "library_ms": None if None in library else sum(library),
        })
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "timing": rows, "breakdown": breakdown,
                       "serving": serving, "calibration": calibration, "faults": faults,
                       "persist": persist, "paper": paper, "moe": moe, "mla": mla,
                       "kernels": kernels},
                      f,
                      indent=1, default=str)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
