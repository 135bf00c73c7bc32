#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (video_tokenizer_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. build the CUDA kernels from csrc/ with nvcc for sm_90a (one nvcc per
     source, all started together); registers and spill bytes of the
     tensor-core kernels (the three wgmma flash kernels, the three 3xTF32
     flash kernels, the chunk and decode kernels, the streaming and the wgmma
     int8 matmuls, the 3xTF32 VQ search), which may not spill;
  2. the flash-attention forward kernels, out and LSE, against their plain
     PyTorch version on the card: the wgmma kernel (bf16, head dim 32 or 64,
     no segment ids) at the tokenizer's shape, the discriminator's ragged
     S = 1025 and the prior's causal NLL-forward shape, all from strided qkv
     views, causal with an offset, GQA, ragged Sk, D = 32 causal ragged, one
     row past a 128-row block, rows that see no key; the 3xTF32 kernel
     (fp32, D 32 or 64, no segment ids) at the tokenizer's B = 1 and
     training B = 8 shapes from strided views, the discriminator's, the
     frame-prediction AR trainer's causal B = 8, S = 2048, H = 20, causal
     with an offset, GQA, ragged Sk, D = 32 causal ragged, the block edge and
     rows that see no key, timed beside the earlier FMA kernel, SDPA fp32 and
     the efficient op with its LSE; the mma.sync / FMA kernel on D = 128 and
     segments with a no-match query; each case must run the kernel the
     dispatch rule names;
  3. the VQ search (3xTF32 on the tensor cores, the codebook split over a
     cluster) against its plain version (cos, l2, ragged, d = 4 to 32) and
     beside the earlier FMA kernel, planted exact ties (the lowest index
     wins across threads and splits), both bounds;
  4. the decode-attention kernels against their plain version at the 632M
     prior's sampling geometry (B = 16, H = 20, D = 64, S = 1152; bf16, int8
     and fp32 caches; pos 0, 511, 1024), plus GQA and key-valid cases,
     within about one ulp of the output, a bound that the plain version at
     pos - 1 or pos + 1 exceeds; a bf16 query over bf16 and int8 caches on
     the tensor-core kernel, fp32 and D = 128 on the earlier one; the new
     kernel timed cold (30 layers' caches) at pos 0, 511 and 1024, with two
     splits, beside the earlier kernel and SDPA;
  5. the int8 weight-matmul kernels against their plain version at every
     projection shape of the prior (M = 16 and 80) and its draft (M = 16),
     the NLL forward's M = 8192 and ragged M > 128 (200, 1000, 4097), bf16
     and fp32 x, both epilogues, each on the kernel the rule names (bf16 at
     M > 128 on the wgmma kernel, also held beside the earlier one) and
     repeatable bit for bit; wqkv at M = 8192 timed on the wgmma kernel,
     the earlier kernel and cuBLAS on a bf16 copy; one decode step's
     projections timed cold (distinct weights, 620 MB for the prior) beside
     the earlier kernel and cuBLAS on bf16 copies;
  6. tokenizer end to end in fp32 (TF32 off): the full-width flagship
     tokenizer, seeded and perturbed, on the card against the same weights
     on the CPU through the plain versions;
  7. tokenizer end to end in bf16: batch-8 reconstruction throughput, with
     the launch counters showing that every attention and VQ call ran the
     kernels;
  8. AR prior in fp32 (TF32 off): the full-width 632M llama-abs-LP prior,
     seeded and perturbed, prefill and 16 decode steps forced to the CPU's
     greedy tokens, card against CPU, with fp32 weights, int8 weights, and
     int8 weights + an int8 KV cache;
  9. AR sampling in bf16: class -> 1024 codes -> video at batch 8 with CFG
     1.5 and top-k 100 with bf16 weights, and 256 codes with int8 weights and
     int8 weights + int8 KV cache: tokens/s, device time per decode step (one step replayed
     as a CUDA graph, timed by CUDA events) against host wall time, kernels
     per step (torch.profiler), the NLL forward and decode_from_bottleneck,
     and exact launch counts (every decode attention on the tensor-core
     kernel, the decode-step projections on the int8 kernels the rule names,
     the NLL forward's 151 on the wgmma int8 kernel, every layer's row write
     inside its decode attention, no separate row write), one step timed
     with the row write fused and separate, and its kernels counted exactly
     as the kernel nodes of the step's captured CUDA graph (30 fewer fused);
     and 16 tokens with `emb_masks` (prompt positions masked as keys), whose
     prefill runs the segment-id flash forward;
 10. the flash backward kernels (dQ; dK/dV, after phase 2) against their
     plain backward: the tokenizer's shape from strided views, the
     discriminator's ragged S = 1025, the prior's causal shape, the
     frame-prediction AR trainer's (B = 8, S = 2048, H = 20), GQA 20/5,
     segments with a no-match query, causal with an offset, each also
     against the plain backward of the plain forward's out and LSE, dQ and
     dK/dV by the wgmma kernels (bf16) and the 3xTF32 kernels (fp32) wherever
     the dispatch rule says so (plus D = 32 causal ragged, Sq = 129 / Sk =
     257, rows that see no key, in both types), D = 128 and segment ids on
     the mma.sync / FMA kernels; timed by CUDA-graph replays beside the
     earlier kernels at the tokenizer's, discriminator's and prior's shapes,
     the 3xTF32 kernels at the fp32 tokenizer's and discriminator's beside
     SDPA's fp32 backward (efficient backend); gradients
     through `attention` under autograd; `attention_with_lse` refusing grad.
     The VQ kernel's stochastic mode (in phase 3): index for index against
     the plain Philox draw, and by frequency against softmax;
 11. tokenizer training in fp32 (TF32 off): one step of the full-width
     flagship generator, discriminator and LPIPS (`cfgs/larp_tokenizer.yaml`)
     at batch 1, card against CPU from the same weights and generators:
     losses, VQ indices, named gradients;
 12. tokenizer training through the port's trainer at batch 8, bf16 and
     fp32: s/step, clips/s, peak memory, exact launch counts of the four
     training-path kernels (in bf16 every flash forward, dQ and dK/dV launch
     on the wgmma kernels; in fp32 every forward, dQ and dK/dV on the 3xTF32
     kernels and none on the wgmma or FMA ones), device idle share and time by kernel
     category from torch.profiler, the card's clock and power under load;
 13. the chunk-attention kernel (the verify forward of speculative decoding)
     against its plain version at the 632M prior's verify shape (B = 16,
     G = 5, H = 20, D = 64, S = 1152) and the draft's (H = 12, G = 1 and 2),
     rows at positions 0..1024, bf16, fp32 and int8 caches, GQA, key-valid,
     each row within 1e-2 of its output's scale, a bound that the plain
     version at pos - 1 or pos + 1 exceeds; bf16 and int8 caches at head dim
     64 on the tensor-core kernel, timed beside the earlier kernel, which
     keeps fp32 caches and head dim 128;
 14. the per-row KV row-write kernel against its plain version: bf16, fp32
     and int8 caches, G = 1, 2, 5, uneven positions, strided row views: whole
     buffers equal bit for bit (the written rows and scales, and every other
     byte unchanged); then the row write fused into the decode and chunk
     kernels against the separate write + unfused kernel, bit for bit
     (buffers and outputs; B = 1, 2, 16, edge positions, masks), and its
     excess over the attention alone, timed over 30 layers' caches;
 15. `decode_chunk` against sequential `decode_step`s on the full-width prior
     in fp32 (TF32 off), forced tokens, rows at different positions, fp32 and
     int8 KV caches; greedy fp32 speculative decoding against `generate`;
 16. speculative sampling with the full-width pair (632M target, 8 x 768
     draft), batch 8, CFG 1.5, top-k 100, gamma 4, bf16 and int8 weights +
     int8 KV: the acceptance ceiling (zero heads, 1024 tokens: acceptance 1.0
     in exactly 205 iterations), the floor (independent sharp heads, 64
     tokens) and self-drafting with the prior's first 8 layers (64 tokens):
     tokens/s beside plain `generate`'s, acceptance, ms per iteration, device time of one
     iteration's forwards, exact launch counts (no one-token decode
     attention, every chunk attention on the tensor-core kernel with the row
     write fused, no separate row write), one host wait per iteration, the
     crossover acceptance;
 17. distillation of the full-width draft against the prior, 10 steps: the
     soft cross-entropy falls; launch counts of the flash forward, dQ and
     dK/dV kernels from the draft's 8 layers;
 18. the AR prior's two trainers (cfgs/larp_ar.yaml, larp_ar_fp.yaml) at the
     632M prior's full width, fed by the frozen flagship tokenizer from a
     checkpoint directory the tokenizer trainer wrote, fp32 (TF32 off): one
     step at batch 1 and 8 of the prior's 30 layers, card against CPU (loss, top-1/top-5, named
     gradients); batch 8 with the configured dropouts: s/step, training
     tokens/s, clips/s, peak memory, idle share and time by kernel category,
     exact launch counts (42 flash forwards, 30 dQ, 30 dK/dV, all 3xTF32,
     one VQ search); the train CLI's entry through one epoch, eval and the
     sample grid, whose `epoch-final` loads and samples on the card;
 19. the model_new family (conv-patchify, M-RoPE, FSQ) at full width
     (`phase_model_new`): the four shipped configs through their yaml in
     fp32 card against CPU at cut depth (FSQ indices >= 99%, reconstruction within 1e-3
     of its scale, decode_from_bottleneck == the forward's decode within
     1e-5); bf16 reconstruction at batch 8 of autoencoder_large and
     f256t768 (clips/s, peak memory, 48 and 36 wgmma flash forwards a
     batch, device time by category); one fp32 training step of
     cfgs/larp_tokenizer_large.yaml card against CPU (losses, FSQ indices,
     named gradients); training throughput through the trainer, bf16 at
     batch 8 and fp32 at batch 4 (72 flash forwards, 56 dQ + 56 dK/dV a
     step, 72 + 72 on a discriminator step, all wgmma / all 3xTF32); the
     train CLI with eval and vis, and the reconstruct CLI on its checkpoint.
     Phases 2 and 10 hold the flash kernels at this family's shapes (H = 16
     at S = 2048; H = 8 at 2304; H = 12 at 512 and 1792), v a strided view
     of the 4C-wide q, k, v, gate projection;
 20. FVD (`phase_fvd`, run before phase 18, which scores its AR samples
     against this phase's real stats): the seeded full Kinetics-400 I3D
     card against CPU (features, and each Mixed block on the CPU's input)
     and its clips/s at batch 16; the eval CLI on the flagship tokenizer
     (bf16, batch 16, null128: clips/s, device ms per batch by stage, peak
     memory, 192 wgmma flash forwards and 8 VQ searches), after the
     evaluator's first 2 clips in fp32 card against CPU; the merge CLI on
     its stats in two shards; the tokenizer trainer's eval rFVD and best
     checkpoint over two epochs; `sample.py --csv_file null128` as one job
     (shards, flags, the report row, 30,690 decode attentions).
 21. the STAT family and the LARP tokenizer's fsq and sq bottlenecks
     (`phase_stat_lattice`, after phase 19): the VQ kernel at the Leech
     codebook's shape (M = 8192 and 1024, K = 196,560, d = 24, cos) against
     its plain version, timed beside `(z @ e.T).argmax`, planted ties;
     cfgs/larp_tokenizer.yaml with bottleneck_type sq and fsq at full width
     (176,778,648 and 172,035,078 parameters), fp32 card vs CPU at 4 + 4 of
     the 12 + 12 layers and bf16 reconstruction at batch 8 (one VQ search per
     sq encode); the STAT model of cfgs/larp_tokenizer_stat.yaml (185,850,633
     parameters): fp32 card vs CPU block by block at 4 + 4 of its 12 + 12
     layers, bf16 reconstruction, one fp32 training step card vs CPU at 4 + 4
     layers, bf16 training at batch 8 and
     `train.py` through the vanilla, random_drop and adaptive stages; LARP-sq
     training through `train.py`, its frozen codebook unchanged and in no
     optimizer; exact launch counts throughout.
 22. LARP's learned AR prior co-trained as scripts/train_larp_tokenizer.sh
     trains it (`phase_prior`): gptc-S (12 layers of 384, 6 heads of 64) in
     fp32 card against CPU at 4 of its layers (`compute_prior_loss` at B = 8
     from 1024 latents and every gradient, exactly 4 3xTF32 forwards, 4 dQ
     and 4 dK/dV; `decode_step` against the full forward); one fp32 step of the recipe
     through the trainer, card against CPU, at 2 + 2 tokenizer layers with
     gptc-S and the 512 / 8 / 12 discriminator at 4 of their 12 layers, `prior_lr_mult` 50 and
     `emb_lr_mult` 2 (losses, VQ indices, gradients, the parameters after the
     step per learning-rate group); a `grad_accum_steps` 2 step at batch 8
     against the plain one; bf16 training at full width, batch 8 (s/step,
     memory, idle share, the prior's share, exact launch counts: 60 wgmma
     forwards, 36 + 36 wgmma dQ / dK/dV and 24 + 24 more on a discriminator
     step, 12 + 12 + 12 3xTF32 for the prior); `train.py` with the script's
     flags for one epoch, resumed from its `epoch-last`, its `epoch-final`
     through `reconstruct` and as the AR trainer's frozen tokenizer. Phases
     2 and 10 hold the flash kernels at the prior's shape (B = 8, S = 1023,
     H = 6, D = 64, causal, fp32) and the 512-wide discriminator's (B = 8,
     S = 1025, H = 8, D = 64, bf16), timed beside the efficient-attention
     op / SDPA and their backward.
 23. the trainer's own behaviour, `spectral_norm` and R1, and the
     model_basic family (`phase_trainer_basic`): (a) the flagship trainer
     (bf16, batch 8, 4 steps an epoch, 2 epochs, the discriminator on) run
     whole with `profile_steps: 2` and the TensorBoard writer, run again for
     the spread of two runs, cut by SIGTERM in epoch 2 (SystemExit(0),
     `epoch-last` with the rolled-back epoch, `resume_skip_steps` and
     `preempted`) and resumed: the resumed run applies exactly the batches
     the cut one had not, in the uninterrupted run's order, with Adam's step
     counts equal and parameters within the spread; the trace holds 2 steps
     with the wgmma flash and VQ kernels by name; the writer wrote `train/`
     scalars or said it is unavailable; (b) the flagship's discriminator
     (384 wide, 12 heads, 8 layers, S = 1025) in fp32 card against CPU at
     batch 2 with `spectral_norm`, R1 (0.01) and both: D loss, `r1_gp` and
     every gradient within 1e-3 of their scale; bf16 trainer steps at
     batch 8 with each option alone beside the plain step, exact flash launches
     (with R1 none in the discriminator, the tokenizer's unchanged); (c) the
     five model_basic registrations at their full width (768 wide, 5 + 5
     layers, 12 heads of 64) in fp32 card against CPU at batch 1 (FSQ
     indices >= 99%, the decode within phase 19's rule, exact 3xTF32 flash
     launches), bf16 reconstruction clips/s at batch 8 of `autoencoder` and
     `autoencoder_dualpatch`, and bf16 training of `autoencoder` through the
     tokenizer trainer with cfgs/larp_tokenizer_large.yaml's loss and
     optimizer (s/step, exact dQ and dK/dV launches, the idle share).
Every kernel phase also times one PyTorch call that computes the same
function (`library_ms`: SDPA and its autograd backward, a matmul + argmax,
`index_put_`), which the port uses nowhere, and computes the kernel's bound
from the published peaks (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s fp32, and
for the 3xTF32 kernel three TF32 products per product at 494.7 TFLOP/s).
Prints the training, sampling and every kernel's numbers as JSON lines, the
card's name and power limit, and last {"ok": true, "device": {...}}. Needs
one CUDA device.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() over `iters` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time of one fn() with no host gaps: `launches` calls captured in
    a CUDA graph, replayed, timed by CUDA events. For kernels shorter than
    the host's launch path, where events around eager calls time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up outside the capture (allocator, cuBLAS)
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def graph_kernels(fn) -> int:
    """The exact number of kernels one fn() launches: fn captured once as a
    CUDA graph (kept, not instantiated), whose kernel nodes are counted
    through libcuda (cuGraphGetNodes, cuGraphNodeGetType). Memset, copy
    and event nodes are not kernels; a child-graph or conditional node is
    refused, since its kernels would go uncounted."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up outside the capture (allocator, cuBLAS)
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    require(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    require(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int()
        require(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0,
                "cuGraphNodeGetType failed")
        types.append(t.value)
    # CUgraphNodeType: 0 kernel, 4 child graph, 13 conditional
    require(not {4, 13} & set(types), f"captured graph has child-graph or conditional nodes: {types}")
    graph.reset()
    return types.count(0)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peaks (dense)
# "tf32x3": an fp32 product as three TF32 products, at 494.7 TFLOP/s dense TF32
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32x3": 494.7e12 / 3}


def bound(n_bytes: float, flops: float = 0.0, kind: str = "bf16") -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once) over
    the memory rate and its operations over the peak rate for their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def phase_build() -> None:
    from video_tokenizer_tpu_torch.ops import _build

    build = _build.build()
    _build.library()
    log(f"[build] {build.path.relative_to(ROOT)} built by nvcc for sm_90a "
        f"in {build.seconds:.1f} s from {', '.join(s.name for s in _build._sources())}")
    for line in build.log.splitlines():
        if ("Used" in line or ("spill" in line and " 0 bytes spill stores" not in line)
                or "Performance Loss" in line):  # e.g. wgmma serialised by ptxas
            log(f"[build]   {line.strip()}")
    # the tensor-core kernels: the wgmma and 3xTF32 flash kernels (forward,
    # dQ, dK/dV) per head dim, the chunk kernel per cache type and number of 16-row tiles, the
    # decode kernel per cache type and KV heads per block, the streaming int8
    # matmul per x type and number of 8-row tiles, the wgmma int8 matmul, the
    # 3xTF32 VQ search per code dim and mode;
    # accumulators spilled to local memory would be re-read on every product
    expected = {f"flash_{k}_sm90_kernel<{d}>" for k in ("fwd", "bwd_dq", "bwd_dkv") for d in (32, 64)}
    expected |= {f"chunk_attn_sm90_kernel<{c}, {m}>" for c in ("bf16", "int8") for m in (1, 2)}
    expected |= {f"decode_attn_sm90_kernel<{c}, {h}>" for c in ("bf16", "int8") for h in (1, 2)}
    expected |= {f"w8_stream_kernel<{x}, {t}>" for x in ("bf16", "fp32")
                 for t in (1, 2, 4, 6, 8, 10, 16)}
    expected |= {f"flash_{k}_tf32x3_kernel<{d}>" for k in ("fwd", "bwd_dq", "bwd_dkv")
                 for d in (32, 64)} | {"w8_sm90_kernel"}
    expected |= {f"vq_tc_kernel<{d}, {mode}>" for d in (4, 8, 16, 24, 32)
                 for mode in ("argmax", "gumbel")}
    types = {"13__nv_bfloat16": "bf16", "a": "int8", "f": "fp32"}
    seen = set()
    for name, (regs, spill) in sorted(_build.kernel_resources(build.log).items()):
        if m := re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_(?:sm90|tf32x3)_kernel)ILi(\d+)E+v",
                          name):
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif "w8_sm90_kernel" in name:
            kernel = "w8_sm90_kernel"
        elif m := re.search(r"vq_tc_kernelILi(\d+)ELb([01])E", name):
            kernel = f"vq_tc_kernel<{m.group(1)}, {('argmax', 'gumbel')[int(m.group(2))]}>"
        elif m := re.search(r"(chunk_attn_sm90_kernel|w8_stream_kernel|decode_attn_sm90_kernel)"
                            r"I(13__nv_bfloat16|a|f)Li(\d+)E+v", name):
            kernel = f"{m.group(1)}<{types[m.group(2)]}, {m.group(3)}>"
        else:
            continue
        seen.add(kernel)
        log(f"[build]   {kernel}: {regs} registers, {spill} spill bytes")
        require(spill == 0, f"{kernel} spills {spill} bytes")
    require(seen == expected, f"tensor-core kernels in the build log: {sorted(seen)}, "
                              f"expected {sorted(expected)}")


def phase_flash(records: dict) -> None:
    import torch
    import torch.nn.functional as F

    from video_tokenizer_tpu_torch.ops.attention import (
        DEFAULT_MASK_VALUE, _fwd_launch, attention_reference, flash_attn_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # (name, B, Sq, Sk, H, Hkv, D, dtype, causal, offset, segments, tol). out is
    # held to tol of max|plain| (at S = 2048 a typical |out| is a few 1e-2, so
    # an absolute bound would pass a wrong P.V): bf16 kernel vs the fp32 plain
    # version (output rounded to bf16 on both sides, P rounded to bf16 in the
    # kernel) 2e-2, fp32 1e-4. The LSE is fp32 from fp32 sums in every case
    # and is held to 1e-4 absolute. "discriminator" is the training path's
    # ragged S = 1 + 1024 (a partial last query and key tile).
    cases = [
        ("flagship", 8, 2048, 2048, 12, 12, 64, torch.bfloat16, False, None, False, 2e-2),
        ("discriminator", 8, 1025, 1025, 12, 12, 32, torch.bfloat16, False, None, False, 2e-2),
        ("ar_nll_causal", 8, 1024, 1024, 20, 20, 64, torch.bfloat16, True, None, False, 2e-2),
        ("causal_offset", 2, 384, 512, 4, 4, 64, torch.bfloat16, True, 100, False, 2e-2),
        ("segments_no_match", 2, 512, 512, 4, 4, 64, torch.bfloat16, False, None, True, 2e-2),
        ("gqa_4_over_2", 2, 512, 512, 4, 2, 64, torch.bfloat16, False, None, False, 2e-2),
        ("ragged_sk", 2, 300, 1000, 4, 4, 64, torch.bfloat16, False, None, False, 2e-2),
        ("fp32", 1, 2048, 2048, 12, 12, 64, torch.float32, False, None, False, 1e-4),
        # fp32 at D 32 / 64 without segment ids: the training shape (B = 8),
        # the discriminator's, the prior's causal one, then the mask cases
        ("fp32_train", 8, 2048, 2048, 12, 12, 64, torch.float32, False, None, False, 1e-4),
        ("fp32_discriminator", 8, 1025, 1025, 12, 12, 32, torch.float32, False, None, False, 1e-4),
        ("fp32_prior_causal", 2, 1024, 1024, 20, 20, 64, torch.float32, True, None, False, 1e-4),
        # the frame-prediction AR trainer's: 1025 condition + 1023 code tokens
        ("fp32_ar_fp_train", 8, 2048, 2048, 20, 20, 64, torch.float32, True, None, False, 1e-4),
        ("fp32_causal_offset", 2, 384, 512, 4, 4, 64, torch.float32, True, 100, False, 1e-4),
        ("fp32_gqa_4_over_2", 2, 512, 512, 4, 2, 64, torch.float32, False, None, False, 1e-4),
        ("fp32_ragged_sk", 2, 300, 1000, 4, 4, 64, torch.float32, False, None, False, 1e-4),
        ("fp32_causal_ragged_d32", 2, 300, 333, 4, 4, 32, torch.float32, True, None, False, 1e-4),
        ("fp32_edge_129_257", 2, 129, 257, 4, 4, 64, torch.float32, False, None, False, 1e-4),
        ("fp32_causal_no_key_rows", 1, 300, 300, 2, 2, 64, torch.float32, True, -70, False, 1e-4),
        ("fp32_segments", 2, 512, 512, 4, 4, 64, torch.float32, False, None, True, 1e-4),
        ("lse_fp32", 2, 384, 200, 4, 2, 128, torch.float32, True, 50, True, 1e-4),
        ("lse_bf16", 2, 384, 512, 4, 4, 32, torch.bfloat16, False, None, True, 2e-2),
        ("causal_ragged_d32", 2, 300, 333, 4, 4, 32, torch.bfloat16, True, None, False, 2e-2),
        # one query row and one key past a 128-row block / a 64-key tile
        ("edge_129_257", 2, 129, 257, 4, 4, 64, torch.bfloat16, False, None, False, 2e-2),
        # queries 0..69 see no key: uniform attention, LSE = the mask value
        ("causal_no_key_rows", 1, 300, 300, 2, 2, 64, torch.bfloat16, True, -70, False, 2e-2),
        # the model_new stacks: autoencoder_large (H = 16, S = 2048), the
        # f256t1024a decoder (H = 8, S = 2304), the f256t* first-frame
        # encoders (H = 12, S = 512) and the f256t512 decoder (S = 1792);
        # bf16 at the reconstruction batch, fp32 at batch 4 and 1
        ("model_new_large", 8, 2048, 2048, 16, 16, 64, torch.bfloat16, False, None, False, 2e-2),
        ("model_new_h8_s2304", 8, 2304, 2304, 8, 8, 64, torch.bfloat16, False, None, False, 2e-2),
        ("model_new_h12_s512", 8, 512, 512, 12, 12, 64, torch.bfloat16, False, None, False, 2e-2),
        ("model_new_h12_s1792", 8, 1792, 1792, 12, 12, 64, torch.bfloat16, False, None, False,
         2e-2),
        ("fp32_model_new_large", 4, 2048, 2048, 16, 16, 64, torch.float32, False, None, False,
         1e-4),
        ("fp32_model_new_h8_s2304", 1, 2304, 2304, 8, 8, 64, torch.float32, False, None, False,
         1e-4),
        ("fp32_model_new_h12_s512", 1, 512, 512, 12, 12, 64, torch.float32, False, None, False,
         1e-4),
        # the LARP recipe's (phase 22): the gptc-S prior, causal over the 1023
        # shifted latents, fp32 whatever the tokenizer computes in, q, k, v
        # from three projections; the 512-wide discriminator, 8 heads of 64
        ("fp32_gptc_prior", 8, 1023, 1023, 6, 6, 64, torch.float32, True, None, False, 1e-4),
        ("disc512", 8, 1025, 1025, 8, 8, 64, torch.bfloat16, False, None, False, 2e-2),
    ]
    # the cases that must run the wgmma kernel (bf16, D = 32 or 64, no segment
    # ids) and the 3xTF32 kernel (the same in fp32); D = 128 and segment ids
    # stay on the mma.sync / FMA kernel
    sm90_cases = {"flagship", "discriminator", "ar_nll_causal", "causal_offset", "gqa_4_over_2",
                  "ragged_sk", "causal_ragged_d32", "edge_129_257", "causal_no_key_rows",
                  "model_new_large", "model_new_h8_s2304", "model_new_h12_s512",
                  "model_new_h12_s1792", "disc512"}
    tf32x3_cases = {c[0] for c in cases if c[7] == torch.float32 and c[6] != 128 and not c[10]}
    strided = {"flagship", "discriminator", "ar_nll_causal", "fp32_train", "fp32_discriminator",
               "fp32_prior_causal", "fp32_ar_fp_train", "disc512"}
    lse_tol = 1e-4
    for name, B, Sq, Sk, H, Hkv, D, dtype, causal, offset, with_seg, tol in cases:
        if name in strided:
            # q, k, v as strided views of one [B, S, 3, H, D] qkv projection
            qkv = randn(B, Sq, 3, H, D, dtype=dtype)
            q, k, v = qkv.unbind(2)
        elif "model_new" in name:
            # the gated block's: q and k fresh from LayerNorm + RoPE, v a view
            # of the 4C-wide q, k, v, gate projection (row stride 4 * H * D)
            q, k = randn(B, Sq, H, D, dtype=dtype), randn(B, Sk, H, D, dtype=dtype)
            v = randn(B, Sk, 4, H, D, dtype=dtype)[:, :, 2]
        else:
            q = randn(B, Sq, H, D, dtype=dtype)
            k, v = randn(B, Sk, Hkv, D, dtype=dtype), randn(B, Sk, Hkv, D, dtype=dtype)
        q_seg = k_seg = None
        if with_seg:
            k_seg = (torch.arange(Sk, device="cuda") >= Sk // 3).int().expand(B, Sk).contiguous()
            q_seg = (torch.arange(Sq, device="cuda") >= Sq // 3).int().expand(B, Sq).contiguous()
            q_seg[:, 5] = 7  # matches no key: uniform attention
        kw = dict(causal=causal, segment_ids=q_seg, kv_segment_ids=k_seg, causal_offset=offset)
        got, got_lse = flash_attn_fwd(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        kernel = flash_attn_fwd.last_kernel
        want, want_lse = attention_reference(q, k, v, causal, q_seg, k_seg, None, offset)
        err = (got.float() - want.float()).abs().max().item()
        rel_err = err / want.float().abs().max().item()
        lse_err = (got_lse - want_lse).abs().max().item()
        require(torch.isfinite(got).all().item() and torch.isfinite(got_lse).all().item(),
                f"flash {name}: non-finite output")
        log(f"[flash] {name}: B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} {str(dtype)[6:]} "
            f"{kernel}: max|kernel-plain| {err:.3e} = {rel_err:.3e} of max|plain| (tol {tol:g}), "
            f"lse {lse_err:.3e} (tol {lse_tol:g})")
        require(kernel == ("flash_fwd_sm90_kernel" if name in sm90_cases else
                           "flash_fwd_tf32x3_kernel" if name in tf32x3_cases else "flash_fwd_kernel"),
                f"flash {name}: ran {kernel}")
        require(rel_err <= tol and lse_err <= lse_tol,
                f"flash {name}: error {rel_err} of max|plain| > {tol} or lse {lse_err} > {lse_tol}")
        # queries that see no key: LSE = the mask value (their out, the mean of V, is
        # held by the comparison above)
        blind = [5] if with_seg else list(range(-offset)) if causal and (offset or 0) < 0 else []
        require((got_lse[:, :, blind] == DEFAULT_MASK_VALUE).all().item(),
                f"flash {name}: LSE of the rows that see no key is not the mask value")
        require(torch.equal(flash_attn_fwd(q, k, v, **kw), got), f"flash {name}: lse changes out")
        if name in ("flagship", "discriminator", "ar_nll_causal", "fp32", "fp32_train",
                    "model_new_large", "fp32_gptc_prior", "disc512"):
            # device time: CUDA-graph replays (CUDA events around one eager
            # call would add the host's launch path, ~0.05 ms)
            ms = graph_ms(lambda: flash_attn_fwd(q, k, v, causal=causal), launches=5, replays=5)
            lse_ms = graph_ms(lambda: flash_attn_fwd(q, k, v, causal=causal, return_lse=True),
                              launches=5, replays=5)
            plain_ms = median_ms(lambda: attention_reference(q, k, v, causal), iters=5)
            flops = 4 * B * H * Sq * Sk * D * (0.5 if causal else 1.0)  # what the mask leaves
            # one PyTorch call for the same function, timed here and used
            # nowhere in the port
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = graph_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                launches=5, replays=5)
            # with the LSE (row 2's function): PyTorch's flash attention op in
            # bf16, its memory-efficient op (3xTF32 products) in fp32; each
            # returns the output and the logsumexp
            if dtype == torch.float32:
                lse_op, lse_library_ms = "_scaled_dot_product_efficient_attention", graph_ms(
                    lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                        qt, kt, vt, None, True, 0.0, causal), launches=5, replays=5)
            else:
                lse_op, lse_library_ms = "_scaled_dot_product_flash_attention", graph_ms(
                    lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                        qt, kt, vt, 0.0, causal), launches=5, replays=5)
            kind = "tf32x3" if dtype == torch.float32 else "bf16"
            bnd = bound(_nbytes(q, k, v, got), flops, kind)
            tflops = flops / ms / 1e9
            rec = {"max_abs_err": err, "max_rel_err": rel_err, "ms": ms, "lse_ms": lse_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "lse_library_ms": lse_library_ms, "tflops": tflops, **bnd}
            earlier = ""
            if dtype == torch.float32:
                # the earlier FMA kernel on the same inputs, through its own
                # entry, held against the plain version too; and its bound
                fma_bnd = bound(_nbytes(q, k, v, got), flops, "fp32")
                out_e = torch.empty(q.shape, dtype=q.dtype, device="cuda")
                args = (q, k, v, None, None, out_e, None, causal, Sk - Sq, D ** -0.5)
                earlier_ms = graph_ms(lambda: _fwd_launch("flash_fwd_kernel", *args),
                                      launches=5, replays=5)
                err_e = (out_e - want).abs().max().item()
                require(err_e <= tol * want.abs().max().item(),
                        f"flash {name}: flash_fwd_kernel error {err_e}")
                rec.update(earlier_ms=earlier_ms, fma_bound_ms=fma_bnd["bound_ms"])
                earlier = (f"; the earlier flash_fwd_kernel {earlier_ms:.3f} ms (max|kernel-plain| "
                           f"{err_e:.3e}, FMA bound {fma_bnd['bound_ms']:.3f} ms)")
            log(f"[flash] {name}: {kernel} {ms:.3f} ms ({tflops:.1f} TFLOP/s), with LSE "
                f"{lse_ms:.3f} ms, bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}, {kind}), "
                f"plain (out and LSE) {plain_ms:.3f} ms, library call (SDPA) {library_ms:.3f} ms, "
                f"with LSE (aten.{lse_op}) {lse_library_ms:.3f} ms (CUDA-graph replays; the plain "
                f"version median of eager calls){earlier}")
            if name == "flagship":
                records["flash_attn_fwd"] = rec
            elif name == "fp32":
                records["flash_attn_fwd_tf32x3"] = rec
                # the kernel that keeps D = 128 and segment ids, at the fp32
                # shape it ran before the 3xTF32 kernel took fp32
                records["flash_attn_fwd_mma"] = {
                    "max_abs_err": err_e, "ms": earlier_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, **fma_bnd}
            elif name == "fp32_train":
                records["flash_attn_fwd_tf32x3"].update(
                    {f"b8_{k}": v for k, v in rec.items() if k != "bound_by"})
            else:  # another shape of a main path, under its kernel's name
                key = "flash_attn_fwd_tf32x3" if dtype == torch.float32 else "flash_attn_fwd"
                records[key].update({
                    f"{name}_shape": f"B={B} S={Sq} H={H} D={D}{' causal' if causal else ''}",
                    f"{name}_ms": ms, f"{name}_lse_ms": lse_ms,
                    f"{name}_max_abs_err": err, f"{name}_plain_ms": plain_ms,
                    f"{name}_library_ms": library_ms, f"{name}_lse_library_ms": lse_library_ms,
                    f"{name}_bound_ms": bnd["bound_ms"]})


def phase_flash_bwd(records: dict) -> None:
    """The flash backward kernels (dQ; dK/dV) against their plain version on
    the card at the shapes the training path gives them: once from the
    kernel forward's out and LSE (both sides read the same inputs), once
    against the plain backward of the plain forward's own out and LSE (so a
    wrong LSE from the forward kernel cannot pass). Plus the autograd path
    and the refusal of attention_with_lse under grad."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from video_tokenizer_tpu_torch.ops.attention import (
        _bwd_launch, attention, attention_bwd_reference, attention_reference, attention_with_lse,
        flash_attn_bwd, flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # bounds relative to max|plain| of each gradient: bf16 (the kernels round
    # P and dS to bf16 before their products and return bf16 gradients; the
    # plain version computes in fp32 and rounds once) 2e-2; fp32 1e-4
    # (name, B, Sq, Sk, H, Hkv, D, dtype, causal, offset, segments, tol)
    cases = [
        ("tokenizer", 8, 2048, 2048, 12, 12, 64, torch.bfloat16, False, None, False, 2e-2),
        ("discriminator", 8, 1025, 1025, 12, 12, 32, torch.bfloat16, False, None, False, 2e-2),
        ("prior_causal", 8, 1024, 1024, 20, 20, 64, torch.bfloat16, True, None, False, 2e-2),
        ("gqa_20_over_5", 2, 512, 512, 20, 5, 64, torch.bfloat16, True, None, False, 2e-2),
        ("segments_no_match", 2, 300, 300, 4, 4, 64, torch.bfloat16, False, None, True, 2e-2),
        ("causal_offset", 2, 384, 512, 4, 2, 128, torch.bfloat16, True, 100, False, 2e-2),
        ("fp32_tokenizer", 8, 2048, 2048, 12, 12, 64, torch.float32, False, None, False, 1e-4),
        ("fp32", 2, 1025, 1025, 12, 12, 32, torch.float32, False, None, False, 1e-4),
        ("fp32_causal_gqa_seg", 2, 200, 333, 4, 2, 128, torch.float32, True, 50, True, 1e-4),
        ("causal_offset_d64", 2, 384, 512, 4, 2, 64, torch.bfloat16, True, 100, False, 2e-2),
        ("causal_ragged_d32", 2, 300, 333, 4, 4, 32, torch.bfloat16, True, None, False, 2e-2),
        # one query row and one key past a 128-row block / a 64-row tile
        ("edge_129_257", 2, 129, 257, 4, 4, 64, torch.bfloat16, False, None, False, 2e-2),
        # queries 0..69 see no key: each adds do / Sk to every key's dv
        ("causal_no_key_rows", 1, 300, 300, 2, 2, 64, torch.bfloat16, True, -70, False, 2e-2),
        # fp32 at the shapes of the bf16 cases above (the AR trainer's causal GQA at D = 64)
        ("fp32_prior_causal", 8, 1024, 1024, 20, 20, 64, torch.float32, True, None, False, 1e-4),
        # the frame-prediction AR trainer's: 1025 condition + 1023 code tokens
        ("fp32_ar_fp_train", 8, 2048, 2048, 20, 20, 64, torch.float32, True, None, False, 1e-4),
        ("fp32_gqa_20_over_5", 2, 512, 512, 20, 5, 64, torch.float32, True, None, False, 1e-4),
        ("fp32_causal_offset_d64", 2, 384, 512, 4, 2, 64, torch.float32, True, 100, False, 1e-4),
        ("fp32_causal_no_key_rows", 1, 300, 300, 2, 2, 64, torch.float32, True, -70, False, 1e-4),
        ("fp32_edge_129_257", 2, 129, 257, 4, 4, 64, torch.float32, False, None, False, 1e-4),
        ("fp32_causal_ragged_d32", 2, 300, 333, 4, 4, 32, torch.float32, True, None, False, 1e-4),
        # the model_new stacks (see phase 2): v a view of the 4C-wide projection
        ("model_new_large", 8, 2048, 2048, 16, 16, 64, torch.bfloat16, False, None, False, 2e-2),
        ("model_new_h8_s2304", 2, 2304, 2304, 8, 8, 64, torch.bfloat16, False, None, False, 2e-2),
        ("model_new_h12_s1792", 2, 1792, 1792, 12, 12, 64, torch.bfloat16, False, None, False,
         2e-2),
        ("fp32_model_new_large", 4, 2048, 2048, 16, 16, 64, torch.float32, False, None, False,
         1e-4),
        ("fp32_model_new_h12_s512", 2, 512, 512, 12, 12, 64, torch.float32, False, None, False,
         1e-4),
        # the LARP recipe's (phase 22): the gptc-S prior (fp32, causal over
        # 1023, q, k, v and dO from separate projections) and the 512-wide
        # discriminator (8 heads of 64, strided qkv views)
        ("fp32_gptc_prior", 8, 1023, 1023, 6, 6, 64, torch.float32, True, None, False, 1e-4),
        ("disc512", 8, 1025, 1025, 8, 8, 64, torch.bfloat16, False, None, False, 2e-2),
    ]
    # the kernels each case's dQ and dK/dV must run: the wgmma kernels (bf16,
    # D = 32 or 64, no segment ids), the 3xTF32 kernels (the same in fp32),
    # else the mma.sync / FMA kernels of csrc/flash_attn_bwd.cu; the forward
    # that feeds them follows the same rule
    sm90_cases = {"tokenizer", "discriminator", "prior_causal", "gqa_20_over_5",
                  "causal_offset_d64", "causal_ragged_d32", "edge_129_257", "causal_no_key_rows",
                  "model_new_large", "model_new_h8_s2304", "model_new_h12_s1792", "disc512"}
    tf32x3_cases = {"fp32", "fp32_tokenizer", "fp32_prior_causal", "fp32_ar_fp_train",
                    "fp32_gqa_20_over_5", "fp32_gptc_prior",
                    "fp32_causal_offset_d64", "fp32_causal_no_key_rows", "fp32_edge_129_257",
                    "fp32_causal_ragged_d32", "fp32_model_new_large", "fp32_model_new_h12_s512"}
    fma_launches = [0, 0]  # dQ, dK/dV launches of csrc/flash_attn_bwd.cu by the cases
    for name, B, Sq, Sk, H, Hkv, D, dtype, causal, offset, with_seg, tol in cases:
        if "model_new" in name:
            # the gated block's: q, k fresh, v the view of the 4C-wide
            # projection that the forward saved; dO (the gate product's
            # gradient) fresh
            q, k = randn(B, Sq, H, D, dtype=dtype), randn(B, Sk, H, D, dtype=dtype)
            v = randn(B, Sk, 4, H, D, dtype=dtype)[:, :, 2]
            do = randn(B, Sq, H, D, dtype=dtype)
        elif name == "fp32_gptc_prior":  # the prior's three projections: contiguous
            q, k, v, do = (randn(B, Sq, H, D, dtype=dtype) for _ in range(4))
        elif Sq == Sk and H == Hkv:
            # q, k, v and dO as strided views of [B, S, 3, H, D] projections
            q, k, v = randn(B, Sq, 3, H, D, dtype=dtype).unbind(2)
            do = randn(B, Sq, 3, H, D, dtype=dtype)[:, :, 1]
        else:
            q, do = randn(B, Sq, H, D, dtype=dtype), randn(B, Sq, H, D, dtype=dtype)
            k, v = randn(B, Sk, Hkv, D, dtype=dtype), randn(B, Sk, Hkv, D, dtype=dtype)
        q_seg = k_seg = None
        if with_seg:
            k_seg = (torch.arange(Sk, device="cuda") >= Sk // 3).int().expand(B, Sk).contiguous()
            q_seg = (torch.arange(Sq, device="cuda") >= Sq // 3).int().expand(B, Sq).contiguous()
            q_seg[:, 5] = 7  # matches no key: its dv share is do / Sk on every key
        kw = dict(causal=causal, segment_ids=q_seg, kv_segment_ids=k_seg, causal_offset=offset)
        out, lse = flash_attn_fwd(q, k, v, return_lse=True, **kw)
        got = flash_attn_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        kernel, dq_kernel = flash_attn_bwd_dkv.last_kernel, flash_attn_bwd_dq.last_kernel
        fma_launches[0] += dq_kernel == "flash_bwd_dq_kernel"
        fma_launches[1] += kernel == "flash_bwd_dkv_kernel"
        want = attention_bwd_reference(q, k, v, out, lse, do, causal, q_seg, k_seg, None, offset)
        plain_out, plain_lse = attention_reference(q, k, v, causal, q_seg, k_seg, None, offset)
        want_plain = attention_bwd_reference(q, k, v, plain_out, plain_lse, do, causal, q_seg,
                                             k_seg, None, offset)
        errs, abs_errs, plain_errs = [], [], []
        for gname, g, w, wp in zip(("dq", "dk", "dv"), got, want, want_plain):
            require(g.shape == w.shape and g.dtype == w.dtype, f"flash bwd {name} {gname}: "
                    f"{tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
            require(torch.isfinite(g).all().item(), f"flash bwd {name}: non-finite {gname}")
            abs_errs.append((g.float() - w.float()).abs().max().item())
            errs.append(abs_errs[-1] / w.float().abs().max().item())
            plain_errs.append((g.float() - wp.float()).abs().max().item()
                              / wp.float().abs().max().item())
        log(f"[flash bwd] {name}: B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} {str(dtype)[6:]}"
            f"{' causal' if causal else ''}{f' offset {offset}' if offset is not None else ''}"
            f"{' segments' if with_seg else ''}, dQ by {dq_kernel}, dK/dV by {kernel}: "
            f"max|kernel-plain|/max|plain| dq {errs[0]:.2e}, "
            f"dk {errs[1]:.2e}, dv {errs[2]:.2e}; against the plain forward's out and LSE "
            f"dq {plain_errs[0]:.2e}, dk {plain_errs[1]:.2e}, dv {plain_errs[2]:.2e} (tol {tol:g})")
        family = "sm90" if name in sm90_cases else "tf32x3" if name in tf32x3_cases else None
        want_dq, want_dkv = ((f"flash_bwd_dq_{family}_kernel", f"flash_bwd_dkv_{family}_kernel")
                             if family else ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
        require(kernel == want_dkv, f"flash bwd {name}: dK/dV ran {kernel}, not {want_dkv}")
        require(dq_kernel == want_dq, f"flash bwd {name}: dQ ran {dq_kernel}, not {want_dq}")
        require(max(errs) <= tol and max(plain_errs) <= tol,
                f"flash bwd {name}: errors {errs}, from the plain forward {plain_errs} > {tol}")
        del plain_out, plain_lse, want_plain
        if name in ("tokenizer", "discriminator", "prior_causal", "fp32", "fp32_tokenizer",
                    "fp32_causal_gqa_seg", "fp32_gptc_prior", "disc512"):
            # the two kernels alone (delta and the GQA sum are torch ops), by
            # CUDA-graph replays (events around one eager call would add the
            # host's launch path, ~0.05 ms)
            delta = torch.einsum("bqhd,bqhd->bhq", out.float(), do.float()).contiguous()
            scale = D ** -0.5
            off = offset if offset is not None else Sk - Sq
            args = (q, k, v, do, lse, delta, q_seg, k_seg, causal, off, scale)
            dq_ms = graph_ms(lambda: flash_attn_bwd_dq(*args), launches=5, replays=5)
            dkv_ms = graph_ms(lambda: flash_attn_bwd_dkv(*args), launches=5, replays=5)
            # the earlier (mma.sync / FMA) kernels through their own entry, in
            # the same run, held against the plain version too
            dq_e = torch.empty(q.shape, dtype=dtype, device="cuda")
            dk_e = torch.empty((B, Sk, H, D), dtype=dtype, device="cuda")
            dv_e = torch.empty((B, Sk, H, D), dtype=dtype, device="cuda")
            fma = (q, k, v, do, lse, delta, q_seg, k_seg)
            dq_earlier_ms = graph_ms(lambda: _bwd_launch(False, *fma, dq_e, None, causal, off,
                                                         scale), launches=5, replays=5)
            dkv_earlier_ms = graph_ms(lambda: _bwd_launch(True, *fma, dk_e, dv_e, causal, off,
                                                          scale), launches=5, replays=5)
            if Hkv != H:
                rep = H // Hkv
                dk_e = dk_e.float().reshape(B, Sk, Hkv, rep, D).sum(3).to(dtype)
                dv_e = dv_e.float().reshape(B, Sk, Hkv, rep, D).sum(3).to(dtype)
            earlier_errs = [(g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
                            for g, w in zip((dq_e, dk_e, dv_e), want)]
            require(max(earlier_errs) <= tol, f"flash bwd {name}: the earlier kernels' errors "
                    f"{earlier_errs} > {tol}")
            plain_ms = median_ms(
                lambda: attention_bwd_reference(q, k, v, out, lse, do, causal, q_seg, k_seg,
                                                None, offset), iters=5)
            # a product over what the mask leaves (2 flops a MAC); the backward has five
            unit = 2 * B * H * Sq * Sk * D * (0.5 if causal else 1.0)
            # the library's call for the same gradients: autograd through
            # SDPA, ONE backward for dq, dk and dv together (both kernels'
            # rows carry its time); timed here, used nowhere in the port
            library_ms = None
            if not with_seg:
                ql, kl, vl = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
                if dtype == torch.float32:  # the memory-efficient backend (3xTF32 products)
                    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                        out_l = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
                else:
                    out_l = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
                do_l = do.transpose(1, 2)
                library_ms = median_ms(
                    lambda: torch.autograd.grad(out_l, (ql, kl, vl), do_l, retain_graph=True))
                del out_l
            # dQ recomputes S and dP and forms dQ (three products), dK/dV
            # S, dP, dV and dK (four); each reads q, k, v, dO, LSE, delta
            read = _nbytes(q, k, v, do, lse, delta)
            kind = {"sm90": "bf16", "tf32x3": "tf32x3"}.get(family, "fp32")
            bnd_dq = bound(read + _nbytes(got[0]), 3 * unit, kind)
            bnd_dkv = bound(read + _nbytes(got[1], got[2]), 4 * unit, kind)
            dkv_tflops = 4 * unit / dkv_ms / 1e9
            lib = f"{library_ms:.3f} ms (median)" if library_ms is not None else "none"
            log(f"[flash bwd] {name}: dQ {dq_kernel} {dq_ms:.3f} ms ({3 * unit / dq_ms / 1e9:.1f} "
                f"TFLOP/s of its 3 products; bound {bnd_dq['bound_ms']:.3f}, "
                f"{bnd_dq['bound_by']}, {kind}), dK/dV {kernel} {dkv_ms:.3f} ms ({dkv_tflops:.1f} "
                f"TFLOP/s of its 4 products, bound {bnd_dkv['bound_ms']:.3f}); the earlier "
                f"flash_bwd_dq_kernel {dq_earlier_ms:.3f} ms, flash_bwd_dkv_kernel "
                f"{dkv_earlier_ms:.3f} ms (max|kernel-plain|/max|plain| "
                f"{max(earlier_errs):.2e}); plain backward (dq, dk, dv) {plain_ms:.3f} ms, "
                f"library call (autograd through SDPA, dq + dk + dv in one backward) {lib} "
                f"(kernels: CUDA-graph replays)")
            rec_dq = {"max_abs_err": abs_errs[0], "max_rel_err": errs[0], "ms": dq_ms,
                      "earlier_ms": dq_earlier_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      **bnd_dq}
            rec_dkv = {"max_abs_err": max(abs_errs[1:]), "max_rel_err": max(errs[1:]),
                       "ms": dkv_ms, "earlier_ms": dkv_earlier_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "tflops": dkv_tflops, **bnd_dkv}
            if name in ("tokenizer", "fp32_tokenizer"):  # the training shape
                slower = [f"{k} {ms:.3f} ms against {e:.3f}" for k, ms, e in (
                    ("dQ", dq_ms, dq_earlier_ms), ("dK/dV", dkv_ms, dkv_earlier_ms))
                    if ms >= e and (family == "tf32x3" or k == "dQ")]
                require(not slower, f"flash bwd {name}: no faster than the earlier kernels: "
                        f"{slower}")
            if name == "tokenizer":
                records["flash_attn_bwd_dq"] = rec_dq
                records["flash_attn_bwd_dkv"] = rec_dkv
            elif name == "fp32_tokenizer":
                # the fp32 training step's shape, beside SDPA's fp32 backward
                fma_bnd = {k: bound(read + _nbytes(*g), n * unit, "fp32")["bound_ms"]
                           for k, g, n in (("dq", got[:1], 3), ("dkv", got[1:], 4))}
                log(f"[flash bwd] {name}: dQ + dK/dV {dq_ms + dkv_ms:.3f} ms against SDPA's "
                    f"whole fp32 backward (efficient backend) {library_ms:.3f} ms; FMA bounds "
                    f"dQ {fma_bnd['dq']:.3f}, dK/dV {fma_bnd['dkv']:.3f} ms")
                rec_dq["fma_bound_ms"], rec_dkv["fma_bound_ms"] = fma_bnd["dq"], fma_bnd["dkv"]
                records["flash_attn_bwd_dq_tf32x3"] = rec_dq
                records["flash_attn_bwd_dkv_tf32x3"] = rec_dkv
            elif name == "fp32_causal_gqa_seg":
                # the kernels that keep D = 128 and segment ids: no PyTorch call
                # takes segment ids, so no library time here
                for key, rec in (("flash_attn_bwd_dq_mma", rec_dq),
                                 ("flash_attn_bwd_dkv_mma", rec_dkv)):
                    del rec["earlier_ms"]  # the same kernel
                    records[key] = rec
            else:
                short = {"discriminator": "disc", "prior_causal": "causal", "fp32": "disc",
                         "fp32_gptc_prior": "gptc_prior", "disc512": "disc512"}[name]
                suffix = "_tf32x3" if family == "tf32x3" else ""
                shape = f"B={B} S={Sq} H={H} D={D}{' causal' if causal else ''}"
                records[f"flash_attn_bwd_dq{suffix}"].update({
                    f"{short}_shape": shape, f"{short}_ms": dq_ms,
                    f"{short}_earlier_ms": dq_earlier_ms, f"{short}_max_abs_err": abs_errs[0],
                    f"{short}_plain_ms": plain_ms, f"{short}_library_ms": library_ms,
                    f"{short}_bound_ms": bnd_dq["bound_ms"]})
                records[f"flash_attn_bwd_dkv{suffix}"].update({
                    f"{short}_shape": shape, f"{short}_ms": dkv_ms,
                    f"{short}_earlier_ms": dkv_earlier_ms,
                    f"{short}_max_abs_err": max(abs_errs[1:]),
                    f"{short}_plain_ms": plain_ms, f"{short}_library_ms": library_ms,
                    f"{short}_bound_ms": bnd_dkv["bound_ms"]})
    # csrc/flash_attn_bwd.cu is on no main path: no trainer takes segment ids
    # or D = 128; its launches are those of the cases above that need it
    records["flash_attn_bwd_dq_mma"]["launches"] = fma_launches[0]
    records["flash_attn_bwd_dkv_mma"]["launches"] = fma_launches[1]
    log(f"[flash bwd] csrc/flash_attn_bwd.cu (D = 128, segment ids; on no main path): "
        f"{fma_launches[0]} dQ and {fma_launches[1]} dK/dV launches by the cases above")

    # autograd: `attention` at the tokenizer's shape is differentiable on the
    # card (its output used to carry no grad_fn, silently dropping gradients)
    qkv = randn(8, 2048, 3, 12, 64, dtype=torch.bfloat16).requires_grad_()
    flash_attn_bwd_dq.launches = flash_attn_bwd_dkv.launches = 0
    out = attention(*qkv.unbind(2))
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    grads = [qkv.grad[:, :, i].float().abs().max().item() for i in range(3)]
    launches = (flash_attn_bwd_dq.launches, flash_attn_bwd_dkv.launches)
    log(f"[flash bwd] autograd at the tokenizer's shape: max|q.grad| {grads[0]:.3e}, "
        f"max|k.grad| {grads[1]:.3e}, max|v.grad| {grads[2]:.3e}; backward launches "
        f"dQ {launches[0]}, dK/dV {launches[1]}")
    require(out.grad_fn is not None and all(g > 0 for g in grads), "attention: no gradient")
    require(launches == (1, 1), f"attention backward launches {launches}")
    try:
        attention_with_lse(*qkv.unbind(2))
    except NotImplementedError:
        log("[flash bwd] attention_with_lse under grad on the card raises NotImplementedError")
    else:
        raise AssertionError("attention_with_lse under grad returned detached outputs")


def _vq_gap(z, emb, bias, a, b):
    """Score gap between codes a and b of each row of z, in fp64."""
    za, ea = z.double(), emb.double()
    sa = (za * ea[a.long()]).sum(-1)
    sb = (za * ea[b.long()]).sum(-1)
    if bias is not None:
        sa, sb = sa + bias.double()[a.long()], sb + bias.double()[b.long()]
    return (sa - sb).abs()


def phase_vq(records: dict) -> None:
    """The VQ search (`vq_tc_kernel`: 3xTF32 scores, the codebook split over a
    cluster) against its plain version in both modes, planted exact ties,
    and the flagship shape timed beside the earlier FMA kernel
    (`vq_argmax_kernel`), one PyTorch call and both bounds."""
    import torch

    from video_tokenizer_tpu_torch.ops.vq import (
        _vq_launch, vq_argmax, vq_kernel, vq_lookup_reference,
    )

    def earlier(z, emb, bias, **kw):  # the FMA kernel, by name
        idx = torch.empty(z.shape[0], dtype=torch.int32, device="cuda")
        _vq_launch("vq_argmax_kernel", z, emb, bias, idx, kw.get("stochastic", False),
                   kw.get("inv_temp", 1.0), kw.get("seed", 0))
        return idx

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # indices equal, or different only at near-ties: a score gap under 1e-5
    # (the kernel and cuBLAS sum the d products in other orders). The
    # reported max_abs_err is the largest such gap.
    for name, M, K, d, metric in (
        ("flagship_cos", 8192, 8192, 8, "cos"),
        ("l2", 8192, 8192, 8, "l2"),
        ("ragged", 1000, 2100, 16, "l2"),
        ("ragged_d4", 999, 5000, 4, "cos"),
        ("ragged_d32", 1000, 300, 32, "l2"),
    ):
        z = torch.randn(M, d, generator=gen, device="cuda")
        emb = torch.randn(K, d, generator=gen, device="cuda")
        bias = None
        if metric == "cos":
            z = z / (z.norm(dim=-1, keepdim=True) + 1e-12)
            emb = emb / (emb.norm(dim=-1, keepdim=True) + 1e-12)
        else:
            bias = -0.5 * (emb**2).sum(-1)
        got = vq_argmax(z, emb, bias)
        torch.cuda.synchronize()
        kernel = vq_argmax.last_kernel
        require(kernel == vq_kernel(d, False) == "vq_tc_kernel", f"vq {name}: ran {kernel}")
        want = vq_lookup_reference(z, emb, bias)
        gaps = {}
        for who, idx in (("kernel", got), ("earlier", earlier(z, emb, bias))):
            diff = idx != want
            n_diff = int(diff.sum().item())
            gap = _vq_gap(z[diff], emb, bias, idx[diff], want[diff]).max().item() if n_diff else 0.0
            gaps[who] = (n_diff, gap)
            require(gap < 1e-5, f"vq {name}: the {who} index differs at a score gap {gap}")
        (n_diff, gap), (n_diff_e, gap_e) = gaps["kernel"], gaps["earlier"]
        log(f"[vq] {name}: M={M} K={K} d={d} {metric}: {kernel} {n_diff} of {M} indices differ "
            f"(largest score gap {gap:.2e}, tol 1e-5); the earlier vq_argmax_kernel {n_diff_e} "
            f"({gap_e:.2e})")
        if name == "flagship_cos":
            ms = graph_ms(lambda: vq_argmax(z, emb, bias))
            earlier_ms = graph_ms(lambda: earlier(z, emb, bias))
            ms_again = graph_ms(lambda: vq_argmax(z, emb, bias))
            plain_ms = graph_ms(lambda: vq_lookup_reference(z, emb, bias), launches=5)
            # timed here, used nowhere
            library_ms = graph_ms(lambda: (z @ emb.T).argmax(-1), launches=5)
            flops = 2 * M * K * d
            bnd = bound(_nbytes(z, emb, got), flops, "tf32x3")
            fma_bnd = bound(_nbytes(z, emb, got), flops, "fp32")
            ms = min(ms, ms_again)
            log(f"[vq] flagship: {kernel} {ms:.4f} ms, the earlier vq_argmax_kernel "
                f"{earlier_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, three "
                f"TF32 products; as fp32 FMAs {fma_bnd['bound_ms']:.4f} ms), plain "
                f"{plain_ms:.4f} ms, library call ((z @ e.T).argmax) {library_ms:.4f} ms "
                f"(device time, CUDA-graph replay)")
            records["vq_argmax"] = {"max_abs_err": gap, "ms": ms, "earlier_ms": earlier_ms,
                                    "plain_ms": plain_ms, "library_ms": library_ms,
                                    "fma_bound_ms": fma_bnd["bound_ms"], **bnd}

    # planted exact ties: duplicate codes at indices in one thread's group of
    # four, in other threads of a split and in other splits of the cluster
    # (1024 codes each at K = 8192); a row equal to a duplicated code scores
    # it exactly the same at every copy, and the lowest index must win
    M, K = 64, 8192
    for metric in ("cos", "l2"):
        emb = torch.randn(K, 8, generator=gen, device="cuda")
        if metric == "cos":
            emb = emb / emb.norm(dim=-1, keepdim=True)
        plants = {100: (101, 103, 130, 1100, 5000, 8191), 2000: (7000, 7001), 3000: (3005,),
                  8190: (8191,)}
        for lo, dups in plants.items():
            emb[list(dups)] = emb[lo].clone()
        z = emb[torch.tensor(list(plants), device="cuda").repeat_interleave(M // len(plants))]
        bias = -0.5 * (emb**2).sum(-1) if metric == "l2" else None
        want = torch.tensor(list(plants), dtype=torch.int32,
                            device="cuda").repeat_interleave(M // len(plants))
        got = vq_argmax(z.contiguous(), emb, bias)
        torch.cuda.synchronize()
        wrong = int((got != want).sum().item())
        log(f"[vq ties] {metric}: {len(plants)} codes duplicated ({sum(map(len, plants.values()))} "
            f"copies, within a thread's four, across threads and across the cluster's splits): "
            f"{wrong} of {M} rows miss the lowest index")
        require(wrong == 0, f"vq ties {metric}: {wrong} rows do not take the lowest index "
                            f"({got.tolist()})")

    # stochastic (Gumbel-max) mode: the kernel and the plain version draw the
    # same Philox bits, so they agree index for index but for rows whose top
    # two perturbed scores are within a few fp32 ulps (three TF32 products
    # against a matmul's sums, logf against torch.log)
    M = K = 8192
    inv_temp = 1.0 / 0.03
    z = torch.randn(M, 8, generator=gen, device="cuda")
    emb = torch.randn(K, 8, generator=gen, device="cuda")
    z, emb = z / (z.norm(dim=-1, keepdim=True) + 1e-12), emb / (emb.norm(dim=-1, keepdim=True) + 1e-12)
    seed = 1234567890123
    got = vq_argmax(z, emb, stochastic=True, inv_temp=inv_temp, seed=seed)
    again = vq_argmax(z, emb, stochastic=True, inv_temp=inv_temp, seed=seed)
    other = vq_argmax(z, emb, stochastic=True, inv_temp=inv_temp, seed=seed + 1)
    got_e = earlier(z, emb, None, stochastic=True, inv_temp=inv_temp, seed=seed)
    torch.cuda.synchronize()
    require(vq_argmax.last_kernel == vq_kernel(8, True) == "vq_tc_kernel",
            f"vq stochastic: ran {vq_argmax.last_kernel}")
    want = vq_lookup_reference(z, emb, stochastic=True, inv_temp=inv_temp, seed=seed)
    det = vq_lookup_reference(z, emb)
    diff = got != want
    n_diff = int(diff.sum().item())
    agree = 1.0 - n_diff / M
    gap = 0.0
    if n_diff:
        from video_tokenizer_tpu_torch.ops.vq import gumbel_noise

        rows = diff.nonzero()[:, 0]
        g = gumbel_noise(M, K, seed, "cuda")[rows].double()
        s = (z[rows].double() @ emb.double().T) * inv_temp + g
        pick = lambda idx: s.gather(1, idx[rows].long()[:, None])[:, 0]  # noqa: E731
        gap = (pick(got) - pick(want)).abs().max().item()
    changed = (got != det).float().mean().item()
    log(f"[vq stochastic] M={M} K={K} d=8 cos, inv_temp 1/0.03: kernel vs plain {n_diff} of "
        f"{M} indices differ (agreement {agree:.4%}, tol >= 99.9%; largest perturbed-score gap "
        f"{gap:.2e}, tol 1e-4); the same seed twice equal: {torch.equal(got, again)}; another "
        f"seed changes {(got != other).float().mean().item():.1%} of rows; "
        f"{changed:.1%} of rows leave the argmax; the earlier kernel differs from the plain "
        f"draw in {int((got_e != want).sum().item())} rows")
    require(agree >= 0.999 and gap < 1e-4, f"vq stochastic: {n_diff} differ, gap {gap}")
    require(torch.equal(got, again), "vq stochastic: the same seed gives other indices")
    require((got != other).any().item(), "vq stochastic: the seed does not move the draw")
    kw = dict(stochastic=True, inv_temp=inv_temp, seed=seed)
    ms = graph_ms(lambda: vq_argmax(z, emb, **kw))
    earlier_ms = graph_ms(lambda: earlier(z, emb, None, **kw))
    ms = min(ms, graph_ms(lambda: vq_argmax(z, emb, **kw)))
    plain_ms = median_ms(lambda: vq_lookup_reference(z, emb, **kw), iters=5)
    # its bound: operations on the SM's 128 fp32 lanes, of which 64 take
    # 32-bit integer multiplies: the product's 8 FMAs a code and the Philox
    # draw's 5 wide 32-bit multiplies a code (ten rounds of two per four
    # codes), each at half the FMA rate, so 2 FMA slots; the two logf a code
    # are left out. No single PyTorch call draws the same function (its noise
    # is this Philox stream), so it has no library time.
    st_bnd = bound(_nbytes(z, emb, got), 2 * (8 * M * K + 2 * 5 * M * K), "fp32")
    log(f"[vq stochastic] flagship: vq_tc_kernel {ms:.4f} ms, the earlier vq_argmax_kernel "
        f"{earlier_ms:.4f} ms (device time, CUDA-graph replay), bound "
        f"{st_bnd['bound_ms']:.4f} ms ({st_bnd['bound_by']}: the product and the Philox "
        f"multiplies), plain {plain_ms:.4f} ms (median); no library call draws the same function")
    records["vq_argmax"].update(stochastic_ms=ms, stochastic_earlier_ms=earlier_ms,
                                stochastic_plain_ms=plain_ms,
                                stochastic_bound_ms=st_bnd["bound_ms"],
                                stochastic_agreement=agree, stochastic_gap=gap)

    # frequencies at a small K: one z row drawn 2**16 times against
    # softmax(score * inv_temp), by a chi-square test
    from scipy.stats import chi2

    K_small, n, it = 16, 1 << 16, 3.0
    emb_s = torch.randn(K_small, 8, generator=gen, device="cuda")
    emb_s = emb_s / emb_s.norm(dim=-1, keepdim=True)
    z_s = emb_s[3:4].repeat(n, 1).contiguous()
    idx = vq_argmax(z_s, emb_s, stochastic=True, inv_temp=it, seed=77)
    counts = torch.bincount(idx.long(), minlength=K_small).double()
    p = torch.softmax((z_s[0] @ emb_s.T).double() * it, dim=0)
    stat = (((counts - n * p) ** 2) / (n * p)).sum().item()
    p_value = chi2.sf(stat, K_small - 1)
    log(f"[vq stochastic] K={K_small}, one row drawn {n} times at inv_temp {it}: chi-square "
        f"{stat:.2f} on {K_small - 1} dof against softmax, p = {p_value:.3f} (tol p > 1e-3)")
    require(p_value > 1e-3, f"vq stochastic frequencies: chi-square p = {p_value}")


def phase_decode_attention(records: dict) -> None:
    """The decode-attention kernels against their plain version at the 632M
    prior's sampling geometry, then timed cold: a decode step's 30 layers
    read 30 distinct caches, so the graph that times a kernel walks 30 of
    them (2.5 GB in bf16) and no cache is in the 50 MB L2 when it is read."""
    import torch
    import torch.nn.functional as F

    from video_tokenizer_tpu_torch.ops.decode_attention import (
        _quantize_rows, decode_attention, decode_attention_reference, decode_kernel,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    # Both kernels and the plain version compute in fp32 (the tensor-core
    # kernel's operands are exact: a bf16 q, bf16 or int8 cache values, P as
    # two bf16 parts) and round the output once, so they differ by about one
    # ulp of the output's dtype: the bound is relative to max|plain| (bf16
    # 1e-2, above its ulp of 2^-7 of a value; fp32 1e-5), capped by the JAX
    # interpret tests' absolute bounds (bf16 2e-2, int8 cache 5e-2, fp32 1e-4).
    # It must be tight enough to fail a kernel that reads one key too few or
    # too many: the plain version at pos - 1 and pos + 1 has to miss it.
    tols = {torch.bfloat16: (2e-2, 1e-2), torch.int8: (5e-2, 1e-2), torch.float32: (1e-4, 1e-5)}
    B, S = 16, 1152  # CFG-doubled batch 8, cache for 1 + 1024 positions
    for name, H, Hkv, D, cache_dtype, key_valid, positions in (
        ("lp_bf16", 20, 20, 64, torch.bfloat16, False, (0, 511, 1024)),
        ("lp_int8", 20, 20, 64, torch.int8, False, (0, 511, 1024)),
        ("lp_fp32", 20, 20, 64, torch.float32, False, (1024,)),
        ("gqa_20_over_5", 20, 5, 64, torch.bfloat16, False, (0, 1024)),
        ("key_valid", 20, 20, 64, torch.bfloat16, True, (3, 1024)),
        ("d128_gqa_int8", 8, 2, 128, torch.int8, True, (700,)),
    ):
        q_dtype = torch.float32 if cache_dtype == torch.float32 else torch.bfloat16
        q = torch.randn(B, H, D, generator=gen, device="cuda").to(q_dtype)
        kf = torch.randn(B, S, Hkv * D, generator=gen, device="cuda")
        vf = torch.randn(B, S, Hkv * D, generator=gen, device="cuda")
        ks = vs = None
        if cache_dtype == torch.int8:
            (k, ks), (v, vs) = _quantize_rows(kf), _quantize_rows(vf)
        else:
            k, v = kf.to(cache_dtype), vf.to(cache_dtype)
        valid = None
        if key_valid:
            valid = torch.rand(B, S, generator=gen, device="cuda") > 0.3
            valid[:, : max(positions) + 1 : 97] = True  # every row keeps valid keys
        for pos in positions:
            pos_t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
            kw = dict(key_valid=valid, k_scale=ks, v_scale=vs, kv_heads=Hkv)
            if valid is not None:
                valid[:, pos] = True
            got = decode_attention(q, k, v, pos_t, **kw)
            torch.cuda.synchronize()
            kernel = decode_attention.last_kernel
            require(kernel == decode_kernel(cache_dtype, q_dtype, D) == (
                "decode_split_kernel" if cache_dtype == torch.float32 or D == 128
                else "decode_attn_sm90_kernel"), f"decode {name}: ran {kernel}")
            want = decode_attention_reference(q, k, v, pos_t, **kw)
            err = (got.float() - want.float()).abs().max().item()
            cap, rel = tols[cache_dtype]
            tol = min(cap, rel * want.float().abs().max().item())
            near = min(
                (got.float() - decode_attention_reference(q, k, v, p, **kw).float()).abs().max().item()
                for p in (pos - 1, pos + 1) if p >= 0
            )
            log(f"[decode] {name}: B={B} H={H} Hkv={Hkv} D={D} S={S} {str(cache_dtype)[6:]} cache, "
                f"pos {pos}, {kernel}: max|kernel-plain| {err:.3e} (tol {tol:.3e}); the plain "
                f"version at pos -/+ 1 misses by >= {near:.3e}")
            require(torch.isfinite(got).all().item(), f"decode {name} pos {pos}: non-finite output")
            require(err <= tol, f"decode {name} pos {pos}: error {err} > {tol}")
            require(near > tol, f"decode {name} pos {pos}: the bound {tol} does not tell pos "
                                f"from pos -/+ 1 ({near})")
            if kernel == "decode_attn_sm90_kernel":
                # the kernel repeats itself bit for bit (a split cache is merged
                # in split order, whichever block comes last)
                require(torch.equal(decode_attention(q, k, v, pos_t, **kw), got),
                        f"decode {name} pos {pos}: two launches differ")
        if name == "lp_fp32":
            # the earlier kernel, which keeps fp32 (the parity path) and D = 128
            pos_t = torch.full((1,), 1024, dtype=torch.int32, device="cuda")
            ms = graph_ms(lambda: decode_attention(q, k, v, pos_t, kv_heads=Hkv))
            plain_ms = graph_ms(lambda: decode_attention_reference(q, k, v, pos_t, kv_heads=Hkv))
            qt = q[:, :, None]
            kt, vt = (t.view(B, S, Hkv, D).transpose(1, 2) for t in (k, v))
            mask = (torch.arange(S, device="cuda") <= 1024).expand(B, 1, 1, S)
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            bnd = bound(B * 1025 * Hkv * D * 2 * 4 + _nbytes(q, got), 4 * B * H * 1025 * D, "fp32")
            log(f"[decode] lp_fp32 at pos 1024: decode_split_kernel {ms:.4f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain {plain_ms:.4f} ms, library "
                f"call (SDPA with a mask, fp32) {library_ms:.4f} ms (device time, CUDA-graph replay)")
            records["decode_attention_split"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                                 "library_ms": library_ms, **bnd}
        if name in ("lp_bf16", "lp_int8"):
            _decode_cold(records, name, q, k, v, ks, vs, Hkv)


def _decode_cold(records: dict, name: str, q, k, v, ks, vs, Hkv: int) -> None:
    """Cold times at the sampling shape: 30 layers' caches (copies of the
    checked one: the same work per layer), one launch per layer in a graph,
    time per launch; the new kernel, the earlier kernel and SDPA with a mask
    on the same caches."""
    import torch
    import torch.nn.functional as F

    from video_tokenizer_tpu_torch.ops.decode_attention import (
        _decode_launch, decode_attention, decode_attention_reference,
    )

    B, H, D = q.shape
    S = k.shape[1]
    layers = 30
    caches = [(k.clone(), v.clone(), None if ks is None else ks.clone(),
               None if vs is None else vs.clone()) for _ in range(layers)]
    out = torch.empty_like(q)
    rec: dict = {}
    for pos in (0, 511, 1024):
        pos_t = torch.full((1,), pos, dtype=torch.int32, device="cuda")

        def run(kernel):
            def step():
                for kc, vc, ksc, vsc in caches:
                    _decode_launch(kernel, q, kc, vc, pos_t, None, ksc, vsc, Hkv, out)
            return graph_ms(step, launches=1, replays=5) / layers

        ms = run("decode_attn_sm90_kernel")
        earlier_ms = run("decode_split_kernel")
        ms_again = run("decode_attn_sm90_kernel")
        live = B * (pos + 1) * (Hkv * D * 2 * k.element_size() + (8 if ks is not None else 0))
        bnd = bound(live + 2 * _nbytes(q))
        log(f"[decode cold] {name} at pos {pos}, {layers} layers' caches: decode_attn_sm90_kernel "
            f"{ms:.4f} / {ms_again:.4f} ms ({live / min(ms, ms_again) / 1e6:.0f} GB/s of live K+V), "
            f"the earlier decode_split_kernel {earlier_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) (device time per launch, CUDA-graph replay)")
        rec[pos] = dict(ms=min(ms, ms_again), earlier_ms=earlier_ms, **bnd)
    pos_t = torch.full((1,), 1024, dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, kv_heads=Hkv)
    plain_ms = graph_ms(lambda: decode_attention_reference(q, k, v, pos_t, **kw))
    got = decode_attention(q, k, v, pos_t, **kw)
    err = (got.float() - decode_attention_reference(q, k, v, pos_t, **kw).float()).abs().max().item()
    library_ms = None
    if ks is None:
        # one PyTorch call for the same function: SDPA on [B, H, S, D] views of
        # each layer's cache with a [B, 1, 1, S] boolean mask (none for an int8
        # cache); timed here, used nowhere in the port
        qt = q[:, :, None]
        mask = (torch.arange(S, device="cuda") <= 1024).expand(B, 1, 1, S)
        views = [tuple(t.view(B, S, Hkv, D).transpose(1, 2) for t in c[:2]) for c in caches]

        def sdpa():
            for kt, vt in views:
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        library_ms = graph_ms(sdpa, launches=1, replays=5) / layers
    log(f"[decode cold] {name} at pos 1024: plain {plain_ms:.4f} ms (warm), library call (SDPA "
        f"with a mask, cold) {'none for int8' if library_ms is None else f'{library_ms:.4f} ms'}")
    top = rec[1024]
    if top["ms"] >= top["earlier_ms"]:
        log(f"[decode cold] {name}: decode_attn_sm90_kernel ({top['ms']:.4f} ms) is NOT faster than "
            f"the earlier kernel ({top['earlier_ms']:.4f} ms) at pos 1024")
    if name == "lp_bf16":
        records["decode_attention"] = {
            "max_abs_err": err, "ms": top["ms"], "earlier_ms": top["earlier_ms"],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "pos_0_ms": rec[0]["ms"], "pos_511_ms": rec[511]["ms"],
            "pos_0_earlier_ms": rec[0]["earlier_ms"], "pos_511_earlier_ms": rec[511]["earlier_ms"]}
    else:
        records["decode_attention"].update(
            int8_ms=top["ms"], int8_earlier_ms=top["earlier_ms"],
            int8_plain_ms=plain_ms, int8_bound_ms=top["bound_ms"], int8_pos_0_ms=rec[0]["ms"],
            int8_pos_511_ms=rec[511]["ms"], int8_pos_0_earlier_ms=rec[0]["earlier_ms"],
            int8_pos_511_earlier_ms=rec[511]["earlier_ms"])
    del caches


def phase_chunk_attention(records: dict) -> None:
    """The chunk-attention kernel against its plain version at the verify and
    draft shapes of speculative decoding with the 632M prior: B = 16 rows at
    uneven positions, S = 1152, queries read in place from a fused qkv
    projection."""
    import torch
    import torch.nn.functional as F

    from video_tokenizer_tpu_torch.ops.decode_attention import (
        _chunk_launch, _quantize_rows, chunk_attention, chunk_attention_reference, chunk_kernel,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    # As for the one-token kernel, the bound is relative to max|plain| (bf16
    # and int8 caches 1e-2: the tensor-core kernel rounds q and P to bf16
    # before its products, as the TPU kernel does, where the plain version
    # computes in fp32 and rounds once; fp32 1e-5), capped by the JAX
    # interpret tests' absolute bounds, here PER ROW: a row at pos 1024 has outputs ~30x smaller than a
    # row at pos 0, and its bound must still fail a kernel that reads one key
    # too few or too many (the plain version at pos - 1 and pos + 1 misses it).
    tols = {torch.bfloat16: (2e-2, 1e-2), torch.int8: (5e-2, 1e-2), torch.float32: (1e-4, 1e-5)}
    B, S = 16, 1152
    # 0, around the 128-key splits, rows that differ by hundreds, the end
    pos = torch.tensor([0, 1, 127, 128, 129, 255, 256, 300, 511, 512, 640, 767, 900, 1023, 1024,
                        1024], dtype=torch.int32, device="cuda")
    for name, G, H, Hkv, D, cache_dtype, key_valid in (
        ("verify_bf16", 5, 20, 20, 64, torch.bfloat16, False),
        ("verify_int8", 5, 20, 20, 64, torch.int8, False),
        ("verify_fp32", 5, 20, 20, 64, torch.float32, False),
        ("draft_g1_bf16", 1, 12, 12, 64, torch.bfloat16, False),
        ("draft_g2_int8", 2, 12, 12, 64, torch.int8, False),
        ("gqa_20_over_5", 5, 20, 5, 64, torch.bfloat16, False),
        ("key_valid", 5, 20, 20, 64, torch.bfloat16, True),
        ("d128_gqa_int8_valid", 3, 8, 2, 128, torch.int8, True),
    ):
        q_dtype = torch.float32 if cache_dtype == torch.float32 else torch.bfloat16
        qkv = torch.randn(B, G, (H + 2 * Hkv) * D, generator=gen, device="cuda").to(q_dtype)
        q = qkv[..., : H * D].unflatten(-1, (H, D))  # a strided view, as the model gives it
        kf = torch.randn(B, S, Hkv * D, generator=gen, device="cuda")
        vf = torch.randn(B, S, Hkv * D, generator=gen, device="cuda")
        ks = vs = None
        if cache_dtype == torch.int8:
            (k, ks), (v, vs) = _quantize_rows(kf), _quantize_rows(vf)
        else:
            k, v = kf.to(cache_dtype), vf.to(cache_dtype)
        valid = None
        if key_valid:
            valid = torch.rand(B, S, generator=gen, device="cuda") > 0.3
            own = pos[:, None].long() + torch.arange(G, device="cuda")
            valid.scatter_(1, own, True)  # the chunk's own keys stay valid
        kw = dict(key_valid=valid, k_scale=ks, v_scale=vs, kv_heads=Hkv)
        got = chunk_attention(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        kernel = chunk_attention.last_kernel
        require(kernel == chunk_kernel(cache_dtype, D) == (
            "chunk_split_kernel" if cache_dtype == torch.float32 or D == 128
            else "chunk_attn_sm90_kernel"), f"chunk {name}: ran {kernel}")
        want = chunk_attention_reference(q, k, v, pos, **kw)
        require(got.shape == want.shape and got.dtype == want.dtype, f"chunk {name}: shape or dtype")
        require(torch.isfinite(got).all().item(), f"chunk {name}: non-finite output")
        cap, rel = tols[cache_dtype]
        err = (got.float() - want.float()).abs().flatten(1).amax(1)  # [B]
        tol = torch.clamp(rel * want.float().abs().flatten(1).amax(1), max=cap)
        near = torch.minimum(*(
            (got.float() - chunk_attention_reference(q, k, v, p, **kw).float()).abs().flatten(1).amax(1)
            for p in ((pos - 1).clamp(min=0), pos + 1)))
        near = torch.where(pos > 0, near, torch.inf)  # pos - 1 of row 0 is row 0 itself
        worst = int((err / tol).argmax())
        log(f"[chunk] {name}: B={B} G={G} H={H} Hkv={Hkv} D={D} S={S} {str(cache_dtype)[6:]} "
            f"cache, {kernel}, pos {pos.min().item()}..{pos.max().item()} per row: max|kernel-plain| "
            f"{err.max().item():.3e}; closest to its row's bound at pos {pos[worst].item()}: "
            f"{err[worst].item():.3e} (tol {tol[worst].item():.3e}); the plain version at pos "
            f"-/+ 1 misses each row's bound by a factor >= {(near / tol).min().item():.1f}")
        require(bool((err <= tol).all()), f"chunk {name}: errors {err.tolist()} > {tol.tolist()}")
        require(bool((near > tol).all()), f"chunk {name}: a row's bound does not tell pos from pos -/+ 1")
        if name in ("verify_bf16", "verify_int8", "verify_fp32", "draft_g1_bf16"):
            # every row at the end of a 1024-token sample: pos + G = 1029 live keys
            full = torch.full((B,), 1024, dtype=torch.int32, device="cuda")
            ms = graph_ms(lambda: chunk_attention(q, k, v, full, **kw))
            at_full = chunk_attention(q, k, v, full, **kw).float()
            want_full = chunk_attention_reference(q, k, v, full, **kw).float()
            err_full = ((at_full - want_full).abs().max() / want_full.abs().max()).item()
            require(err_full <= rel, f"chunk {name}, every row at pos 1024: {err_full} of "
                                     f"max|plain| > {rel}")
            earlier_ms = None
            if kernel != "chunk_split_kernel":
                # the earlier kernel through its own entry, in the same run
                earlier = torch.empty_like(got)
                earlier_ms = graph_ms(lambda: _chunk_launch("chunk_split_kernel", q, k, v, full,
                                                            valid, ks, vs, Hkv, earlier))
                err_earlier = (earlier.float() - at_full).abs().max().item()
                require(err_earlier <= 2e-2, f"chunk {name}: the two kernels differ by {err_earlier}")
                require(ms < earlier_ms, f"chunk {name}: {kernel} ({ms} ms) is no faster than the "
                                         f"earlier kernel ({earlier_ms} ms)")
            if name == "draft_g1_bf16":
                log(f"[chunk] {name}, every row at pos 1024: {kernel} {ms:.4f} ms, the earlier "
                    f"chunk_split_kernel {earlier_ms:.4f} ms (device time, CUDA-graph replay)")
                records["chunk_attention"].update(draft_g1_ms=ms, draft_g1_earlier_ms=earlier_ms)
                continue
            plain_ms = graph_ms(lambda: chunk_attention_reference(q, k, v, full, **kw), launches=5)
            live = B * (1024 + G) * (Hkv * D * 2 * k.element_size() + (8 if ks is not None else 0))
            bnd = bound(live + _nbytes(got, got, full))  # + the queries and the output
            library_ms = None
            if cache_dtype != torch.int8:
                # one PyTorch call for the same function: SDPA on [B, H, S, D]
                # views of the cache with a [B, 1, G, S] boolean mask (there is
                # none for an int8 cache); timed here, used nowhere in the port
                qt = q.transpose(1, 2)
                kt, vt = (t.view(B, S, Hkv, D).transpose(1, 2) for t in (k, v))
                mask = (torch.arange(S, device="cuda") <=
                        (full[:, None] + torch.arange(G, device="cuda"))[:, :, None])[:, None]
                lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask).transpose(1, 2)
                lib_err = (lib.float() - at_full).abs().max().item()
                require(lib_err <= 2e-2, f"chunk {name}: the library call computes another function ({lib_err})")
                library_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            log(f"[chunk] {name}, every row at pos 1024: {kernel} {ms:.4f} ms "
                f"({live / ms / 1e6:.0f} GB/s of live K+V), "
                + (f"the earlier chunk_split_kernel {earlier_ms:.4f} ms, " if earlier_ms else "")
                + f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain {plain_ms:.4f} ms, "
                f"library call (SDPA with a mask) "
                f"{'none for int8' if library_ms is None else f'{library_ms:.4f} ms'} "
                f"(device time, CUDA-graph replay)")
            rec = {"max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, **bnd}
            if name == "verify_bf16":
                records["chunk_attention"] = {**rec, "earlier_ms": earlier_ms}
            elif name == "verify_fp32":
                # the kernel that keeps fp32 caches and D = 128
                records["chunk_attention_split"] = rec
            else:
                records["chunk_attention"].update(int8_ms=ms, int8_earlier_ms=earlier_ms,
                                                  int8_plain_ms=plain_ms,
                                                  int8_bound_ms=bnd["bound_ms"])


def phase_cache_update(records: dict) -> None:
    """The per-row KV row-write kernel against its plain version: the written
    rows and scales equal bit for bit and every other byte of the caches
    unchanged (whole buffers are compared), rows read in place from a fused
    qkv projection, uneven positions, one row that runs past the cache."""
    import torch

    from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row, write_rows_reference
    from video_tokenizer_tpu_torch.ops.decode_attention import _quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    B, S = 16, 1152
    pos = torch.tensor([0, 1, 127, 128, 129, 255, 256, 300, 511, 512, 640, 767, 900, 1023, 1024,
                        S - 2], dtype=torch.int32, device="cuda")  # the last row runs past S for G > 2
    n_cases = 0
    for KV, H in ((1280, 20), (768, 12)):
        for cache_dtype, rows_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                                        (torch.int8, torch.bfloat16), (torch.int8, torch.float32),
                                        (torch.bfloat16, torch.float32)):
            for G in (1, 2, 5):
                qkv = (torch.randn(B, G, 3 * KV, generator=gen, device="cuda") * 3).to(rows_dtype)
                if cache_dtype == torch.int8:
                    qkv[0, 0, KV : 2 * KV] = 0  # an all-zero row: the 1e-8 scale floor
                rows_k, rows_v = qkv[..., KV : 2 * KV], qkv[..., 2 * KV :]
                lc = {}
                for name in ("k", "v"):  # caches full of other values, to see what is touched
                    old = torch.randn(B, S, KV, generator=gen, device="cuda")
                    if cache_dtype == torch.int8:
                        lc[name], lc[name + "s"] = _quantize_rows(old)
                    else:
                        lc[name] = old.to(cache_dtype)
                want = write_rows_reference({n: t.clone() for n, t in lc.items()}, rows_k, rows_v, pos)
                before = {n: t.clone() for n, t in lc.items()}
                write_rows_per_row(lc, rows_k, rows_v, pos)
                torch.cuda.synchronize()
                for n in lc:
                    require(torch.equal(lc[n], want[n]),
                            f"cache update KV={KV} {cache_dtype} from {rows_dtype} G={G}: '{n}' differs "
                            f"from the plain version in {(lc[n] != want[n]).sum().item()} places")
                    require(not torch.equal(lc[n], before[n]), f"cache update: '{n}' was not written")
                n_cases += 1
    log(f"[cache update] {n_cases} cases (KV 1280 and 768; bf16, fp32 and int8 caches from bf16 and "
        f"fp32 rows; G = 1, 2, 5; B={B}, S={S}, uneven pos, a row past the end skipped): K, V and "
        f"scale buffers equal the plain version's bit for bit, whole buffers compared")

    # times at the verify shape: G = 5 rows of 1280 into bf16 and int8 caches
    pos = torch.full((B,), 1020, dtype=torch.int32, device="cuda")
    G, KV = 5, 1280
    qkv = torch.randn(B, G, 3 * KV, generator=gen, device="cuda").bfloat16()
    rows_k, rows_v = qkv[..., KV : 2 * KV], qkv[..., 2 * KV :]
    bidx = torch.arange(B, device="cuda")[:, None].expand(B, G)
    at = pos[:, None].long() + torch.arange(G, device="cuda")
    for name, cache_dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        lc = {n: torch.zeros(B, S, KV, dtype=cache_dtype, device="cuda") for n in ("k", "v")}
        if cache_dtype == torch.int8:
            lc.update(ks=torch.zeros(B, S, device="cuda"), vs=torch.zeros(B, S, device="cuda"))

        def library():  # one index_put_ per buffer, after the port's _quantize_rows for int8
            for n, rows in (("k", rows_k), ("v", rows_v)):
                if cache_dtype == torch.int8:
                    q8, scale = _quantize_rows(rows)
                    lc[n].index_put_((bidx, at), q8)
                    lc[n + "s"].index_put_((bidx, at), scale)
                else:
                    lc[n].index_put_((bidx, at), rows)

        ms = graph_ms(lambda: write_rows_per_row(lc, rows_k, rows_v, pos))
        library_ms = graph_ms(library)
        # the plain version selects the in-range rows with a boolean mask, which
        # waits for the device: it cannot be captured, so its time is an eager
        # call's, host launch path included
        plain_ms = median_ms(lambda: write_rows_reference(lc, rows_k, rows_v, pos), iters=20)
        moved = 2 * B * G * KV * (2 + lc["k"].element_size()) + (2 * B * G * 4 if "ks" in lc else 0)
        bnd = bound(moved + _nbytes(pos))
        log(f"[cache update] {name} cache, [16, 5, 1280] bf16 rows: kernel {ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.6f} ms ({bnd['bound_by']}: {moved / 1e6:.2f} MB), library call "
            f"(index_put_{' after _quantize_rows' if 'ks' in lc else ''}) {library_ms:.4f} ms "
            f"(device time, CUDA-graph replay); plain {plain_ms:.4f} ms (one eager call)")
        if name == "bf16":
            records["cache_update"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                       "library_ms": library_ms, **bnd}
        else:
            records["cache_update"].update(int8_ms=ms, int8_plain_ms=plain_ms,
                                           int8_library_ms=library_ms, int8_bound_ms=bnd["bound_ms"])


def phase_fused_write(records: dict) -> None:
    """The KV row write fused into the tensor-core decode and chunk kernels
    (`decode_attention_write`, `chunk_attention_write`) against
    `write_rows_per_row` followed by the unfused kernel on the same inputs:
    whole K, V and scale buffers and the outputs equal bit for bit, bf16 and
    int8 caches, B = 1, 2, 16 (the split kernels below 132 blocks), keys at
    tile, warp and block edges, chunks at uneven positions with rows past the
    cache, a key-valid mask that masks the new rows; then 30 layers' worth of
    each, cold, by graph replay: the fused call's excess over the attention
    alone is the row write's time."""
    import torch

    from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row, write_rows_reference
    from video_tokenizer_tpu_torch.ops.decode_attention import (
        _quantize_rows, chunk_attention, chunk_attention_write, chunk_splits, decode_attention,
        decode_attention_write, decode_heads_per_block, decode_splits,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    S, D = 1152, 64

    def caches(B, KV, cache_dtype):  # full of other values, to see what is touched
        lc = {}
        for n in ("k", "v"):
            old = torch.randn(B, S, KV, generator=gen, device="cuda")
            if cache_dtype == torch.int8:
                lc[n], lc[n + "s"] = _quantize_rows(old)
            else:
                lc[n] = old.to(cache_dtype)
        return lc

    def qkv_of(B, G, H, Hkv, dtype):
        qkv = (torch.randn(B, G, (H + 2 * Hkv) * D, generator=gen, device="cuda") * 3).to(dtype)
        return (qkv[..., : H * D].unflatten(-1, (H, D)), qkv[..., H * D : (H + Hkv) * D],
                qkv[..., (H + Hkv) * D :])

    def masking(B, new_keys):  # random keys masked, key 0 kept, the new keys masked
        valid = torch.rand(B, S, generator=gen, device="cuda") > 0.3
        valid[:, 0] = True
        valid.scatter_(1, new_keys.clamp(max=S - 1), False)
        valid[:, 0] |= new_keys.min(1).values == 0  # a row whose only key is new keeps it
        return valid

    def check(what, fused_lc, sep_lc, got, want, before):
        for n in sep_lc:
            require(torch.equal(fused_lc[n], sep_lc[n]),
                    f"fused write {what}: '{n}' differs from write_rows_per_row's in "
                    f"{(fused_lc[n] != sep_lc[n]).sum().item()} places")
        require(not torch.equal(fused_lc["k"], before["k"]), f"fused write {what}: nothing written")
        require(torch.equal(got, want), f"fused write {what}: outputs differ by "
                                        f"{(got.float() - want.float()).abs().max().item()}")

    H = Hkv = 20
    n_dec = 0
    splits_seen = set()
    for cache_dtype in (torch.bfloat16, torch.int8):
        for B in (1, 2, 16):
            lc0 = caches(B, Hkv * D, cache_dtype)
            q, rows_k, rows_v = qkv_of(B, 1, H, Hkv, torch.bfloat16)
            q = q[:, 0]
            splits_seen.add(decode_splits(B, Hkv, S, decode_heads_per_block(cache_dtype, H, Hkv)))
            for pos in (0, 15, 16, 63, 64, 511, 1023, S - 1):
                pos_t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
                pos_b = pos_t.expand(B).contiguous()
                for masked in (False, True):
                    valid = masking(B, pos_b[:, None].long()) if masked else None
                    fused = {n: t.clone() for n, t in lc0.items()}
                    sep = {n: t.clone() for n, t in lc0.items()}
                    got = decode_attention_write(q, rows_k, rows_v, fused, pos_t, key_valid=valid,
                                                 kv_heads=Hkv)
                    write_rows_per_row(sep, rows_k, rows_v, pos_b)
                    want = decode_attention(q, sep["k"], sep["v"], pos_t, key_valid=valid,
                                            k_scale=sep.get("ks"), v_scale=sep.get("vs"),
                                            kv_heads=Hkv)
                    torch.cuda.synchronize()
                    check(f"decode {str(cache_dtype)[6:]} B={B} pos {pos} mask {masked}",
                          fused, sep, got, want, lc0)
                    n_dec += 1
            del lc0
    log(f"[fused write] decode: {n_dec} cases (bf16 and int8 caches, B = 1, 2, 16: "
        f"{sorted(splits_seen)} splits; pos 0, 15, 16, 63, 64, 511, 1023, {S - 1}; with and "
        f"without a key-valid mask that masks the new row): K, V and scale buffers and outputs "
        f"equal write_rows_per_row + decode_attention bit for bit")

    n_chunk = 0
    edges = [0, 15, 16, 63, 64, 511, 1023, S - 1, S - 3, 100, 200, 300, 12, 14, 60, 62]
    for name, H, Hkv, cache_dtype, q_dtype, Gs in (
        ("verify", 20, 20, torch.bfloat16, torch.bfloat16, (1, 5)),
        ("verify", 20, 20, torch.int8, torch.bfloat16, (1, 5)),
        ("verify fp32 q", 20, 20, torch.bfloat16, torch.float32, (5,)),
        ("draft", 12, 12, torch.int8, torch.bfloat16, (2,)),
    ):
        for B in (1, 2, 16):
            lc0 = caches(B, Hkv * D, cache_dtype)
            for G in Gs:
                q, rows_k, rows_v = qkv_of(B, G, H, Hkv, q_dtype)
                for at in range(0, len(edges), B):  # every edge position in some row
                    pos = torch.tensor((edges * 2)[at : at + B], dtype=torch.int32, device="cuda")
                    new = pos[:, None].long() + torch.arange(G, device="cuda")
                    for masked in (False, True):
                        valid = masking(B, new) if masked else None
                        fused = {n: t.clone() for n, t in lc0.items()}
                        sep = {n: t.clone() for n, t in lc0.items()}
                        got = chunk_attention_write(q, rows_k, rows_v, fused, pos, key_valid=valid,
                                                    kv_heads=Hkv)
                        write_rows_per_row(sep, rows_k, rows_v, pos)
                        want = chunk_attention(q, sep["k"], sep["v"], pos, key_valid=valid,
                                               k_scale=sep.get("ks"), v_scale=sep.get("vs"),
                                               kv_heads=Hkv)
                        torch.cuda.synchronize()
                        check(f"chunk {name} {str(cache_dtype)[6:]} B={B} G={G} pos "
                              f"{pos.tolist()} mask {masked}", fused, sep, got, want, lc0)
                        n_chunk += 1
            del lc0
    log(f"[fused write] chunk: {n_chunk} cases (the verify shape G = 1 and 5 with bf16 and int8 "
        f"caches, fp32 queries and rows over a bf16 cache, the draft's G = 2 with an int8 cache; "
        f"B = 1, 2, 16: {chunk_splits('chunk_attn_sm90_kernel', 1, 20, S)} / "
        f"{chunk_splits('chunk_attn_sm90_kernel', 2, 20, S)} / 1 splits; uneven positions at "
        f"tile, warp and block edges, rows past the cache; with and without a mask on the new "
        f"rows): buffers and outputs equal write_rows_per_row + chunk_attention bit for bit")

    # a fused launch captured in a CUDA graph (its shared memory includes the
    # staged rows) still replays after unfused launches of the same kernel
    B, H, Hkv = 16, 20, 20
    for cache_dtype in (torch.bfloat16, torch.int8):
        lc = caches(B, Hkv * D, cache_dtype)
        q, rows_k, rows_v = qkv_of(B, 1, H, Hkv, torch.bfloat16)
        q = q[:, 0]
        pos_t = torch.full((1,), 700, dtype=torch.int32, device="cuda")
        want = decode_attention_write(q, rows_k, rows_v, lc, pos_t, kv_heads=Hkv)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            decode_attention_write(q, rows_k, rows_v, lc, pos_t, kv_heads=Hkv)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = decode_attention_write(q, rows_k, rows_v, lc, pos_t, kv_heads=Hkv)
        decode_attention(q, lc["k"], lc["v"], pos_t, k_scale=lc.get("ks"), v_scale=lc.get("vs"),
                         kv_heads=Hkv)
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"fused write {cache_dtype}: the captured launch, "
                                        f"replayed after an unfused one, differs")
    log("[fused write] a captured fused launch replays after unfused launches of the same "
        "kernel (bf16 and int8 caches): same output")

    # 30 layers' caches (distinct: cold, as a step reads them), one call per
    # layer in a graph; in turn: fused, attention alone, separate write +
    # attention, and back
    B, H, Hkv, layers = 16, 20, 20, 30
    rec: dict = {}
    for cache_dtype in (torch.bfloat16, torch.int8):
        lcs = [caches(B, Hkv * D, cache_dtype) for _ in range(layers)]
        tag = str(cache_dtype)[6:]
        for kind, G in (("decode", 1), ("chunk", 5)):
            q, rows_k, rows_v = qkv_of(B, G, H, Hkv, torch.bfloat16)
            for pos in (512, 1024):
                pos_t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
                pos_b = pos_t.expand(B).contiguous()

                def attend(lc):
                    kw = dict(k_scale=lc.get("ks"), v_scale=lc.get("vs"), kv_heads=Hkv)
                    if kind == "decode":
                        return decode_attention(q[:, 0], lc["k"], lc["v"], pos_t, **kw)
                    return chunk_attention(q, lc["k"], lc["v"], pos_b, **kw)

                def fused():
                    for lc in lcs:
                        if kind == "decode":
                            decode_attention_write(q[:, 0], rows_k, rows_v, lc, pos_t, kv_heads=Hkv)
                        else:
                            chunk_attention_write(q, rows_k, rows_v, lc, pos_b, kv_heads=Hkv)

                def alone():
                    for lc in lcs:
                        attend(lc)

                def separate():
                    for lc in lcs:
                        write_rows_per_row(lc, rows_k, rows_v, pos_b)
                        attend(lc)

                runs = {"fused": fused, "alone": alone, "separate": separate}
                times: dict = {k: [] for k in runs}
                for k in ("fused", "alone", "separate", "separate", "alone", "fused"):
                    times[k].append(graph_ms(runs[k], launches=1, replays=5) / layers)
                t = {k: min(v) for k, v in times.items()}
                excess, sep_cost = t["fused"] - t["alone"], t["separate"] - t["alone"]
                log(f"[fused write] {kind} {tag} cache, B={B} G={G} at pos {pos}, {layers} layers' "
                    f"caches, per layer: fused {t['fused'] * 1e3:.2f} us, attention alone "
                    f"{t['alone'] * 1e3:.2f}, separate write + attention {t['separate'] * 1e3:.2f} "
                    f"(in turn: " + ", ".join(f"{k} {' / '.join(f'{x * 1e3:.2f}' for x in v)}"
                                             for k, v in times.items())
                    + f"): the fused write's excess {excess * 1e3:.2f} us against "
                    f"{sep_cost * 1e3:.2f} us for the separate launch; {layers} layers save "
                    f"{(t['separate'] - t['fused']) * layers * 1e3:.1f} us (device time, CUDA-graph "
                    f"replay)")
                rec[f"{kind}_{tag}_{pos}"] = dict(excess_ms=excess, separate_ms=sep_cost,
                                                  fused_ms=t["fused"], alone_ms=t["alone"])
        del lcs
    # what the write alone moves, one decode step's rows (the bound), its plain
    # version (eager: its boolean mask waits for the device) and index_put_
    lc = caches(B, Hkv * D, torch.bfloat16)
    _, rows_k, rows_v = qkv_of(B, 1, H, Hkv, torch.bfloat16)
    pos_b = torch.full((B,), 512, dtype=torch.int32, device="cuda")
    bidx, at = torch.arange(B, device="cuda")[:, None], pos_b[:, None].long()
    plain_ms = median_ms(lambda: write_rows_reference(lc, rows_k, rows_v, pos_b), iters=20)
    library_ms = graph_ms(lambda: (lc["k"].index_put_((bidx, at), rows_k),
                                   lc["v"].index_put_((bidx, at), rows_v)))
    bnd = bound(2 * _nbytes(rows_k, rows_v) + _nbytes(pos_b))
    head = rec["decode_bfloat16_512"]
    records["kv_row_write_fused"] = {
        "max_abs_err": 0.0, "ms": head["excess_ms"], "earlier_ms": head["separate_ms"],
        "plain_ms": plain_ms, "library_ms": library_ms, **bnd,
        **{f"{k}_{m}": v[m] for k, v in rec.items() for m in ("excess_ms", "separate_ms")}}
    log(f"[fused write] one decode step's rows [16, 1, 1280] bf16: bound {bnd['bound_ms']:.6f} ms "
        f"({bnd['bound_by']}), plain {plain_ms:.4f} ms (one eager call), library call "
        f"(index_put_ on K and V) {library_ms:.4f} ms (CUDA-graph replay)")


# (K, N) of the projections of one decode step, in layer order: 30 layers of
# the 632M prior (wqkv, wo, w1, w3, w2) and its output head; the draft's 8
# layers and head
LP_PROJ = [(1280, 3840), (1280, 1280), (1280, 3584), (1280, 3584), (3584, 1280)] * 30 + [(1280, 8192)]
DRAFT_PROJ = [(768, 2304), (768, 768), (768, 2048), (768, 2048), (2048, 768)] * 8 + [(768, 8192)]


def phase_w8_matmul(records: dict) -> None:
    """The int8 matmul kernels against their plain version at every shape of
    the prior and its draft at the decode (M = 16), draft-chunk and
    self-draft (M = 32) and verify (M = 80) row counts, the NLL forward's M =
    8192 and ragged shapes (M > 128: 200, 1000, 4097, odd N), with every
    row-count instance of the streaming kernel (8-row tiles 1, 2, 4, 6, 8,
    10, 16: M = 1, 16, 32, 37, 64, 80, 128) launched at least once; wqkv at M
    = 8192 timed on the wgmma kernel, the earlier one and cuBLAS; then one
    decode step's 151 projections timed cold (distinct weights, 620 MB)."""
    import torch

    from video_tokenizer_tpu_torch.ops.quant_matmul import (
        _w8_launch, w8_kernel, w8_matmul, w8_matmul_reference, w8_streams,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    shapes = sorted({(M, K, N) for M in (16, 32, 80) for K, N in set(LP_PROJ)}
                    | {(M, K, N) for M in (16, 32) for K, N in set(DRAFT_PROJ)}
                    | {(8192, 1280, 3840), (37, 200, 77), (37, 208, 77), (1, 1280, 1280),
                       (64, 1280, 3584), (128, 768, 2304), (200, 1280, 3840), (1000, 3584, 1280),
                       (4097, 1280, 1280), (333, 768, 2305), (129, 200, 77)})
    worst = {}  # kernel -> (max abs error, max error of the output's scale), bf16 x
    for M, K, N in shapes:
        x32 = torch.randn(M, K, generator=gen, device="cuda")
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(N, generator=gen, device="cuda") * 2e-3 + 1e-4
        # bf16 x: bf16 outputs rounded once on each side, sums in another
        # order, 1e-2 of the output's scale; fp32 x: the kernel's products
        # are exact (x split into three bf16 parts), fp32 sums in another
        # order, 1e-5 of it (measured on an H100: at most 2.3e-6)
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            chosen = w8_kernel(M, K, dtype)
            rule = ("w8_sm90_kernel" if M > 128 and dtype == torch.bfloat16 and K % 64 == 0 else
                    "w8_matmul_kernel" if M > 128 or K % 16 or (M <= 16 and K <= 2048) else
                    "w8_stream_kernel")
            require(chosen == rule, f"w8 {M}x{K}x{N} {dtype}: the chooser names {chosen}")
            # the kernel the chooser names, through `w8_matmul`, and at every
            # shape the streaming kernel has an instance for, the other one as
            # well; beside the wgmma kernel, the earlier one
            kernels = [chosen] + [k for k in ("w8_stream_kernel", "w8_matmul_kernel") if k != chosen
                                  and (k == "w8_matmul_kernel" or w8_streams(M, K))]
            x = x32.to(dtype)
            for kernel in kernels:
                rel = abs_err = 0.0
                for double_round in (True, False):
                    def run():
                        if kernel == chosen:
                            return w8_matmul(x, w.t(), scale, double_round)
                        out = torch.empty(M, N, dtype=dtype, device="cuda")
                        _w8_launch(kernel, x, w, scale, out, double_round)
                        return out

                    got = run()
                    torch.cuda.synchronize()
                    if kernel == chosen:
                        require(w8_matmul.last_kernel == chosen,
                                f"w8 {M}x{K}x{N}: ran {w8_matmul.last_kernel}, not {chosen}")
                    want = w8_matmul_reference(x, w.t(), scale, double_round)
                    err = (got.float() - want.float()).abs().max().item()
                    rel, abs_err = max(rel, err / want.float().abs().max().item()), max(abs_err, err)
                    require(torch.isfinite(got).all().item(), f"w8 {M}x{K}x{N}: non-finite output")
                    # split K is summed in a fixed order: a launch repeats bit for bit
                    require(torch.equal(run(), got), f"w8 {M}x{K}x{N} {kernel}: two launches differ")
                log(f"[w8] [{M}, {K}] {str(dtype)[6:]} x [{K}, {N}] int8, {kernel}"
                    f"{' (chosen)' if kernel == chosen else ''}: max|kernel-plain|/max|plain| "
                    f"{rel:.2e} (tol {tol:g}), both epilogues")
                require(rel <= tol,
                        f"w8 {M}x{K}x{N} {dtype} {kernel}: error {rel} of the output's scale > {tol}")
                if dtype == torch.bfloat16:
                    a, r = worst.get(kernel, (0.0, 0.0))
                    worst[kernel] = (max(a, abs_err), max(r, rel))
        if (M, K, N) == (8192, 1280, 3840):
            # the NLL forward's wqkv on the wgmma kernel, on the earlier kernel
            # (through its own entry) and as cuBLAS on a bf16 copy of the weights
            x = x32.to(torch.bfloat16)
            out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
            ms = graph_ms(lambda: w8_matmul(x, w.t(), scale, True), launches=3)
            earlier_ms = graph_ms(lambda: _w8_launch("w8_matmul_kernel", x, w, scale, out, True),
                                  launches=3)
            plain_ms = graph_ms(lambda: w8_matmul_reference(x, w.t(), scale, True), launches=3)
            library_ms = graph_ms(lambda: (x @ w.t().to(torch.bfloat16)) * scale, launches=3)
            bnd = bound(_nbytes(x, w, scale) + M * N * 2, 2 * M * K * N)
            log(f"[w8] wqkv at M = 8192: w8_sm90_kernel {ms:.4f} ms ({2 * M * K * N / ms / 1e9:.1f} "
                f"TFLOP/s), the earlier w8_matmul_kernel {earlier_ms:.4f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain {plain_ms:.4f} ms, library "
                f"call (x @ w8.to(bf16) * s) {library_ms:.4f} ms (device time, CUDA-graph replay)")
            records["w8_matmul_sm90"] = {"ms": ms, "earlier_ms": earlier_ms, "plain_ms": plain_ms,
                                         "library_ms": library_ms, **bnd}
            # the earlier kernel keeps fp32 x, other K and the decode shapes;
            # its row at the shape it ran before the wgmma kernel took it
            records["w8_matmul_mma"] = {"ms": earlier_ms, "plain_ms": plain_ms,
                                        "library_ms": library_ms, **bnd}
    keys = {"w8_stream_kernel": "w8_matmul", "w8_matmul_kernel": "w8_matmul_mma",
            "w8_sm90_kernel": "w8_matmul_sm90"}
    for kernel, (a, r) in worst.items():
        records.setdefault(keys[kernel], {}).update(max_abs_err=a, max_rel_err=r)
    for name, M, proj in (("lp_m16", 16, LP_PROJ), ("lp_m80", 80, LP_PROJ),
                          ("draft_m16", 16, DRAFT_PROJ)):
        _w8_step_cold(records, name, M, proj, gen)


def _w8_step_cold(records: dict, name: str, M: int, proj, gen) -> None:
    """One decode step's projections with distinct weights (620 MB of int8 for
    the prior: none of them is in the 50 MB L2 when it is read), in layer
    order, one graph: all on the streaming kernel, all on the earlier kernel,
    each on the kernel `w8_kernel` names (as the model runs them), the plain
    version, and cuBLAS on bf16 copies of the weights. The three also with an
    elementwise kernel writing x before each product, as in the model (timed
    alone as well). Kernels in turn, twice."""
    import torch

    from video_tokenizer_tpu_torch.ops.quant_matmul import (
        _w8_launch, w8_kernel, w8_matmul, w8_matmul_reference,
    )

    ws = [torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
          for K, N in proj]
    scales = [torch.rand(N, generator=gen, device="cuda") * 2e-3 + 1e-4 for _, N in proj]
    xs = {K: torch.randn(M, K, generator=gen, device="cuda").bfloat16() for K, _ in set(proj)}
    outs = [torch.empty(M, N, dtype=torch.bfloat16, device="cuda") for _, N in proj]
    n_bytes = sum(w.numel() for w in ws)
    chosen = {}
    for K, _ in proj:
        kernel = w8_kernel(M, K, torch.bfloat16)
        chosen[kernel] = chosen.get(kernel, 0) + 1

    def step(kernel, touch=False):
        def run():
            for (K, _), w, s, o in zip(proj, ws, scales, outs):
                if touch:
                    xs[K].mul_(1.0)  # an elementwise kernel writes x first, as in the model
                if kernel == "chosen":
                    w8_matmul(xs[K], w.t(), s, True)
                elif kernel != "none":
                    _w8_launch(kernel, xs[K], w, s, o, True)
        return run

    kernels = ("w8_stream_kernel", "w8_matmul_kernel", "chosen")
    times = {(k, t): [] for t in (False, True) for k in kernels}
    for _ in range(2):
        for (kernel, touch), ms in times.items():
            ms.append(graph_ms(step(kernel, touch), launches=1, replays=5))
    touch_ms = graph_ms(step("none", touch=True), launches=1, replays=5)
    best = {key: min(ms) for key, ms in times.items()}
    wb = [w.to(torch.bfloat16) for w in ws]  # cuBLAS's bf16 copies: twice the bytes

    def cublas():
        for (K, _), w in zip(proj, wb):
            torch.matmul(xs[K], w.t())

    library_ms = graph_ms(cublas, launches=1, replays=5)
    del wb
    plain_ms = median_ms(lambda: [w8_matmul_reference(xs[K], w.t(), s, True)
                                  for (K, _), w, s in zip(proj, ws, scales)], iters=3, warmup=1)
    flops = sum(2 * M * K * N for K, N in proj)
    bnd = bound(n_bytes + sum(_nbytes(s, o) for s, o in zip(scales, outs)), flops)
    ms = best[("w8_stream_kernel", False)]
    for touch in (False, True):
        log(f"[w8 cold] {name}: one step's {len(proj)} projections at M = {M}, {n_bytes / 1e6:.0f} MB "
            f"of int8 weights, {'each after an elementwise kernel, as in the model' if touch else 'back to back'}: "
            + ", ".join(f"{'as w8_kernel names them ' + str(chosen) if k == 'chosen' else 'all on ' + k} "
                        + " / ".join(f"{t:.4f}" for t in times[(k, touch)]) + " ms" for k in kernels)
            + (f" (in turn; the {len(proj)} elementwise kernels alone {touch_ms:.4f} ms)" if touch else
               f"; w8_stream_kernel {n_bytes / ms / 1e6:.0f} GB/s; cuBLAS on bf16 copies "
               f"({2 * n_bytes / 1e6:.0f} MB) {library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
               f"({bnd['bound_by']}) (device time, CUDA-graph replay); plain {plain_ms:.2f} ms (eager)"))
        new, old = best[("w8_stream_kernel", touch)], best[("w8_matmul_kernel", touch)]
        if new >= old:
            log(f"[w8 cold] {name}, {'after elementwise kernels' if touch else 'back to back'}: "
                f"w8_stream_kernel ({new:.4f} ms) is NOT faster than the earlier kernel ({old:.4f} ms)")
    rec = {"ms": ms, "earlier_ms": best[("w8_matmul_kernel", False)],
           "chosen_ms": best[("chosen", False)],
           "after_elementwise_ms": best[("w8_stream_kernel", True)],
           "after_elementwise_earlier_ms": best[("w8_matmul_kernel", True)],
           "after_elementwise_chosen_ms": best[("chosen", True)], "elementwise_alone_ms": touch_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, **bnd}
    if name == "lp_m16":
        records.setdefault("w8_matmul", {}).update(rec)
    else:
        records["w8_matmul"].update({f"{name}_{k}": v for k, v in rec.items() if k != "bound_by"})
    del ws


def _perturb(model, seed: int) -> None:
    """Bench-style: every weight of rank >= 2 += 0.02 * N(0, 1) (the output
    layer is zero-initialised, so a fresh model would decode zeros)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2 and p.requires_grad:  # a frozen codebook stays as it is
                p.add_(0.02 * torch.randn(p.shape, generator=gen).to(p.device))


def phase_e2e_fp32():
    import torch

    from video_tokenizer_tpu_torch import flagship_tokenizer

    model = flagship_tokenizer(dtype=torch.float32, generator=torch.Generator().manual_seed(SEED))
    _perturb(model, SEED + 9)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.rand(1, 3, 16, 128, 128, generator=torch.Generator().manual_seed(SEED + 2))
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = model(x)
        ref_dec = model.decode_from_bottleneck(ref["bottleneck_rep"])
    cpu_s = time.perf_counter() - t0
    model.cuda()
    with torch.inference_mode():
        got = model(x.cuda())
        got_dec = model.decode_from_bottleneck(ref["bottleneck_rep"].cuda())
    torch.cuda.synchronize()
    agree = (got["bottleneck_rep"].cpu() == ref["bottleneck_rep"]).float().mean().item()
    dec_err = (got_dec.cpu() - ref_dec).abs().max().item()
    scale = ref_dec.abs().max().item()
    pred_err = (got["pred_frames"].cpu() - ref["pred_frames"]).abs().max().item()
    log(f"[e2e fp32] flagship {n_params:,} params, S = 2048, batch 1, TF32 off; "
        f"CPU plain path {cpu_s:.1f} s")
    log(f"[e2e fp32] bottleneck_rep agreement {agree:.4%} (tol >= 99%); "
        f"decode_from_bottleneck max|card-cpu| {dec_err:.3e} vs 1e-3 * max|ref| = {1e-3 * scale:.3e}; "
        f"pred_frames max|card-cpu| {pred_err:.3e}")
    require(tuple(got["pred_frames"].shape) == (1, 3, 16, 128, 128), "fp32 pred_frames shape")
    require(agree >= 0.99, f"bottleneck_rep agreement {agree}")
    require(dec_err <= 1e-3 * scale, f"decode_from_bottleneck error {dec_err} > {1e-3 * scale}")
    return model


def phase_e2e_bf16(model_fp32, records: dict) -> None:
    import numpy as np
    import torch

    from video_tokenizer_tpu_torch import flagship_tokenizer
    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
    from video_tokenizer_tpu_torch.ops.vq import vq_argmax
    from video_tokenizer_tpu_torch.reconstruct import make_clips, reconstruct
    from video_tokenizer_tpu_torch.utils.common import psnr_from_mse

    model = flagship_tokenizer(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    model.load_state_dict(model_fp32.state_dict())
    model.cuda().eval()
    B = 8
    x = torch.from_numpy(make_clips(np.random.default_rng(SEED), B, 16, 128)).cuda()
    reconstruct(model, x)  # warm-up
    torch.cuda.synchronize()

    iters = 5
    flash_attn_fwd.launches = flash_attn_fwd.launches_sm90 = 0
    vq_argmax.launches = vq_argmax.launches_tc = 0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        rec = reconstruct(model, x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"flash_attn_fwd": flash_attn_fwd.launches, "vq_argmax": vq_argmax.launches}
    sm90_launches, vq_tc = flash_attn_fwd.launches_sm90, vq_argmax.launches_tc

    clips_per_s = B / statistics.median(times)
    mse = torch.mean((rec - x).reshape(B, -1) ** 2, dim=-1)
    ref = reconstruct(model_fp32, x[:1])
    bf16_vs_fp32 = (rec[:1] - ref).abs().mean().item()
    log(f"[e2e bf16] batch {B} clips [8,3,16,128,128]: median {statistics.median(times) * 1e3:.2f} ms "
        f"over {iters} iterations = {clips_per_s:.2f} clips/s; "
        f"mse {mse.mean().item():.5f}, psnr {psnr_from_mse(mse).mean().item():.3f} dB")
    log(f"[e2e bf16] launches in {iters} forwards: flash {launches['flash_attn_fwd']}, "
        f"vq {launches['vq_argmax']} (expect {24 * iters} and {iters}), of the flash launches "
        f"{sm90_launches} the wgmma kernel (expect all), of the VQ launches {vq_tc} "
        f"vq_tc_kernel (expect all); mean|bf16 - fp32| of clip 0: {bf16_vs_fp32:.3e} (tol 1e-2)")
    require(tuple(rec.shape) == (B, 3, 16, 128, 128), "bf16 reconstruction shape")
    require(torch.isfinite(rec).all().item() and torch.isfinite(mse).all().item(), "non-finite output")
    # bf16 activations through 24 layers against the fp32 card path: about
    # 2e-3 mean deviation on [0, 1] pixels; 1e-2 flags a broken dtype policy
    require(bf16_vs_fp32 <= 1e-2, f"bf16 drifts from fp32 by {bf16_vs_fp32} on average")
    require(launches == {"flash_attn_fwd": 24 * iters, "vq_argmax": iters},
            f"launch counts {launches}")
    require(sm90_launches == 24 * iters, f"{sm90_launches} of the flash launches ran the wgmma kernel")
    require(vq_tc == iters, f"{vq_tc} of the VQ launches ran vq_tc_kernel")
    for name, n in launches.items():
        records[name]["launches"] = n
    return model


def phase_ar_fp32(records: dict):
    """Full-width prior in fp32, card vs CPU: prefill + 16 decode steps whose
    inputs are the CPU's greedy tokens on both sides, so that a difference
    in one step does not compound. Three ways: fp32 weights; int8 weights
    (`quantize_model`, fp32 activations); int8 weights with an int8 KV
    cache, whose rows are quantised on the device and written at a device
    position. Returns the fp32 card model."""
    import torch

    from video_tokenizer_tpu_torch import flagship_ar
    from video_tokenizer_tpu_torch.models.larp_ar import quantize_model
    from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row
    from video_tokenizer_tpu_torch.ops.decode_attention import decode_attention

    decode_attention.launches = decode_attention.launches_sm90 = 0
    decode_attention.launches_fused = write_rows_per_row.launches = 0
    model = flagship_ar(torch.float32, torch.Generator().manual_seed(SEED + 20))
    _perturb(model, SEED + 21)
    qmodel = quantize_model(model)
    n_params = sum(p.numel() for p in model.parameters())
    cond = torch.tensor([3, 7, 50, 101])  # 101 is the null (CFG) class
    steps = 16

    def run(m, device, cache_dtype, tokens=None):
        logits_all, chosen = [], []
        with torch.inference_mode():
            cache = m.init_cache(len(cond), 1 + 1024, cache_dtype)
            logits, _ = m.prefill(cond.to(device), cache)
            logits_all.append(logits[:, -1].cpu())
            for i in range(1, steps + 1):
                tok = logits_all[-1].argmax(-1, keepdim=True).int() if tokens is None else tokens[i - 1]
                chosen.append(tok)
                logits, _ = m.decode_step(tok.to(device), i, cache)
                logits_all.append(logits[:, -1].cpu())
        return torch.stack(logits_all), chosen, {k: t.cpu() for k, t in cache[0].items()}

    # fp32 cache: the same sums in another order, 1e-3 of the logit scale
    # and >= 99% argmax agreement. int8 cache: a ~1e-6 card-vs-CPU
    # difference moves a few int8 K/V values across a rounding boundary, a
    # step of 1/127 of the row's amax; the layers after it see inputs that
    # differ by that much and flip more, so the two sides end up as two
    # int8 quantisations of one computation (measured on an H100: 9.6e-3 of
    # the logit scale, 98.5% argmax agreement). Bound 3e-2 and >= 95%; what
    # the cascade hides is checked where it cannot reach, in layer 0's cache
    # (its inputs are the same tokens on both sides), below.
    for name, m, cache_dtype, tol, min_agree in (
        ("fp32", model, torch.float32, 1e-3, 0.99),
        ("int8 weights", qmodel, torch.float32, 1e-3, 0.99),
        ("int8 weights + int8 KV", qmodel, torch.int8, 3e-2, 0.95),
    ):
        t0 = time.perf_counter()
        m.cpu()
        ref, tokens, ref_lc = run(m, "cpu", cache_dtype)
        cpu_s = time.perf_counter() - t0
        m.cuda()
        got, _, got_lc = run(m, "cuda", cache_dtype, tokens)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"[ar fp32] {name}: llama-abs-LP {n_params:,} params, batch {len(cond)}, prefill + "
            f"{steps} forced decode steps, TF32 off; CPU plain path {cpu_s:.1f} s")
        log(f"[ar fp32] {name}: max|card-cpu| logit {err:.3e} = {err / scale:.2e} of "
            f"max|logit| {scale:.3e} (tol {tol:g}); argmax agreement {agree:.2%} "
            f"(tol >= {min_agree:.0%})")
        require(torch.isfinite(got).all().item(), f"AR {name}: non-finite logits")
        require(err <= tol * scale, f"AR {name}: logit error {err} > {tol * scale}")
        require(agree >= min_agree, f"AR {name}: argmax agreement {agree}")
        if cache_dtype == torch.int8:
            # layer 0's int8 rows at positions 0..16, written on the card at a
            # device position: the same int8 values but for rounding-boundary
            # flips of one step, the same row scales to 1e-5, nothing past 16
            live = steps + 1
            flips = max_step = scale_err = 0.0
            for q8, sname in (("k", "ks"), ("v", "vs")):
                d = (got_lc[q8].int() - ref_lc[q8].int()).abs()
                flips = max(flips, (d[:, :live] > 0).float().mean().item())
                max_step = max(max_step, d.max().item())
                rel = (got_lc[sname][:, :live] - ref_lc[sname][:, :live]).abs() / ref_lc[sname][:, :live]
                scale_err = max(scale_err, rel.max().item())
                require(not got_lc[q8][:, live:].any() and not got_lc[sname][:, live:].any(),
                        f"AR {name}: layer 0's cache written past position {live - 1}")
                require(bool((ref_lc[sname][:, :live] > 0).all()), f"AR {name}: a row scale is 0")
            log(f"[ar fp32] {name}: layer 0 cache rows 0..{live - 1}, card vs CPU: {flips:.2e} "
                f"of int8 values differ, by at most {max_step:g} (tol 1e-3, 1); row scales "
                f"{scale_err:.2e} (tol 1e-5); rows past {live - 1} untouched")
            require(flips <= 1e-3 and max_step <= 1 and scale_err <= 1e-5,
                    f"AR {name}: layer 0's int8 cache differs: {flips}, {max_step}, {scale_err}")
    # fp32 queries: every decode attention of the parity path on the earlier
    # kernel, each after its layer's row write by csrc/cache_update.cu
    n, n_sm90 = decode_attention.launches, decode_attention.launches_sm90
    n_rows, n_fused = write_rows_per_row.launches, decode_attention.launches_fused
    log(f"[ar fp32] {n} decode attentions on the card, {n_sm90} by decode_attn_sm90_kernel "
        f"(expect {3 * steps * 30} and 0: fp32 queries); {n_rows} row writes by "
        f"write_rows_per_row, {n_fused} fused (expect {3 * steps * 30} and 0)")
    require(n == 3 * steps * 30 and n_sm90 == 0, "AR fp32: decode attention off the earlier kernel")
    require(n_rows == 3 * steps * 30 and n_fused == 0, "AR fp32: row writes off write_rows_per_row")
    records["decode_attention_split"]["launches"] = n
    records["cache_update"]["launches"] = n_rows
    del qmodel
    return model


def _kernels_in(fn) -> dict:
    """{kernel name: launches} of the device work of one fn(), by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found[e.name] = found.get(e.name, 0) + 1
    return found


def _w8_streamed(model, M: int, kernel: str = "w8_stream_kernel") -> int:
    """How many of one forward's int8 projections at M rows of bf16 x
    `w8_kernel` puts on `kernel`."""
    import torch

    from video_tokenizer_tpu_torch.models.larp_ar import QuantDense
    from video_tokenizer_tpu_torch.ops.quant_matmul import w8_kernel

    return sum(w8_kernel(M, m.weight.shape[1], torch.bfloat16) == kernel
               for m in model.modules() if isinstance(m, QuantDense))


def _step_ms_by_w8_kernel(model, tok, pos, cache) -> dict:
    """{choice: [ms, ms]}: the device time of one decode step (graph replay)
    with its int8 projections on the kernels `w8_kernel` names ("chosen"),
    all on the earlier w8_matmul_kernel, and all on w8_stream_kernel, the
    chooser replaced for the capture; in turn, twice."""
    import importlib

    from video_tokenizer_tpu_torch.models.larp_ar import QuantDense

    qm = importlib.import_module("video_tokenizer_tpu_torch.ops.quant_matmul")
    chooser = qm.w8_kernel
    choices = {
        "chosen": chooser,
        "w8_matmul_kernel": lambda M, K, dtype: "w8_matmul_kernel",
        "w8_stream_kernel": lambda M, K, dtype: ("w8_stream_kernel" if qm.w8_streams(M, K)
                                                 else chooser(M, K, dtype)),
    }
    streamed = {"chosen": _w8_streamed(model, tok.shape[0]), "w8_matmul_kernel": 0,
                "w8_stream_kernel": sum(isinstance(m, QuantDense) for m in model.modules())}
    times: dict = {c: [] for c in choices}
    try:
        for _ in range(2):
            for choice, ms in times.items():
                qm.w8_kernel = choices[choice]
                ms.append(graph_ms(lambda: model.decode_step(tok, pos, cache), launches=1, replays=50))
                before = qm.w8_matmul.launches_stream
                model.decode_step(tok, pos, cache)
                ran = qm.w8_matmul.launches_stream - before
                require(ran == streamed[choice],
                        f"step as {choice}: {ran} projections on w8_stream_kernel, not {streamed[choice]}")
    finally:
        qm.w8_kernel = chooser
    return times


def _step_fused_vs_separate(model, tok, pos, cache) -> dict:
    """{"fused" / "separate": ([ms, ms], kernels)}: the device time of one
    decode step (graph replay, in turn, twice) and its exact kernel count
    (the kernel nodes of the step's captured graph, `graph_kernels`) with the
    K/V rows written inside the decode attention as `fuses_row_write` says,
    and with that chooser answering no, so that each layer's rows go through
    `write_rows_per_row` first."""
    import importlib

    ar = importlib.import_module("video_tokenizer_tpu_torch.models.larp_ar")
    chooser = ar.fuses_row_write
    choices = {"fused": chooser, "separate": lambda *a, **k: False}
    out: dict = {c: ([], 0) for c in choices}
    try:
        for _ in range(2):
            for c, (ms, _) in out.items():
                ar.fuses_row_write = choices[c]
                ms.append(graph_ms(lambda: model.decode_step(tok, pos, cache), launches=1, replays=50))
        for c in choices:
            ar.fuses_row_write = choices[c]
            out[c] = (out[c][0], graph_kernels(lambda: model.decode_step(tok, pos, cache)))
    finally:
        ar.fuses_row_write = chooser
    return out


def phase_ar_sampling(model_fp32, tokenizer, records: dict) -> None:
    import torch

    from video_tokenizer_tpu_torch.generation import generate
    from video_tokenizer_tpu_torch.models.larp_ar import quantize_model
    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
    from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row
    from video_tokenizer_tpu_torch.ops.decode_attention import decode_attention
    from video_tokenizer_tpu_torch.ops.quant_matmul import w8_matmul

    bf16 = model_fp32.to(torch.bfloat16)  # in place: the same perturbed weights
    int8 = quantize_model(bf16)
    B = 8
    labels = torch.tensor([0, 5, 17, 33, 50, 64, 88, 100], device="cuda")
    kernels = (flash_attn_fwd, decode_attention, w8_matmul, write_rows_per_row)
    results, step_ms_of = {}, {}
    # bf16 samples whole 1024-code videos; the int8 modes 256 codes each, the
    # host setting the pace of every step (1024 before phase 21 ran)
    for name, model, kv, new in (("bf16", bf16, None, 1024), ("int8", int8, None, 256),
                                 ("int8_kv8", int8, torch.int8, 256)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
        kw = dict(cfg_scale=1.5, top_k=100, cache_dtype=kv)
        generate(model, labels, 8, gen, **kw)  # warm-up
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        decode_attention.launches_sm90 = w8_matmul.launches_stream = w8_matmul.launches_sm90 = 0
        decode_attention.launches_fused = 0
        t0 = time.perf_counter()
        seq = generate(model, labels, new, gen, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.inference_mode():
            t1 = time.perf_counter()
            _, nll = model(seq[:, :-1], labels, targets=seq)
            torch.cuda.synchronize()
            nll_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            # the decoder takes whole samples of 1024 codes
            video = tokenizer.decode_from_bottleneck(seq) if new == 1024 else None
            torch.cuda.synchronize()
            dec_s = time.perf_counter() - t1
        launches = {k.__name__: k.launches for k in kernels}
        decode_sm90, w8_stream = decode_attention.launches_sm90, w8_matmul.launches_stream
        w8_sm90, decode_fused = w8_matmul.launches_sm90, decode_attention.launches_fused
        with torch.inference_mode():  # one step at the mean cache length
            cache = model.init_cache(2 * B, 1 + 1024, kv or torch.bfloat16)
            pos = torch.full((1,), 512, dtype=torch.int32, device="cuda")
            tok = seq[:, :1].repeat(2, 1)
            step_ms = graph_ms(lambda: model.decode_step(tok, pos, cache), launches=1)
            per_step = _kernels_in(lambda: model.decode_step(tok, pos, cache))
            by_w8 = _step_ms_by_w8_kernel(model, tok, pos, cache) if model is int8 else None
            by_write = _step_fused_vs_separate(model, tok, pos, cache)
        tok_s = B * new / wall
        wall_ms = wall * 1e3 / new
        idle = 1.0 - step_ms / wall_ms
        # per sample: 1023 decode steps of 30 layers, each one decode attention
        # that also writes the layer's K/V row (no separate row write); with
        # int8 weights 151 projections in the prefill and in each step (M = 16:
        # the 30 w2 products on the streaming kernel, the rest on the earlier
        # one, as `w8_kernel` names them) and 151 in the NLL forward (M = 8192,
        # the wgmma kernel)
        want = {"flash_attn_fwd": 30 + 30 + (12 if video is not None else 0),
                "decode_attention": 30 * (new - 1),
                "w8_matmul": 151 * (new + 1) if model is int8 else 0,
                "write_rows_per_row": 0}
        want_w8_stream = _w8_streamed(model, 2 * B) * new
        want_w8_sm90 = _w8_streamed(model, B * new, "w8_sm90_kernel") if model is int8 else 0
        top = sorted(per_step.items(), key=lambda kv: -kv[1])[:6]
        log(f"[sample {name}] batch {B}, CFG 1.5, top-k 100, {new} tokens: {wall:.3f} s = "
            f"{tok_s:.1f} tokens/s, {wall_ms:.3f} ms per decode step (host wall); device "
            f"{step_ms:.3f} ms per step (CUDA-graph replay at pos 512): idle {idle:.1%}; "
            f"{sum(per_step.values())} device events per step (torch.profiler, which can drop "
            f"some), most launched: "
            + ", ".join(f"{n[:60]} x{c}" for n, c in top))
        log(f"[sample {name}] NLL forward {nll_s * 1e3:.1f} ms (NLL {nll.item():.4f}), "
            + (f"decode_from_bottleneck {dec_s * 1e3:.1f} ms ({in_range(video):.1%} of pixels in "
               "[0, 1] before clipping); " if video is not None else "")
            + f"launches {launches} (expect {want}); of the decode "
            f"attentions {decode_sm90} by decode_attn_sm90_kernel and {decode_fused} with the row "
            f"write fused (expect all), of the int8 "
            f"matmuls {w8_stream} by w8_stream_kernel (expect {want_w8_stream}) and {w8_sm90} by "
            f"w8_sm90_kernel (expect {want_w8_sm90}: the NLL forward's)")
        (fused_ms, fused_n), (sep_ms, sep_n) = by_write["fused"], by_write["separate"]
        log(f"[sample {name}] one step at pos 512 with the K/V rows written inside the decode "
            f"attention: " + " / ".join(f"{t:.4f}" for t in fused_ms) + f" ms, {fused_n} kernels "
            f"(kernel nodes of the captured step); with a separate row write per layer: "
            + " / ".join(f"{t:.4f}" for t in sep_ms)
            + f" ms, {sep_n} kernels (in turn, CUDA-graph replay): the fusion saves "
            f"{(min(sep_ms) - min(fused_ms)) * 1e3:.1f} us and {sep_n - fused_n} kernels a step; "
            f"torch.profiler saw {sum(per_step.values())} device events (kernels, copies, "
            f"memsets) in the fused step")
        require(sep_n - fused_n == 30, f"sample {name}: the fused step has {fused_n} kernels, the "
                                       f"separate one {sep_n}: not 30 fewer")
        if by_w8 is not None:
            best = {c: min(t) for c, t in by_w8.items()}
            log(f"[sample {name}] device time per step at pos 512 with the int8 projections as "
                f"w8_kernel names them ({want_w8_stream // new} of 151 on w8_stream_kernel) "
                + " / ".join(f"{t:.4f}" for t in by_w8["chosen"]) + " ms, all on the earlier "
                "w8_matmul_kernel " + " / ".join(f"{t:.4f}" for t in by_w8["w8_matmul_kernel"])
                + " ms, all on w8_stream_kernel "
                + " / ".join(f"{t:.4f}" for t in by_w8["w8_stream_kernel"]) + " ms (in turn): the "
                f"choice {'saves' if best['chosen'] < best['w8_matmul_kernel'] else 'does NOT save'} "
                f"{best['w8_matmul_kernel'] - best['chosen']:.4f} ms per step against the earlier "
                f"kernel alone")
            records["w8_matmul"][f"{name}_step_ms"] = best["chosen"]
            records["w8_matmul"][f"{name}_step_earlier_ms"] = best["w8_matmul_kernel"]
            records["w8_matmul"][f"{name}_step_stream_ms"] = best["w8_stream_kernel"]
        require(tuple(seq.shape) == (B, new) and int(seq.min()) >= 0 and int(seq.max()) < 8192,
                f"sample {name}: codes {tuple(seq.shape)} out of range")
        require(torch.isfinite(nll).item(), f"sample {name}: non-finite NLL")
        require(video is None or (tuple(video.shape) == (B, 3, 16, 128, 128)
                                  and torch.isfinite(video).all().item()),
                f"sample {name}: video {None if video is None else tuple(video.shape)}")
        require(launches == want, f"sample {name}: launch counts {launches}, expected {want}")
        require(decode_sm90 == want["decode_attention"] == decode_fused
                and w8_stream == want_w8_stream and w8_sm90 == want_w8_sm90,
                f"sample {name}: {decode_sm90} decode_attn_sm90_kernel, {decode_fused} fused, "
                f"{w8_stream} w8_stream_kernel, {w8_sm90} w8_sm90_kernel")
        results[name] = dict(launches, w8_stream=w8_stream, w8_sm90=w8_sm90,
                             decode_sm90=decode_sm90, decode_fused=decode_fused)
        step_ms_of[name] = (step_ms, fused_n)  # the exact kernel count of the step
        records.setdefault("sampling_write_fused", {})[name] = {
            "fused_ms": min(fused_ms), "separate_ms": min(sep_ms), "fused_kernels": fused_n,
            "separate_kernels": sep_n}
        records.setdefault("sampling", {})[name] = tok_s
    log("[sample] device time per decode step at pos 512, bf16 / int8 weights / int8 weights + "
        "int8 KV: " + " / ".join(f"{ms:.3f} ms ({n} kernels)" for ms, n in step_ms_of.values())
        + f"; int8 {'below' if step_ms_of['int8'][0] < step_ms_of['bf16'][0] else 'NOT below'} bf16")
    records["sampling_device_step_ms"] = {k: v[0] for k, v in step_ms_of.items()}
    records["sampling_kernels_per_step"] = {k: v[1] for k, v in step_ms_of.items()}
    records["decode_attention"]["launches"] = results["int8_kv8"]["decode_sm90"]
    records["w8_matmul"]["launches"] = results["int8"]["w8_stream"]
    records["w8_matmul_sm90"]["launches"] = results["int8"]["w8_sm90"]
    records["w8_matmul_mma"]["launches"] = (results["int8"]["w8_matmul"] - results["int8"]["w8_stream"]
                                            - results["int8"]["w8_sm90"])
    records["kv_row_write_fused"]["launches"] = results["int8_kv8"]["decode_fused"]

    # sampling with a prompt mask (`emb_masks`: prompt positions that are not
    # valid are masked as keys): the prefill's attention takes segment ids,
    # which stay on the earlier flash_fwd_kernel; with every position valid
    # the codes are those of the same draw without a mask
    n = 16
    mask = torch.ones(B, 1, dtype=torch.bool, device="cuda")
    with_mask = {}
    for m in (None, mask):
        flash_attn_fwd.launches = flash_attn_fwd.launches_sm90 = flash_attn_fwd.launches_tf32x3 = 0
        gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
        with_mask[m is not None] = generate(bf16, labels, n, gen, cfg_scale=1.5, top_k=100,
                                            emb_masks=m)
        torch.cuda.synchronize()
    seq = with_mask[True]
    n_fwd, n_new = flash_attn_fwd.launches, flash_attn_fwd.launches_sm90 + flash_attn_fwd.launches_tf32x3
    same = (seq == with_mask[False]).float().mean().item()
    log(f"[sample bf16, emb_masks] batch {B}, {n} tokens with every prompt position valid: "
        f"{n_fwd} flash forwards (expect 30, the prefill's), {n_new} of them on the wgmma or "
        f"3xTF32 kernels (expect 0: segment ids); codes equal to the unmasked draw's: {same:.1%}")
    require(tuple(seq.shape) == (B, n) and int(seq.min()) >= 0 and int(seq.max()) < 8192,
            f"sample emb_masks: codes {tuple(seq.shape)} out of range")
    require(n_fwd == 30 and n_new == 0, f"sample emb_masks: {n_fwd} flash launches, {n_new} new")
    records["flash_attn_fwd_mma"]["launches"] = n_fwd


def in_range(video) -> float:
    """Share of a decoded video's pixels in [0, 1] before clipping."""
    return ((video >= 0) & (video <= 1)).float().mean().item()


def phase_decode_chunk_fp32(model) -> None:
    """`decode_chunk` against sequential `decode_step`s on the full-width prior
    in fp32 (TF32 off), forced tokens, rows at different positions: a batch-4
    cache is grown by 12 uniform steps, then one chunk of 5 tokens goes to
    positions pos[b].. of each row; each row alone (batch 1, grown to its own
    pos by one-token steps, then 5 more) is the reference."""
    import torch

    cond = torch.tensor([3, 7, 50, 101], device="cuda")
    gen = torch.Generator().manual_seed(SEED + 50)
    pre = torch.randint(0, 8192, (4, 12), generator=gen).cuda()
    toks = torch.randint(0, 8192, (4, 5), generator=gen).cuda()
    pos = torch.tensor([1, 4, 9, 13], dtype=torch.int32, device="cuda")  # T = 1: pos <= 1 + 12
    # fp32 cache: sums in another order (GEMMs of 20 rows against 1), 1e-3 of
    # the logit scale as phase 8. int8 cache: a rounding flip of an int8 K/V
    # value moves later layers' inputs by 1/127 of a row's amax and cascades:
    # 3e-2, as phase 8 measured and bounds it.
    for name, cache_dtype, tol in (("fp32 cache", torch.float32, 1e-3), ("int8 KV", torch.int8, 3e-2)):
        with torch.inference_mode():
            cache = model.init_cache(4, 1 + 1024 + 4, cache_dtype)
            model.prefill(cond, cache)
            for g in range(12):
                model.decode_step(pre[:, g : g + 1], 1 + g, cache)
            got, _ = model.decode_chunk(toks, pos, cache)
            want = []
            for r in range(4):
                solo = model.init_cache(1, 1 + 1024 + 4, cache_dtype)
                model.prefill(cond[r : r + 1], solo)
                for g in range(int(pos[r]) - 1):
                    model.decode_step(pre[r : r + 1, g : g + 1], 1 + g, solo)
                want.append(torch.cat([
                    model.decode_step(toks[r : r + 1, g : g + 1], int(pos[r]) + g, solo)[0]
                    for g in range(5)], dim=1))
            want = torch.cat(want)
        torch.cuda.synchronize()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"[chunk fp32] {name}: decode_chunk of 5 tokens at pos {pos.tolist()} vs 5 decode_steps "
            f"per row: max|chunk-steps| logit {err:.3e} = {err / scale:.2e} of max|logit| "
            f"{scale:.3e} (tol {tol:g}); argmax agreement {agree:.2%}")
        require(tuple(got.shape) == (4, 5, 8192) and torch.isfinite(got).all().item(),
                f"decode_chunk {name}: shape or non-finite logits")
        require(err <= tol * scale, f"decode_chunk {name}: logit error {err} > {tol * scale}")


def _set_head(model, weight) -> None:
    """Overwrites the output head (zero-initialised in a fresh model) in place."""
    import torch

    with torch.no_grad():
        model.output.weight.copy_(weight)


def _sharp_heads():
    """Independent sharp output heads for the target and the draft (std 0.11,
    the head_std of the JAX package's speculative benchmark)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 60)
    return 0.11 * torch.randn(8192, 1280, generator=gen), 0.11 * torch.randn(8192, 768, generator=gen)


def phase_speculative_greedy(ar_fp32, draft_fp32, records: dict) -> None:
    """Greedy decoding in fp32 (TF32 off) with sharp heads, 64 tokens at batch
    8: speculative == `generate` token for token, but for near-ties of the
    target's top two logits (the verify chunk and the single step are GEMMs
    of other shapes, so a tie may break the other way and the rows then part).
    The target's own head is put back afterwards. The fp32 caches keep every
    chunk attention on the earlier kernel."""
    import torch

    from video_tokenizer_tpu_torch.generation import generate, speculative_generate
    from video_tokenizer_tpu_torch.ops.decode_attention import chunk_attention

    B, gamma = 8, 4
    chunk_attention.launches = chunk_attention.launches_sm90 = 0
    labels = torch.tensor([0, 5, 17, 33, 50, 64, 88, 100], device="cuda")
    sharp_t, sharp_d = _sharp_heads()
    own_head = ar_fp32.output.weight.detach().clone()
    _set_head(ar_fp32, sharp_t)
    _set_head(draft_fp32, sharp_d)
    want = generate(ar_fp32, labels, 64, sample_logits=False)
    with torch.inference_mode():
        logits, _ = ar_fp32(want[:, :-1], labels)  # [B, 64, V]: row i predicts token i
    scale = logits.abs().max().item()
    # the separate draft never guesses the target's argmax (every token is a
    # correction at slot 0); the target as its own draft has every proposal
    # accepted, so the verify chunk's later slots and the bonus draw decide
    for name, dm in (("separate draft", draft_fp32), ("the target as its own draft", ar_fp32)):
        got, stats = speculative_generate(ar_fp32, dm, labels, 64, gamma=gamma,
                                          sample_logits=False, return_stats=True)
        differ, worst_gap = 0, 0.0
        for b in range(B):
            idx = (got[b] != want[b]).nonzero()
            if len(idx):
                i = int(idx[0])
                gap = (logits[b, i, want[b, i]] - logits[b, i, got[b, i]]).abs().item()
                differ, worst_gap = differ + 1, max(worst_gap, gap)
        log(f"[spec greedy fp32] {name}, 64 tokens, batch {B}: {B - differ} of {B} rows equal "
            f"generate token for token; the others first differ at a logit gap of at most "
            f"{worst_gap:.2e} (tol 1e-3 of max|logit| {scale:.2f}); acceptance "
            f"{float(stats['acceptance_rate']):.3f}, {stats['iterations']} iterations")
        require(worst_gap <= 1e-3 * scale,
                f"greedy speculative ({name}) differs from generate at a gap {worst_gap}")
    _set_head(ar_fp32, own_head)
    launches = chunk_attention.launches
    log(f"[spec greedy fp32] {launches} chunk attentions, {chunk_attention.launches_sm90} of them "
        f"by chunk_attn_sm90_kernel (expect 0: fp32 caches)")
    require(launches > 0 and chunk_attention.launches_sm90 == 0,
            "greedy fp32 speculative: chunk attention off the earlier kernel")
    records["chunk_attention_split"]["launches"] = launches


def phase_speculative(target, draft, tokenizer, records: dict) -> None:
    """Speculative sampling with the full-width pair (632M llama-abs-LP target,
    ~70M draft of 8 layers x 768), batch 8, CFG 1.5, top-k 100, 1024 tokens,
    gamma 4, in bf16 and with int8 weights + int8 KV, three constructions that
    bracket the acceptance rate a trained pair would have:
      ceiling     both output heads zero: both distributions uniform, every
                  proposal accepted, ceil(1023 / 5) = 205 iterations;
      floor       independent sharp heads (std 0.11): uncorrelated peaked
                  distributions, acceptance near 0 (64 tokens: one iteration
                  per token, and the host sets each one's time; 512 before
                  phase 19, 256 before phase 21);
      self_draft  the target's own first 8 layers and its sharp head (64
                  tokens, for the same reason; 256, then 128 before).
    `target` and `draft` arrive on the card and are cast to bf16 in place.
    Also: two short runs under the CUDA sync debug mode (the loop reads one
    scalar per iteration on the host)."""
    import warnings

    import torch

    from video_tokenizer_tpu_torch.generation import self_draft, speculative_generate
    from video_tokenizer_tpu_torch.models.larp_ar import quantize_model
    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
    from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row
    from video_tokenizer_tpu_torch.ops.decode_attention import chunk_attention, decode_attention
    from video_tokenizer_tpu_torch.ops.quant_matmul import w8_matmul

    kernels = (flash_attn_fwd, decode_attention, w8_matmul, chunk_attention, write_rows_per_row)
    B, gamma = 8, 4
    labels = torch.tensor([0, 5, 17, 33, 50, 64, 88, 100], device="cuda")
    sharp_t, sharp_d = _sharp_heads()
    t_bf16, d_bf16 = target.to(torch.bfloat16), draft.to(torch.bfloat16)  # in place
    plain = records["sampling"]  # tokens/s of plain `generate` in this run (phase 9)
    out = {}
    for con in ("ceiling", "floor", "self_draft"):
        new = {"ceiling": 1024, "floor": 64, "self_draft": 64}[con]
        _set_head(t_bf16, torch.zeros_like(sharp_t) if con == "ceiling" else sharp_t)
        _set_head(d_bf16, torch.zeros_like(sharp_d) if con == "ceiling" else sharp_d)
        for prec in ("bf16", "int8_kv8"):
            if prec == "bf16":
                tm, kv = t_bf16, None
                dm = self_draft(tm, 8) if con == "self_draft" else d_bf16
            else:
                tm, kv = quantize_model(t_bf16), torch.int8
                dm = self_draft(tm, 8) if con == "self_draft" else quantize_model(d_bf16)
            kw = dict(gamma=gamma, cfg_scale=1.5, top_k=100, cache_dtype=kv, draft_cache_dtype=kv,
                      return_stats=True)
            gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
            speculative_generate(tm, dm, labels, 12, gen, **kw)  # warm-up
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            chunk_attention.launches_sm90 = chunk_attention.launches_fused = 0
            w8_matmul.launches_stream = 0
            t0 = time.perf_counter()
            seq, stats = speculative_generate(tm, dm, labels, new, gen, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in kernels}
            chunk_sm90, w8_stream = chunk_attention.launches_sm90, w8_matmul.launches_stream
            chunk_fused = chunk_attention.launches_fused
            iters, acc = stats["iterations"], float(stats["acceptance_rate"])
            with torch.inference_mode():
                # (the decoder takes whole samples of 1024 codes)
                video = tokenizer.decode_from_bottleneck(seq) if new == 1024 else None
                # one iteration's forwards at the mean cache length, no host gaps
                tc = tm.init_cache(2 * B, 1 + 1024 + gamma, kv or torch.bfloat16)
                dc = dm.init_cache(2 * B, 1 + 1024 + gamma, kv or torch.bfloat16)
                pn = torch.full((2 * B,), 512, dtype=torch.int32, device="cuda")
                t1, t2, t5 = (seq[:, :g].repeat(2, 1) for g in (1, 2, gamma + 1))

                def one_iteration():
                    dm.decode_chunk(t2, pn - 1, dc)
                    for g in range(1, gamma):
                        dm.decode_chunk(t1, pn + g, dc)
                    tm.decode_chunk(t5, pn, tc)

                dev_ms = graph_ms(one_iteration, launches=1)
                del tc, dc
            iter_ms = wall * 1e3 / iters
            # per iteration gamma draft forwards and one target forward, each
            # with one chunk attention per layer, which writes the layer's K/V
            # rows too, and, with int8 weights, five projections per layer and
            # the head
            n_d, n_t = len(dm.layers), len(tm.layers)
            per_iter, w8_d, w8_t = gamma * n_d + n_t, 5 * n_d + 1, 5 * n_t + 1
            want_launches = {
                "flash_attn_fwd": n_t + n_d, "decode_attention": 0,  # the two prefills
                "w8_matmul": ((gamma * w8_d + w8_t) * iters + w8_d + w8_t
                              if prec == "int8_kv8" else 0),
                "chunk_attention": per_iter * iters, "write_rows_per_row": 0,
            }
            # on the streaming kernel, as `w8_kernel` names them: the verify
            # chunks (80 rows), the draft's width-2 chunks (32 rows; width 1 in
            # iteration 0) and, at 16 rows, the projections with K > 2048
            want_w8_stream = (iters * (_w8_streamed(tm, 2 * B * (gamma + 1))
                                       + (gamma - 1) * _w8_streamed(dm, 2 * B))
                              + (iters - 1) * _w8_streamed(dm, 4 * B) + 2 * _w8_streamed(dm, 2 * B)
                              + _w8_streamed(tm, 2 * B))
            tok_s = B * new / wall
            log(f"[spec {con} {prec}] batch {B}, CFG 1.5, top-k 100, {new} tokens, gamma {gamma}: "
                f"{wall:.3f} s = {tok_s:.1f} tokens/s (plain generate in this run: "
                f"{plain[prec]:.1f}); acceptance {acc:.4f}, {iters} iterations, {iter_ms:.3f} ms "
                f"per iteration (host wall); device {dev_ms:.3f} ms per iteration's forwards "
                f"(CUDA-graph replay at pos 512): idle {1 - dev_ms / iter_ms:.1%}")
            log(f"[spec {con} {prec}] launches {launches} (expect {want_launches}), of the chunk "
                f"attentions {chunk_sm90} by chunk_attn_sm90_kernel and {chunk_fused} with the row "
                f"write fused (expect all: a "
                f"{'int8' if kv else 'bf16'} cache at head dim 64), of the int8 matmuls "
                f"{w8_stream} by w8_stream_kernel (expect {want_w8_stream})")
            require(w8_stream == want_w8_stream,
                    f"spec {con} {prec}: {w8_stream} of {launches['w8_matmul']} int8 matmuls ran "
                    f"w8_stream_kernel, not {want_w8_stream}")
            require(tuple(seq.shape) == (B, new) and int(seq.min()) >= 0 and int(seq.max()) < 8192,
                    f"spec {con} {prec}: codes {tuple(seq.shape)} out of range")
            require(video is None or (tuple(video.shape) == (B, 3, 16, 128, 128)
                                      and torch.isfinite(video).all().item()),
                    f"spec {con} {prec}: video shape or non-finite")
            require(launches == want_launches,
                    f"spec {con} {prec}: launch counts {launches}, expected {want_launches}")
            require(chunk_sm90 == chunk_fused == launches["chunk_attention"],
                    f"spec {con} {prec}: {chunk_sm90} of {launches['chunk_attention']} chunk "
                    f"attentions ran chunk_attn_sm90_kernel, {chunk_fused} fused the row write")
            if con == "ceiling":
                require(acc == 1.0 and iters == -(-(new - 1) // (gamma + 1)),
                        f"spec ceiling {prec}: acceptance {acc}, {iters} iterations")
            out[f"{con}_{prec}"] = {"tokens": new, "tokens_per_s": tok_s, "acceptance": acc,
                                    "iterations": iters,
                                    "iter_ms": iter_ms, "device_iter_ms": dev_ms,
                                    "plain_tokens_per_s": plain[prec]}
            if con == "floor":  # the separate draft's run carries the kernels' counts
                key = "launches" if prec == "bf16" else "launches_int8_kv8"
                records["chunk_attention"][key] = launches["chunk_attention"]
                records["kv_row_write_fused"][f"chunk_{key}"] = chunk_fused
            if con == "floor" and prec == "bf16":
                # the loop may wait for the device once per iteration (has the
                # slowest row finished?) and nowhere else: every wait warns here.
                # Two lengths: what is left after iterations + 1 loop tests (one
                # more to leave) is outside the loop, and must be the same
                outside = []
                for n_tok in (17, 49):
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        with warnings.catch_warnings(record=True) as caught:
                            warnings.simplefilter("always")
                            _, st = speculative_generate(tm, dm, labels, n_tok, gen, **kw)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    waits = sum("synchroniz" in str(w.message).lower() for w in caught)
                    outside.append(waits - (st["iterations"] + 1))
                    log(f"[spec sync] {n_tok} tokens, {st['iterations']} iterations: {waits} host "
                        f"waits for the device = one per loop test + {outside[-1]} outside the loop")
                require(outside[0] == outside[1] and outside[0] >= 0,
                        f"speculative loop: host waits beyond one per iteration: {outside}")
            del tm, dm
    records["speculative"] = out
    # the crossover acceptance of this run: E(a) = (1 - a^(gamma+1)) / (1 - a)
    # tokens per row per iteration must exceed plain tokens/s * T_iter / batch
    for prec in ("bf16", "int8_kv8"):
        t_iter = statistics.mean(out[f"{c}_{prec}"]["iter_ms"] for c in ("ceiling", "floor")) / 1e3
        need = plain[prec] * t_iter / B
        lo, hi = 0.0, 1.0
        for _ in range(50):
            mid = (lo + hi) / 2
            e = (1 - mid ** (gamma + 1)) / (1 - mid)
            lo, hi = (mid, hi) if e < need else (lo, mid)
        cross = f"a* = {hi:.3f}" if need < gamma + 1 else "none: it loses at any acceptance"
        log(f"[spec crossover {prec}] T_iter {t_iter * 1e3:.2f} ms, plain generate "
            f"{plain[prec]:.1f} tokens/s: speculative wins above E(a) = {need:.3f} tokens per "
            f"row per iteration, {cross}")
        out[f"crossover_{prec}"] = {"t_iter_ms": t_iter * 1e3, "need_tokens_per_iter": need,
                                    "acceptance": hi if need < gamma + 1 else None}


def phase_distill(target, draft, records: dict) -> None:
    """Distillation of the full-width draft against the full-width target on
    the card, short: 10 AdamW steps at batch 8 on 256-token sequences sampled
    from the target, the targets refreshed every 2 steps. The draft's forward
    and backward run the causal flash forward, dQ and dK/dV kernels."""
    import torch

    from video_tokenizer_tpu_torch.ops.attention import (
        flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
    )
    from video_tokenizer_tpu_torch.tools.distill_draft import distill

    kernels = (flash_attn_fwd, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    steps, n_draft, n_target = 10, len(draft.layers), len(target.layers)
    for k in kernels:
        k.launches = k.launches_sm90 = 0
    lines = []
    t0 = time.perf_counter()
    trained, stats = distill(target, draft, torch.Generator(device="cuda").manual_seed(SEED + 70),
                             steps=steps, batch=8, seq_len=256, lr=1e-3, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    sm90 = {k.__name__: k.launches_sm90 for k in kernels}
    refreshes = -(-steps // max(steps // 5, 1))
    # forwards: the draft's per step; per refresh the target's prefill (in
    # generate) and its teacher-forcing forward
    want = {"flash_attn_fwd": n_draft * steps + 2 * n_target * refreshes,
            "flash_attn_bwd_dq": n_draft * steps, "flash_attn_bwd_dkv": n_draft * steps}
    log(f"[distill] {steps} steps, batch 8, seq 256, {refreshes} refreshes of the targets: "
        f"{wall:.1f} s; soft-CE {stats['first_loss']:.4f} -> {stats['last_loss']:.4f}; launches "
        f"{launches} (expect {want}), of which the wgmma kernels {sm90} (expect all: bf16)")
    require(math.isfinite(stats["first_loss"]) and math.isfinite(stats["last_loss"]),
            "distill: non-finite soft-CE")
    require(stats["last_loss"] < stats["first_loss"], f"distill: the soft-CE did not fall: {stats}")
    require(launches == want, f"distill: launch counts {launches}, expected {want}")
    require(sm90 == want, f"distill: wgmma launches {sm90}, expected {want}")
    require(all(p.dtype == torch.bfloat16 for p in trained.parameters()), "distill: draft not bf16")
    records["distill"] = {"steps": steps, "wall_s": wall, "first_loss": stats["first_loss"],
                          "last_loss": stats["last_loss"]}


def _load_cfg(name: str, save_dir, batch: int) -> dict:
    """cfgs/<name>.yaml at full width, its $vars$ filled as the train CLI
    fills them (16 frames of 128 x 128, fake null128 clips, no loader
    workers), one epoch, seeded, for the port's trainers."""
    import yaml

    text = (ROOT / "cfgs" / f"{name}.yaml").read_text()
    for key, value in (("frame_num", 16), ("input_size", 128), ("csv_file", "null128"),
                       ("batch_size", batch), ("num_workers", 0)):
        text = text.replace(f"${key}$", str(value))
    cfg = yaml.safe_load(text)
    cfg.update(save_dir=str(save_dir), manualSeed=SEED, max_epoch=1)
    return cfg


def _train_cfg(save_dir, batch: int, use_amp: bool, **over) -> dict:
    """cfgs/larp_tokenizer.yaml (`_load_cfg`) in bf16 or fp32."""
    cfg = _load_cfg("larp_tokenizer", save_dir, batch)
    cfg["use_amp"] = use_amp
    cfg.update(over)
    return cfg


def _trainer(cfg: dict, device: str):
    """The port's trainer at epoch 1, built as `train.py` builds it."""
    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    tr = trainers.make({"name": cfg["trainer"]}, args={"cfg": cfg, "device": device})
    tr.make_datasets()
    tr.epoch = 1
    tr.make_model()
    tr.n_steps_per_epoch = tr.steps_per_epoch()
    return tr


def phase_train_fp32(tmp: Path) -> None:
    """One train step of the full-width flagship generator, discriminator and
    LPIPS in fp32 (TF32 off) at batch 1, on the card and on the CPU (the plain
    versions) from the same perturbed weights and the same generators (so the
    same VQ seed and label noise); the discriminator trains on this step."""
    import numpy as np
    import torch

    cfg = _train_cfg(tmp, 1, False)
    cfg["loss"]["args"]["d_update_freq"] = 1
    trainers = {}
    for device in ("cpu", "cuda"):
        cfg = {**cfg, "save_dir": str(tmp / f"fp32_{device}")}
        trainers[device] = _trainer(cfg, device)
    cpu, gpu = trainers["cpu"], trainers["cuda"]
    _perturb(cpu.model, SEED + 40)
    _perturb(cpu.disc, SEED + 41)
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.loss_mod.load_state_dict(cpu.loss_mod.state_dict())
    clip = np.random.default_rng(SEED + 42).integers(0, 256, (1, 3, 16, 128, 128), dtype=np.uint8)
    reps, infos, secs = {}, {}, {}
    for device, tr in trainers.items():
        hook = tr.model.bottleneck.register_forward_hook(
            lambda m, i, o, d=device: reps.__setitem__(d, o["bottleneck_rep"].cpu()))
        t0 = time.perf_counter()
        keys, packed = tr.train_step({"gt": torch.from_numpy(clip)})
        infos[device] = dict(zip(keys, packed.tolist()))
        secs[device] = time.perf_counter() - t0
        hook.remove()
    agree = (reps["cuda"] == reps["cpu"]).float().mean().item()
    loss_keys = ("loss", "rec_loss", "perceptual_loss", "g_loss", "d_loss", "loss_q",
                 "logits_real", "logits_fake")
    loss_err = max(abs(infos["cuda"][k] - infos["cpu"][k]) / max(abs(infos["cpu"][k]), 1e-6)
                   for k in loss_keys)
    log(f"[train fp32] flagship generator {sum(p.numel() for p in cpu.model.parameters()):,} + "
        f"discriminator {sum(p.numel() for p in cpu.disc.parameters()):,} + LPIPS params, batch 1, "
        f"TF32 off: CPU step (plain versions) {secs['cpu']:.1f} s, card step {secs['cuda']:.2f} s")
    log(f"[train fp32] VQ indices agree on {agree:.4%} (tol >= 99.9%); losses "
        + ", ".join(f"{k} {infos['cuda'][k]:.6g}/{infos['cpu'][k]:.6g}" for k in loss_keys)
        + f" (card/CPU; largest relative difference {loss_err:.2e}, tol 2e-4)")
    require(set(infos["cuda"]) == set(infos["cpu"]), "train fp32: info keys differ")
    require(all(np.isfinite(v) for v in infos["cuda"].values()), "train fp32: non-finite info")
    require(agree >= 0.999, f"train fp32: VQ agreement {agree}")
    # bounds: ~10x the readings on an H100 (losses 1.6e-5 apart, gradients at
    # most 7.1e-5 of their scale, with 100% of the VQ indices equal)
    require(loss_err <= 2e-4, f"train fp32: losses differ by {loss_err}")
    named = ("x_embedder.proj.weight", "encoder.blocks.6.attn.qkv.weight",
             "bottleneck.regularizer.embedding.weight", "decoder.blocks.11.mlp.fc2.weight",
             "final_layer.linear.weight")
    worst = 0.0
    for mod, names in ((("model", gpu.model, cpu.model), named),
                       (("disc", gpu.disc, cpu.disc), ("transformer_encoder.blocks.3.attn.qkv.weight",
                                                       "x_embedder.proj.weight"))):
        tag, gm, cm = mod
        gp, cp = dict(gm.named_parameters()), dict(cm.named_parameters())
        for name in names:
            g, c = gp[name].grad, cp[name].grad
            require(g is not None and c is not None, f"train fp32: no gradient for {tag} {name}")
            rel = (g.cpu() - c).abs().max().item() / c.abs().max().item()
            worst = max(worst, rel)
            log(f"[train fp32] grad {tag} {name}: max|card-cpu|/max|cpu| {rel:.2e} "
                f"(max|g| {c.abs().max().item():.3e}; tol 1e-3)")
    require(worst <= 1e-3, f"train fp32: gradients differ by {worst} of their scale")
    del trainers, cpu, gpu
    torch.cuda.empty_cache()


_KERNEL_CATEGORIES = (  # first match wins, on the kernel's lower-cased name
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel",
                       "flash_bwd_dkv_tf32x3_kernel")),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel",
                      "flash_bwd_dq_tf32x3_kernel")),
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_sm90_kernel", "flash_fwd_tf32x3_kernel")),
    ("vq_argmax", ("vq_tc_kernel", "vq_argmax_kernel")),
    ("conv (LPIPS)", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("layer_norm", ("layer_norm",)),
    ("optimizer", ("adam", "multi_tensor")),
)


def _category(name: str) -> str:
    low = name.lower()
    return next((cat for cat, keys in _KERNEL_CATEGORIES if any(k in low for k in keys)),
                "other elementwise/copy")


def _profile_and_load(step, n: int, by_name: Optional[dict] = None):
    """(wall ms, {category: device us}, device events, the card under load)
    of n steps under torch.profiler, then the card's clock, power and
    temperature during two more steps with one nvidia-smi query in flight (a
    step time read beside a lower clock is the card's, not the code's).
    `by_name`, if given, receives {kernel name: device us}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    try:
        under_load = smi.communicate(timeout=60)[0].strip() or "not available"
    except subprocess.TimeoutExpired:
        smi.kill()
        smi.communicate()
        under_load = "not available"
    # the device's events straight from Kineto's results: prof.events() also
    # builds every CPU op's event and tree first, which took 87 us an event
    # on the H100's host (14 s for 5 steps of 3400 kernels), and reads the
    # same start and end of each kernel
    per_cat: dict = {}
    n_events = 0
    for e in prof.profiler.kineto_results.events():
        hidden = getattr(e, "is_hidden_event", lambda: False)()  # as prof.events() skips
        if e.device_type() != torch.autograd.DeviceType.CUDA or hidden:
            continue
        n_events += 1
        us = (e.end_ns() - e.start_ns()) / 1e3
        per_cat[_category(e.name())] = per_cat.get(_category(e.name()), 0.0) + us
        if by_name is not None:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + us
    return wall_ms, per_cat, n_events, under_load


def _train_throughput(tag: str, cfg: dict, flash: tuple, vq: int, warm: int = 2,
                      timed: int = 5, fp32_flash: tuple = (0, 0),
                      by_name: Optional[dict] = None) -> dict:
    """Training through the port's trainer on the card from `cfg` (batch and
    dtype as it sets them), on fake null128 clips from its own loader: `warm`
    warm-up steps, `timed` timed steps (d_update_freq 5 puts one
    discriminator step among five), exact launch counts over the timed steps
    against `flash` = (forwards, dQ and dK/dV each, extra dQ and dK/dV on a
    discriminator step) per step and `vq` VQ searches per step, peak memory,
    then `timed` more steps under torch.profiler for the device's idle share
    and time by kernel category (and by kernel name into `by_name`), and the
    card under load. In bf16 every flash forward, dQ and dK/dV launch of
    `flash` must run the wgmma kernels, and `fp32_flash` = (forwards, dQ
    and dK/dV each) per step of an fp32 module inside it (the gptc prior)
    the 3xTF32 kernels; in fp32 every launch the 3xTF32 kernels (and so
    none the FMA ones). Returns the numbers."""
    import torch

    from video_tokenizer_tpu_torch.ops.attention import (
        flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
    )
    from video_tokenizer_tpu_torch.ops.vq import vq_argmax

    kernels = (flash_attn_fwd, flash_attn_bwd_dq, flash_attn_bwd_dkv, vq_argmax)
    use_amp, B = bool(cfg["use_amp"]), int(cfg["train_dataset"]["loader"]["batch_size"])
    tr = _trainer(cfg, "cuda")
    batches = tr.train_loader(1)
    fetch_s = []  # host time in the loader, per step (read beside the idle share)

    def step():
        t0 = time.perf_counter()
        batch = next(batches)
        fetch_s.append(time.perf_counter() - t0)
        return tr.train_step(batch)

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for k in kernels[:3]:
        k.launches_sm90 = k.launches_tf32x3 = 0
    vq_argmax.launches_tc = 0
    gc.collect()  # an earlier trainer in a reference cycle still holds its tensors
    torch.cuda.reset_peak_memory_stats()
    times, infos = [], []
    fetch_s.clear()
    d_steps = sum((tr.step + i + 1) % tr.loss_mod.d_update_freq == 0 for i in range(timed))
    for _ in range(timed):
        t0 = time.perf_counter()
        infos.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    sm90 = {k.__name__: k.launches_sm90 for k in kernels[:3]}
    tf32x3 = {k.__name__: k.launches_tf32x3 for k in kernels[:3]}
    vq_tc = vq_argmax.launches_tc
    loader_s = statistics.mean(fetch_s)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    prof_wall_ms, per_cat, n_events, under_load = _profile_and_load(step, timed, by_name)
    busy_ms = sum(per_cat.values()) / 1e3
    idle = 1.0 - busy_ms / prof_wall_ms
    mean_s = statistics.mean(times)
    fwd, bwd, bwd_d = flash
    p_fwd, p_bwd = fp32_flash
    require(use_amp or fp32_flash == (0, 0), f"{tag}: fp32_flash is for a bf16 run")
    want = {"flash_attn_fwd": (fwd + p_fwd) * timed,
            "flash_attn_bwd_dq": (bwd + p_bwd) * timed + bwd_d * d_steps,
            "flash_attn_bwd_dkv": (bwd + p_bwd) * timed + bwd_d * d_steps, "vq_argmax": vq * timed}
    fp32_part = {"flash_attn_fwd": p_fwd * timed, "flash_attn_bwd_dq": p_bwd * timed,
                 "flash_attn_bwd_dkv": p_bwd * timed}
    finite = all(torch.isfinite(packed).all().item() for _, packed in infos)
    keys, last = infos[-1]
    last = dict(zip(keys, last.tolist()))
    log(f"[{tag}] batch {B} clips [{B},3,16,128,128], {timed} steps ({d_steps} with a "
        f"discriminator step): {', '.join(f'{t:.3f}' for t in times)} s; mean {mean_s:.3f} "
        f"s/step = {B / mean_s:.2f} clips/s (median {statistics.median(times):.3f} s); "
        f"loader {loader_s * 1e3:.1f} ms per step on the host ({loader_s / mean_s:.1%} of "
        f"the step, {tr.train_workers} workers); peak memory {peak_gb:.2f} GiB")
    # bf16 runs the wgmma forward, dQ and dK/dV kernels on every launch,
    # fp32 never; fp32 runs every forward, dQ and dK/dV on the 3xTF32
    # kernels, and so none on csrc/flash_attn_bwd.cu's FMA kernels
    want_sm90 = {k: want[k] - fp32_part[k] if use_amp else 0 for k in sm90}
    want_tf32x3 = {k: fp32_part[k] if use_amp else want[k] for k in tf32x3}
    log(f"[{tag}] launches over the timed steps {launches} (expect {want}), of which "
        f"the wgmma kernels {sm90} (expect {want_sm90}), the 3xTF32 kernels {tf32x3} "
        f"(expect {want_tf32x3}) and vq_tc_kernel {vq_tc} (expect {vq * timed}); losses "
        f"finite: {finite}; last step loss {last['loss']:.4f}, rec {last['rec_loss']:.4f}, "
        f"perceptual {last['perceptual_loss']:.4f}, d_loss {last['d_loss']:.4f}, "
        f"psnr {last['psnr']:.2f}")
    log(f"[{tag}] profiled {timed} steps: wall {prof_wall_ms / timed:.1f} ms per step, "
        f"device busy {busy_ms / timed:.1f} ms, idle {idle:.1%}, {n_events / timed:.0f} "
        f"kernels per step; device ms per step by category: "
        + ", ".join(f"{c} {us / 1e3 / timed:.1f} ({us / 1e3 / busy_ms:.1%})"
                    for c, us in sorted(per_cat.items(), key=lambda kv: -kv[1])))
    log(f"[{tag}] the card during two further steps (SM clock, its maximum, power "
        f"draw, temperature): {under_load}")
    require(finite, f"{tag}: non-finite losses")
    require(launches == want, f"{tag}: launch counts {launches}, expected {want}")
    require(sm90 == want_sm90, f"{tag}: wgmma launches {sm90}, expected {want_sm90}")
    require(tf32x3 == want_tf32x3, f"{tag}: 3xTF32 launches {tf32x3}, expected {want_tf32x3}")
    require(vq_tc == vq * timed, f"{tag}: {vq_tc} of {vq * timed} VQ launches on vq_tc_kernel")
    del tr, batches
    torch.cuda.empty_cache()
    return {"batch": B, "s_per_step": mean_s, "clips_per_s": B / mean_s, "peak_gib": peak_gb,
            "idle": idle, "loader_s": loader_s, "launches": launches, "tf32x3": tf32x3,
            "sm90": sm90, "busy_ms_per_step": busy_ms / timed,
            "device_ms_per_step": {c: us / 1e3 / timed for c, us in per_cat.items()},
            "under_load": under_load}


def phase_train_throughput(tmp: Path, records: dict) -> None:
    """The flagship's training through the port's trainer at batch 8, full
    width (`_train_throughput`), bf16 (`use_amp: true`) and the config's
    fp32: per step 48 flash forwards, 32 dQ + 32 dK/dV (48 + 48 on a
    discriminator step) and one VQ search."""
    for name, use_amp in (("bf16", True), ("fp32", False)):
        run = _train_throughput(f"train {name}", _train_cfg(tmp / name, 8, use_amp),
                                (48, 32, 16), 1)
        records[f"train_{name}"] = {k: run[k] for k in ("s_per_step", "clips_per_s", "peak_gib",
                                                        "idle", "loader_s")}
        if name == "bf16":
            for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
                records[k]["launches"] = run["launches"][k]
        else:  # fp32: the 3xTF32 forward, dQ and dK/dV
            for k, n in run["tf32x3"].items():
                records[f"{k}_tf32x3"]["launches"] = n


def _ar_cfg(tmp: Path, name: str, vae_dir: Path, batch: int) -> dict:
    """cfgs/<name>.yaml (larp_ar or larp_ar_fp, `_load_cfg`): the 632M
    llama-abs-LP prior on the frozen tokenizer of the checkpoint directory
    `vae_dir`."""
    cfg = _load_cfg(name, tmp, batch)
    cfg["vae"]["checkpoint"] = str(vae_dir)
    return cfg


def _read_png(path: Path):
    """uint8 [H, W, 3] of an 8-bit RGB PNG whose rows all use filter 0 (what
    `utils.common.save_png` writes); the card's machine has no cv2 or PIL."""
    import struct
    import zlib

    import numpy as np

    data = path.read_bytes()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = head[:4]
    require((depth, color) == (8, 2), f"{path}: depth {depth}, colour type {color}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    require(not rows[:, 0].any(), f"{path}: a row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def phase_ar_train(tmp: Path, records: dict, real_stats: Path) -> None:
    """The AR prior's two trainers (class-conditional and frame-prediction)
    at the 632M llama-abs-LP prior's full width, fed by the frozen flagship
    tokenizer, fp32 (TF32 off), as `cfgs/larp_ar.yaml` and `larp_ar_fp.yaml`
    configure them:
      (a) the tokenizer checkpoint: the port's tokenizer trainer on
          cfgs/larp_tokenizer.yaml, weights perturbed (its output layer
          starts at zero), `epoch-final` saved with no epoch trained; every
          AR trainer below loads it through `vae.checkpoint`;
      (b) one step at batch 1, every dropout 0, card against CPU from the
          same weights, at full width and 8 of the prior's 30 layers (the
          CPU side of the whole depth took 27.5 and 58.4 s): loss,
          top-1/top-5 (2 of 1024 tokens), named gradients;
      (c) batch 8 with the configured dropouts: 2 warm-up steps, 5 timed
          (s/step, training tokens/s, clips/s, peak memory), 5 profiled (idle
          share, device time by kernel category), the card under load;
      (d) exact launch counts per step: 42 flash forwards (12 in the frozen
          encoder, 30 in the prior), 30 dQ and 30 dK/dV, all on the 3xTF32
          kernels, 1 VQ search on vq_tc_kernel, no int8 matmul;
      (e) the train CLI's entry (`train.main`) on cfgs/larp_ar.yaml at batch 8
          through one epoch of null128 (16 steps), eval and `vis_epoch`: the
          sample grid decodes to 4 x 128 by 8 x 128 pixels and is not
          constant, the samples' FVD against `real_stats` (phase 20's reals,
          `fvd_real_stats_path` with `force_fvd`) is logged as
          `sample gFVD:` with no failure, and `epoch-final` loads through
          `load_ar_checkpoint` and samples 16 tokens on the card."""
    import numpy as np
    import torch

    from video_tokenizer_tpu_torch.generation import generate
    from video_tokenizer_tpu_torch.ops.attention import (
        flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
    )
    from video_tokenizer_tpu_torch.ops.cache_update import write_rows_per_row
    from video_tokenizer_tpu_torch.ops.decode_attention import decode_attention
    from video_tokenizer_tpu_torch.ops.quant_matmul import w8_matmul
    from video_tokenizer_tpu_torch.ops.vq import vq_argmax
    from video_tokenizer_tpu_torch.train import main as train_main
    from video_tokenizer_tpu_torch.utils.model_io import load_ar_checkpoint

    # (a) the frozen tokenizer's checkpoint directory
    vae = _trainer(_train_cfg(tmp / "vae", 1, False), "cpu")
    _perturb(vae.model, SEED + 80)
    vae.save_final_checkpoint()
    vae_dir = tmp / "vae" / "epoch-final"
    del vae

    # (b) one fp32 step, card against CPU
    clip = np.random.default_rng(SEED + 81).integers(0, 256, (1, 3, 16, 128, 128), dtype=np.uint8)
    batch = {"gt": torch.from_numpy(clip), "label": torch.tensor([5])}
    named = ("tok_embeddings.weight", "abs_pe", "layers.0.attention.wqkv.weight",
             "layers.4.feed_forward.w2.weight", "layers.7.attention.wo.weight", "output.weight")
    for name in ("larp_ar", "larp_ar_fp"):
        cfg = _ar_cfg(tmp / f"{name}_parity", name, vae_dir, 1)
        cfg["model"]["args"].update(token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0,
                                    class_dropout_prob=0.0)
        # llama-abs-LP's width and heads at 8 of its 30 layers (the zoo name
        # fixes the depth; the flat registration takes it)
        cfg["model"] = {"name": "larp_ar",
                        "args": {**cfg["model"]["args"], "n_layer": 8, "n_head": 20, "dim": 1280}}
        pair = {d: _trainer({**cfg, "save_dir": str(tmp / f"{name}_{d}")}, d)
                for d in ("cpu", "cuda")}
        cpu, gpu = pair["cpu"], pair["cuda"]
        _perturb(cpu.model, SEED + 82)
        gpu.model.load_state_dict(cpu.model.state_dict())
        infos, secs = {}, {}
        for d, tr in pair.items():
            t0 = time.perf_counter()
            keys, packed = tr.train_step(batch)
            infos[d] = dict(zip(keys, packed.tolist()))
            secs[d] = time.perf_counter() - t0
        n_params = sum(p.numel() for p in cpu.model.parameters())
        loss_err = abs(infos["cuda"]["loss"] - infos["cpu"]["loss"]) / abs(infos["cpu"]["loss"])
        topk_err = max(abs(infos["cuda"][k] - infos["cpu"][k]) for k in ("top1", "top5"))
        log(f"[ar train fp32] {name}: prior {n_params:,} params ({cpu.model_cfg.n_layer} layers, "
            f"S = {cpu.model_cfg.max_seq_len + cpu.model_cfg.cls_token_num - 1}), batch 1, dropouts "
            f"0, TF32 off: CPU step (plain versions) {secs['cpu']:.1f} s, card step "
            f"{secs['cuda']:.2f} s; loss {infos['cuda']['loss']:.6g}/{infos['cpu']['loss']:.6g} "
            f"(card/CPU, relative difference {loss_err:.2e}, tol 2e-4), top1 "
            f"{infos['cuda']['top1']:.4f}/{infos['cpu']['top1']:.4f}, top5 "
            f"{infos['cuda']['top5']:.4f}/{infos['cpu']['top5']:.4f} (tol 2/1024)")
        require(all(np.isfinite(v) for v in infos["cuda"].values()), f"{name}: non-finite info")
        require(loss_err <= 2e-4, f"ar train {name}: losses differ by {loss_err}")
        require(topk_err <= 2 / 1024, f"ar train {name}: top-k differs by {topk_err}")
        gp, cp = dict(gpu.model.named_parameters()), dict(cpu.model.named_parameters())
        worst = 0.0
        for pname in named + (() if name == "larp_ar_fp" else ("cls_embedding.embedding_table.weight",)):
            g, c = gp[pname].grad, cp[pname].grad
            require(g is not None and c is not None, f"ar train {name}: no gradient for {pname}")
            rel = (g.cpu() - c).abs().max().item() / c.abs().max().item()
            worst = max(worst, rel)
            log(f"[ar train fp32] {name} grad {pname}: max|card-cpu|/max|cpu| {rel:.2e} "
                f"(max|g| {c.abs().max().item():.3e}; tol 1e-3)")
        require(worst <= 1e-3, f"ar train {name}: gradients differ by {worst} of their scale")
        records[f"train_{name[len('larp_'):]}"] = {"parity_loss_rel": loss_err, "parity_grad_rel": worst,
                                    "parity_cpu_s": secs["cpu"]}
        del pair, cpu, gpu, gp, cp
        torch.cuda.empty_cache()

    # (c) throughput and (d) launch counts, batch 8, dropouts as configured
    kernels = (flash_attn_fwd, flash_attn_bwd_dq, flash_attn_bwd_dkv, vq_argmax, w8_matmul)
    B, warm, timed = 8, 2, 5
    for name in ("larp_ar", "larp_ar_fp"):
        tr = _trainer(_ar_cfg(tmp / name, name, vae_dir, B), "cuda")
        mc = tr.model_cfg
        batches = tr.train_loader(1)
        fetch_s = []

        def step():
            t0 = time.perf_counter()
            b = next(batches)
            fetch_s.append(time.perf_counter() - t0)
            return tr.train_step(b)

        for _ in range(warm):
            step()
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        for k in kernels[:3]:
            k.launches_sm90 = k.launches_tf32x3 = 0
        vq_argmax.launches_tc = 0
        torch.cuda.reset_peak_memory_stats()
        fetch_s.clear()
        times, infos = [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            infos.append(step())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {k.__name__: k.launches for k in kernels}
        tf32x3 = {k.__name__: k.launches_tf32x3 for k in kernels[:3]}
        sm90 = {k.__name__: k.launches_sm90 for k in kernels[:3]}
        vq_tc = vq_argmax.launches_tc
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        loader_s = statistics.mean(fetch_s)
        prof_wall_ms, per_cat, n_events, under_load = _profile_and_load(step, timed)
        busy_ms = sum(per_cat.values()) / 1e3
        idle = 1.0 - busy_ms / prof_wall_ms
        mean_s = statistics.mean(times)
        tokens = B * mc.max_seq_len  # targets a step
        want = {"flash_attn_fwd": (12 + mc.n_layer) * timed,
                "flash_attn_bwd_dq": mc.n_layer * timed, "flash_attn_bwd_dkv": mc.n_layer * timed,
                "vq_argmax": timed, "w8_matmul": 0}
        want_tf32x3 = {k: want[k] for k in tf32x3}
        finite = all(torch.isfinite(packed).all().item() for _, packed in infos)
        keys, last = infos[-1]
        last = dict(zip(keys, last.tolist()))
        log(f"[ar train {name}] batch {B}, {mc.n_layer} layers of {mc.dim}, "
            f"S = {mc.max_seq_len + mc.cls_token_num - 1}, dropouts token "
            f"{mc.token_dropout_p} resid {mc.resid_dropout_p} ffn {mc.ffn_dropout_p} class "
            f"{mc.class_dropout_prob}, {timed} steps: {', '.join(f'{t:.3f}' for t in times)} s; "
            f"mean {mean_s:.3f} s/step = {tokens / mean_s:.0f} training tokens/s = "
            f"{B / mean_s:.2f} clips/s (median {statistics.median(times):.3f} s); loader "
            f"{loader_s * 1e3:.1f} ms per step on the host; peak memory {peak_gb:.2f} GiB; last "
            f"loss {last['loss']:.4f}, top1 {last['top1']:.4f}, top5 {last['top5']:.4f}")
        log(f"[ar train {name}] launches over the timed steps {launches} (expect {want}), of which "
            f"the 3xTF32 kernels {tf32x3} (expect {want_tf32x3}), the wgmma kernels {sm90} "
            f"(expect 0) and vq_tc_kernel {vq_tc} (expect {timed})")
        log(f"[ar train {name}] profiled {timed} steps: wall {prof_wall_ms / timed:.1f} ms per "
            f"step, device busy {busy_ms / timed:.1f} ms, idle {idle:.1%}, {n_events / timed:.0f} "
            f"device events per step; device ms per step by category: "
            + ", ".join(f"{c} {us / 1e3 / timed:.1f} ({us / 1e3 / busy_ms:.1%})"
                        for c, us in sorted(per_cat.items(), key=lambda kv: -kv[1])))
        log(f"[ar train {name}] the card during two further steps (SM clock, its maximum, power "
            f"draw, temperature): {under_load}")
        require(finite, f"ar train {name}: non-finite losses")
        require(launches == want, f"ar train {name}: launch counts {launches}, expected {want}")
        require(tf32x3 == want_tf32x3, f"ar train {name}: 3xTF32 launches {tf32x3}")
        require(not any(sm90.values()), f"ar train {name}: wgmma launches {sm90}")
        require(vq_tc == timed, f"ar train {name}: {vq_tc} of {timed} VQ launches on vq_tc_kernel")
        records[f"train_{name[len('larp_'):]}"].update(
            batch=B, s_per_step=mean_s, tokens_per_s=tokens / mean_s, clips_per_s=B / mean_s,
            peak_gib=peak_gb, idle=idle, loader_s=loader_s,
            device_ms_per_step={c: us / 1e3 / timed for c, us in per_cat.items()})
        for k in kernels[:3]:
            row = records[f"{k.__name__}_tf32x3"]
            row["launches"] += tf32x3[k.__name__]
            row[f"{name}_launches"] = tf32x3[k.__name__]
        records["vq_argmax"]["launches"] += vq_tc
        records["vq_argmax"][f"{name}_launches"] = vq_tc
        del tr, batches
        torch.cuda.empty_cache()

    # (e) the train CLI on cfgs/larp_ar.yaml through one epoch, eval and vis
    for k in (decode_attention, write_rows_per_row):
        k.launches = 0
    out = tmp / "cli"
    t0 = time.perf_counter()
    tr = train_main(["--cfg", str(ROOT / "cfgs" / "larp_ar.yaml"), "--csv_file", "null128",
                     "-b", "8", "-j", "0", "--device", "cuda", "--manualSeed", str(SEED),
                     "--out_path", str(out), "--opts", "max_epoch", "1", "eval_epoch", "1",
                     "vis_epoch", "1", "vae.checkpoint", str(vae_dir),
                     "test_dataset.csv_paths.ucf101_val", "null128",
                     "fvd_real_stats_path", str(real_stats), "force_fvd", "true"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = out / "larp_ar"
    text = (run / "log.txt").read_text()
    line = next((l for l in text.splitlines() if "Epoch 1, train:" in l), "")
    losses = [float(x.split("=")[1].rstrip(",")) for x in line.split() if x.startswith("loss=")]
    n_decode, n_rows = decode_attention.launches, write_rows_per_row.launches
    grid_path = run / "vis" / "samples_ep1.png"
    grid = _read_png(grid_path) if grid_path.exists() else None
    grid_text = "missing" if grid is None else f"{grid.shape}, pixel std {grid.std():.4g}"
    gfvd = [float(l.rsplit(" ", 1)[1]) for l in text.splitlines() if "sample gFVD:" in l]
    del tr
    torch.cuda.empty_cache()
    model = load_ar_checkpoint(str(run / "epoch-final"), device="cuda")
    seq = generate(model, torch.tensor([3, 40], device="cuda"), 16,
                   torch.Generator(device="cuda").manual_seed(SEED + 83))
    torch.cuda.synchronize()
    log(f"[ar train cli] train.main on cfgs/larp_ar.yaml, batch 8, one epoch of null128: "
        f"{wall:.1f} s; train and eval losses {losses}; visualize_epoch sampled 4 x 1024 tokens "
        f"with {n_decode} decode attentions and {n_rows} row writes (fp32 cache: the earlier "
        f"kernels), grid {grid_text}; sample gFVD {gfvd}; epoch-final loaded by "
        f"load_ar_checkpoint, 16 tokens sampled: {seq[0].tolist()}")
    require("visualize_epoch failed" not in text, "ar train cli: visualize_epoch failed")
    require("gFVD computation failed" not in text and len(gfvd) == 1
            and math.isfinite(gfvd[0]), f"ar train cli: sample gFVD {gfvd}")
    require("Epoch 1 training done" in text and len(losses) == 2
            and all(math.isfinite(v) for v in losses), f"ar train cli: losses {losses}")
    require(grid is not None and grid.shape == (4 * 128, 8 * 128, 3) and grid.std() > 0,
            f"ar train cli: sample grid {grid_text}")
    require(n_decode == 30 * 1023 and n_rows == 30 * 1023,
            f"ar train cli: {n_decode} decode attentions, {n_rows} row writes")
    require(tuple(seq.shape) == (2, 16) and int(seq.min()) >= 0 and int(seq.max()) < 8192,
            f"ar train cli: sampled codes {seq.tolist()}")
    records["train_ar"]["cli_s"] = wall
    records["train_ar"]["cli_gfvd"] = gfvd[0]
    for row, n in (("decode_attention_split", n_decode), ("cache_update", n_rows)):
        records[row]["launches"] += n
        records[row]["larp_ar_vis_launches"] = n
    del model


_MODEL_NEW_CFGS = ("larp_tokenizer_large", "larp_tokenizerf256t1024", "larp_tokenizerf256t768",
                   "larp_tokenizerf256t512")
_MODEL_NEW_PARITY_DEPTH = {"larp_tokenizer_large": 8, "larp_tokenizerf256t768": 4,
                           "larp_tokenizerf256t512": 4}


def _model_new(tmp: Path, name: str, dtype, seed: int, perturb: bool = True):
    """cfgs/<name>.yaml's model_new autoencoder at full width, built from the
    yaml as the trainer builds it (the int `patch_size: 8` read as (4, 8, 8)),
    seeded (and perturbed), on the host; and its attention layers per forward."""
    import torch

    from video_tokenizer_tpu_torch.registry import models

    cfg = _load_cfg(name, tmp, 1)
    model = models.make(cfg["model"], args={"dtype": dtype,
                                            "generator": torch.Generator().manual_seed(seed)})
    if perturb:
        _perturb(model, seed + 1)
    stacks = (model.encoder, getattr(model, "encoder1", None), model.decoder)
    return model, sum(m.blocks.depth for m in stacks if m is not None)


def phase_model_new(tmp: Path, records: dict) -> None:
    """The model_new family (conv-patchify, M-RoPE, FSQ) at full width:
      (a) fp32 (TF32 off), batch 1, the four shipped configs built through
          their yaml (cfgs/larp_tokenizer_large.yaml and
          larp_tokenizerf256t{1024,768,512}.yaml), card against the same
          weights on the CPU through the plain versions, autoencoder_large at
          8 + 8 of its 24 + 24 layers and f256t768 / t512 at 4 of each
          stack's 12 (the run's budget; f256t1024a whole): FSQ indices (and the
          first frame's) >= 99% equal; decode_from_bottleneck of the CPU's
          indices within 1e-3 of the scale, or 5x the CPU's own change under a
          1e-6 nudge of proj_in where these random weights amplify rounding
          more; the decoder's first and last blocks on the CPU's inputs within
          1e-5; on the card,
          decode_from_bottleneck(indices[, first_indices]) equal to the
          forward's decode within 1e-5 of the scale; exact flash launches per
          forward, all on the 3xTF32 kernel;
      (b) bf16 reconstruction at batch 8 through `reconstruct` for
          autoencoder_large and autoencoder_first_token_f256t768: clips/s
          (median of 5 batches after a warm-up), peak memory, exact launch
          counts (48 and 36 flash forwards a batch, all on the wgmma kernel),
          device time by kernel category;
      (c) one fp32 training step at batch 1 of cfgs/larp_tokenizer_large.yaml
          through the port's trainer (generator, transformer discriminator,
          LPIPS), card against CPU from the same weights, at 8 + 8 of the
          24 + 24 layers (`_model_new_train_parity` says why): losses, FSQ
          indices, named gradients, with phase 11's bounds;
      (d) training throughput through the trainer (`_train_throughput`):
          bf16 at batch 8, the config's fp32 at batch 4; per step 72 flash
          forwards (48 tokenizer, 24 discriminator), 56 dQ + 56 dK/dV (72 +
          72 on a discriminator step), no VQ;
      (e) the train CLI on cfgs/larp_tokenizer_large.yaml (null128, bf16,
          batch 8, one epoch, eval, `visualize_epoch`): the grid decodes and is not
          constant; the reconstruct CLI loads the run's `epoch-final` and
          reconstructs on the card."""
    weights = _model_new_parity(tmp, records)
    _model_new_reconstruction(tmp, records, weights)
    del weights
    _model_new_train_parity(tmp, records)
    _model_new_train_throughput(tmp, records)
    _model_new_cli(tmp, records)


def _fsq_indices(out: dict) -> list:
    return [out[k] for k in ("bottleneck_rep", "first_rep") if k in out]


def _model_new_parity(tmp: Path, records: dict) -> dict:
    """Phase 19 (a); returns the fp32 weights of autoencoder_large and f256t768."""
    import torch

    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd

    fsq_indices = _fsq_indices
    # (a) fp32, card against CPU, all four configs. At these random weights
    # the deep models amplify fp32 rounding: a 1e-6 relative change of the
    # decoder's proj_in weights moves autoencoder_large's reconstruction by
    # ~2e-3 of its scale. So the end-to-end bound is 1e-3 of the scale or 5x
    # that yardstick (measured here on the CPU; the card read 2.4x), and
    # each decoder's first and last blocks are held on the CPU's own inputs
    # to 1e-5 of their output's scale, where no depth amplifies anything
    # (the budget: the CPU forwards of the three deep configs run at cut depth,
    # 8 of autoencoder_large's 24 + 24 layers and 4 of each f256t768 / t512
    # stack's 12, at full width; the bf16 phases below keep the whole depth)
    weights, layers = {}, {}
    x = torch.rand(1, 3, 16, 128, 128, generator=torch.Generator().manual_seed(SEED + 100))
    for i, name in enumerate(_MODEL_NEW_CFGS):
        model, full_layers = _model_new(tmp, name, torch.float32, SEED + 101 + 2 * i)
        model.eval()
        n_params = sum(p.numel() for p in model.parameters())
        if name in ("larp_tokenizer_large", "larp_tokenizerf256t768"):
            weights[name] = {k: v.clone() for k, v in model.state_dict().items()}
        depth = _MODEL_NEW_PARITY_DEPTH.get(name)
        if depth is not None:
            _cut_depth(model, depth)
        stacks = (model.encoder, getattr(model, "encoder1", None), model.decoder)
        layers[name] = sum(m.blocks.depth for m in stacks if m is not None)
        blocks = model.decoder.blocks
        probe_names = ("attn_0", "ffd_0", f"attn_{blocks.depth - 1}", f"ffd_{blocks.depth - 1}")
        probes = {}
        hooks = [getattr(blocks, n).register_forward_hook(
            lambda m, i, o, n=n: probes.__setitem__(n, (i, o))) for n in probe_names]
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = model(x)
            for h in hooks:
                h.remove()
            ref_dec = model.decode_from_bottleneck(*fsq_indices(ref))
        cpu_s = time.perf_counter() - t0
        with torch.inference_mode():  # the yardstick: proj_in's weights x (1 + 1e-6)
            w = model.decoder.proj_in.weight
            kept = w.clone()
            w.mul_(1 + 1e-6)
            nudged = model.decode_from_bottleneck(*fsq_indices(ref))
            w.copy_(kept)
        scale = ref_dec.abs().max().item()
        yardstick = (nudged - ref_dec).abs().max().item() / scale
        model.cuda()
        flash_attn_fwd.launches = flash_attn_fwd.launches_tf32x3 = 0
        with torch.inference_mode():
            got = model(x.cuda())
            n_fwd, n_tf32x3 = flash_attn_fwd.launches, flash_attn_fwd.launches_tf32x3
            dec_cpu_idx = model.decode_from_bottleneck(*(i.cuda() for i in fsq_indices(ref)))
            dec_own = model.decode_from_bottleneck(*fsq_indices(got))
            block_errs = {}
            for n, (args, out) in probes.items():
                o = getattr(blocks, n)(*(a.cuda() for a in args))
                block_errs[n] = (o.cpu() - out).abs().max().item() / out.abs().max().item()
        torch.cuda.synchronize()
        agree = [(g.cpu() == r).float().mean().item()
                 for g, r in zip(fsq_indices(got), fsq_indices(ref))]
        rec_err = (dec_cpu_idx.cpu() - ref_dec).abs().max().item() / scale
        own_err = (dec_own - got["pred_frames"]).abs().max().item() / scale
        pred_err = (got["pred_frames"].cpu() - ref["pred_frames"]).abs().max().item() / scale
        rec_tol = max(1e-3, 5 * yardstick)
        log(f"[model_new fp32] {name} ({_load_cfg(name, tmp, 1)['model']['name']}, "
            f"patch {model.patch_size}, {n_params:,} params, {model.num_latent_tokens} latent "
            f"tokens, FSQ-{model.codebook_size}), batch 1, TF32 off, "
            f"{layers[name]} of its {full_layers} layers: CPU plain path {cpu_s:.1f} s; "
            f"FSQ indices agree {', '.join(f'{a:.4%}' for a in agree)} (tol >= 99%); "
            f"decode_from_bottleneck(CPU indices) max|card-cpu| {rec_err:.3e} of the scale "
            f"{scale:.4g} (tol {rec_tol:.3e}: the CPU's own change under proj_in x (1 + 1e-6) "
            f"{yardstick:.3e}); decoder blocks on the CPU's inputs "
            + ", ".join(f"{n} {e:.2e}" for n, e in block_errs.items())
            + f" (tol 1e-5); card decode_from_bottleneck(card indices) vs the forward's "
            f"{own_err:.3e} (tol 1e-5); pred_frames max|card-cpu| {pred_err:.3e} of the scale; "
            f"flash launches {n_fwd} (expect {layers[name]}), 3xTF32 {n_tf32x3}")
        require(tuple(got["pred_frames"].shape) == (1, 3, 16, 128, 128), f"{name}: shape")
        require(torch.isfinite(got["pred_frames"]).all().item(), f"{name}: non-finite output")
        require(min(agree) >= 0.99, f"{name}: FSQ index agreement {agree}")
        require(rec_err <= rec_tol, f"{name}: reconstruction error {rec_err} > {rec_tol}")
        require(max(block_errs.values()) <= 1e-5, f"{name}: decoder blocks differ {block_errs}")
        require(own_err <= 1e-5, f"{name}: decode_from_bottleneck differs by {own_err}")
        require(n_fwd == n_tf32x3 == layers[name], f"{name}: flash launches {n_fwd}/{n_tf32x3}")
        records[f"model_new_{name}"] = {
            "params": n_params, "cpu_s": cpu_s, "index_agree": min(agree), "rec_err_rel": rec_err,
            "yardstick": yardstick, "block_err_rel": max(block_errs.values()),
            "flash_per_forward": n_fwd, "layers": layers[name], "full_layers": full_layers}
        del model, got, dec_cpu_idx, dec_own, probes
        torch.cuda.empty_cache()
    return weights


def _model_new_reconstruction(tmp: Path, records: dict, weights: dict) -> None:
    """Phase 19 (b): bf16 reconstruction at batch 8 of the models in `weights`."""
    import numpy as np
    import torch

    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
    from video_tokenizer_tpu_torch.reconstruct import make_clips, reconstruct

    B, iters = 8, 5
    clips = torch.from_numpy(make_clips(np.random.default_rng(SEED), B, 16, 128)).cuda()
    for name, state in weights.items():
        model, n_layers = _model_new(tmp, name, torch.bfloat16, SEED, perturb=False)
        model.load_state_dict(state)
        model.cuda().eval()
        reconstruct(model, clips)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attn_fwd.launches = flash_attn_fwd.launches_sm90 = 0
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            rec = reconstruct(model, clips)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches, sm90 = flash_attn_fwd.launches, flash_attn_fwd.launches_sm90
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        prof_wall_ms, per_cat, n_events, _ = _profile_and_load(lambda: reconstruct(model, clips), 3)
        busy_ms = sum(per_cat.values()) / 1e3
        clips_per_s = B / statistics.median(times)
        mse = torch.mean((rec - clips).reshape(B, -1) ** 2).item()
        log(f"[model_new bf16] {name} batch {B}: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; "
            f"median {statistics.median(times) * 1e3:.2f} ms = {clips_per_s:.2f} clips/s; peak "
            f"memory {peak_gb:.2f} GiB; mse {mse:.5f}; flash launches {launches} (expect "
            f"{n_layers * iters}), wgmma {sm90}; profiled 3 batches: wall "
            f"{prof_wall_ms / 3:.1f} ms, device busy {busy_ms / 3:.1f} ms, idle "
            f"{1 - busy_ms / prof_wall_ms:.1%}, {n_events / 3:.0f} kernels per batch; device ms "
            f"per batch by category: " + ", ".join(
                f"{c} {us / 1e3 / 3:.2f} ({us / 1e3 / busy_ms:.1%})"
                for c, us in sorted(per_cat.items(), key=lambda kv: -kv[1])))
        require(tuple(rec.shape) == (B, 3, 16, 128, 128) and torch.isfinite(rec).all().item(),
                f"{name} bf16: reconstruction")
        require(launches == sm90 == n_layers * iters, f"{name} bf16: flash launches {launches}, "
                f"wgmma {sm90}, expected {n_layers * iters}")
        records[f"model_new_{name}"].update(
            clips_per_s=clips_per_s, peak_gib=peak_gb, idle=1 - busy_ms / prof_wall_ms,
            device_ms_per_batch={c: us / 1e3 / 3 for c, us in per_cat.items()},
            bf16_flash_launches=launches)
        del model, rec
        torch.cuda.empty_cache()


def _cut_depth(model, depth: int):
    """Keeps the first `depth` blocks of every block stack of `model`, at full
    width: the encoders and decoder of a LARP or model_new tokenizer (a
    ModuleList, or the gated stack's `attn_i` / `ffd_i` and `depth`) and a
    gptc prior's blocks. Returns a function that puts the whole stacks back."""
    import torch

    undo = []
    for stack in (model, *(getattr(model, n, None) for n in ("encoder", "encoder1", "decoder"))):
        blocks = getattr(stack, "blocks", None)
        if isinstance(blocks, torch.nn.ModuleList):
            stack.blocks = blocks[:depth]
            undo.append(lambda s=stack, b=blocks: setattr(s, "blocks", b))
        elif blocks is not None and hasattr(blocks, "depth"):
            cut = {f"{k}_{i}": getattr(blocks, f"{k}_{i}")
                   for i in range(depth, blocks.depth) for k in ("attn", "ffd")}
            for name in cut:
                delattr(blocks, name)
            whole, blocks.depth = blocks.depth, depth

            def put_back(b=blocks, cut=cut, whole=whole):
                for name, m in cut.items():
                    b.add_module(name, m)
                b.depth = whole
            undo.append(put_back)
    return lambda: [f() for f in reversed(undo)]


# the depth of each stack in the card-vs-CPU comparisons of phases 21 and 22,
# at full width (the run's budget: the CPU side's time grows with depth, and
# deep random stacks only amplify fp32 rounding, phase 19 (a)); the card's own
# runs there keep the whole depth
PARITY_DEPTH = 4


def _model_new_train_parity(tmp: Path, records: dict) -> None:
    """Phase 19 (c): one fp32 step of cfgs/larp_tokenizer_large.yaml, card
    against CPU, at full width and 8 + 8 of the 24 + 24 layers: deep, these
    random weights amplify fp32 rounding (phase (a)'s yardstick ~2e-3 of the
    output at 24 + 24; in a 24 + 24 step 0.5% of the FSQ indices flipped and
    the losses moved 6.5e-3; at 12 + 12 the indices and losses agreed, the
    gradients to 7.6e-4 of their scale, near the 1e-3 bound)."""
    import numpy as np
    import torch

    cfg = _load_cfg("larp_tokenizer_large", tmp, 1)
    cfg["loss"]["args"]["d_update_freq"] = 1
    pair = {d: _trainer({**cfg, "save_dir": str(tmp / f"model_new_fp32_{d}")}, d)
            for d in ("cpu", "cuda")}
    cpu, gpu = pair["cpu"], pair["cuda"]
    for tr in (cpu, gpu):
        _cut_depth(tr.model, 8)
        tr.opt_g.param_groups[0]["params"] = list(tr.model.parameters())
    _perturb(cpu.model, SEED + 110)
    _perturb(cpu.disc, SEED + 111)
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.loss_mod.load_state_dict(cpu.loss_mod.state_dict())
    clip = np.random.default_rng(SEED + 112).integers(0, 256, (1, 3, 16, 128, 128), dtype=np.uint8)
    reps, infos, secs = {}, {}, {}
    for device, tr in pair.items():
        hook = tr.model.quantize.register_forward_hook(
            lambda m, i, o, d=device: reps.__setitem__(d, o[1]["indices"].cpu()))
        t0 = time.perf_counter()
        keys, packed = tr.train_step({"gt": torch.from_numpy(clip)})
        infos[device] = dict(zip(keys, packed.tolist()))
        secs[device] = time.perf_counter() - t0
        hook.remove()
    agree = (reps["cuda"] == reps["cpu"]).float().mean().item()
    loss_keys = ("loss", "rec_loss", "perceptual_loss", "g_loss", "d_loss", "loss_q",
                 "logits_real", "logits_fake")
    loss_err = max(abs(infos["cuda"][k] - infos["cpu"][k]) / max(abs(infos["cpu"][k]), 1e-6)
                   for k in loss_keys)
    log(f"[model_new train fp32] autoencoder_large {sum(p.numel() for p in cpu.model.parameters()):,}"
        f" + discriminator {sum(p.numel() for p in cpu.disc.parameters()):,} + LPIPS params, "
        f"batch 1, 8 + 8 of the 24 + 24 layers, TF32 off: CPU step (plain versions) {secs['cpu']:.1f} s, "
        f"card step {secs['cuda']:.2f} s; FSQ indices agree on {agree:.4%} (tol >= 99.9%); losses "
        + ", ".join(f"{k} {infos['cuda'][k]:.6g}/{infos['cpu'][k]:.6g}" for k in loss_keys)
        + f" (card/CPU; largest relative difference {loss_err:.2e}, tol 2e-4)")
    require(set(infos["cuda"]) == set(infos["cpu"]), "model_new train fp32: info keys differ")
    require(all(np.isfinite(v) for v in infos["cuda"].values()), "model_new train: non-finite")
    require(agree >= 0.999, f"model_new train fp32: FSQ agreement {agree}")
    require(loss_err <= 2e-4, f"model_new train fp32: losses differ by {loss_err}")
    worst = 0.0
    for tag, gm, cm, names in (
            ("model", gpu.model, cpu.model, ("encoder.proj_in.weight",
                                             "encoder.blocks.attn_4.to_qkv.weight",
                                             "encoder.blocks.ffd_7.proj_out.weight",
                                             "decoder.blocks.attn_0.q_norm.weight",
                                             "decoder.blocks.ffd_7.proj_in.weight",
                                             "decoder.proj_out.weight")),
            ("disc", gpu.disc, cpu.disc, ("transformer_encoder.blocks.3.attn.qkv.weight",
                                          "x_embedder.proj.weight"))):
        gp, cp = dict(gm.named_parameters()), dict(cm.named_parameters())
        for pname in names:
            g, c = gp[pname].grad, cp[pname].grad
            require(g is not None and c is not None, f"model_new train: no gradient for {pname}")
            rel = (g.cpu() - c).abs().max().item() / c.abs().max().item()
            worst = max(worst, rel)
            log(f"[model_new train fp32] grad {tag} {pname}: max|card-cpu|/max|cpu| {rel:.2e} "
                f"(max|g| {c.abs().max().item():.3e}; tol 1e-3)")
    require(worst <= 1e-3, f"model_new train fp32: gradients differ by {worst} of their scale")
    records["model_new_larp_tokenizer_large"].update(
        train_parity_loss_rel=loss_err, train_parity_grad_rel=worst, train_parity_cpu_s=secs["cpu"])
    del pair, cpu, gpu
    torch.cuda.empty_cache()


def _model_new_train_throughput(tmp: Path, records: dict) -> None:
    """Phase 19 (d): bf16 at batch 8, the config's fp32 at batch 4."""
    for dtype, use_amp, batch in (("bf16", True, 8), ("fp32", False, 4)):
        cfg = _load_cfg("larp_tokenizer_large", tmp / f"model_new_{dtype}", batch)
        cfg["use_amp"] = use_amp
        run = _train_throughput(f"model_new train {dtype}", cfg, (72, 56, 16), 0)
        records[f"train_model_new_{dtype}"] = {k: v for k, v in run.items() if k != "tf32x3"}
        for k, n in run["launches"].items():
            if k != "vq_argmax":
                row = records[f"{k}_tf32x3" if dtype == "fp32" else k]
                row[f"model_new_{dtype}_launches"] = n


def _model_new_cli(tmp: Path, records: dict) -> None:
    """Phase 19 (e): the train CLI through one short epoch with eval and vis,
    bf16 at batch 8 (16 steps: fp32 at batch 2, 64 steps, before phase 21
    needed the time; fp32 training is (c) and (d)); the reconstruct CLI on
    its checkpoint."""
    import torch

    from video_tokenizer_tpu_torch.reconstruct import main as reconstruct_main
    from video_tokenizer_tpu_torch.train import main as train_main

    out = tmp / "model_new_cli"
    t0 = time.perf_counter()
    tr = train_main(["--cfg", str(ROOT / "cfgs" / "larp_tokenizer_large.yaml"), "--csv_file",
                     "null128", "-b", "8", "-j", "0", "--device", "cuda", "--manualSeed", str(SEED),
                     "--out_path", str(out), "--opts", "max_epoch", "1", "eval_epoch", "1",
                     "vis_epoch", "1", "use_amp", "true",
                     "test_dataset.csv_paths.ucf101_val", "null128"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_steps = tr.step
    del tr
    torch.cuda.empty_cache()
    run_dir = out / "larp_tokenizer_large"
    text = (run_dir / "log.txt").read_text()
    line = next((l for l in text.splitlines() if "Epoch 1, train:" in l), "")
    losses = [float(x.split("=")[1].rstrip(",")) for x in line.split() if x.startswith("loss=")]
    grid_path = run_dir / "vis" / "epoch_1.png"
    grid = _read_png(grid_path) if grid_path.exists() else None
    grid_text = "missing" if grid is None else f"{grid.shape}, pixel std {grid.std():.4g}"
    t0 = time.perf_counter()
    result = reconstruct_main(["--checkpoint", str(run_dir / "epoch-final"), "--device", "cuda",
                               "--batch_size", "2", "--num_batches", "2"])
    load_s = time.perf_counter() - t0
    log(f"[model_new cli] train.main on cfgs/larp_tokenizer_large.yaml, batch 8, one epoch of "
        f"null128 ({n_steps} bf16 steps), eval and vis: {wall:.1f} s; train and eval losses "
        f"{losses}; vis grid {grid_text}; reconstruct --checkpoint epoch-final on the card "
        f"({load_s:.1f} s with the load): {json.dumps(result)}")
    require("visualize_epoch failed" not in text, "model_new cli: visualize_epoch failed")
    require(n_steps == 16 and len(losses) == 2 and all(math.isfinite(v) for v in losses),
            f"model_new cli: {n_steps} steps, losses {losses}")
    require(grid is not None and grid.shape == (2 * 4 * 128, 8 * 128, 3) and grid.std() > 0,
            f"model_new cli: vis grid {grid_text}")
    require(result["clips"] == 4 and result["device"] == torch.cuda.get_device_name(0),
            f"model_new cli: reconstruct {result}")
    records["model_new_larp_tokenizer_large"]["cli_s"] = wall


class _Timed:
    """Wraps `owner.attr` (a function or method) while active: CUDA events
    around each call, kept per name, and the results of the calls when
    `keep` is set. The launch counters are untouched."""

    def __init__(self, owner, attr: str, name: str, marks: dict, keep: list = None):
        self.owner, self.attr, self.name, self.marks, self.keep = owner, attr, name, marks, keep

    def __enter__(self):
        import torch

        self.inner = getattr(self.owner, self.attr)
        inner, marks, name, keep = self.inner, self.marks, self.name, self.keep

        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kwargs)
            end.record()
            marks.setdefault(name, []).append((start, end))
            if keep is not None:
                keep.append(out)
            return out

        setattr(self.owner, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.inner)


def _events_ms(marks: dict) -> dict:
    import torch

    torch.cuda.synchronize()
    return {k: [s.elapsed_time(e) for s, e in v] for k, v in marks.items()}


def phase_fvd(tmp: Path, records: dict) -> Path:
    """FVD on the card (phase 20). The I3D extractor is the port's seeded
    full Kinetics-400 I3D (12,697,264 parameters, `random_variables(0)`, what
    every entry point loads without `--i3d_weights`), fp32 without TF32:
      (a) 2 clips of 16 x 128 x 128 through the extractor (resize included),
          card against CPU: features within 1e-4 of their scale, and every
          Mixed block on the CPU's own input within 1e-5 of its output's
          scale; the extractor's clips/s and peak memory at batch 16;
      (b) the eval CLI (`eval/eval_larp_tokenizer.py`) on the flagship
          tokenizer, seeded and perturbed as in phase 6, saved as an
          upstream-format `.pth` and read back through `--tokenizer`:
          `--use_amp`, batch 16, `--csv_file null128` (8 batches): clips/s,
          device ms per batch for reconstruction / LPIPS / I3D (events),
          peak memory; exact launches, 24 x 8 of the bf16 wgmma flash forward
          and 8 of the VQ search on vq_tc_kernel; FVD of the reals against
          themselves <= 1e-6 of trace(C), the reconstruction FVD finite and
          > 0; first, the evaluator on the first 2 clips in fp32 on the card
          against the CPU: mse / psnr / lpips within 1e-3 of their scale;
      (c) the merge CLI on (b)'s features saved as two shards (batches 0-3 and
          4-7) prints (b)'s FVD;
      (d) the tokenizer trainer (`train.main`, cfgs/larp_tokenizer.yaml, bf16,
          batch 8, `force_fvd`, `save_best`, a null128 test set, two epochs):
          `eval rFVD:` each epoch, no failed FVD line, exactly one
          `best_fvd_*` directory, the lower FVD's (the AR trainer's
          `sample gFVD:` is checked in phase 18, against (b)'s real stats);
      (e) `sample.py --csv_file null128` as one job at full width: bf16, CFG
          1.5, top-k 100, batch 8, 8 samples: both shards, `done_0.flag`,
          `merged.flag`, one `fvd_report.csv` row whose finite FVD is the
          merge CLI's over the same shards; 30 x 1023 decode attentions on
          the tensor-core kernel, each writing its row.
    Returns the path of (b)'s real stats."""
    import contextlib
    import csv
    import io

    import numpy as np
    import torch

    from video_tokenizer_tpu_torch import FLAGSHIP_TOKENIZER, flagship_tokenizer
    from video_tokenizer_tpu_torch.eval import rfvd_evaluator
    from video_tokenizer_tpu_torch.eval.calc_fvd_from_multiple_feature_stats import (
        main as merge_main,
    )
    from video_tokenizer_tpu_torch.eval.eval_larp_tokenizer import main as eval_main
    from video_tokenizer_tpu_torch.metrics.fvd import FeatureStats, frechet_distance
    from video_tokenizer_tpu_torch.metrics.i3d import I3DFeatureExtractor
    from video_tokenizer_tpu_torch.models.lpips import LPIPS
    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
    from video_tokenizer_tpu_torch.ops.decode_attention import decode_attention
    from video_tokenizer_tpu_torch.ops.vq import vq_argmax
    from video_tokenizer_tpu_torch.sample import main as sample_main
    from video_tokenizer_tpu_torch.train import main as train_main
    from video_tokenizer_tpu_torch.utils.common import no_tf32

    out: dict = {}
    t_phase = time.perf_counter()

    # (a) I3D, card against CPU
    gpu, cpu = I3DFeatureExtractor(None, "cuda"), I3DFeatureExtractor(None, "cpu")
    n_params = sum(p.numel() for p in gpu.model.parameters())
    x = torch.rand(2, 3, 16, 128, 128, generator=torch.Generator().manual_seed(SEED + 200))
    seen = {}  # each Mixed block's input and output on the CPU
    hooks = [getattr(cpu.model, name).register_forward_hook(
        lambda mod, args, output, name=name: seen.__setitem__(name, (args[0], output)))
        for name in cpu.model.plan if isinstance(name, str)]
    t0 = time.perf_counter()
    want = cpu(x)
    cpu_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    got = gpu(x.cuda())
    feat_err = float(np.abs(got - want).max() / np.abs(want).max())
    block_err = {}
    with torch.no_grad(), no_tf32():
        for name, (inp, outp) in seen.items():
            mine = getattr(gpu.model, name)(inp.cuda()).cpu()
            block_err[name] = float((mine - outp).abs().max() / outp.abs().max())
    log(f"[fvd i3d] seeded I3D {n_params:,} params, 2 clips [2,3,16,128,128] -> 224, fp32, TF32 "
        f"off: max|card-cpu| {feat_err:.3e} of the feature scale {np.abs(want).max():.3f} (tol "
        f"1e-4); CPU {cpu_s:.1f} s; per Mixed block on the CPU's input, worst "
        f"{max(block_err.values()):.3e} (tol 1e-5): "
        + ", ".join(f"{k} {v:.1e}" for k, v in block_err.items()))
    require(n_params == 12_697_264, f"I3D has {n_params} parameters")
    require(got.shape == (2, 400) and np.isfinite(got).all(), f"I3D features {got.shape}")
    require(max(block_err.values()) <= 1e-5, f"I3D blocks card vs CPU {block_err}")
    require(feat_err <= 1e-4, f"I3D features card vs CPU {feat_err}")
    del cpu
    xb = torch.rand(16, 3, 16, 128, 128, device="cuda")
    gpu.features(xb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    i3d_ms = median_ms(lambda: gpu.features(xb), iters=5, warmup=1)
    i3d_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[fvd i3d] batch 16: {i3d_ms:.2f} ms = {16e3 / i3d_ms:.1f} clips/s "
        f"({48.6 * 16 / i3d_ms:.1f} TFLOP/s at 48.6 GFLOP a clip), peak {i3d_gib:.2f} GiB")
    out["i3d"] = {"features_rel_err": feat_err, "block_rel_err": max(block_err.values()),
                  "batch16_ms": i3d_ms, "clips_per_s": 16e3 / i3d_ms, "peak_gib": i3d_gib}
    del gpu, xb

    # (b) the flagship tokenizer as an upstream-format .pth
    model = flagship_tokenizer(torch.float32, torch.Generator().manual_seed(SEED))
    _perturb(model, SEED + 9)
    pth = tmp / "fvd" / "tokenizer.pth"
    pth.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {"name": "larp_tokenizer", "args": FLAGSHIP_TOKENIZER,
                          "sd": model.state_dict()}}, pth)

    # (b) first: 2 clips in fp32 through the evaluator, card against CPU
    from video_tokenizer_tpu_torch.data import datasets

    ds = datasets.make({"name": "video_dataset", "args": {
        "root_path": "data/metadata", "csv_file": "null128", "frame_num": 16, "crop_size": 128,
        "cls_vid_num": "-1_-1", "split": "test", "use_all_frames": False}})
    parity, secs = {}, {}
    for dev in ("cpu", "cuda"):
        lp = LPIPS(generator=torch.Generator().manual_seed(0))
        ev = rfvd_evaluator.UCFrFVDEvaluator(model.to(dev).eval(), ds, batch_size=2, lpips=lp,
                                             compute_fvd=False, device=dev)
        t0 = time.perf_counter()
        parity[dev] = ev.evaluate(max_batches=1)
        secs[dev] = time.perf_counter() - t0
    rel = {k: abs(parity["cuda"][k] - parity["cpu"][k]) / abs(parity["cpu"][k])
           for k in ("mse", "psnr", "lpips")}
    log(f"[fvd eval] fp32 evaluator, first 2 clips of null128: card {parity['cuda']} vs CPU "
        f"{parity['cpu']}: relative {rel} (tol 1e-3); CPU {secs['cpu']:.1f} s")
    require(max(rel.values()) <= 1e-3, f"evaluator card vs CPU {rel}")
    del model, ev
    torch.cuda.empty_cache()

    # (b) the eval CLI, bf16, batch 16, 8 batches
    marks, feats = {}, []
    torch.cuda.reset_peak_memory_stats()
    flash_attn_fwd.launches = flash_attn_fwd.launches_sm90 = 0
    vq_argmax.launches = vq_argmax.launches_tc = 0
    with contextlib.ExitStack() as stack:
        for owner, attr, name, keep in (
                (rfvd_evaluator.UCFrFVDEvaluator, "evaluate", "evaluate", None),
                (rfvd_evaluator, "reconstruct", "reconstruction", None),
                (rfvd_evaluator.UCFrFVDEvaluator, "lpips_mean", "lpips", None),
                (I3DFeatureExtractor, "__call__", "i3d", feats)):
            stack.enter_context(_Timed(owner, attr, name, marks, keep))
        res = eval_main(["--tokenizer", str(pth), "--csv_path", "null128", "--frames", "16",
                         "--input_size", "128", "--batch_size", "16", "--num_workers", "0",
                         "--use_amp", "--device", "cuda"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {"flash_sm90": flash_attn_fwd.launches_sm90, "flash": flash_attn_fwd.launches,
                "vq_tc": vq_argmax.launches_tc, "vq": vq_argmax.launches}
    ms = _events_ms(marks)
    evaluate_s = ms.pop("evaluate")[0] / 1e3  # it ends waiting for the card: its wall time
    per_batch = {k: statistics.mean(v) * (2 if k == "i3d" else 1) for k, v in ms.items()}
    fake, real = feats[0::2], feats[1::2]
    real_all = FeatureStats(capture_mean_cov=True)
    for f in real:
        real_all.append(f)
    mu, cov = real_all.get_mean_cov()
    self_fvd = frechet_distance(mu, cov, mu, cov)
    clips_s = 128 / evaluate_s
    log(f"[fvd eval] eval CLI, flagship bf16 (--use_amp), batch 16, null128: {res}; "
        f"{evaluate_s:.2f} s = {clips_s:.2f} clips/s (model load and builds excluded), peak "
        f"{peak_gib:.2f} GiB; device ms per batch: reconstruction "
        f"{per_batch['reconstruction']:.2f}, LPIPS {per_batch['lpips']:.2f}, I3D (two passes) "
        f"{per_batch['i3d']:.2f}; launches {launches} (expect 192 wgmma flash, 8 vq_tc); "
        f"FVD(reals, reals) {self_fvd:.3e} vs 1e-6 * trace(C) = {1e-6 * np.trace(cov):.3e}")
    require(res["num_samples"] == 128 and len(fake) == len(real) == 8, f"eval CLI {res}")
    require(all(math.isfinite(res[k]) for k in ("mse", "psnr", "lpips", "fvd")), f"eval {res}")
    require(res["fvd"] > 0, f"reconstruction FVD {res['fvd']}")
    require(abs(self_fvd) <= 1e-6 * np.trace(cov), f"FVD of the reals to themselves {self_fvd}")
    require(launches == {"flash_sm90": 192, "flash": 192, "vq_tc": 8, "vq": 8},
            f"eval CLI launches {launches}")
    records["flash_attn_fwd"]["launches"] += launches["flash_sm90"]
    records["flash_attn_fwd"]["eval_cli_launches"] = launches["flash_sm90"]
    records["vq_argmax"]["launches"] += launches["vq_tc"]
    records["vq_argmax"]["eval_cli_launches"] = launches["vq_tc"]
    out["eval_cli"] = {"clips_per_s": clips_s, "seconds": evaluate_s, "peak_gib": peak_gib,
                       "device_ms_per_batch": per_batch, "fvd": res["fvd"], "mse": res["mse"],
                       "psnr": res["psnr"], "lpips": res["lpips"], "self_fvd": self_fvd,
                       "parity_rel": rel, "parity_cpu_s": secs["cpu"]}

    # (c) the merge CLI on two shards of (b)'s features
    shards = tmp / "fvd" / "shards"
    shards.mkdir(parents=True, exist_ok=True)
    for kind, rows in (("gen", fake), ("real", real)):
        for first in (0, 4):
            st = FeatureStats(capture_mean_cov=True)
            for f in rows[first:first + 4]:
                st.append(f)
            st.save(shards / f"{kind}_stats_{first}.pkl")
    real_stats = tmp / "fvd" / "real_stats.pkl"
    real_all.save(real_stats)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        merged = merge_main(["--feature_stats_dir", str(shards)])
    printed = buf.getvalue()
    log(f"[fvd merge] {printed.strip()!r} against (b)'s FVD {res['fvd']:.6f}")
    require(printed == f"num_gen: 128, num_real: 128\nFVD: {merged:.4f}\n", f"merge {printed!r}")
    require(abs(merged - res["fvd"]) <= 1e-6 * res["fvd"], f"merged {merged} vs {res['fvd']}")
    out["merge_fvd"] = merged

    # (d) the tokenizer trainer: eval rFVD each epoch, the best by FVD
    t0 = time.perf_counter()
    run_dir = tmp / "fvd" / "train"
    train_main(["--cfg", str(ROOT / "cfgs" / "larp_tokenizer.yaml"), "--csv_file", "null128",
                "-b", "8", "-j", "0", "--device", "cuda", "--manualSeed", str(SEED),
                "--out_path", str(run_dir), "--opts", "max_epoch", "2", "eval_epoch", "1",
                "vis_epoch", "99", "latest_interval", "1", "use_amp", "true", "force_fvd",
                "true", "save_best", "true", "test_dataset.csv_paths.ucf101_val", "null128"])
    train_s = time.perf_counter() - t0
    text = (run_dir / "larp_tokenizer" / "log.txt").read_text()
    rfvd = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines() if "eval rFVD:" in line]
    best = sorted(p.name for p in (run_dir / "larp_tokenizer").glob("best_fvd_*"))
    log(f"[fvd train] train.main, cfgs/larp_tokenizer.yaml bf16, batch 8, 2 epochs of null128 "
        f"with eval: {train_s:.1f} s; eval rFVD {rfvd}; best checkpoints {best}")
    require(len(rfvd) == 2 and all(math.isfinite(v) for v in rfvd), f"eval rFVD lines {rfvd}")
    require(not re.search(r"FVD.*failed|failed.*FVD", text), "a failed FVD line in the log")
    # the directory's name has the FVD to 2 decimals, the log line to 3: the
    # best is the lower epoch's within both roundings (0.005 + 0.0005)
    require(len(best) == 1 and abs(float(best[0][len("best_fvd_"):]) - min(rfvd)) <= 0.0055 + 1e-9,
            f"best checkpoints {best} for {rfvd}")
    out["train_rfvd"] = rfvd
    out["train_s"] = train_s
    torch.cuda.empty_cache()

    # (e) sample.py with FVD: one job at full width
    samples = tmp / "fvd" / "sampling" / "run"
    decode_attention.launches = decode_attention.launches_sm90 = 0
    decode_attention.launches_fused = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = sample_main(["--device", "cuda", "--dtype", "bfloat16", "--cfg_scale", "1.5",
                              "--top_k", "100", "--batch_size", "8", "--num_samples", "8",
                              "--csv_file", "null128", "--seed", str(SEED), "--output_dir",
                              str(samples)])
    sample_s = time.perf_counter() - t0
    dec = {"all": decode_attention.launches, "sm90": decode_attention.launches_sm90,
           "fused": decode_attention.launches_fused}
    with open(samples.parent / "fvd_report.csv") as f:
        rows = list(csv.reader(f))
    buf2 = io.StringIO()
    with contextlib.redirect_stdout(buf2):
        merged_e = merge_main(["--feature_stats_dir", str(samples)])
    files = sorted(p.name for p in samples.iterdir() if p.is_file())
    log(f"[fvd sample] sample.py --csv_file null128, bf16, CFG 1.5, top-k 100, batch 8, 8 "
        f"samples: {sample_s:.1f} s (the models' builds included); {buf.getvalue().strip()}; "
        f"files {files}; report {rows}; merge CLI {buf2.getvalue().strip()!r}; decode "
        f"attentions {dec} (expect 30690 each)")
    require({"gen_stats_0.pkl", "real_stats_0.pkl", "done_0.flag", "merged.flag"} <= set(files),
            f"sample.py files {files}")
    require(len(rows) == 2 and rows[1][7] == "8", f"fvd_report.csv {rows}")
    fvd_e = float(rows[1][-1])
    require(math.isfinite(fvd_e) and result["fvd"] is not None
            and abs(result["fvd"] - merged_e) <= 1e-9 * max(merged_e, 1.0)
            and rows[1][-1] == f"{merged_e:.4f}", f"sample FVD {result['fvd']} vs merge {merged_e}")
    require(dec == {"all": 30690, "sm90": 30690, "fused": 30690}, f"decode launches {dec}")
    records["decode_attention"]["launches"] += dec["sm90"]
    records["decode_attention"]["sample_fvd_launches"] = dec["sm90"]
    out["sample"] = {"fvd": result["fvd"], "seconds": sample_s,
                     "tokens_per_s": result["tokens_per_s"], "nll": result["nll"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[fvd] phase 20 in {out['seconds']:.1f} s")
    records["fvd"] = out
    return real_stats


# ---------------------------------------------------------------- phase 21

STAT_PARAMS, LARP_PARAMS = 185_850_633, {"sq": 176_778_648, "fsq": 172_035_078}


def phase_stat_lattice(tmp: Path, records: dict) -> None:
    """The STAT family and the LARP tokenizer's fsq and sq bottlenecks:
      (a) the VQ kernel at the Leech codebook's shape (`_leech_vq`);
      (b) the flagship LARP tokenizer with the sq and fsq bottlenecks at full
          width: fp32 card vs CPU at batch 1, bf16 reconstruction at batch 8
          (`_larp_fsq_sq`);
      (c) the STAT model of cfgs/larp_tokenizer_stat.yaml: fp32 card vs CPU,
          bf16 reconstruction, one fp32 training step card vs CPU at cut
          depth, bf16 training throughput, and three stages through
          `train.py` (`_stat_parity`, `_stat_train_parity`, `_stat_train`);
      (d) LARP-sq training through `train.py`: the frozen codebook stays
          bit for bit, in no optimizer (`_sq_train`)."""
    _leech_vq(records)
    _larp_fsq_sq(tmp, records)
    _stat_parity(tmp, records)
    _stat_train_parity(tmp, records)
    _stat_train(tmp, records)
    _sq_train(tmp, records)


def _leech_vq(records: dict) -> None:
    """Phase 21 (a): M = 8192 and 1024 unit rows against the 196,560
    normalised Leech minimal vectors (d = 24, cos) on `vq_tc_kernel`, held
    against `vq_lookup_reference` (indices equal but at score gaps under
    1e-5, counted); CUDA-graph times of the kernel, the plain version and
    `(z @ e.T).argmax` (TF32 off), both bounds; planted ties."""
    import torch

    from video_tokenizer_tpu_torch.models.fsq import leech_lattice_codebook
    from video_tokenizer_tpu_torch.ops.vq import vq_argmax, vq_kernel, vq_lookup_reference

    emb = torch.from_numpy(leech_lattice_codebook()).cuda()
    K, d = emb.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 140)
    row = {}
    for M in (8192, 1024):
        z = torch.randn(M, d, generator=gen, device="cuda")
        z = z / (z.norm(dim=-1, keepdim=True) + 1e-12)
        got = vq_argmax(z, emb)
        torch.cuda.synchronize()
        kernel = vq_argmax.last_kernel
        require(kernel == vq_kernel(d, False) == "vq_tc_kernel", f"vq leech: ran {kernel}")
        want = vq_lookup_reference(z, emb)
        diff = got != want
        n_diff = int(diff.sum().item())
        gap = _vq_gap(z[diff], emb, None, got[diff], want[diff]).max().item() if n_diff else 0.0
        require(gap < 1e-5, f"vq leech M={M}: an index differs at a score gap {gap}")
        ms = min(graph_ms(lambda: vq_argmax(z, emb), launches=10) for _ in range(2))
        plain_ms = graph_ms(lambda: vq_lookup_reference(z, emb), launches=2, replays=3)
        # timed here, used nowhere (TF32 off: an fp32 product)
        library_ms = graph_ms(lambda: (z @ emb.T).argmax(-1), launches=2, replays=3)
        flops = 2 * M * K * d
        bnd = bound(_nbytes(z, emb, got), flops, "tf32x3")
        fma = bound(_nbytes(z, emb, got), flops, "fp32")
        log(f"[vq leech] M={M} K={K} d={d} cos: {kernel} {n_diff} of {M} indices differ from "
            f"plain (largest score gap {gap:.2e}, tol 1e-5); {ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, three TF32 products; as fp32 FMAs "
            f"{fma['bound_ms']:.4f} ms), plain {plain_ms:.4f} ms, library call "
            f"((z @ e.T).argmax, fp32) {library_ms:.4f} ms (device time, CUDA-graph replay)")
        if M == 8192:
            row = {"max_abs_err": gap, "differ": n_diff, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "fma_bound_ms": fma["bound_ms"], **bnd}
        else:
            row.update(m1024_ms=ms, m1024_plain_ms=plain_ms, m1024_library_ms=library_ms,
                       m1024_bound_ms=bnd["bound_ms"], m1024_differ=n_diff)
    # planted exact ties: copies of a code within a thread's four, in other
    # tiles of a split and in other splits of the cluster (24,576 codes each)
    dup = emb.clone()
    plants = {100: (101, 103, 700, 30_000, 100_000), 50_000: (50_001, 170_000), K - 2: (K - 1,)}
    for lo, dups in plants.items():
        dup[list(dups)] = dup[lo].clone()
    rows = torch.tensor(list(plants) * 16, device="cuda")
    got = vq_argmax(dup[rows].contiguous(), dup)
    torch.cuda.synchronize()
    wrong = int((got != rows.to(torch.int32)).sum().item())
    log(f"[vq leech ties] codes 100, 50,000 and {K - 2} duplicated (within a thread's four, "
        f"across tiles and across the cluster's splits): {wrong} of {len(rows)} rows miss the "
        "lowest index")
    require(wrong == 0, f"vq leech ties: {got.tolist()}")
    records["vq_argmax_leech"] = row


def _rel_max(a, b) -> float:
    return (a.float().cpu() - b.float().cpu()).abs().max().item() / b.float().abs().max().item()


def _reconstruction_rate(tag: str, model, n_flash: int, n_vq: int) -> dict:
    """bf16 reconstruction at batch 8 through `reconstruct`: median of 5
    batches after a warm-up, exact launch counts (every flash forward on the
    wgmma kernel, every VQ on vq_tc_kernel), peak memory, device time by
    kernel category over 3 profiled batches."""
    import numpy as np
    import torch

    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
    from video_tokenizer_tpu_torch.ops.vq import vq_argmax
    from video_tokenizer_tpu_torch.reconstruct import make_clips, reconstruct

    B, iters = 8, 5
    clips = torch.from_numpy(make_clips(np.random.default_rng(SEED), B, 16, 128)).cuda()
    reconstruct(model, clips)  # warm-up
    torch.cuda.synchronize()
    gc.collect()  # an earlier trainer in a reference cycle still holds its tensors
    torch.cuda.reset_peak_memory_stats()
    flash_attn_fwd.launches = flash_attn_fwd.launches_sm90 = 0
    vq_argmax.launches = vq_argmax.launches_tc = 0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        rec = reconstruct(model, clips)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n = {"flash": flash_attn_fwd.launches, "wgmma": flash_attn_fwd.launches_sm90,
         "vq": vq_argmax.launches, "vq_tc": vq_argmax.launches_tc}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    wall_ms, per_cat, n_events, _ = _profile_and_load(lambda: reconstruct(model, clips), 3)
    busy_ms = sum(per_cat.values()) / 1e3
    clips_per_s = B / statistics.median(times)
    mse = torch.mean((rec - clips) ** 2).item()
    want = {"flash": n_flash * iters, "wgmma": n_flash * iters, "vq": n_vq * iters,
            "vq_tc": n_vq * iters}
    log(f"[{tag}] bf16 batch {B}: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median "
        f"{statistics.median(times) * 1e3:.2f} ms = {clips_per_s:.2f} clips/s; peak memory "
        f"{peak_gb:.2f} GiB; mse {mse:.5f}; launches {n} (expect {want}); profiled 3 batches: "
        f"wall {wall_ms / 3:.1f} ms, device busy {busy_ms / 3:.1f} ms, idle "
        f"{1 - busy_ms / wall_ms:.1%}, {n_events / 3:.0f} kernels per batch; device ms per "
        f"batch by category: " + ", ".join(
            f"{c} {us / 1e3 / 3:.2f} ({us / 1e3 / busy_ms:.1%})"
            for c, us in sorted(per_cat.items(), key=lambda kv: -kv[1])))
    require(tuple(rec.shape) == (B, 3, 16, 128, 128) and torch.isfinite(rec).all().item(),
            f"{tag}: reconstruction")
    require(n == want, f"{tag}: launches {n}, expected {want}")
    return {"clips_per_s": clips_per_s, "peak_gib": peak_gb, "idle": 1 - busy_ms / wall_ms,
            "device_ms_per_batch": {c: us / 1e3 / 3 for c, us in per_cat.items()},
            "launches": n}


def _larp_fsq_sq(tmp: Path, records: dict) -> None:
    """Phase 21 (b): cfgs/larp_tokenizer.yaml with `bottleneck_type` sq and
    fsq, seeded and perturbed (the frozen Leech codebook left as it is): fp32
    card vs CPU at batch 1 at full width and 4 of the 12 + 12 layers (the
    run's budget; deep random stacks only amplify rounding, phase 19 (a))
    (indices >= 99% equal, decode_from_bottleneck of the CPU's indices
    within 1e-3 of the scale, one VQ launch per encode on the sq path), then
    bf16 reconstruction at batch 8 of the whole depth from the same fp32
    weights (`_reconstruction_rate`, 24 flash forwards a batch, one VQ search
    on the sq path)."""
    import torch

    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
    from video_tokenizer_tpu_torch.ops.vq import vq_argmax
    from video_tokenizer_tpu_torch.registry import models

    x = torch.rand(1, 3, 16, 128, 128, generator=torch.Generator().manual_seed(SEED + 150))
    for i, kind in enumerate(("sq", "fsq")):
        spec = _load_cfg("larp_tokenizer", tmp, 1)["model"]
        spec["args"]["bottleneck_type"] = kind
        gen = lambda: torch.Generator().manual_seed(SEED + 151 + i)  # noqa: E731
        model = models.make(spec, args={"dtype": torch.float32, "generator": gen()})
        _perturb(model, SEED + 153 + i)
        model.eval()
        n_params = sum(p.numel() for p in model.parameters())
        require(n_params == LARP_PARAMS[kind], f"larp {kind}: {n_params} parameters")
        state = {k: v.clone() for k, v in model.state_dict().items()}  # the whole depth
        _cut_depth(model, PARITY_DEPTH)
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = model(x)
            ref_dec = model.decode_from_bottleneck(ref["bottleneck_rep"])
        cpu_s = time.perf_counter() - t0
        model.cuda()
        flash_attn_fwd.launches = vq_argmax.launches = 0
        with torch.inference_mode():
            got = model(x.cuda())
            n_flash, n_vq = flash_attn_fwd.launches, vq_argmax.launches
            dec = model.decode_from_bottleneck(ref["bottleneck_rep"].cuda())
        torch.cuda.synchronize()
        agree = (got["bottleneck_rep"].cpu() == ref["bottleneck_rep"]).float().mean().item()
        dec_err = _rel_max(dec, ref_dec)
        extra = ""
        if kind == "sq":
            extra = (f"; loss_q {got['loss_q'].item():.6g}/{ref['loss_q'].item():.6g}, codebook "
                     f"entropy {got['codebook_entropy'].item():.6g}/"
                     f"{ref['codebook_entropy'].item():.6g} (card/CPU)")
        log(f"[larp {kind}] cfgs/larp_tokenizer.yaml with bottleneck_type {kind}: "
            f"{n_params:,} params, codebook {model.codebook_size:,}; fp32 batch 1, TF32 off, "
            f"{PARITY_DEPTH} + {PARITY_DEPTH} of the 12 + 12 layers: CPU "
            f"plain path {cpu_s:.1f} s; indices agree {agree:.4%} (tol >= 99%); "
            f"decode_from_bottleneck(CPU indices) max|card-cpu| {dec_err:.3e} of the scale (tol "
            f"1e-3); pred_frames {_rel_max(got['pred_frames'], ref['pred_frames']):.3e}; "
            f"launches per forward: flash {n_flash}, VQ {n_vq}{extra}")
        require(agree >= 0.99 and dec_err <= 1e-3, f"larp {kind}: {agree}, {dec_err}")
        require(n_flash == 2 * PARITY_DEPTH and n_vq == (kind == "sq"),
                f"larp {kind}: {n_flash}, {n_vq}")
        del model, got, ref
        bf16 = models.make(spec, args={"dtype": torch.bfloat16, "generator": gen()})
        bf16.load_state_dict(state)
        del state
        run = _reconstruction_rate(f"larp {kind}", bf16.cuda().eval(), 24, int(kind == "sq"))
        records[f"larp_{kind}"] = {"params": n_params, "index_agree": agree,
                                   "dec_err_rel": dec_err, **run}
        if kind == "sq":  # the main path of the d = 24 search: one launch per encode
            records["vq_argmax_leech"]["launches"] = run["launches"]["vq"]
        del bf16
        torch.cuda.empty_cache()


def _stat_model(tmp: Path, dtype, seed: int):
    """cfgs/larp_tokenizer_stat.yaml's `autoencoder_stat` at full width, from
    the yaml as the trainer builds it, seeded, on the host."""
    import torch

    from video_tokenizer_tpu_torch.registry import models

    cfg = _load_cfg("larp_tokenizer_stat", tmp, 1)
    return models.make(cfg["model"], args={"dtype": dtype,
                                           "generator": torch.Generator().manual_seed(seed)})


def _centre_keep_head(model, x) -> None:
    """Sets the keep head's output bias to minus the median logit of x's
    latents, so that about half of them are kept at probs > 0.5 (random
    weights would put all of them on one side)."""
    import torch

    with torch.no_grad():
        probs = model.encoder(x)[1].double()
        model.encoder.prob_head.fc2.bias.fill_(-torch.logit(probs).median().item())


def _stat_parity(tmp: Path, records: dict) -> None:
    """Phase 21 (c), first half: the STAT model, 185,850,633 parameters,
    perturbed; fp32 eval ('adaptive': probs > 0.5) card vs CPU at batch 1 at
    full width and 4 of the 12 + 12 layers (the run's budget), the keep head
    centred on that model: FSQ indices >= 99%, keep masks, the encoder's and
    the decoder's first and last blocks on the CPU's own inputs within 1e-5,
    decode_from_bottleneck of the CPU's indices within 1e-3 of the scale or
    5x the CPU's own change under a 1e-6 nudge of the decoder's proj_in
    (phase 19's yardstick), 8 flash forwards on the 3xTF32 kernel; then bf16
    reconstruction at batch 8 of the whole depth (24 wgmma flash forwards a
    batch)."""
    import torch

    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd

    model = _stat_model(tmp, torch.float32, SEED + 160)
    _perturb(model, SEED + 161)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == STAT_PARAMS, f"stat: {n_params} parameters")
    x = torch.rand(1, 3, 16, 128, 128, generator=torch.Generator().manual_seed(SEED + 162))
    state = {k: v.clone() for k, v in model.state_dict().items()}  # the whole depth
    _cut_depth(model, PARITY_DEPTH)
    _centre_keep_head(model, x)
    head = "encoder.prob_head.fc2.bias"
    state[head] = model.state_dict()[head].clone()
    probes, hooks = {}, []
    for stack in ("encoder", "decoder"):
        blocks = getattr(model, stack).blocks
        for n in ("attn_0", "ffd_0", f"attn_{blocks.depth - 1}", f"ffd_{blocks.depth - 1}"):
            hooks.append(getattr(blocks, n).register_forward_hook(
                lambda m, i, o, k=f"{stack}.{n}": probes.__setitem__(k, (m, i, o))))
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = model(x)
        for h in hooks:
            h.remove()
        ref_dec = model.decode_from_bottleneck(ref["bottleneck_rep"])
        w = model.decoder.proj_in.weight
        kept = w.clone()
        w.mul_(1 + 1e-6)
        nudged = model.decode_from_bottleneck(ref["bottleneck_rep"])
        w.copy_(kept)
    cpu_s = time.perf_counter() - t0
    yardstick = _rel_max(nudged, ref_dec)
    model.cuda()
    flash_attn_fwd.launches = flash_attn_fwd.launches_tf32x3 = 0
    with torch.inference_mode():
        got = model(x.cuda())
        n_fwd, n_tf32x3 = flash_attn_fwd.launches, flash_attn_fwd.launches_tf32x3
        dec = model.decode_from_bottleneck(ref["bottleneck_rep"].cuda())
        block_errs = {k: _rel_max(m(*(a.cuda() for a in i)), o) for k, (m, i, o) in probes.items()}
    torch.cuda.synchronize()
    agree = (got["bottleneck_rep"].cpu() == ref["bottleneck_rep"]).float().mean().item()
    mask_agree = (got["token_mask"].cpu() == ref["token_mask"]).float().mean().item()
    kept_frac = ref["token_mask"].mean().item()
    rec_err = _rel_max(dec, ref_dec)
    rec_tol = max(1e-3, 5 * yardstick)
    log(f"[stat fp32] cfgs/larp_tokenizer_stat.yaml: autoencoder_stat {n_params:,} params, patch "
        f"{model.encoder.patch_size}, {model.num_latent_tokens} latents, FSQ-{model.codebook_size}"
        f", batch 1, TF32 off, {PARITY_DEPTH} + {PARITY_DEPTH} of the 12 + 12 layers: "
        f"CPU plain path {cpu_s:.1f} s; kept (probs > 0.5) {kept_frac:.1%}, "
        f"keep masks agree {mask_agree:.4%}; FSQ indices agree {agree:.4%} (tol >= 99%); "
        f"decode_from_bottleneck(CPU indices) {rec_err:.3e} of the scale (tol {rec_tol:.3e}: the "
        f"CPU's own change under proj_in x (1 + 1e-6) {yardstick:.3e}); blocks on the CPU's "
        "inputs " + ", ".join(f"{k} {e:.2e}" for k, e in block_errs.items())
        + f" (tol 1e-5); probs max|card-cpu| {_rel_max(got['probs'], ref['probs']):.2e} of "
        f"the scale; flash launches {n_fwd}, 3xTF32 {n_tf32x3} (expect {2 * PARITY_DEPTH})")
    require(tuple(got["pred_frames"].shape) == (1, 3, 16, 128, 128), "stat: shape")
    require(torch.isfinite(got["pred_frames"]).all().item(), "stat: non-finite output")
    require(0.0 < kept_frac < 1.0, f"stat: kept fraction {kept_frac}")
    require(agree >= 0.99 and mask_agree >= 0.99, f"stat: agreement {agree}, masks {mask_agree}")
    require(rec_err <= rec_tol, f"stat: reconstruction error {rec_err} > {rec_tol}")
    require(all(e <= 1e-5 for e in block_errs.values()), f"stat: blocks differ {block_errs}")
    require(n_fwd == n_tf32x3 == 2 * PARITY_DEPTH, f"stat: flash launches {n_fwd}/{n_tf32x3}")
    del model, got, probes
    torch.cuda.empty_cache()
    bf16 = _stat_model(tmp, torch.bfloat16, SEED)
    bf16.load_state_dict(state)
    run = _reconstruction_rate("stat", bf16.cuda().eval(), 24, 0)
    records["stat"] = {"params": n_params, "cpu_s": cpu_s, "index_agree": agree,
                       "rec_err_rel": rec_err, "yardstick": yardstick,
                       "block_err_rel": max(block_errs.values()), "kept": kept_frac, **run}
    del bf16
    torch.cuda.empty_cache()


def _stat_train_parity(tmp: Path, records: dict) -> None:
    """Phase 21 (c): one fp32 step ('adaptive': Bernoulli masks, the STAT
    losses) of cfgs/larp_tokenizer_stat.yaml through the STAT trainer at
    batch 1, card vs CPU from the same weights and generators, at full width
    and 4 + 4 of the 12 + 12 layers (`PARITY_DEPTH`): losses 2e-4, FSQ
    indices >= 99.9%, gradients 1e-3."""
    import numpy as np
    import torch

    cfg = _load_cfg("larp_tokenizer_stat", tmp, 1)
    cfg["loss"]["args"]["d_update_freq"] = 1
    pair = {d: _trainer({**cfg, "save_dir": str(tmp / f"stat_fp32_{d}")}, d)
            for d in ("cpu", "cuda")}
    cpu, gpu = pair["cpu"], pair["cuda"]
    for tr in (cpu, gpu):
        _cut_depth(tr.model, PARITY_DEPTH)
        tr.opt_g.param_groups[0]["params"] = [p for p in tr.model.parameters() if p.requires_grad]
    _perturb(cpu.model, SEED + 170)
    _perturb(cpu.disc, SEED + 171)
    clip = np.random.default_rng(SEED + 172).integers(0, 256, (1, 3, 16, 128, 128), dtype=np.uint8)
    _centre_keep_head(cpu.model, torch.from_numpy(clip).float() / 255.0)
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.loss_mod.load_state_dict(cpu.loss_mod.state_dict())
    require(gpu._stage == cpu._stage == "adaptive", f"stat train: stage {cpu._stage}")
    reps, infos, secs = {}, {}, {}
    for device, tr in pair.items():
        hook = tr.model.quantize.register_forward_hook(
            lambda m, i, o, d=device: reps.__setitem__(d, o[1]["indices"].cpu()))
        t0 = time.perf_counter()
        keys, packed = tr.train_step({"gt": torch.from_numpy(clip)})
        infos[device] = dict(zip(keys, packed.tolist()))
        secs[device] = time.perf_counter() - t0
        hook.remove()
    agree = (reps["cuda"] == reps["cpu"]).float().mean().item()
    loss_keys = ("loss", "rec_loss", "perceptual_loss", "g_loss", "d_loss", "logits_real",
                 "logits_fake", "loss_content", "loss_decrease", "loss_sparse", "diversity_loss",
                 "stat_target_sparsity")
    loss_err = max(abs(infos["cuda"][k] - infos["cpu"][k]) / max(abs(infos["cpu"][k]), 1e-6)
                   for k in loss_keys)
    tokens = (infos["cuda"]["avg_tokens"], infos["cpu"]["avg_tokens"])
    log(f"[stat train fp32] autoencoder_stat {sum(p.numel() for p in cpu.model.parameters()):,} + "
        f"discriminator {sum(p.numel() for p in cpu.disc.parameters()):,} + LPIPS params, batch 1, "
        f"{PARITY_DEPTH} + {PARITY_DEPTH} of the 12 + 12 layers, TF32 off, "
        f"stage {cpu._stage}: CPU step {secs['cpu']:.1f} s, "
        f"card step {secs['cuda']:.2f} s; FSQ indices agree on {agree:.4%} (tol >= 99.9%); "
        f"avg_tokens {tokens[0]:g}/{tokens[1]:g}; losses "
        + ", ".join(f"{k} {infos['cuda'][k]:.6g}/{infos['cpu'][k]:.6g}" for k in loss_keys)
        + f" (card/CPU; largest relative difference {loss_err:.2e}, tol 2e-4)")
    require(set(infos["cuda"]) == set(infos["cpu"]), "stat train fp32: info keys differ")
    require(all(np.isfinite(v) for v in infos["cuda"].values()), "stat train: non-finite")
    require(agree >= 0.999, f"stat train fp32: FSQ agreement {agree}")
    require(loss_err <= 2e-4, f"stat train fp32: losses differ by {loss_err}")
    require(abs(tokens[0] - tokens[1]) <= 2, f"stat train fp32: avg_tokens {tokens}")
    worst = 0.0
    for tag, gm, cm, names in (
            ("model", gpu.model, cpu.model, ("encoder.proj_in.weight", "encoder.mask_token",
                                             "encoder.blocks.attn_2.to_qkv.weight",
                                             "encoder.prob_head.fc1.weight",
                                             "encoder.prob_head.fc2.weight",
                                             "encoder.proj_out.weight",
                                             "decoder.blocks.ffd_3.proj_in.weight",
                                             "decoder.proj_out.weight")),
            ("disc", gpu.disc, cpu.disc, ("transformer_encoder.blocks.3.attn.qkv.weight",
                                          "x_embedder.proj.weight"))):
        gp, cp = dict(gm.named_parameters()), dict(cm.named_parameters())
        for pname in names:
            g, c = gp[pname].grad, cp[pname].grad
            require(g is not None and c is not None, f"stat train: no gradient for {pname}")
            rel = _rel_max(g, c)
            log(f"[stat train fp32] grad {tag} {pname}: max|card-cpu|/max|cpu| {rel:.2e} "
                f"(max|g| {c.abs().max().item():.3e}; tol 1e-3)")
            require(math.isfinite(rel), f"stat train fp32: gradient of {pname} not finite")
            worst = max(worst, rel)
    require(worst <= 1e-3, f"stat train fp32: gradients differ by {worst} of their scale")
    records["stat"].update(train_parity_loss_rel=loss_err, train_parity_grad_rel=worst,
                           train_parity_cpu_s=secs["cpu"])
    del pair, cpu, gpu
    torch.cuda.empty_cache()


def _epoch_lines(log_text: str) -> dict:
    """{epoch: (training seconds, train line)} of a trainer's log."""
    out = {}
    for line in log_text.splitlines():
        if m := re.search(r"Epoch (\d+) training done\. Time: ([\d.]+)s", line):
            out.setdefault(int(m.group(1)), [None, ""])[0] = float(m.group(2))
        elif m := re.search(r"Epoch (\d+), train:", line):
            out.setdefault(int(m.group(1)), [None, ""])[1] = line
    return out


def _cli_counts(run):
    """Launch counts of the flash and VQ kernels over `run()`, from 0."""
    from video_tokenizer_tpu_torch.ops.attention import (
        flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
    )
    from video_tokenizer_tpu_torch.ops.vq import vq_argmax

    kernels = (flash_attn_fwd, flash_attn_bwd_dq, flash_attn_bwd_dkv, vq_argmax)
    for k in kernels:
        k.launches = 0
    for k in kernels[:3]:
        k.launches_sm90 = 0
    vq_argmax.launches_tc = 0
    result = run()
    counts = {k.__name__: k.launches for k in kernels}
    counts.update({f"{k.__name__}_sm90": k.launches_sm90 for k in kernels[:3]},
                  vq_argmax_tc=vq_argmax.launches_tc)
    return result, counts


def _want_counts(steps: int, first_step: int, d_freq: int, vq: int) -> dict:
    """A tokenizer step's launches (48 flash forwards, 32 dQ and dK/dV, 16
    more on a discriminator step, `vq` VQ searches), all on the wgmma and
    vq_tc kernels, over `steps` steps from step `first_step`."""
    d_steps = sum((first_step + i + 1) % d_freq == 0 for i in range(steps))
    want = {"flash_attn_fwd": 48 * steps, "flash_attn_bwd_dq": 32 * steps + 16 * d_steps,
            "flash_attn_bwd_dkv": 32 * steps + 16 * d_steps, "vq_argmax": vq * steps}
    want.update({f"{k}_sm90": want[k] for k in list(want)[:3]}, vq_argmax_tc=vq * steps)
    return want


def _stat_train(tmp: Path, records: dict) -> None:
    """Phase 21 (c), training: bf16 at batch 8 through the STAT trainer
    (`_train_throughput`, the config's 'adaptive' stage: per step 48 flash
    forwards, 32 dQ + 32 dK/dV, 48 + 48 on a discriminator step, no VQ),
    then `train.py` on cfgs/larp_tokenizer_stat.yaml over three epochs of
    null128 (16 steps each), `vanilla_until_epoch 2`, `random_drop_until_epoch
    3` (the trainers count epochs from 1): the three stage lines, s/step by
    stage, exact launch counts over the 48 steps."""
    import torch

    from video_tokenizer_tpu_torch.train import main as train_main

    cfg = _load_cfg("larp_tokenizer_stat", tmp / "stat_bf16", 8)
    cfg["use_amp"] = True
    run = _train_throughput("stat train bf16", cfg, (48, 32, 16), 0)
    records["train_stat_bf16"] = {k: v for k, v in run.items() if k != "tf32x3"}
    out = tmp / "stat_cli"
    t0 = time.perf_counter()
    tr, counts = _cli_counts(lambda: train_main([
        "--cfg", str(ROOT / "cfgs" / "larp_tokenizer_stat.yaml"), "--csv_file", "null128", "-b",
        "8", "-j", "0", "--device", "cuda", "--manualSeed", str(SEED), "--out_path", str(out),
        "--opts", "max_epoch", "3", "eval_epoch", "99", "vis_epoch", "99", "use_amp", "true",
        "model.args.vanilla_until_epoch", "2", "model.args.random_drop_until_epoch", "3"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, d_freq = tr.step, tr.loss_mod.d_update_freq
    del tr
    torch.cuda.empty_cache()
    text = (out / "larp_tokenizer_stat" / "log.txt").read_text()
    stages = re.findall(r"STAT stage -> (\w+)", text)
    epochs = _epoch_lines(text)
    per_step = {e: t / 16 for e, (t, _) in epochs.items()}
    want = _want_counts(48, 0, d_freq, 0)
    tokens = [float(m) for m in re.findall(r"avg_tokens=([\d.]+)", epochs.get(3, [0, ""])[1])]
    log(f"[stat cli] train.py on cfgs/larp_tokenizer_stat.yaml, bf16, batch 8, 3 epochs of "
        f"null128 ({steps} steps) in {wall:.1f} s: stage lines {stages}; s/step by epoch "
        + ", ".join(f"{e} ({s}) {per_step[e]:.3f}" for e, s in zip(sorted(per_step), stages))
        + f"; epoch 3 avg_tokens {tokens}; launches {counts} (expect {want})")
    require(stages == ["vanilla", "random_drop", "adaptive"], f"stat cli: stages {stages}")
    require(steps == 48 and counts == want, f"stat cli: {steps} steps, launches {counts}")
    require(len(tokens) == 1 and "avg_tokens" not in epochs[1][1], "stat cli: STAT losses")
    records["train_stat_bf16"].update(cli_s=wall, cli_s_per_step=per_step, stages=stages)


def _sq_train(tmp: Path, records: dict) -> None:
    """Phase 21 (d): `train.py --opts model.args.bottleneck_type sq`, bf16,
    batch 8, one epoch of null128 (16 steps): exact launch counts (one d = 24
    VQ search a step), the Leech codebook bit for bit unchanged and held by
    no optimizer group or state."""
    import torch

    from video_tokenizer_tpu_torch.models.fsq import leech_lattice_codebook
    from video_tokenizer_tpu_torch.train import main as train_main

    out = tmp / "sq_cli"
    t0 = time.perf_counter()
    tr, counts = _cli_counts(lambda: train_main([
        "--cfg", str(ROOT / "cfgs" / "larp_tokenizer.yaml"), "--csv_file", "null128", "-b", "8",
        "-j", "0", "--device", "cuda", "--manualSeed", str(SEED), "--out_path", str(out),
        "--opts", "max_epoch", "1", "eval_epoch", "99", "vis_epoch", "99", "use_amp", "true",
        "model.args.bottleneck_type", "sq"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emb = tr.model.sq_quantizer.embedding
    same = torch.equal(emb.detach().cpu(), torch.from_numpy(leech_lattice_codebook()))
    held = {id(p) for g in tr.opt_g.param_groups for p in g["params"]}
    in_opt = id(emb) in held or emb in tr.opt_g.state
    steps, d_freq = tr.step, tr.loss_mod.d_update_freq
    text = (out / "larp_tokenizer" / "log.txt").read_text()
    epoch = _epoch_lines(text)[1]
    loss_q = [float(m) for m in re.findall(r" loss_q=([\d.]+)", epoch[1])]
    want = _want_counts(steps, 0, d_freq, 1)
    log(f"[sq cli] train.py --opts model.args.bottleneck_type sq, bf16, batch 8, {steps} steps "
        f"in {wall:.1f} s ({epoch[0] / steps:.3f} s/step in the epoch); codebook unchanged bit "
        f"for bit: {same}; in opt_g: {in_opt}; loss_q {loss_q}; launches {counts} (expect {want})")
    require(same and not in_opt, "sq cli: the frozen codebook moved or is optimised")
    require(steps == 16 and counts == want, f"sq cli: {steps} steps, launches {counts}")
    require(len(loss_q) == 1 and math.isfinite(loss_q[0]), f"sq cli: loss_q {loss_q}")
    records["train_sq_bf16"] = {"s_per_step": epoch[0] / steps, "cli_s": wall}
    del tr
    torch.cuda.empty_cache()


# the LARP recipe's flags (scripts/train_larp_tokenizer.sh), its data paths aside
RECIPE_OPTS = [
    "model.args.bottleneck_token_num", "1024", "model.args.encoder_hidden_size", "768",
    "model.args.decoder_hidden_size", "768", "model.args.encoder_depth", "12",
    "model.args.decoder_depth", "12", "model.args.encoder_num_heads", "12",
    "model.args.decoder_num_heads", "12", "model.args.bottleneck.args.regularizer.name", "vq",
    "model.args.prior_model.name", "gptc-S", "loss.args.disc_tran_hidden_size", "512",
    "loss.args.disc_tran_n_heads", "8", "loss.args.disc_tran_n_layers", "12",
    "optimizer.args.lr", "0.0001", "optimizer.loss_args.lr", "0.00003",
    "optimizer.warmup_epoch", "8", "optimizer.min_lr_mult", "0.01",
    "optimizer.prior_lr_mult", "50.0", "optimizer.lr_type", "cosine", "use_amp", "true",
    "vis_epoch", "1", "eval_epoch", "1", "max_epoch", "150", "latest_interval", "1",
    "save_best", "true",
]


def _recipe_argv(out: Path, batch: int, seed: int, *opts: str) -> list:
    """train.py's arguments for the LARP recipe on null128 clips (16 x 128 x
    128, no loader workers), then `opts` (a later key wins)."""
    return ["--cfg", str(ROOT / "cfgs" / "larp_tokenizer.yaml"), "--manualSeed", str(seed),
            "--csv_file", "null128", "--out_path", str(out), "--name", "larp_tokenizer",
            "-b", str(batch), "-j", "0", "--frame_num", "16", "--input_size", "128",
            "--opts", "test_dataset.csv_paths.ucf101_val", "null128", *RECIPE_OPTS, *opts]


def _recipe_cfg(out: Path, batch: int, *opts: str) -> dict:
    """The recipe's config as train.py builds it, one epoch, seeded."""
    from video_tokenizer_tpu_torch.train import make_cfg, parse_args

    return make_cfg(parse_args(_recipe_argv(out, batch, SEED, "max_epoch", "1", *opts))).to_dict()


def _group_drift(a, b, step: int) -> dict:
    """{group: share of its weights in trainer `a` more than 0.01 of the
    group's learning rate at `step` away from trainer `b`'s}. Adam's first
    update is about +-lr wherever |g| >> eps, so a weight whose gradient is
    within rounding of 0 may flip; a wrong learning rate moves a whole group."""
    pb = dict(b.model.named_parameters())
    names = {id(p): n for n, p in a.model.named_parameters()}
    out = {}
    for g in a.opt_g.param_groups:
        lr = a.g_sched(step) * g["lr_mult"]
        off = sum(((p.detach().cpu() - pb[names[id(p)]].detach().cpu()).abs() > 0.01 * lr)
                  .sum().item() for p in g["params"])
        out[g["name"]] = off / sum(p.numel() for p in g["params"])
    return out


def phase_prior(tmp: Path, records: dict) -> None:
    """Phase 22: LARP's learned AR prior (gptc-S, 12 layers of 384, 6 heads of
    64) co-trained as scripts/train_larp_tokenizer.sh trains it, fp32 inside
    the bf16 tokenizer, at 50x the learning rate:
      (a) gptc-S in fp32 (TF32 off), perturbed: `compute_prior_loss` from
          8 x 1024 latents and every gradient (its input's too), card against
          CPU at 4 of its 12 layers (the run's budget); exactly 4 3xTF32
          forwards, 4 dQ and 4 dK/dV; the whole model's forward and forward +
          backward timed on the card; `decode_step` (6 rows, then 10 single
          steps) against the card's own full forward;
      (b) the recipe's attention shapes are phases 2 and 10's cases
          `fp32_gptc_prior` (B = 8, S = 1023, H = 6, D = 64, causal, fp32) and
          `disc512` (B = 8, S = 1025, H = 8, D = 64, bf16); their times are
          copied here;
      (c) one fp32 step of the recipe through the trainer at batch 1, card
          against CPU, the tokenizer at 2 + 2 of its 12 + 12 layers, gptc-S
          and the 512 / 8 / 12 discriminator at 4 of their 12 layers
          (`PARITY_DEPTH`), `prior_lr_mult` 50 and
          `emb_lr_mult` 2 (three learning-rate groups): losses, VQ indices,
          named gradients, the parameters after the step per group; then a
          `grad_accum_steps` 2 step at batch 8 (deterministic VQ, the
          discriminator gated off) against the plain step on the card;
      (d) bf16 training of the recipe at full width, batch 8, five steps
          (one with a discriminator step): s/step, peak memory, idle share,
          device time by category and the prior's share, exact launch counts
          (60 wgmma forwards, 36 wgmma dQ and dK/dV, 24 more on the
          discriminator step; 12 + 12 + 12 3xTF32 launches for the prior; 1 VQ);
      (e) `train.py` with the script's flags (and `optimizer.emb_lr_mult 2`,
          so that the emb group exists) on null128 for one epoch (16 steps,
          eval and vis), resumed from its `epoch-last` (the three groups, the
          step, the Adam state equal), its `epoch-final` through
          `reconstruct` and as the AR trainer's frozen tokenizer."""
    rec = records["prior"] = {}
    _prior_parity(rec)
    for key, name in (("fwd", "flash_attn_fwd_tf32x3"), ("dq", "flash_attn_bwd_dq_tf32x3"),
                      ("dkv", "flash_attn_bwd_dkv_tf32x3")):
        r = records[name]
        prefix = "fp32_gptc_prior" if key == "fwd" else "gptc_prior"
        rec[f"flash_{key}"] = {k[len(prefix) + 1:]: v for k, v in r.items() if k.startswith(prefix)}
    for key, name in (("fwd", "flash_attn_fwd"), ("dq", "flash_attn_bwd_dq"),
                      ("dkv", "flash_attn_bwd_dkv")):
        rec[f"disc512_{key}"] = {k[len("disc512_"):]: v for k, v in records[name].items()
                                 if k.startswith("disc512_")}
    _recipe_step_parity(tmp, rec)
    _recipe_accum(tmp, rec)
    _recipe_throughput(tmp, rec)
    _recipe_cli(tmp, rec)


def _prior_parity(rec: dict) -> None:
    import numpy as np
    import torch

    import video_tokenizer_tpu_torch.models  # noqa: F401  (registers gptc-S)
    from video_tokenizer_tpu_torch.ops.attention import (
        flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
    )
    from video_tokenizer_tpu_torch.registry import models

    args = {"n_ind": 8, "max_seq_len": 1024, "embd_pdrop": 0.0, "resid_pdrop": 0.0}
    pair = {d: models.make({"name": "gptc-S", "args": args},
                           args={"generator": torch.Generator().manual_seed(SEED + 220)})
            for d in ("cpu", "cuda")}
    _perturb(pair["cpu"], SEED + 221)
    pair["cuda"].load_state_dict(pair["cpu"].state_dict())
    pair["cuda"].cuda()
    # card vs CPU at PARITY_DEPTH of the 12 layers; the timings and
    # decode_step below take the card's whole model back
    n_params = sum(p.numel() for p in pair["cpu"].parameters())
    _cut_depth(pair["cpu"], PARITY_DEPTH)
    whole = _cut_depth(pair["cuda"], PARITY_DEPTH)
    x = torch.from_numpy(np.random.default_rng(SEED + 222).standard_normal((8, 1024, 8))
                         .astype(np.float32))
    kernels = (flash_attn_fwd, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    loss, xs, secs = {}, {}, {}
    for d, m in pair.items():
        xs[d] = x.to(d, copy=True).requires_grad_()
        for k in kernels:
            k.launches = k.launches_tf32x3 = 0
        t0 = time.perf_counter()
        loss[d] = m.compute_prior_loss(xs[d], train=True)
        loss[d].backward()
        if d == "cuda":
            torch.cuda.synchronize()
        secs[d] = time.perf_counter() - t0
    counts = {k.__name__: (k.launches, k.launches_tf32x3) for k in kernels}
    loss_rel = abs(loss["cuda"].item() - loss["cpu"].item()) / abs(loss["cpu"].item())
    gp, cp = dict(pair["cuda"].named_parameters()), dict(pair["cpu"].named_parameters())
    top = max(c.grad.abs().max().item() for c in cp.values())
    worst, worst_name, key_bias = 0.0, "", 0.0
    for name, c in cp.items():
        g = gp[name].grad
        require(g is not None and c.grad is not None, f"prior: no gradient for {name}")
        if name.endswith("key.bias"):  # 0 in exact arithmetic: softmax is shift invariant
            key_bias = max(key_bias, (g.cpu() - c.grad).abs().max().item() / top)
            continue
        rel = _rel_max(g, c.grad)
        if rel > worst:
            worst, worst_name = rel, name
    x_rel = _rel_max(xs["cuda"].grad, xs["cpu"].grad)
    log(f"[prior fp32] gptc-S {n_params:,} params, compute_prior_loss at B = 8 from 1024 "
        f"latents, TF32 off, {PARITY_DEPTH} of its 12 layers: CPU {secs['cpu']:.1f} s, "
        f"card {secs['cuda']:.2f} s (first call); "
        f"loss {loss['cuda'].item():.6g}/{loss['cpu'].item():.6g} (card/CPU, relative "
        f"{loss_rel:.2e}, tol 2e-4); gradients max|card-cpu|/max|cpu| {worst:.2e} ({worst_name}), "
        f"input {x_rel:.2e}, key biases {key_bias:.2e} of the largest gradient (tol 1e-3); "
        f"launches (all, 3xTF32) {counts} (expect {PARITY_DEPTH} each, all 3xTF32)")
    require(n_params == 21_694_088, f"prior: gptc-S has {n_params} parameters")
    require(math.isfinite(loss["cuda"].item()) and loss_rel <= 2e-4, f"prior: loss {loss_rel}")
    require(max(worst, x_rel, key_bias) <= 1e-3, f"prior: gradients {worst}, {x_rel}, {key_bias}")
    want = (PARITY_DEPTH, PARITY_DEPTH)
    require(all(v == want for v in counts.values()), f"prior: launches {counts}")

    m, xg = pair["cuda"], xs["cuda"].detach()
    whole()
    m.zero_grad(set_to_none=True)
    fwd_ms = median_ms(lambda: m.compute_prior_loss(xg), iters=5)
    xr = xg.clone().requires_grad_()

    def fwd_bwd():
        m.compute_prior_loss(xr, train=True).backward()

    step_ms = median_ms(fwd_bwd, iters=5)
    gemm_flops = 2 * 8 * 1023 * sum(p.numel() for n, p in m.named_parameters()
                                    if n.endswith("weight") and p.ndim == 2)
    log(f"[prior fp32] card: forward (compute_prior_loss) {fwd_ms:.2f} ms, forward + backward "
        f"{step_ms:.2f} ms (CUDA events, median of 5); its GEMMs {gemm_flops * 3 / 1e12:.3f} "
        f"TFLOP forward + backward, {gemm_flops * 3 / step_ms / 1e9:.1f} TFLOP/s over the whole")

    # decode_step: 6 rows, then 10 single steps, against the card's own forward
    with torch.no_grad():
        x16 = xg[:, :16]
        full, _ = m(x16)
        cache = m.init_cache(8, 16)
        worst_dec = 0.0
        for a, b in [(0, 6)] + [(t, t + 1) for t in range(6, 16)]:
            pred, cache = m.decode_step(x16[:, a:b], a, cache)
            worst_dec = max(worst_dec, _rel_max(pred, full[:, a:b]))
    log(f"[prior fp32] decode_step (6 rows, then 10 steps; plain fp32 attention over the cache) "
        f"against the full forward (3xTF32 flash): max|diff|/max|full| {worst_dec:.2e} (tol 1e-4)")
    require(worst_dec <= 1e-4, f"prior: decode_step differs by {worst_dec}")
    rec.update(params=n_params, parity_loss_rel=loss_rel, parity_grad_rel=worst,
               parity_input_grad_rel=x_rel, parity_cpu_s=secs["cpu"], fwd_ms=fwd_ms,
               fwd_bwd_ms=step_ms, gemm_tflop_fwd_bwd=gemm_flops * 3 / 1e12,
               decode_rel=worst_dec)
    del pair, m, xs, xg, xr
    torch.cuda.empty_cache()


def _recipe_step_parity(tmp: Path, rec: dict) -> None:
    import numpy as np
    import torch

    cfg = _recipe_cfg(tmp / "recipe_parity", 1, "use_amp", "false", "model.args.encoder_depth",
                      "2", "model.args.decoder_depth", "2", "loss.args.d_update_freq", "1",
                      "optimizer.emb_lr_mult", "2.0", "loss.args.disc_tran_n_layers",
                      str(PARITY_DEPTH))
    pair = {d: _trainer({**cfg, "save_dir": str(tmp / f"recipe_{d}")}, d) for d in ("cpu", "cuda")}
    cpu, gpu = pair["cpu"], pair["cuda"]
    for tr in (cpu, gpu):  # gptc-S at PARITY_DEPTH of its 12 layers
        _cut_depth(tr.model.prior, PARITY_DEPTH)
        group = next(g for g in tr.opt_g.param_groups if g["name"] == "prior")
        group["params"] = list(tr.model.prior.parameters())
    groups = [(g["name"], g["lr_mult"]) for g in cpu.opt_g.param_groups]
    require(groups == [("base", 1.0), ("prior", 50.0), ("emb", 2.0)], f"recipe groups {groups}")
    _perturb(cpu.model, SEED + 230)
    _perturb(cpu.disc, SEED + 231)
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.loss_mod.load_state_dict(cpu.loss_mod.state_dict())
    clip = np.random.default_rng(SEED + 232).integers(0, 256, (1, 3, 16, 128, 128), dtype=np.uint8)
    reps, infos, secs = {}, {}, {}
    for device, tr in pair.items():
        hook = tr.model.bottleneck.register_forward_hook(
            lambda m, i, o, d=device: reps.__setitem__(d, o["bottleneck_rep"].cpu()))
        t0 = time.perf_counter()
        keys, packed = tr.train_step({"gt": torch.from_numpy(clip)})
        infos[device] = dict(zip(keys, packed.tolist()))
        secs[device] = time.perf_counter() - t0
        hook.remove()
    agree = (reps["cuda"] == reps["cpu"]).float().mean().item()
    loss_keys = ("loss", "rec_loss", "perceptual_loss", "g_loss", "d_loss", "loss_q",
                 "loss_latent_ce", "logits_real", "logits_fake")
    loss_err = max(abs(infos["cuda"][k] - infos["cpu"][k]) / max(abs(infos["cpu"][k]), 1e-6)
                   for k in loss_keys)
    log(f"[recipe fp32] tokenizer at 2 + 2 layers {sum(p.numel() for p in cpu.model.parameters()):,}"
        f" params (the prior at {PARITY_DEPTH} of its 12 layers "
        f"{sum(p.numel() for p in cpu.model.prior.parameters()):,}) + discriminator 512/8 at "
        f"{PARITY_DEPTH} of its 12 layers {sum(p.numel() for p in cpu.disc.parameters()):,} + LPIPS, "
        f"batch 1, TF32 off, groups {groups}: CPU step {secs['cpu']:.1f} s, card step "
        f"{secs['cuda']:.2f} s; VQ indices agree on {agree:.4%} (tol >= 99.9%); losses "
        + ", ".join(f"{k} {infos['cuda'][k]:.6g}/{infos['cpu'][k]:.6g}" for k in loss_keys)
        + f" (card/CPU; largest relative difference {loss_err:.2e}, tol 2e-4)")
    require(set(infos["cuda"]) == set(infos["cpu"]), "recipe fp32: info keys differ")
    require(all(np.isfinite(v) for v in infos["cuda"].values()), "recipe fp32: non-finite info")
    require(agree >= 0.999, f"recipe fp32: VQ agreement {agree}")
    require(loss_err <= 2e-4, f"recipe fp32: losses differ by {loss_err}")
    worst = 0.0
    for tag, gm, cm, names in (
            ("model", gpu.model, cpu.model, (
                "x_embedder.proj.weight", "encoder.blocks.0.attn.qkv.weight",
                "encoder.blocks.1.mlp.fc2.weight", "encoder_latent_query_embed",
                "bottleneck.in_linear.weight", "prior.input_proj.weight", "prior.pos_emb",
                "prior.blocks.0.query.weight", "prior.blocks.3.mlp_proj.weight",
                "prior.head.weight", "decoder.blocks.1.mlp.fc2.weight",
                "final_layer.linear.weight")),
            ("disc", gpu.disc, cpu.disc, ("transformer_encoder.blocks.3.attn.qkv.weight",
                                          "x_embedder.proj.weight"))):
        gp, cp = dict(gm.named_parameters()), dict(cm.named_parameters())
        for pname in names:
            g, c = gp[pname].grad, cp[pname].grad
            require(g is not None and c is not None, f"recipe fp32: no gradient for {pname}")
            rel = _rel_max(g, c)
            log(f"[recipe fp32] grad {tag} {pname}: max|card-cpu|/max|cpu| {rel:.2e} "
                f"(max|g| {c.abs().max().item():.3e}; tol 1e-3)")
            require(math.isfinite(rel), f"recipe fp32: gradient of {pname} not finite")
            worst = max(worst, rel)
    require(worst <= 1e-3, f"recipe fp32: gradients differ by {worst} of their scale")
    drift = _group_drift(gpu, cpu, 0)
    log(f"[recipe fp32] parameters after the step, card against CPU: share of each group's "
        f"weights more than 0.01 of its learning rate apart {drift} (tol 1e-3)")
    require(all(v <= 1e-3 for v in drift.values()), f"recipe fp32: parameters drift {drift}")
    rec.update(step_parity_loss_rel=loss_err, step_parity_grad_rel=worst,
               step_parity_drift=drift, step_parity_cpu_s=secs["cpu"])
    del pair, cpu, gpu
    torch.cuda.empty_cache()


def _recipe_accum(tmp: Path, rec: dict) -> None:
    """`grad_accum_steps` 2 at batch 8 against the plain step at batch 8 on
    the card: fp32, 2 + 2 tokenizer layers, deterministic VQ (a stochastic
    one draws one seed per microbatch), the discriminator gated off (the
    first step of a d_update_freq 5 cycle)."""
    import numpy as np
    import torch

    opts = ("use_amp", "false", "model.args.encoder_depth", "2", "model.args.decoder_depth", "2",
            "model.args.bottleneck.args.regularizer.args.stochastic", "false",
            "optimizer.emb_lr_mult", "2.0")
    plain = _trainer(_recipe_cfg(tmp / "recipe_plain", 8, *opts), "cuda")
    accum = _trainer(_recipe_cfg(tmp / "recipe_accum", 8, *opts, "grad_accum_steps", "2"), "cuda")
    require(accum.grad_accum == 2 and plain.loss_mod.d_update_freq == 5, "recipe accum: config")
    _perturb(plain.model, SEED + 240)
    _perturb(plain.disc, SEED + 241)
    accum.model.load_state_dict(plain.model.state_dict())
    accum.loss_mod.load_state_dict(plain.loss_mod.state_dict())
    disc0 = {n: p.detach().clone() for n, p in plain.disc.named_parameters()}
    clip = np.random.default_rng(SEED + 242).integers(0, 256, (8, 3, 16, 128, 128), dtype=np.uint8)
    infos = {}
    for tag, tr in (("plain", plain), ("accum", accum)):
        keys, packed = tr.train_step({"gt": torch.from_numpy(clip)})
        infos[tag] = dict(zip(keys, packed.tolist()))
    torch.cuda.synchronize()
    loss_keys = ("loss", "loss_latent_ce", "loss_q", "rec_loss", "perceptual_loss", "g_loss")
    loss_err = max(abs(infos["accum"][k] - infos["plain"][k]) / abs(infos["plain"][k])
                   for k in loss_keys)
    drift = _group_drift(accum, plain, 0)
    d_moved = [n for tr in (plain, accum) for n, p in tr.disc.named_parameters()
               if not torch.equal(p, disc0[n])]
    log(f"[recipe accum] grad_accum_steps 2 at batch 8 against the plain step at batch 8 (fp32, "
        f"2 + 2 tokenizer layers, deterministic VQ, discriminator gated off): losses "
        + ", ".join(f"{k} {infos['accum'][k]:.6g}/{infos['plain'][k]:.6g}" for k in loss_keys)
        + f" (largest relative difference {loss_err:.2e}, tol 1e-4); share of each group's "
        f"weights more than 0.01 of its learning rate apart {drift} (tol 1e-3); discriminator "
        f"tensors moved: {len(d_moved)} (expect 0)")
    require(loss_err <= 1e-4, f"recipe accum: losses differ by {loss_err}")
    require(all(v <= 1e-3 for v in drift.values()), f"recipe accum: parameters drift {drift}")
    require(not d_moved, f"recipe accum: the gated-off discriminator moved: {d_moved[:3]}")
    rec.update(accum_loss_rel=loss_err, accum_drift=drift)
    del plain, accum
    torch.cuda.empty_cache()


def _recipe_throughput(tmp: Path, rec: dict) -> None:
    by_name: dict = {}
    run = _train_throughput("recipe bf16", _recipe_cfg(tmp / "recipe_bf16", 8), (60, 36, 24), 1,
                            fp32_flash=(12, 12), by_name=by_name)
    timed = 5
    busy = run["busy_ms_per_step"]
    prior_flash = sum(us for n, us in by_name.items() if "tf32x3" in n) / 1e3 / timed
    # the GEMMs with fp32 operands (cuBLAS's `..._f32f32_f32f32_f32_...` and
    # sgemm kernels): the prior's and the bottleneck's two small projections;
    # the tokenizer and the discriminator compute in bf16
    fp32_gemm = {n: us / 1e3 / timed for n, us in by_name.items()
                 if _category(n) == "gemm" and re.search(r"f32f32|sgemm", n.lower())}
    top = sorted(fp32_gemm.items(), key=lambda kv: -kv[1])[:6]
    prior_share = rec["fwd_bwd_ms"] / busy
    log(f"[recipe bf16] device busy {busy:.1f} ms a step; the prior's 3xTF32 flash kernels "
        f"{prior_flash:.2f} ms a step ({prior_flash / busy:.1%}); GEMMs with fp32 operands "
        f"{sum(fp32_gemm.values()):.2f} ms a step ({sum(fp32_gemm.values()) / busy:.1%}), the "
        f"largest: " + "; ".join(f"{n[:90]} {ms:.2f} ms" for n, ms in top)
        + f"; the prior's forward + backward alone (phase 22 (a), fp32, B = 8) "
        f"{rec['fwd_bwd_ms']:.2f} ms = {prior_share:.1%} of the busy step")
    rec["train_bf16"] = {k: run[k] for k in ("s_per_step", "clips_per_s", "peak_gib", "idle",
                                             "loader_s", "busy_ms_per_step",
                                             "device_ms_per_step", "launches", "tf32x3",
                                             "sm90")}
    rec["train_bf16"].update(prior_flash_ms=prior_flash, fp32_gemm_ms=sum(fp32_gemm.values()),
                             prior_share=prior_share)


def _recipe_cli(tmp: Path, rec: dict) -> None:
    import numpy as np
    import torch

    from video_tokenizer_tpu_torch.reconstruct import reconstruct
    from video_tokenizer_tpu_torch.registry import trainers
    from video_tokenizer_tpu_torch.train import main as train_main
    from video_tokenizer_tpu_torch.utils.model_io import load_tokenizer_checkpoint

    out = tmp / "recipe_cli"
    t0 = time.perf_counter()
    tr1 = train_main(["--device", "cuda", "--tag", "single_host",
                      *_recipe_argv(out, 8, 66667, "max_epoch", "1", "optimizer.emb_lr_mult",
                                    "2.0")])
    cli_s = time.perf_counter() - t0
    run = Path(tr1.save_dir)
    log_text = (run / "log.txt").read_text()
    groups = [(g["name"], g["lr_mult"], len(g["params"])) for g in tr1.opt_g.param_groups]
    lines = [line.split("] ", 1)[-1] for line in log_text.splitlines()]
    log(f"[recipe cli] train.py with the script's flags on null128, batch 8, one epoch: "
        f"{cli_s:.1f} s, {tr1.step} steps, groups {groups}; " + " | ".join(
            line[:160] for line in lines if line.startswith(("Epoch 1 training", "eval ")))
        + "; train " + ", ".join(
            kv for line in lines if line.startswith("Epoch 1,") for kv in line.split(" ")
            if kv.startswith(("loss=", "loss_latent_ce=", "psnr=")))[:120])
    require(tr1.step == 16, f"recipe cli: {tr1.step} steps")
    require([g[:2] for g in groups] == [("base", 1.0), ("prior", 50.0), ("emb", 2.0)],
            f"recipe cli: groups {groups}")
    require("nan" not in log_text.lower(), "recipe cli: NaN in the log")
    require((run / "vis" / "epoch_1.png").exists(), "recipe cli: no vis grid")
    require(np.isfinite(float((run / "results.csv").read_text().splitlines()[1].split(",")[2])),
            "recipe cli: train loss not finite")

    # resume from epoch-last: the groups, the step and Adam's state
    tr2 = trainers.make({"name": tr1.cfg["trainer"]}, args={"cfg": tr1.cfg, "device": "cuda"})
    tr2.make_datasets()
    tr2.make_model()
    require(tr2.try_resume(), "recipe cli: no epoch-last to resume from")
    same = tr2.step == tr1.step and len(tr2.opt_g.param_groups) == len(tr1.opt_g.param_groups)
    for g1, g2 in zip(tr1.opt_g.param_groups, tr2.opt_g.param_groups):
        same &= (g1["name"], g1["lr_mult"]) == (g2["name"], g2["lr_mult"])
        for p1, p2 in zip(g1["params"], g2["params"]):
            s1, s2 = tr1.opt_g.state[p1], tr2.opt_g.state[p2]
            same &= torch.equal(p1, p2) and all(torch.equal(s1[k], s2[k])
                                               for k in ("exp_avg", "exp_avg_sq", "step"))
    keys, packed = tr2.train_step(next(tr2.train_loader(2)))
    log(f"[recipe cli] resumed from epoch-last: step {tr2.step - 1}, groups, parameters and "
        f"Adam state equal to the run's: {same}; the next step's loss "
        f"{dict(zip(keys, packed.tolist()))['loss']:.4f}")
    require(same, "recipe cli: the resumed state differs from the run's")
    require(torch.isfinite(packed).all().item(), "recipe cli: the resumed step is not finite")
    del tr1, tr2
    torch.cuda.empty_cache()

    # epoch-final: reconstruct, and the AR trainer's frozen tokenizer
    final = run / "epoch-final"
    model = load_tokenizer_checkpoint(str(final), dtype=torch.bfloat16, device="cuda")
    clips = torch.from_numpy(np.random.default_rng(SEED + 250).random(
        (2, 3, 16, 128, 128), dtype=np.float32)).cuda()
    recon = reconstruct(model, clips)
    require(model.prior is not None and recon.shape == clips.shape
            and torch.isfinite(recon).all().item(), "recipe cli: epoch-final does not reconstruct")
    del model
    cfg = _ar_cfg(tmp / "recipe_ar", "larp_ar", final, 2)
    cfg["model"] = {"name": "larp_ar", "args": {**cfg["model"]["args"], "n_layer": 2,
                                                "n_head": 20, "dim": 1280}}
    ar = _trainer(cfg, "cuda")
    keys, packed = ar.train_step(next(ar.train_loader(1)))
    log(f"[recipe cli] epoch-final reconstructs (bf16, 2 clips, max {recon.max().item():.3f}) and "
        f"feeds the AR trainer as its frozen tokenizer (prior loaded: "
        f"{ar.vae.prior is not None}; a 2-layer AR step's loss "
        f"{dict(zip(keys, packed.tolist()))['loss']:.4f})")
    require(ar.vae.prior is not None and torch.isfinite(packed).all().item(),
            "recipe cli: the AR trainer's step on epoch-final")
    rec["cli"] = {"seconds": cli_s, "steps": 16}
    del ar
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 23


BASIC_NAMES = ("autoencoder", "autoencoder_dualpatch", "autoencoder_first_token",
               "autoencoder_first_token_res", "autoencoder_design")
BASIC_FLASH = {"autoencoder": 10, "autoencoder_dualpatch": 10, "autoencoder_first_token": 15,
               "autoencoder_first_token_res": 15, "autoencoder_design": 15}
FLASH_NAMES = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel",
               "vq_tc_kernel")


def phase_trainer_basic(tmp: Path, records: dict) -> None:
    """The trainer's own behaviour, `spectral_norm` and R1, and the
    model_basic family:
      (a) the flagship trainer of cfgs/larp_tokenizer.yaml (bf16, batch 8, 4
          steps an epoch, 2 epochs, the discriminator on, seeded null128
          clips) through `run()`: run A whole with `profile_steps: 2` and
          the TensorBoard writer, run A' whole (the spread of two runs), run
          B cut by a SIGTERM in epoch 2, run C resuming B (`_preempt_resume`);
      (b) the flagship's discriminator with `spectral_norm`, R1 and both:
          fp32 card vs CPU, then a bf16 trainer step each (`_r1_spectral`);
      (c) the five model_basic registrations (`_model_basic`)."""
    rec = records["trainer_basic"] = {}
    _preempt_resume(tmp, rec)
    _r1_spectral(tmp, rec, records)
    _model_basic(tmp, rec)


def _basic_run(cfg: dict, sigterm_at=None) -> dict:
    """`run()` of the port's tokenizer trainer from `cfg` with 4 steps an
    epoch; `sigterm_at` (epoch, i) sends this process a SIGTERM as the loader
    is about to yield batch i of that epoch. Returns the trainer, the CRC of
    every batch that reached `train_step`, and the SystemExit code (None when
    run() returned)."""
    import os
    import signal
    import zlib

    import torch

    import video_tokenizer_tpu_torch.data  # noqa: F401
    import video_tokenizer_tpu_torch.trainers  # noqa: F401
    from video_tokenizer_tpu_torch.registry import trainers

    tr = trainers.make({"name": cfg["trainer"]}, args={"cfg": cfg, "device": "cuda"})
    tr.steps_per_epoch = lambda: 4
    loader, step, applied = tr.train_loader, tr.train_step, []

    def signalling_loader(epoch):
        for i, batch in enumerate(loader(epoch)):
            if (epoch, i) == sigterm_at:
                require(signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None),
                        "preempt: the trainer's SIGTERM handler is not installed")
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    def counted_step(batch):
        applied.append(zlib.crc32(batch["gt"].numpy().tobytes()))
        return step(batch)

    tr.train_loader, tr.train_step = signalling_loader, counted_step
    code = None
    t0 = time.perf_counter()
    try:
        tr.run()
    except SystemExit as e:
        code = e.code
    torch.cuda.synchronize()
    return {"trainer": tr, "applied": applied, "exit": code, "s": time.perf_counter() - t0}


def _state_gap(a, b) -> float:
    """max over the tensors of two trainers' generator and discriminator of
    max|a - b| / max|b|."""
    worst = 0.0
    for ma, mb in ((a.model, b.model), (a.disc, b.disc)):
        for (n, x), y in zip(ma.state_dict().items(), mb.state_dict().values()):
            if x.is_floating_point():
                scale = y.float().abs().max().item()
                worst = max(worst, (x.float() - y.float()).abs().max().item() / max(scale, 1e-30))
    return worst


def _adam_steps(tr) -> list:
    return [[int(s["step"]) for s in opt.state_dict()["state"].values()]
            for opt in (tr.opt_g, tr.opt_d)]


def _preempt_resume(tmp: Path, rec: dict) -> None:
    """Phase 23 (a). Gates: B leaves through SystemExit(0) with `epoch-last`
    holding epoch 1, resume_skip_steps 2 and preempted; C skips those 2 and
    applies the rest, B's and C's batches together are A's in A's order
    (CRCs of the clips), Adam's step counts equal A's, C's parameters are
    within the spread of A and A' (bit for bit when A and A' are); A's trace
    holds exactly 2 steps with the wgmma flash forward, dQ, dK/dV and VQ
    kernels by name; the writer wrote `train/` scalars, or the log says it
    is unavailable."""
    import json

    import torch

    from video_tokenizer_tpu_torch.utils import checkpoint as ckpt_lib

    def cfg(name, **over):
        c = _train_cfg(tmp / name, 8, True, max_epoch=2, **over)
        # seeded clips: the fake train split draws fresh entropy per clip,
        # which no two runs could share
        c["train_dataset"]["args"]["split"] = "val"
        return c

    a = _basic_run(cfg("pre_a", profile_steps=2, enable_tb=True))
    a2 = _basic_run(cfg("pre_a2", enable_tb=False))
    b = _basic_run(cfg("pre_b", enable_tb=False), sigterm_at=(2, 1))
    last = tmp / "pre_b" / "epoch-last"
    state = ckpt_lib.restore_checkpoint(str(last))
    meta = json.loads((last / "meta.json").read_text())
    position = {k: (state.get(k), meta.get(k))
                for k in ("epoch", "global_step", "resume_skip_steps", "preempted")}
    c = _basic_run(cfg("pre_b", enable_tb=False))
    del state
    spread, gap = _state_gap(a2["trainer"], a["trainer"]), _state_gap(c["trainer"], a["trainer"])
    steps = {k: _adam_steps(r["trainer"]) for k, r in (("A", a), ("C", c))}
    trace = json.loads((tmp / "pre_a" / "profile" / "trace.json").read_text())["traceEvents"]
    annotated = sorted(e["name"] for e in trace if e.get("cat") == "user_annotation"
                       and str(e.get("name", "")).startswith("train_step#"))
    kernels = {k: sum(k in str(e.get("name", "")) for e in trace if e.get("cat") == "kernel")
               for k in FLASH_NAMES}
    tb_dir = tmp / "pre_a" / "tensorboard"
    if a["trainer"].writer is not None:
        events = b"".join(p.read_bytes() for p in tb_dir.glob("events.out.tfevents.*"))
        writer = ("wrote " + ", ".join(t for t in ("train/loss", "train/d_loss", "train/psnr")
                                       if t.encode() in events))
        wrote = b"train/loss" in events
    else:
        text = (tmp / "pre_a" / "log.txt").read_text()
        wrote = "TensorBoard writer unavailable" in text
        writer = "unavailable, as the log says: " + next(
            (l for l in text.splitlines() if "TensorBoard writer unavailable" in l), "")
    log(f"[preempt] flagship bf16 batch 8, 4 steps an epoch, 2 epochs: run A {a['s']:.1f} s "
        f"(profiled), A' {a2['s']:.1f} s, B {b['s']:.1f} s (SIGTERM before epoch 2's batch 1: "
        f"SystemExit({b['exit']}), {len(b['applied'])} batches applied), C {c['s']:.1f} s "
        f"(resumed, {len(c['applied'])} applied); epoch-last position (state.pth, meta.json) "
        f"{position}; batches B + C == A: {b['applied'] + c['applied'] == a['applied']}, A == A': "
        f"{a['applied'] == a2['applied']}; Adam steps (G, D) A {sorted(set(steps['A'][0]))}, "
        f"{sorted(set(steps['A'][1]))}, C equal: {steps['A'] == steps['C']}; parameters: "
        f"max|C - A|/max|A| {gap:.3e}, spread of two whole runs max|A' - A|/max|A| {spread:.3e} "
        "(gate: C == A bit for bit when A' == A, else within 2x the spread)")
    log(f"[preempt] A's trace ({len(trace)} events): profiled steps {annotated}; kernels by name "
        f"{kernels}; TensorBoard writer: {writer}")
    require(b["exit"] == 0, f"preempt: run B left with {b['exit']}")
    want = {"epoch": (1, 1), "global_step": (6, 6), "resume_skip_steps": (2, 2),
            "preempted": (True, True)}
    require(position == want, f"preempt: position {position}")
    require(len(a["applied"]) == 8 and len(c["applied"]) == 2, "preempt: batch counts")
    require(b["applied"] + c["applied"] == a["applied"] == a2["applied"], "preempt: data order")
    require(steps["A"] == steps["C"] and max(steps["A"][0]) == 8, f"preempt: Adam steps {steps}")
    require(gap == 0.0 if spread == 0.0 else gap <= 2 * spread,
            f"preempt: C is {gap} from A, the spread of two runs {spread}")
    require(annotated == ["train_step#2", "train_step#3"], f"preempt: profiled {annotated}")
    require(all(kernels.values()), f"preempt: kernels in the trace {kernels}")
    require(wrote, f"preempt: writer {writer}")
    rec["preempt"] = {"gap_rel": gap, "spread_rel": spread,
                      "run_s": {"A": a["s"], "A2": a2["s"], "B": b["s"], "C": c["s"]},
                      "trace_kernels": kernels, "writer": writer}
    del a, a2, b, c, trace
    torch.cuda.empty_cache()


R1_OPTIONS = {"spectral_norm": {"spectral_norm": True}, "r1": {"r1_gp_weight": 0.01},
              "both": {"spectral_norm": True, "r1_gp_weight": 0.01}}


def _r1_spectral(tmp: Path, rec: dict, records: dict) -> None:
    """Phase 23 (b). The discriminator of cfgs/larp_tokenizer.yaml (384 wide,
    12 heads, 8 layers, temporal patch 4, patch 8: S = 1025), seeded and
    perturbed, fp32 (TF32 off) at batch 2, card against CPU with each option:
    the D loss, `r1_gp` and every discriminator gradient within 1e-3 of
    their scale, 16 3xTF32 flash forwards, dQ and dK/dV without R1 and none
    with it. Then bf16 trainer steps at batch 8 with each option alone
    (`_train_throughput`): s/step beside phase 12's plain step, exact launch
    counts: 48 forwards, 32 dQ and dK/dV, 16 more on a discriminator step
    without R1; 24, 24 and 0 with it (the tokenizer's 24 forwards and 24
    backward passes unchanged)."""
    import numpy as np
    import torch

    from video_tokenizer_tpu_torch.ops.attention import (
        flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
    )
    from video_tokenizer_tpu_torch.registry import models

    kernels = (flash_attn_fwd, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    loss_spec = _load_cfg("larp_tokenizer", tmp, 2)["loss"]
    rng = np.random.default_rng(SEED + 230)
    x = torch.from_numpy(rng.random((2, 3, 16, 128, 128), dtype=np.float32))
    y = torch.from_numpy(rng.random((2, 3, 16, 128, 128), dtype=np.float32))
    for i, (name, option) in enumerate(R1_OPTIONS.items()):
        args = {**dict(loss_spec["args"]), **option, "dtype": torch.float32,
                "generator": torch.Generator().manual_seed(SEED + 231)}
        pair = {d: models.make({"name": loss_spec["name"], "args": args}) for d in ("cpu", "cuda")}
        _perturb(pair["cpu"].discriminator, SEED + 232 + i)
        pair["cuda"].load_state_dict(pair["cpu"].state_dict())
        pair["cuda"].cuda()
        out, secs = {}, {}
        for d, m in pair.items():
            for k in kernels:
                k.launches = k.launches_tf32x3 = 0
            t0 = time.perf_counter()
            loss, info = m.discriminator_loss(x.to(d), y.to(d), 1, train=True)
            loss.backward()
            if d == "cuda":
                torch.cuda.synchronize()
            secs[d] = time.perf_counter() - t0
            out[d] = (loss.item(), float(info.get("r1_gp", 0.0)))
        counts = {k.__name__: (k.launches, k.launches_tf32x3) for k in kernels}
        loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        r1_rel = abs(out["cuda"][1] - out["cpu"][1]) / max(abs(out["cpu"][1]), 1e-30)
        gp = dict(pair["cuda"].discriminator.named_parameters())
        worst, worst_name = 0.0, ""
        for pname, c in pair["cpu"].discriminator.named_parameters():
            require(c.grad is not None and gp[pname].grad is not None,
                    f"{name}: no gradient for {pname}")
            rel = _rel_max(gp[pname].grad, c.grad)
            if not rel <= worst:
                worst, worst_name = rel, pname
        n = 0 if "r1_gp_weight" in option else 16
        log(f"[disc {name}] the 384 / 12 / 8 discriminator (S = 1025) with {option}, fp32 batch 2, "
            f"TF32 off: CPU {secs['cpu']:.1f} s, card {secs['cuda']:.2f} s (first call); D loss "
            f"{out['cuda'][0]:.6g}/{out['cpu'][0]:.6g} (card/CPU, relative {loss_rel:.2e}), r1_gp "
            f"{out['cuda'][1]:.6g}/{out['cpu'][1]:.6g} ({r1_rel:.2e}); gradients max|card-cpu|/"
            f"max|cpu| {worst:.2e} ({worst_name}) (tol 1e-3 each); flash launches (all, 3xTF32) "
            f"{counts} (expect {n} each)")
        require(loss_rel <= 1e-3 and r1_rel <= 1e-3, f"{name}: losses {loss_rel}, {r1_rel}")
        require(("r1_gp_weight" in option) == (out["cpu"][1] > 0), f"{name}: r1_gp {out}")
        require(worst <= 1e-3, f"{name}: gradients differ by {worst} ({worst_name})")
        require(all(v == (n, n) for v in counts.values()), f"{name}: launches {counts}")
        rec[f"disc_{name}"] = {"loss_rel": loss_rel, "r1_rel": r1_rel, "grad_rel": worst,
                               "cpu_s": secs["cpu"]}
        del pair
    torch.cuda.empty_cache()
    plain = records["train_bf16"]["s_per_step"]
    for name in ("spectral_norm", "r1"):
        option = R1_OPTIONS[name]
        cfg = _train_cfg(tmp / f"train_{name}", 8, True)
        cfg["loss"]["args"].update(option)
        flash = (24, 24, 0) if "r1_gp_weight" in option else (48, 32, 16)
        run = _train_throughput(f"train bf16 {name}", cfg, flash, 1)
        log(f"[train bf16 {name}] {run['s_per_step']:.3f} s/step beside the plain step's "
            f"{plain:.3f} (phase 12, this run): x{run['s_per_step'] / plain:.2f}")
        rec[f"train_{name}"] = {k: run[k] for k in ("s_per_step", "clips_per_s", "peak_gib",
                                                    "idle", "launches", "busy_ms_per_step")}


def _model_basic(tmp: Path, rec: dict) -> None:
    """Phase 23 (c). Each of the five registrations at its full default
    width (small_thin: 768 wide, 5 + 5 layers, 12 heads of 64; FSQ), seeded
    and perturbed, fp32 (TF32 off) at batch 1, card against CPU: FSQ indices
    (and the first frame's) >= 99% equal, decode_from_bottleneck of the CPU's
    indices within 1e-3 of the scale or 5x the CPU's own change under a 1e-6
    nudge of the decoder's proj_in (phase 19's rule), exact 3xTF32 flash
    launches (10 a forward, 15 with the first-frame encoder); bf16
    reconstruction at batch 8 of `autoencoder` and `autoencoder_dualpatch`
    (`_reconstruction_rate`: 10 wgmma forwards a batch); one bf16 training
    run of `autoencoder` through the tokenizer trainer with
    cfgs/larp_tokenizer_large.yaml's loss and optimizer, the model swapped in
    memory (`_train_throughput`: 34 forwards, 18 dQ and dK/dV a step, 16
    more on a discriminator step)."""
    import torch

    from video_tokenizer_tpu_torch.ops.attention import flash_attn_fwd
    from video_tokenizer_tpu_torch.registry import models

    x = torch.rand(1, 3, 16, 128, 128, generator=torch.Generator().manual_seed(SEED + 240))
    weights = {}
    for i, name in enumerate(BASIC_NAMES):
        model = models.make({"name": name}, args={
            "dtype": torch.float32, "generator": torch.Generator().manual_seed(SEED + 241 + i)})
        _perturb(model, SEED + 250 + i)
        model.eval()
        n_params = sum(p.numel() for p in model.parameters())
        if name in ("autoencoder", "autoencoder_dualpatch"):
            weights[name] = {k: v.clone() for k, v in model.state_dict().items()}
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = model(x)
            ref_dec = model.decode_from_bottleneck(*_fsq_indices(ref))
            w = model.decoder.proj_in.weight
            kept = w.clone()
            w.mul_(1 + 1e-6)
            nudged = model.decode_from_bottleneck(*_fsq_indices(ref))
            w.copy_(kept)
        cpu_s = time.perf_counter() - t0
        yardstick = _rel_max(nudged, ref_dec)
        model.cuda()
        flash_attn_fwd.launches = flash_attn_fwd.launches_tf32x3 = 0
        with torch.inference_mode():
            got = model(x.cuda())
            n_fwd, n_tf32x3 = flash_attn_fwd.launches, flash_attn_fwd.launches_tf32x3
            dec = model.decode_from_bottleneck(*(i.cuda() for i in _fsq_indices(ref)))
        torch.cuda.synchronize()
        agree = [(g.cpu() == r).float().mean().item()
                 for g, r in zip(_fsq_indices(got), _fsq_indices(ref))]
        rec_err, rec_tol = _rel_max(dec, ref_dec), max(1e-3, 5 * yardstick)
        log(f"[model_basic fp32] {name} ({model.arch}, {n_params:,} params, "
            f"{model.num_latent_tokens} latents, FSQ-{model.codebook_size}), batch 1, TF32 off: "
            f"CPU plain path {cpu_s:.1f} s; FSQ indices agree "
            f"{', '.join(f'{a:.4%}' for a in agree)} (tol >= 99%); decode_from_bottleneck(CPU "
            f"indices) {rec_err:.3e} of the scale (tol {rec_tol:.3e}: the CPU's own change under "
            f"proj_in x (1 + 1e-6) {yardstick:.3e}); pred_frames "
            f"{_rel_max(got['pred_frames'], ref['pred_frames']):.3e}; flash launches {n_fwd}, "
            f"3xTF32 {n_tf32x3} (expect {BASIC_FLASH[name]})")
        require(tuple(got["pred_frames"].shape) == (1, 3, 16, 128, 128), f"{name}: shape")
        require(torch.isfinite(got["pred_frames"]).all().item(), f"{name}: non-finite output")
        require(min(agree) >= 0.99, f"{name}: FSQ index agreement {agree}")
        require(rec_err <= rec_tol, f"{name}: reconstruction error {rec_err} > {rec_tol}")
        require(n_fwd == n_tf32x3 == BASIC_FLASH[name], f"{name}: flash {n_fwd}/{n_tf32x3}")
        rec[name] = {"params": n_params, "cpu_s": cpu_s, "index_agree": min(agree),
                     "rec_err_rel": rec_err, "yardstick": yardstick, "flash_per_forward": n_fwd}
        del model, got, ref
        torch.cuda.empty_cache()
    for name, state in weights.items():
        bf16 = models.make({"name": name}, args={
            "dtype": torch.bfloat16, "generator": torch.Generator().manual_seed(SEED)})
        bf16.load_state_dict(state)
        rec[name].update(_reconstruction_rate(f"model_basic {name}", bf16.cuda().eval(),
                                              BASIC_FLASH[name], 0))
        del bf16
        torch.cuda.empty_cache()
    del weights
    cfg = _load_cfg("larp_tokenizer_large", tmp / "basic_train", 8)
    cfg["model"], cfg["use_amp"] = {"name": "autoencoder", "args": {}}, True
    run = _train_throughput("model_basic train bf16", cfg, (34, 18, 16), 0)
    rec["train_autoencoder_bf16"] = {k: run[k] for k in (
        "s_per_step", "clips_per_s", "peak_gib", "idle", "launches", "busy_ms_per_step",
        "device_ms_per_step")}


def main() -> int:
    if not (ROOT / "video_tokenizer_tpu_torch").is_dir():
        print("chip_smoke.py: the video_tokenizer_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch sees no CUDA device; there is no CPU fallback", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # fp32 parity phases: full-precision matmuls and convolutions on the
    # card (cuDNN would round fp32 convolutions to TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    records: dict = {}

    def run(fn, *args):  # a phase, and its wall time on a line of its own
        t = time.perf_counter()
        out = fn(*args)
        log(f"[time] {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    run(phase_build)
    for phase in (phase_flash, phase_flash_bwd, phase_vq, phase_decode_attention,
                  phase_chunk_attention, phase_cache_update, phase_fused_write, phase_w8_matmul):
        run(phase, records)
    model_fp32 = run(phase_e2e_fp32)
    tokenizer = run(phase_e2e_bf16, model_fp32, records)
    del model_fp32
    ar_model = run(phase_ar_fp32, records)
    run(phase_decode_chunk_fp32, ar_model)
    from video_tokenizer_tpu_torch import flagship_draft

    draft = flagship_draft(torch.float32, torch.Generator().manual_seed(SEED + 22))
    _perturb(draft, SEED + 23)
    draft.cuda()
    run(phase_speculative_greedy, ar_model, draft, records)
    run(phase_ar_sampling, ar_model, tokenizer, records)  # casts the prior to bf16 in place
    run(phase_speculative, ar_model, draft, tokenizer, records)
    run(phase_distill, ar_model, draft, records)
    del ar_model, draft, tokenizer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:  # the trainers' logs and cfg.yaml
        run(phase_train_fp32, Path(tmp))
        run(phase_train_throughput, Path(tmp), records)
        real_stats = run(phase_fvd, Path(tmp), records)
        run(phase_ar_train, Path(tmp), records, real_stats)
        run(phase_model_new, Path(tmp), records)
        run(phase_stat_lattice, Path(tmp), records)
        run(phase_prior, Path(tmp), records)
        run(phase_trainer_basic, Path(tmp), records)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    sources = {
        "flash_attn_fwd": ("video_tokenizer_tpu_torch/csrc/flash_attn_fwd_sm90.cu",
                           "video_tokenizer_tpu/ops/attention.py:166"),
        "flash_attn_fwd_tf32x3": ("video_tokenizer_tpu_torch/csrc/flash_attn_fwd_tf32x3.cu",
                                  "video_tokenizer_tpu/ops/attention.py:166"),
        "flash_attn_fwd_mma": ("video_tokenizer_tpu_torch/csrc/flash_attn_fwd.cu",
                               "video_tokenizer_tpu/ops/attention.py:166"),
        "flash_attn_bwd_dq": ("video_tokenizer_tpu_torch/csrc/flash_attn_bwd_dq_sm90.cu",
                              "video_tokenizer_tpu/ops/attention.py:387"),
        "flash_attn_bwd_dq_mma": ("video_tokenizer_tpu_torch/csrc/flash_attn_bwd.cu",
                                  "video_tokenizer_tpu/ops/attention.py:387"),
        "flash_attn_bwd_dq_tf32x3": ("video_tokenizer_tpu_torch/csrc/flash_attn_bwd_dq_tf32x3.cu",
                                     "video_tokenizer_tpu/ops/attention.py:387"),
        "flash_attn_bwd_dkv": ("video_tokenizer_tpu_torch/csrc/flash_attn_bwd_dkv_sm90.cu",
                               "video_tokenizer_tpu/ops/attention.py:447"),
        "flash_attn_bwd_dkv_tf32x3": (
            "video_tokenizer_tpu_torch/csrc/flash_attn_bwd_dkv_tf32x3.cu",
            "video_tokenizer_tpu/ops/attention.py:447"),
        "flash_attn_bwd_dkv_mma": ("video_tokenizer_tpu_torch/csrc/flash_attn_bwd.cu",
                                   "video_tokenizer_tpu/ops/attention.py:447"),
        "vq_argmax": ("video_tokenizer_tpu_torch/csrc/vq_lookup_sm90.cu",
                      "video_tokenizer_tpu/ops/vq.py:35"),
        # the same kernel at d = 24 over the Leech codebook (the sq bottleneck)
        "vq_argmax_leech": ("video_tokenizer_tpu_torch/csrc/vq_lookup_sm90.cu",
                            "video_tokenizer_tpu/ops/vq.py:35"),
        "decode_attention": ("video_tokenizer_tpu_torch/csrc/decode_attention_sm90.cu",
                             "video_tokenizer_tpu/ops/decode_attention.py:80"),
        "decode_attention_split": ("video_tokenizer_tpu_torch/csrc/decode_attention.cu",
                                   "video_tokenizer_tpu/ops/decode_attention.py:80"),
        "w8_matmul": ("video_tokenizer_tpu_torch/csrc/w8_matmul_stream.cu",
                      "video_tokenizer_tpu/ops/quant_matmul.py:51"),
        "w8_matmul_sm90": ("video_tokenizer_tpu_torch/csrc/w8_matmul_sm90.cu",
                           "video_tokenizer_tpu/ops/quant_matmul.py:51"),
        "w8_matmul_mma": ("video_tokenizer_tpu_torch/csrc/w8_matmul.cu",
                          "video_tokenizer_tpu/ops/quant_matmul.py:51"),
        "chunk_attention": ("video_tokenizer_tpu_torch/csrc/chunk_attention_sm90.cu",
                            "video_tokenizer_tpu/ops/decode_attention.py:330"),
        "chunk_attention_split": ("video_tokenizer_tpu_torch/csrc/chunk_attention.cu",
                                  "video_tokenizer_tpu/ops/decode_attention.py:330"),
        "cache_update": ("video_tokenizer_tpu_torch/csrc/cache_update.cu",
                         "video_tokenizer_tpu/ops/cache_update.py:60"),
        # the row write inside the decode (and chunk) kernel: its ms is the
        # fused call's excess over the attention alone
        "kv_row_write_fused": ("video_tokenizer_tpu_torch/csrc/decode_attention_sm90.cu",
                               "video_tokenizer_tpu/ops/cache_update.py:60"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, **records[name]}
        for name, (src, rep) in sources.items()
    ]
    for k in kernels:
        missing = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms"} - set(k)
        require(not missing and k["launches"] > 0, f"kernel {k['name']}: {missing or 'never launched'}")
    print(json.dumps({"train": {k: v for k, v in records.items() if k.startswith("train_")}}))
    print(json.dumps({"model_new": {k: v for k, v in records.items() if k.startswith("model_new_")}}))
    print(json.dumps({"fvd": records["fvd"]}))
    print(json.dumps({"stat_lattice": {k: records[k] for k in (
        "larp_sq", "larp_fsq", "stat", "train_stat_bf16", "train_sq_bf16", "vq_argmax_leech")}}))
    print(json.dumps({"prior": records["prior"]}))
    print(json.dumps({"trainer_basic": records["trainer_basic"]}))
    print(json.dumps({"sampling_tokens_per_s": records["sampling"],
                      "sampling_device_step_ms": records["sampling_device_step_ms"],
                      "sampling_kernels_per_step": records["sampling_kernels_per_step"],
                      "sampling_write_fused": records["sampling_write_fused"],
                      "speculative": records["speculative"], "distill": records["distill"]}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
