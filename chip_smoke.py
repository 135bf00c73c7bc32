#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (video_tokenizer_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. build the CUDA kernels from csrc/ with nvcc for sm_90a;
  2. the flash-attention forward kernel against its plain PyTorch version
     on the card (flagship shape from strided qkv views, causal with an
     offset, segments with a no-match query, GQA, ragged Sk, fp32, LSE);
  3. the VQ nearest-code kernel against its plain version (cos, l2, ragged);
  4. end to end in fp32 (TF32 off): the full-width flagship tokenizer,
     seeded and perturbed, on the card against the same weights on the CPU
     through the plain versions;
  5. end to end in bf16: batch-8 reconstruction throughput, with the launch
     counters showing that every attention and VQ call ran the kernels.
Prints the card's name and power limit, one JSON line with every kernel's
numbers, and last {"ok": true, "device": {...}}. Needs one CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

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


def phase_build() -> None:
    from video_tokenizer_tpu_torch.ops import _build

    build = _build.build()
    _build.library()
    log(f"[build] {build.path.relative_to(ROOT)} built by nvcc for sm_90a "
        f"in {build.seconds:.1f} s from {', '.join(s.name for s in _build._sources())}")
    for line in build.log.splitlines():
        if "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            log(f"[build]   {line.strip()}")


def phase_flash(records: dict) -> None:
    import torch

    from video_tokenizer_tpu_torch.ops.attention import attention_reference, flash_attn_fwd

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # (name, B, Sq, Sk, H, Hkv, D, dtype, causal, offset, segments, lse, tol)
    # bf16 kernel vs the fp32 plain version (output rounded to bf16 on both
    # sides, P rounded to bf16 in the kernel): 2e-2. fp32: 1e-4.
    cases = [
        ("flagship", 8, 2048, 2048, 12, 12, 64, torch.bfloat16, False, None, False, False, 2e-2),
        ("causal_offset", 2, 384, 512, 4, 4, 64, torch.bfloat16, True, 100, False, False, 2e-2),
        ("segments_no_match", 2, 512, 512, 4, 4, 64, torch.bfloat16, False, None, True, False, 2e-2),
        ("gqa_4_over_2", 2, 512, 512, 4, 2, 64, torch.bfloat16, False, None, False, False, 2e-2),
        ("ragged_sk", 2, 300, 1000, 4, 4, 64, torch.bfloat16, False, None, False, False, 2e-2),
        ("fp32", 1, 2048, 2048, 12, 12, 64, torch.float32, False, None, False, False, 1e-4),
        ("lse_fp32", 2, 384, 200, 4, 2, 128, torch.float32, True, 50, True, True, 1e-4),
        ("lse_bf16", 2, 384, 512, 4, 4, 32, torch.bfloat16, False, None, True, True, 2e-2),
    ]
    for name, B, Sq, Sk, H, Hkv, D, dtype, causal, offset, with_seg, lse, tol in cases:
        if name == "flagship":
            # q, k, v as strided views of one [B, S, 3, H, D] qkv projection
            qkv = randn(B, Sq, 3, H, D, dtype=dtype)
            q, k, v = qkv.unbind(2)
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
        want, want_lse = attention_reference(q, k, v, causal, q_seg, k_seg, None, offset)
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (got_lse - want_lse).abs().max().item() if lse else 0.0
        require(torch.isfinite(got).all().item(), f"flash {name}: non-finite output")
        log(f"[flash] {name}: B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} {str(dtype)[6:]} "
            f"max|kernel-plain| {err:.3e} (tol {tol:g})" + (f", lse {lse_err:.3e}" if lse else ""))
        require(err <= tol and lse_err <= tol, f"flash {name}: error {err}, lse {lse_err} > {tol}")
        if not lse:
            require(torch.equal(flash_attn_fwd(q, k, v, **kw), got), f"flash {name}: lse changes out")
        if name == "flagship":
            ms = median_ms(lambda: flash_attn_fwd(q, k, v))
            plain_ms = median_ms(lambda: attention_reference(q, k, v), iters=5)
            lse_ms = median_ms(lambda: flash_attn_fwd(q, k, v, return_lse=True))
            flops = 4 * B * H * Sq * Sk * D
            log(f"[flash] flagship: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                f"with LSE {lse_ms:.3f} ms, plain (out and LSE) {plain_ms:.3f} ms (median)")
            records["flash_attn_fwd"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _vq_gap(z, emb, bias, a, b):
    """Score gap between codes a and b of each row of z, in fp64."""
    za, ea = z.double(), emb.double()
    sa = (za * ea[a.long()]).sum(-1)
    sb = (za * ea[b.long()]).sum(-1)
    if bias is not None:
        sa, sb = sa + bias.double()[a.long()], sb + bias.double()[b.long()]
    return (sa - sb).abs()


def phase_vq(records: dict) -> None:
    import torch

    from video_tokenizer_tpu_torch.ops.vq import vq_argmax, vq_lookup_reference

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
        want = vq_lookup_reference(z, emb, bias)
        diff = got != want
        n_diff = int(diff.sum().item())
        gap = _vq_gap(z[diff], emb, bias, got[diff], want[diff]).max().item() if n_diff else 0.0
        log(f"[vq] {name}: M={M} K={K} d={d} {metric}: {n_diff} of {M} indices differ "
            f"(largest score gap {gap:.2e}, tol 1e-5)")
        require(gap < 1e-5, f"vq {name}: index differs at a score gap {gap}")
        if name == "flagship_cos":
            ms = median_ms(lambda: vq_argmax(z, emb, bias))
            plain_ms = median_ms(lambda: vq_lookup_reference(z, emb, bias))
            log(f"[vq] flagship: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median)")
            records["vq_argmax"] = {"max_abs_err": gap, "ms": ms, "plain_ms": plain_ms}


def _perturb(model, seed: int) -> None:
    """Bench-style: every weight of rank >= 2 += 0.02 * N(0, 1) (the output
    layer is zero-initialised, so a fresh model would decode zeros)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.add_(0.02 * torch.randn(p.shape, generator=gen))


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
    from video_tokenizer_tpu_torch.reconstruct import make_clips, psnr_from_mse, reconstruct

    model = flagship_tokenizer(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    model.load_state_dict(model_fp32.state_dict())
    model.cuda().eval()
    B = 8
    x = torch.from_numpy(make_clips(np.random.default_rng(SEED), B, 16, 128)).cuda()
    reconstruct(model, x)  # warm-up
    torch.cuda.synchronize()

    iters = 5
    flash_attn_fwd.launches = vq_argmax.launches = 0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        rec = reconstruct(model, x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"flash_attn_fwd": flash_attn_fwd.launches, "vq_argmax": vq_argmax.launches}

    clips_per_s = B / statistics.median(times)
    mse = torch.mean((rec - x).reshape(B, -1) ** 2, dim=-1)
    ref = reconstruct(model_fp32, x[:1])
    bf16_vs_fp32 = (rec[:1] - ref).abs().mean().item()
    log(f"[e2e bf16] batch {B} clips [8,3,16,128,128]: median {statistics.median(times) * 1e3:.2f} ms "
        f"over {iters} iterations = {clips_per_s:.2f} clips/s; "
        f"mse {mse.mean().item():.5f}, psnr {psnr_from_mse(mse).mean().item():.3f} dB")
    log(f"[e2e bf16] launches in {iters} forwards: flash {launches['flash_attn_fwd']}, "
        f"vq {launches['vq_argmax']} (expect {24 * iters} and {iters}); "
        f"mean|bf16 - fp32| of clip 0: {bf16_vs_fp32:.3e} (tol 1e-2)")
    require(tuple(rec.shape) == (B, 3, 16, 128, 128), "bf16 reconstruction shape")
    require(torch.isfinite(rec).all().item() and torch.isfinite(mse).all().item(), "non-finite output")
    # bf16 activations through 24 layers against the fp32 card path: about
    # 2e-3 mean deviation on [0, 1] pixels; 1e-2 flags a broken dtype policy
    require(bf16_vs_fp32 <= 1e-2, f"bf16 drifts from fp32 by {bf16_vs_fp32} on average")
    require(launches == {"flash_attn_fwd": 24 * iters, "vq_argmax": iters},
            f"launch counts {launches}")
    for name, n in launches.items():
        records[name]["launches"] = n


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
    phase_build()
    phase_flash(records)
    phase_vq(records)
    model_fp32 = phase_e2e_fp32()
    phase_e2e_bf16(model_fp32, records)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    sources = {
        "flash_attn_fwd": ("video_tokenizer_tpu_torch/csrc/flash_attn_fwd.cu",
                           "video_tokenizer_tpu/ops/attention.py:166"),
        "vq_argmax": ("video_tokenizer_tpu_torch/csrc/vq_lookup.cu",
                      "video_tokenizer_tpu/ops/vq.py:35"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, **records[name]}
        for name, (src, rep) in sources.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
