"""Where the device time of the port's flagship reconstruction goes, on one GPU.

Traces `reconstruct` (encode_eval + decode_eval) of the full-width flagship
tokenizer in bf16 at batch 8 with torch.profiler (CPU + CUDA activities),
after a warm-up, and prints:
  * device kernel time per category (flash kernel, VQ kernel, GEMMs,
    LayerNorm, GELU, other elementwise and copies), per forward;
  * the device's busy and idle share of the traced wall time, the wall time
    of the same forwards without the profiler, and kernel launches per forward;
  * the top kernels by device time;
and one JSON line with the same numbers. Weights are a seeded random init
(timing has no data-dependent branch).

  python tools/profile_torch_tokenizer.py [--batch_size 8] [--iters 3] [--trace out.json]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("flash_attn_fwd", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("vq_argmax", ("vq_argmax_kernel",)),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("layer_norm", ("layer_norm",)),
    ("gelu", ("gelu",)),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other elementwise/copy"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from video_tokenizer_tpu_torch import flagship_tokenizer
    from video_tokenizer_tpu_torch.reconstruct import reconstruct

    model = flagship_tokenizer(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    model.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(args.batch_size, 3, 16, 128, 128, generator=gen, device="cuda")
    for _ in range(2):
        reconstruct(model, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        reconstruct(model, x)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3  # without the profiler

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            reconstruct(model, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # device busy time: the union of kernel intervals (one stream, so the sum)
    per_cat: dict = {}
    per_name: dict = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        per_cat[category(e.name)] = per_cat.get(category(e.name), 0.0) + us
        per_name[e.name] = per_name.get(e.name, 0.0) + us
    busy_ms = sum(per_cat.values()) / 1e3
    n = args.iters
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"batch {args.batch_size}, {n} forwards: wall {wall_ms / n:.3f} ms per forward "
          f"({plain_wall_ms / n:.3f} ms without the profiler), "
          f"device busy {busy_ms / n:.3f} ms ({busy_ms / wall_ms:.1%}), "
          f"idle {1 - busy_ms / wall_ms:.1%}, {len(kernels) / n:.0f} kernel launches per forward")
    for cat, us in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:24s} {us / 1e3 / n:9.3f} ms per forward  {us / 1e3 / busy_ms:6.1%}")
    print("top kernels:")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3 / n:9.3f} ms  {name[:110]}")
    print(json.dumps({
        "device": smi, "batch": args.batch_size, "forwards": n,
        "wall_ms_per_forward": wall_ms / n, "unprofiled_wall_ms_per_forward": plain_wall_ms / n,
        "busy_ms_per_forward": busy_ms / n, "kernels_per_forward": len(kernels) / n,
        "idle_share": 1 - busy_ms / wall_ms,
        "ms_per_forward": {k: v / 1e3 / n for k, v in per_cat.items()},
    }))


if __name__ == "__main__":
    main()
