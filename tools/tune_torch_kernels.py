"""Times tilings of the Hopper kernels whose tiling is a set of constants.

  python3 tools/tune_torch_kernels.py [chunk] [dq] [decode] [w8] [w8_step] [flash_fp32] [w8_large]
      [flash_bwd_fp32] [vq] [vq_gemm] [flash_d80] [parent=<csrc directory>]
  (one CUDA device, nvcc)

`csrc/chunk_attention_sm90.cu`, `csrc/flash_attn_bwd_dq_sm90.cu`,
`csrc/decode_attention_sm90.cu`, `csrc/w8_matmul_stream.cu`,
`csrc/flash_attn_fwd_tf32x3.cu`, `csrc/w8_matmul_sm90.cu`,
`csrc/flash_attn_bwd_dq_tf32x3.cu` and `csrc/flash_attn_bwd_dkv_tf32x3.cu` fix their
tiling in `constexpr int` constants at the head of the file. This script
copies `csrc/` to `build/variants/<name>/`, substitutes the constants of each
variant below in the copy, compiles that one source with the port's nvcc
flags into a library of its own, binds the entry point with the port's
signature table, and times every variant in one process on one card, beside
the earlier kernel, with its registers, spill bytes and its error against the
plain version (chunk, decode, w8) or the earlier kernel (dQ): the chunk kernel
for 1, 2, 3, 4 and 6 splits of the cache at the verify and draft shapes of the
632M prior at positions 1024 and 512 (CUDA-graph replays), the dQ kernel at
the tokenizer's, the discriminator's and the prior's causal shape (CUDA
events, two rounds), the one-token decode kernel cold over 30 layers' caches
(bf16 and int8, one or two KV heads per block, 1 or 2 splits, pos 1024, 512
and 0), and the streaming int8 matmul over one decode step's 151 (or the
draft's 41) distinct weights, cold, back to back and after an elementwise
kernel, under `w8_plan`'s plan and others (`w8_plans`), then each projection
shape alone; and (`w8_step`) one decode step of the int8 prior with its
projections on the earlier kernel and under each of those plans; the 3xTF32
flash forward (`flash_fp32`: warps a block, ring stages, blocks an SM, the
way an operand is split) at the fp32 tokenizer's B = 1 and B = 8 and the
prior's causal shape beside the earlier FMA kernel and SDPA (CUDA events, two
rounds); and the wgmma int8 matmul (`w8_large`: output channels a block, ring
stages) at the NLL forward's M = 8192 shapes beside the earlier kernel and
cuBLAS on a bf16 copy (CUDA-graph replays, two rounds); and the 3xTF32 flash
backward kernels (`flash_bwd_fp32`: the streamed tile, ring stages and
blocks an SM of dQ and of dK/dV) at the fp32 tokenizer's, discriminator's and
AR trainer's causal shapes at batch 8 beside the FMA kernels and SDPA's fp32
backward (kernels by CUDA-graph replays, SDPA by CUDA events, two rounds).
`vq`: the 3xTF32 VQ search (`csrc/vq_lookup_sm90.cu`: 16-row tiles a warp,
warps a block, blocks a cluster, and two diagnostic variants that leave out
the index pick or the products) at the flagship shape (M = K = 8192, d = 8,
argmax and Gumbel-max; CUDA-graph replays, two rounds) beside the earlier FMA
kernel. `flash_d80`: the wgmma flash forward at D = 80 (`csrc/flash_attn_fwd_sm90.cu`:
Q in shared memory or in registers, one or two blocks an SM) at the V-JEPA2
teacher's B = 8, S = 2048, H = 16 beside SDPA (CUDA-graph replays, two
rounds). `vq_gemm`: the wide-code VQ search (`csrc/vq_gemm_sm90.cu`: one block of 8
warps over 128 rows an SM in place of two of 4 over 64, ring stages, and
diagnostic variants that keep one of the three TF32 products or none) at SimVQ's
d = 256, K = 16,384, M = 256, 2048 and 8192 (CUDA-graph replays, two rounds)
beside `torch.addmm(bias, z, e.T).argmax(-1)`, with diagnostic variants that
leave out the codes' TF32 split, the ring's block barrier or its loads.
With `parent=DIR`, the decode and chunk attention kernels of DIR (the `csrc/`
of a checkout from before their KV row write was fused in, built and bound
with the entry points they had then) are timed beside this tree's, unfused
and fused, on the same caches: 30 layers' caches cold, bf16 and int8, the
one-token step and the G = 5 verify chunk at pos 512 and 1024 (CUDA-graph
replays, in turn: parent, this tree, fused, fused, this tree, parent).
Nothing here is used
by the port; the sources keep one tiling.
"""
import ctypes
import importlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as c  # noqa: E402  (median_ms, graph_ms)
from video_tokenizer_tpu_torch.ops import _build  # noqa: E402

# the ops package exports functions under its modules' names
A = importlib.import_module("video_tokenizer_tpu_torch.ops.attention")
DA = importlib.import_module("video_tokenizer_tpu_torch.ops.decode_attention")
QM = importlib.import_module("video_tokenizer_tpu_torch.ops.quant_matmul")

W8_PLAN = QM.w8_plan  # the port's own, whatever tune_w8_step puts in its place
ROOT = REPO / "build" / "variants"
CSRC = _build.CSRC


def compile_variant(name, source, subs, entry, header=None):
    """Builds `source` of a copy of csrc/ with the `constexpr int` constants of
    `subs` replaced; returns the bound entry point, or None if nvcc refuses it.
    A key "text" takes (old, new) pairs of source text instead: diagnostic
    variants that leave part of a kernel's work out, to time the rest."""
    d = ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    text = (d / source).read_text()
    for key, val in subs.items():
        if key == "text":
            target = d / (header or source)
            body = target.read_text() if header else text
            for old, new in val:
                if body.count(old) != 1:
                    raise ValueError(f"{target.name}: {old!r} is not there once")
                body = body.replace(old, new)
            if header:
                target.write_text(body)
            else:
                text = body
            continue
        text, n = re.subn(rf"constexpr int {key} = [^;]+;", f"constexpr int {key} = {val};", text, count=1)
        if n != 1:
            raise ValueError(f"{source}: no constant {key}")
    (d / source).write_text(text)
    lib = d / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(d / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"[{name}] nvcc failed:\n{proc.stdout}{proc.stderr}"[-3000:], flush=True)
        return None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Performance Loss" in line:  # e.g. wgmma serialised by ptxas
            print(f"[{name}] {line.strip()}"[:400], flush=True)
    res = _build.kernel_resources(proc.stdout + proc.stderr)
    short = {re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f_]+", "", k)[:60]: v for k, v in res.items()}
    print(f"[{name}] {subs} regs/spills: {short}", flush=True)
    cdll = ctypes.CDLL(str(lib))
    fn = getattr(cdll, entry)
    fn.argtypes, fn.restype = _build.SIGNATURES[entry]
    return fn


def tune_dq():
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = {"tok": (8, 2048, 12, 64, False), "disc": (8, 1025, 12, 32, False), "causal": (8, 1024, 20, 64, True)}
    data = {}
    for name, (B, S, H, D, causal) in shapes.items():
        q, k, v = (torch.randn(B, S, 3, H, D, generator=gen, device="cuda").bfloat16()).unbind(2)
        do = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
        out, lse = A.flash_attn_fwd(q, k, v, causal=causal, return_lse=True)
        delta = torch.einsum("bqhd,bqhd->bhq", out.float(), do.float()).contiguous()
        want = torch.empty_like(do)
        A._bwd_launch(False, q, k, v, do, lse, delta, None, None, want, None, causal, 0, D ** -0.5)
        data[name] = (q, k, v, do, lse, delta, want, causal)
    variants = {
        "wg2_mb2_st4": dict(kWG=2, kMinBlocks=2, kStages=4),
        "wg2_mb2_st3": dict(kWG=2, kMinBlocks=2, kStages=3),
        "wg1_mb2_st4": dict(kWG=1, kMinBlocks=2, kStages=4),
        "wg1_mb3_st3": dict(kWG=1, kMinBlocks=3, kStages=3),
        "wg1_mb4_st2": dict(kWG=1, kMinBlocks=4, kStages=2),
        "wg2_mb1_st4": dict(kWG=2, kMinBlocks=1, kStages=4),
        "wg2_mb1_st6": dict(kWG=2, kMinBlocks=1, kStages=6),
    }
    fns = {n: compile_variant(n, "flash_attn_bwd_dq_sm90.cu", s, "vtt_flash_attn_bwd_dq_sm90")
           for n, s in variants.items()}
    for rnd in range(2):
        for n, fn in fns.items():
            if fn is None:
                continue
            line = []
            for name, (q, k, v, do, lse, delta, want, causal) in data.items():
                B, S, H, D = q.shape
                dq = torch.empty_like(do)
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), B, H, H, S, S, D,
                              *A._bwd_strides(q, k, v, do), int(causal), 0, D ** -0.5, stream)
                    assert code == 0, code

                ms = c.median_ms(run)
                err = (dq.float() - want.float()).abs().max().item() / want.float().abs().max().item()
                line.append(f"{name} {ms:.3f} ms (err {err:.1e})")
            print(f"[dq round {rnd}] {n}: " + ", ".join(line), flush=True)
    # the earlier kernel and dK/dV for reference
    for name, (q, k, v, do, lse, delta, want, causal) in data.items():
        D = q.shape[-1]
        e = c.median_ms(lambda: A._bwd_launch(False, q, k, v, do, lse, delta, None, None, want, None, causal, 0, D ** -0.5))
        kv = c.median_ms(lambda: A.flash_attn_bwd_dkv(q, k, v, do, lse, delta, None, None, causal, 0, D ** -0.5))
        print(f"[dq] {name}: earlier dq {e:.3f} ms, dkv sm90 {kv:.3f} ms", flush=True)


def tune_chunk():
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, S, D = 16, 1152, 64
    cases = {}
    for name, G, H, dt in (("verify_bf16", 5, 20, torch.bfloat16), ("verify_int8", 5, 20, torch.int8),
                           ("draft_g1_bf16", 1, 12, torch.bfloat16), ("draft_g2_int8", 2, 12, torch.int8)):
        qkv = torch.randn(B, G, 3 * H * D, generator=gen, device="cuda").bfloat16()
        q = qkv[..., : H * D].unflatten(-1, (H, D))
        kf = torch.randn(B, S, H * D, generator=gen, device="cuda")
        vf = torch.randn(B, S, H * D, generator=gen, device="cuda")
        ks = vs = None
        if dt == torch.int8:
            (k, ks), (v, vs) = DA._quantize_rows(kf), DA._quantize_rows(vf)
        else:
            k, v = kf.bfloat16(), vf.bfloat16()
        cases[name] = (q, k, v, ks, vs, G, H)
    variants = {
        "w4_st4": dict(kWarps=4, kStages=4),
        "w4_st8": dict(kWarps=4, kStages=8),
        "w4_st6": dict(kWarps=4, kStages=6),
        "w8_st4": dict(kWarps=8, kStages=4),
        "w2_st4": dict(kWarps=2, kStages=4),
    }
    fns = {n: compile_variant(n, "chunk_attention_sm90.cu", s, "vtt_chunk_attention_sm90")
           for n, s in variants.items()}
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    for pos_val in (1024, 512):
        pos = torch.full((B,), pos_val, dtype=torch.int32, device="cuda")
        for name, (q, k, v, ks, vs, G, H) in cases.items():
            want = DA.chunk_attention_reference(q, k, v, pos, k_scale=ks, v_scale=vs, kv_heads=H)
            # (not empty_like: the plain version's output is a permuted view)
            earlier = torch.empty(want.shape, dtype=want.dtype, device="cuda")
            e_ms = c.graph_ms(lambda: DA._chunk_launch("chunk_split_kernel", q, k, v, pos, None, ks, vs, H, earlier))
            print(f"[chunk pos {pos_val}] {name}: earlier {e_ms:.4f} ms", flush=True)
            for n, fn in fns.items():
                if fn is None:
                    continue
                line = []
                for n_splits in (1, 2, 3, 4, 6):
                    out = torch.empty(want.shape, dtype=want.dtype, device="cuda")
                    po = torch.empty((B, G, H, n_splits, D), dtype=torch.float32, device="cuda")
                    pm = torch.empty((B, G, H, n_splits, 2), dtype=torch.float32, device="cuda")

                    def run():
                        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), None, ptr(ks), ptr(vs),
                                  None, None, po.data_ptr(), pm.data_ptr(), out.data_ptr(),
                                  DA._CACHE_DTYPES[k.dtype], 1, 0, B, G, H, H, S, D, n_splits,
                                  q.stride(0), q.stride(1), 0, 0, D ** -0.5,
                                  torch.cuda.current_stream().cuda_stream)
                        assert code == 0, code

                    ms = c.graph_ms(run)
                    err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
                    line.append(f"s{n_splits} {ms:.4f} ({err:.0e})")
                print(f"[chunk pos {pos_val}] {name} {n}: " + ", ".join(line), flush=True)


def compile_variants(source, variants, entry, header=None):
    """compile_variant for every variant of one source, all nvcc runs at once;
    "text" substitutions go to `header` if given."""
    with ThreadPoolExecutor(len(variants)) as pool:
        futures = {n: pool.submit(compile_variant, n, source, s, entry, header)
                   for n, s in variants.items()}
    return {n: f.result() for n, f in futures.items()}


def tune_decode():
    """The one-token decode kernel at the 632M prior's sampling shape, cold
    (30 layers' caches per graph replay), bf16 and int8 caches, pos 1024, 512
    and 0, one and two KV heads per block (int8), 1 and 2 splits, beside the
    earlier kernel."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, D, layers = 16, 1152, 20, 64, 30
    q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
    variants = {
        "w4_st4": dict(kWarps=4, kStages=4),
        "w8_st4": dict(kWarps=8, kStages=4),
        "w4_st6": dict(kWarps=4, kStages=6),
        "w2_st6": dict(kWarps=2, kStages=6),
    }
    fns = compile_variants("decode_attention_sm90.cu", variants, "vtt_decode_attention_sm90")
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    arrived = torch.zeros(B * H, dtype=torch.int32, device="cuda")
    for dt in (torch.bfloat16, torch.int8):
        caches = []
        for _ in range(layers):
            kf = torch.randn(B, S, H * D, generator=gen, device="cuda")
            vf = torch.randn(B, S, H * D, generator=gen, device="cuda")
            if dt == torch.int8:
                (k, ks), (v, vs) = DA._quantize_rows(kf), DA._quantize_rows(vf)
            else:
                k, v, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
            caches.append((k, v, ks, vs))
        for pos_val in (1024, 512, 0):
            pos = torch.full((1,), pos_val, dtype=torch.int32, device="cuda")
            out = torch.empty_like(q)

            def earlier():
                for k, v, ks, vs in caches:
                    DA._decode_launch("decode_split_kernel", q, k, v, pos, None, ks, vs, H, out)

            e_ms = c.graph_ms(earlier, launches=1, replays=5) / layers
            print(f"[decode {str(dt)[6:]} pos {pos_val}] earlier {e_ms:.4f} ms", flush=True)
            k, v, ks, vs = caches[-1]
            want = DA.decode_attention_reference(q, k, v, pos, k_scale=ks, v_scale=vs, kv_heads=H)
            for n, fn in fns.items():
                if fn is None:
                    continue
                line = []
                for hpb in ((1, 2) if dt == torch.int8 else (1,)):
                    for n_splits in ((1, 2) if n == "w4_st4" else (1,)):
                        po = torch.empty((B, H, n_splits, D), dtype=torch.float32, device="cuda")
                        pm = torch.empty((B, H, n_splits, 2), dtype=torch.float32, device="cuda")

                        def run():
                            for k, v, ks, vs in caches:
                                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                                          None, ptr(ks), ptr(vs), None, None, po.data_ptr(),
                                          pm.data_ptr(), arrived.data_ptr(), out.data_ptr(),
                                          DA._CACHE_DTYPES[dt], 0, B, H, H, S, D, n_splits, hpb,
                                          q.stride(0), 0, D ** -0.5,
                                          torch.cuda.current_stream().cuda_stream)
                                assert code == 0, code

                        ms = c.graph_ms(run, launches=1, replays=5) / layers
                        err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
                        line.append(f"hpb{hpb} s{n_splits} {ms:.4f} ({err:.0e})")
                print(f"[decode {str(dt)[6:]} pos {pos_val}] {n}: " + ", ".join(line), flush=True)
        del caches


def w8_plans(M, N, K):
    """Plans of the streaming int8 matmul beside `w8_plan`'s own ("plan"):
    64-channel blocks of 4 warps (fewer where even 8 splits leave an SM
    without a block) with `factor` times the splits that give each SM a block
    as one cluster ("clusters_x<factor>")."""
    stages = -(-K // 128)
    least = -(-stages // QM._stages_that_fit(QM._rows(M)))
    plans = {"plan": W8_PLAN(M, N, K)}
    for factor in (1, 2):
        for warps in (4, 2, 1):
            groups = -(-N // (16 * warps))
            once = min(stages, 8, max(least, -(-132 // groups)))
            if groups * once >= 132:
                break
        plans[f"clusters_x{factor}"] = QM.W8Plan(warps, groups, min(stages, 8, max(least, factor * once)),
                                                 QM._rows(M))
    return plans


def tune_w8_step():
    """The device time of one decode step of the 632M prior with int8 weights
    (graph replay at pos 512, replays of 50) with its projections on the
    kernels `w8_kernel` names, all on the earlier kernel, and all on the
    streaming kernel under each plan of `w8_plans`, two rounds in turn."""
    from video_tokenizer_tpu_torch import flagship_ar
    from video_tokenizer_tpu_torch.models.larp_ar import quantize_model

    bf16 = flagship_ar(torch.float32, torch.Generator().manual_seed(1)).cuda().to(torch.bfloat16)
    int8 = quantize_model(bf16)
    del bf16
    tok = torch.randint(0, 8192, (16, 1), device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    pos = torch.full((1,), 512, dtype=torch.int32, device="cuda")
    chooser, planner = QM.w8_kernel, W8_PLAN
    options = ["chosen", "earlier", *w8_plans(16, 1280, 1280)]
    with torch.inference_mode():
        for kv in (None, torch.int8):
            cache = int8.init_cache(16, 1025, kv or torch.bfloat16)
            times = {o: [] for o in options}
            try:
                for _ in range(2):
                    for o, t in times.items():
                        if o == "chosen":
                            QM.w8_kernel, QM.w8_plan = chooser, planner
                        elif o == "earlier":
                            QM.w8_kernel, QM.w8_plan = (lambda M, K, dtype: "w8_matmul_kernel"), planner
                        else:  # every projection on the streaming kernel, under plan o
                            QM.w8_kernel = lambda M, K, dtype: (
                                "w8_stream_kernel" if QM.w8_streams(M, K) else "w8_matmul_kernel")
                            QM.w8_plan = lambda M, N, K, o=o: w8_plans(M, N, K)[o]
                        t.append(c.graph_ms(lambda: int8.decode_step(tok, pos, cache), launches=1,
                                            replays=50))
            finally:
                QM.w8_kernel, QM.w8_plan = chooser, planner
            print(f"[w8 step {'int8 + int8 KV' if kv else 'int8'}] " + ", ".join(
                f"{o} " + " / ".join(f"{x:.4f}" for x in t) for o, t in times.items()) + " ms",
                flush=True)


def tune_w8():
    """The streaming int8 matmul over one decode step's projections (distinct
    weights, cold), back to back and with an elementwise kernel writing x
    before each product (as in the model), for each variant under each plan
    of `w8_plans`, beside the earlier kernel and cuBLAS on bf16 copies; then,
    for the first variant, each projection shape alone (30 distinct weights
    of it per replay)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    variants = {
        "base": {},
        "st4": dict(kStages=4),
    }
    fns = compile_variants("w8_matmul_stream.cu", variants, "vtt_w8_matmul_stream")
    def stream_run(fn, M, proj, xs, ws, scales, outs, plans, touch):
        def run():
            for (K, N), w, s, o, (plan, splits) in zip(proj, ws, scales, outs, plans):
                if touch:
                    xs[K].mul_(1.0)  # an elementwise kernel writes x first
                code = fn(xs[K].data_ptr(), w.data_ptr(), s.data_ptr(), o.data_ptr(), 1, M, N, K,
                          plan.warps, splits, 1, torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
        return run

    for name, M, proj in (("lp_m16", 16, c.LP_PROJ), ("lp_m80", 80, c.LP_PROJ),
                          ("draft_m16", 16, c.DRAFT_PROJ)):
        ws = [torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
              for K, N in proj]
        scales = [torch.rand(N, generator=gen, device="cuda") * 2e-3 + 1e-4 for _, N in proj]
        xs = {K: torch.randn(M, K, generator=gen, device="cuda").bfloat16() for K, _ in set(proj)}
        outs = [torch.empty(M, N, dtype=torch.bfloat16, device="cuda") for _, N in proj]
        wants = [QM.w8_matmul_reference(xs[K], w.t(), s, True) for (K, _), w, s in zip(proj, ws, scales)]
        nbytes = sum(w.numel() for w in ws)

        def earlier(touch):
            def run():
                for (K, _), w, s, o in zip(proj, ws, scales, outs):
                    if touch:
                        xs[K].mul_(1.0)
                    QM._w8_launch("w8_matmul_kernel", xs[K], w, s, o, True)
            return run

        e_ms = c.graph_ms(earlier(False), launches=1, replays=5)
        et_ms = c.graph_ms(earlier(True), launches=1, replays=5)
        wb = [w.to(torch.bfloat16) for w in ws]

        def cublas():
            for (K, _), w in zip(proj, wb):
                torch.matmul(xs[K], w.t())

        l_ms = c.graph_ms(cublas, launches=1, replays=5)
        del wb
        print(f"[w8 {name}] {nbytes / 1e6:.0f} MB: earlier {e_ms:.4f} ms (after elementwise "
              f"{et_ms:.4f} ms), cuBLAS bf16 {l_ms:.4f} ms, "
              f"bound {nbytes / c.HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
        for n, fn in fns.items():
            if fn is None:
                continue
            for option in w8_plans(16, 1280, 1280):
                plans = [(pl, pl.splits) for pl in (w8_plans(M, N, K)[option] for K, N in proj)]
                line = []
                for touch in (False, True):
                    ms = c.graph_ms(stream_run(fn, M, proj, xs, ws, scales, outs, plans, touch),
                                    launches=1, replays=5)
                    line.append(f"{'after elementwise' if touch else 'back to back'} {ms:.4f} ms")
                stream_run(fn, M, proj, xs, ws, scales, outs, plans, False)()
                torch.cuda.synchronize()
                err = max((o.float() - w_.float()).abs().max().item() / w_.float().abs().max().item()
                          for o, w_ in zip(outs, wants))
                print(f"[w8 {name}] {n}, {option}: "
                      + ", ".join(line)
                      + f" (err {err:.1e})", flush=True)
        fn = next(f for f in fns.values() if f is not None)
        for K, N in sorted(set(proj)):
            idx = [i for i, kn in enumerate(proj) if kn == (K, N)][:30]
            sub = [proj[i] for i in idx]
            sw, ss, so = [ws[i] for i in idx], [scales[i] for i in idx], [outs[i] for i in idx]
            plan = QM.w8_plan(M, N, K)
            plans = [(plan, plan.splits)] * len(idx)
            ms = c.graph_ms(stream_run(fn, M, sub, xs, sw, ss, so, plans, False), launches=1,
                            replays=5) / len(idx)

            def earlier_one():
                for w, s, o in zip(sw, ss, so):
                    QM._w8_launch("w8_matmul_kernel", xs[K], w, s, o, True)

            e1 = c.graph_ms(earlier_one, launches=1, replays=5) / len(idx)
            print(f"[w8 {name}] {K}x{N} ({len(idx)} distinct, {plan}): {ms * 1e3:.2f} us per product, "
                  f"earlier {e1 * 1e3:.2f} us, bound {K * N / c.HBM_BYTES_PER_S * 1e6:.2f} us", flush=True)
        del ws


def tune_flash_fp32():
    """The 3xTF32 flash forward's tilings at the fp32 training path's shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = {"tok_b1": (1, 2048, 12, 64, False), "tok_b8": (8, 2048, 12, 64, False),
              "disc_b8": (8, 1025, 12, 32, False), "prior_causal": (2, 1024, 20, 64, True)}
    data = {}
    for name, (B, S, H, D, causal) in shapes.items():
        q, k, v = torch.randn(B, S, 3, H, D, generator=gen, device="cuda").unbind(2)
        want, _ = A.attention_reference(q, k, v, causal)
        data[name] = (q, k, v, want, causal)
    # lo rounded by cvt.rna, as the first version did (sm90.cuh now leaves
    # it to the tensor core's truncation)
    rna = ("  lo = __float_as_uint(x - __uint_as_float(hi));",
           '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));')
    variants = {
        "w4_st3_mb2": dict(kWarps=4, kStages=3, kMinBlocks=2),
        "w4_st3_mb2_rna_lo": dict(kWarps=4, kStages=3, kMinBlocks=2, text=[rna]),
        "w4_st2_mb2": dict(kWarps=4, kStages=2, kMinBlocks=2),
        "w8_st3_mb1": dict(kWarps=8, kStages=3, kMinBlocks=1),
        "w4_n32_st4_mb3": dict(kWarps=4, kBlockN=32, kStages=4, kMinBlocks=3),
    }
    fns = compile_variants("flash_attn_fwd_tf32x3.cu", variants, "vtt_flash_attn_fwd_tf32x3",
                           header="sm90.cuh")
    for rnd in range(2):
        for n, fn in fns.items():
            if fn is None:
                continue
            line = []
            for name, (q, k, v, want, causal) in data.items():
                B, S, H, D = q.shape
                out = torch.empty(q.shape, device="cuda")
                strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                              out.data_ptr(), None, B, H, H, S, S, D, *strides, int(causal), 0,
                              0, D ** -0.5, stream)
                    assert code == 0, code

                ms = c.median_ms(run)
                err = (out - want).abs().max().item() / want.abs().max().item()
                line.append(f"{name} {ms:.3f} ms (err {err:.1e})")
            print(f"[flash_fp32 round {rnd}] {n}: " + ", ".join(line), flush=True)
        for name, (q, k, v, want, causal) in data.items():
            out = torch.empty(q.shape, device="cuda")
            D = q.shape[-1]
            args = (q, k, v, None, None, out, None, causal, 0, D ** -0.5)
            e = c.median_ms(lambda: A._fwd_launch("flash_fwd_kernel", *args))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = c.median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
            print(f"[flash_fp32 round {rnd}] {name}: earlier flash_fwd_kernel {e:.3f} ms, "
                  f"SDPA {lib:.3f} ms", flush=True)


def tune_flash_bwd_fp32():
    """The 3xTF32 flash backward kernels' tilings (`flash_bwd_fp32`: key
    tile, ring stages and blocks an SM of dQ; query tile, ring stages and
    blocks an SM of dK/dV) at the fp32 training path's shapes: the
    tokenizer's, the discriminator's and the AR trainer's causal one, beside
    the FMA kernels and SDPA's fp32 backward (efficient backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = {"tok_b8": (8, 2048, 12, 64, False), "disc_b8": (8, 1025, 12, 32, False),
              "prior_causal": (8, 1024, 20, 64, True)}
    data = {}
    for name, (B, S, H, D, causal) in shapes.items():
        q, k, v = torch.randn(B, S, 3, H, D, generator=gen, device="cuda").unbind(2)
        do = torch.randn(B, S, H, D, generator=gen, device="cuda")
        out, lse = A.attention_reference(q, k, v, causal)
        delta = torch.einsum("bqhd,bqhd->bhq", out, do).contiguous()
        want = A.attention_bwd_reference(q, k, v, out, lse, do, causal)
        data[name] = (q, k, v, do, lse, delta, want, causal)
    dq_variants = {
        "n64_st2_mb2": dict(kBlockN=64, kStages=2, kMinBlocks=2),
        "n64_st3_mb1": dict(kBlockN=64, kStages=3, kMinBlocks=1),
        "n32_st3_mb2": dict(kBlockN=32, kStages=3, kMinBlocks=2),
        "n32_st4_mb2": dict(kBlockN=32, kStages=4, kMinBlocks=2),
    }
    dkv_variants = {
        "q64_st2_mb2": dict(kBlockQ=64, kStages=2, kMinBlocks=2),
        "q64_st3_mb1": dict(kBlockQ=64, kStages=3, kMinBlocks=1),
        "q32_st3_mb2": dict(kBlockQ=32, kStages=3, kMinBlocks=2),
        "q32_st4_mb2": dict(kBlockQ=32, kStages=4, kMinBlocks=2),
    }
    fns = {("dq", n): f for n, f in compile_variants(
        "flash_attn_bwd_dq_tf32x3.cu", {f"dq_{n}": v for n, v in dq_variants.items()},
        "vtt_flash_attn_bwd_dq_tf32x3").items()}
    fns |= {("dkv", n): f for n, f in compile_variants(
        "flash_attn_bwd_dkv_tf32x3.cu", {f"dkv_{n}": v for n, v in dkv_variants.items()},
        "vtt_flash_attn_bwd_dkv_tf32x3").items()}
    for rnd in range(2):
        for (which, n), fn in fns.items():
            if fn is None:
                continue
            line = []
            for name, (q, k, v, do, lse, delta, want, causal) in data.items():
                B, S, H, D = q.shape
                outs = [torch.empty(q.shape, device="cuda") for _ in range(1 if which == "dq" else 2)]

                def run():
                    # the stream of the call: a CUDA-graph capture runs on one of its own
                    stream = torch.cuda.current_stream().cuda_stream
                    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                              lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
                              B, H, H, S, S, D, *A._bwd_strides(q, k, v, do), int(causal), 0,
                              D ** -0.5, stream)
                    assert code == 0, code

                ms = c.graph_ms(run, launches=3, replays=5)
                ref = want[:1] if which == "dq" else want[1:]
                err = max((o - w).abs().max().item() / w.abs().max().item()
                          for o, w in zip(outs, ref))
                line.append(f"{name} {ms:.3f} ms (err {err:.1e})")
            print(f"[flash_bwd_fp32 round {rnd}] {n}: " + ", ".join(line), flush=True)
        for name, (q, k, v, do, lse, delta, want, causal) in data.items():
            B, S, H, D = q.shape
            dq_e, dk_e, dv_e = (torch.empty(q.shape, device="cuda") for _ in range(3))
            fma = (q, k, v, do, lse, delta, None, None)
            e_dq = c.graph_ms(lambda: A._bwd_launch(False, *fma, dq_e, None, causal, 0, D ** -0.5),
                              launches=3, replays=5)
            e_dkv = c.graph_ms(lambda: A._bwd_launch(True, *fma, dk_e, dv_e, causal, 0, D ** -0.5),
                               launches=3, replays=5)
            ql, kl, vl = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                out_l = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
            do_l = do.transpose(1, 2)
            lib = c.median_ms(
                lambda: torch.autograd.grad(out_l, (ql, kl, vl), do_l, retain_graph=True))
            print(f"[flash_bwd_fp32 round {rnd}] {name}: FMA flash_bwd_dq_kernel {e_dq:.3f} ms, "
                  f"flash_bwd_dkv_kernel {e_dkv:.3f} ms; SDPA's fp32 backward (efficient "
                  f"backend, dq + dk + dv) {lib:.3f} ms", flush=True)


def tune_w8_large():
    """The wgmma int8 matmul's tilings at the NLL forward's shapes (M = 8192)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    M = 8192
    data = {}
    for name, (K, N) in {"wqkv": (1280, 3840), "w2": (3584, 1280), "head": (1280, 8192)}.items():
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand(N, generator=gen, device="cuda") * 2e-3 + 1e-4
        data[name] = (x, w, s, QM.w8_matmul_reference(x, w.t(), s, True))
    # diagnostics: the same kernel without the int8 -> bf16 conversion (its
    # products read a stale tile), and without the products: what the loads
    # (and the conversion) take alone
    no_convert = [("for (int it = 0; it < kBlockN * 4 / kThreads; ++it) {\n"
                   "      const int i = threadIdx.x + it * kThreads, r = i / 4, c = i % 4;\n"
                   "      const uint4 v",
                   "for (int it = 0; it < 0; ++it) {\n"
                   "      const int i = threadIdx.x + it * kThreads, r = i / 4, c = i % 4;\n"
                   "      const uint4 v")]
    no_products = [("        wgmma_ss(acc[hh], desc_x", "        if (steps < 0) wgmma_ss(acc[hh], desc_x")]
    variants = {
        "n256_st4": dict(kBlockN=256, kStages=4),
        "n256_st5": dict(kBlockN=256, kStages=5),
        "n128_st6": dict(kBlockN=128, kStages=6),
        "n256_st4_no_products": dict(kBlockN=256, kStages=4, text=no_products),
        "n256_st4_loads_only": dict(kBlockN=256, kStages=4, text=no_products + no_convert),
    }
    fns = compile_variants("w8_matmul_sm90.cu", variants, "vtt_w8_matmul_sm90")
    for rnd in range(2):
        for n, fn in fns.items():
            if fn is None:
                continue
            line = []
            for name, (x, w, s, want) in data.items():
                (M, K), N = x.shape, w.shape[0]
                out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")

                def run():  # on the stream current at the call: graph_ms captures a side stream
                    code = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K, 1,
                              torch.cuda.current_stream().cuda_stream)
                    assert code == 0, code

                ms = c.graph_ms(run, launches=3)
                err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
                line.append(f"{name} {ms:.4f} ms (err {err:.1e})")
            print(f"[w8_large round {rnd}] {n}: " + ", ".join(line), flush=True)
        for name, (x, w, s, want) in data.items():
            (M, K), N = x.shape, w.shape[0]
            out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
            e = c.graph_ms(lambda: QM._w8_launch("w8_matmul_kernel", x, w, s, out, True), launches=3)
            lib = c.graph_ms(lambda: (x @ w.t().to(torch.bfloat16)) * s, launches=3)
            wb = w.to(torch.bfloat16)
            mm = c.graph_ms(lambda: x @ wb.t(), launches=3)
            print(f"[w8_large round {rnd}] {name}: earlier w8_matmul_kernel {e:.4f} ms, cuBLAS "
                  f"on a bf16 copy {lib:.4f} ms (the matmul alone {mm:.4f}), bound "
                  f"{2 * M * K * N / 989e9:.4f} ms", flush=True)


def tune_vq():
    VQ = importlib.import_module("video_tokenizer_tpu_torch.ops.vq")
    gen = torch.Generator(device="cuda").manual_seed(5)
    M = K = 8192
    z = torch.randn(M, 8, generator=gen, device="cuda")
    emb = torch.randn(K, 8, generator=gen, device="cuda")
    z, emb = z / z.norm(dim=-1, keepdim=True), emb / emb.norm(dim=-1, keepdim=True)
    src = "vq_lookup_sm90.cu"
    mt = "  static constexpr int kMT = D <= 8 && !kStochastic ? 2 : 1;"
    variants = {
        "base": {},
        "mt1": {"text": [(mt, mt.replace("D <= 8 && !kStochastic ? 2 : 1", "1"))]},
        "mt2": {"text": [(mt, mt.replace("D <= 8 && !kStochastic ? 2 : 1", "D <= 8 ? 2 : 1"))]},
        "warps4": dict(kWarps=4),
        "cluster4": dict(kCluster=4),
        "no_pick": {"text": [("if (__any_sync(0xffffffffu, up)) {",
                              "if (__any_sync(0xffffffffu, up) && p.M < 0) {")]},
        "no_mma": {"text": [
            ("mma_m16n8k8_tf32x3(acc[mt][h], ahi[mt][0], alo[mt][0], f.x, f.y, f.z, f.w);",
             "acc[mt][h][0] += __uint_as_float(f.x ^ ahi[mt][0][0]);")]},
    }
    fns = compile_variants(src, variants, "vtt_vq_argmax_sm90")
    want = VQ.vq_lookup_reference(z, emb)
    want_st = VQ.vq_lookup_reference(z, emb, stochastic=True, inv_temp=1 / 0.03, seed=11)
    idx = torch.empty(M, dtype=torch.int32, device="cuda")
    for rnd in range(2):
        for st in (0, 1):
            e_ms = c.graph_ms(lambda: VQ._vq_launch("vq_argmax_kernel", z, emb, None, idx, bool(st),
                                                    1 / 0.03, 11))
            line = [f"earlier {e_ms:.4f}"]
            for n, fn in fns.items():
                if fn is None:
                    continue

                def run():
                    code = fn(z.data_ptr(), emb.data_ptr(), None, idx.data_ptr(), M, K, 8, st,
                              1 / 0.03, 11, torch.cuda.current_stream().cuda_stream)
                    assert code == 0, code

                ms = c.graph_ms(run)
                run()
                wrong = int((idx != (want_st if st else want)).sum())
                line.append(f"{n} {ms:.4f} ({wrong} differ)")
            print(f"[vq {'gumbel' if st else 'argmax'} round {rnd}] " + ", ".join(line), flush=True)


def tune_vq_gemm():
    VQ = importlib.import_module("video_tokenizer_tpu_torch.ops.vq")
    gen = torch.Generator(device="cuda").manual_seed(6)
    K, d = 16384, 256
    emb = torch.randn(K, d, generator=gen, device="cuda") / 16
    bias = -0.5 * (emb**2).sum(-1)
    src = "vq_gemm_sm90.cu"
    lo_hi = "      for (int n = 0; n < kNT; ++n) mma_m16n8k8_tf32(t[n], alo, bhi[n][0], bhi[n][1]);"
    hi_lo = "      for (int n = 0; n < kNT; ++n) mma_m16n8k8_tf32(t[n], ahi, blo[n][0], blo[n][1]);"
    hi_hi = "      for (int n = 0; n < kNT; ++n) mma_m16n8k8_tf32(t[n], ahi, bhi[n][0], bhi[n][1]);"
    bsplit = ("        for (int h = 0; h < 2; ++h) split_tf32(b[n][h][ks], bhi[n][h], blo[n][h]);",
              "        for (int h = 0; h < 2; ++h) { bhi[n][h] = __float_as_uint(b[n][h][ks]); "
              "blo[n][h] = 0u; }")
    # one block of 8 warps over 128 rows an SM (d <= 384 then fits 227 KB)
    one_block = [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),
                 ('static_assert(2 * smem_bytes(256) <= 227 * 1024, "two blocks an SM at '
                  'SimVQ\'s d = 256");', "")]
    variants = {
        "base": {},
        "warps8": {"kWarps": 8, "kMaxDim": 384, "text": one_block},
        "stages2": dict(kStages=2),
        "one_product": {"text": [(lo_hi, "      {}"), (hi_lo, "      {}")]},
        "no_mma": {"text": [(lo_hi, "      {}"), (hi_lo, "      {}"),
                            (hi_hi, "      for (int n = 0; n < kNT; ++n) t[n][0] += "
                                    "__uint_as_float(bhi[n][0] ^ ahi[0] ^ blo[n][1] ^ alo[1]);")]},
        # diagnostics, wrong answers: no split of the codes, no barrier, no code loads
        "no_bsplit": {"text": [bsplit]},
        "no_sync": {"text": [("    __syncthreads();  // stage `it` is in", "    // stage `it` is in")]},
        "no_load": {"text": [("    if (it + kStages - 1 < total) load(it + kStages - 1);",
                              "    if (it + kStages - 1 < total && p.M < 0) load(it + kStages - 1);")]},
    }
    fns = compile_variants(src, variants, "vtt_vq_argmax_gemm")
    for M in (256, 2048, 8192):
        z = torch.randn(M, d, generator=gen, device="cuda") / 16
        want = VQ.vq_lookup_reference(z, emb, bias)
        idx = torch.empty(M, dtype=torch.int32, device="cuda")
        for rnd in range(2):
            lib = c.graph_ms(lambda: torch.addmm(bias, z, emb.T).argmax(-1), launches=5)
            line = [f"library {lib:.4f}"]
            for n, fn in fns.items():
                if fn is None:
                    continue

                def run():
                    code = fn(z.data_ptr(), emb.data_ptr(), bias.data_ptr(), idx.data_ptr(), M, K,
                              d, torch.cuda.current_stream().cuda_stream)
                    assert code == 0, code

                ms = c.graph_ms(run, launches=10)
                run()
                wrong = int((idx != want).sum())
                line.append(f"{n} {ms:.4f} ({wrong} differ)")
            print(f"[vq_gemm M={M} round {rnd}] " + ", ".join(line), flush=True)


# the decode and chunk kernels' entry points before the KV row write was fused in
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
PARENT_SIGNATURES = {
    "vtt_decode_attention_sm90": ([_P] * 11 + [_I] * 8 + [_LL, _F, _P], _I),
    "vtt_chunk_attention_sm90": ([_P] * 10 + [_I] * 9 + [_LL, _LL, _F, _P], _I),
}


def compare_parent(csrc_dir):
    """See the module docstring (`parent=DIR`)."""
    d = ROOT / "parent"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(Path(csrc_dir), d)
    lib = d / "lib.so"
    srcs = [str(d / "decode_attention_sm90.cu"), str(d / "chunk_attention_sm90.cu")]
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), *srcs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"parent: nvcc failed\n{proc.stdout}{proc.stderr}"[-3000:])
    res = _build.kernel_resources(proc.stdout + proc.stderr)
    print(f"[parent] regs/spills: { {k[-60:]: v for k, v in res.items() if 'attn' in k} }",
          flush=True)
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for name, (argtypes, restype) in PARENT_SIGNATURES.items():
        fns[name] = getattr(cdll, name)
        fns[name].argtypes, fns[name].restype = argtypes, restype
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, H, D, layers = 16, 1152, 20, 64, 30
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    for dt in (torch.bfloat16, torch.int8):
        lcs = []
        for _ in range(layers):
            lc = {}
            for n in ("k", "v"):
                x = torch.randn(B, S, H * D, generator=gen, device="cuda")
                if dt == torch.int8:
                    lc[n], lc[n + "s"] = DA._quantize_rows(x)
                else:
                    lc[n] = x.bfloat16()
            lcs.append(lc)
        for kind, G in (("decode", 1), ("chunk", 5)):
            qkv = torch.randn(B, G, 3 * H * D, generator=gen, device="cuda").bfloat16()
            q = qkv[..., : H * D].unflatten(-1, (H, D))
            rows_k, rows_v = qkv[..., H * D : 2 * H * D], qkv[..., 2 * H * D :]
            out = torch.empty(B, G, H, D, dtype=torch.bfloat16, device="cuda")
            hpb = DA.decode_heads_per_block(dt, H, H)
            for pos_val in (512, 1024):
                pos1 = torch.full((1,), pos_val, dtype=torch.int32, device="cuda")
                posb = pos1.expand(B).contiguous()

                def parent():
                    for lc in lcs:
                        if kind == "decode":
                            code = fns["vtt_decode_attention_sm90"](
                                q.data_ptr(), lc["k"].data_ptr(), lc["v"].data_ptr(), pos1.data_ptr(),
                                None, ptr(lc.get("ks")), ptr(lc.get("vs")), None, None, None,
                                out.data_ptr(), DA._CACHE_DTYPES[dt], B, H, H, S, D, 1, hpb,
                                q.stride(0), D ** -0.5, stream())
                        else:
                            code = fns["vtt_chunk_attention_sm90"](
                                q.data_ptr(), lc["k"].data_ptr(), lc["v"].data_ptr(), posb.data_ptr(),
                                None, ptr(lc.get("ks")), ptr(lc.get("vs")), None, None,
                                out.data_ptr(), DA._CACHE_DTYPES[dt], 1, B, G, H, H, S, D, 1,
                                q.stride(0), q.stride(1), D ** -0.5, stream())
                        assert code == 0, code

                def this():
                    for lc in lcs:
                        args = (lc["k"], lc["v"])
                        if kind == "decode":
                            DA._decode_launch("decode_attn_sm90_kernel", q[:, 0], *args, pos1, None,
                                              lc.get("ks"), lc.get("vs"), H, out[:, 0])
                        else:
                            DA._chunk_launch("chunk_attn_sm90_kernel", q, *args, posb, None,
                                             lc.get("ks"), lc.get("vs"), H, out)

                def fused():
                    for lc in lcs:
                        if kind == "decode":
                            DA.decode_attention_write(q[:, 0], rows_k, rows_v, lc, pos1, kv_heads=H)
                        else:
                            DA.chunk_attention_write(q, rows_k, rows_v, lc, posb, kv_heads=H)

                runs = {"parent": parent, "this": this, "fused": fused}
                times = {n: [] for n in runs}
                for n in ("parent", "this", "fused", "fused", "this", "parent"):
                    times[n].append(c.graph_ms(runs[n], launches=1, replays=5) / layers)
                print(f"[parent {kind} {str(dt)[6:]} pos {pos_val}] per layer, cold: "
                      + ", ".join(f"{n} {' / '.join(f'{t * 1e3:.2f}' for t in ts)} us"
                                  for n, ts in times.items()), flush=True)
        del lcs


def tune_flash_d80():
    """The wgmma forward at D = 80 (the V-JEPA2 teacher's B = 8, S = 2048,
    H = 16 in bf16): Q read from shared memory (the source's `kQSmem`) or
    held in registers as A fragments, each at two blocks an SM (the
    source's; registers capped at 128) and at one, beside SDPA (CUDA-graph
    replays, two rounds), with registers and spills. Three warpgroups a
    block do not build: ptxas cannot fit the D = 64 instance in 85
    registers."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(9)
    B, S, H, D = 8, 2048, 16, 80
    q, k, v = torch.randn(B, S, 3, H, D, generator=gen, device="cuda").bfloat16().unbind(2)
    want = A.attention_reference(q, k, v)[0].float()
    q_regs = ("kQSmem = kTail != 0;", "kQSmem = false;")
    variants = {
        "q_smem_mb2": dict(),
        "q_smem_mb1": dict(kMinBlocks=1),
        "q_regs_mb2": dict(text=[q_regs]),
        "q_regs_mb1": dict(kMinBlocks=1, text=[q_regs]),
    }
    fns = compile_variants("flash_attn_fwd_sm90.cu", variants, "vtt_flash_attn_fwd_sm90")
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    for rnd in range(2):
        for n, fn in fns.items():
            if fn is None:
                continue
            out = torch.empty(q.shape, dtype=torch.bfloat16, device="cuda")

            def run():
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, out.data_ptr(),
                          None, B, H, H, S, S, D, *strides, 0, 0, 0, D ** -0.5,
                          torch.cuda.current_stream().cuda_stream)
                assert code == 0, code

            ms = c.graph_ms(run, launches=10)
            err = (out.float() - want).abs().max().item() / want.abs().max().item()
            print(f"[flash_d80 round {rnd}] {n}: {ms:.4f} ms (err {err:.1e})", flush=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = c.graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), launches=10)
        print(f"[flash_d80 round {rnd}] SDPA {lib:.4f} ms; bound "
              f"{c.bound(4 * 2 * B * S * H * D, 4 * B * H * S * S * D)['bound_ms']:.4f} ms",
              flush=True)


if __name__ == "__main__":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.library()
    which = sys.argv[1:] or ["dq", "chunk", "decode", "w8", "w8_step", "flash_fp32", "w8_large",
                             "flash_bwd_fp32"]
    for arg in which:
        if arg.startswith("parent="):
            compare_parent(arg.split("=", 1)[1])
    if "vq" in which:
        tune_vq()
    if "vq_gemm" in which:
        tune_vq_gemm()
    if "flash_d80" in which:
        tune_flash_d80()
    if "flash_bwd_fp32" in which:
        tune_flash_bwd_fp32()
    if "flash_fp32" in which:
        tune_flash_fp32()
    if "w8_large" in which:
        tune_w8_large()
    if "w8_step" in which:
        tune_w8_step()
    if "w8" in which:
        tune_w8()
    if "decode" in which:
        tune_decode()
    if "chunk" in which:
        tune_chunk()
    if "dq" in which:
        tune_dq()
