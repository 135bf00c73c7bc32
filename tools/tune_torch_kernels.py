"""Times tilings of the two Hopper kernels whose tiling is a set of constants.

  python3 tools/tune_torch_kernels.py [chunk] [dq]     (needs one CUDA device and nvcc)

`csrc/chunk_attention_sm90.cu` and `csrc/flash_attn_bwd_dq_sm90.cu` fix their
tiling in `constexpr int` constants at the head of the file. This script
copies `csrc/` to `build/variants/<name>/`, substitutes the constants of each
variant below in the copy, compiles that one source with the port's nvcc
flags into a library of its own, binds the entry point with the port's
signature table, and times every variant in one process on one card, beside
the earlier kernel, with its registers, spill bytes and its error against the
plain version (chunk) or the earlier kernel (dQ): the chunk kernel for 1, 2,
3, 4 and 6 splits of the cache at the verify and draft shapes of the 632M
prior at positions 1024 and 512 (CUDA-graph replays), the dQ kernel at the
tokenizer's, the discriminator's and the prior's causal shape (CUDA events,
two rounds). Nothing here is used by the port; the sources keep one tiling.
"""
import ctypes
import importlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as c  # noqa: E402  (median_ms, graph_ms)
from video_tokenizer_tpu_torch.ops import _build  # noqa: E402

# the ops package exports functions under its modules' names
A = importlib.import_module("video_tokenizer_tpu_torch.ops.attention")
DA = importlib.import_module("video_tokenizer_tpu_torch.ops.decode_attention")

ROOT = REPO / "build" / "variants"
CSRC = _build.CSRC


def compile_variant(name, source, subs, entry):
    """Builds `source` of a copy of csrc/ with the `constexpr int` constants of
    `subs` replaced; returns the bound entry point, or None if nvcc refuses it."""
    d = ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    text = (d / source).read_text()
    for key, val in subs.items():
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
                                  po.data_ptr(), pm.data_ptr(), out.data_ptr(), DA._CACHE_DTYPES[k.dtype], 1,
                                  B, G, H, H, S, D, n_splits, q.stride(0), q.stride(1), D ** -0.5,
                                  torch.cuda.current_stream().cuda_stream)
                        assert code == 0, code

                    ms = c.graph_ms(run)
                    err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
                    line.append(f"s{n_splits} {ms:.4f} ({err:.0e})")
                print(f"[chunk pos {pos_val}] {name} {n}: " + ", ".join(line), flush=True)


if __name__ == "__main__":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.library()
    which = sys.argv[1:] or ["dq", "chunk"]
    if "chunk" in which:
        tune_chunk()
    if "dq" in which:
        tune_dq()
