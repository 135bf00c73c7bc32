"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc`, all of them started
together, and the objects are linked into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes) for
`sm_90a`. The library lands in `build/torch_kernels/<hash>/`
under the checkout, keyed by a hash of the sources, the headers they include
(`csrc/*.cuh`) and the flags, so an edited kernel or header is rebuilt and an
unchanged one is reused. Importing this module builds nothing and needs no
`nvcc`: the first kernel launch does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libvtt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)


class Build(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str


def _sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def source_digest(csrc: Path = CSRC) -> str:
    """Hash of everything the library is built from: the flags, every
    `*.cu` source and every `*.cuh` header of `csrc`, by name and bytes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(csrc), *csrc.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built on this machine"
    )


def build() -> Build:
    """Compiles csrc/*.cu unless a library for these sources and headers exists."""
    out_dir = BUILD_ROOT / source_digest()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib_path.exists():
        return Build(lib_path, 0.0, log_path.read_text() if log_path.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", None
    for cmd, _, proc in compiles:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
    if failed is None:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in compiles)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
    for _, obj, _ in compiles:
        obj.unlink(missing_ok=True)
    if failed is not None:
        raise RuntimeError(failed)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a library
    return Build(lib_path, seconds, log)


def kernel_resources(log: str) -> dict[str, tuple[int, int]]:
    """{mangled kernel name: (registers, spill bytes)} from a build's
    `-Xptxas -v` output (spill bytes: stores + loads)."""
    found, name, spills = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], 0
        elif "bytes spill stores" in line:
            spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", line))
        elif name is not None and (m := re.search(r"Used (\d+) registers", line)):
            found[name] = (int(m.group(1)), spills)
            name = None
    return found


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# (argtypes, restype) of every `extern "C"` entry point in csrc/. Pointers and
# the stream are c_void_p: without a declaration ctypes would pass them as
# 32-bit ints. tests/test_torch_ops.py checks this table against the sources.
SIGNATURES = {
    "vtt_flash_attn_fwd": ([_P] * 7 + [_I] * 7 + [_LL] * 9 + [_I, _I, _F, _P], _I),
    "vtt_flash_attn_fwd_sm90": ([_P] * 7 + [_I] * 6 + [_LL] * 9 + [_I, _I, _I, _F, _P], _I),
    "vtt_flash_attn_fwd_tf32x3": ([_P] * 7 + [_I] * 6 + [_LL] * 9 + [_I, _I, _I, _F, _P], _I),
    "vtt_flash_attn_bwd": ([_I] + [_P] * 10 + [_I] * 7 + [_LL] * 12 + [_I, _I, _F, _P], _I),
    "vtt_flash_attn_bwd_dkv_sm90": ([_P] * 8 + [_I] * 6 + [_LL] * 12 + [_I, _I, _F, _P], _I),
    "vtt_vq_argmax": ([_P] * 4 + [_I] * 4 + [_F, _LL, _P], _I),
    "vtt_vq_argmax_sm90": ([_P] * 4 + [_I] * 4 + [_F, _LL, _P], _I),
    "vtt_vq_argmax_gemm": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "vtt_decode_attention": ([_P] * 10 + [_I] * 8 + [_LL, _F, _P], _I),
    "vtt_decode_attention_sm90": ([_P] * 13 + [_I] * 9 + [_LL, _LL, _F, _P], _I),
    "vtt_w8_matmul": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "vtt_w8_matmul_stream": ([_P] * 4 + [_I] * 7 + [_P], _I),
    "vtt_w8_matmul_sm90": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "vtt_chunk_attention": ([_P] * 10 + [_I] * 9 + [_LL, _LL, _F, _P], _I),
    "vtt_chunk_attention_sm90": ([_P] * 12 + [_I] * 10 + [_LL] * 4 + [_F, _P], _I),
    "vtt_flash_attn_bwd_dq_sm90": ([_P] * 7 + [_I] * 6 + [_LL] * 12 + [_I, _I, _F, _P], _I),
    "vtt_flash_attn_bwd_dq_tf32x3": ([_P] * 7 + [_I] * 6 + [_LL] * 12 + [_I, _I, _F, _P], _I),
    "vtt_flash_attn_bwd_dkv_tf32x3": ([_P] * 8 + [_I] * 6 + [_LL] * 12 + [_I, _I, _F, _P], _I),
    "vtt_write_rows": ([_P] * 7 + [_I] * 6 + [_LL, _LL, _P], _I),
    "vtt_error_string": ([_I], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernels, with every C entry point's signature declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check(code: int, kernel: str) -> None:
    """Raises if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = library().vtt_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch: {msg}")
