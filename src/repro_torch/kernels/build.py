"""Build and load the port's hand-written CUDA kernels.

The sources under ``src/repro_torch/csrc/`` have a plain C interface.  At
first use, ``load_library`` compiles each ``.cu`` with its own ``nvcc``
process (all started together), links the objects into one shared library
under ``build/kernels/`` keyed by a hash of the sources, and loads it with
``ctypes``.  Nothing here runs at import: the CPU tests import every module
and have no ``nvcc``.

Every pointer and the stream cross the boundary as ``ctypes.c_void_p``;
each C entry point returns ``cudaGetLastError()`` and :func:`check` raises
when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (restype int: a cudaError_t).
SIGNATURES = {
    "flash_attention_launch": (_P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "cosine_topk_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "cosine_topk_gather_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "cosine_topk_gather_wave_clusters": (_I, _I, _P),
    "decode_attention_block_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "panel_mma_wave_clusters": (_I, _I, _I, _P),
    "panel_mma_wave_clusters_dh256": (_I, _I, _I, _P),
    "paged_decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "paged_decode_attention_block_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                            _I, _F, _P),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_PER_BLOCK = 232_448   # bytes of shared memory one block may use on an H100


def smem_row_bytes(dh: int) -> int:
    """Bytes of a bf16 row of ``dh`` in a shared-memory tile: whole groups of
    8 16-byte chunks, so the XOR swizzle stays inside the row (mma.cuh's
    ``row_bytes``; dh 80 sits in 128 columns)."""
    return -(-dh // 64) * 64 * 2

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
builds = 0
"""Kernel libraries built or loaded in this process (a plain count)."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the port's kernels")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(lib_path: Path) -> None:
    """nvcc each source in parallel, then link one shared library; the
    compiler's output (ptxas registers and shared memory per kernel) goes to
    a ``.log`` beside it."""
    nvcc = _nvcc()
    cu, _ = _sources()
    obj_dir = lib_path.parent / f"obj_{lib_path.stem}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in cu:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = lib_path.with_suffix(".so.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link (rc {link.returncode})\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + "\n".join(log))
    lib_path.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, lib_path)


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources on first use."""
    global _lib, build_seconds, builds
    if _lib is not None:
        return _lib
    builds += 1
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libreprotorch_{_source_hash()}.so"
    if not lib_path.exists():
        _compile(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


# hostsync: ok parses the ptxas log, no tensor
def kernel_resources(log_text: Optional[str] = None) -> dict:
    """{kernel: {"registers", "smem_bytes", "stack_bytes", "spill_bytes"}} from
    the ptxas output of the last build (the ``.log`` beside the library);
    ``smem_bytes`` is static shared memory, the dynamic part is the
    wrapper's.  Names are demangled with ``c++filt`` where it exists."""
    if log_text is None:
        logs = sorted(BUILD_DIR.glob("libreprotorch_*.log"), key=lambda f: f.stat().st_mtime)
        if not logs:
            return {}
        log_text = logs[-1].read_text()
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "smem_bytes": 0, "stack_bytes": 0,
                         "spill_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name]["stack_bytes"] = int(m.group(1))
            out[name]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return _demangled(out)


def sass_opcodes(opcodes=("HMMA", "HGMMA", "LDSM", "LDGSTS", "SHFL")) -> dict:
    """{kernel: {opcode: count}} from ``cuobjdump -sass`` of the built
    library: which instructions each kernel was compiled to (tensor-core
    products, ldmatrix, cp.async, shuffles).  Empty without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = sorted(BUILD_DIR.glob("libreprotorch_*.so"), key=lambda f: f.stat().st_mtime)
    if not libs or not os.path.exists(tool):
        return {}
    res = subprocess.run([tool, "-sass", str(libs[-1])], capture_output=True, text=True)
    return count_opcodes(res.stdout, opcodes)


def count_opcodes(sass: str, opcodes) -> dict:
    """{kernel: {opcode: count}} of a ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = {op: 0 for op in opcodes}
        elif name is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if m and m.group(1) in out[name]:
                out[name][m.group(1)] += 1
    return _demangled(out)


def _demangled(by_name: dict) -> dict:
    """Re-key a {mangled kernel name: value} dict by short demangled names
    where ``c++filt`` exists."""
    filt = shutil.which("c++filt")
    if filt and by_name:
        names = list(by_name)
        res = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            return {_short(d): by_name[n] for n, d in zip(names, res.stdout.splitlines())}
    return by_name


def _short(demangled: str) -> str:
    """'void ns::(anonymous namespace)::k<float, 64>(args)' -> 'k<float, 64>'."""
    d = demangled.replace("(anonymous namespace)::", "")
    d = d[5:] if d.startswith("void ") else d
    depth, cut, start = 0, len(d), 0
    for pos, ch in enumerate(d):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = pos
            break
        elif ch == ":" and depth == 0 and d[pos:pos + 2] == "::":
            start = pos + 2
    return d[start:cut]


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(device: torch.device, entry, *args) -> int:
    """Call a library entry ``entry(*args, stream)`` on ``device``'s current
    stream with ``device`` current: the runtime launches on the current
    device, and a stream of another device is an invalid handle there."""
    with torch.cuda.device(device):
        return entry(*args, stream_ptr(device))


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev
