"""Build, load and count the hand-written CUDA kernels.

The sources in ``vibertgrid_tpu_torch/csrc/`` are compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface and
loaded with ``ctypes``. Nothing is built at import: :func:`library` builds
at first use, one ``nvcc`` per source, all started together, then links.
The build lands in ``build/vibertgrid_tpu_torch/<hash>/`` at the repo root,
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the cached library.

Every kernel wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel, and nowhere else, so a caller can show which kernels a
run went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from vibertgrid_tpu_torch.ops.dropout import seed_i32

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vibertgrid_tpu_torch"
SOURCES = (
    "flash_attention.cu", "flash_attention_bwd.cu", "fused_ffn.cu", "fused_proj_ln.cu",
    "bertgrid_scatter.cu", "bertgrid_scatter_bwd.cu", "fused_update.cu", "errors.cu",
)
HEADERS = ("common.cuh", "ffn_down_ln.cuh", "wgmma.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libvibertgrid_kernels.so"

# Launches per kernel since the last reset_launch_counts().
LAUNCHES = {
    "flash_attention": 0, "flash_attention_bwd": 0, "fused_ffn": 0, "fused_ffn_saved": 0,
    "fused_proj_ln": 0, "bertgrid_scatter": 0, "bertgrid_scatter_bwd": 0, "grad_sq_norm": 0,
    "dual_update": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_DROPOUT = [_I, _P, _U, _F]  # on, seed (a device pointer), threshold, scale: see dropout_args()
_SIGNATURES = {
    # q, k, v, bias, out, lse, B, T, H, D, scale, dtype, dropout..., stream
    "vg_flash_attention": [_P] * 6 + [_I, _I, _I, _I, _F, _I, *_DROPOUT, _P],
    # q, k, v, bias, d_out, lse, dq, dk, dv, d_bias_part, delta, B, T, H, D, scale, dtype,
    # dropout..., stream
    "vg_flash_attention_bwd": [_P] * 11 + [_I, _I, _I, _I, _F, _I, *_DROPOUT, _P],
    # x, w1, b1, w2, b2, gamma, beta, out, h1, yhat, rsig, h, N, D, F, eps, dtype,
    # dropout..., stream
    "vg_fused_ffn": [_P] * 12 + [_I, _I, _I, _F, _I, *_DROPOUT, _P],
    # ctx, res, w, b, gamma, beta, out, N, D, eps, dtype, dropout..., stream
    "vg_fused_proj_ln": [_P] * 7 + [_I, _I, _F, _I, *_DROPOUT, _P],
    # emb, boxes, mask, out, B, S, row_bytes, height, width, stride, stream
    "vg_bertgrid_scatter": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # d_out, boxes, mask, d_emb, cells, offsets, partials, counters, B, S, D, height, width,
    # stride, piece, dtype, stream
    "vg_bertgrid_scatter_bwd": [_P] * 8 + [_I] * 8 + [_P],
    # desc, n_rows, n_chunks, partials, out, stream
    "vg_grad_sq_norm": [_P, _I, _I, _P, _P, _P],
    # desc, n_rows, n_chunks, table, count, last, scale, momentum, beta1, 1 - beta1, beta2,
    # 1 - beta2, eps, stream
    "vg_dual_update": [_P, _I, _I, _P, _P, _I, _P] + [_F] * 6 + [_P],
}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless the cached library for these sources
    exists; returns its path. Each source's compiler output (with the
    ``-Xptxas -v`` register and shared-memory report) is kept beside the
    objects as ``<source>.log``."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in SOURCES:
        obj = out_dir / (name + ".o")
        log = open(out_dir / (name + ".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        jobs.append((name, obj, log, subprocess.Popen(cmd, stdout=log, stderr=log)))
    failed = []
    for name, _, log, proc in jobs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        logs = "\n".join((out_dir / (n + ".log")).read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(j[1]) for j in jobs)],
        check=True,
    )
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.vg_error_string.argtypes = [ctypes.c_int]
        lib.vg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    if err != 0:
        msg = library().vg_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel failed: CUDA error {err} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def seed_tensor(seed, device) -> torch.Tensor:
    """The seed of a kernel's dropout as the kernels read it: a 0-d int32
    tensor on ``device``. A tensor seed (a slot of the train step's seed
    tensor, which a replayed CUDA graph refills) is used as it is; an int is
    written there by a fill, wrapped to int32, with no copy from the host."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.dim() != 0 or seed.device != device:
            raise ValueError(f"a seed tensor must be 0-d int32 on {device}, got "
                             f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
        return seed
    return torch.full((), seed_i32(seed), dtype=torch.int32, device=device)


def dropout_args(seed: torch.Tensor | None, rate: float,
                 scale: float) -> tuple[int, int | None, int, float]:
    """The kernels' dropout arguments ``(on, seed, threshold, scale)``: an
    element is kept where its hash reaches ``int(rate·2³²)``, compared
    unsigned; ``seed`` is the address of the 0-d int32 tensor
    (:func:`seed_tensor`) that the kernel reads when it runs, so the caller
    keeps the tensor alive across the call."""
    if rate <= 0.0:
        return 0, None, 0, 1.0
    return 1, seed.data_ptr(), int(rate * float(2**32)), scale


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Check that the tensors are on one device, contiguous and 16-byte
    aligned (the kernels move rows with 16-byte vector copies)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
