"""ctypes bindings for the port's host-side data ops (``csrc/host_ops.cpp``).

The collate's hot loop (port of ``vibertgrid_tpu/data/native.py``): the
page resize with its normalization, straight into the padded canvas, on the
host's cores. The functions keep the JAX module's names and argument
contracts; their plain versions are ``data/transform.py``'s
``resize_normalize_into`` / ``bilinear_resize`` and
``ops/rasterize.py::box_winner_map``, which the tests hold them to bit for
bit.

Nothing is built at import. :func:`library` compiles the source at first use
with ``g++`` (or ``c++``) from ``PATH`` into
``build/vibertgrid_tpu_torch/host/<hash>/`` at the repo root, keyed by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one loads the cached library. The library is written under a temporary name
and renamed into place, so processes that build at once each load a whole
file. There is no fallback: a failed build raises with the compiler's log.

The calls go through ``ctypes.CDLL``, which releases the GIL while the C
function runs, so the collator's thread pool resizes pages in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host_ops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vibertgrid_tpu_torch" / "host"
# -ffp-contract=off: no fused multiply-add, so the resize keeps its plain
# version's bits on every host (see the source's header)
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]
LIB_NAME = "libvibertgrid_host.so"

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the host ops need one")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the host ops unless the cached library for this source
    exists; returns its path."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded host-ops library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            c = ctypes.c_int
            signatures = {
                "bilinear_resize_f32": [f32p, c, c, c, f32p, c, c],
                "bilinear_resize_norm_f32": [f32p, c, c, c, f32p, c, c, f32p, f32p],
                "bilinear_resize_norm_strided_f32": [f32p, c, c, c, f32p, c, c, ctypes.c_long,
                                                     f32p, f32p],
                "rasterize_winner_i32": [i32p, u8p, c, i32p, c, c, c],
                "pad_batch_f32": [f32p, c, c, c, f32p, c, c, c],
            }
            for name, argtypes in signatures.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = None
            _lib = lib
    return _lib


def _page(image: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(image, np.float32)
    if src.ndim != 3 or 0 in src.shape:
        raise ValueError(f"expected a non-empty [H, W, C] image, got shape {image.shape}")
    return src


def _channels(values, c: int, what: str) -> np.ndarray:
    out = np.ascontiguousarray(values, np.float32).reshape(-1)
    if out.shape != (c,):
        raise ValueError(f"{what} has {out.size} values for {c} channels")
    return out


def _check_size(out_h: int, out_w: int) -> None:
    if out_h < 1 or out_w < 1:
        raise ValueError(f"output size {out_h}x{out_w} is empty")


def bilinear_resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Torch-semantics bilinear resize, ``image [H, W, C]`` -> ``[out_h,
    out_w, C]`` float32."""
    src = _page(image)
    h, w, c = src.shape
    if (h, w) == (out_h, out_w):
        return src
    _check_size(out_h, out_w)
    dst = np.empty((out_h, out_w, c), np.float32)
    library().bilinear_resize_f32(src, h, w, c, dst, out_h, out_w)
    return dst


def bilinear_resize_norm(image: np.ndarray, out_h: int, out_w: int, mean: np.ndarray,
                         std: np.ndarray) -> np.ndarray:
    """Fused bilinear resize and per-channel normalization, ``(resize(image)
    - mean) * (1 / std)``, in one pass."""
    src = _page(image)
    h, w, c = src.shape
    _check_size(out_h, out_w)
    dst = np.empty((out_h, out_w, c), np.float32)
    library().bilinear_resize_norm_f32(src, h, w, c, dst, out_h, out_w,
                                       _channels(mean, c, "mean"), _channels(std, c, "std"))
    return dst


def rasterize_winner(boxes: np.ndarray, mask: np.ndarray, h: int, w: int,
                     stride: int = 1) -> np.ndarray:
    """``[h, w]`` int32: 0 where no valid box covers the cell, else 1 + the
    index of the last covering valid box (``ops/rasterize.py::box_winner_map``
    for non-negative boxes)."""
    boxes = np.ascontiguousarray(boxes, np.int32).reshape(-1, 4)
    mask = np.ascontiguousarray(mask, np.uint8).reshape(-1)
    if len(mask) != len(boxes):
        raise ValueError(f"{len(boxes)} boxes and {len(mask)} mask entries")
    if stride < 1 or h < 0 or w < 0:
        raise ValueError(f"stride {stride}, size {h}x{w}")
    out = np.empty((h, w), np.int32)
    library().rasterize_winner_i32(boxes, mask, len(boxes), out, h, w, stride)
    return out


def _check_canvas(dst: np.ndarray, out_h: int, out_w: int, c: int) -> None:
    if not (isinstance(dst, np.ndarray) and dst.dtype == np.float32
            and dst.flags["C_CONTIGUOUS"] and dst.ndim == 3):
        raise ValueError("the canvas must be a C-contiguous float32 [bh, bw, C] array")
    if dst.shape[2] != c or dst.shape[0] < out_h or dst.shape[1] < out_w:
        raise ValueError(f"canvas {dst.shape} cannot hold {out_h}x{out_w}x{c}")


def bilinear_resize_norm_into(image: np.ndarray, dst: np.ndarray, out_h: int, out_w: int,
                              mean: np.ndarray, std: np.ndarray) -> None:
    """Fused resize and normalization written straight into the top-left
    ``[out_h, out_w]`` of the canvas ``dst [bh, bw, C]`` (float32,
    C-contiguous); the rest of ``dst`` is left as it is, so no pad copy
    follows."""
    src = _page(image)
    h, w, c = src.shape
    _check_size(out_h, out_w)
    _check_canvas(dst, out_h, out_w, c)
    library().bilinear_resize_norm_strided_f32(
        src, h, w, c, dst, out_h, out_w, dst.shape[1] * c,
        _channels(mean, c, "mean"), _channels(std, c, "std"))


def pad_into(image: np.ndarray, dst: np.ndarray) -> None:
    """Copy ``image [h, w, C]`` into the top-left of ``dst [bh, bw, C]``
    (zeroed by the caller)."""
    src = _page(image)
    h, w, c = src.shape
    _check_canvas(dst, h, w, c)
    library().pad_batch_f32(src, h, w, c, dst, dst.shape[0], dst.shape[1], 0)
