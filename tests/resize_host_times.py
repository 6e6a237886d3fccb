"""Host time of the port's page resize against the JAX package's C++ host op.

    python tests/resize_host_times.py [--tree DIR] [--threads N]

Times ``vibertgrid_tpu_torch.data.transform.resize_normalize_into`` (from
this checkout, or from the checkout at ``--tree``) and
``vibertgrid_tpu.data.native.bilinear_resize_norm_into`` on the serving
pages of ``chip_smoke.py`` (1100x850 to 662x512, 1250x800 to 800x512) and a
larger scan (2000x1400 to 731x512): the median of 20 calls each, after one
call that is not counted, on one 704 x 512 or 832 x 512 canvas. Checks that
both give the same bits. Needs the JAX package's native library
(``csrc/build.sh``), so it runs where the CPU tests run, not on the card's
machine.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = (((1100, 850), (662, 512)), ((1250, 800), (800, 512)), ((2000, 1400), (731, 512)))


def _port_resize(tree: str):
    path = os.path.join(tree, "vibertgrid_tpu_torch", "data", "transform.py")
    spec = importlib.util.spec_from_file_location("_port_transform", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module.resize_normalize_into


def _median_ms(fn, reps: int = 20) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--threads", type=int, default=torch.get_num_threads())
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)
    from vibertgrid_tpu.data import native

    if not native.native_available():
        print("the native host op is not built (csrc/build.sh)", file=sys.stderr)
        return 1
    torch.set_num_threads(args.threads)
    port = _port_resize(os.path.abspath(args.tree))
    mean = np.asarray([0.9248, 0.9224, 0.9215], np.float32)
    std = np.asarray([0.1532, 0.1545, 0.1536], np.float32)
    rng = np.random.default_rng(0)
    lines = []
    for (h, w), (oh, ow) in PAGES:
        image = rng.random((h, w, 3)).astype(np.float32)
        got = np.zeros((-(-oh // 64) * 64, 512, 3), np.float32)
        want = np.zeros_like(got)
        port_ms = _median_ms(lambda: port(image, got, oh, ow, mean, std))
        native_ms = _median_ms(lambda: native.bilinear_resize_norm_into(image, want, oh, ow,
                                                                         mean, std))
        if not np.array_equal(got, want):
            raise AssertionError(f"{h}x{w}: the port's resize differs from the native op")
        lines.append(f"{h}x{w} -> {oh}x{ow}: port {port_ms:.2f} ms, native {native_ms:.2f} ms "
                     f"({port_ms / native_ms:.2f}x)")
    print(f"resize + normalize of one page, {args.tree}, torch threads {args.threads}, "
          f"{os.cpu_count()} cores: " + "; ".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
