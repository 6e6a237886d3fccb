"""Smoke run of the PyTorch/CUDA port (``vibertgrid_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. builds the hand-written kernels from ``vibertgrid_tpu_torch/csrc``
   (``sm_90a``) into ``build/vibertgrid_tpu_torch/``;
2. holds each kernel against its plain PyTorch twin on the card, in bf16,
   at the shapes of the flagship forward, and times kernel, twin and, where
   one PyTorch call computes the same function, that call;
3. drives the flagship inference forward (BERT-base-uncased, ResNet-34-FPN,
   simplified head, bf16; batch 16, 512x384 images, one 510-token window,
   128 segments) through the port's entry points, checks its output and
   that it launched every kernel (12 attention, 12 FFN, 1 scatter), and
   reports docs/s and where the device time went;
4. runs the same forward in fp32 at batch 2 on the card (kernels) and on
   the host CPU (twins) from one set of weights and compares them.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
B, H, W, T, S, VOCAB = 16, 512, 384, 510, 128, 30522

# Kernel vs twin tolerances, bf16 on the card. The twin rounds and sums in
# another order than the kernel (fp32 either way), so a bf16 output can
# differ by an ulp or two: 2 ulps of bf16 is 2^-6 relative.
ATTN_TOL = dict(atol=2 ** -6, rtol=2 ** -6)   # outputs are averages of N(0,1) values
FFN_TOL = dict(atol=2 ** -5, rtol=2 ** -6)    # LayerNorm outputs up to ~5
# fp32 forward, card (kernels, cuDNN) vs host (twins): the same fp32
# arithmetic summed in other orders through ~50 layers.
FP32_FORWARD_ATOL = 1e-3


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _assert_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"{name}: kernel differs from twin, max err {err.max().item():.3e} "
            f"(atol {atol}, rtol {rtol})"
        )


def check_attention(dev):
    from vibertgrid_tpu_torch.ops.flash_attention import attention_reference, flash_attention

    g = torch.Generator(device=dev).manual_seed(1)
    nh, dh = 12, 64
    # A ragged T (not a multiple of the 64-key tile) with padded keys.
    for b, t in ((2, 130), (B, T + 2)):
        q, k, v = (torch.randn(b, t, nh * dh, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
        if t == T + 2:  # the flagship batch: 384 tokens + [CLS] + [SEP] valid
            lengths.fill_(3 * S + 2)
        valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
        bias = torch.where(valid, 0.0, -1e9).float()
        args = (q, k, v, bias, dh ** -0.5, nh)
        got, want = flash_attention(*args), attention_reference(*args)
        torch.cuda.synchronize()
        _assert_close(f"attention T={t}", got, want, **ATTN_TOL)
    err = _max_err(got, want)
    qh, kh, vh = (x.view(b, t, nh, dh).transpose(1, 2) for x in (q, k, v))
    mask = valid[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    _assert_close("sdpa yardstick", sdpa().transpose(1, 2).reshape(b, t, -1), want,
                  atol=4 * 2 ** -6, rtol=4 * 2 ** -6)
    ms = _time_ms(lambda: flash_attention(*args))
    plain_ms = _time_ms(lambda: attention_reference(*args))
    library_ms = _time_ms(sdpa)
    bound_ms, bound_by = _bound(4 * b * nh * t * t * dh, 4 * q.numel() * 2 + bias.numel() * 4)
    return dict(name="flash_attention", route="cuda",
                source="vibertgrid_tpu_torch/csrc/flash_attention.cu",
                replaces="vibertgrid_tpu/ops/flash_attention.py:99",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_ffn(dev):
    from vibertgrid_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn

    g = torch.Generator(device=dev).manual_seed(2)
    d, f = 768, 3072
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    w1 = (randn(f, d) * d ** -0.5).bfloat16()
    w2 = (randn(d, f) * f ** -0.5).bfloat16()
    b1, b2 = randn(f) * 0.1, randn(d) * 0.1
    gamma, beta = 1 + 0.1 * randn(d), 0.1 * randn(d)
    # A row count that is not a multiple of the 32-row block, then the flagship's.
    for n in (200 - 5, B * (T + 2)):
        x = randn(n, d).bfloat16()
        args = (x, w1, b1, w2, b2, gamma, beta, 1e-12)
        got, want = fused_ffn(*args), ffn_reference(*args)
        torch.cuda.synchronize()
        _assert_close(f"fused_ffn N={n}", got, want, **FFN_TOL)
    ms = _time_ms(lambda: fused_ffn(*args))
    plain_ms = _time_ms(lambda: ffn_reference(*args))
    nbytes = (2 * n * d + 2 * d * f) * 2 + (f + 3 * d) * 4
    bound_ms, bound_by = _bound(4 * n * d * f, nbytes)
    return dict(name="fused_ffn", route="cuda", source="vibertgrid_tpu_torch/csrc/fused_ffn.cu",
                replaces="vibertgrid_tpu/ops/fused_ffn.py:126", max_abs_err=_max_err(got, want),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_scatter(dev):
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter
    from vibertgrid_tpu_torch.ops.rasterize import bertgrid_scatter

    batch = make_batch(B, H, W, T, S, VOCAB, seed=3, device=dev)
    boxes = batch.boxes.clone()
    edge = lambda *xyxy: torch.tensor(xyxy, dtype=boxes.dtype, device=dev)
    boxes[:, 0] = edge(0, 0, W, H)                 # the whole page
    boxes[:, 1] = edge(W - 40, H - 20, W, H)       # the bottom-right corner
    boxes[:, 2] = edge(W - 16, 8, W + 64, 40)      # past the right edge
    boxes[:, 3] = edge(3, 5, 11, 9)                # inside a single cell
    mask = batch.box_mask.clone()
    mask[:, 5::7] = False                                # masked boxes
    g = torch.Generator(device=dev).manual_seed(3)
    emb = torch.randn(B, S, 768, generator=g, device=dev).bfloat16()
    kw = dict(height=H // 8, width=W // 8, stride=8)
    got, want = grid_scatter(emb, boxes, mask, **kw), bertgrid_scatter(emb, boxes, mask, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"bertgrid_scatter: kernel differs from twin, max err {_max_err(got, want)}")
    ms = _time_ms(lambda: grid_scatter(emb, boxes, mask, **kw))
    plain_ms = _time_ms(lambda: bertgrid_scatter(emb, boxes, mask, **kw))
    nbytes = got.numel() * 2 + emb.numel() * 2 + boxes.numel() * 4 + mask.numel()
    bound_ms, bound_by = _bound(0, nbytes)
    return dict(name="bertgrid_scatter", route="cuda",
                source="vibertgrid_tpu_torch/csrc/bertgrid_scatter.cu",
                replaces="vibertgrid_tpu/ops/pallas_scatter.py:39", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def flagship_forward(dev, records):
    from vibertgrid_tpu_torch.entry import FLAGSHIP, make_batch
    from vibertgrid_tpu_torch.models import ViBERTgridNet
    from vibertgrid_tpu_torch.ops import kernels

    model = ViBERTgridNet(
        FLAGSHIP, device=dev, generator=torch.Generator(device=dev).manual_seed(0)
    ).eval()
    batch = make_batch(B, H, W, T, S, VOCAB, seed=0, device=dev)

    kernels.reset_launch_counts()
    pred = model(batch).pred_label
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {"flash_attention": 12, "fused_ffn": 12, "bertgrid_scatter": 1}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected {want}")
    for r in records:
        r["launches"] = launches[r["name"]]
    if pred.shape != (B, S, 5) or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"pred_label bad: shape {tuple(pred.shape)}")
    row_err = (pred.sum(-1) - 1).abs().max().item()
    if row_err > 1e-5:
        raise AssertionError(f"pred_label rows do not sum to 1 (max err {row_err})")

    iters = 10
    model(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    print(f"flagship forward bf16 B={B} {H}x{W} T={T} S={S}: {dt * 1e3:.2f} ms/batch, "
          f"{B / dt:.1f} docs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        model(batch)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()),
        key=lambda r: -r[1],
    )
    total = sum(r[1] for r in rows)
    print(f"device time by kernel, one forward: total {total / 1e3:.2f} ms "
          f"(wall {dt * 1e3:.2f} ms)")
    for key, us, count in rows[:15]:
        print(f"  {us / 1e3:8.3f} ms {100 * us / max(total, 1):5.1f}%  x{count:<4d} {key[:90]}")
    return B / dt, dt


def fp32_card_vs_host(dev):
    from vibertgrid_tpu_torch.entry import FLAGSHIP, make_batch
    from vibertgrid_tpu_torch.models import ViBERTgridNet

    cfg = dataclasses.replace(FLAGSHIP, compute_dtype=torch.float32)
    host = ViBERTgridNet(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).eval()
    card = copy.deepcopy(host).to(dev)
    batch = make_batch(2, H, W, T, S, VOCAB, seed=5, device="cpu")
    want = host(batch).pred_label
    got = card(batch.to(dev)).pred_label.cpu()
    err = _max_err(got, want)
    print(f"fp32 forward B=2, card vs host: max |diff| {err:.3e} "
          f"(tol {FP32_FORWARD_ATOL}), probabilities in [{want.min().item():.3f}, "
          f"{want.max().item():.3f}]")
    if not err <= FP32_FORWARD_ATOL:
        raise AssertionError(f"fp32 card forward differs from host: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from vibertgrid_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    records = [check_attention(dev), check_ffn(dev), check_scatter(dev)]
    flagship_forward(dev, records)
    fp32_card_vs_host(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
