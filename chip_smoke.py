"""Smoke run of the PyTorch/CUDA port (``vibertgrid_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only flagship   # build, then steps 3 and 4 alone
    python3 chip_smoke.py --only host_ops   # build, then step 8 (0) alone: the collate's host ops
    python3 chip_smoke.py --only serve      # build, then serving steps 1-5 alone
    python3 chip_smoke.py --only driver     # build, then step 9 alone
    python3 chip_smoke.py --only determinism [--tree DIR]  # build, then step 4's pin, diagnosed
    python3 chip_smoke.py --only bench      # build, then bench.py's line (steps 3, 4 and two windows)
    python3 chip_smoke.py --only distributed  # build, then step 10 alone
    python3 chip_smoke.py --only tp         # build, then step 10 (5) alone
    python3 chip_smoke.py --only nccl       # two cards: step 10 (3) and (5)'s step on NCCL
    python3 chip_smoke.py --only attention [--tree DIR]   # build, then time kernels 1 and 4
    python3 chip_smoke.py --only ffn [--tree DIR]         # build, then time kernels 2 and 5
    python3 chip_smoke.py --only proj_ln [--tree DIR]     # build, then time kernel 7
    python3 chip_smoke.py --only scatter_bwd [--tree DIR] # build, then time kernel 6

1. builds the hand-written kernels from ``vibertgrid_tpu_torch/csrc``
   (``sm_90a``) into ``build/vibertgrid_tpu_torch/``;
2. holds each of the seven kernels against its plain PyTorch twin on the card,
   in bf16, at the flagship's shapes and a ragged one (forward outputs, with
   and without dropout, and gradients; attention also at a head width that
   takes its other tensor-core body, its row statistic, its backward against
   both plain backwards and twice for equal bits; the FFN's two launches each
   against its own twin and twice for equal bits, and its FMA body in bf16
   at widths 64 and 256; the attention epilogue's FMA body likewise; the
   scatter backward's cell list against ``winner_cells`` and its sums against
   ``scatter_backward_pieces``, both bit for bit, and twice for equal bits),
   and times kernel, twin and, where one PyTorch call computes the same
   function, that call (for the FFN and the epilogue, which no single call
   computes, the chain of library calls);
3. drives the flagship inference forward (BERT-base-uncased, ResNet-34-FPN,
   simplified head, bf16; batch 16, 512x384 images, one 510-token window,
   128 segments) through the port's entry points, checks its output and
   that it launched its kernels (12 attention, 12 FFN, 1 scatter), and
   reports docs/s and where the device time went;
4. drives the flagship train step at the same shapes (dropout, the OHEM and
   sampled losses, backward, SGD + AdamW with bf16 state, BatchNorm
   statistics), checks the launches of a step (attention 12, attention
   backward 12, saved-residual FFN 12, scatter 1, scatter backward 1, the
   inference FFN 0), that loss and gradients are finite and that parameters
   and statistics moved, and reports ms a step, docs/s and the device time;
   then pins that the step is bit-repeatable: two steps from one seed give
   the same loss, every gradient and every parameter bit for bit, two
   trajectories of 8 steps the same losses and parameters, and the port's
   embedding lookup the same gradient in four runs for an id repeated over a
   whole batch (the library's ``F.embedding``, printed beside it, does not);
   prints one JSON line with ``bench.py``'s keys (forward docs/s at batch
   16, the same with two windows a document, train docs/s and ms a step;
   no ``vs_baseline``, which divides by a TPU number);
5. drives the full-head model on the encoder with the fused attention
   epilogue at the same width, depth and shapes: the inference forward
   (launches: attention 12, epilogue 12, FFN 12, scatter 1) and the train step
   (attention 12 + 12 backward, epilogue 12, saved-residual FFN 12, scatter
   1 + 1), each timed in turns with the same model on the unfused epilogue
   (unfused, fused, fused, unfused); one train step under ``ffn_impl="fused"``
   (the residual-free FFN kernel 12 times, the saved-residual one never);
6. drives the CRF-head model on the same encoder: train steps (finite NLL, a
   gradient on the transitions, START and STOP still pinned) and a decode;
7. runs the inference forward and one train step in fp32 at batch 2 on the
   card (kernels) and on the host CPU (twins) from one set of weights and
   the same seeds, for the flagship and for the full-head model with the
   fused epilogue, the forward also at ``roberta-base``'s shapes (pad id 1,
   positions from 2), and the CRF decode, and compares them;
8. (0) builds the collate's C++ host ops (``vibertgrid_tpu_torch/data/native.py``
   over ``csrc/host_ops.cpp``, with the host's ``g++``) and holds each of
   the five functions bit for bit against its plain version on three pages
   (1100x850, 1250x800 and 2000x1400, resized to a short edge of 512), float
   and uint8 wire, with the host op's and the plain version's median ms for
   one page and for a 16-page collate through the serving engine's pool;
   then serves at the width of ``vibertgrid_tpu_torch/configs/deployment_sroie.yaml``
   (BERT-base-uncased, ResNet-34-FPN, simplified head, bf16, short edge 512,
   long edge at most 800) through ``InferenceEngine`` and ``BatchingEngine``
   on numpy pages and the synthetic vocabulary, the category head's last bias
   shifted by its mean logit so that the random weights fill fields (each
   comparison of answers fails if every field is empty; (1), (2) and (5)
   print the collate's ms a batch): (1) ``predict`` of one
   document of 128 segments, timed, with its dispatch under
   ``torch.cuda.set_sync_debug_mode("error")``, and an empty-OCR request;
   (2) ``predict_many`` of 1, 2, 4 and 16 documents, the 16's device time and
   the host's collate on its own; (3) a ragged batch of 3 documents padded to
   4, one of two windows (T = 1020, S bucket 256), and one of S = 512; (4)
   ``predict_stream`` of 64 documents against serial ``predict_many``, answers
   and score rows equal; (5)
   ``BatchingEngine`` under 8 client threads, each answer against the
   request's own ``predict``; each with the launches of a forward asserted
   (attention 12, FFN 12, saved-residual FFN 0, scatter 1); then (6) the
   uint8 wire against the fp32 wire, (7) fp32 card against host at batch 2
   with the two-window document, (8) kernel 3 bit for bit against its twin on
   the serving batches' boxes (S = 256 on an 832 x 512 canvas, S = 512) and
   (9) the HTTP front: ``serve()`` with a stub OCR service on localhost,
   three POSTs answered as ``predict``, with equal scores;
9. trains and evaluates through the port's command-line entry points at the
   width of ``vibertgrid_tpu_torch/configs/sroie_example.yaml`` (BERT-base,
   ResNet-34-FPN, simplified head, bf16, batch 2, random train scales
   320-704, OHEM random) on a synthetic dataset of 16 training and 8 test
   documents of 40-80 segments: (1) ``driver.main`` for two epochs, every
   loss finite, the launches of every train step (attention 12, attention
   backward 12, saved-residual FFN 12, scatter 1, scatter backward 1) and of
   every validate batch (attention 12, FFN 12, scatter 1) with the counts set
   to 0 just before each; train docs/s, wall, device time and the wait on the
   loader a step, validate docs/s, peak memory; (2) one more epoch resumed
   from the last checkpoint, the step count carrying on; (3) ``eval.cli.main``
   on that checkpoint: F1 and per-document predictions equal to the driver's
   validate of it, and on the uint8 wire the F1 within 0.05; (4) the fp32
   validate of the checkpoint on the card and on the host (segments classed
   otherwise only at top-2 margins under 1e-3, loss within 1e-4); (5) the
   tiny learnability run of ``tests/test_learnability.py`` (fp32, 24 epochs)
   held to its thresholds (best F1 above 0.5, two entity types learned);
10. runs the distributed layer (``vibertgrid_tpu_torch/parallel``) in rank
   processes of this script (``--rank PART DIR``), which the phase starts
   and stops: (1) a world of one on NCCL: the bootstrap, one all-reduce, the
   fp32 train step at full width (loss and gradients against this process's
   step, as in (2)) and the flagship bf16 train step through the
   data-parallel step (its loss within ``DIST_BF16_LOSS_RTOL`` of this
   process's); then two ranks that share the one card over gloo (NCCL
   refuses two ranks on one device), which first run gloo's all-reduce,
   reduce-scatter and all-gather on the card at the gradients' size (each
   one's ms, and whether its result is right for the next kernel of the
   caller's stream when a kernel wrote its input just before it, which it
   must be): (2) the fp32 train step at full width, dropout off, OHEM
   random off and on, two ranks of one document against one process of
   two: the loss, the gradients and the two ranks' parameters bit-equal to
   each other; (3) the flagship bf16 step at
   ``bench.py``'s shapes, 8 documents a rank, dropout 0.1, 5 timed steps
   without and with ZeRO-1: every step's launches (attention 12, attention
   backward 12, saved-residual FFN 12, scatter 1, scatter backward 1), ms a
   step, device ms, the gradient exchange's ms (the all-reduce; under ZeRO-1
   also the split leaves' reduce-scatter), peak memory, the optimizer
   state a rank keeps; ZeRO-1 from the replicated run's start: every loss
   and the parameters after the last step bit-equal to the replicated run's; before it,
   ZeRO-1's update against the replicated one from the same parameters and
   gradients at the flagship's shapes (three steps through
   ``train.state.apply_gradients``, the clip firing on the third) within
   ``ZERO1_PARAM_RTOL``; (4)
   ``driver.main`` on two ranks at ``sroie_example.yaml``'s width for one
   epoch, replicated and with ``zero1: true`` (``eval_batch_size: 1``):
   every step's and validate batch's launches, equal losses, F1 and fields
   on both ranks, one checkpoint, global train and validate docs/s; then
   ``eval.cli.main`` in this process on the checkpoint, its F1, fields and
   every segment's class equal to the ranks' gathered validate; every
   trajectory (replicated and ZeRO-1) bit-equal; (5) tensor parallelism,
   two gloo ranks on the card with ``mesh_model = 2`` (each holds its
   slices of the encoder's weights and runs kernels 1 and 4 on 6 of the 12
   heads): the fp32 step at full width on 2 documents against this
   process's (loss, the watched gradients gathered whole), the flagship bf16
   step at ``bench.py``'s shapes (launches: attention 12, attention backward
   12, scatter 1 and 1, the FFN and epilogue kernels 0; 48 activation
   all-reduces; ms a step, device ms, the all-reduces' ms, peak memory,
   parameter bytes a rank), ``driver.main`` for an epoch with
   ``mesh_model: 2`` (validate batches: attention 12, scatter 1) and
   ``eval.cli.main`` in this process on its checkpoint, with the ranks' F1,
   fields and classes.

The ``kernels`` line gives each kernel's launches in a train step of the
driver (step 9 (1)) where it runs there, else in a validate batch of the
driver, else in the first path that ran it; the line before it gives them by
path, the distributed paths among them (per rank).

``--only flagship`` is for comparing two trees on one card: run it from each
tree's root in turns (parent, change, change, parent) in one shell command and
read the two lines "flagship forward" and "flagship train step"; ``--only
host_ops`` runs step 8 (0) alone; ``--only
serve`` likewise runs step 8's parts (1) to (5) alone, ``--only driver`` step
9, ``--only distributed`` step 10, ``--only tp`` step 10 (5); ``--only
nccl`` runs step 10 (3) and (5)'s bf16 step on two NCCL ranks, one a card (a
host of two cards or more); ``--only determinism`` step 4's pin, and one
step under ``torch.use_deterministic_algorithms(True, warn_only=True)``
that prints the ops the library has no deterministic path for (with
``--tree DIR`` another checkout's package, its results printed and not
held: the parent of the repair shows the fault); ``--only
bench`` prints ``bench.py``'s line from steps 3 and 4 and the two-window
forward, for comparing trees. ``--only
attention`` does the same for the two attention kernels alone, through the
package's public ``flash_attention`` only, so ``--tree DIR`` can point this
script at another checkout's package (an earlier commit unpacked under a
directory that ``.gitignore`` lists) and time both with one clock; ``--only
ffn`` does it for the two FFN kernels through ``fused_ffn`` and
``fused_ffn_saved``, ``--only proj_ln`` for the attention epilogue through
``fused_proj_ln`` and ``--only scatter_bwd`` for the scatter backward through
``grid_scatter`` and autograd.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
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
# Backward: dq, dk, dv are bf16 roundings of fp32 sums of ~T products; kernel
# and twin sum in another order, so an entry can land on the neighbouring bf16
# value (2 ulps: rtol 2^-6). The entries are 0.08-0.17 in rms at these inputs;
# atol, 2^-8, covers the entries near zero, where the differing roundings of
# ds (2^-9 relative, ~T terms) outweigh the entry's own ulp. Measured on an
# H100: largest error 2^-9 at T=512 and 2^-8 at T=130, a third of the limit at
# most. The check prints each tensor's largest error beside its rms.
ATTN_BWD_TOL = dict(atol=2 ** -8, rtol=2 ** -6)
# d_bias: fp32 sums of fp32 ds over heads and queries, entries 2-4 in rms;
# measured 6e-6 at most.
ATTN_BIAS_TOL = dict(atol=5e-5, rtol=1e-4)
RSIG_TOL = dict(atol=0.0, rtol=1e-3)          # fp32 1/sqrt(var) of rows summed in another order
# FFN gradients with the kernel's residuals vs the twin's: the residuals
# differ by a bf16 ulp here and there, the products sum thousands of terms.
FFN_GRAD_RTOL = 2 ** -6
DROP_RATE, DROP_SEED = 0.1, 20240607
# The fp32 paths of the kernels (fp32 FMAs) against their twins, fp32 on both
# sides, on a small ragged shape: summation order only.
FP32_KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)
# fp32 forward, card (kernels, cuDNN) vs host (twins): the same fp32
# arithmetic summed in other orders through ~50 layers.
FP32_FORWARD_ATOL = 1e-3
# fp32 train step, card vs host, same weights and seeds: the loss is a mean
# of O(1) terms; a gradient is compared relative to its largest entry. The
# OHEM selections could in principle flip on a near-tie; none is expected at
# fp32 agreement of ~1e-6.
FP32_TRAIN_LOSS_RTOL = 1e-4
# Gradients, as |card − host| / |host| over a whole tensor. The backward of a
# randomly initialised net with batch statistics of two pages amplifies the
# ~1e-7 differences of the forward: measured 2e-7 to 1e-5 in the heads' last
# layers, about 1e-3 after two BatchNorms, about 1e-2 in the encoder (which
# the gradient reaches through the whole backbone), the same with every
# hand-written kernel replaced by nothing but summation order (each is held
# to its twin in fp32 at FP32_KERNEL_TOL above). The limit tells a wrong
# backward (errors of order 1) from that noise.
FP32_TRAIN_GRAD_RTOL = 5e-2
# CRF decode, card vs host in fp32: the card's path, scored with the host's
# emissions and transitions, against the host's own best path. A path score
# sums 2 x 128 emission and transition terms of order 1-10 and the two sides'
# emissions differ by ~1e-5, so the path that is best on the card is within
# ~5e-3 of the best on the host; where the host's best two paths are further
# apart than that, the tags are identical.
CRF_PATH_SCORE_ATOL = 1e-2


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds of one ``fn()``: the median over groups of
    back-to-back calls between one pair of CUDA events. Before each group the
    card is kept busy by a spin kernel so that the host runs ahead and queues
    the group's launches: the events then time the card's work, not the
    host's dispatch (a backward through autograd costs the host 0.2-0.3 ms a
    call, more than the short kernels take)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    groups, per_group = (5, iters // 5) if iters >= 10 else (iters, 1)
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000 * per_group)  # ~2 ms of spinning for each queued call
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return statistics.median(times)


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _assert_close(name, got, want, atol, rtol, show: bool = False):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if show:
        print(f"  {name}: max err {err.max().item():.3e}, largest err/limit "
              f"{(err / lim).max().item():.3f} (atol {atol:.3e}, rtol {rtol:.3e}), "
              f"rms of the twin's {want.float().square().mean().sqrt().item():.3e}")
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"{name}: kernel differs from twin, max err {err.max().item():.3e} "
            f"(atol {atol}, rtol {rtol})"
        )


def _attention_inputs(dev, b, t, nh, dh, g):
    q, k, v = (torch.randn(b, t, nh * dh, generator=g, device=dev).bfloat16()
               for _ in range(3))
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
    if t == T + 2:  # the flagship batch: 384 tokens + [CLS] + [SEP] valid
        lengths.fill_(3 * S + 2)
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    return q, k, v, valid, torch.where(valid, 0.0, -1e9).float()


def _record(name, source, replaces, **kw):
    return dict(name=name, route="cuda", source=f"vibertgrid_tpu_torch/csrc/{source}",
                replaces=f"vibertgrid_tpu/ops/{replaces}", **kw)


# (batch, T, heads, head width): a ragged T (not a multiple of the 64-row tile,
# two valid rows in the last) with padded keys on the wgmma bodies; the same on
# the WMMA bodies that head widths 32 and 128 take; a tensor-parallel rank's 6
# heads of the flagship (rows of 384 columns, mesh_model = 2); then the flagship's.
ATTN_SHAPES = ((2, 130, 12, 64), (2, 130, 4, 32), (B, T + 2, 6, 64), (B, T + 2, 12, 64))
LSE_ATOL = 1e-4  # fp32 max + log(sum) of scores of order 1-10, summed in another order


def check_attention(dev):
    from vibertgrid_tpu_torch.ops.flash_attention import (
        attention_forward,
        attention_reference,
        flash_attention,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    # each shape without and with dropout of the probabilities
    with torch.no_grad():
        for b, t, nh, dh in ATTN_SHAPES:
            q, k, v, valid, bias = _attention_inputs(dev, b, t, nh, dh, g)
            for rate in (DROP_RATE, 0.0):
                args = (q, k, v, bias, dh ** -0.5, nh)
                got = flash_attention(*args, rate=rate, seed=DROP_SEED)
                # the forward of a gradient path: the same output bit for bit, and lse
                got_grad, lse = attention_forward(*args, DROP_SEED, rate, True)
                want, want_lse = attention_reference(*args, seed=DROP_SEED, rate=rate,
                                                     return_lse=True)
                torch.cuda.synchronize()
                what = f"attention T={t} D={dh} rate={rate}"
                _assert_close(what, got, want, **ATTN_TOL)
                _assert_close(f"{what} lse", lse, want_lse, atol=LSE_ATOL, rtol=0.0)
                if not torch.equal(got, got_grad):
                    raise AssertionError(f"{what}: the output changes when lse is asked for")
        err = _max_err(got, want)
        qh, kh, vh = (x.view(b, t, nh, dh).transpose(1, 2) for x in (q, k, v))
        mask = valid[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        _assert_close("sdpa yardstick", sdpa().transpose(1, 2).reshape(b, t, -1), want,
                      atol=4 * 2 ** -6, rtol=4 * 2 ** -6)
        ms = _time_ms(lambda: flash_attention(*args))
        drop_ms = _time_ms(lambda: flash_attention(*args, rate=DROP_RATE, seed=DROP_SEED))
        lse_ms = _time_ms(lambda: attention_forward(*args, DROP_SEED, DROP_RATE, True))
        plain_ms = _time_ms(lambda: attention_reference(*args))
        library_ms = _time_ms(sdpa)
    print(f"flash_attention with dropout {DROP_RATE}: {drop_ms:.3f} ms, with dropout and lse: "
          f"{lse_ms:.3f} ms (without either: {ms:.3f} ms); sdpa {library_ms:.3f} ms")
    bound_ms, bound_by = _bound(4 * b * nh * t * t * dh, 4 * q.numel() * 2 + bias.numel() * 4)
    return _record("flash_attention", "flash_attention.cu", "flash_attention.py:99",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)


def _check_attention_fma(dev, g):
    """Forward and backward on the kernels' fp32-FMA bodies, at a head width
    the tensor-core bodies do not take: fp32, then bf16 storage."""
    from vibertgrid_tpu_torch.ops.flash_attention import (
        attention_backward_reference,
        attention_reference,
        flash_attention,
    )

    b, t, nh, dh = 2, 70, 3, 24
    bias = torch.zeros(b, t, device=dev)
    bias[0, t - 20:] = -1e9
    for dt, tol in ((torch.float32, FP32_KERNEL_TOL), (torch.bfloat16, ATTN_BWD_TOL)):
        q, k, v, d_out = (torch.randn(b, t, nh * dh, generator=g, device=dev).to(dt)
                          for _ in range(4))
        leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
        out = flash_attention(*leaves, dh ** -0.5, nh, rate=DROP_RATE, seed=DROP_SEED)
        got = (out, *torch.autograd.grad(out, leaves, d_out))
        want = (attention_reference(q, k, v, bias, dh ** -0.5, nh, DROP_SEED, DROP_RATE),
                *attention_backward_reference(q, k, v, bias, d_out, dh ** -0.5, nh, DROP_SEED,
                                              DROP_RATE))
        torch.cuda.synchronize()
        for name, a, w in zip(("out", "dq", "dk", "dv", "d_bias"), got, want):
            name_tol = ATTN_BIAS_TOL if (name, dt) == ("d_bias", torch.bfloat16) else tol
            _assert_close(f"attention FMA body {dt} {name}", a, w, **name_tol, show=True)


def check_attention_bwd(dev):
    from vibertgrid_tpu_torch.ops.flash_attention import (
        attention_backward_from_stats,
        attention_backward_reference,
        attention_reference,
        flash_attention,
    )

    g = torch.Generator(device=dev).manual_seed(6)
    names = ("dq", "dk", "dv", "d_bias")
    for b, t, nh, dh in ATTN_SHAPES:
        q, k, v, valid, bias = _attention_inputs(dev, b, t, nh, dh, g)
        d_out = torch.randn(b, t, nh * dh, generator=g, device=dev).bfloat16()
        for rate in (DROP_RATE, 0.0):
            leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
            out = flash_attention(*leaves, dh ** -0.5, nh, rate=rate, seed=DROP_SEED)
            got = torch.autograd.grad(out, leaves, d_out, retain_graph=True)
            again = torch.autograd.grad(out, leaves, d_out)
            # the statement of what the TPU kernel computes, and the kernel's own
            # arithmetic from the twin's lse
            want = attention_backward_reference(q, k, v, bias, d_out, dh ** -0.5, nh,
                                                DROP_SEED, rate)
            lse = attention_reference(q, k, v, bias, dh ** -0.5, nh, DROP_SEED, rate,
                                      return_lse=True)[1]
            want_stats = attention_backward_from_stats(q, k, v, bias, d_out, None, lse,
                                                       dh ** -0.5, nh, DROP_SEED, rate)
            torch.cuda.synchronize()
            what = f"T={t} D={dh} rate={rate}"
            for name, a, a2, w, ws in zip(names, got, again, want, want_stats):
                tol = ATTN_BIAS_TOL if name == "d_bias" else ATTN_BWD_TOL
                _assert_close(f"attention backward {name} {what}", a, w, **tol, show=True)
                _assert_close(f"attention backward {name} {what} vs from-stats twin", a, ws,
                              **tol)
                if not torch.equal(a, a2):  # no atomics: the same bits every run
                    raise AssertionError(f"attention backward {name} {what}: two runs differ")
    err = max(_max_err(a, w) for a, w in zip(got[:3], want[:3]))
    _check_attention_fma(dev, g)

    def timed(rate):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, bias, dh ** -0.5, nh, rate=rate, seed=DROP_SEED)
        return _time_ms(lambda: torch.autograd.grad(out, leaves, d_out, retain_graph=True))

    ms, no_drop_ms = timed(DROP_RATE), timed(0.0)
    print(f"flash_attention_bwd with dropout {DROP_RATE}: {ms:.3f} ms "
          f"(without: {no_drop_ms:.3f} ms)")
    with torch.no_grad():
        plain_ms = _time_ms(lambda: attention_backward_reference(
            q, k, v, bias, d_out, dh ** -0.5, nh, DROP_SEED, DROP_RATE), iters=5)
    heads = [x.detach().view(b, t, nh, dh).transpose(1, 2).requires_grad_() for x in (q, k, v)]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *heads, attn_mask=valid[:, None, None, :])
    d_heads = d_out.view(b, t, nh, dh).transpose(1, 2)
    library_ms = _time_ms(lambda: torch.autograd.grad(sdpa_out, heads, d_heads, retain_graph=True))
    # five T x T x D products a head; q, k, v, d_out read, dq, dk, dv written
    bound_ms, bound_by = _bound(5 * 2 * b * nh * t * t * dh, 7 * q.numel() * 2 + bias.numel() * 4)
    return _record("flash_attention_bwd", "flash_attention_bwd.cu", "flash_attention.py:127",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)


def _ffn_masters(dev, g, d=768, f=3072):
    """fp32 parameters as a model holds them: W1, b1, W2, b2, LN scale, LN bias."""
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    return (randn(f, d) * d ** -0.5, randn(f) * 0.1, randn(d, f) * f ** -0.5, randn(d) * 0.1,
            1 + 0.1 * randn(d), 0.1 * randn(d))


def _ffn_params(dev, g, d=768, f=3072, dt=torch.bfloat16):
    """The masters with W1 and W2 cast to the compute dtype, as the kernel takes them."""
    return tuple(p.to(dt) if p.ndim == 2 else p for p in _ffn_masters(dev, g, d, f))


def _check_ffn_launches(x, params, rate, saved, what):
    """The wgmma body's two launches, each against its twin on the same
    inputs: the up-projection's ``h`` (and ``h1``) against ``ffn_up_reference``,
    the down-projection's outputs against ``ffn_down_ln_reference`` given the
    kernel's own ``h``; then a second call, which must give the same bits."""
    from vibertgrid_tpu_torch.ops import fused_ffn as ffn

    n, f = x.shape[0], params[0].shape[0]
    runs = []
    for _ in range(2):
        h = torch.empty(n, f, dtype=x.dtype, device=x.device)
        runs.append((h, *ffn._launch(x, *params, 1e-12, DROP_SEED, rate, saved=saved, h=h)))
    torch.cuda.synchronize()
    h, y, h1, yhat, rsig = runs[0]
    want_h, want_h1 = ffn.ffn_up_reference(x, *params[:2])
    want_y, want_yhat, want_rsig = ffn.ffn_down_ln_reference(h, x, *params[2:], 1e-12, DROP_SEED,
                                                             rate)
    _assert_close(f"{what} up-projection h", h, want_h, **FFN_TOL)
    _assert_close(f"{what} down-projection y", y, want_y, **FFN_TOL)
    if saved:
        _assert_close(f"{what} up-projection h1", h1, want_h1, **FFN_TOL)
        _assert_close(f"{what} down-projection yhat", yhat, want_yhat, **FFN_TOL)
        _assert_close(f"{what} down-projection rsig", rsig, want_rsig, **RSIG_TOL)
    for name, a, b in zip(("h", "y", "h1", "yhat", "rsig"), *runs):
        if a is not None and not torch.equal(a, b):  # no atomics: the same bits every run
            raise AssertionError(f"{what}: two runs differ in {name}")


def _ffn_chain_ms(x, params):
    """Device ms of the library chain that computes the FFN tail in bf16 (no
    single PyTorch call does)."""
    F = torch.nn.functional
    w1, b1, w2, b2, g, bt = (p.bfloat16() for p in params)
    d = x.shape[1]
    with torch.no_grad():
        ms = _time_ms(lambda: F.layer_norm(x + F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2),
                                           (d,), g, bt, 1e-12))
    print(f"library chain F.layer_norm(x + F.linear(F.gelu(F.linear(x, W1, b1)), W2, b2)), "
          f"bf16 N={x.shape[0]}: {ms:.4f} ms")
    return ms


def check_ffn(dev):
    from vibertgrid_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn

    g = torch.Generator(device=dev).manual_seed(2)
    d, f = 768, 3072
    params = _ffn_params(dev, g, d, f)
    with torch.no_grad():
        # A row count that is not a multiple of any block's rows, then the
        # flagship's; then bf16 at D = 256, which takes the FMA body.
        for n, prm in ((200 - 5, params), (B * (T + 2), params),
                       (200 - 5, _ffn_params(dev, g, 256, 1024))):
            xn = torch.randn(n, prm[0].shape[1], generator=g, device=dev).bfloat16()
            for rate in (DROP_RATE, 0.0):
                got = fused_ffn(xn, *prm, 1e-12, rate=rate, seed=DROP_SEED)
                want = ffn_reference(xn, *prm, 1e-12, seed=DROP_SEED, rate=rate)
                torch.cuda.synchronize()
                what = f"fused_ffn N={n} D={xn.shape[1]} rate={rate}"
                _assert_close(what, got, want, **FFN_TOL)
                if xn.shape[1] == d:
                    _check_ffn_launches(xn, prm, rate, False, what)
            if n > 200:
                x, err = xn, _max_err(got, want)
        ms = _time_ms(lambda: fused_ffn(x, *params, 1e-12))
        drop_ms = _time_ms(lambda: fused_ffn(x, *params, 1e-12, rate=DROP_RATE, seed=DROP_SEED))
        plain_ms = _time_ms(lambda: ffn_reference(x, *params, 1e-12))
    print(f"fused_ffn with dropout {DROP_RATE}: {drop_ms:.3f} ms (without: {ms:.3f} ms)")
    _ffn_chain_ms(x, params)
    n = x.shape[0]
    nbytes = (2 * n * d + 2 * d * f) * 2 + (f + 3 * d) * 4
    bound_ms, bound_by = _bound(4 * n * d * f, nbytes)
    return _record("fused_ffn", "fused_ffn.cu", "fused_ffn.py:126",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_ffn_saved(dev):
    """The training forward's four outputs against the twin's, and each of
    the two launches against its own twin; then the wrapper on the fp32
    parameters (it casts the weights itself): its output against the twin's,
    and its gradients (kernel forward, plain PyTorch backward from the saved
    residuals) against the same backward on the twin's residuals and the
    twin's weights."""
    from vibertgrid_tpu_torch.ops import fused_ffn as ffn

    g = torch.Generator(device=dev).manual_seed(7)
    d, f = 768, 3072
    masters = _ffn_masters(dev, g, d, f)
    params = tuple(p.bfloat16() if p.ndim == 2 else p for p in masters)
    for n in (200 - 5, B * (T + 2)):
        x = torch.randn(n, d, generator=g, device=dev).bfloat16()
        for rate in (DROP_RATE, 0.0):
            with torch.no_grad():
                got = ffn._launch(x, *params, 1e-12, DROP_SEED, rate, saved=True)
                want = ffn.ffn_saved_reference(x, *params, 1e-12, DROP_SEED, rate)
                torch.cuda.synchronize()
                for name, a, w, tol in zip(("y", "h1", "yhat", "rsig"), got, want,
                                           (FFN_TOL, FFN_TOL, FFN_TOL, RSIG_TOL)):
                    _assert_close(f"fused_ffn_saved {name} N={n} rate={rate}", a, w, **tol)
                _check_ffn_launches(x, params, rate, True, f"fused_ffn_saved N={n} rate={rate}")
    err = _max_err(got[0], want[0])

    # The FMA body on a ragged row count: fp32 at the flagship's widths, then
    # bf16 storage at the tiny configuration's width and at D = 256.
    for dt, dd, ff in ((torch.float32, d, f), (torch.bfloat16, 64, 256),
                       (torch.bfloat16, 256, 1024)):
        small = _ffn_params(dev, g, dd, ff, dt)
        xs = torch.randn(200 - 5, dd, generator=g, device=dev).to(dt)
        with torch.no_grad():
            got_s = ffn._launch(xs, *small, 1e-12, DROP_SEED, DROP_RATE, saved=True)
            want_s = ffn.ffn_saved_reference(xs, *small, 1e-12, DROP_SEED, DROP_RATE)
            torch.cuda.synchronize()
        tols = [FP32_KERNEL_TOL] * 4 if dt == torch.float32 else [FFN_TOL] * 3 + [RSIG_TOL]
        for name, a, w, tol in zip(("y", "h1", "yhat", "rsig"), got_s, want_s, tols):
            _assert_close(f"fused_ffn_saved {dt} D={dd} {name}", a, w, **tol)

    # The wrapper, given the fp32 masters: its output against the twin's on
    # the cast weights, then its gradients with the kernel's residuals
    # against the backward with the twin's.
    with torch.no_grad():
        want = ffn.ffn_saved_reference(x, *params, 1e-12, DROP_SEED, DROP_RATE)
    dy = torch.randn(n, d, generator=g, device=dev).bfloat16()
    leaves = [t.clone().requires_grad_() for t in (x, *masters)]
    y = ffn.fused_ffn_saved(*leaves, 1e-12, rate=DROP_RATE, seed=DROP_SEED)
    _assert_close("fused_ffn_saved wrapper y on fp32 parameters", y, want[0], **FFN_TOL)
    err = max(err, _max_err(y, want[0]))
    got_grads = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    if any(a.dtype != leaf.dtype for a, leaf in zip(got_grads, leaves)):
        raise AssertionError("fused_ffn_saved: a gradient is not in its parameter's dtype")

    with torch.no_grad():
        want_grads = ffn.ffn_backward(dy, x, want[1], want[2], want[3], params[0], params[2],
                                      params[4], DROP_SEED, DROP_RATE)
    # The residual-free kernel with its rematerialising backward gives the same.
    remat_leaves = [t.clone().requires_grad_() for t in (x, *masters)]
    y_remat = ffn.fused_ffn(*remat_leaves, 1e-12, rate=DROP_RATE, seed=DROP_SEED)
    remat_grads = torch.autograd.grad(y_remat, remat_leaves, dy, retain_graph=True)
    torch.cuda.synchronize()
    if not torch.equal(y_remat, y):
        raise AssertionError("fused_ffn and fused_ffn_saved differ in their forward")
    names = ("dx", "dw1", "db1", "dw2", "db2", "dg", "dbt")
    for name, a, r, w in zip(names, got_grads, remat_grads, want_grads):
        scale = w.float().abs().max().item()
        tol = dict(atol=FFN_GRAD_RTOL * scale, rtol=FFN_GRAD_RTOL)
        _assert_close(f"fused_ffn_saved {name}", a, w.to(a.dtype), **tol)
        _assert_close(f"fused_ffn (rematerialising) {name}", r, w.to(r.dtype), **tol)

    with torch.no_grad():
        ms = _time_ms(lambda: ffn._launch(x, *params, 1e-12, DROP_SEED, DROP_RATE, saved=True))
        plain_ms = _time_ms(lambda: ffn.ffn_saved_reference(x, *params, 1e-12, DROP_SEED,
                                                            DROP_RATE))
    bwd_ms = _time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True))
    remat_ms = _time_ms(lambda: torch.autograd.grad(y_remat, remat_leaves, dy, retain_graph=True))
    print(f"fused_ffn_saved backward (four matmuls + elementwise, plain PyTorch): {bwd_ms:.3f} ms; "
          f"fused_ffn's rematerialising backward (two more matmuls): {remat_ms:.3f} ms")
    _ffn_chain_ms(x, params)
    # inputs x, W1, W2 and the small vectors; outputs y, h1, yhat, rsig
    nbytes = (3 * n * d + n * f + 2 * d * f) * 2 + (f + 3 * d + n) * 4
    bound_ms, bound_by = _bound(4 * n * d * f, nbytes)
    return _record("fused_ffn_saved", "fused_ffn.cu", "fused_ffn.py:307",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)


def check_proj_ln(dev):
    """The attention-epilogue kernel against its twin: bf16 at a ragged row
    count and at the flagship's, with and without dropout; the dropped set
    itself; the FMA body in fp32 and at a narrow bf16 width; the wrapper's
    gradients (kernel forward, plain PyTorch rematerialising backward) against
    autograd through the twin."""
    from vibertgrid_tpu_torch.models.norm import LayerNorm
    from vibertgrid_tpu_torch.ops import fused_ffn as ffn
    from vibertgrid_tpu_torch.ops.dropout import keep_mask

    g = torch.Generator(device=dev).manual_seed(9)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    proj_masters = lambda d: (randn(d, d) * d ** -0.5, randn(d) * 0.1, 1 + 0.1 * randn(d),
                              0.1 * randn(d))  # W, b, LN scale, LN bias as a model holds them
    d = 768
    masters = proj_masters(d)
    params = (masters[0].bfloat16(), *masters[1:])
    with torch.no_grad():
        for n in (200 - 5, B * (T + 2)):
            ctx, res = randn(n, d).bfloat16(), randn(n, d).bfloat16()
            for rate in (DROP_RATE, 0.0):
                got = ffn.fused_proj_ln(ctx, res, *params, 1e-12, rate=rate, seed=DROP_SEED)
                want = ffn.proj_ln_reference(ctx, res, *params, 1e-12, DROP_SEED, rate)
                torch.cuda.synchronize()
                _assert_close(f"fused_proj_ln N={n} rate={rate}", got, want, **FFN_TOL)
        err = _max_err(got, want)
        # The dropped set: a projection of all ones (W = 0, b = 1) on a zero
        # residual leaves 1/(1-rate) where kept and 0 where dropped, and the
        # LayerNorm (scale 1, bias 0) maps those to a positive and a negative value.
        zeros, ones = torch.zeros(d, device=dev), torch.ones(d, device=dev)
        y = ffn.fused_proj_ln(torch.zeros_like(ctx), torch.zeros_like(res),
                              torch.zeros(d, d, device=dev), ones, ones, zeros, 1e-12,
                              rate=0.4, seed=DROP_SEED)
        if not torch.equal(y > 0, keep_mask((n, d), DROP_SEED, 0.4, dev)):
            raise AssertionError("fused_proj_ln: dropped positions differ from hash_dropout's")

        # the FMA body: fp32 at the flagship's width, bf16 at the tiny
        # configuration's and at 256
        for dt, dd, tol in ((torch.float32, d, FP32_KERNEL_TOL), (torch.bfloat16, 64, FFN_TOL),
                            (torch.bfloat16, 256, FFN_TOL)):
            small = proj_masters(dd)
            small = (small[0].to(dt), *small[1:])
            cs, rs = randn(200 - 5, dd).to(dt), randn(200 - 5, dd).to(dt)
            got_s = ffn.fused_proj_ln(cs, rs, *small, 1e-12, rate=DROP_RATE, seed=DROP_SEED)
            want_s = ffn.proj_ln_reference(cs, rs, *small, 1e-12, DROP_SEED, DROP_RATE)
            torch.cuda.synchronize()
            _assert_close(f"fused_proj_ln FMA body {dt} D={dd}", got_s, want_s, **tol, show=True)

    # Gradients on the fp32 parameters at the flagship shape.
    dy = randn(n, d).bfloat16()
    leaves = [t.clone().requires_grad_() for t in (ctx, res, *masters)]
    y = ffn.fused_proj_ln(*leaves, 1e-12, rate=DROP_RATE, seed=DROP_SEED)
    got_grads = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    if any(a.dtype != leaf.dtype for a, leaf in zip(got_grads, leaves)):
        raise AssertionError("fused_proj_ln: a gradient is not in its tensor's dtype")
    twin_leaves = [t.clone().requires_grad_() for t in (ctx, res, *masters)]
    want_grads = torch.autograd.grad(
        ffn.proj_ln_reference(*twin_leaves, 1e-12, DROP_SEED, DROP_RATE), twin_leaves, dy)
    torch.cuda.synchronize()
    for name, a, w in zip(("dctx", "dres", "dw", "db", "dg", "dbt"), got_grads, want_grads):
        scale = w.float().abs().max().item()
        _assert_close(f"fused_proj_ln {name}", a, w, atol=FFN_GRAD_RTOL * scale,
                      rtol=FFN_GRAD_RTOL, show=True)

    ln = LayerNorm(d, eps=1e-12, dtype=torch.bfloat16, device=dev)
    w_bf, b_bf, g_bf, bt_bf = (p.bfloat16() for p in masters)
    F = torch.nn.functional
    with torch.no_grad():
        ln.weight.copy_(masters[2])
        ln.bias.copy_(masters[3])
        ms = _time_ms(lambda: ffn.fused_proj_ln(ctx, res, *params, 1e-12))
        drop_ms = _time_ms(lambda: ffn.fused_proj_ln(ctx, res, *params, 1e-12, rate=DROP_RATE,
                                                     seed=DROP_SEED))
        plain_ms = _time_ms(lambda: ffn.proj_ln_reference(ctx, res, *params, 1e-12))
        unfused_ms = _time_ms(lambda: ln(res + F.linear(ctx, w_bf, b_bf)))
        composed_ms = _time_ms(
            lambda: F.layer_norm(res + F.linear(ctx, w_bf, b_bf), (d,), g_bf, bt_bf, 1e-12))
    bwd_ms = _time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True))
    print(f"fused_proj_ln: {ms:.3f} ms, with dropout {DROP_RATE} {drop_ms:.3f} ms; the encoder's "
          f"unfused epilogue (F.linear, add, models/norm.py LayerNorm) {unfused_ms:.3f} ms; "
          f"F.layer_norm(res + F.linear(ctx, W, b)) {composed_ms:.3f} ms (no single library "
          f"call computes the function); rematerialising backward (plain PyTorch) {bwd_ms:.3f} ms")
    bound_ms, bound_by = _proj_ln_bound(n, d)
    return _record("fused_proj_ln", "fused_proj_ln.cu", "fused_ffn.py:588",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=composed_ms)


def _proj_ln_bound(n, d):
    """ctx, res read and out written once, W and the three vectors read once;
    2 N D^2 operations."""
    return _bound(2 * n * d * d, (3 * n * d + d * d) * 2 + 3 * d * 4)


def _scatter_inputs(dev):
    from vibertgrid_tpu_torch.entry import make_batch

    batch = make_batch(B, H, W, T, S, VOCAB, seed=3, device=dev)
    boxes = batch.boxes.clone()
    edge = lambda *xyxy: torch.tensor(xyxy, dtype=boxes.dtype, device=dev)
    boxes[:, 0] = edge(0, 0, W, H)                 # the whole page
    boxes[:, 1] = edge(W - 40, H - 20, W, H)       # the bottom-right corner
    boxes[:, 2] = edge(W - 16, 8, W + 64, 40)      # past the right edge
    boxes[:, 3] = edge(3, 5, 11, 9)                # inside a single cell
    boxes[:, 4] = edge(100, 100, 140, 140)         # fully covered by the next
    boxes[:, 5] = edge(96, 96, 160, 160)
    mask = batch.box_mask.clone()
    mask[:, 6::7] = False                          # masked boxes
    return boxes, mask


def check_scatter(dev):
    from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter
    from vibertgrid_tpu_torch.ops.rasterize import bertgrid_scatter

    boxes, mask = _scatter_inputs(dev)
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
    return _record("bertgrid_scatter", "bertgrid_scatter.cu", "pallas_scatter.py:39",
                   max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)


def check_scatter_bwd(dev):
    """The scatter backward against its twin on a ragged grid in fp32 and
    bf16 and on the flagship's, all on the check's boxes (a page-wide box
    under the others, boxes past the edge, inside one cell, covered, masked);
    its first launch's cell list against ``winner_cells`` and its sums
    against ``scatter_backward_pieces``, both bit for bit; two runs bit-equal."""
    from vibertgrid_tpu_torch.ops import grid_scatter as gs

    boxes, mask = _scatter_inputs(dev)
    g = torch.Generator(device=dev).manual_seed(8)
    # a ragged shape in fp32 and in bf16, then the flagship's
    for height, width, d, dt in ((20, 12, 76, torch.float32), (20, 12, 76, torch.bfloat16),
                                 (H // 8, W // 8, 768, torch.bfloat16)):
        emb = torch.randn(B, S, d, generator=g, device=dev).to(dt).requires_grad_()
        d_out = torch.randn(B, height, width, d, generator=g, device=dev).to(dt)
        out = gs.grid_scatter(emb, boxes, mask, height=height, width=width, stride=8)
        (got,) = torch.autograd.grad(out, emb, d_out, retain_graph=True)
        (again,) = torch.autograd.grad(out, emb, d_out, retain_graph=True)
        lists = (torch.empty(B, S + 2, dtype=torch.int32, device=dev),
                 torch.empty(B, height * width, dtype=torch.int32, device=dev))
        direct = gs._backward(d_out, boxes, mask, 8, lists=lists)
        want = gs.scatter_backward_reference(d_out, boxes, mask, stride=8)
        want_lists = gs.winner_cells(boxes, mask, height=height, width=width, stride=8)
        want_pieces = gs.scatter_backward_pieces(d_out, boxes, mask, stride=8)
        torch.cuda.synchronize()
        what = f"bertgrid_scatter_bwd {height}x{width}x{d} {dt}"
        # fp32 sums of up to a page of bf16 rows in another order, then one
        # rounding to bf16: one bf16 ulp of the result.
        tol = FP32_KERNEL_TOL if dt == torch.float32 else dict(atol=2 ** -7, rtol=2 ** -7)
        _assert_close(what, got, want, **tol)
        if not bool((got[~mask] == 0).all()) or not bool((got[:, 4] == 0).all()):
            raise AssertionError(f"{what}: masked or covered segment got a gradient")
        for name, a, w in zip(("offsets", "cells"), lists, want_lists):
            if not torch.equal(a, w):
                raise AssertionError(f"{what}: the kernel's {name} differ from winner_cells'")
        if not torch.equal(got, want_pieces):
            raise AssertionError(f"{what}: differs from the piece-order sum, max err "
                                 f"{_max_err(got, want_pieces)}")
        if not (torch.equal(got, again) and torch.equal(got, direct)):  # no float atomics
            raise AssertionError(f"{what}: two runs differ")
    # the page-wide box's cells reach across many pieces of the list
    spanned = ((want_lists[0][:, 1] - 1) // gs.PIECE + 1).min().item()
    print(f"bertgrid_scatter_bwd: cell lists and sums bit-equal to winner_cells and "
          f"scatter_backward_pieces; the page-wide segment spans at least {spanned} pieces "
          f"of {gs.PIECE} cells")
    ms = _time_ms(lambda: torch.autograd.grad(out, emb, d_out, retain_graph=True))
    with torch.no_grad():
        plain_ms = _time_ms(lambda: gs.scatter_backward_reference(d_out, boxes, mask, stride=8))
        library_ms = _index_add_ms(d_out, boxes, mask)
    bound_ms, bound_by = _scatter_bwd_bound(d_out, boxes, mask)
    return _record("bertgrid_scatter_bwd", "bertgrid_scatter_bwd.cu", "pallas_scatter.py:75",
                   max_abs_err=_max_err(got, want), ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def _scatter_bwd_bound(d_out, boxes, mask):
    """The rows of the cells that some segment won are read once, d_emb
    written once, boxes and mask read once."""
    from vibertgrid_tpu_torch.ops.rasterize import box_winner_map

    b, height, width, d = d_out.shape
    won = int((box_winner_map(boxes, mask, height=height, width=width, stride=8) > 0).sum())
    size = d_out.element_size()
    return _bound(0, won * d * size + b * boxes.shape[1] * d * size + boxes.numel() * 4
                  + mask.numel())


def _index_add_ms(d_out, boxes, mask):
    """Device ms of ``index_add_``, the library call nearest the backward:
    d_out's rows added into ``[B·(S+1), D]`` at the winner map's rows. The
    index is made beforehand, and the call accumulates in d_out's dtype (it
    takes one dtype for both)."""
    from vibertgrid_tpu_torch.ops.rasterize import box_winner_map

    b, height, width, d = d_out.shape
    s = boxes.shape[1]
    winner = box_winner_map(boxes, mask, height=height, width=width, stride=8)
    index = (winner.reshape(b, -1).long()
             + (s + 1) * torch.arange(b, device=d_out.device)[:, None]).reshape(-1)
    rows = d_out.reshape(-1, d)
    acc = torch.zeros(b * (s + 1), d, dtype=d_out.dtype, device=d_out.device)
    return _time_ms(lambda: acc.index_add_(0, index, rows))


def _device_time_table(fn, wall_s, what):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()),
        key=lambda r: -r[1],
    )
    total = sum(r[1] for r in rows)
    print(f"device time by kernel, {what}: total {total / 1e3:.2f} ms "
          f"(wall {wall_s * 1e3:.2f} ms)")
    # the top 15, and the port's own kernels (csrc/*.cu, anonymous namespace) wherever they rank
    own = lambda key: key.startswith("void (anonymous namespace)::") and "at::" not in key
    for i, (key, us, count) in enumerate(rows):
        if i < 15 or own(key):
            print(f"  {us / 1e3:8.3f} ms {100 * us / max(total, 1):5.1f}%  x{count:<4d} {key[:90]}")


def _timed_forward(model, batch, what, iters: int = 10) -> float:
    """Seconds per batch: the host clock around ``iters`` inference forwards
    that end in a synchronize, after one warm forward. Also prints how long
    the host took to issue them: where that is the whole time, the host and
    not the card bounds the forward."""
    with torch.no_grad():
        model(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(batch)
        issued = (time.perf_counter() - t0) / iters
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    b, h, w, _ = batch.images.shape
    print(f"{what} bf16 B={b} {h}x{w} T={batch.tokens.shape[1]} S={batch.boxes.shape[1]}: "
          f"{dt * 1e3:.2f} ms/batch, {b / dt:.1f} docs/s (the host issued a batch in "
          f"{issued * 1e3:.2f} ms), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dt


def _assert_launches(records, launches, want, what):
    """Check one path's launches, and keep each kernel's count by path."""
    if launches != want:
        raise AssertionError(f"{what} launches {launches}, expected {want}")
    for r in records:
        if want[r["name"]]:
            r.setdefault("paths", {})[what] = launches[r["name"]]


def flagship_forward(dev, records):
    from vibertgrid_tpu_torch.entry import FLAGSHIP, make_batch
    from vibertgrid_tpu_torch.models import ViBERTgridNet
    from vibertgrid_tpu_torch.ops import kernels

    model = ViBERTgridNet(
        FLAGSHIP, device=dev, generator=torch.Generator(device=dev).manual_seed(0)
    ).eval()
    batch = make_batch(B, H, W, T, S, VOCAB, seed=0, device=dev)

    with torch.no_grad():
        kernels.reset_launch_counts()
        pred = model(batch).pred_label
        torch.cuda.synchronize()
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        want.update(flash_attention=12, fused_ffn=12, bertgrid_scatter=1)
        _assert_launches(records, dict(kernels.LAUNCHES), want, "inference forward")
        if pred.shape != (B, S, 5) or not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"pred_label bad: shape {tuple(pred.shape)}")
        row_err = (pred.sum(-1) - 1).abs().max().item()
        if row_err > 1e-5:
            raise AssertionError(f"pred_label rows do not sum to 1 (max err {row_err})")

        dt = _timed_forward(model, batch, "flagship forward")
        _device_time_table(lambda: model(batch), dt, "one forward")

    # The same evaluation forward with autograd recording: the encoder takes
    # the saved-residual FFN (the same kernel body), so a gradient can be asked.
    kernels.reset_launch_counts()
    pred_grad = model(batch).pred_label
    torch.cuda.synchronize()
    want.update(fused_ffn=0, fused_ffn_saved=12)
    if dict(kernels.LAUNCHES) != want:
        raise AssertionError(f"forward under autograd launches {dict(kernels.LAUNCHES)}")
    err = _max_err(pred_grad, pred)
    print(f"evaluation forward under autograd vs under no_grad: max |diff| {err:.3e}")
    if not (pred_grad.requires_grad and err <= 2 ** -8):  # bf16 logits, probabilities <= 1
        raise AssertionError(f"forward under autograd differs from the one under no_grad: {err}")
    return B / dt, dt


TRAIN_LAUNCHES = dict(flash_attention=12, flash_attention_bwd=12, fused_ffn=0, fused_ffn_saved=12,
                      fused_proj_ln=0, bertgrid_scatter=1, bertgrid_scatter_bwd=1)
TRAIN_WATCH = ("bert_model.layer.0.intermediate.weight", "bert_model.word_embeddings.weight",
               "backbone.stem_conv.weight", "field_type_head.category_net.out.weight",
               "semantic_segmentation_head.encoder.conv1.weight")


def train_phase(dev, records, config, what, want, watch=(), iters: int = 5, table: bool = True):
    """One checked train step of ``config`` at the flagship shapes (launch
    counts, finite loss and gradients, a gradient on every parameter, moved
    parameters and statistics), two more warm ones, then ``iters`` timed.
    Returns ``(seconds a step, state)``."""
    from vibertgrid_tpu_torch.entry import train_entry
    from vibertgrid_tpu_torch.ops import kernels
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    state, train_step, batch = train_entry(device=dev, seed=0, config=config)
    model = state.model
    seeds = SeedStream(0)
    params = {name: model.get_parameter(name) for name in (*TRAIN_WATCH, *watch)}
    stats = {name: model.get_buffer(name) for name in (
        "backbone.stem_bn.running_mean", "late_fusion.roi_embedding.bn1.running_var",
        "semantic_segmentation_head.encoder.bn2.running_var")}
    before = {k: v.detach().clone() for k, v in {**params, **stats}.items()}

    kernels.reset_launch_counts()
    _, loss = train_step(state, batch, seeds)
    torch.cuda.synchronize()
    _assert_launches(records, dict(kernels.LAUNCHES), want, what)
    losses = [loss.item()]
    if not all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
               if p.grad is not None):
        raise AssertionError(f"{what}: a gradient is not finite")
    no_grad = [n for n, p in model.named_parameters() if p.grad is None]
    if no_grad:
        raise AssertionError(f"{what}: no gradient reached {no_grad[:5]}")
    for name, tensor in {**params, **stats}.items():
        if torch.equal(tensor, before[name]):
            raise AssertionError(f"{what} left {name} unchanged")

    for _ in range(2):  # warm steps two and three
        losses.append(train_step(state, batch, seeds)[1].item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        _, loss = train_step(state, batch, seeds)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    losses.append(loss.item())
    if not all(x == x and abs(x) < 1e4 for x in losses):
        raise AssertionError(f"{what}: losses {losses}")
    print(f"{what} bf16 B={B} {H}x{W} T={T} S={S}: {dt * 1e3:.2f} ms/step, "
          f"{B / dt:.1f} docs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss at steps 1-3 and "
          f"{3 + iters}: {', '.join(f'{x:.4f}' for x in losses)}")
    if table:
        _device_time_table(lambda: train_step(state, batch, seeds), dt, f"one {what}")
    return dt, state


def flagship_train(dev, records):
    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN

    dt, _ = train_phase(dev, records, FLAGSHIP_TRAIN, "flagship train step", TRAIN_LAUNCHES)
    return B / dt, dt


DETERMINISM_STEPS = 8


def _repeats_of_embedding_grad(dev, lookup, runs: int = 4) -> int:
    """How many of ``runs`` backward passes of ``lookup(weight, ids)`` give a
    weight gradient other than the first's, for an id repeated over every
    token of a flagship batch (the token type's case)."""
    g = torch.Generator(device=dev).manual_seed(11)
    weight = torch.randn(2, 768, device=dev, generator=g)
    ids = torch.zeros(B, T + 2, dtype=torch.long, device=dev)
    d_out = torch.randn(B, T + 2, 768, device=dev, generator=g)
    grads = []
    for _ in range(runs):
        w = weight.clone().requires_grad_()
        lookup(w, ids).backward(d_out)
        grads.append(w.grad)
    return sum(not torch.equal(x, grads[0]) for x in grads[1:])


def _flagship_run(dev, steps: int):
    """``steps`` flagship bf16 train steps from seed 0: the losses, the
    first step's gradients and the parameters after the last step."""
    from vibertgrid_tpu_torch.entry import train_entry
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    state, train_step, batch = train_entry(device=dev, seed=0)
    seeds, losses, grads = SeedStream(0), [], None
    for i in range(steps):
        losses.append(train_step(state, batch, seeds)[1].item())
        if i == 0:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    params = {n: t.clone() for n, t in state.model.state_dict().items()}
    del state, batch
    torch.cuda.empty_cache()
    return losses, grads, params


def _differing(a: dict, b: dict) -> list:
    return [n for n in a if not torch.equal(a[n], b[n])]


def determinism(dev, tree: str = HERE, probe: bool = False):
    """The bf16 flagship train step is bit-repeatable (ROADMAP Queue 3): two
    runs of one step from one seed give the same loss, every gradient and
    every parameter bit for bit, and two runs of DETERMINISM_STEPS steps the
    same losses and parameters. Beside it, the gradient of an embedding
    lookup of one id repeated over a whole batch, four runs each: the
    library's ``F.embedding`` (printed; it differs between runs on the card)
    and the port's ``embedding_lookup`` (held bit-equal). With ``probe``
    (``--only determinism``) one more step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` prints each
    op that the library has no deterministic path for. ``tree``: the
    checkout whose package runs (``--tree DIR``); another tree's results are
    printed, not held (an earlier commit shows the fault)."""
    import warnings

    own = os.path.abspath(tree) == HERE
    library = _repeats_of_embedding_grad(dev, lambda w, ids: torch.nn.functional.embedding(ids, w))
    line = (f"embedding gradient of one id repeated over {B}x{T + 2} tokens, 4 runs: "
            f"F.embedding {library} of 3 differ from the first")
    if own:
        from vibertgrid_tpu_torch.ops.segments import embedding_lookup

        ours = _repeats_of_embedding_grad(dev, embedding_lookup)
        print(f"{line}, embedding_lookup {ours}")
        if ours:
            raise AssertionError("embedding_lookup's gradient differs between runs")
    else:
        print(f"{line} (package of {tree})")
    (l1, g1, p1), (l2, g2, p2) = _flagship_run(dev, 1), _flagship_run(dev, 1)
    grads, params = _differing(g1, g2), _differing(p1, p2)
    print(f"flagship bf16 train step twice from one seed: loss {l1[0]:.6f} / {l2[0]:.6f}, "
          f"gradients differing {len(grads)} of {len(g1)} {grads[:6]}, parameters and "
          f"statistics after it differing {len(params)} of {len(p1)} {params[:6]}")
    if own and (l1 != l2 or grads or params):
        raise AssertionError("two flagship train steps from one seed differ")
    del g1, g2, p1, p2
    (l1, _, p1), (l2, _, p2) = (_flagship_run(dev, DETERMINISM_STEPS) for _ in range(2))
    params = _differing(p1, p2)
    print(f"flagship bf16 trajectory of {DETERMINISM_STEPS} steps twice: losses "
          f"{', '.join(f'{x:.6f}' for x in l1)} / {', '.join(f'{x:.6f}' for x in l2)}; "
          f"parameters differing after it: {len(params)}")
    if own and (l1 != l2 or params):
        raise AssertionError("two flagship trajectories from one seed differ")
    del p1, p2
    if probe:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _flagship_run(dev, 1)
        finally:
            torch.use_deterministic_algorithms(False)
        names = sorted({str(w.message).splitlines()[0][:200] for w in caught})
        print(f"under use_deterministic_algorithms(warn_only): {len(names)} ops without a "
              f"deterministic path: {names}")
    torch.cuda.empty_cache()


def two_window_forward(dev) -> float:
    """bench.py's second row: the flagship forward at batch 16 with two
    510-token windows a document (T = 1020, folded into the encoder's batch);
    docs/s on the host clock."""
    from vibertgrid_tpu_torch.entry import FLAGSHIP, make_batch
    from vibertgrid_tpu_torch.models import ViBERTgridNet

    model = ViBERTgridNet(FLAGSHIP, device=dev).eval()
    batch = make_batch(B, H, W, 2 * T, S, VOCAB, seed=0, device=dev)
    dt = _timed_forward(model, batch, "flagship forward, two windows")
    del model, batch
    torch.cuda.empty_cache()
    return B / dt


def bench_line(forward, train, two_window) -> None:
    """One JSON line with bench.py's keys, measured here (no vs_baseline:
    bench.py's divides by a TPU number)."""
    print(json.dumps({
        "metric": "docs/sec/chip joint CNN+BERT forward (SROIE 512x384, bs16)",
        "value": round(forward[0], 2), "unit": "docs/sec/chip",
        "value_2win": round(two_window, 2), "train_docs_per_sec": round(train[0], 2),
        "train_ms_per_batch": round(train[1] * 1e3, 2),
        "device": torch.cuda.get_device_name(0)}))


def full_fused_forward(dev, records):
    """The full-head model's inference forward with the fused attention
    epilogue, and beside it the same weights on the unfused epilogue."""
    from vibertgrid_tpu_torch.entry import FULL_FUSED, make_batch
    from vibertgrid_tpu_torch.models import ViBERTgridNet
    from vibertgrid_tpu_torch.ops import kernels

    fused = ViBERTgridNet(
        FULL_FUSED, device=dev, generator=torch.Generator(device=dev).manual_seed(0)).eval()
    unfused = ViBERTgridNet(dataclasses.replace(FULL_FUSED, text_config=None), device=dev).eval()
    unfused.load_state_dict(fused.state_dict(), strict=True)
    batch = make_batch(B, H, W, T, S, VOCAB, seed=0, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        pred = fused(batch).pred_label
        torch.cuda.synchronize()
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        want.update(flash_attention=12, fused_proj_ln=12, fused_ffn=12, bertgrid_scatter=1)
        _assert_launches(records, dict(kernels.LAUNCHES), want, "full-head forward, fused epilogue")
        if pred.shape != (B, S, 5) or not bool(((pred >= 0) & (pred <= 1)).all()):
            raise AssertionError(f"full head: pred_label bad, shape {tuple(pred.shape)}")
        kernels.reset_launch_counts()
        ref = unfused(batch).pred_label
        torch.cuda.synchronize()
        if kernels.LAUNCHES["fused_proj_ln"] != 0:
            raise AssertionError("the unfused epilogue launched the epilogue kernel")
        # bf16 through 12 layers, the unfused side rounding each projection to
        # bf16 first; a gate at a near-tie of 0.5 zeroes a whole row of class scores
        diff = (pred - ref).abs()
        close = (diff <= 2 ** -4).float().mean().item()
        print(f"full head, fused vs unfused epilogue: max |diff| {diff.max().item():.3e}, "
              f"{100 * close:.2f}% of the scores within 2^-4; predicted positive "
              f"{100 * (pred[..., 1:].sum(-1) > 0).float().mean().item():.1f}% of the segments")
        if close < 0.99:
            raise AssertionError("full head: fused and unfused epilogues disagree")
    times = [_timed_forward(m, batch, f"full-head forward, {name} epilogue")
             for name, m in (("unfused", unfused), ("fused", fused), ("fused", fused),
                             ("unfused", unfused))]
    print(f"full-head forward, unfused / fused / fused / unfused epilogue: "
          f"{' / '.join(f'{t * 1e3:.2f}' for t in times)} ms")
    with torch.no_grad():
        _device_time_table(lambda: fused(batch), times[1], "one full-head forward, fused epilogue")


def full_fused_train(dev, records):
    """The full-head model's train step with the fused epilogue, in turns with
    the unfused one; then one configuration on the residual-free FFN kernel."""
    from vibertgrid_tpu_torch.entry import FULL_FUSED

    unfused = dataclasses.replace(FULL_FUSED, text_config=None)
    watch = ("semantic_segmentation_head.binary_bank.weight",
             "field_type_head.pos_neg_net.out.weight", "bert_model.layer.0.attention.out.weight")
    want_fused = dict(TRAIN_LAUNCHES, fused_proj_ln=12)
    times = []
    for i, (name, cfg, want) in enumerate((
            ("unfused", unfused, TRAIN_LAUNCHES), ("fused", FULL_FUSED, want_fused),
            ("fused", FULL_FUSED, want_fused), ("unfused", unfused, TRAIN_LAUNCHES))):
        dt, state = train_phase(dev, records, cfg, f"full-head train step, {name} epilogue", want,
                                watch, table=i < 2)
        times.append(dt)
        del state
        torch.cuda.empty_cache()
    print(f"full-head train step, unfused / fused / fused / unfused epilogue: "
          f"{' / '.join(f'{t * 1e3:.2f}' for t in times)} ms")
    remat = dataclasses.replace(FULL_FUSED, ffn_impl="fused")
    train_phase(dev, records, remat, 'full-head train step, fused epilogue, ffn_impl="fused"',
                dict(want_fused, fused_ffn=12, fused_ffn_saved=0), watch, iters=3, table=False)
    torch.cuda.empty_cache()


def crf_fused(dev, records):
    """The CRF-head model on the encoder with the fused epilogue: train steps,
    then a decode."""
    from vibertgrid_tpu_torch.entry import CRF_FUSED, make_batch
    from vibertgrid_tpu_torch.ops import kernels

    name = "field_type_head.transitions"
    _, state = train_phase(dev, records, CRF_FUSED, "CRF-head train step, fused epilogue",
                           dict(TRAIN_LAUNCHES, fused_proj_ln=12),
                           (name, "semantic_segmentation_head.binary_bank.weight"))
    model = state.model.eval()
    trans = model.get_parameter(name)
    k = trans.shape[0]
    # No path moves to START or from STOP, so no gradient reaches the pins; as
    # in the JAX package nothing re-pins them, and the SGD weight decay moves
    # them by lr * wd * 1e4 = 0.025 a step.
    pins = torch.cat([trans[k - 2, :], trans[:, k - 1]]).detach()
    pin_grads = torch.cat([trans.grad[k - 2, :], trans.grad[:, k - 1]])
    if not bool((pins < -9999).all()) or not bool((pin_grads == 0).all()):
        raise AssertionError(f"CRF: START / STOP pins moved: {pins.max().item()}")
    if not trans.grad.abs().sum().item() > 0:
        raise AssertionError("CRF: no gradient on the transitions")
    batch = make_batch(B, H, W, T, S, VOCAB, seed=0, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        tags = model(batch).pred_label
        torch.cuda.synchronize()
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(flash_attention=12, fused_proj_ln=12, fused_ffn=12, bertgrid_scatter=1)
    _assert_launches(records, dict(kernels.LAUNCHES), want, "CRF decode")
    if tags.shape != (B, S) or tags.dtype != torch.int64 or not bool(
            ((tags >= 0) & (tags < k - 2)).all()):
        raise AssertionError(f"CRF decode: tags bad, shape {tuple(tags.shape)} {tags.dtype}")
    _timed_forward(model, batch, "CRF-head forward with decode, fused epilogue", iters=5)


def fp32_card_vs_host(dev, config, what, vocab=VOCAB, pad_id=None):
    """The inference forward in fp32 at batch 2 on the card and on the host
    from one set of weights; ``pad_id``: the token of the masked positions
    (RoBERTa's 1, from which its positions are counted)."""
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.models import ViBERTgridNet

    cfg = dataclasses.replace(config, compute_dtype=torch.float32)
    host = ViBERTgridNet(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).eval()
    card = copy.deepcopy(host).to(dev)
    batch = make_batch(2, H, W, T, S, vocab, seed=5, device="cpu")
    if pad_id is not None:
        batch.tokens[batch.token_mask == 0] = pad_id
    with torch.no_grad():
        want = host(batch).pred_label
        got = card(batch.to(dev)).pred_label.cpu()
    err = _max_err(got, want)
    print(f"fp32 forward B=2, {what}, card vs host: max |diff| {err:.3e} "
          f"(tol {FP32_FORWARD_ATOL}), scores in [{want.min().item():.3f}, "
          f"{want.max().item():.3f}]")
    if not err <= FP32_FORWARD_ATOL:
        raise AssertionError(f"fp32 card forward differs from host ({what}): {err}")


def fp32_crf_decode_card_vs_host(dev):
    """The CRF decode in fp32 at batch 2: the card's tags must be a best path
    of the host's model within CRF_PATH_SCORE_ATOL."""
    from vibertgrid_tpu_torch.entry import CRF_FUSED, make_batch
    from vibertgrid_tpu_torch.models import ViBERTgridNet
    from vibertgrid_tpu_torch.ops import crf

    cfg = dataclasses.replace(CRF_FUSED, compute_dtype=torch.float32)
    host = ViBERTgridNet(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).eval()
    card = copy.deepcopy(host).to(dev)
    batch = make_batch(2, H, W, T, S, VOCAB, seed=5, device="cpu")
    kept = {}
    hook = host.field_type_head.category_net.register_forward_hook(
        lambda module, args, out: kept.update(feats=out.float()))
    with torch.no_grad():
        want = host(batch).pred_label
        got = card(batch.to(dev)).pred_label.cpu()
        hook.remove()
        trans = host.field_type_head.transitions
        lengths = batch.box_mask.sum(dim=1)
        best = crf._gold_score(trans, kept["feats"], want, lengths)
        score = crf._gold_score(trans, kept["feats"], got, lengths)
    same = (got == want).float().mean().item()
    gap = (best - score).abs().max().item()
    print(f"fp32 CRF decode B=2, card vs host: {100 * same:.2f}% of the tags identical, the "
          f"card's paths within {gap:.3e} of the host's best scores "
          f"{[round(x, 3) for x in best.tolist()]} (tol {CRF_PATH_SCORE_ATOL})")
    if not gap <= CRF_PATH_SCORE_ATOL:
        raise AssertionError(f"fp32 CRF decode: the card's path scores {gap} below the host's best")


def fp32_train_card_vs_host(dev, config, what, names):
    """One train step in fp32 at batch 2, dropout on, the same seeds: the
    card (kernels, cuDNN) against the host CPU (twins) from one state."""
    from vibertgrid_tpu_torch.entry import TRAIN_SHAPE, train_entry
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    cfg = dataclasses.replace(config, compute_dtype=torch.float32)
    shape = dict(TRAIN_SHAPE, b=2)
    host_state, train_step, batch = train_entry("cpu", seed=6, config=cfg, shape=shape)
    card_state = copy.deepcopy(host_state)
    card_state.model.to(dev)
    for st in card_state.optimizer.state.values():
        for key, value in st.items():
            st[key] = value.to(dev)
    _, want = train_step(host_state, batch, SeedStream(7))
    _, got = train_step(card_state, batch.to(dev), SeedStream(7))
    want, got = want.item(), got.item()
    print(f"fp32 train step B=2, {what}, card vs host: loss {got:.6f} vs {want:.6f}")
    if not abs(got - want) <= FP32_TRAIN_LOSS_RTOL * abs(want):
        raise AssertionError(
            f"fp32 train step ({what}): loss on the card {got}, on the host {want}")
    for name in ("bert_model.layer.0.attention.query.weight",
                 "bert_model.layer.11.intermediate.weight",
                 "bert_model.word_embeddings.weight", "backbone.stem_conv.weight",
                 "backbone.early_fusion.weight", "field_type_head.category_net.out.weight",
                 *names):
        g_host = host_state.model.get_parameter(name).grad
        g_card = card_state.model.get_parameter(name).grad.cpu()
        err = ((g_card - g_host).norm() / g_host.norm()).item()
        print(f"  grad {name}: |card - host| / |host| = {err:.3e}")
        if not err <= FP32_TRAIN_GRAD_RTOL:
            raise AssertionError(f"fp32 train step ({what}): gradient of {name} differs by {err}")


# ---- the serving path ----

# vibertgrid_tpu_torch/configs/deployment_sroie.yaml as a dict, so that the
# serving phase needs no YAML reader (tests/test_torch_data.py holds them equal)
DEPLOYMENT_HYP = {
    "ocr_url": "http://127.0.0.1:8010/ocr",
    "parse_mode": "eng_line",
    "weights": "",
    "reference_weights": "",
    "num_classes": 5,
    "bert_version": "bert-base-uncased",
    "tokenizer_path": None,
    "backbone": "resnet_34_fpn_pretrained",
    "classifier_mode": "simp",
    "layer_mode": "single",
    "grid_mode": "mean",
    "early_fusion_downsampling_ratio": 8,
    "roi_shape": 7,
    "p_fuse_downsampling_ratio": 4,
    "late_fusion_fuse_embedding_channel": 1024,
    "amp": True,
    "image_mean": [0.9248, 0.9224, 0.9215],
    "image_std": [0.1532, 0.1545, 0.1536],
    "image_min_size": [512],
    "test_image_min_size": 512,
    "image_max_size": 800,
}
SERVE_LAUNCHES = dict(flash_attention=12, flash_attention_bwd=0, fused_ffn=12, fused_ffn_saved=0,
                      fused_proj_ln=0, bertgrid_scatter=1, bertgrid_scatter_bwd=0)
# Two answers to one request that the card computed in batches of other
# shapes (or over the two wires) are compared as tests/test_serve.py compares
# the wires: the class probabilities (the simplified head's softmax, which the
# engine reads as its scores) within WIRE_PROB_TOL, the fields equal unless
# some segment's top-2 margin is within twice the measured difference.
WIRE_PROB_TOL = 0.05
A4, TALL = (1100, 850), (1250, 800)  # pages resized to 662x512 and 800x512


class _VocabTokenizer:
    """Whitespace split and a lookup in the synthetic vocabulary: the
    tokenizer where ``transformers`` is not installed."""

    def __init__(self, vocab):
        self.ids = {w: i for i, w in enumerate(vocab)}
        self.cls_token_id, self.sep_token_id = self.ids["[CLS]"], self.ids["[SEP]"]

    def tokenize(self, text):
        return text.lower().split()

    def convert_tokens_to_ids(self, tokens):
        return [self.ids.get(t, self.ids["[UNK]"]) for t in tokens]


def _serve_tokenizer(directory):
    from vibertgrid_tpu_torch.data.synthetic import VOCAB, write_vocab

    try:
        from transformers import BertTokenizer
    except ImportError:
        return _VocabTokenizer(VOCAB)
    return BertTokenizer(write_vocab(directory), do_lower_case=True)


def _serve_request(seed: int, n_seg: int, words=(1, 4), hw=A4):
    """A page of ``n_seg`` OCR segments of the synthetic vocabulary's words,
    set in lines of boxes, each box shaded."""
    import numpy as np

    from vibertgrid_tpu_torch.data.synthetic import CLASS_WORDS

    rng = np.random.default_rng(seed)
    h, w = hw
    image = np.full((h, w, 3), 0.95, np.float32)
    vocab = [x for ws in CLASS_WORDS.values() for x in ws] + [str(i) for i in range(10)]
    per_line = -(-n_seg // ((h - 20) // 14))
    texts, boxes = [], []
    for i in range(n_seg):
        texts.append(" ".join(rng.choice(vocab, int(rng.integers(*words)))))
        x0 = 10 + (i % per_line) * ((w - 20) // per_line)
        y0 = 10 + (i // per_line) * 14
        box = [x0, y0, x0 + int(rng.integers(8, (w - 20) // per_line)), y0 + 11]
        image[box[1]:box[3], box[0]:box[2]] = rng.uniform(0.1, 0.8)
        boxes.append(box)
    return image, texts, boxes


def _answers(engine, requests):
    """``(answers, {request: class probabilities [n_seg, C]})`` of one batch."""
    pending = engine._dispatch(requests)
    pred, aux, _, keep = pending
    pred = pred.float().cpu()
    scores = {i: pred[row, :aux.n_segments[row]] for row, i in enumerate(keep)}
    for p in scores.values():
        if not (p.sum(-1) - 1).abs().max().item() <= 1e-4:
            raise AssertionError("serving scores are not probabilities")
    return engine._finish(*pending), scores


def _centre_head(engine, requests):
    """Random weights give every segment one class, so every field is '' and
    a comparison of answers compares nothing. Shift the category head's last
    bias by its mean logit over the segments of ``requests``: the classes then
    split the segments by what tells them apart."""
    net = engine.model.field_type_head.category_net
    logits = []
    hook = net.register_forward_hook(lambda m, i, o: logits.append(o.float().clone()))
    try:
        pred, aux, _, _ = engine._dispatch(requests)
    finally:
        hook.remove()
    rows = logits[0].view(*pred.shape[:2], -1)
    mean = torch.cat([rows[b, :n] for b, n in enumerate(aux.n_segments)]).mean(0)
    with torch.no_grad():
        net.out.bias.sub_(mean.to(net.out.bias.dtype))


def _fields_compared(what, answers):
    """Fail unless some answer has a field that is not empty."""
    filled = sum(bool(v) for a in answers for v in a.values())
    print(f"{what}: {filled} of {sum(len(a) for a in answers)} fields filled")
    if not filled:
        raise AssertionError(f"{what}: every field empty, nothing compared")


def _agree(what, got, want, got_scores, want_scores, tol=WIRE_PROB_TOL):
    """Answers ``got`` against ``want`` under the wire rule above."""
    _fields_compared(what, want)
    delta = max(((got_scores[i] - want_scores[i]).abs().max().item() for i in want_scores),
                default=0.0)
    differ = [i for i in range(len(want)) if got[i] != want[i]]
    near = []
    for i in differ:
        top2 = want_scores[i].topk(2, dim=-1).values
        near.append((top2[:, 0] - top2[:, 1]).min().item())
    print(f"{what}: {len(want) - len(differ)} of {len(want)} answers equal, max |probability "
          f"difference| {delta:.3e} (tol {tol}); the others' least top-2 margins "
          f"{[round(m, 5) for m in near]}")
    if not delta <= tol or any(m > 2 * delta for m in near):
        raise AssertionError(f"{what}: answers differ beyond a near tie")


def _device_total_ms(fn) -> float:
    """Device milliseconds of all the kernels one ``fn()`` runs (profiler)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def _median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _counted(engine, formed):
    """Wrap ``engine._dispatch`` so that each formed batch records its
    requests, its prediction and the launches it made (the counts set to 0
    just before it; one thread dispatches at a time)."""
    from vibertgrid_tpu_torch.ops import kernels

    dispatch = engine._dispatch

    def counted(requests):
        kernels.reset_launch_counts()
        out = dispatch(requests)
        formed.append((requests, out, dict(kernels.LAUNCHES)))
        return out

    engine._dispatch = counted


@contextlib.contextmanager
def _collate_times(engine):
    """The host ms of every ``engine._collate`` (a batch's resize and pad,
    through the host op) that the calls inside make."""
    times = []
    collate = engine._collate

    def timed(samples):
        t0 = time.perf_counter()
        out = collate(samples)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    engine._collate = timed
    try:
        yield times
    finally:
        del engine._collate


def serve_engine(dev, hyp=DEPLOYMENT_HYP, **kw):
    import tempfile

    from vibertgrid_tpu_torch.serve.engine import InferenceEngine

    with tempfile.TemporaryDirectory() as tmp:
        tokenizer = _serve_tokenizer(tmp)
    return InferenceEngine(hyp, tokenizer=tokenizer, device=dev, **kw)


def serving(dev, records, full: bool = True):
    """The serving path at the deployment config's width (bf16), steps 1-5;
    with ``full`` also 6-9: the wires, fp32 card against host, kernel 3 at
    the serving shapes, the HTTP front."""
    import numpy as np

    from vibertgrid_tpu_torch.ops import kernels
    from vibertgrid_tpu_torch.serve.batching import BatchingEngine

    t_phase = time.perf_counter()
    engine = serve_engine(dev)
    pages = [_serve_request(i, 128) for i in range(16)]  # one window each
    long_doc = _serve_request(100, 200, words=(3, 6), hw=TALL)  # 2 windows, S 256
    wide_doc = _serve_request(101, 400, words=(1, 2), hw=TALL)  # S 512
    n_tok = lambda req: sum(len(engine.tokenizer.tokenize(t)) for t in req[1])
    if not (max(map(n_tok, pages)) <= 510 < 700 <= n_tok(long_doc) <= 1020):
        raise AssertionError("serving documents: token counts off their windows")
    _centre_head(engine, pages)

    # 1. single requests; the dispatch reads nothing back from the card
    one = pages[0]
    engine.predict(*one)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine._dispatch([one])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    engine._finish(*pending)
    kernels.reset_launch_counts()
    want_one = engine.predict(*one)
    _assert_launches(records, dict(kernels.LAUNCHES), SERVE_LAUNCHES, "serving predict")
    with _collate_times(engine) as collates:
        single_s = _median_s(lambda: engine.predict(*one), 10)
    empty = engine.predict(one[0], [], np.zeros((0, 4), np.int32))
    if empty != {c: "" for c in engine.spec.class_list[1:]}:
        raise AssertionError(f"empty OCR answered {empty}")
    sample = engine._make_sample(*one)
    tokenize_ms = _median_s(lambda: engine._make_sample(*one), 5) * 1e3
    collate_ms = _median_s(lambda: engine._collate([sample]), 5) * 1e3
    print(f"serving predict, 1 document, 128 segments, {n_tok(one)} tokens, canvas "
          f"{engine._collate([sample])[0].images.shape[1:3]}: {single_s * 1e3:.2f} ms "
          f"(median of 10, host clock), of it tokenize {tokenize_ms:.2f} ms and resize and pad "
          f"{collate_ms:.2f} ms ({100 * (tokenize_ms + collate_ms) / (single_s * 1e3):.1f}%; "
          f"inside the calls the collate took {statistics.median(collates):.2f} ms a batch); "
          f"device time {_device_total_ms(lambda: engine.predict(*one)):.2f} ms; answer {want_one}")

    print(f"[serving: step 2 starts at {time.perf_counter() - t_phase:.1f} s]")
    # 2. predict_many at 1, 2, 4, 16; the 16-document call's device time; the
    # host's collate on its own
    rates = {}
    for n in (1, 2, 4, 16):
        reqs = pages[:n]
        engine.predict_many(reqs)
        with _collate_times(engine) as collates:
            s = _median_s(lambda: engine.predict_many(reqs), 3 if n == 16 else 5)
        rates[n] = (s * 1e3, n / s, statistics.median(collates))
    print("serving predict_many, ms a call, docs/s and the collate's ms a batch: "
          + ", ".join(f"{n} docs {ms:.2f} ms {r:.1f} docs/s collate {c:.2f} ms"
                      for n, (ms, r, c) in rates.items()))
    tokenize_s = _median_s(lambda: [engine._make_sample(*r) for r in pages], 3)
    samples = [engine._make_sample(*r) for r in pages]
    collate_s = _median_s(lambda: engine._collate(samples), 3)
    print(f"serving host collate of 16 documents: tokenize {tokenize_s * 1e3:.2f} ms, resize and "
          f"pad {collate_s * 1e3:.2f} ms, together {100 * (tokenize_s + collate_s) / (rates[16][0] / 1e3):.1f}% "
          f"of the predict_many call")
    _device_time_table(lambda: engine.predict_many(pages), rates[16][0] / 1e3,
                       "one predict_many of 16 documents")

    print(f"[serving: step 3 starts at {time.perf_counter() - t_phase:.1f} s]")
    # 3. a ragged batch: 3 documents padded to 4, one of two windows and 200
    # segments (T = 1020, S bucket 256) on the tallest canvas
    ragged = [pages[1], long_doc, pages[2]]
    kernels.reset_launch_counts()
    pred, aux, _, _ = engine._dispatch(ragged)
    torch.cuda.synchronize()
    _assert_launches(records, dict(kernels.LAUNCHES), SERVE_LAUNCHES, "serving ragged batch")
    batch, _ = engine._collate([engine._make_sample(*r) for r in ragged])
    print(f"serving ragged batch: prediction {tuple(pred.shape)}, tokens {batch.tokens.shape}, "
          f"canvas {batch.images.shape[1:3]}; launches as for one window (the windows of the "
          f"batch go through each kernel in one launch)")
    if pred.shape[:2] != (4, 256) or batch.tokens.shape[1] != 1020:
        raise AssertionError("ragged batch: unexpected shapes")
    if not bool(torch.isfinite(pred).all()):
        raise AssertionError("ragged batch: scores not finite")
    engine.predict_many([wide_doc])  # S bucket 512

    print(f"[serving: step 4 starts at {time.perf_counter() - t_phase:.1f} s]")
    # 4. predict_stream against serial predict_many: answers and score rows
    stream = [pages[i % 16] for i in range(64)]
    engine.predict_stream(stream[:16], batch_size=16, depth=2)
    runs = {"stream": [], "serial": []}
    try:
        _counted(engine, runs["stream"])
        t0 = time.perf_counter()
        streamed = engine.predict_stream(stream, batch_size=16, depth=2)
        stream_s = time.perf_counter() - t0
        del engine._dispatch
        _counted(engine, runs["serial"])
        t0 = time.perf_counter()
        serial = [a for i in range(0, 64, 16) for a in engine.predict_many(stream[i:i + 16])]
        serial_s = time.perf_counter() - t0
    finally:
        engine.__dict__.pop("_dispatch", None)
    _fields_compared("predict_stream vs serial predict_many", serial)
    for (_, (got, *_), launches), (_, (want, *_), _) in zip(runs["stream"], runs["serial"]):
        _assert_launches(records, launches, SERVE_LAUNCHES, "predict_stream batch")
        if not torch.equal(got, want):
            raise AssertionError("predict_stream scores differ from serial predict_many")
    if streamed != serial or len(runs["stream"]) != 4:
        raise AssertionError("predict_stream answers differ from serial predict_many")
    print(f"serving predict_stream of 64 documents, batch 16, depth 2: {64 / stream_s:.1f} docs/s; "
          f"serial predict_many: {64 / serial_s:.1f} docs/s; answers and scores equal")

    print(f"[serving: step 5 starts at {time.perf_counter() - t_phase:.1f} s]")
    # 5. BatchingEngine: 8 client threads x 4 requests
    # 32 requests over the 16 pages, each with its own list of texts, by
    # which its row in a formed batch is found
    reqs = [(p[0], list(p[1]), p[2]) for p in (pages[(3 * i) % 16] for i in range(32))]
    formed = []
    _counted(engine, formed)
    front = BatchingEngine(engine, max_batch=8, max_wait_ms=5)
    try:
        front.predict(*reqs[0])
        formed.clear()
        results = [None] * len(reqs)

        def client(k):
            for j in range(k, len(reqs), 8):
                results[j] = front.predict(*reqs[j])

        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        with _collate_times(engine) as collates:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            batching_s = time.perf_counter() - t0
    finally:
        front.close()
        del engine._dispatch
    sizes = [len(r) for r, _, _ in formed]
    for _, _, launches in formed:
        _assert_launches(records, launches, SERVE_LAUNCHES, "BatchingEngine batch")
    row_of, alone, got_scores, want_scores = {}, [], {}, {}
    for requests, (pred, _, _, keep), _ in formed:
        pred = pred.float().cpu()
        for row, req in zip(keep, requests):
            row_of[id(req[1])] = pred[row]
    for i, req in enumerate(reqs):
        answers, scores = _answers(engine, [req])
        alone.append(answers[0])
        want_scores[i] = scores[0]
        got_scores[i] = row_of[id(req[1])][:scores[0].shape[0]]
    _agree("BatchingEngine answers vs predict", results, alone, got_scores, want_scores)
    print(f"BatchingEngine, 8 threads x 4 requests, max_batch 8, max_wait_ms 5: "
          f"{len(reqs) / batching_s:.1f} docs/s, batches formed {sizes}, the collate "
          f"{statistics.median(collates):.2f} ms a batch (median)")
    if not full:
        print(f"serving phase: {time.perf_counter() - t_phase:.1f} s")
        return

    print(f"[serving: step 6 starts at {time.perf_counter() - t_phase:.1f} s]")
    # 6. the uint8 wire against the fp32 wire
    fp32_wire = serve_engine(dev, dict(DEPLOYMENT_HYP, serve_uint8_upload=False),
                             state=engine.model.state_dict())
    wire_reqs = [pages[0], long_doc, pages[3]]
    (got, got_scores), (want, want_scores) = (_answers(e, wire_reqs) for e in (engine, fp32_wire))
    _agree("uint8 wire vs fp32 wire", got, want, got_scores, want_scores)
    del fp32_wire

    print(f"[serving: step 7 starts at {time.perf_counter() - t_phase:.1f} s]")
    # 7. fp32, card against host, batch 2 with the two-window document
    roi_align_card_vs_host(dev)
    fp32_hyp = dict(DEPLOYMENT_HYP, amp=False)
    card = serve_engine(dev, fp32_hyp, state=engine.model.state_dict())
    host = serve_engine("cpu", fp32_hyp, state=engine.model.state_dict())
    pair = [pages[4], long_doc]
    (got, got_scores), (want, want_scores) = _answers(card, pair), _answers(host, pair)
    _fields_compared("fp32 serving card vs host", want)
    err = max((got_scores[i] - want_scores[i]).abs().max().item() for i in want_scores)
    same = got == want
    print(f"fp32 serving B=2 (T = 1020), card vs host: max |diff| {err:.3e} (tol "
          f"{FP32_FORWARD_ATOL}), answers equal: {same}")
    if not (err <= FP32_FORWARD_ATOL and same):
        raise AssertionError("fp32 serving: card differs from host")
    del card, host

    print(f"[serving: step 8 starts at {time.perf_counter() - t_phase:.1f} s]")
    # 8. kernel 3 against its twin at the serving shapes
    check_scatter_serving(dev, engine, ragged, wide_doc)

    print(f"[serving: step 9 starts at {time.perf_counter() - t_phase:.1f} s]")
    # 9. the HTTP front
    http_round_trip(engine, pages[5:8])
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s")


# ---- the host ops of the collate ----

HOST_PAGES = (A4, TALL, (2000, 1400))  # resized to 662x512, 800x512, 731x512


class _PlainHostOps:
    """``data/native.py``'s two resize entry points as their plain versions
    (torch ops on CPU tensors), swapped into ``data.dataset`` to build or
    time the same batch without the host op."""

    @staticmethod
    def bilinear_resize_norm(image, out_h, out_w, mean, std):
        import numpy as np

        from vibertgrid_tpu_torch.data import transform

        out = np.empty((out_h, out_w, image.shape[2]), np.float32)
        transform.resize_normalize_into(image, out, out_h, out_w, mean, std)
        return out

    @staticmethod
    def bilinear_resize_norm_into(image, dst, out_h, out_w, mean, std):
        from vibertgrid_tpu_torch.data import transform

        transform.resize_normalize_into(image, dst, out_h, out_w, mean, std)


@contextlib.contextmanager
def _plain_collate():
    from vibertgrid_tpu_torch.data import dataset

    native = dataset.native
    dataset.native = _PlainHostOps
    try:
        yield
    finally:
        dataset.native = native


def _host_median_ms(fn, reps: int) -> float:
    fn()
    return _median_s(fn, reps) * 1e3


def _equal_bits(what, got, want):
    import numpy as np

    if not (got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)):
        raise AssertionError(f"host ops: {what} differs from its plain version")


def host_ops_phase(dev, smi: str, engine=None):
    """The port's C++ host ops (``data/native.py``, ``csrc/host_ops.cpp``) on
    the card's host (``--only host_ops``): built from the source, then each of
    the five functions bit for bit against its plain version on the serving
    pages (1100x850, 1250x800 and 2000x1400 to a short edge of 512), float
    and uint8 wire; the median ms of the host op and of the plain version for
    one page, and for a 16-page collate through the serving engine's pool."""
    import numpy as np

    from vibertgrid_tpu_torch.data import native, transform
    from vibertgrid_tpu_torch.data.dataset import Collator
    from vibertgrid_tpu_torch.ops.rasterize import box_winner_map

    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    print(f"host ops build: {time.perf_counter() - t0:.1f} s, {os.path.relpath(lib, HERE)}")
    engine = engine or serve_engine(dev)
    tr = engine.transform
    mean = np.asarray(tr.image_mean, np.float32)
    std = np.asarray(tr.image_std, np.float32)
    timings = []
    for hw in HOST_PAGES:
        image, _, boxes = _serve_request(7, 128, hw=hw)
        oh, ow = tr.test_output_shape(*hw)
        bh, bw = transform.bucket_hw(oh, ow)
        canvas = np.random.default_rng(3).standard_normal((bh, bw, 3)).astype(np.float32)
        got, want = canvas.copy(), canvas.copy()
        native.bilinear_resize_norm_into(image, got, oh, ow, mean, std)
        transform.resize_normalize_into(image, want, oh, ow, mean, std)
        _equal_bits(f"bilinear_resize_norm_into {hw}", got, want)
        resized = native.bilinear_resize_norm(image, oh, ow, mean, std)
        _equal_bits(f"bilinear_resize_norm {hw}", resized, want[:oh, :ow])
        _equal_bits(f"bilinear_resize {hw}", native.bilinear_resize(image, oh, ow),
                    transform.bilinear_resize(image, oh, ow))
        u8, u8_want = np.zeros((bh, bw, 3), np.uint8), np.zeros((bh, bw, 3), np.uint8)

        def wire_u8(dst=u8):
            transform.round_uint8_into(native.bilinear_resize_norm(
                image, oh, ow, transform.UINT8_MEAN, transform.UINT8_STD), dst)

        wire_u8()
        transform.resize_uint8_into(image, u8_want, oh, ow)
        _equal_bits(f"the uint8 wire {hw}", u8, u8_want)
        padded, pad_want = np.zeros((bh, bw, 3), np.float32), np.zeros((bh, bw, 3), np.float32)
        native.pad_into(resized, padded)
        pad_want[:oh, :ow] = resized
        _equal_bits(f"pad_into {hw}", padded, pad_want)
        scaled = tr.rescale_boxes(np.asarray(boxes, np.int32), hw, (oh, ow))
        mask = np.arange(len(scaled)) % 7 != 3
        for stride in (1, 8):
            gh, gw = bh // stride, bw // stride
            _equal_bits(f"rasterize_winner {hw} stride {stride}",
                        native.rasterize_winner(scaled, mask, gh, gw, stride),
                        box_winner_map(torch.from_numpy(scaled), torch.from_numpy(mask),
                                       height=gh, width=gw, stride=stride).numpy())
        ms = {
            "float": (_host_median_ms(lambda: native.bilinear_resize_norm_into(
                image, got, oh, ow, mean, std), 20), _host_median_ms(
                lambda: transform.resize_normalize_into(image, want, oh, ow, mean, std), 20)),
            "uint8": (_host_median_ms(wire_u8, 20), _host_median_ms(
                lambda: transform.resize_uint8_into(image, u8_want, oh, ow), 20)),
        }
        timings.append(f"{hw[0]}x{hw[1]} -> {oh}x{ow}: " + ", ".join(
            f"{k} {a:.2f} ms (plain {b:.2f}, {b / a:.2f}x)" for k, (a, b) in ms.items()))
    print("host ops, five functions bit-equal to their plain versions on "
          f"{len(HOST_PAGES)} pages, float and uint8 wire")
    print(f"host ops, one page resized into its canvas, median of 20, host clock "
          f"({os.cpu_count()} cores; {smi}): " + "; ".join(timings))

    # a 16-page collate through the engine's pool, host op against plain
    samples = [engine._make_sample(*_serve_request(i, 128, hw=HOST_PAGES[i % 3]))
               for i in range(16)]
    lines = []
    for wire, collator in (("uint8", Collator(tr, emit_uint8=True)), ("float", Collator(tr))):
        run = lambda: collator(samples, train=False, pool=engine._pool)
        got = run()[0].images
        native_ms = _host_median_ms(run, 5)
        with _plain_collate():
            want = run()[0].images
            plain_ms = _host_median_ms(run, 5)
        _equal_bits(f"a 16-page {wire} collate", got, want)
        lines.append(f"{wire} {native_ms:.2f} ms (plain {plain_ms:.2f}, "
                     f"{plain_ms / native_ms:.2f}x), canvas {got.shape}")
    print(f"host ops, a 16-page collate through the engine's pool of "
          f"{engine._pool._max_workers} threads, bit-equal to the plain one, median of 5 "
          f"({smi}): " + "; ".join(lines))


# ---- the training driver path ----

# tests/test_train_driver.py's tiny config with tests/test_learnability.py's
# changes (tests/test_torch_driver.py holds them equal): the learnability run
LEARN_HYP = {
    "comment": "synthetic-smoke", "tee_logs": False, "mesh_data": 1, "mesh_model": 1,
    "batch_size": 4, "start_epoch": 0, "end_epoch": 24, "num_classes": 5,
    "bert_version": "tiny-bert-test", "backbone": "resnet_18_fpn", "classifier_mode": "simp",
    "eval_mode": "seqeval", "tag_mode": "B", "layer_mode": "single", "image_min_size": [256],
    "test_image_min_size": 256, "image_max_size": 400, "image_mean": [0.9, 0.9, 0.9],
    "image_std": [0.15, 0.15, 0.15], "num_hard_positive_main_1": 8,
    "num_hard_negative_main_1": 8, "num_hard_positive_main_2": 8,
    "num_hard_negative_main_2": 8, "loss_aux_sample_list": [64, 128, 64],
    "num_hard_positive_aux": 32, "num_hard_negative_aux": 32, "ohem_random": False,
    "loss_control_lambda": 1.0, "add_pos_neg": True, "weights": "",
    "optimizer_cnn_hyp": dict(learning_rate=5e-3, min_learning_rate=1e-5, warm_up_epoches=3,
                              warm_up_init_lr=1e-5, momentum=0.9, weight_decay=5e-4,
                              min_weight_decay=5e-4),
    "optimizer_bert_hyp": dict(learning_rate=5e-4, min_learning_rate=1e-7, warm_up_epoches=3,
                               warm_up_init_lr=1e-7, beta1=0.9, beta2=0.999, epsilon=1e-8,
                               weight_decay=0.01, min_weight_decay=0.01),
}
LEARN_F1, LEARN_TYPES = 0.5, 2  # tests/test_learnability.py's thresholds
# Evaluation of one checkpoint through the CLI against the driver's validate
# of the same state (bf16): equal F1 and predictions; on the uint8 wire the
# F1 within UINT8_F1_TOL (tests/test_model.py's bound for the JAX package).
UINT8_F1_TOL = 0.05
# fp32 validate, card vs host: segments whose class differs must all be near
# ties (top-2 margin of the host's scores under FP32_MARGIN); the loss within
# FP32_TRAIN_LOSS_RTOL.
FP32_MARGIN = 1e-3


@contextlib.contextmanager
def _instrumented(*modules):
    """Wrap ``make_train_step``, ``make_eval_step`` and ``validate`` where
    ``modules`` import them: each train step's and each evaluation batch's
    launches (the counts set to 0 just before the call and read just after),
    each validate's results and each valid segment's score row in it, and
    every train step's batch."""
    from vibertgrid_tpu_torch.ops import kernels

    record = {"train": [], "validate": [], "results": [], "scores": [], "batches": []}
    scores = []

    def counting(kind, step):
        def run(*args):
            kernels.reset_launch_counts()
            out = step(*args)
            record[kind].append(dict(kernels.LAUNCHES))
            if kind == "train":
                record["batches"].append(args[1])
                record["step"] = step
            if kind == "validate":
                scores.append(out.pred_label.float()[args[1].box_mask].cpu())
            return out
        return run

    def keeping(validate):
        def run(*args, **kw):
            scores.clear()
            record["results"].append(validate(*args, **kw))
            record["scores"].append(torch.cat(scores))
            return record["results"][-1]
        return run

    wraps = {"make_train_step": lambda f: lambda *a, **k: counting("train", f(*a, **k)),
             "make_eval_step": lambda f: lambda *a, **k: counting("validate", f(*a, **k)),
             "validate": keeping}
    saved = [(m, name, getattr(m, name)) for m in modules for name in wraps if hasattr(m, name)]
    for m, name, f in saved:
        setattr(m, name, wraps[name](f))
    try:
        yield record
    finally:
        for m, name, f in saved:
            setattr(m, name, f)


def _driver_yaml(tmp, root, name, **changes) -> str:
    """``configs/sroie_example.yaml`` with the driver phase's changes, written
    to ``tmp/name``."""
    import yaml

    with open(os.path.join(HERE, "vibertgrid_tpu_torch", "configs", "sroie_example.yaml")) as f:
        hyp = yaml.safe_load(f)
    hyp.update(data_root=root, tokenizer_path=os.path.join(root, "vocab.txt"),
               save_top=os.path.join(tmp, "weights"), save_log=os.path.join(tmp, "log"),
               tee_logs=False, end_epoch=2, eval_batch_size=8)
    hyp.update(changes)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(hyp, f)
    return path


def _driver_launches(records, record, what, kinds=("train", "validate")):
    """Every train step's and every evaluation batch's launches; a validate
    batch launches what a served batch does."""
    wants = {"train": TRAIN_LAUNCHES, "validate": SERVE_LAUNCHES}
    for kind in kinds:
        label, counts = f"{what} {kind} {'step' if kind == 'train' else 'batch'}", record[kind]
        if not counts:
            raise AssertionError(f"{label}: no call counted")
        for launches in counts:
            _assert_launches(records, launches, wants[kind], label)
        print(f"{label}: {len(counts)} calls, each {counts[0]}")


def _same_evaluation(what, got, want, got_scores, want_scores, need_classes=1):
    """The eval CLI's results against the driver's validate of the same
    checkpoint: F1, the fields of every document and every segment's class
    equal; fails where fewer than ``need_classes`` classes were predicted."""
    preds = lambda r: {k: v["pred"] for k, v in r.get("per_sample", {}).items()}
    classes = got_scores.argmax(-1)
    same = torch.equal(classes, want_scores.argmax(-1))
    filled = sum(bool(x) for p in preds(got).values() for x in p[1:])
    print(f"{what}: F1 {got['primary_F1']:.6f}, the driver's validate {want['primary_F1']:.6f}; "
          f"fields equal: {preds(got) == preds(want)} ({filled} filled), every segment's class "
          f"equal: {same} ({len(classes)} segments, by class {torch.bincount(classes).tolist()}), "
          f"max |score difference| {_max_err(got_scores, want_scores):.3e}")
    if got["primary_F1"] != want["primary_F1"] or preds(got) != preds(want) or not same:
        raise AssertionError(f"{what}: differs from the driver's validate of the checkpoint")
    if len(classes.unique()) < need_classes:
        raise AssertionError(f"{what}: fewer than {need_classes} classes predicted")


def _epoch_losses(results):
    losses = [x for e in results["timings"]["train"] for x in e["losses"]]
    if not losses or not all(x == x and abs(x) < 1e4 for x in losses):
        raise AssertionError(f"driver losses {losses}")
    return losses


def _driver_timings(results, record, seed, what, device_ms=None):
    """The driver's numbers: each epoch's train docs/s, wall and loader wait
    a step, beside the wall a step of the same batches replayed afterwards
    without the loader; device ms a step; validate docs/s."""
    state, at = results["final_state"], 0
    for e in results["timings"]["train"]:
        n = max(e["steps"], 1)
        replay = _replay_ms(record, state, seed, record["batches"][at:at + n])
        at += n
        print(f"{what} epoch {e['epoch'] + 1}: {e['docs'] / e['wall_s']:.2f} train docs/s, "
              f"{1e3 * e['wall_s'] / n:.2f} ms a step of wall, "
              f"{1e3 * e['loader_wait_s'] / n:.2f} ms a step waiting on the loader "
              f"({e['steps']} steps of batch {e['docs'] // n}); the same batches replayed "
              f"without the loader {replay:.2f} ms a step of wall")
    if device_ms is not None:
        print(f"{what}: device time a train step {device_ms:.2f} ms (profiler, 4 steps)")
    for v in results["timings"]["validate"]:
        print(f"{what} validate (epoch {v['epoch']}): {v['docs'] / v['wall_s']:.2f} docs/s "
              f"({v['docs']} documents, {v['wall_s']:.3f} s)")


def _validate_scores(hyp, device):
    """``(results, valid scores [N, C] on the host)`` of the port's validate of
    the checkpoint ``hyp["weights"]`` on ``device``."""
    from vibertgrid_tpu_torch.data.dataset import (
        KIEDataset,
        bucketed_eval_loader,
        prefetch_to_device,
    )
    from vibertgrid_tpu_torch.data.synthetic import synthetic_spec
    from vibertgrid_tpu_torch.eval.harness import validate
    from vibertgrid_tpu_torch.train.checkpoint import restore_model
    from vibertgrid_tpu_torch.train.driver import build_all, build_tokenizer
    from vibertgrid_tpu_torch.train.state import TrainState, make_eval_step

    tokenizer = build_tokenizer(hyp)
    spec, _, model, _, collator, tag_to_idx = build_all(hyp, "sroie", tokenizer,
                                                        synthetic_spec(), device=device)
    restore_model(hyp["weights"], model)
    step, scores = make_eval_step(), []

    def keeping(state, batch):
        out = step(state, batch)
        scores.append(out.pred_label.float()[batch.box_mask].cpu())
        return out

    loader = bucketed_eval_loader(KIEDataset(os.path.join(hyp["data_root"], "test"), spec,
                                             tokenizer, train=False),
                                  collator, batch_size=hyp["eval_batch_size"])
    with contextlib.closing(prefetch_to_device(loader, device)) as batches:
        results = validate(keeping, TrainState(model=model, optimizer=None), batches, spec,
                           eval_mode=hyp["eval_mode"], tag_to_idx=tag_to_idx, verbose=False)
    return results, torch.cat(scores)


def fp32_validate_card_vs_host(dev, hyp, what):
    """The fp32 validate of the checkpoint ``hyp["weights"]`` on the card
    (kernels) and on the host (twins)."""
    hyp = dict(hyp, amp=False)
    card, card_scores = _validate_scores(hyp, dev)
    host, host_scores = _validate_scores(hyp, torch.device("cpu"))
    differ = (card_scores.argmax(-1) != host_scores.argmax(-1)).nonzero().flatten()
    top2 = host_scores[differ].topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    print(f"fp32 validate, {what}, card vs host: F1 {card['primary_F1']:.6f} / "
          f"{host['primary_F1']:.6f}, "
          f"token accuracy {card['token_accuracy']:.6f} / {host['token_accuracy']:.6f}, loss "
          f"{card['loss']:.6f} / {host['loss']:.6f}, max |score diff| "
          f"{_max_err(card_scores, host_scores):.3e}; {len(differ)} of {len(host_scores)} "
          f"segments classed otherwise (by class {torch.bincount(host_scores.argmax(-1)).tolist()}"
          f" on the host), top-2 margins {[round(m, 6) for m in margins]}")
    if not abs(card["loss"] - host["loss"]) <= FP32_TRAIN_LOSS_RTOL * abs(host["loss"]):
        raise AssertionError("fp32 validate: the loss on the card differs from the host's")
    if len(differ) == 0:
        if (card["primary_F1"], card["token_accuracy"]) != (host["primary_F1"],
                                                            host["token_accuracy"]):
            raise AssertionError("fp32 validate: same classes, other metrics")
    elif not max(margins) < FP32_MARGIN:
        raise AssertionError("fp32 validate: a segment away from a tie is classed otherwise")


def _replay_ms(record, state, seed, batches) -> float:
    """Wall ms a step of the driver's step function over ``batches`` again,
    continuing from ``state``, with no loader beside it (ending in a
    synchronize)."""
    from vibertgrid_tpu_torch.train.seeds import step_seeds

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        record["step"](state, batch, step_seeds(seed, state.step))
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / len(batches)


def _replayed_device_ms(record, state, seed) -> float:
    """Device ms a train step over the run's first four batches (profiler),
    and one step's device time by kernel."""
    from vibertgrid_tpu_torch.train.seeds import step_seeds

    def steps(batches):
        for batch in batches:
            record["step"](state, batch, step_seeds(seed, state.step))

    wall = _replay_ms(record, state, seed, record["batches"][:1]) / 1e3
    _device_time_table(lambda: steps(record["batches"][:1]), wall, "one driver train step")
    return _device_total_ms(lambda: steps(record["batches"][:4])) / 4


def learnability(dev, tmp):
    """tests/test_learnability.py's run through ``driver.train`` on the card;
    then its best checkpoint through the eval CLI's ``evaluate`` (against the
    driver's validate of it) and in fp32 on the card and the host."""
    from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root, synthetic_spec
    from vibertgrid_tpu_torch.eval import cli
    from vibertgrid_tpu_torch.train import driver

    root = make_synthetic_root(os.path.join(tmp, "learn"), n_train=16, n_test=4, n_classes=3,
                               seed=0)
    hyp = copy.deepcopy(LEARN_HYP)
    hyp.update(data_root=root, tokenizer_path=os.path.join(root, "vocab.txt"),
               save_top=os.path.join(tmp, "learn_w"), save_log=os.path.join(tmp, "learn_l"))
    t0 = time.perf_counter()
    with _instrumented(driver) as rec:
        results = driver.train(hyp, "sroie", spec=synthetic_spec(), device=dev)
    print(f"learnability on the card (tiny, fp32, {hyp['end_epoch']} epochs, "
          f"{time.perf_counter() - t0:.1f} s): "
          f"best F1 {results['best_F1']:.4f} (> {LEARN_F1}), types learned "
          f"{results['best_learned_types']} (>= {LEARN_TYPES}), per type "
          f"{results.get('per_type_F1')}")
    if not (results["best_F1"] > LEARN_F1 and results["best_learned_types"] >= LEARN_TYPES):
        raise AssertionError("learnability: the tiny model did not learn the synthetic task")
    best = max((e for e in os.listdir(hyp["save_top"]) if e.startswith("epoch")),
               key=lambda e: float(e.rsplit("_", 1)[-1]))
    epoch = int(best.split("_")[0][5:])
    hyp.update(weights=os.path.join(hyp["save_top"], best), eval_batch_size=8,
               result_dir=os.path.join(tmp, "learn_result"))
    with _instrumented(cli) as rec_cli:
        got = cli.evaluate(hyp, "sroie", spec=synthetic_spec(), device=dev)
    _same_evaluation(f"eval CLI on the learned {best}", got, rec["results"][epoch + 1],
                     rec_cli["scores"][0], rec["scores"][epoch + 1], need_classes=LEARN_TYPES)
    fp32_validate_card_vs_host(dev, hyp, "learned tiny model")


def driver_phase(dev, records):
    """The training driver and the eval CLI at the flagship's width through
    ``driver.main`` and ``eval.cli.main``: train, resume, evaluate, the
    checks and the numbers."""
    import tempfile

    import yaml

    from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root
    from vibertgrid_tpu_torch.eval import cli
    from vibertgrid_tpu_torch.train import driver

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = make_synthetic_root(os.path.join(tmp, "data"), n_train=16, n_test=8, seed=0,
                                   words_range=(2, 6), segs_range=(8, 16))
        config = _driver_yaml(tmp, root, "train.yaml")
        # 1. two epochs through the command line's entry point
        torch.cuda.reset_peak_memory_stats()
        with _instrumented(driver) as rec:
            first = driver.main(["-c", config, "-d", "synthetic"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = _epoch_losses(first)
        state = first["final_state"]
        if len(losses) != 16 or state.step != 16 or len(rec["results"]) != 3:
            raise AssertionError(f"driver: {len(losses)} steps, step {state.step}, "
                                 f"{len(rec['results'])} validates")
        _driver_launches(records, rec, "driver")
        _driver_timings(first, rec, 42, "driver", _replayed_device_ms(rec, state, 42))
        print(f"driver: peak memory {peak:.2f} GiB; losses {', '.join(f'{x:.4f}' for x in losses)}"
              f"; validate F1 {[round(r['primary_F1'], 4) for r in rec['results']]}")
        del state, first["final_state"]

        # 2. one more epoch from the last checkpoint saved
        saved = sorted((e for e in os.listdir(os.path.join(tmp, "weights"))
                        if e.startswith("epoch")), key=lambda e: int(e.split("_")[0][5:]))
        epoch = int(saved[-1].split("_")[0][5:])
        ckpt = os.path.join(tmp, "weights", saved[-1])
        resume = _driver_yaml(tmp, root, "resume.yaml", weights=ckpt, end_epoch=epoch + 2,
                              save_top=os.path.join(tmp, "weights2"))
        with _instrumented(driver) as rec2:
            second = driver.main(["-c", resume, "-d", "synthetic"])
        _epoch_losses(second)
        epochs = [e["epoch"] for e in second["timings"]["train"]]
        if epochs != [epoch + 1] or second["final_state"].step != 8 * (epoch + 2):
            raise AssertionError(f"resume from {saved[-1]}: epochs {epochs}, step "
                                 f"{second['final_state'].step}")
        print(f"resumed from {saved[-1]}: epoch {epoch + 2}, step {second['final_state'].step}")
        _driver_launches(records, rec2, "resumed driver")
        _driver_timings(second, rec2, 42, "resumed driver")
        del second, rec2

        # 3. the eval CLI on that checkpoint, against the driver's validate of it
        want = rec["results"][epoch + 1]
        evaluation = _driver_yaml(tmp, root, "eval.yaml", weights=ckpt,
                                  result_dir=os.path.join(tmp, "result"))
        with _instrumented(cli) as rec3:
            got = cli.main(["-c", evaluation, "-d", "synthetic"])
        _driver_launches(records, rec3, "eval CLI", kinds=("validate",))
        _same_evaluation(f"eval CLI on {saved[-1]}", got, want, rec3["scores"][0],
                         rec["scores"][epoch + 1])
        wire = _driver_yaml(tmp, root, "eval_u8.yaml", weights=ckpt, eval_uint8_upload=True,
                            result_dir=os.path.join(tmp, "result"))
        u8 = cli.main(["-c", wire, "-d", "synthetic"])
        print(f"eval CLI, uint8 wire: F1 {u8['primary_F1']:.6f} (tol {UINT8_F1_TOL})")
        if not abs(u8["primary_F1"] - got["primary_F1"]) <= UINT8_F1_TOL:
            raise AssertionError("eval CLI: the uint8 wire's F1 is off the fp32 wire's")

        # 4. fp32 validate of the checkpoint, card vs host
        with open(evaluation) as f:
            fp32_validate_card_vs_host(dev, yaml.safe_load(f), "flagship width")
        torch.cuda.empty_cache()

        # 5. the tiny learnability run
        learnability(dev, tmp)
    print(f"driver phase: {time.perf_counter() - t_phase:.1f} s")


# ---- the distributed layer: ranks as subprocesses of this script ----

# NCCL refuses two ranks on one device and the machine has one card, so the
# two-rank runs join over gloo (every collective through the host) with both
# ranks on the card; a world of one on NCCL checks that bootstrap. The
# numbers describe that setup, not NCCL across cards.
DIST_WORLD = 2
DIST_TIMEOUT_S = 480
DIST_BF16_STEPS = 5
# the NCCL world of one against this process: the same bf16 step, its
# BatchNorms through the global-batch path (sums and counts) instead of
# F.batch_norm, so the loss moves by bf16 roundings of the normalised maps
DIST_BF16_LOSS_RTOL = 1e-2
# ZeRO-1's update against the replicated one from the same parameters and
# gradients, |θ_zero1 − θ_replicated| / |θ_replicated − θ_0|: the update is
# elementwise and the clip's norm is summed in float64, so they are
# bit-equal but where that norm rounds to another float32 (a relative 6e-8
# in one step's factor); a slice written to the wrong place moves a whole
# slice's update, a ratio of order 0.1-1. (The bf16 train steps' own
# trajectories, replicated and ZeRO-1, are held bit-equal: the step is
# bit-repeatable on the card.)
ZERO1_PARAM_RTOL = 1e-6
# fp32 at full width, two ranks x 1 document against one process x 2 on the
# card: the loss within FP32_TRAIN_LOSS_RTOL, these gradients within
# FP32_TRAIN_GRAD_RTOL in norm (the same sums in other orders: the global
# BatchNorm statistics and the loss's sums are the two ranks' partial sums)
DIST_GRADS = ("bert_model.layer.0.attention.query.weight", "bert_model.layer.11.intermediate.weight",
              "bert_model.word_embeddings.weight", "backbone.stem_conv.weight",
              "backbone.early_fusion.weight", "backbone.stem_bn.weight",
              "late_fusion.roi_embedding.bn1.weight", "field_type_head.category_net.out.weight",
              "semantic_segmentation_head.encoder.conv1.weight")


def _fp32_dist_config(ohem_random: bool):
    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN

    text = dataclasses.replace(FLAGSHIP_TRAIN.resolved_text_config(), hidden_dropout=0.0,
                               attention_dropout=0.0)
    return dataclasses.replace(FLAGSHIP_TRAIN, compute_dtype=torch.float32, text_config=text,
                               ohem_random=ohem_random)


def _fp32_dist_step(dev, ohem_random: bool, share=None):
    """One fp32 train step at full width from seed 6 on batch 2 (or the share
    ``(rank, world)`` of it): ``(loss, {name: gradient on the host}, state)``."""
    from vibertgrid_tpu_torch.entry import TRAIN_SHAPE, train_entry
    from vibertgrid_tpu_torch.parallel.mesh import shard_batch
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    state, train_step, batch = train_entry(device=dev, seed=6, config=_fp32_dist_config(ohem_random),
                                           shape=dict(TRAIN_SHAPE, b=2))
    if share is not None:
        batch = shard_batch(batch, *share)
    _, loss = train_step(state, batch, SeedStream(7))
    grads = {n: state.model.get_parameter(n).grad.detach().cpu() for n in DIST_GRADS}
    return loss.item(), grads, state


def _flat_params_equal(model) -> bool:
    """Whether every rank holds rank 0's parameters bit for bit."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    theirs = flat.clone()
    dist.broadcast(theirs, 0)
    return torch.equal(flat, theirs)


def _fp32_against_reference(dev, tmp, ohem_random, rank, world) -> dict:
    """This rank's fp32 step against the one-process step of
    ``fp32_reference.pt``: both losses, each watched gradient's relative
    error, and whether the ranks hold one set of parameters."""
    ref = torch.load(os.path.join(tmp, "fp32_reference.pt"), weights_only=False)[ohem_random]
    loss, grads, state = _fp32_dist_step(dev, ohem_random, (rank, world))
    out = dict(loss=loss, want=ref["loss"], equal=_flat_params_equal(state.model),
               errs={n: ((g - ref["grads"][n]).norm() / ref["grads"][n].norm()).item()
                     for n, g in grads.items()})
    del state
    torch.cuda.empty_cache()
    return out


def _check_fp32(what, got: list):
    """Every rank's loss within FP32_TRAIN_LOSS_RTOL of the one process's,
    the watched gradients within FP32_TRAIN_GRAD_RTOL, the ranks' parameters
    bit-equal; prints the line."""
    errs = {n: max(g["errs"][n] for g in got) for n in DIST_GRADS}
    losses = " / ".join(f"{g['loss']:.6f}" for g in got)
    print(f"{what}: loss {losses} on the ranks, one "
          f"process {got[0]['want']:.6f}; largest gradient error {max(errs.values()):.3e} "
          f"({max(errs, key=errs.get)}); parameters bit-equal across ranks: "
          f"{all(g['equal'] for g in got)}")
    for g in got:
        if not abs(g["loss"] - g["want"]) <= FP32_TRAIN_LOSS_RTOL * abs(g["want"]):
            raise AssertionError(f"{what}: loss {g['loss']} vs {g['want']}")
    if not max(errs.values()) <= FP32_TRAIN_GRAD_RTOL or not all(g["equal"] for g in got):
        raise AssertionError(f"{what}: gradients {errs} or parameters differ")


def _rank_fp32(dev, tmp, rank, world):
    return {ohem: _fp32_against_reference(dev, tmp, ohem, rank, world) for ohem in (False, True)}


def _step_profile(fn) -> dict:
    """Two profiled ``fn()``: on the card alone, its busy ms with its copies
    (gloo stages every collective through host memory) and its waits (a
    stream waiting on an event) apart, and its largest rows; on the host
    alone, the collectives (the ``all_reduce``, ``reduce_scatter`` and
    ``all_gather`` events: count, total and largest ms by kind; the largest
    all-reduce, or under ZeRO-1 reduce-scatter, is the gradients').
    Profiled together, the host's op and annotation rows would count the
    card's time again."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    kind = lambda key: ("copy" if "memcpy" in key.lower() else
                        "wait" if "sync" in key.lower() or "wait" in key.lower() else "busy")
    ms = {k: sum(v for key, v in rows if kind(key) == k) for k in ("busy", "copy", "wait")}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    comms = {}
    for e in prof.events():
        kind = next((k for k in ("all_reduce", "reduce_scatter", "all_gather") if k in e.name),
                    None)
        if kind:
            comms.setdefault(kind, []).append(e.cpu_time_total / 1e3)
    return dict(device_ms=ms["busy"], copy_ms=ms["copy"], wait_ms=ms["wait"],
                top=[(key[:60], round(v, 3)) for key, v in rows[:6]],
                comms={k: (len(v), round(sum(v), 2), round(max(v), 2)) for k, v in comms.items()})


def _rank_bf16(dev, tmp, rank, world):
    """The flagship bf16 step at bench.py's shapes, 8 documents a rank,
    dropout 0.1, without and with ZeRO-1 from the same start: each step's
    launches, ms a step, device ms, the gradient exchange's ms a step, peak
    memory, optimizer-state bytes; under ZeRO-1 its distance from the
    replicated run's parameters after the same steps."""
    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, train_entry
    from vibertgrid_tpu_torch.ops import kernels
    from vibertgrid_tpu_torch.parallel.mesh import shard_batch
    from vibertgrid_tpu_torch.parallel.sharding import shard_optimizer_state, state_bytes
    from vibertgrid_tpu_torch.train import state as state_module
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    exchanges = {name: getattr(state_module, name)
                 for name in ("average_gradients", "reduce_scatter_mean")}
    reduce_ms = []  # each step's gradient exchange, host clock

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            reduce_ms[-1] += 1e3 * (time.perf_counter() - t0)
            return res
        return run

    flat = lambda model: torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    for name, fn in exchanges.items():
        setattr(state_module, name, timed(fn))
    clip_scale, scales = state_module.clip_scale, []  # each step's clip factor

    def kept_scale(*args, **kwargs):
        scales.append(clip_scale(*args, **kwargs))
        return scales[-1]

    state_module.clip_scale = kept_scale
    out = {}
    try:
        for zero1 in (False, True):
            state, train_step, batch = train_entry(device=dev, seed=0, config=FLAGSHIP_TRAIN)
            batch = shard_batch(batch, rank, world)
            full = state_bytes(state.optimizer)
            if zero1:
                shard_optimizer_state(state.optimizer, rank, world)
            else:
                start = flat(state.model)
            seeds, launches, losses = SeedStream(0), [], []
            scales.clear()

            def step():
                kernels.reset_launch_counts()
                reduce_ms.append(0.0)
                _, loss = train_step(state, batch, seeds)
                torch.cuda.synchronize()
                launches.append(dict(kernels.LAUNCHES))
                losses.append(loss.item())

            step()  # warm
            torch.cuda.reset_peak_memory_stats()
            reduce_ms.clear()
            t0 = time.perf_counter()
            for _ in range(DIST_BF16_STEPS):
                step()
            ms = 1e3 * (time.perf_counter() - t0) / DIST_BF16_STEPS
            reduce = statistics.median(reduce_ms)
            out[zero1] = dict(ms=ms, reduce_ms=reduce, launches=launches, **_step_profile(step),
                              losses=losses, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                              state_bytes=state_bytes(state.optimizer), replicated_bytes=full,
                              equal=_flat_params_equal(state.model),
                              scales=[x.item() for x in scales])
            if not zero1:
                replicated = flat(state.model)
            else:
                mine = flat(state.model)
                out[zero1].update(
                    bit_equal=torch.equal(mine, replicated),
                    param_ratio=((mine - replicated).norm() / (replicated - start).norm()).item())
                del mine, replicated, start
            del state, batch
            torch.cuda.empty_cache()
    finally:
        for name, fn in exchanges.items():
            setattr(state_module, name, fn)
        state_module.clip_scale = clip_scale
    return out


def _rank_zero1_update(dev, tmp, rank, world):
    """ZeRO-1's update against the replicated one at the flagship's parameter
    shapes: two copies of the model from one seed, the same gradients given
    to both (random, this rank's own), three steps through
    ``train.state.apply_gradients`` (the gradients' exchange, the clip, both
    updates; the clip fires on the third): how far apart the parameters end,
    relative to the replicated run's whole update, and whether bit-equal.
    Unlike a train step this is repeatable on the card."""
    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, train_entry
    from vibertgrid_tpu_torch.parallel.sharding import shard_optimizer_state
    from vibertgrid_tpu_torch.train.state import apply_gradients

    plain, zero1 = (train_entry(device=dev, seed=0, config=FLAGSHIP_TRAIN)[0] for _ in range(2))
    shard_optimizer_state(zero1.optimizer, rank, world)
    flat = lambda model: torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    start = flat(plain.model)
    gen = torch.Generator(device=dev).manual_seed(rank)
    pairs = [(a, b) for ga, gb in zip(plain.optimizer.param_groups, zero1.optimizer.param_groups)
             for a, b in zip(ga["params"], gb["params"])]
    for step in range(3):
        loss = torch.tensor(20.0 if step == 2 else 1.0, device=dev)
        for a, b in pairs:
            a.grad = torch.randn(a.shape, device=dev, generator=gen)
            b.grad = a.grad.clone()
        for state in (plain, zero1):
            apply_gradients(state.optimizer, loss, True, 10.0, 2.0)
    want, got = flat(plain.model), flat(zero1.model)
    out = dict(split=len(zero1.optimizer.shards), bit_equal=torch.equal(got, want),
               ratio=((got - want).norm() / (want - start).norm()).item())
    del plain, zero1, want, got, start
    torch.cuda.empty_cache()
    return out


def _rank_driver(dev, tmp, rank, world):
    """``driver.main`` on the synthetic root for one epoch, replicated and
    with ZeRO-1: losses, the gathered F1 and fields, each step's and each
    validate batch's launches, the last validate's score rows, timings."""
    from vibertgrid_tpu_torch.train import driver

    out = {}
    for name in ("replicated", "zero1"):
        with _instrumented(driver) as rec:
            res = driver.main(["-c", os.path.join(tmp, f"dist_{name}.yaml"), "-d", "synthetic"])
        out[name] = dict(
            losses=_epoch_losses(res), f1=res["primary_F1"],
            fields={k: v["pred"] for k, v in res["per_sample"].items()},
            train=rec["train"], validate=rec["validate"], scores=rec["scores"][-1],
            timings=res["timings"], steps=res["final_state"].step)
        del res, rec
        torch.cuda.empty_cache()
    return out


def _rank_nccl(dev, tmp, rank, world):
    """A world of one on NCCL: one all-reduce, the fp32 step against
    ``fp32_reference.pt`` and the flagship bf16 train step through the
    data-parallel step (its gradient all-reduce on NCCL)."""
    import torch.distributed as dist

    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, train_entry
    from vibertgrid_tpu_torch.ops import kernels
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    x = torch.full((4,), 1.5, device=dev)
    dist.all_reduce(x)
    fp32 = _fp32_against_reference(dev, tmp, False, rank, world)
    state, train_step, batch = train_entry(device=dev, seed=0, config=FLAGSHIP_TRAIN)
    kernels.reset_launch_counts()
    _, loss = train_step(state, batch, SeedStream(0))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(3):
        train_step(state, batch, SeedStream(1))
    torch.cuda.synchronize()
    return dict(backend=dist.get_backend(), reduced=x.tolist(), loss=loss.item(),
                launches=launches, ms=1e3 * (time.perf_counter() - t0) / 3, fp32=fp32)


def _rank_collectives(dev, tmp, rank, world):
    """Gloo's collectives on the card at the size of the gradients (2²⁶ fp32
    a rank): each one's ms (host clock, median of 3), then one call whose
    input a kernel writes just before it, behind a 50 ms sleep on the
    stream, as the train step's packing copies do: the elements of its
    result wrong when the next kernel of the stream reads them, and after a
    device-wide sync (an input read before its kernel ran leaves them wrong
    for good)."""
    import torch.distributed as dist

    n = 2**26
    total = world * (world + 1) / 2  # Σ (rank + 1)
    mine = torch.full((n,), rank + 1.0, device=dev)
    cases = {
        "all_reduce": (lambda out: out.copy_(mine), lambda out: dist.all_reduce(out),
                       torch.full((n,), total, device=dev)),
        "reduce_scatter": (lambda out: out.fill_(-1.0),
                           lambda out: dist.reduce_scatter(out, list(mine.view(world, -1))),
                           torch.full((n // world,), total, device=dev)),
        "all_gather": (lambda out: out.fill_(-1.0),
                       lambda out: dist.all_gather(list(out.view(world, -1)),
                                                   mine[:n // world]),
                       (torch.arange(world, device=dev, dtype=torch.float32)[:, None] + 1)
                       .expand(world, n // world).reshape(-1)),
    }
    out = {}
    for name, (reset, call, want) in cases.items():
        got, ms = torch.empty_like(want), []
        for _ in range(3):
            reset(got)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(got)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        mine.fill_(-7.0)
        reset(got)
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # ~50 ms of the card's clock
        mine.fill_(rank + 1.0)
        if name == "all_reduce":
            got.copy_(mine)
        call(got)
        early = int((got != want).sum())  # the next kernel on this stream
        torch.cuda.synchronize()
        out[name] = dict(ms=statistics.median(ms), early=early, late=int((got != want).sum()))
    return out


# ---- tensor parallelism: mesh_model = 2 ----

TP_MODEL = 2
# a tensor-parallel step: kernels 1 and 4 on each rank's 6 heads, the FFN and
# the epilogue as plain products (their partial sums meet before the
# residual and the LayerNorm), the scatter and its backward once
TP_TRAIN_LAUNCHES = dict(TRAIN_LAUNCHES, fused_ffn_saved=0)
TP_VALIDATE_LAUNCHES = dict(SERVE_LAUNCHES, fused_ffn=0)
# per layer two sums of the partial products forward and two of the input
# gradients backward
TP_REDUCES = 4 * 12


def _tp_layout(world: int):
    from vibertgrid_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(world // TP_MODEL, TP_MODEL)


def _whole_params_equal(model, layout) -> bool:
    """Whether every rank holds rank 0's whole model bit for bit."""
    import torch.distributed as dist

    from vibertgrid_tpu_torch.parallel.sharding import gather_whole

    flat = torch.cat([t.reshape(-1) for t in gather_whole(dict(model.named_parameters()),
                                                          layout).values()])
    theirs = flat.clone()
    dist.broadcast(theirs, 0)
    return torch.equal(flat, theirs)


def _rank_tp_fp32(dev, tmp, rank, world):
    """fp32 at full width, dropout off, under mesh_model = 2: the step on the
    whole batch of 2 against the one-process step of ``fp32_reference.pt``
    (the watched gradients gathered whole)."""
    from vibertgrid_tpu_torch.entry import TRAIN_SHAPE, train_entry
    from vibertgrid_tpu_torch.parallel.mesh import shard_batch
    from vibertgrid_tpu_torch.parallel.sharding import gather_whole
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    layout = _tp_layout(world)
    ref = torch.load(os.path.join(tmp, "fp32_reference.pt"), weights_only=False)[False]
    cfg = dataclasses.replace(_fp32_dist_config(False), mesh=layout)
    state, train_step, batch = train_entry(device=dev, seed=6, config=cfg,
                                           shape=dict(TRAIN_SHAPE, b=2))
    _, loss = train_step(state, shard_batch(batch, layout.data_index, layout.data),
                         SeedStream(7))
    grads = gather_whole({n: state.model.get_parameter(n).grad for n in DIST_GRADS}, layout)
    out = dict(loss=loss.item(), want=ref["loss"], equal=_whole_params_equal(state.model, layout),
               errs={n: ((g.cpu() - ref["grads"][n]).norm() / ref["grads"][n].norm()).item()
                     for n, g in grads.items()})
    del state
    torch.cuda.empty_cache()
    return out


def _rank_tp_bf16(dev, tmp, rank, world):
    """The flagship bf16 step at bench.py's shapes under mesh_model = 2 (the
    whole batch of 16 on each model group), dropout 0.1: every step's
    launches, ms a step, device ms and the collectives (profiler), the
    activation all-reduces of one step each timed alone (count and host ms,
    each between two synchronisations), peak memory, the parameter bytes
    this rank holds, the losses."""
    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, train_entry
    from vibertgrid_tpu_torch.ops import kernels
    from vibertgrid_tpu_torch.parallel import collectives
    from vibertgrid_tpu_torch.parallel.mesh import shard_batch
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    layout = _tp_layout(world)
    state, train_step, batch = train_entry(device=dev, seed=0,
                                           config=dataclasses.replace(FLAGSHIP_TRAIN, mesh=layout))
    batch = shard_batch(batch, layout.data_index, layout.data)
    seeds, launches, losses = SeedStream(0), [], []

    def step():
        kernels.reset_launch_counts()
        _, loss = train_step(state, batch, seeds)
        torch.cuda.synchronize()
        launches.append(dict(kernels.LAUNCHES))
        losses.append(loss.item())

    step()  # warm
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(DIST_BF16_STEPS):
        step()
    ms = 1e3 * (time.perf_counter() - t0) / DIST_BF16_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = _step_profile(step)
    reduces, all_reduce = [], collectives._all_reduce

    def timed(x, op=collectives.dist.ReduceOp.SUM, group=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = all_reduce(x, op, group)
        torch.cuda.synchronize()
        if group is layout.model_group:
            reduces.append((1e3 * (time.perf_counter() - t0), x.numel() * x.element_size()))
        return y

    collectives._all_reduce = timed
    try:
        step()
    finally:
        collectives._all_reduce = all_reduce
    out = dict(ms=ms, launches=launches, losses=losses, peak_gib=peak,
               param_bytes=sum(p.numel() * p.element_size() for p in state.model.parameters()),
               reduce_count=len(reduces), reduce_ms=sum(t for t, _ in reduces),
               reduce_bytes=max((n for _, n in reduces), default=0),
               equal=_whole_params_equal(state.model, layout),
               **profile)
    del state, batch
    torch.cuda.empty_cache()
    return out


def _rank_tp_driver(dev, tmp, rank, world):
    """``driver.main`` for one epoch with ``mesh_model: 2``."""
    from vibertgrid_tpu_torch.train import driver

    with _instrumented(driver) as rec:
        res = driver.main(["-c", os.path.join(tmp, "dist_tp.yaml"), "-d", "synthetic"])
    out = dict(losses=_epoch_losses(res), f1=res["primary_F1"],
               fields={k: v["pred"] for k, v in res["per_sample"].items()},
               train=rec["train"], validate=rec["validate"], scores=rec["scores"][-1],
               timings=res["timings"], steps=res["final_state"].step)
    del res, rec
    torch.cuda.empty_cache()
    return out


def _check_tp_bf16(records, ranks, how: str) -> None:
    """The report on the ranks' ``_rank_tp_bf16``: launches, the activation
    all-reduces, times and memory; the ranks' losses and whole models equal."""
    what = f"tensor-parallel bf16 train step ({how}, mesh_model={TP_MODEL})"
    for rank, r in enumerate(ranks):
        b = r["_rank_tp_bf16"]
        for launches in b["launches"]:
            _assert_launches(records, launches, TP_TRAIN_LAUNCHES, f"{what} (rank {rank})")
        print(f"{what}, rank {rank}, {B} documents a model group: {b['ms']:.2f} ms a step, "
              f"{B / b['ms'] * 1e3:.2f} docs/s, device busy {b['device_ms']:.2f} ms a "
              f"rank-step, copies {b['copy_ms']:.2f} ms, waits {b['wait_ms']:.2f} ms "
              f"(profiler); activation all-reduces {b['reduce_count']} a step of "
              f"{b['reduce_bytes'] / 1e6:.2f} MB, {b['reduce_ms']:.2f} ms together (each timed "
              f"alone, host clock); profiler: collectives (count, ms, largest ms) {b['comms']}; "
              f"peak memory {b['peak_gib']:.2f} GiB, parameters {b['param_bytes'] / 2**20:.1f} "
              f"MiB a rank; losses {', '.join(f'{x:.4f}' for x in b['losses'])}")
        if rank == 0:
            print(f"  largest device rows, ms: {b['top']}")
        if b["reduce_count"] != TP_REDUCES:
            raise AssertionError(f"{what}: {b['reduce_count']} activation all-reduces a step")
        if not (all(x == x and abs(x) < 1e4 for x in b["losses"]) and b["equal"]):
            raise AssertionError(f"{what}: losses {b['losses']}, ranks equal {b['equal']}")
    if any(r["_rank_tp_bf16"]["losses"] != ranks[0]["_rank_tp_bf16"]["losses"] for r in ranks):
        raise AssertionError(f"{what}: the ranks report other losses")


def tp_phase(dev, records, tmp=None, root=None):
    """Tensor parallelism on the card (``--only tp``; the end of step 10): two
    gloo ranks share the card with ``mesh_model: 2``: the fp32 step at full
    width against one process, the flagship bf16 step, ``driver.main`` for an
    epoch, then ``eval.cli.main`` in this process on its checkpoint."""
    import tempfile

    from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root
    from vibertgrid_tpu_torch.eval import cli

    t_phase = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if tmp is None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            torch.save({False: dict(zip(("loss", "grads"), _fp32_dist_step(dev, False)[:2]))},
                       os.path.join(tmp, "fp32_reference.pt"))
            torch.cuda.empty_cache()
            root = make_synthetic_root(os.path.join(tmp, "data"), n_train=16, n_test=8, seed=0,
                                       words_range=(2, 6), segs_range=(8, 16))
        _driver_yaml(tmp, root, "dist_tp.yaml", end_epoch=1, eval_batch_size=1,
                     mesh_model=TP_MODEL, save_top=os.path.join(tmp, "weights_tp"))
        ranks = _spawn_ranks("tp", tmp, DIST_WORLD)
        _check_fp32(f"tensor-parallel fp32 (mesh_model={TP_MODEL}, 2 documents)",
                    [r["_rank_tp_fp32"] for r in ranks])
        _check_tp_bf16(records, ranks, "gloo, one card")

        got = [r["_rank_tp_driver"] for r in ranks]
        for rank, g in enumerate(got):
            for kind, want in (("train", TP_TRAIN_LAUNCHES), ("validate", TP_VALIDATE_LAUNCHES)):
                label = (f"tensor-parallel driver {kind} "
                         f"{'step' if kind == 'train' else 'batch'} (rank {rank})")
                for launches in g[kind]:
                    _assert_launches(records, launches, want, label)
        a, b = got
        if a["losses"] != b["losses"] or a["f1"] != b["f1"] or a["fields"] != b["fields"]:
            raise AssertionError("tensor-parallel driver: the ranks disagree")
        saved = [e for e in os.listdir(os.path.join(tmp, "weights_tp")) if e.startswith("epoch")]
        if len(saved) != 1:
            raise AssertionError(f"tensor-parallel driver: checkpoints {saved}")
        t = a["timings"]["train"][0]
        val = ", ".join(f"{x['docs'] / x['wall_s']:.2f}" for x in a["timings"]["validate"])
        print(f"tensor-parallel driver (mesh_model={TP_MODEL}, batch 2, gloo): {t['steps']} "
              f"steps, {t['docs'] / t['wall_s']:.2f} train docs/s ({t['wall_s']:.2f} s), "
              f"validate {val} docs/s (initial, final); losses "
              f"{', '.join(f'{x:.4f}' for x in a['losses'])}; F1 {a['f1']:.6f} on both ranks")
        evaluation = _driver_yaml(tmp, root, "tp_eval.yaml", eval_batch_size=1,
                                  weights=os.path.join(tmp, "weights_tp", saved[0]),
                                  result_dir=os.path.join(tmp, "result_tp"))
        with _instrumented(cli) as rec:
            res = cli.main(["-c", evaluation, "-d", "synthetic"])
        # one process sums the encoder's products whole, the ranks in two
        # halves: bf16 scores differ by roundings, so a class may differ only
        # where the top-2 margin is within twice the largest difference
        ours, theirs = _sorted_rows(rec["scores"][0]), _sorted_rows(a["scores"])
        fields = {k: v["pred"] for k, v in res["per_sample"].items()}
        err = _max_err(ours, theirs)
        top2 = theirs.float().topk(2, dim=-1).values
        flips = ours.argmax(-1) != theirs.argmax(-1)
        near = (top2[:, 0] - top2[:, 1]) <= 2 * err
        print(f"eval CLI (one process) on the tensor-parallel {saved[0]}: F1 "
              f"{res['primary_F1']:.6f}, the ranks' validate {a['f1']:.6f}; fields equal: "
              f"{fields == a['fields']}; segments of another class {int(flips.sum())} of "
              f"{len(ours)}, all at top-2 margins within {2 * err:.3e}: "
              f"{bool((near | ~flips).all())} (max |score difference| {err:.3e})")
        if (res["primary_F1"] != a["f1"] or bool((flips & ~near).any())
                or (fields != a["fields"] and not bool(flips.any()))):
            raise AssertionError("eval CLI: differs from the tensor-parallel validate")
    print(f"tensor-parallel phase: {time.perf_counter() - t_phase:.1f} s")


RANK_PARTS = {"nccl": (_rank_nccl,), "gloo": (_rank_collectives, _rank_zero1_update,
                                               _rank_fp32, _rank_bf16, _rank_driver),
              "tp": (_rank_tp_fp32, _rank_tp_bf16, _rank_tp_driver),
              "nccl_cards": (_rank_zero1_update, _rank_bf16, _rank_tp_bf16)}


def rank_main(part: str, tmp: str) -> int:
    """One rank of the distributed phase (``--rank PART DIR``): joins the
    group the environment describes (gloo for the two ranks on one card,
    else NCCL), runs the part and writes its results to
    ``DIR/PART_<rank>.pt``."""
    import torch.distributed as dist

    from vibertgrid_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh.init_distributed_mode(backend="gloo" if part in ("gloo", "tp") else None)
    rank, world = mesh.get_rank(), mesh.get_world_size()
    dev = torch.device("cuda", mesh.local_device_index())
    torch.cuda.set_device(dev)
    out = {fn.__name__: fn(dev, tmp, rank, world) for fn in RANK_PARTS[part]}
    torch.save(out, os.path.join(tmp, f"{part}_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spawn_ranks(part: str, tmp: str, world: int) -> list:
    """Run ``part`` in ``world`` rank processes of this script on the card; their
    results in rank order. A rank that fails stops the others and fails the
    phase, with every rank's last lines."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(os.path.join(tmp, f"{part}_{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", part, tmp], cwd=HERE,
        stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
        for r in range(world)]
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        for r, p in enumerate(procs):
            with open(os.path.join(tmp, f"{part}_{r}.log")) as f:
                tail = f.read()[-4000:]
            print(f"--- {part} rank {r} exited {p.returncode}:\n{tail}")
        raise AssertionError(f"distributed {part}: a rank failed")
    return [torch.load(os.path.join(tmp, f"{part}_{r}.pt"), weights_only=False)
            for r in range(world)]


def _sorted_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` in lexicographic order (one order for equal sets)."""
    for c in reversed(range(x.shape[1])):
        x = x[torch.sort(x[:, c], stable=True).indices]
    return x


def _check_zero1_update(ranks, how: str) -> None:
    """Each rank's ``_rank_zero1_update`` within ``ZERO1_PARAM_RTOL``."""
    for rank, r in enumerate(ranks):
        x = r["_rank_zero1_update"]
        print(f"ZeRO-1 update against the replicated one ({how}), rank {rank}, {x['split']} "
              f"split leaves, 3 steps of the same gradients: parameters {x['ratio']:.3e} of "
              f"the update apart, bit-equal: {x['bit_equal']}")
        if not x["ratio"] <= ZERO1_PARAM_RTOL:
            raise AssertionError(f"ZeRO-1's update is not the replicated one ({how}): {x}")


def _check_bf16(records, ranks, how: str, what0: str) -> None:
    """Step 10 (3)'s report on the ranks' ``_rank_bf16``: launches, times,
    the ranks' losses equal, ZeRO-1 against the replicated run, the state
    each rank keeps."""
    world = len(ranks)
    for zero1 in (False, True):
        what = f"{what0}{', ZeRO-1' if zero1 else ''}"
        for rank, r in enumerate(ranks):
            b = r["_rank_bf16"][zero1]
            for launches in b["launches"]:
                _assert_launches(records, launches, TRAIN_LAUNCHES, f"{what} (rank {rank})")
            print(f"{what}, rank {rank} of {world} ({how}), {B // world} "
                  f"documents a rank: {b['ms']:.2f} ms a step, {B / b['ms'] * 1e3:.2f} global "
                  f"docs/s, device busy {b['device_ms']:.2f} ms a step, copies "
                  f"{b['copy_ms']:.2f} ms, waits {b['wait_ms']:.2f} ms (profiler), gradient "
                  f"exchange {b['reduce_ms']:.2f} ms (median, host clock); profiler: "
                  f"collectives (count, ms, largest ms) {b['comms']}; peak memory "
                  f"{b['peak_gib']:.2f} GiB, optimizer state {b['state_bytes'] / 2**20:.1f} MiB "
                  f"of {b['replicated_bytes'] / 2**20:.1f} MiB; losses "
                  f"{', '.join(f'{x:.4f}' for x in b['losses'])}")
            if rank == 0:
                print(f"  largest device rows, ms: {b['top']}")
            if not (all(x == x and abs(x) < 1e4 for x in b["losses"]) and b["equal"]):
                raise AssertionError(f"{what}: losses {b['losses']}, ranks equal {b['equal']}")
        losses = [r["_rank_bf16"][zero1]["losses"] for r in ranks]
        if any(x != losses[0] for x in losses):
            raise AssertionError(f"{what}: the ranks report other losses")
    for rank, r in enumerate(ranks):
        z, plain = r["_rank_bf16"][True], r["_rank_bf16"][False]
        print(f"{what0}, ZeRO-1 against replicated ({how}), rank {rank}: parameters after "
              f"{len(z['losses'])} steps {z['param_ratio']:.3e} of the update apart "
              f"(bit-equal: {z['bit_equal']}), every loss bit-equal: "
              f"{z['losses'] == plain['losses']}; clip factors, replicated "
              f"{plain['scales']}, ZeRO-1 {z['scales']}")
        # the step is bit-repeatable and ZeRO-1's update elementwise: the
        # whole trajectory is the replicated one's
        if z["losses"] != plain["losses"] or not z["bit_equal"]:
            raise AssertionError(f"ZeRO-1: losses {z['losses']} vs {plain['losses']}, "
                                 f"parameters bit-equal {z['bit_equal']}")
    kept = [r["_rank_bf16"][True]["state_bytes"] / r["_rank_bf16"][True]["replicated_bytes"]
            for r in ranks]
    if not all(0.45 < k < 0.6 for k in kept):
        raise AssertionError(f"ZeRO-1: each rank keeps {kept} of the optimizer state")


def nccl_cards_phase(records):
    """``--only nccl`` (two cards or more): step 10 (3) with two NCCL ranks,
    one a card, as torchrun would start them: ZeRO-1's update against the
    replicated one, then the bf16 flagship step at 8 documents a rank
    without and with ZeRO-1 (its gradients reduce-scattered and its updated
    slices all-gathered by NCCL)."""
    import tempfile

    if torch.cuda.device_count() < DIST_WORLD:
        raise AssertionError(f"--only nccl needs {DIST_WORLD} cards, the host has "
                             f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _spawn_ranks("nccl_cards", tmp, DIST_WORLD)
    _check_zero1_update(ranks, "NCCL, one card a rank")
    _check_bf16(records, ranks, "NCCL, one card a rank", "NCCL bf16 train step")
    _check_tp_bf16(records, ranks, "NCCL, one card a rank")


def distributed_phase(dev, records):
    """Step 10: the distributed layer on the card, ranks as subprocesses."""
    import gc
    import tempfile

    from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root
    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, train_entry
    from vibertgrid_tpu_torch.eval import cli
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # the one-process references: the fp32 step, the flagship bf16 step
        torch.save({ohem: dict(zip(("loss", "grads"), _fp32_dist_step(dev, ohem)[:2]))
                    for ohem in (False, True)}, os.path.join(tmp, "fp32_reference.pt"))
        state, train_step, batch = train_entry(device=dev, seed=0, config=FLAGSHIP_TRAIN)
        bf16_want = train_step(state, batch, SeedStream(0))[1].item()
        del state, train_step, batch
        gc.collect()
        torch.cuda.empty_cache()

        # 1. NCCL, a world of one
        (nccl,) = (r["_rank_nccl"] for r in _spawn_ranks("nccl", tmp, 1))
        _assert_launches(records, nccl["launches"], TRAIN_LAUNCHES, "distributed NCCL train step")
        print(f"distributed, NCCL world of 1: backend {nccl['backend']}, all_reduce "
              f"{nccl['reduced']}, flagship bf16 B={B} step loss {nccl['loss']:.6f}, one "
              f"process {bf16_want:.6f}, {nccl['ms']:.2f} ms a step")
        if nccl["backend"] != "nccl" or nccl["reduced"] != [1.5] * 4:
            raise AssertionError("distributed: the NCCL bootstrap failed")
        if not abs(nccl["loss"] - bf16_want) <= DIST_BF16_LOSS_RTOL * abs(bf16_want):
            raise AssertionError(f"distributed NCCL: bf16 loss {nccl['loss']} vs {bf16_want}")
        _check_fp32("distributed fp32, NCCL world of 1", [nccl["fp32"]])

        # the driver's data and configs
        root = make_synthetic_root(os.path.join(tmp, "data"), n_train=16, n_test=8, seed=0,
                                   words_range=(2, 6), segs_range=(8, 16))
        for name, extra in (("replicated", {}), ("zero1", {"zero1": True})):
            _driver_yaml(tmp, root, f"dist_{name}.yaml", end_epoch=1, eval_batch_size=1,
                         save_top=os.path.join(tmp, f"weights_{name}"), **extra)
        ranks = _spawn_ranks("gloo", tmp, DIST_WORLD)

        # gloo's collectives on the card (what ZeRO-1's exchange may use
        # there), and ZeRO-1's update through them
        _check_zero1_update(ranks, "gloo, one card")
        for rank, r in enumerate(ranks):
            c = r["_rank_collectives"]
            print(f"gloo collectives on the card, rank {rank}, 256 MiB a rank: " + "; ".join(
                f"{k} {v['ms']:.2f} ms; its input written just before it: {v['early']} "
                f"elements wrong for the next kernel of the stream, {v['late']} after a sync"
                for k, v in c.items()))
            if any(v["early"] or v["late"] for v in c.values()):
                raise AssertionError(f"gloo's collectives on the card wrong: {c}")

        # 2. fp32 at full width: two ranks x 1 document against one process x 2
        for ohem in (False, True):
            _check_fp32(f"distributed fp32, ohem_random={ohem}",
                        [r["_rank_fp32"][ohem] for r in ranks])

        # 3. bf16 at bench.py's shapes, 8 documents a rank, without and with ZeRO-1
        _check_bf16(records, ranks, "gloo, one card", "distributed bf16 train step")

        # 4. driver.main on two ranks, then the eval CLI in one process
        for name in ("replicated", "zero1"):
            got = [r["_rank_driver"][name] for r in ranks]
            for rank, g in enumerate(got):
                for kind, want in (("train", TRAIN_LAUNCHES), ("validate", SERVE_LAUNCHES)):
                    label = f"distributed driver {kind} {'step' if kind == 'train' else 'batch'}"
                    for launches in g[kind]:
                        _assert_launches(records, launches, want, f"{label} (rank {rank})")
            a, b = got
            if a["losses"] != b["losses"] or a["f1"] != b["f1"] or a["fields"] != b["fields"]:
                raise AssertionError(f"distributed driver ({name}): the ranks disagree")
            saved = [e for e in os.listdir(os.path.join(tmp, f"weights_{name}"))
                     if e.startswith("epoch")]
            if len(saved) != 1:
                raise AssertionError(f"distributed driver ({name}): checkpoints {saved}")
            t = a["timings"]["train"][0]
            val = ", ".join(f"{x['docs'] / x['wall_s']:.2f}" for x in a["timings"]["validate"])
            print(f"distributed driver ({name}, 2 ranks x batch 2, gloo): {t['steps']} steps, "
                  f"{t['docs'] / t['wall_s']:.2f} global train docs/s ({t['wall_s']:.2f} s, "
                  f"{t['loader_wait_s']:.2f} s waiting on the loader), validate {val} docs/s "
                  f"(initial, final); losses {', '.join(f'{x:.4f}' for x in a['losses'])}; "
                  f"F1 {a['f1']:.6f} on both ranks")
            if name == "replicated":
                evaluation = _driver_yaml(tmp, root, "dist_eval.yaml", eval_batch_size=1,
                                          weights=os.path.join(tmp, f"weights_{name}", saved[0]),
                                          result_dir=os.path.join(tmp, "result"))
                with _instrumented(cli) as rec:
                    res = cli.main(["-c", evaluation, "-d", "synthetic"])
                ours = _sorted_rows(rec["scores"][0])
                theirs = _sorted_rows(torch.cat([r["_rank_driver"][name]["scores"]
                                                 for r in ranks]))
                fields = {k: v["pred"] for k, v in res["per_sample"].items()}
                same = torch.equal(ours.argmax(-1), theirs.argmax(-1))
                print(f"eval CLI (one process) on {saved[0]}: F1 {res['primary_F1']:.6f}, the "
                      f"ranks' gathered validate {a['f1']:.6f}; fields equal: "
                      f"{fields == a['fields']}; every segment's class equal: {same} "
                      f"({len(ours)} segments, max |score difference| "
                      f"{_max_err(ours, theirs):.3e})")
                if res["primary_F1"] != a["f1"] or fields != a["fields"] or not same:
                    raise AssertionError("eval CLI: differs from the gathered validate")

        # 5. tensor parallelism, mesh_model = 2
        tp_phase(dev, records, tmp, root)
    print(f"distributed phase: {time.perf_counter() - t_phase:.1f} s")


def roi_align_card_vs_host(dev):
    """RoIAlign in fp32, card against host, on boxes whose bins are whole
    numbers of feature pixels (sides of 28·k image pixels at stride 4): there
    a bin size one ulp off changes the number of samples a bin averages."""
    from vibertgrid_tpu_torch.ops.roi_align import roi_align

    feats = torch.randn(1, 64, 64, 32, generator=torch.Generator().manual_seed(13))
    k = torch.arange(1, 9)
    boxes = torch.stack([4 * k, 2 * k, 32 * k, 30 * k], -1)[None].to(torch.int32)
    mask = torch.ones(1, 8, dtype=torch.bool)
    want = roi_align(feats, boxes, mask)
    err = _max_err(roi_align(feats.to(dev), boxes.to(dev), mask.to(dev)).cpu(), want)
    print(f"roi_align fp32 on whole-pixel bins, card vs host: max |diff| {err:.3e}")
    if not err <= FP32_KERNEL_TOL["atol"]:
        raise AssertionError(f"roi_align: card differs from host on whole-pixel bins: {err}")


def check_scatter_serving(dev, engine, ragged, wide_doc):
    """Kernel 3 bit for bit against its twin on the boxes the serving batches
    collated: S = 256 on the ragged batch's 832 x 512 canvas, S = 512."""
    from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter
    from vibertgrid_tpu_torch.ops.rasterize import bertgrid_scatter

    g = torch.Generator(device=dev).manual_seed(12)
    for reqs in (ragged, [wide_doc]):
        batch, _ = engine.collator([engine._make_sample(*r) for r in reqs], train=False)
        boxes = torch.from_numpy(batch.boxes).to(dev)
        mask = torch.from_numpy(batch.box_mask).to(dev)
        b, s = mask.shape
        h, w = batch.images.shape[1:3]
        emb = torch.randn(b, s, 768, generator=g, device=dev).bfloat16()
        kw = dict(height=h // 8, width=w // 8, stride=8)
        got, want = grid_scatter(emb, boxes, mask, **kw), bertgrid_scatter(emb, boxes, mask, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"bertgrid_scatter at S={s}: kernel differs from twin")
        ms = _time_ms(lambda: grid_scatter(emb, boxes, mask, **kw))
        print(f"bertgrid_scatter at serving shape B={b} S={s} grid {h // 8}x{w // 8}: bit-equal to "
              f"its twin, {ms:.4f} ms")


def http_round_trip(engine, requests):
    """``serve()`` on localhost with a stub OCR service: one POST to
    ``/core`` a request, its PNG page; the answers and the scores behind them
    equal ``predict``'s on the decoded page and the OCR segments."""
    import io
    import urllib.request
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from vibertgrid_tpu_torch.serve.app import serve

    ocr_reply = {}

    class StubOcr(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body = json.dumps(ocr_reply["api"]).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    ocr = ThreadingHTTPServer(("127.0.0.1", 0), StubOcr)
    threading.Thread(target=ocr.serve_forever, daemon=True).start()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    engine.ocr_url = f"http://127.0.0.1:{ocr.server_address[1]}/ocr"
    threading.Thread(target=serve, args=(engine,), kwargs={"port": port}, daemon=True).start()
    times, answers = [], []
    try:
        for image, texts, boxes in requests:
            # eng_line reads corners 0, 1 and 2, 5 of each line's position
            ocr_reply["api"] = {"code": 200, "result": {"lines": [
                {"text": t, "position": [x0, y0, x1, y0, x1, y1, x0, y1], "char_positions": []}
                for t, (x0, y0, x1, y1) in zip(texts, boxes)]}}
            pixels = np.rint(image * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(pixels).save(buf, format="PNG")
            body = (b'--b\r\nContent-Disposition: form-data; name="file"; filename="p.png"\r\n'
                    b"Content-Type: image/png\r\n\r\n" + buf.getvalue() + b"\r\n--b--\r\n")
            req = urllib.request.Request(f"http://127.0.0.1:{port}/core", data=body,
                                         headers={"Content-Type": 'multipart/form-data; boundary="b"'})
            deadline = time.time() + 30
            formed = []
            _counted(engine, formed)  # the server's thread dispatches the POST
            try:
                while True:
                    try:
                        t0 = time.perf_counter()
                        with urllib.request.urlopen(req, timeout=60) as r:
                            answer = json.loads(r.read())
                        times.append(time.perf_counter() - t0)
                        break
                    except OSError:
                        if time.time() > deadline:
                            raise
                        time.sleep(0.2)
            finally:
                del engine._dispatch
            (want,), scores = _answers(engine, [(pixels.astype(np.float32) / 255.0, texts, boxes)])
            (_, (pred, aux, _, _), _), = formed
            got = pred.float().cpu()[0, :aux.n_segments[0]]
            if answer != {"result": want} or not torch.equal(got, scores[0]):
                raise AssertionError(f"HTTP answer {answer} differs from predict {want}")
            answers.append(want)
    finally:
        ocr.shutdown()
        engine.ocr_url = DEPLOYMENT_HYP["ocr_url"]
    _fields_compared("HTTP answers vs predict", answers)
    print(f"HTTP /core round trip with a stub OCR service: {len(requests)} POSTs answered as "
          f"predict with equal scores, {', '.join(f'{t * 1e3:.1f}' for t in times)} ms each (the first includes "
          f"the server's start)")


def attention_times(dev, tree):
    """Device time of the attention forward and backward at the flagship
    shape, with and without dropout, beside the twin's and the library
    call's, through ``flash_attention`` and autograd alone."""
    from vibertgrid_tpu_torch.ops.flash_attention import attention_reference, flash_attention

    nh, dh = 12, 64
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, valid, bias = _attention_inputs(dev, B, T + 2, nh, dh, g)
    d_out = torch.randn(B, T + 2, nh * dh, generator=g, device=dev).bfloat16()
    args = (q, k, v, bias, dh ** -0.5, nh)
    heads = [x.view(B, T + 2, nh, dh).transpose(1, 2).requires_grad_() for x in (q, k, v)]
    mask = valid[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(*heads, attn_mask=mask)

    def backward_ms(rate):
        """Device ms of one backward, and of each of its kernels by name."""
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, bias, dh ** -0.5, nh, rate=rate, seed=DROP_SEED)
        run = lambda: torch.autograd.grad(out, leaves, d_out, retain_graph=True)
        ms = _time_ms(run)
        parts = ", ".join(f"{k} {kms:.4f}"
                          for k, kms, _ in _kernel_ms_by_name(run, r"attention_bwd_[a-z]+"))
        return f"{ms:.4f} ({parts})"

    with torch.no_grad():
        fwd = _time_ms(lambda: flash_attention(*args))
        fwd_drop = _time_ms(lambda: flash_attention(*args, rate=DROP_RATE, seed=DROP_SEED))
        twin = _time_ms(lambda: attention_reference(*args))
        lib = _time_ms(sdpa)
    bwd, bwd_drop = backward_ms(0.0), backward_ms(DROP_RATE)
    sdpa_out = sdpa()
    d_heads = d_out.view(B, T + 2, nh, dh).transpose(1, 2)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(sdpa_out, heads, d_heads, retain_graph=True))
    print(f"attention kernels of {tree}, B={B} H={nh} T={T + 2} D={dh} bf16, device ms: "
          f"forward {fwd:.4f}, with dropout {DROP_RATE} {fwd_drop:.4f}, twin {twin:.4f}, "
          f"sdpa {lib:.4f}; backward {bwd}, with dropout {bwd_drop}, "
          f"sdpa backward {lib_bwd:.4f}")


def ffn_times(dev, tree):
    """Device time of the FFN kernels (2 and 5) at the flagship shape, with
    and without dropout, beside the twin's and the library chain's, through
    ``fused_ffn`` and ``fused_ffn_saved`` alone (given bf16 weights, which
    they take as they are); each kernel launch's device time by name from
    the profiler; and the host's time a call (``_host_us``)."""
    from vibertgrid_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn, fused_ffn_saved

    g = torch.Generator(device=dev).manual_seed(2)
    d, f = 768, 3072
    params = _ffn_params(dev, g, d, f)
    x = torch.randn(B * (T + 2), d, generator=g, device=dev).bfloat16()
    runs = {
        "fused_ffn": lambda: fused_ffn(x, *params, 1e-12),
        "fused_ffn dropout": lambda: fused_ffn(x, *params, 1e-12, rate=DROP_RATE, seed=DROP_SEED),
        "fused_ffn_saved": lambda: fused_ffn_saved(x, *params, 1e-12),
        "fused_ffn_saved dropout": lambda: fused_ffn_saved(x, *params, 1e-12, rate=DROP_RATE,
                                                           seed=DROP_SEED),
    }
    parts = []
    with torch.no_grad():
        times = {name: _time_ms(fn) for name, fn in runs.items()}
        twin = _time_ms(lambda: ffn_reference(x, *params, 1e-12), iters=5)
        for name, fn in runs.items():
            parts += [f"{name}: {k} {kms:.4f}"
                      for k, kms, _ in _kernel_ms_by_name(fn, r"[a-z_]*ffn[a-z_]*<[^>]*>")]
        host = _host_us(runs, "vg_fused_ffn")
    chain = _ffn_chain_ms(x, params)
    print(f"FFN kernels of {tree}, N={x.shape[0]} D={d} F={f} bf16, device ms: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in times.items())}; twin {twin:.4f}; "
          f"library chain {chain:.4f}; by launch: {'; '.join(parts)}")
    print(f"FFN host us a call of {tree} (median of 40, card busy), C call vg_fused_ffn / "
          f"whole wrapper: {', '.join(f'{k} {c:.1f} / {w:.1f}' for k, (c, w) in host.items())}")


def _host_us(runs, c_name: str, calls: int = 40):
    """Host microseconds of one call of the C entry ``c_name`` (for the wgmma
    bodies it encodes the tensor maps and launches) and of one whole wrapper
    call, for each of ``runs``: medians over ``calls`` calls queued behind a
    spin kernel, so that no call waits for the card."""
    from vibertgrid_tpu_torch.ops import kernels

    lib = kernels.library()
    c_call, c_us = getattr(lib, c_name), []

    def timed(*args):
        t0 = time.perf_counter()
        err = c_call(*args)
        c_us.append((time.perf_counter() - t0) * 1e6)
        return err

    out = {}
    setattr(lib, c_name, timed)
    try:
        for name, fn in runs.items():
            c_us.clear()
            wrapper_us = []
            torch.cuda._sleep(40_000_000)  # ~20 ms, longer than the host takes to queue
            for _ in range(calls):
                t0 = time.perf_counter()
                fn()
                wrapper_us.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            out[name] = (statistics.median(c_us), statistics.median(wrapper_us))
    finally:
        setattr(lib, c_name, c_call)
    return out


def _kernel_ms_by_name(fn, pattern: str, calls: int = 5):
    """``[(kernel name, device ms a launch, launches a call)]`` of the kernels
    whose profiler name matches ``pattern``, over ``calls`` calls of ``fn``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(re.search(pattern, e.key).group(), e.self_device_time_total / e.count / 1e3,
             e.count / calls) for e in prof.key_averages() if re.search(pattern, e.key)]


def proj_ln_times(dev, tree):
    """Device time of the attention epilogue (kernel 7) at the flagship shape
    (N = 8192, D = 768, bf16), with and without dropout, beside the twin's,
    the library chain's ``F.layer_norm(res + F.linear(ctx, W, b))`` and the
    bound, through ``fused_proj_ln`` alone (given bf16 W, which it takes as
    it is); the kernel that ran, by name; and the host's time a call."""
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_proj_ln, proj_ln_reference

    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(9)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    d, n = 768, B * (T + 2)
    w, b, gamma, beta = randn(d, d) * d ** -0.5, randn(d) * 0.1, 1 + 0.1 * randn(d), 0.1 * randn(d)
    params = (w.bfloat16(), b, gamma, beta)
    bf = tuple(p.bfloat16() for p in (w, b, gamma, beta))
    ctx, res = randn(n, d).bfloat16(), randn(n, d).bfloat16()
    runs = {
        "fused_proj_ln": lambda: fused_proj_ln(ctx, res, *params, 1e-12),
        "fused_proj_ln dropout": lambda: fused_proj_ln(ctx, res, *params, 1e-12, rate=DROP_RATE,
                                                       seed=DROP_SEED),
    }
    with torch.no_grad():
        times = {name: _time_ms(fn) for name, fn in runs.items()}
        twin = _time_ms(lambda: proj_ln_reference(ctx, res, *params, 1e-12), iters=5)
        chain = _time_ms(lambda: F.layer_norm(res + F.linear(ctx, bf[0], bf[1]), (d,), bf[2],
                                              bf[3], 1e-12))
        parts = [f"{name}: {k} {ms:.4f} x{count:g}" for name, fn in runs.items()
                 for k, ms, count in _kernel_ms_by_name(fn, r"[a-z_]*(proj_ln|ffn_down_ln)"
                                                            r"[a-z_]*<[^>]*>")]
        host = _host_us(runs, "vg_fused_proj_ln")
    bound_ms, bound_by = _proj_ln_bound(n, d)
    print(f"attention epilogue kernel of {tree}, N={n} D={d} bf16, device ms: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in times.items())}; twin {twin:.4f}; library "
          f"chain F.layer_norm(res + F.linear(ctx, W, b)) {chain:.4f}; bound {bound_ms:.4f} "
          f"({bound_by}); by launch: {'; '.join(parts)}")
    print(f"attention epilogue host us a call of {tree} (median of 40, card busy), C call "
          f"vg_fused_proj_ln / whole wrapper: "
          f"{', '.join(f'{k} {c:.1f} / {w:.1f}' for k, (c, w) in host.items())}")


def scatter_bwd_times(dev, tree):
    """Device time of the scatter backward (kernel 6) at the flagship's grid
    (64 x 48 cells, D = 768, bf16) on two sets of boxes: the check's, under a
    page-wide box, and ``make_batch``'s own; beside the twin's, ``index_add_``'s
    and the bound, through ``grid_scatter`` and autograd alone; each kernel
    of a call by name, with its launches a call."""
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter, scatter_backward_reference

    g = torch.Generator(device=dev).manual_seed(8)
    height, width, d = H // 8, W // 8, 768
    batch = make_batch(B, H, W, T, S, VOCAB, seed=0, device=dev)
    lines = []
    for name, (boxes, mask) in (("page box", _scatter_inputs(dev)),
                                ("flagship boxes", (batch.boxes, batch.box_mask))):
        emb = torch.randn(B, S, d, generator=g, device=dev).bfloat16().requires_grad_()
        d_out = torch.randn(B, height, width, d, generator=g, device=dev).bfloat16()
        out = grid_scatter(emb, boxes, mask, height=height, width=width, stride=8)

        def run():
            return torch.autograd.grad(out, emb, d_out, retain_graph=True)

        ms = _time_ms(run)
        with torch.no_grad():
            plain = _time_ms(lambda: scatter_backward_reference(d_out, boxes, mask, stride=8))
            library = _index_add_ms(d_out, boxes, mask)
        bound_ms, bound_by = _scatter_bwd_bound(d_out, boxes, mask)
        parts = ", ".join(f"{k} {kms:.4f} x{count:g}"
                          for k, kms, count in _kernel_ms_by_name(run, r"scatter_bwd[a-z_]*"))
        lines.append(f"{name}: {ms:.4f} (by launch: {parts}), twin {plain:.4f}, index_add_ "
                     f"{library:.4f}, bound {bound_ms:.4f} ({bound_by})")
    print(f"scatter backward kernel of {tree}, B={B} {height}x{width} D={d} bf16, device ms: "
          + "; ".join(lines))


KERNEL_MODES = {"attention": attention_times, "ffn": ffn_times, "proj_ln": proj_ln_times,
                "scatter_bwd": scatter_bwd_times}


def main(argv) -> int:
    tree = HERE
    kernel_modes = [["--only", mode] for mode in (*KERNEL_MODES, "determinism")]
    if len(argv) == 4 and argv[:2] in kernel_modes and argv[2] == "--tree":
        tree, argv = os.path.abspath(argv[3]), argv[:2]
    rank_mode = len(argv) == 3 and argv[0] == "--rank" and argv[1] in RANK_PARTS
    phases = ("flagship", "bench", "host_ops", "serve", "driver", "distributed", "tp", "nccl")
    if not rank_mode and argv not in ([], *(["--only", m] for m in phases), *kernel_modes):
        print(f"usage: python3 chip_smoke.py [--only {' | --only '.join(phases)} | "
              f"--only {'|'.join((*KERNEL_MODES, 'determinism'))} [--tree DIR]]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, tree)
    if rank_mode:  # one rank of the distributed phase, started by it
        return rank_main(argv[1], argv[2])
    from vibertgrid_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    uuid = subprocess.run(["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.split()[0]
    print(f"host {socket.gethostname()}, card {uuid}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if argv == ["--only", "determinism"]:  # step 4's pin, with the library's diagnosis
        determinism(dev, tree, probe=True)
        print(smi)
        return 0
    if argv in kernel_modes:  # one kernel or pair alone, for comparing trees
        KERNEL_MODES[argv[1]](dev, tree)
        print(smi)
        return 0
    if argv == ["--only", "host_ops"]:  # the collate's C++ host ops alone
        host_ops_phase(dev, smi)
        print(smi)
        return 0
    if argv == ["--only", "serve"]:  # serving steps 1-5, for comparing trees
        serving(dev, [], full=False)
        print(smi)
        return 0
    if argv == ["--only", "driver"]:  # the training driver and the eval CLI alone
        driver_phase(dev, [])
        print(smi)
        return 0
    if argv == ["--only", "distributed"]:  # step 10 alone
        distributed_phase(dev, [])
        print(smi)
        return 0
    if argv == ["--only", "nccl"]:  # step 10 (3) and the TP step on NCCL across two cards
        nccl_cards_phase([])
        print(smi)
        return 0
    if argv == ["--only", "tp"]:  # step 10 (5): tensor parallelism alone
        tp_phase(dev, [])
        print(smi)
        return 0
    if argv == ["--only", "bench"]:  # bench.py's line, for comparing trees
        bench_line(flagship_forward(dev, []), flagship_train(dev, []), two_window_forward(dev))
        print(smi)
        return 0
    if argv:  # the two end-to-end numbers of the flagship, for comparing trees
        flagship_forward(dev, [])
        flagship_train(dev, [])
        print(smi)
        return 0
    from vibertgrid_tpu_torch.entry import FLAGSHIP, FLAGSHIP_TRAIN, FULL_FUSED

    # roberta-base's shapes on the flagship: vocabulary 50265, 514 positions,
    # pad id 1 (positions count from 2), <s> 0 and </s> 2
    roberta = dataclasses.replace(FLAGSHIP, bert_version="roberta-base", cls_token_id=0,
                                  sep_token_id=2)

    records = [check(dev) for check in (
        check_attention, check_attention_bwd, check_ffn, check_ffn_saved, check_proj_ln,
        check_scatter, check_scatter_bwd)]
    forward = flagship_forward(dev, records)
    train = flagship_train(dev, records)
    determinism(dev)
    bench_line(forward, train, two_window_forward(dev))
    full_fused_forward(dev, records)
    full_fused_train(dev, records)
    crf_fused(dev, records)
    fp32_card_vs_host(dev, FLAGSHIP, "flagship")
    fp32_card_vs_host(dev, roberta, "roberta-base", vocab=50265, pad_id=1)
    fp32_train_card_vs_host(dev, FLAGSHIP_TRAIN, "flagship", ())
    fp32_card_vs_host(dev, FULL_FUSED, "full head, fused epilogue")
    fp32_train_card_vs_host(
        dev, FULL_FUSED, "full head, fused epilogue",
        ("bert_model.layer.0.attention.out.weight", "field_type_head.pos_neg_net.out.weight",
         "semantic_segmentation_head.binary_bank.weight"))
    fp32_crf_decode_card_vs_host(dev)
    host_ops_phase(dev, smi)
    serving(dev, records)
    driver_phase(dev, records)
    distributed_phase(dev, records)

    # a kernel's launches: those of this slice's path, a train step of the
    # driver, else a validate batch of the driver, where it runs there, else
    # those of the first path that ran it
    for r in records:
        paths = r["paths"]
        r["launches"] = paths.get("driver train step", paths.get(
            "driver validate batch", next(iter(paths.values()))))
    print("launches by path: " + json.dumps({r["name"]: r["paths"] for r in records}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
