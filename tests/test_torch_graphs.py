"""The train step's seeds, schedule scalars and syncs on the device, and its
CUDA graphs (``train/state.py``, ``train/seeds.py``, ``train/optim.py``).

On the CPU, each held to the values the step took before they moved there:

- hash dropout with a device-slot seed against the int seed, and against
  the mask-and-factor formulation it replaced, bit for bit;
- the twins' dropouts and the sampled losses' keys with slot seeds;
- ``_weighted_threshold``'s gather against indexing by the 0-d position,
  on ties and on a count that is not reached;
- the optimizer's update (host floats from its table) against the
  host-float update from the schedules, bit for bit, past the schedules' end;
- the step's seed tensor: slot *i* is the stream's *i*-th draw;
- CPU steps stay eager, and their second step (seeds on the device) takes
  the first step's path's values;
- what the update kernel takes (fp32 parameters and gradients, bf16 or
  fp32 state, any strides; anything else raises; CPU updates take the
  library's passes and read a ``fused_share`` of 0, which marks the
  ``optimizer`` range), its descriptor lists' layout (one row a contiguous
  run: a slice along a later axis, a strided view, a contiguous state beside
  a sliced parameter) and their cache (the same pointers reuse a list, a new
  ``.grad`` builds one, a capture that finds none raises; the CPU builds
  none), and the clip's sum of squares against the library's fp64 norms.

On the card (``cuda``): the update kernel and the norm kernel in the
host-float update's test above (one launch each); 400 tensors of odd sizes,
half of them misaligned, over both state dtypes, eager and replayed from a
CUDA graph, bit-equal to the host-float passes, also with a strided
gradient and a parameter sliced along its second axis, which the kernel
takes by runs (the share 100); a capture whose list was not built raises;
the kernels' dropout read through a seed pointer
against ``hash_dropout``'s masks; 8 steps over two batch shapes, eager and
graph-replayed, bit-equal; the ``train_step`` ranges marked 2 captured, then
6 replayed, whose inner ranges carry device intervals and no host interval;
no sync and no host launch in a replay; the returned loss kept; the memory
flat over 50 replays; a second shape's graph sharing the first's gradient
buffers; a cache with room for one graph running the second shape eagerly,
bit-equal to eager steps.

Imports neither JAX nor the JAX package, so the card runs the ``cuda`` tests:
``python -m pytest --noconftest -m cuda tests/test_torch_graphs.py``.
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, make_batch, train_entry
from vibertgrid_tpu_torch.ops import fused_update, kernels, losses
from vibertgrid_tpu_torch.ops.dropout import hash_dropout, keep_mask
from vibertgrid_tpu_torch.ops.flash_attention import attention_dropout_mask
from vibertgrid_tpu_torch.ops.fused_ffn import ffn_down_ln_reference
from vibertgrid_tpu_torch.parallel import collectives
from vibertgrid_tpu_torch.train.optim import DualOptimizer
from vibertgrid_tpu_torch.train.schedules import (
    cosine_scheduler,
    schedule_value,
    step_scheduler,
)
from vibertgrid_tpu_torch.train.seeds import (
    DeviceSeeds,
    ReplaySeeds,
    SeedStream,
    step_seeds,
    upload,
)
from vibertgrid_tpu_torch.train import state as train_state
from vibertgrid_tpu_torch.train.state import make_train_step
from vibertgrid_tpu_torch.utils import profiling

TINY = dataclasses.replace(
    FLAGSHIP_TRAIN, bert_version="tiny-bert-test", backbone="resnet_18_fpn",
    compute_dtype=torch.float32, num_hard_positive_main_1=2, num_hard_negative_main_1=2,
    num_hard_positive_main_2=2, num_hard_negative_main_2=2, loss_aux_sample_list=[16, 32, 16],
    num_hard_positive_aux=16, num_hard_negative_aux=16)
TINY_SHAPE = dict(b=2, h=64, w=64, t=510, s=8, vocab=512)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of a float tensor (so -0 and +0 differ)."""
    t = t.detach().contiguous()
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def _slot(seed: int, device="cpu") -> torch.Tensor:
    return DeviceSeeds(upload(ReplaySeeds([seed]), 1, device)).next()


# ---- seeds ----


def test_step_seed_tensor_slots_are_the_streams_draws():
    want = SeedStream(5)
    slots = upload(SeedStream(5), 7, "cpu")
    assert slots.dtype == torch.int32 and slots.tolist() == [want.next() for _ in range(7)]
    seeds = DeviceSeeds(slots)
    assert [int(seeds.next()) for _ in range(7)] == slots.tolist() and seeds.drawn == 7
    with pytest.raises(IndexError):
        seeds.next()


def test_upload_wraps_seeds_to_int32_and_fills_a_given_tensor():
    out = torch.full((3,), 5, dtype=torch.int32)
    got = upload(ReplaySeeds([2**32 - 1, 2**31, 7]), 3, "cpu", out=out)
    assert got is out and out.tolist() == [-1, -(2**31), 7]


# ---- dropout and the random sites ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_slot_seed_matches_int_seed(dtype, rate):
    x = torch.randn(6, 37, generator=torch.Generator().manual_seed(0)).to(dtype)
    x[0, :5] = torch.tensor([-0.0, 0.0, float("inf"), -3.0, 2.0]).to(dtype)
    seed = 2**31 + 12345  # wraps to a negative int32
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y_int, y_slot = hash_dropout(a, seed, rate), hash_dropout(b, _slot(seed), rate)
    assert torch.equal(_bits(y_int), _bits(y_slot))
    g = torch.randn(y_int.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    y_int.backward(g)
    y_slot.backward(g)
    assert torch.equal(_bits(a.grad), _bits(b.grad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hash_dropout_keeps_the_values_of_the_mask_and_factor_it_replaced(dtype):
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(2)).to(dtype)
    x[1, :3] = torch.tensor([-0.0, -1.5, float("inf")]).to(dtype)
    rate, seed = 0.1, 99
    keep = keep_mask(x.shape, seed, rate, x.device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=dtype)
    before = x * torch.where(keep, scale, torch.zeros((), dtype=dtype))
    assert torch.equal(_bits(hash_dropout(x, _slot(seed), rate)), _bits(before))


def test_attention_mask_takes_a_slot_seed():
    for seed in (0, 77, 2**31 - 1, -5):
        want = attention_dropout_mask(2, 3, 20, seed, 0.1, "cpu")
        assert torch.equal(attention_dropout_mask(2, 3, 20, _slot(seed), 0.1, "cpu"), want)


def test_ffn_twin_dropout_takes_a_slot_seed():
    g = torch.Generator().manual_seed(3)
    h, x = torch.randn(9, 32, generator=g), torch.randn(9, 16, generator=g)
    w2, b2 = torch.randn(16, 32, generator=g), torch.randn(16, generator=g)
    gamma, beta = torch.ones(16), torch.zeros(16)
    want = ffn_down_ln_reference(h, x, w2, b2, gamma, beta, 1e-12, seed=4321, rate=0.2)
    got = ffn_down_ln_reference(h, x, w2, b2, gamma, beta, 1e-12, seed=_slot(4321), rate=0.2)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def test_sampled_losses_keys_take_a_slot_seed():
    n = 300
    assert torch.equal(losses._hash_bits(n, _slot(2024), "cpu"),
                       losses._hash_bits(n, 2024, "cpu"))
    logits = torch.randn(2, 6, 6, 4, generator=torch.Generator().manual_seed(4))
    targets = torch.randint(0, 4, (2, 24, 24), generator=torch.Generator().manual_seed(5))
    kw = dict(block=4, sample_list=[5, 9, 7, 3])
    want = losses.cross_entropy_random_sample_pooled(logits, targets, seed=31, **kw)
    got = losses.cross_entropy_random_sample_pooled(logits, targets, seed=_slot(31), **kw)
    assert torch.equal(_bits(got), _bits(want))


def test_fold_seed_folds_a_slot_seed_as_an_int():
    token = collectives._ACTIVE.set(types.SimpleNamespace(rank=3))
    try:
        for seed in (0, 2**31 - 70000, -12):
            assert int(collectives.fold_seed(_slot(seed))) == collectives.fold_seed(seed)
    finally:
        collectives._ACTIVE.reset(token)


# ---- the OHEM threshold ----


def _threshold_by_indexing(keys, w, k):
    """The threshold as it was taken: indexing by the 0-d position."""
    order = torch.argsort(keys, descending=True)
    reached = torch.cumsum(w[order], 0) >= k
    first = torch.argmax(reached.to(torch.int8))
    return torch.where(reached.any(), keys[order][first], 0)


@pytest.mark.parametrize("case", ["ties", "not_reached", "exactly", "single", "zero_weights"])
def test_weighted_threshold_gather_matches_indexing(case):
    keys, w, k = {
        "ties": ([5, 9, 9, 9, 2, 7, 7], [1, 2, 1, 3, 1, 1, 2], 4),
        "not_reached": ([3, 8, 1, 6], [1, 1, 2, 1], 50),
        "exactly": ([4, 10, 6, 2], [2, 1, 1, 5], 4),
        "single": ([11], [3], 2),
        "zero_weights": ([0, 9, 0, 4], [0, 2, 0, 1], 3),
    }[case]
    keys, w = torch.tensor(keys, dtype=torch.int64), torch.tensor(w, dtype=torch.int64)
    got = losses._weighted_threshold(keys, w, k)
    want = _threshold_by_indexing(keys, w, k)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


# ---- the optimizer's table ----


def _schedules():
    return {"lr_cnn": step_scheduler(0.01, [1], 0.1, 3, 2),
            "wd_cnn": cosine_scheduler(1e-4, 1e-5, 3, 2),
            "lr_bert": step_scheduler(5e-5, [1], 0.1, 3, 2),
            "wd_bert": cosine_scheduler(1e-2, 1e-3, 3, 2)}


def _host_float_update(opt, count, grads):
    """The update as it took its scalars as host floats (``alpha=``), for
    update ``count`` from the (already clip-scaled) fp32 ``grads``."""
    for group in opt.param_groups:
        kind, params = group["kind"], group["params"]
        g = [grads[p] for p in params]
        lr = schedule_value(opt.schedules[f"lr_{kind}"], count)
        wd = schedule_value(opt.schedules[f"wd_{kind}"], count)
        if kind == "cnn":
            bufs = [opt.state[p]["momentum"] for p in params]
            gd = torch._foreach_add(g, params, alpha=wd)
            buf = torch._foreach_mul([b.float() for b in bufs], opt.momentum)
            torch._foreach_add_(buf, gd)
            torch._foreach_add_(params, buf, alpha=-lr)
            torch._foreach_copy_(bufs, buf)
            continue
        b1, b2 = opt.beta1, opt.beta2
        mus = [opt.state[p]["mu"] for p in params]
        nus = [opt.state[p]["nu"] for p in params]
        mu = torch._foreach_mul([m.float() for m in mus], b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        nu = torch._foreach_mul([v.float() for v in nus], b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        c = np.float32(count + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** c)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, opt.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=wd)
        torch._foreach_add_(params, upd, alpha=-lr)
        torch._foreach_copy_(mus, mu)
        torch._foreach_copy_(nus, nu)


def _named(seed):
    g = torch.Generator().manual_seed(seed)
    shapes = [(37, 5), (128,), (3, 3, 8, 16), (1001,)]
    return ([(f"backbone.w{i}", torch.randn(s, generator=g)) for i, s in enumerate(shapes)]
            + [(f"bert_model.w{i}", torch.randn(s, generator=g)) for i, s in enumerate(shapes)])


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("state_dtype", [torch.bfloat16, None])
def test_optimizer_device_table_update_matches_host_floats(state_dtype, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: python -m pytest --noconftest -m cuda)")
    named = [(n, p.to(device).requires_grad_(True)) for n, p in _named(0)]
    twin = [(n, p.detach().clone()) for n, p in named]
    opt = DualOptimizer(named, _schedules(), state_dtype=state_dtype)
    host = DualOptimizer([(n, p.clone().requires_grad_(True)) for n, p in twin], _schedules(),
                         state_dtype=state_dtype)
    host_params = [p for g in host.param_groups for p in g["params"]]
    g = torch.Generator().manual_seed(1)
    for count in range(12):  # the schedules end after 9
        scale = torch.tensor(0.7 if count % 3 else 1.0, device=device)
        grads = [(torch.randn(p.shape, generator=g) * 3).to(device) for _, p in named]
        for (_, p), gr in zip(named, grads):
            p.grad = gr.clone()
        launched = dict(kernels.LAUNCHES)
        opt.step(grad_scale=scale)
        if device == "cuda":  # the hand kernel updated every tensor, in one launch
            assert kernels.LAUNCHES["dual_update"] == launched["dual_update"] + 1
            assert opt.fused_share == 100.0
            _assert_norm_matches_the_library(grads)
        with torch.no_grad():
            _host_float_update(host, count, {q: gr * scale for q, gr in zip(host_params, grads)})
        for (name, p), q in zip(named, host_params):
            assert torch.equal(_bits(p), _bits(q)), (count, name)
            for slot, v in opt.state[p].items():
                assert torch.equal(v, host.state[q][slot]), (count, name, slot)
    assert opt.count == 12 and int(opt._count_t) == 12


def _assert_norm_matches_the_library(grads):
    """The clip's sum of squares, one launch on the card, against the
    library's fp64 norms squared and summed, within 1e-12 of it."""
    launched = kernels.LAUNCHES["grad_sq_norm"]
    got = train_state._squares(grads)
    if grads[0].is_cuda:
        assert kernels.LAUNCHES["grad_sq_norm"] == launched + 1
    want = torch.stack(torch._foreach_norm(grads, dtype=torch.float64)).square().sum()
    assert got.dtype == torch.float64 and got.dim() == 0
    assert abs(got.item() - want.item()) <= 1e-12 * want.item(), (got.item(), want.item())


# ---- what the update kernel takes, and its descriptor lists (ops/fused_update.py) ----


def test_update_routing_takes_contiguous_fp32_tensors_with_bf16_or_fp32_state():
    """The kernel's entries: fp32 parameter and gradient with bf16 or fp32
    state, contiguous or not; anything else raises rather than run apart."""
    p, g = torch.randn(6, 4), torch.randn(6, 4)
    bf16, fp32 = torch.zeros(6, 4, dtype=torch.bfloat16), torch.zeros(6, 4)
    one = fused_update.update_entry(p, g, [bf16], False)
    assert one[:2] == (fused_update.STATE_BF16, (6, 4))
    assert one[2:] == ((p.data_ptr(), (4, 1)), (g.data_ptr(), (4, 1)), (bf16.data_ptr(), (4, 1)))
    assert fused_update.update_entry(p, g, [fp32, fp32], True)[0] == fused_update.ADAMW
    # slices that are not contiguous (ZeRO-1's narrow along a later axis)
    cut = fused_update.update_entry(p[:, 1:3], g[:, 1:3], [bf16[:, 1:3]], False)
    assert cut[1] == (6, 2) and cut[2] == (p.data_ptr() + 4, (4, 1))
    fused_update.update_entry(p, g.t().contiguous().t(), [bf16], False)
    # an fp16 state, a mixed state, an fp16 parameter or gradient, another shape
    for args in ((p, g, [bf16.half()]), (p, g, [bf16, fp32]), (p.half(), g, [bf16]),
                 (p, g.half(), [bf16])):
        with pytest.raises(TypeError):
            fused_update.update_entry(*args, True)
    with pytest.raises(ValueError):
        fused_update.update_entry(p, g[:5], [bf16], False)
    with pytest.raises(TypeError):
        fused_update.norm_entry(g.double())


def test_cpu_updates_take_the_passes_and_read_a_fused_share_of_0():
    named = [(n, p.requires_grad_(True)) for n, p in _named(3)]
    opt = DualOptimizer(named, _schedules())
    assert opt.fused_share is None
    for _, p in named:
        p.grad = torch.ones_like(p)
    launched = dict(kernels.LAUNCHES)
    opt.step(grad_scale=torch.tensor(0.5))
    assert opt.fused_share == 0.0 and kernels.LAUNCHES == launched
    assert opt.prepare() is None  # nothing on the card
    _assert_norm_matches_the_library([p.grad for _, p in named])


def test_cpu_train_steps_mark_their_optimizer_range_with_the_fused_share():
    state, step, batch = train_entry("cpu", config=TINY, shape=TINY_SHAPE)
    _, recorded = _traced(lambda: step(state, batch, step_seeds(7, 0)))
    assert [s.fused_share for s in recorded if s.name == "optimizer"] == [0.0]


def _entries(named, grads, states):
    return tuple(fused_update.update_entry(p, g, st, name.startswith("bert_model."))
                 for (name, p), g, st in zip(named, grads, states))


def _norm_entries(*grads):
    return [fused_update.norm_entry(g) for g in grads]


def test_descriptor_list_layout(monkeypatch):
    monkeypatch.setattr(fused_update, "CHUNK", 8)
    flat = torch.zeros(64)
    p, q = flat[0:20], flat[21:24]  # 3 chunks, aligned; 1 chunk, misaligned
    bf16, s0, s1 = torch.zeros(20, dtype=torch.bfloat16), torch.zeros(3), torch.zeros(3)
    entries = (fused_update.update_entry(p, p.clone(), [bf16], False),
               fused_update.update_entry(q, q.clone(), [s0, s1], True))
    got = fused_update.build(entries, "cpu")
    assert (got.n_rows, got.n_chunks) == (2, 4)
    table = got.table.tolist()
    assert table[0] == p.data_ptr() and table[2:4] == [bf16.data_ptr(), 0]
    assert table[4:8] == [20, fused_update.STATE_BF16 | fused_update.ALIGNED, 0, 0]  # chunk 0
    assert table[8] == q.data_ptr() and table[10:12] == [s0.data_ptr(), s1.data_ptr()]
    assert table[12:16] == [3, fused_update.ADAMW, 3, 0]  # misaligned, first chunk 3
    assert table[16:] == [0, 0, 0, 1]
    norm = fused_update.rows_of(_norm_entries(q))
    assert norm.tolist() == [[0, q.data_ptr(), 0, 0, 3, 0]]


def test_descriptor_rows_are_the_contiguous_runs_of_strided_operands():
    """A slice along a later axis is one row a run of its leading axes; a
    contiguous state beside it takes the same runs; a view with a stride
    in its last axis one row an element; a contiguous tensor one row."""
    base, grads = torch.zeros(5, 8), torch.zeros(5, 8)
    p, g = base.narrow(1, 4, 4), grads.narrow(1, 4, 4)
    state = torch.zeros(5, 4, dtype=torch.bfloat16)
    rows = fused_update.rows_of([fused_update.update_entry(p, g, [state], False)])
    assert rows[:, 0].tolist() == [base.data_ptr() + 4 * (8 * r + 4) for r in range(5)]
    assert rows[:, 1].tolist() == [grads.data_ptr() + 4 * (8 * r + 4) for r in range(5)]
    assert rows[:, 2].tolist() == [state.data_ptr() + 2 * 4 * r for r in range(5)]
    assert rows[:, 4].tolist() == [4] * 5
    assert (rows[:, 5] & fused_update.ALIGNED).all()
    # three axes, sliced along the second: runs of the last two axes' slice
    cube = torch.zeros(3, 4, 6)
    cut = cube.narrow(1, 2, 2)
    rows = fused_update.rows_of(_norm_entries(cut))
    assert rows[:, 1].tolist() == [cube.data_ptr() + 4 * (24 * r + 12) for r in range(3)]
    assert rows[:, 4].tolist() == [12] * 3
    # every other element: runs of one, each flagged by its own address
    flat = torch.zeros(14)
    rows = fused_update.rows_of(_norm_entries(flat[::2]))
    assert rows[:, 1].tolist() == [flat.data_ptr() + 8 * k for k in range(7)]
    assert rows[:, 4].tolist() == [1] * 7
    assert rows[:, 5].tolist() == [fused_update.ALIGNED * (a % 16 == 0) for a in rows[:, 1]]
    # contiguous, with axes of size one, and empty
    one = torch.zeros(1, 5, 1, 3)
    assert fused_update.rows_of(_norm_entries(one))[:, 4].tolist() == [15]
    assert fused_update.rows_of(_norm_entries(torch.zeros(0, 3))).shape == (0, 6)


def test_descriptor_rows_put_each_contiguous_tensor_first_then_the_runs():
    """A list's rows: one for each contiguous tensor, in order, then the
    runs of the others; each flagged by the alignment of all its addresses
    (a state of bf16 needs 8 bytes, of fp32 16)."""
    base = torch.zeros(4, 8)
    p, g = torch.zeros(12), torch.zeros(12)
    bf16, fp32 = torch.zeros(16, dtype=torch.bfloat16), torch.zeros(16)
    entries = [fused_update.update_entry(base[:, :4], base[:, 4:], [fp32[:16].view(4, 4)], False),
               fused_update.update_entry(p, g, [bf16[2:14]], False),
               fused_update.update_entry(p, g, [fp32[2:14]], True)]
    rows = fused_update.rows_of(entries)
    assert rows[:, 4].tolist() == [12, 12, 4, 4, 4, 4]
    assert rows[:2, 2].tolist() == [bf16.data_ptr() + 4, fp32.data_ptr() + 8]
    assert all(t.data_ptr() % 16 == 0 for t in (base, p, g, bf16, fp32))  # the allocator's
    aligned = (rows[:, 5] & fused_update.ALIGNED) > 0
    assert aligned.tolist() == [False, False, True, True, True, True]  # states 4 and 8 bytes in
    assert rows[2:, 0].tolist() == [base.data_ptr() + 32 * r for r in range(4)]
    assert rows[2:, 2].tolist() == [fp32.data_ptr() + 16 * r for r in range(4)]


def test_run_offsets_are_kept_by_layout():
    """A strided layout's run offsets are computed once and shared, read-only."""
    first = fused_update._offsets((6, 10), (20, 1), 10)
    assert first.tolist() == [20 * r for r in range(6)] and not first.flags.writeable
    assert fused_update._offsets((6, 10), (20, 1), 10) is first


def test_prepare_update_builds_no_list_on_the_cpu():
    state, _, _ = train_entry("cpu", config=TINY, shape=TINY_SHAPE)
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    assert train_state.prepare_update(state.optimizer) == [None]


def test_descriptor_lists_are_cached_by_their_rows(monkeypatch):
    monkeypatch.setattr(fused_update, "_lists", type(fused_update._lists)())
    named = _named(4)
    grads = [torch.randn(p.shape) for _, p in named]
    states = [[torch.zeros_like(p, dtype=torch.bfloat16)
               for _ in range(2 if n.startswith("bert_model.") else 1)] for n, p in named]
    entries = _entries(named, grads, states)
    first = fused_update.descriptors(entries, "cpu")
    assert fused_update.descriptors(_entries(named, grads, states), "cpu") is first  # same storage
    grads[3] = grads[3].clone()  # a new .grad: a new list
    other = fused_update.descriptors(_entries(named, grads, states), "cpu")
    assert other is not first and other.table[3 * fused_update.ROW + 1] == grads[3].data_ptr()
    for k in range(fused_update._KEEP):  # the least recently used go
        fused_update.descriptors([fused_update.norm_entry(torch.zeros(k + 1))], "cpu")
    assert entries not in fused_update._lists
    # under capture a list is only taken from the cache: a list not built raises
    kept = [fused_update.norm_entry(torch.zeros(1))]
    built = fused_update.descriptors(kept, "cpu")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="no descriptor list"):
        fused_update.descriptors(entries, "cpu")
    assert fused_update.descriptors(kept, "cpu") is built


def test_optimizer_table_rows_and_counter():
    opt = DualOptimizer(_named(2), _schedules())
    sch = _schedules()
    for n in (0, 4, 8, 9, 30, 17320, 10**6):
        opt.count = n
        row = opt._row()
        assert all(isinstance(v, float) for v in row)
        assert row == opt.table[min(n, len(opt.table) - 1)].tolist()
        c = np.float32(n + 1)
        assert row[:4] == [-schedule_value(sch["lr_cnn"], n), schedule_value(sch["wd_cnn"], n),
                           -schedule_value(sch["lr_bert"], n), schedule_value(sch["wd_bert"], n)]
        bc = [np.float32(1) - np.float32(0.9) ** c, np.float32(1) - np.float32(0.999) ** c]
        assert row[4:6] == [float(v) for v in bc], n
        assert row[6:] == [float(np.float32(1 / np.float64(v))) for v in bc], n
    table = opt.table
    opt.schedules = {k: v * 2 for k, v in sch.items()}
    assert opt.table is not table and opt.count == 10**6
    twin = copy.deepcopy(opt)
    assert twin.count == opt.count and torch.equal(twin.table, opt.table)
    assert twin._count_t is not opt._count_t


# ---- the step on the CPU ----


def test_cpu_steps_stay_eager_and_take_the_first_steps_values():
    """Two steps of one closure (the second reads its seeds from a slot
    tensor) against two fresh closures, whose one step each takes the
    stream's ints: the same bits; every step eager, and marked so."""
    graph_state, step, batch = train_entry("cpu", config=TINY, shape=TINY_SHAPE)
    ref_state, _, _ = train_entry("cpu", config=TINY, shape=TINY_SHAPE)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [step(graph_state, batch, step_seeds(7, k))[1] for k in range(2)]
    marks = [s.mode for s in profiling.spans() if s.name == "train_step"]
    want = [make_train_step()(ref_state, batch, step_seeds(7, k))[1] for k in range(2)]
    assert marks == ["eager", "eager"]
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    for (name, p), q in zip(graph_state.model.state_dict().items(),
                            ref_state.model.state_dict().values()):
        assert torch.equal(p, q), name


# ---- on the card ----


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: python -m pytest --noconftest -m cuda)")
    return torch.device("cuda")


def _mask_from(out: torch.Tensor) -> torch.Tensor:
    """Where a kernel kept an element of a constant: with a zero residual
    the LayerNorm puts the kept ones above the row's mean and the dropped
    ones below it."""
    return out.float() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["attention", "ffn", "ffn_saved", "proj_ln"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_dropout_through_the_seed_pointer_is_hash_dropouts(cuda_device, kernel, dtype):
    from vibertgrid_tpu_torch.ops.flash_attention import flash_attention
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_saved, fused_proj_ln

    dev, rate, seed = cuda_device, 0.3, 2**31 + 977
    slot = _slot(seed, dev)
    if kernel == "attention":
        # q = k = 0: every probability is 1/T; v is the identity, so
        # out[b, i, j] = keep[b, i, j] / (T (1 - rate))
        b, t = 2, 64
        q = torch.zeros(b, t, t, dtype=dtype, device=dev)
        v = torch.eye(t, dtype=dtype, device=dev).expand(b, t, t).contiguous()
        bias = torch.zeros(b, t, device=dev)
        run = lambda s: flash_attention(q, q, v, bias, 1.0, 1, rate=rate, seed=s)
        want = attention_dropout_mask(b, 1, t, seed, rate, dev)[:, 0] > 0
        mask = lambda out: out.float() > 0
    else:
        n, d, f = 40, (768 if dtype == torch.bfloat16 else 64), 256
        x = torch.zeros(n, d, dtype=dtype, device=dev)
        ones, zeros = torch.ones(d, device=dev), torch.zeros(d, device=dev)
        if kernel == "proj_ln":
            w = torch.zeros(d, d, dtype=dtype, device=dev)
            run = lambda s: fused_proj_ln(x, x, w, ones, ones, zeros, 1e-12, rate=rate, seed=s)
        else:
            fn = fused_ffn if kernel == "ffn" else fused_ffn_saved
            w1 = torch.randn(f, d, device=dev).to(dtype)
            w2 = torch.zeros(d, f, dtype=dtype, device=dev)
            b1 = torch.zeros(f, device=dev)
            run = lambda s: fn(x, w1, b1, w2, ones, ones, zeros, 1e-12, rate=rate, seed=s)
        want = hash_dropout(torch.ones(n, d, device=dev), slot, rate) > 0
        mask = _mask_from
    with torch.no_grad():
        got_slot, got_int = run(slot), run(seed)
    assert torch.equal(_bits(got_slot), _bits(got_int))
    assert torch.equal(mask(got_slot), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_reads_the_seed_pointer(cuda_device, dtype):
    from vibertgrid_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=cuda_device).manual_seed(0)
    b, t, h, d = 2, 100, 2, 64
    qkv = [torch.randn(b, t, h * d, generator=g, device=cuda_device).to(dtype) for _ in range(3)]
    bias = torch.zeros(b, t, device=cuda_device)
    d_out = torch.randn(b, t, h * d, generator=g, device=cuda_device).to(dtype)

    def grads(seed):
        leaves = [x.clone().requires_grad_(True) for x in qkv]
        flash_attention(*leaves, bias, d ** -0.5, h, rate=0.1, seed=seed).backward(d_out)
        return [x.grad for x in leaves]

    for a, b_ in zip(grads(_slot(4242, cuda_device)), grads(4242)):
        assert torch.equal(_bits(a), _bits(b_))


def _many_tensors(dev, seed: int, count: int = 400):
    """``count`` parameters of odd sizes, from 1 element to several of the
    kernel's chunks, every other one at an odd offset in a shared buffer
    (so that the kernel takes it element by element), half of each group;
    and a gradient for each at the same offsets in a buffer of their own."""
    g = torch.Generator().manual_seed(seed)
    sizes = torch.randint(1, 3000, (count,), generator=g).tolist()
    sizes[5], sizes[206] = 2 * fused_update.CHUNK + 3, fused_update.CHUNK + 1
    offsets, at = [], 0
    for k, n in enumerate(sizes):
        at += 1 if k % 2 else (-at) % 4
        offsets.append(at)
        at += n
    flat = torch.randn(at, generator=g).to(dev)
    named = [(f"{'bert_model' if k % 4 < 2 else 'backbone'}.w{k}",
              torch.nn.Parameter(flat[o:o + n])) for k, (o, n) in enumerate(zip(offsets, sizes))]

    def grads(step_seed):
        buf = (torch.randn(at, generator=torch.Generator().manual_seed(step_seed)) * 3).to(dev)
        return [buf[o:o + n] for o, n in zip(offsets, sizes)]

    return named, grads


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view that is not contiguous (every other element
    of a buffer twice its size)."""
    out = t.new_zeros(2 * t.numel())[::2]
    out.copy_(t)
    return out


def _captured_update(opt, named, static):
    """``update(grads, scale)``: ``opt``'s step captured in a CUDA graph on
    the gradient buffers ``static`` and replayed."""
    for (_, p), gr in zip(named, static):
        p.grad = gr
    scale = torch.ones((), device=static[0].device)
    kernels.library()
    kept = opt.prepare()  # the graph reads it at every replay
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.step(grad_scale=scale)
    opt.advance_host_count(-1)  # the capture ran no update

    def update(grads, value):
        assert kept is not None
        torch._foreach_copy_(static, grads)
        scale.fill_(value)
        graph.replay()
        opt.advance_host_count(1)

    return update


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["eager", "captured"])
@pytest.mark.parametrize("state_dtype", [torch.bfloat16, None])
@pytest.mark.parametrize("strided", [False, True])
def test_update_kernel_over_many_odd_tensors_is_the_passes_bit_for_bit(cuda_device, path,
                                                                       state_dtype, strided):
    """400 tensors of odd sizes, half of them misaligned (several chunks, the
    element-by-element tails), updated by the kernel, eager and in a
    replayed CUDA graph, against the library's host-float passes; with
    ``strided`` one gradient is every other element of a buffer, and one
    parameter and its gradient are slices along the second axis (as ZeRO-1
    cuts a parameter whose first axis does not split), which the kernel
    takes by runs, beside a contiguous state."""
    named, make_grads = _many_tensors(cuda_device, 5)
    odd, cut = 1, 2  # misaligned in the encoder's group; in the CNN's group
    wide = (37, 24)
    if strided:
        base = torch.randn(wide, generator=torch.Generator().manual_seed(9)).to(cuda_device)
        named[cut] = (named[cut][0], torch.nn.Parameter(base.narrow(1, 8, 12)))
    host = DualOptimizer([(n, p.detach().clone().requires_grad_(True)) for n, p in named],
                         _schedules(), state_dtype=state_dtype)
    opt = DualOptimizer(named, _schedules(), state_dtype=state_dtype)
    host_params = [p for g in host.param_groups for p in g["params"]]
    params = [p for g in opt.param_groups for p in g["params"]]
    order = {id(p): k for k, (_, p) in enumerate(named)}

    def laid_out(seed):
        grads = make_grads(seed)
        if strided:
            grads[odd] = _strided(grads[odd])
            buf = torch.randn(wide, generator=torch.Generator().manual_seed(seed + 1)) * 3
            grads[cut] = buf.to(cuda_device).narrow(1, 8, 12)
        return grads

    update = None
    if path == "captured":
        update = _captured_update(opt, named, laid_out(0))
    for count in range(4):
        grads = laid_out(100 + count)
        scale = torch.tensor(0.7 if count % 2 else 1.0, device=cuda_device)
        launched = dict(kernels.LAUNCHES)
        if update is None:
            for (_, p), gr in zip(named, grads):
                p.grad = gr
            opt.step(grad_scale=scale)
            assert kernels.LAUNCHES["dual_update"] == launched["dual_update"] + 1
        else:
            update(grads, scale.item())
        with torch.no_grad():
            _host_float_update(host, count, {q: grads[order[id(p)]].contiguous() * scale
                                             for p, q in zip(params, host_params)})
        for p, q in zip(params, host_params):
            assert torch.equal(_bits(p), _bits(q)), (count, order[id(p)])
            for slot, v in opt.state[p].items():
                assert torch.equal(_bits(v), _bits(host.state[q][slot])), (count, slot)
    assert opt.fused_share == 100.0
    _assert_norm_matches_the_library(laid_out(7))


@pytest.mark.cuda
def test_a_capture_whose_list_was_not_built_raises(cuda_device):
    """A capture copies nothing from the host, so the update and the norm
    raise where their descriptor list was not built before it, rather than
    run apart from the kernels."""
    named = [(n, torch.nn.Parameter(p.to(cuda_device))) for n, p in _named(6)]
    opt = DualOptimizer(named, _schedules())
    for _, p in named:
        p.grad = torch.randn_like(p)
    kernels.library()
    opt.step()  # eager: the table on the card, the list of these gradients built
    for _, p in named:
        p.grad = torch.randn_like(p)  # new storage
    launched = dict(kernels.LAUNCHES)
    for run in (opt.step, lambda: train_state._squares([p.grad for _, p in named])):
        with pytest.raises(RuntimeError, match="no descriptor list"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                run()
    assert kernels.LAUNCHES == launched and opt.count == 1


GRAPH_SHAPES = (dict(b=2, h=256, w=256, t=510, s=32, vocab=30522),
                dict(b=2, h=320, w=192, t=510, s=32, vocab=30522))
STEP_RANGES = ["forward", "encoder", "backbone", "heads", "roi_align", "heads", "backward",
               "optimizer"]
RANGE_PARENT = {"forward": "train_step", "backward": "train_step", "optimizer": "train_step"}


def _trajectory(dev, order, fresh: bool):
    """Steps of the flagship (bf16) from seed 0's weights over the batches
    of ``GRAPH_SHAPES`` in ``order``; ``fresh``: each step by a new closure
    (its first sight, so every step runs eagerly), else one closure.
    ``(state, losses, (loss, value) at step 4, (step, batches), the last
    step's gradients)``."""
    state, step, _ = train_entry(dev, seed=0, shape=GRAPH_SHAPES[0])
    batches = [make_batch(**shape, seed=i, device=dev) for i, shape in enumerate(GRAPH_SHAPES)]
    losses, kept = [], None
    for k, b in enumerate(order):
        run = make_train_step() if fresh else step
        _, loss = run(state, batches[b], step_seeds(11, state.step))
        losses.append(loss)
        if k == 3:
            kept = (loss, loss.item())
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}
    return state, losses, kept, (step, batches), grads


def _traced(run):
    """``run()`` under a CPU profiler: its result and the spans recorded."""
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = run()
    return out, profiling.spans()


def _modes(recorded):
    return [s.mode for s in recorded if s.name == "train_step"]


def _equal_states(a, b):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    pa = [p for g in a.optimizer.param_groups for p in g["params"]]
    pb = [p for g in b.optimizer.param_groups for p in g["params"]]
    for p, q in zip(pa, pb):
        for slot, v in a.optimizer.state[p].items():
            assert torch.equal(v, b.optimizer.state[q][slot]), slot
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    assert int(a.optimizer._count_t) == int(b.optimizer._count_t) == a.optimizer.count


@pytest.fixture(scope="module")
def graph_runs(cuda_device):
    order = [k % 2 for k in range(8)]
    eager_state, eager_losses, _, _, eager_grads = _trajectory(cuda_device, order, fresh=True)
    (state, losses, kept, rest, grads), recorded = _traced(
        lambda: _trajectory(cuda_device, order, fresh=False))
    return dict(eager=(eager_state, eager_losses, eager_grads), graph=(state, losses, grads),
                spans=recorded, kept=kept, rest=rest)


@pytest.mark.cuda
def test_graph_replays_are_bit_equal_to_eager_steps(graph_runs):
    eager_state, eager_losses, eager_grads = graph_runs["eager"]
    state, losses, grads = graph_runs["graph"]
    assert [_bits(x).item() for x in losses] == [_bits(x).item() for x in eager_losses]
    _equal_states(state, eager_state)
    # a replay hands its gradients to .grad, as an eager step leaves them
    assert grads.keys() == eager_grads.keys() and len(grads) > 100
    for name, g in grads.items():
        assert torch.equal(_bits(g), _bits(eager_grads[name])), name


@pytest.mark.cuda
def test_two_captures_then_six_replays(graph_runs):
    assert _modes(graph_runs["spans"]) == ["captured"] * 2 + ["replayed"] * 6


@pytest.mark.cuda
def test_a_replayed_step_records_its_ranges_on_the_device_only(graph_runs):
    recorded = graph_runs["spans"]
    steps = [s for s in recorded if s.name == "train_step"]
    for top in steps:
        own = [s for s in recorded if s.step == top.step and s is not top]
        assert [s.name for s in own] == STEP_RANGES
        for s in own:
            parent = recorded[s.parent]
            assert parent.name == RANGE_PARENT.get(s.name, "forward") and parent.step == top.step
            assert top.device_start_ns <= s.device_start_ns <= s.device_end_ns
            assert s.device_end_ns <= top.device_end_ns
            assert parent.device_start_ns <= s.device_start_ns
            assert s.device_end_ns <= parent.device_end_ns
            # the host issues a replayed range nothing, and nothing else
            assert (s.host_start_ns is None) == (top.mode == "replayed"), (top.mode, s.name)
        assert own[6].device_end_ns - own[6].device_start_ns > 0  # the backward


@pytest.mark.cuda
def test_a_replayed_step_makes_no_sync_launches_nothing_and_keeps_the_returned_loss(graph_runs):
    state = graph_runs["graph"][0]
    (step, batches), (loss, value) = graph_runs["rest"], graph_runs["kept"]
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.reset_launch_counts()
        step(state, batches[0], step_seeds(11, state.step))
        # replayed: the host launched none of the hand-written kernels
        assert not any(kernels.LAUNCHES.values()), dict(kernels.LAUNCHES)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert loss.item() == value


@pytest.mark.cuda
def test_memory_is_flat_over_50_replays(graph_runs):
    state = graph_runs["graph"][0]
    step, batches = graph_runs["rest"]
    seen = []
    for k in range(60):
        step(state, batches[k % 2], step_seeds(11, state.step))
        if k in (9, 59):
            torch.cuda.synchronize()
            seen.append(torch.cuda.memory_allocated())
    assert seen[0] == seen[1]


@pytest.mark.cuda
def test_a_second_shapes_graph_shares_the_gradient_buffers(cuda_device):
    """A capture allocates no gradients of its own: the second shape's
    graph adds its inputs and its loss to what the first left, far under
    one set of gradients."""
    state, step, _ = train_entry(cuda_device, seed=0, shape=GRAPH_SHAPES[0])
    batches = [make_batch(**shape, seed=i, device=cuda_device)
               for i, shape in enumerate(GRAPH_SHAPES)]
    grad_bytes = sum(p.numel() * 4 for p in state.model.parameters() if p.requires_grad)
    held = []
    for b in batches:
        step(state, b, step_seeds(11, state.step))
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    inputs = sum(t.numel() * t.element_size() for t in (
        getattr(batches[1], f.name) for f in dataclasses.fields(batches[1]))
        if isinstance(t, torch.Tensor))
    assert held[1] - held[0] < inputs + grad_bytes // 10, (held, inputs, grad_bytes)


@pytest.mark.cuda
def test_a_full_cache_runs_new_shapes_eagerly(cuda_device, monkeypatch):
    """With room for one graph: the first shape is captured and replayed,
    the second runs eagerly at every sight; every step bit-equal to eager
    steps."""
    monkeypatch.setattr(train_state, "_GRAPHS", 1)
    order = [0, 1, 0, 1, 1, 0, 0]
    eager_state, eager_losses, *_ = _trajectory(cuda_device, order, fresh=True)
    (state, losses, *_), recorded = _traced(lambda: _trajectory(cuda_device, order, fresh=False))
    assert _modes(recorded) == ["captured", "eager", "replayed", "eager", "eager", "replayed",
                                "replayed"]
    assert [_bits(x).item() for x in losses] == [_bits(x).item() for x in eager_losses]
    _equal_states(state, eager_state)
