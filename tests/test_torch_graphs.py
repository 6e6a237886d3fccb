"""The train step's seeds, schedule scalars and syncs on the device, and its
CUDA graphs (``train/state.py``, ``train/seeds.py``, ``train/optim.py``).

On the CPU, each held to the values the step took before they moved there:

- hash dropout with a device-slot seed against the int seed, and against
  the mask-and-factor formulation it replaced, bit for bit;
- the twins' dropouts and the sampled losses' keys with slot seeds;
- ``_weighted_threshold``'s gather against indexing by the 0-d position,
  on ties and on a count that is not reached;
- the optimizer's update as a CUDA graph captures it (the device table at
  the device counter) against the host-float update, bit for bit, past the
  schedules' end, and the eager update (host floats from the table) too;
- the step's seed tensor: slot *i* is the stream's *i*-th draw;
- CPU steps stay eager, and their second step (seeds on the device) takes
  the first step's path's values.

On the card (``cuda``): the kernels' dropout read through a seed pointer
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
from vibertgrid_tpu_torch.ops import kernels, losses
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
from vibertgrid_tpu_torch.train import optim
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


@pytest.fixture(params=["eager", "captured"])
def update_path(request, monkeypatch):
    """The optimizer's two forms: host floats (an eager update), and the
    device table at the device counter (an update under CUDA graph capture,
    which this makes the optimizer take outside one)."""
    if request.param == "captured":
        monkeypatch.setattr(optim, "_capturing", lambda: True)
    return request.param


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("state_dtype", [torch.bfloat16, None])
def test_optimizer_device_table_update_matches_host_floats(state_dtype, device, update_path):
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
        opt.step(grad_scale=scale)
        with torch.no_grad():
            _host_float_update(host, count, {q: gr * scale for q, gr in zip(host_params, grads)})
        for (name, p), q in zip(named, host_params):
            assert torch.equal(_bits(p), _bits(q)), (count, name)
            for slot, v in opt.state[p].items():
                assert torch.equal(v, host.state[q][slot]), (count, name, slot)
    assert opt.count == 12 and int(opt._count_t) == 12


def test_optimizer_table_rows_and_counter(update_path):
    opt = DualOptimizer(_named(2), _schedules())
    sch = _schedules()
    for n in (0, 4, 8, 9, 30, 17320, 10**6):
        opt.count = n
        row = opt._row(torch.device("cpu"))
        assert all(isinstance(v, float) == (update_path == "eager") for v in row)
        row = [float(v) for v in row]
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
