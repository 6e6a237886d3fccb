"""The port's distributed layer on the CPU: two gloo ranks against one process
on the concatenated batch, and against the JAX package.

Each group of checks runs once in two processes of
``tests/torch_parallel_worker.py`` (torch and the port only, two threads
each, on a free port of localhost); the comparisons run here, where the JAX
package runs on the virtual CPU devices of ``tests/conftest.py``. No JAX
train step is compiled.

- bootstrap: the gathers are the identity in one process; a two-process
  bootstrap to a port nothing listens on raises within its timeout;
- norms: ``BatchNorm`` and ``MaskedBatchNorm`` (one rank all padding):
  outputs, input and weight gradients and running statistics;
- losses: every OHEM and sampled loss, with ties and with k above one
  rank's candidates: loss and input gradients against the one-process port
  on the concatenated arrays (``tests/test_torch_losses.py`` holds those to
  JAX), the deterministic OHEM losses also against JAX;
- dropout: rank r's elementwise mask is its rows of JAX ``hash_dropout`` on
  the concatenated array, its attention, FFN and epilogue twins shard r of
  the JAX package's sharded kernels (interpret mode, ``make_mesh(data=2)``);
- the train step (tiny config, dropout off, OHEM random off and on, a step
  where the clip fires; the full and CRF heads), ZeRO-1 (the update, the state each rank holds, a
  checkpoint resumed in one process), the eval gather and ``driver.main``.

**Gradient convention.** Every rank holds the global loss L; the backward
of a sum over ranks sums the ranks' gradients, so rank r's gradient with
respect to its own inputs is ``world · ∂L/∂x_r``, and the mean of the ranks'
parameter gradients is ``∂L/∂θ`` (``parallel/collectives.py``).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from tests.torch_checkpoints import checkpoints_dropped, drop_checkpoints  # noqa: F401

# each test's checkpoints go once it has read them back
pytestmark = pytest.mark.usefixtures("checkpoints_dropped")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(rank: int, port: int, world: int = WORLD) -> dict:
    return dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="2")


def _start(task: str, inputs: dict, tmp, world: int = WORLD) -> tuple:
    """Start ``task`` in ``world`` ranks; :func:`_wait` collects their results."""
    path = os.path.join(tmp, f"{task}_in.pt")
    torch.save(inputs, path)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, task, path, str(tmp)],
                              env=_env(r, port, world), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return task, tmp, procs


def _wait(run: tuple, timeout: float = 300) -> list:
    """The ranks' results in rank order. A rank that fails fails the run,
    with every rank's output."""
    task, tmp, procs = run
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs[len(outs):]:
            p.kill()
            outs.append(p.communicate()[0])
    if any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{o[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise AssertionError(f"{task}: a rank failed\n{tails}")
    return [torch.load(os.path.join(tmp, f"{task}_{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def _rows(x: torch.Tensor, rank: int) -> torch.Tensor:
    n = x.shape[0] // WORLD
    return x[rank * n:(rank + 1) * n]


def _cat(parts) -> np.ndarray:
    return torch.cat(list(parts)).numpy()


# ---------------------------------------------------------------- bootstrap


def test_gathers_are_the_identity_in_one_process():
    from vibertgrid_tpu_torch.parallel import collectives, mesh

    assert mesh.get_world_size() == 1 and mesh.get_rank() == 0 and mesh.is_main_process()
    assert mesh.process_allgather_objects({"a": [1, 2]}) == [{"a": [1, 2]}]
    assert mesh.process_allgather_bytes(b"xyz") == [b"xyz"]
    x = torch.arange(6.0)
    assert collectives.all_sum(x) is x and collectives.index_base(6, "cpu") == 0
    assert collectives.fold_seed(7) == 7
    assert mesh.make_mesh() == mesh.Layout() and mesh.make_mesh(1) == mesh.Layout()
    with pytest.raises(ValueError, match="mesh_data=2"):
        mesh.make_mesh(2)
    # a model axis of 2 needs two processes (tests/test_torch_tensor_parallel.py runs them)
    with pytest.raises(ValueError, match="mesh_model=2"):
        mesh.make_mesh(1, 2)
    from vibertgrid_tpu_torch.parallel.sharding import param_shardings

    layer = torch.nn.Linear(2, 2)
    assert param_shardings(layer, mesh.make_mesh()) == {layer.weight: None, layer.bias: None}


def test_a_bootstrap_that_fails_raises():
    """Rank 1 of two, at a port nothing listens on: the bootstrap raises
    within its timeout instead of training alone."""
    code = ("from vibertgrid_tpu_torch.parallel.mesh import init_distributed_mode\n"
            "init_distributed_mode(timeout=2, backend='gloo')\n"
            "print('JOINED')\n")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], env=_env(1, _free_port()), cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "JOINED" not in p.stdout, p.stdout + p.stderr
    assert time.perf_counter() - t0 < 90
    env = {k: v for k, v in _env(1, 0).items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "rendezvous" in p.stderr, p.stderr


def test_the_backend_follows_the_device():
    """``backend=None`` joins gloo for ranks on the CPU even where CUDA is
    available (a world of one, so the bootstrap completes alone)."""
    code = ("import torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "import torch.distributed as dist\n"
            "from vibertgrid_tpu_torch.parallel.mesh import init_distributed_mode\n"
            "init_distributed_mode(timeout=30, device='cpu')\n"
            "print('BACKEND', dist.get_backend())\n")
    p = subprocess.run([sys.executable, "-c", code], env=_env(0, _free_port(), world=1),
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and "BACKEND gloo" in p.stdout, p.stdout + p.stderr


# ---------------------------------------------------------------------- ops


def _quantised(rng, shape, step=0.5):
    """Normal values on a grid of ``step``: ties everywhere."""
    return torch.from_numpy(np.round(rng.standard_normal(shape) / step) * step).float()


def _loss_cases(rng):
    n, c = 24, 4
    logits = _quantised(rng, (n, c))
    # 3 positives in rank 0's rows and 6 in rank 1's: k = 5 is above rank 0's
    targets = torch.tensor([0, 2, 0, 0, 1, 0, 0, 0, 0, 3, 0, 0,
                            1, 2, 0, 3, 0, 1, 2, 0, 0, 1, 0, 0])
    valid = torch.ones(n, dtype=torch.bool)
    valid[[5, 17]] = False
    bin_logits = _quantised(rng, (n,))
    bin_targets = (targets > 0).float()
    b, h, w = 4, 3, 4
    logits4 = _quantised(rng, (b, h, w, c))
    pix = torch.from_numpy(rng.integers(0, c, (b, 4 * h, 4 * w)))
    pix[0, :6] = 0  # more negatives in rank 0's rows
    pix[3, 0, :3] = c  # the overflow bucket
    bin4 = _quantised(rng, (b, h, w))
    bin_pix = torch.from_numpy(rng.integers(0, 2, (b, 4 * h, 4 * w)))
    gate = torch.from_numpy(rng.random((b, 4 * h, 4 * w)) < 0.8)
    ce, bce = (logits, targets, valid), (bin_logits, bin_targets, valid)
    pooled, bpooled = (logits4, pix), (bin4, bin_pix, gate)
    seed, block = 1234, dict(block=4)
    return {
        "ce_ohem": ("cross_entropy_ohem", ce, dict(num_hard_positive=5, num_hard_negative=4)),
        "ce_ohem_few": ("cross_entropy_ohem", ce, dict(num_hard_positive=20,
                                                       num_hard_negative=3)),
        "ce_ohem_weighted": ("cross_entropy_ohem", ce, dict(weight=[1.0, 2.0, 0.5, 1.5])),
        "ce_ohem_random": ("cross_entropy_ohem", ce, dict(num_hard_positive=2,
                                                          num_hard_negative=3, random=True,
                                                          seed=seed)),
        "bce_ohem": ("bce_ohem", bce, dict(num_hard_positive=5, num_hard_negative=4)),
        "bce_ohem_random": ("bce_ohem", bce, dict(num_hard_positive=3, num_hard_negative=2,
                                                  random=True, seed=seed)),
        "ce_random_sample": ("cross_entropy_random_sample", ce, dict(sample_list=[5, 4],
                                                                     seed=seed)),
        "ce_random_sample_classes": ("cross_entropy_random_sample", ce,
                                     dict(sample_list=[4, 2, 2, 1], seed=seed)),
        "bce_random_sample": ("bce_random_sample", bce, dict(sample_list=[4], seed=seed)),
        "ce_ohem_pooled": ("cross_entropy_ohem_pooled", pooled,
                           dict(num_hard_positive=70, num_hard_negative=90, **block)),
        "ce_ohem_pooled_plain": ("cross_entropy_ohem_pooled", pooled,
                                 dict(weight=[1.0, 2.0, 0.5, 1.5], **block)),
        "ce_ohem_pooled_random": ("cross_entropy_ohem_pooled", pooled,
                                  dict(num_hard_positive=30, num_hard_negative=40, random=True,
                                       seed=seed, **block)),
        "bce_ohem_pooled": ("bce_ohem_pooled", bpooled,
                            dict(num_hard_positive=60, num_hard_negative=50, **block)),
        "bce_ohem_pooled_random": ("bce_ohem_pooled", bpooled,
                                   dict(num_hard_positive=20, num_hard_negative=25,
                                        random=True, seed=seed, **block)),
        "ce_random_sample_pooled": ("cross_entropy_random_sample_pooled", pooled,
                                    dict(sample_list=[60, 50], seed=seed, **block)),
        "ce_random_sample_pooled_classes": ("cross_entropy_random_sample_pooled", pooled,
                                            dict(sample_list=[30, 20, 20, 10], seed=seed,
                                                 **block)),
    }


DROP = dict(rate=0.25, seed=4321, eps=1e-12, heads=2, head_dim=8)


@pytest.fixture(scope="module")
def ops_case():
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    bn = dict(x=t(4, 6, 5, 7) * 2 + 0.5, g=t(4, 6, 5, 7), w=1 + 0.1 * t(6), b=0.1 * t(6))
    mbn = dict(x=t(4, 6, 3, 3) + 1.0, g=t(4, 6, 3, 3), w=1 + 0.1 * t(6), b=0.1 * t(6),
               mask=torch.tensor([True, True, False, False]))  # rank 1: all padding
    losses = {name: dict(fn=fn, arrays=list(arrays), kw=kw)
              for name, (fn, arrays, kw) in _loss_cases(rng).items()}
    tq, d = 24, DROP["heads"] * DROP["head_dim"]
    bias = torch.zeros(4, tq)
    bias[1, 18:] = bias[2, 20:] = -1e9
    n, dm, f = 40, 64, 128
    ffn_jax = [t(dm, f) * dm ** -0.5, 0.1 * t(f), t(f, dm) * f ** -0.5, 0.1 * t(dm),
               1 + 0.1 * t(dm), 0.1 * t(dm)]
    proj_jax = [t(dm, dm) * dm ** -0.5, 0.1 * t(dm), 1 + 0.1 * t(dm), 0.1 * t(dm)]
    port = lambda ps: [p.T.contiguous() if p.ndim == 2 else p for p in ps]
    dropout = dict(x=torch.ones(4, 6, 8), q=t(4, tq, d), k=t(4, tq, d), v=t(4, tq, d),
                   bias=bias, scale=DROP["head_dim"] ** -0.5, heads=DROP["heads"],
                   ffn_x=t(n, dm), ffn_params=port(ffn_jax), ctx=t(n, dm), res=t(n, dm),
                   proj_params=port(proj_jax), rate=DROP["rate"], seed=DROP["seed"],
                   eps=DROP["eps"])
    inputs = dict(bn=bn, mbn=mbn, losses=losses, dropout=dropout)
    return inputs, dict(ffn=ffn_jax, proj=proj_jax)


@pytest.fixture(scope="module")
def ops_run(ops_case, tmp_path_factory):
    return _wait(_start("ops", ops_case[0], tmp_path_factory.mktemp("ops")))


@pytest.mark.parametrize("name", ["bn", "mbn"])
def test_norms_take_the_global_batch_statistics(ops_case, ops_run, name):
    from vibertgrid_tpu_torch.models.norm import BatchNorm, MaskedBatchNorm

    case = ops_case[0][name]
    norm = (BatchNorm if name == "bn" else MaskedBatchNorm)(6)
    with torch.no_grad():
        norm.weight.copy_(case["w"])
        norm.bias.copy_(case["b"])
    x = case["x"].clone().requires_grad_()
    y = norm(x, *((case["mask"],) if name == "mbn" else ()), train=True)
    (y * case["g"]).sum().backward()
    got = [r["norms"][name] for r in ops_run]
    # fp32 sums of 70-140 terms in another order
    tol = dict(atol=2e-6, rtol=2e-5)
    np.testing.assert_allclose(_cat(g["y"] for g in got), y.detach().numpy(), **tol)
    # rank r's own gradient is world x its share of the global one
    np.testing.assert_allclose(_cat(g["dx"] / WORLD for g in got), x.grad.numpy(), **tol)
    for key, want in (("dw", norm.weight.grad), ("db", norm.bias.grad)):
        mean = torch.stack([g[key] for g in got]).mean(0)
        np.testing.assert_allclose(mean.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    for key, want in (("mean", norm.running_mean), ("var", norm.running_var)):
        for g in got:
            np.testing.assert_allclose(g[key].numpy(), want.numpy(), atol=1e-6, rtol=1e-5)
    if name == "mbn":  # the all-padding rank's entries are normalised all the same
        assert np.isfinite(got[1]["y"].numpy()).all()


LOSS_NAMES = [name for name in _loss_cases(np.random.default_rng(0))]


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_losses_over_two_ranks_equal_one_process(ops_case, ops_run, name):
    from vibertgrid_tpu_torch.ops import losses

    case = ops_case[0]["losses"][name]
    logits = case["arrays"][0].clone().requires_grad_()
    want = getattr(losses, case["fn"])(logits, *case["arrays"][1:], **case["kw"])
    want.backward()
    for r, got in enumerate(ops_run):
        # the same selected sets; fp32 sums in another order
        np.testing.assert_allclose(got["losses"][name]["loss"].item(), want.item(), rtol=2e-6)
        np.testing.assert_allclose((got["losses"][name]["grad"] / WORLD).numpy(),
                                   _rows(logits.grad, r).numpy(), atol=1e-7, rtol=1e-5)
    assert logits.grad.abs().sum() > 0


JAX_LOSSES = ["ce_ohem", "ce_ohem_few", "ce_ohem_weighted", "bce_ohem", "ce_ohem_pooled",
              "ce_ohem_pooled_plain", "bce_ohem_pooled"]


@pytest.mark.parametrize("name", JAX_LOSSES)
def test_deterministic_ohem_over_two_ranks_equals_jax(ops_case, ops_run, name):
    import jax.numpy as jnp

    from vibertgrid_tpu.ops import losses as jl

    case = ops_case[0]["losses"][name]
    arrays = [jnp.asarray(a.numpy()) for a in case["arrays"]]
    want = float(getattr(jl, case["fn"])(*arrays, **case["kw"]))
    for got in ops_run:
        np.testing.assert_allclose(got["losses"][name]["loss"].item(), want, rtol=1e-5)


def test_elementwise_dropout_is_the_rows_of_the_global_mask(ops_case, ops_run):
    import jax.numpy as jnp

    from vibertgrid_tpu.ops.dropout import hash_dropout

    d = ops_case[0]["dropout"]
    want = np.asarray(hash_dropout(jnp.asarray(d["x"].numpy()), jnp.int32(d["seed"]), d["rate"]))
    got = _cat(r["dropout"]["mask"] for r in ops_run)
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 0).mean() < 0.5


@pytest.mark.parametrize("kernel", ["attention", "ffn", "proj_ln"])
def test_kernel_twins_fold_the_rank_as_the_sharded_kernels(ops_case, ops_run, kernel):
    import jax.numpy as jnp

    from vibertgrid_tpu.ops.flash_attention import flash_attention_sharded
    from vibertgrid_tpu.ops.fused_ffn import fused_ffn_saved_sharded, fused_proj_ln_sharded
    from vibertgrid_tpu.parallel.mesh import make_mesh

    d, jax_params = ops_case
    d = d["dropout"]
    j = lambda x: jnp.asarray(x.numpy())
    seed, rate, eps, mesh = jnp.int32(d["seed"]), d["rate"], d["eps"], make_mesh(data=2)
    if kernel == "attention":
        want = flash_attention_sharded(j(d["q"]), j(d["k"]), j(d["v"]), j(d["bias"]), seed,
                                       d["scale"], d["heads"], rate, True, mesh=mesh)
    elif kernel == "ffn":
        want = fused_ffn_saved_sharded(j(d["ffn_x"]), *map(j, jax_params["ffn"]), seed, eps,
                                       rate, True, mesh=mesh)
    else:
        want = fused_proj_ln_sharded(j(d["ctx"]), j(d["res"]), *map(j, jax_params["proj"]),
                                     seed, eps, rate, True, mesh=mesh)
    got = _cat(r["dropout"][kernel] for r in ops_run)
    # fp32 on both sides, sums of up to 128 products in another order
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)
    # one process draws rank 0's stream on rank 1's rows: the fold matters
    from vibertgrid_tpu_torch.ops.flash_attention import flash_attention
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn_saved, fused_proj_ln

    with torch.no_grad():
        unfolded = [{"attention": lambda: flash_attention(
                        *(_rows(d[k], r) for k in ("q", "k", "v", "bias")), d["scale"],
                        d["heads"], rate=rate, seed=d["seed"]),
                     "ffn": lambda: fused_ffn_saved(_rows(d["ffn_x"], r), *d["ffn_params"], eps,
                                                    rate=rate, seed=d["seed"]),
                     "proj_ln": lambda: fused_proj_ln(_rows(d["ctx"], r), _rows(d["res"], r),
                                                      *d["proj_params"], eps, rate=rate,
                                                      seed=d["seed"]),
                     }[kernel]().numpy() for r in range(WORLD)]
    np.testing.assert_array_equal(unfolded[0], _rows(torch.from_numpy(got), 0).numpy())
    assert np.abs(unfolded[1] - _rows(torch.from_numpy(got), 1).numpy()).max() > 1e-2


# -------------------------------------------------------------------- train


LR_BERT = 2e-3  # tests/test_torch_train.py's HYP


@pytest.fixture(scope="module")
def train_case(tmp_path_factory):
    from tests.test_torch_train import MODEL_KW, SHAPE, TRAIN_HYP

    tmp = tmp_path_factory.mktemp("train")
    yield dict(model_kw=MODEL_KW, hyp=TRAIN_HYP, shape=dict(SHAPE, b=2 * WORLD), seed=5,
               min_size=128, ckpt_dir=str(tmp / "ckpt")), tmp
    drop_checkpoints(tmp)


@pytest.fixture(scope="module")
def train_runs(train_case):
    """The two ranks' runs, and one process on the concatenated batch (while
    the ranks run): two steps and a clipped one (OHEM random off), two steps
    (on), three plain steps (off)."""
    from tests.torch_parallel_worker import run_steps, tiny_train_state

    run = _start("train", *train_case)
    inp = train_case[0]
    single = {}
    for key, ohem_random, clip in (("ohem_random=False", False, 1),
                                   ("ohem_random=True", True, 0), ("plain", False, 0)):
        state, batch = tiny_train_state(inp, ohem_random)
        single[key] = run_steps(state, batch, inp["seed"], 2, clip_steps=clip)
        if key == "plain":  # a third step without the clip
            third = run_steps(state, batch, inp["seed"], 1)
            single[key].update(final=third["final"], losses=single[key]["losses"] + third["losses"])
    for mode in ("full", "crf"):
        state, batch = tiny_train_state(inp, True, mode)
        single[mode] = run_steps(state, batch, inp["seed"], 1)
    return _wait(run), single


@pytest.fixture(scope="module")
def train_run(train_runs):
    return train_runs[0]


@pytest.fixture(scope="module")
def train_single(train_runs):
    return train_runs[1]


def _close_grads(got: dict, want: dict):
    """As ``tests/test_parallel_train.py`` compares the JAX package's: the
    norm within 1e-2 and the direction within cos 0.999 (BatchNorm over a
    small batch amplifies the other summation order); every gradient's norm,
    the watched ones whole."""
    assert got["stats"].keys() == want["stats"].keys() and got["full"]
    for name, b in want["stats"].items():
        na, nb = got["stats"][name][1].sqrt().item(), b[1].sqrt().item()
        assert abs(na - nb) <= 1e-2 * max(na, nb) + 1e-6, (name, na, nb)
    for name in want["full"]:
        a = got["full"][name].double().numpy().ravel()
        b = want["full"][name].double().numpy().ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na * nb > 1e-12:
            assert float(np.dot(a, b) / (na * nb)) > 0.999, name
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)


def _close_params(got: dict, want: dict, steps: int = 3):
    """Every tensor's norm, the watched ones whole (the AdamW rule below
    bounds the norm of a BERT tensor's difference, so its norm's change)."""
    for name, b in want["stats"].items():
        na, nb, n = got["stats"][name][1].sqrt().item(), b[1].sqrt().item(), b[2].item()
        noisy = n if name.endswith("attention.key.bias") else max(1.0, 0.01 * n)
        slack = 2 * LR_BERT * steps * noisy ** 0.5 if name.startswith("bert_model.") else 0.0
        assert abs(na - nb) <= 1e-4 * abs(nb) + 1e-6 + slack, (name, na, nb)
    for name in want["full"]:
        a, b = got["full"][name].numpy(), want["full"][name].numpy()
        if name.startswith("bert_model."):
            # AdamW divides by sqrt(nu): an element whose gradient is at the
            # rounding level (the key bias's is 0 in exact arithmetic: the
            # softmax ignores a constant added to every key's score) moves
            # by ±lr whatever its size, so such elements may differ by whole
            # steps; the rest agree closely (tests/test_torch_train.py's rule:
            # all but 1% of a tensor, or all but one element of a small one)
            diff = np.abs(a - b)
            assert diff.max() <= 2 * LR_BERT * steps, name
            if not name.endswith("attention.key.bias"):
                assert np.sum(diff > 2e-4 + 1e-3 * np.abs(b)) <= max(1, 0.01 * b.size), name
            continue
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-3, err_msg=name)


def _same(a: dict, b: dict) -> bool:
    """Bit-equal watched tensors and equal sums of every tensor."""
    return (all(torch.equal(a["stats"][n], b["stats"][n]) for n in a["stats"])
            and all(torch.equal(a["full"][n], b["full"][n]) for n in a["full"]))


@pytest.mark.parametrize("key", ["ohem_random=False", "ohem_random=True"])
def test_train_step_over_two_ranks_equals_one_process(train_run, train_single, key):
    want = train_single[key]
    for got in (r[key] for r in train_run):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
        _close_grads(got["grads"], want["grads"])
        _close_params(got["params"], want["params"])
        _close_params(got["final"], want["final"])  # the clipped step, with OHEM random off
    assert _same(*(r[key]["final"] for r in train_run))  # the ranks hold the same model


@pytest.mark.parametrize("mode", ["full", "crf"])
def test_other_families_step_as_one_process(train_run, train_single, mode):
    """The full head (the gate's random sample, the binary OHEM losses, the
    two-stage segmentation head, each "any positive" over the global batch)
    and the CRF head (the NLL's mean over the global batch), one step with
    OHEM random on."""
    want = train_single[mode]
    for got in (r[mode] for r in train_run):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
        _close_grads(got["grads"], want["grads"])
        _close_params(got["final"], want["final"], steps=1)
    assert ("field_type_head.transitions" in want["grads"]["full"]) == (mode == "crf")


def test_the_clip_fires_alike(train_run, train_single):
    want = train_single["ohem_random=False"]["scales"]
    assert want[2] < 1e-2  # the third step clipped its gradients
    for got in (r["ohem_random=False"]["scales"] for r in train_run):
        # the same decision and factor on every rank: the global loss and
        # the averaged gradients
        np.testing.assert_allclose(got, want, rtol=1e-3)
    assert train_run[0]["ohem_random=False"]["scales"] == train_run[1]["ohem_random=False"]["scales"]


def test_zero1_updates_as_the_replicated_run(train_run):
    for r in train_run:
        want = r["ohem_random=False"]
        np.testing.assert_array_equal(r["zero1"]["losses"], want["losses"][:2])
        for part in ("full", "stats"):  # the update is elementwise
            for name, value in r["zero1"]["params"][part].items():
                np.testing.assert_allclose(value.numpy(), want["params"][part][name].numpy(),
                                           atol=1e-7, rtol=1e-6, err_msg=name)
    assert _same(*(r["zero1"]["final"] for r in train_run))


def test_zero1_holds_half_the_large_state(train_run):
    for rank, r in enumerate(train_run):
        run = r["zero1"]
        assert run["shards"], "no leaf was split"
        assert all(start == rank * length for _, start, length in run["shards"].values())
        full, kept, split = (run["bytes"][k] for k in ("replicated", "zero1", "split"))
        # a rank keeps half of each split leaf and all of the others; the
        # split leaves are most of the state
        assert kept == full - split // WORLD and split > 0.9 * full, run["bytes"]


def test_zero1_checkpoint_resumes_in_one_process(train_case, train_run, train_single):
    from tests.torch_parallel_worker import kept, run_steps, tiny_train_state
    from vibertgrid_tpu_torch.train.checkpoint import restore_checkpoint

    inp, _ = train_case
    state, batch = tiny_train_state(inp, False)
    _, meta = restore_checkpoint(os.path.join(inp["ckpt_dir"], "zero1"), state)
    assert state.step == 2 and state.optimizer.count == 2 and not state.optimizer.shards
    plain = train_single["plain"]
    _close_params(kept(state.model.state_dict()), plain["params"])
    resumed = run_steps(state, batch, inp["seed"], 1)
    np.testing.assert_allclose(resumed["losses"], plain["losses"][2:], rtol=2e-5)
    _close_params(resumed["final"], plain["final"])


# --------------------------------------------------------------- eval, driver


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root

    return make_synthetic_root(str(tmp_path_factory.mktemp("synth")), n_train=8, n_test=5,
                               seed=0)


def _tiny_hyp(root, tmp, **kw):
    from tests.test_train_driver import tiny_hyp

    hyp = tiny_hyp(root)
    hyp.update(mesh_data=None, save_top=str(tmp / "w"), save_log=str(tmp / "l"),
               result_dir=str(tmp / "result"), **kw)
    return hyp


def test_validate_gathers_the_metrics(synth_root, tmp_path):
    from tests.torch_parallel_worker import task_eval

    """``validate`` and the eval CLI's ``evaluate`` over 5 documents, 3 on
    rank 0 and 2 on rank 1 (batch size 1), against one process."""
    run = _start("eval", dict(hyp=_tiny_hyp(synth_root, tmp_path / "ranks")), tmp_path)
    want = task_eval(dict(hyp=_tiny_hyp(synth_root, tmp_path / "one")), 0, 1)
    got = _wait(run)
    assert [g["batches"] for g in got] == [3, 2] and want["batches"] == 5
    for g in got:
        for kind in ("results", "cli"):
            res = g[kind]
            assert res.keys() == want[kind].keys()
            for key, value in want[kind].items():
                if key.startswith("loss"):  # means of the five documents' losses
                    assert res[key] == pytest.approx(value, rel=1e-6)
                elif key != "token_F1_dict":
                    assert res[key] == value, (kind, key)
    assert want["results"]["per_sample"] and want["results"]["token_accuracy"] > 0
    # rank 0 alone writes the CLI's report
    assert os.listdir(tmp_path / "ranks" / "result") == ["eval.json"]


def test_driver_main_trains_on_two_ranks(synth_root, tmp_path):
    hyp = _tiny_hyp(synth_root, tmp_path, end_epoch=1)
    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump(hyp))
    got = _wait(_start("driver", dict(config=str(config)), tmp_path))
    a, b = got
    assert a["losses"] == b["losses"] and len(a["losses"]) == 2 and np.isfinite(a["losses"]).all()
    assert a["f1"] == b["f1"] and a["loss"] == b["loss"] and a["steps"] == b["steps"] == 2
    # 8 documents, two processes, batch 2: 2 steps an epoch each (the
    # schedule arrays hold epochs · (niter_per_ep + 1) entries)
    assert a["schedule_len"] == (8 // WORLD // hyp["batch_size"] + 1) * hyp["end_epoch"]
    assert a["docs"] == [2 * hyp["batch_size"] * WORLD]
    assert len(os.listdir(tmp_path / "w")) == 1


def test_the_worker_imports_no_jax():
    from pathlib import Path

    from tests.test_torch_isolation import FORBIDDEN, _imports

    names = list(_imports(Path(WORKER)))
    assert "torch" in names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names
