"""The port stands apart from the JAX package, and its kernel wrappers take
the plain twins only for CPU tensors.

- no module of ``vibertgrid_tpu_torch`` and not ``chip_smoke.py`` imports
  jax, flax or ``vibertgrid_tpu`` (an AST scan, and an import in a fresh
  interpreter);
- no file of the port names the JAX package's host library
  (``csrc/libhost_ops.so``) or its build script (``csrc/build.sh``), and a
  process that runs the port's collate maps only the port's own host
  library, built under ``build/``;
- the entry points default to the card and raise where it is absent;
- on CPU tensors the wrappers run their twins and count no launch.

The tests marked ``cuda`` hold the kernels against their twins on a GPU;
they skip where ``torch.cuda.is_available()`` is false.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vibertgrid_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vibertgrid_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_scan_covers_every_sub_package():
    scanned = {p.relative_to(PORT).parts[0] for p in _port_files() if p.is_relative_to(PORT)}
    assert {"models", "ops", "train", "data", "eval", "serve", "utils", "preprocessing",
            "parallel", "entry.py", "convert.py"} <= scanned
    assert {PORT / "train" / "state.py", PORT / "train" / "checkpoint.py",
            PORT / "ops" / "crf.py", PORT / "train" / "driver.py",
            PORT / "models" / "convert_reference.py", PORT / "serve" / "engine.py",
            PORT / "data" / "transform.py", PORT / "eval" / "entities.py",
            PORT / "data" / "dataset.py", PORT / "eval" / "harness.py", PORT / "eval" / "cli.py",
            PORT / "eval" / "seqeval_lite.py", PORT / "eval" / "criteria.py",
            PORT / "utils" / "logging.py", PORT / "utils" / "visualize.py",
            PORT / "utils" / "profiling.py", PORT / "ops" / "segments.py",
            *(PORT / "parallel" / f"{name}.py" for name in ("mesh", "collectives", "sharding")),
            *(PORT / "preprocessing" / f"{name}.py"
              for name in ("common", "sroie", "ephoie", "funsd", "split"))} <= set(_port_files())


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_port_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import vibertgrid_tpu_torch.entry, vibertgrid_tpu_torch.convert\n"
        "import vibertgrid_tpu_torch.models.vibertgrid, vibertgrid_tpu_torch.train\n"
        "import vibertgrid_tpu_torch.ops.losses, vibertgrid_tpu_torch.ops.dropout\n"
        "import vibertgrid_tpu_torch.ops.crf, vibertgrid_tpu_torch.train.checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serve_import_leaves_jax_and_transformers_unloaded():
    code = (
        "import sys\n"
        "import vibertgrid_tpu_torch.serve, vibertgrid_tpu_torch.data\n"
        "import vibertgrid_tpu_torch.eval, vibertgrid_tpu_torch.train.driver\n"
        "import vibertgrid_tpu_torch.eval.cli, vibertgrid_tpu_torch.utils.visualize\n"
        "import vibertgrid_tpu_torch.preprocessing.sroie\n"
        "import vibertgrid_tpu_torch.models.convert_reference\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('transformers',)!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


JAX_HOST_LIBRARY = ("libhost_ops", "build.sh")


@pytest.mark.parametrize(
    "path", sorted(p for p in PORT.rglob("*") if p.suffix in (".py", ".cpp", ".cu", ".cuh"))
    + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_no_part_of_the_jax_host_library(path):
    text = path.read_text()
    for name in JAX_HOST_LIBRARY:
        assert name not in text, f"{path.name} names {name}"


def test_the_collate_loads_only_the_ports_host_library():
    code = (
        "import numpy as np\n"
        "from vibertgrid_tpu_torch.data.dataset import Collator, Sample\n"
        "from vibertgrid_tpu_torch.data.transform import ImageTransform\n"
        "s = Sample(np.ones((50, 40, 3), np.float32), np.ones(3, np.int32), np.zeros(3, np.int32),\n"
        "           np.zeros((1, 4), np.int32), np.zeros(1, np.int32), ['a'])\n"
        "for u8 in (False, True):\n"
        "    Collator(ImageTransform([0.5] * 3, [0.5] * 3, [32], 32, 64), emit_uint8=u8)([s], False)\n"
        "maps = open('/proc/self/maps').read().split()\n"
        "print(sorted({m for m in maps if m.endswith('.so') and 'host' in m}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    loaded = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert len(loaded) == 1, loaded
    lib = Path(loaded[0])
    assert lib.name == "libvibertgrid_host.so"
    assert lib.is_relative_to(ROOT / "build" / "vibertgrid_tpu_torch" / "host")
    assert not (ROOT / "csrc" / "libhost_ops.so").samefile(lib)


def test_inference_engine_defaults_to_cuda_and_raises_without_it():
    from vibertgrid_tpu_torch.serve.engine import InferenceEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    hyp = {"num_classes": 5, "bert_version": "tiny-bert-test", "backbone": "resnet_18_fpn"}
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(hyp, tokenizer=object())
    from vibertgrid_tpu_torch.train.driver import build_all

    with pytest.raises(RuntimeError, match="cuda"):
        build_all(hyp, "sroie")


def test_train_and_evaluate_default_to_cuda_and_raise_without_it(tmp_path):
    from vibertgrid_tpu_torch.eval.cli import evaluate
    from vibertgrid_tpu_torch.train.driver import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    hyp = {"num_classes": 5, "bert_version": "tiny-bert-test", "backbone": "resnet_18_fpn",
           "data_root": str(tmp_path), "weights": str(tmp_path), "tee_logs": False}
    for run in (train, evaluate):
        with pytest.raises(RuntimeError, match="cuda"):
            run(hyp, "sroie")


def test_entry_defaults_to_cuda_and_raises_without_it():
    from vibertgrid_tpu_torch.entry import entry, make_batch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
    with pytest.raises(RuntimeError, match="cuda"):
        make_batch(1, 64, 64, 510, 4, 512)


def test_entry_on_cpu_runs_the_flagship_forward():
    from vibertgrid_tpu_torch.entry import entry

    forward, (model, batch) = entry(device="cpu")
    pred = forward(model, batch)
    assert not pred.requires_grad
    assert pred.shape == (1, 32, 5)
    assert torch.isfinite(pred).all()
    np.testing.assert_allclose(pred.sum(-1).numpy(), 1.0, atol=1e-5)


def test_wrappers_use_twins_on_cpu_and_count_no_launch():
    from vibertgrid_tpu_torch.ops import kernels
    from vibertgrid_tpu_torch.ops.flash_attention import attention_reference, flash_attention
    from vibertgrid_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn
    from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter
    from vibertgrid_tpu_torch.ops.rasterize import bertgrid_scatter

    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 40, 32, generator=g) for _ in range(3))
    bias = torch.zeros(2, 40)
    torch.testing.assert_close(flash_attention(q, k, v, bias, 0.25, 2),
                               attention_reference(q, k, v, bias, 0.25, 2), rtol=0, atol=0)
    x = torch.randn(10, 64, generator=g)
    ffn = (x, torch.randn(128, 64, generator=g), torch.zeros(128), torch.randn(64, 128, generator=g),
           torch.zeros(64), torch.ones(64), torch.zeros(64), 1e-12)
    torch.testing.assert_close(fused_ffn(*ffn), ffn_reference(*ffn), rtol=0, atol=0)
    emb = torch.randn(2, 3, 16, generator=g)
    boxes = torch.tensor([[[0, 0, 16, 16], [8, 8, 32, 24], [0, 0, 0, 0]]] * 2, dtype=torch.int32)
    mask = torch.ones(2, 3, dtype=torch.bool)
    torch.testing.assert_close(grid_scatter(emb, boxes, mask, height=4, width=4),
                               bertgrid_scatter(emb, boxes, mask, height=4, width=4),
                               rtol=0, atol=0)
    # the backward wrappers too: gradients on CPU tensors come from the twins
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, bias, 0.25, 2, rate=0.1, seed=3).sum().backward()
    emb.requires_grad_()
    grid_scatter(emb, boxes, mask, height=4, width=4).sum().backward()
    assert leaves[0].grad is not None and emb.grad is not None
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_proj_ln, proj_ln_reference

    proj = (x, torch.randn(10, 64, generator=g), torch.randn(64, 64, generator=g),
            torch.zeros(64), torch.ones(64), torch.zeros(64), 1e-12)
    torch.testing.assert_close(fused_proj_ln(*proj), proj_ln_reference(*proj), rtol=0, atol=0)
    from vibertgrid_tpu_torch.train.state import _squares

    # the clip's sum of squares on CPU gradients: the library's fp64 norms
    want = torch.stack(torch._foreach_norm([x, emb.grad], dtype=torch.float64)).square().sum()
    assert torch.equal(_squares([x, emb.grad]), want)
    assert set(kernels.LAUNCHES) == {
        "flash_attention", "flash_attention_bwd", "fused_ffn", "fused_ffn_saved",
        "fused_proj_ln", "bertgrid_scatter", "bertgrid_scatter_bwd", "grad_sq_norm",
        "dual_update"}
    assert not any(kernels.LAUNCHES.values())


def test_dropout_rates_raise():
    """Dropout is ported: a rate above 0 runs (on CPU through the twins). What
    still raises is a dropout site that is given no seed stream."""
    from vibertgrid_tpu_torch.models.bert import TextEncoder, TextEncoderConfig
    from vibertgrid_tpu_torch.ops.flash_attention import flash_attention
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn
    from vibertgrid_tpu_torch.train.seeds import ReplaySeeds, SeedStream

    x = torch.ones(1, 4, 8)
    out = flash_attention(x, x, x, torch.zeros(1, 4), 1.0, 2, rate=0.5, seed=1)
    assert not torch.equal(out, flash_attention(x, x, x, torch.zeros(1, 4), 1.0, 2))
    w = torch.eye(64)
    ffn = (torch.ones(3, 64), torch.cat([w, w]), torch.zeros(128), torch.cat([w, w], 1),
           torch.zeros(64), torch.ones(64), torch.zeros(64), 1e-12)
    assert not torch.equal(fused_ffn(*ffn, rate=0.5, seed=1), fused_ffn(*ffn))

    encoder = TextEncoder(TextEncoderConfig.tiny(), device="cpu")
    ids, mask = torch.randint(3, 500, (1, 12)), torch.ones(1, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="seed stream"):
        encoder(ids, mask, deterministic=False)
    # embedding + 2 layers x (attention, attention output, FFN) = 7 draws,
    # with the unfused and with the fused attention epilogue
    fused = TextEncoder(dataclasses.replace(TextEncoderConfig.tiny(), attn_epilogue="fused"),
                        device="cpu")
    for model in (encoder, fused):
        seeds = ReplaySeeds(range(7))
        model(ids, mask, deterministic=False, seeds=seeds)
        with pytest.raises(IndexError):
            seeds.next()
    a, b = SeedStream(5), SeedStream(5)
    assert [a.next() for _ in range(4)] == [b.next() for _ in range(4)]


def test_unported_paths_raise():
    """What the port does not know raises; every classifier mode the JAX
    package builds constructs and runs."""
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.models import ModelConfig, ViBERTgridNet
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    with pytest.raises(ValueError, match="classifier_mode"):
        ViBERTgridNet(ModelConfig(bert_version="tiny-bert-test", classifier_mode="bio"),
                      device="cpu")
    batch = make_batch(1, 64, 64, 510, 4, 512, device="cpu")
    for mode, shape in (("full", (1, 4, 5)), ("crf", (1, 4))):
        net = ViBERTgridNet(ModelConfig(bert_version="tiny-bert-test", classifier_mode=mode),
                            device="cpu")
        with torch.no_grad():
            out = net(batch, compute_loss=True)
        assert torch.isfinite(out.total_loss) and out.pred_label.shape == shape
        out = net(batch, train=True, compute_loss=True, seeds=SeedStream(0))
        assert out.total_loss.requires_grad
    # training and the losses are ported: the simplified model takes both
    net = ViBERTgridNet(ModelConfig(bert_version="tiny-bert-test"), device="cpu")
    with torch.no_grad():
        out = net(batch, compute_loss=True)
    assert torch.isfinite(out.total_loss) and out.pred_mask.shape == (1, 64, 64, 3)
    # an evaluation forward under autograd takes the saved-residual FFN: the
    # same prediction as under no_grad, and a gradient for the parameters
    with torch.no_grad():
        want = net(batch).pred_label
    pred = net(batch).pred_label
    torch.testing.assert_close(pred.detach(), want, rtol=0, atol=1e-6)
    pred.square().sum().backward()
    assert net.bert_model.layer[0].intermediate.weight.grad.abs().sum() > 0


def test_train_entry_on_cpu_takes_one_step():
    import dataclasses

    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, train_entry
    from vibertgrid_tpu_torch.ops import kernels
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_entry()
    config = dataclasses.replace(FLAGSHIP_TRAIN, bert_version="tiny-bert-test",
                                 backbone="resnet_18_fpn", compute_dtype=torch.float32)
    state, train_step, batch = train_entry(
        device="cpu", config=config, shape=dict(b=2, h=64, w=64, t=510, s=6, vocab=512))
    model = state.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kernels.reset_launch_counts()
    state, loss = train_step(state, batch, SeedStream(0))
    assert torch.isfinite(loss) and state.step == 1 and state.optimizer.count == 1
    assert not any(kernels.LAUNCHES.values())
    after = model.state_dict()
    for name in ("bert_model.layer.1.output.weight", "backbone.stem_conv.weight",
                 "semantic_segmentation_head.encoder.class_proj.bias",
                 "backbone.stem_bn.running_mean", "late_fusion.roi_embedding.bn2.running_var"):
        assert not torch.equal(after[name], before[name]), name
    sgd = state.optimizer.state[model.backbone.stem_conv.weight]["momentum"]
    adam = state.optimizer.state[model.bert_model.layer[0].output.weight]
    assert sgd.dtype == torch.bfloat16 and sgd.abs().sum() > 0
    assert adam["mu"].dtype == torch.bfloat16 and adam["nu"].abs().sum() > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: python -m pytest --noconftest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_twins_on_cuda(cuda_device):
    import chip_smoke

    for check in (chip_smoke.check_attention, chip_smoke.check_attention_bwd,
                  chip_smoke.check_ffn, chip_smoke.check_ffn_saved, chip_smoke.check_proj_ln,
                  chip_smoke.check_scatter, chip_smoke.check_scatter_bwd):
        record = check(cuda_device)
        assert record["ms"] > 0


@pytest.mark.cuda
def test_wrapper_counts_launches_on_cuda(cuda_device):
    from vibertgrid_tpu_torch.ops import kernels
    from vibertgrid_tpu_torch.ops.grid_scatter import grid_scatter

    kernels.reset_launch_counts()
    emb = torch.randn(1, 2, 16, device=cuda_device)
    boxes = torch.tensor([[[0, 0, 16, 16], [8, 8, 32, 24]]], dtype=torch.int32, device=cuda_device)
    grid_scatter(emb, boxes, torch.ones(1, 2, dtype=torch.bool, device=cuda_device),
                 height=4, width=4)
    assert kernels.LAUNCHES["bertgrid_scatter"] == 1 and kernels.LAUNCHES["bertgrid_scatter_bwd"] == 0
    emb.requires_grad_()
    grid_scatter(emb, boxes, torch.ones(1, 2, dtype=torch.bool, device=cuda_device),
                 height=4, width=4).sum().backward()
    assert kernels.LAUNCHES["bertgrid_scatter_bwd"] == 1
