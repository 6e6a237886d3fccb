"""The port stands apart from the JAX package, and its kernel wrappers take
the plain twins only for CPU tensors.

- no module of ``vibertgrid_tpu_torch`` and not ``chip_smoke.py`` imports
  jax, flax or ``vibertgrid_tpu`` (an AST scan, and an import in a fresh
  interpreter);
- the entry points default to the card and raise where it is absent;
- on CPU tensors the wrappers run their twins and count no launch.

The tests marked ``cuda`` hold the kernels against their twins on a GPU;
they skip where ``torch.cuda.is_available()`` is false.
"""

import ast
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


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_port_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import vibertgrid_tpu_torch.entry, vibertgrid_tpu_torch.convert\n"
        "import vibertgrid_tpu_torch.models.vibertgrid\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
    assert kernels.LAUNCHES == {"flash_attention": 0, "fused_ffn": 0, "bertgrid_scatter": 0}


def test_dropout_rates_raise():
    from vibertgrid_tpu_torch.ops.flash_attention import flash_attention
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn

    x = torch.zeros(1, 4, 8)
    with pytest.raises(NotImplementedError):
        flash_attention(x, x, x, torch.zeros(1, 4), 1.0, 2, rate=0.1)
    with pytest.raises(NotImplementedError):
        fused_ffn(x[0], None, None, None, None, None, None, 1e-12, rate=0.1)


def test_unported_paths_raise():
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.models import ModelConfig, ViBERTgridNet

    for mode in ("full", "crf"):
        with pytest.raises(NotImplementedError, match="item 11"):
            ViBERTgridNet(ModelConfig(bert_version="tiny-bert-test", classifier_mode=mode),
                          device="cpu")
    net = ViBERTgridNet(ModelConfig(bert_version="tiny-bert-test"), device="cpu")
    batch = make_batch(1, 64, 64, 510, 4, 512, device="cpu")
    with pytest.raises(NotImplementedError):
        net(batch, train=True)
    with pytest.raises(NotImplementedError):
        net(batch, compute_loss=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: python -m pytest --noconftest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_twins_on_cuda(cuda_device):
    import chip_smoke

    for check in (chip_smoke.check_attention, chip_smoke.check_ffn, chip_smoke.check_scatter):
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
    assert kernels.LAUNCHES["bertgrid_scatter"] == 1
