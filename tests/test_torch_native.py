"""The port's C++ host ops (``vibertgrid_tpu_torch/data/native.py`` over
``vibertgrid_tpu_torch/csrc/host_ops.cpp``) on the CPU, built here with the
host's compiler.

- each of the five functions bit-equal to the JAX package's native op
  (``vibertgrid_tpu/data/native.py``) and to the port's plain version
  (``data/transform.py``, ``ops/rasterize.py::box_winner_map``): down by
  more than 2, up, up on one axis and down on the other, the same size,
  one channel and three, and a strided write into a canvas whose other
  pixels stay as they were;
- the ``Collator``'s batch through the host op bit-equal to the same batch
  built with the plain versions, float and uint8 wire, at train-time random
  sizes, on a thread pool; ``ImageTransform`` likewise;
- two processes that build the library at once load one library;
- a broken compiler on ``PATH`` raises with its log, and nothing falls back
  to the plain path.
"""

import hashlib
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from vibertgrid_tpu.data import native as jnative
from vibertgrid_tpu_torch.data import native
from vibertgrid_tpu_torch.data import transform as ttransform
from vibertgrid_tpu_torch.data.dataset import Collator, Sample
from vibertgrid_tpu_torch.ops.rasterize import box_winner_map

ROOT = Path(__file__).resolve().parents[1]
MEAN = np.asarray([0.9248, 0.9224, 0.9215], np.float32)
STD = np.asarray([0.1532, 0.1545, 0.1536], np.float32)

# (source h, w) -> (output h, w)
SIZES = {
    "down more than 2": ((230, 170), (61, 45)),
    "down, a page": ((1100, 850), (331, 256)),
    "up": ((37, 53), (80, 117)),
    "mixed": ((64, 900), (128, 300)),
    "same size": ((48, 40), (48, 40)),
}


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    """The JAX module falls back to numpy where its library does not load:
    every comparison below is with its C++ op."""
    assert jnative.native_available()


def _image(hw, c, seed=0):
    return np.random.default_rng(seed + hw[0] + c).random((*hw, c)).astype(np.float32)


def _channels(c):
    return (MEAN[:c], STD[:c]) if c <= 3 else (np.full(c, 0.5, np.float32),
                                               np.full(c, 0.25, np.float32))


def _plain_norm(image, oh, ow, mean, std):
    out = np.empty((oh, ow, image.shape[2]), np.float32)
    ttransform.resize_normalize_into(image, out, oh, ow, mean, std)
    return out


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("case", list(SIZES))
def test_bilinear_resize_is_the_jax_ops_bits(case, c):
    (h, w), (oh, ow) = SIZES[case]
    image = _image((h, w), c)
    got = native.bilinear_resize(image, oh, ow)
    assert got.shape == (oh, ow, c) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.bilinear_resize(image, oh, ow))
    np.testing.assert_array_equal(got, ttransform.bilinear_resize(image, oh, ow))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("case", list(SIZES))
def test_bilinear_resize_norm_is_the_jax_ops_bits(case, c):
    (h, w), (oh, ow) = SIZES[case]
    image = _image((h, w), c, seed=1)
    mean, std = _channels(c)
    got = native.bilinear_resize_norm(image, oh, ow, mean, std)
    np.testing.assert_array_equal(got, jnative.bilinear_resize_norm(image, oh, ow, mean, std))
    np.testing.assert_array_equal(got, _plain_norm(image, oh, ow, mean, std))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("case", list(SIZES))
def test_resize_into_a_canvas_leaves_the_rest_as_it_was(case, c):
    """The strided write: the page's top-left slot of a canvas that is
    taller and wider, its other pixels random and untouched."""
    (h, w), (oh, ow) = SIZES[case]
    image = _image((h, w), c, seed=2)
    mean, std = _channels(c)
    canvas = np.random.default_rng(9).standard_normal((oh + 13, ow + 21, c)).astype(np.float32)
    got, jax_got, plain = canvas.copy(), canvas.copy(), canvas.copy()
    native.bilinear_resize_norm_into(image, got, oh, ow, mean, std)
    jnative.bilinear_resize_norm_into(image, jax_got, oh, ow, mean, std)
    ttransform.resize_normalize_into(image, plain, oh, ow, mean, std)
    np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(got, plain)
    outside = np.ones(canvas.shape[:2], bool)
    outside[:oh, :ow] = False
    np.testing.assert_array_equal(got[outside], canvas[outside])
    assert not np.array_equal(got[:oh, :ow], canvas[:oh, :ow])


def test_resize_into_checks_its_canvas():
    image = _image((40, 30), 3)
    with pytest.raises(ValueError, match="cannot hold"):
        native.bilinear_resize_norm_into(image, np.zeros((20, 64, 3), np.float32), 32, 24,
                                         MEAN, STD)
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.bilinear_resize_norm_into(image, np.zeros((64, 64, 3), np.float64), 32, 24,
                                         MEAN, STD)
    with pytest.raises(ValueError, match="channels"):
        native.bilinear_resize_norm(image, 32, 24, MEAN[:2], STD)


@pytest.mark.parametrize("stride", [1, 4, 8])
def test_rasterize_winner_is_the_jax_op_and_box_winner_map(stride):
    """Later boxes win; masked boxes paint nothing; boxes past the edge are
    clipped."""
    rng = np.random.default_rng(stride)
    h, w, s = 96, 128, 40
    x0 = rng.integers(0, w * stride, s)
    y0 = rng.integers(0, h * stride, s)
    boxes = np.stack([x0, y0, x0 + rng.integers(1, 60 * stride, s),
                      y0 + rng.integers(1, 30 * stride, s)], 1).astype(np.int32)
    mask = rng.random(s) < 0.8
    got = native.rasterize_winner(boxes, mask, h, w, stride)
    assert got.dtype == np.int32 and got.shape == (h, w)
    np.testing.assert_array_equal(got, jnative.rasterize_winner(boxes, mask, h, w, stride))
    want = box_winner_map(torch.from_numpy(boxes), torch.from_numpy(mask), height=h, width=w,
                          stride=stride)
    np.testing.assert_array_equal(got, want.numpy())
    assert 0 < len(np.unique(got)) - 1 <= mask.sum()


@pytest.mark.parametrize("c", [1, 3])
def test_pad_into_is_the_jax_op_and_a_slice_copy(c):
    image = _image((37, 29), c)
    got, jax_got = np.zeros((64, 48, c), np.float32), np.zeros((64, 48, c), np.float32)
    plain = np.zeros_like(got)
    native.pad_into(image, got)
    jnative.pad_into(image, jax_got)
    plain[:37, :29] = image
    np.testing.assert_array_equal(got, jax_got)
    np.testing.assert_array_equal(got, plain)


# --------------------------------------------------------------- collate


TRANSFORM = ttransform.ImageTransform(image_mean=MEAN, image_std=STD,
                                      train_min_size=[64, 96, 128, 160], test_min_size=96,
                                      max_size=200)


def _samples(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = int(rng.integers(60, 400)), int(rng.integers(60, 400))
        s, t = int(rng.integers(1, 9)), int(rng.integers(1, 40))
        x0, y0 = rng.integers(0, w // 2, s), rng.integers(0, h // 2, s)
        boxes = np.stack([x0, y0, x0 + rng.integers(1, w // 2, s), y0 + rng.integers(1, h // 2, s)],
                         1).astype(np.int32)
        out.append(Sample(image=rng.random((h, w, 3)).astype(np.float32),
                          tokens=rng.integers(1, 500, t).astype(np.int32),
                          seg_ids=np.sort(rng.integers(0, s, t)).astype(np.int32),
                          boxes=boxes, seg_classes=rng.integers(0, 5, s).astype(np.int32),
                          texts=[f"w{i}"] * s))
    return out


@pytest.mark.parametrize("emit_uint8", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_collator_through_the_host_op_is_the_plain_batch(emit_uint8, train):
    """The canvas the collator resizes into through the host op, on a pool,
    against one built page by page with the plain versions at the sizes
    the collator drew; every other array as it is."""
    samples = _samples(seed=int(train) + 2 * int(emit_uint8))
    collator = Collator(TRANSFORM, emit_uint8=emit_uint8)
    with ThreadPoolExecutor(max_workers=3) as pool:
        batch, aux = collator(samples, train, np.random.default_rng(5), pool=pool)
    serial, _ = collator(samples, train, np.random.default_rng(5))
    want = np.zeros_like(batch.images)
    for i, (s, (oh, ow)) in enumerate(zip(samples, aux.image_sizes)):
        if emit_uint8:
            ttransform.resize_uint8_into(s.image, want[i], oh, ow)
        else:
            ttransform.resize_normalize_into(s.image, want[i], oh, ow, MEAN, STD)
    assert batch.images.dtype == (np.uint8 if emit_uint8 else np.float32)
    np.testing.assert_array_equal(batch.images, want)
    np.testing.assert_array_equal(serial.images, want)
    if train:  # the random sizes were drawn: not every page at the test size
        assert len({min(hw) for hw in aux.image_sizes}) > 1
    for i, s in enumerate(samples):
        (oh, ow) = aux.image_sizes[i]
        np.testing.assert_array_equal(batch.boxes[i, :len(s.boxes)], TRANSFORM.rescale_boxes(
            s.boxes, s.image.shape[:2], (oh, ow)))


def test_image_transform_is_the_plain_resize():
    image = _image((300, 220), 3, seed=4)
    boxes = np.asarray([[10, 20, 100, 60], [0, 0, 219, 299]], np.int32)
    out, got_boxes, (oh, ow) = TRANSFORM(image, boxes, train=False)
    np.testing.assert_array_equal(out, _plain_norm(image, oh, ow, MEAN, STD))
    np.testing.assert_array_equal(got_boxes, TRANSFORM.rescale_boxes(boxes, (300, 220), (oh, ow)))


# ------------------------------------------------------------------ build


def _run(code: str, *args, env=None, timeout=120):
    env = dict(os.environ if env is None else env)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code, *map(str, args)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


BUILD_AND_CALL = """
import hashlib, sys, time
from pathlib import Path
import numpy as np
from vibertgrid_tpu_torch.data import native
native.BUILD_ROOT = Path(sys.argv[1])
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.01)
out = native.bilinear_resize(np.arange(48, dtype=np.float32).reshape(4, 4, 3), 2, 2)
path = native.build()
print(path, hashlib.sha256(path.read_bytes()).hexdigest(), float(out.sum()))
"""


def test_two_processes_building_at_once_load_one_library(tmp_path):
    build_root, go = tmp_path / "build", tmp_path / "go"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_CALL, str(build_root), str(go)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o[0].split() for o in outs]
    assert lines[0] == lines[1], lines
    path = Path(lines[0][0])
    assert path.parent.parent == build_root and path.name == native.LIB_NAME
    assert [p.name for p in path.parent.iterdir()] == [native.LIB_NAME]  # no partial file left
    want = native.bilinear_resize(np.arange(48, dtype=np.float32).reshape(4, 4, 3), 2, 2)
    assert float(lines[0][2]) == float(want.sum())
    assert lines[0][1] == hashlib.sha256(path.read_bytes()).hexdigest()


BROKEN_BUILD = """
import sys
from pathlib import Path
import numpy as np
from vibertgrid_tpu_torch.data import native, transform
from vibertgrid_tpu_torch.data.dataset import Collator, Sample
native.BUILD_ROOT = Path(sys.argv[1])
assert not hasattr(native, "set_enabled")
sample = Sample(image=np.ones((40, 30, 3), np.float32), tokens=np.ones(3, np.int32),
                seg_ids=np.zeros(3, np.int32), boxes=np.zeros((1, 4), np.int32),
                seg_classes=np.zeros(1, np.int32), texts=["a"])
tr = transform.ImageTransform([0.5] * 3, [0.5] * 3, [32], 32, 64)
for call in (lambda: native.bilinear_resize(sample.image, 20, 15),
             lambda: tr(sample.image, sample.boxes, train=False),
             lambda: Collator(tr)([sample], train=False),
             lambda: Collator(tr, emit_uint8=True)([sample], train=False)):
    try:
        call()
    except RuntimeError as e:
        print("RAISED", str(e).replace(chr(10), " | "))
    else:
        print("NO ERROR")
print("LIBRARIES", sorted(p.name for p in Path(sys.argv[1]).rglob("*.so")))
"""


def test_a_broken_compiler_raises_and_nothing_falls_back(tmp_path):
    """``g++`` and ``c++`` on ``PATH`` fail: every call that needs the
    library raises with the compiler's output, the module has no switch to
    the plain path, and no library is left behind."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("g++", "c++"):
        tool = bin_dir / name
        tool.write_text("#!/bin/sh\necho 'host_ops.cpp: the compiler is broken' >&2\nexit 1\n")
        tool.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    proc = _run(BROKEN_BUILD, tmp_path / "build", env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    raised = [line for line in lines if line.startswith("RAISED")]
    assert len(raised) == 4 and "NO ERROR" not in proc.stdout, proc.stdout
    assert all("the compiler is broken" in line for line in raised), raised
    assert lines[-1] == "LIBRARIES []"


def test_the_library_is_keyed_by_its_source_and_flags(monkeypatch):
    key = native._source_hash()
    assert native.build() == native.BUILD_ROOT / key / native.LIB_NAME
    assert native.BUILD_ROOT == ROOT / "build" / "vibertgrid_tpu_torch" / "host"
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DVG_OTHER"])
    assert native._source_hash() != key
    assert "-ffp-contract=off" in native.CXX_FLAGS and not any(
        f.startswith(("-march", "-ffast-math", "-Ofast")) for f in native.CXX_FLAGS)
