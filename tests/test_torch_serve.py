"""The port's serving path against the JAX package's, on the CPU.

One JAX ``InferenceEngine`` on the tiny config of ``tests/test_serve.py``
(module scope); its weights go through ``convert.from_flax`` into the port's
engine on ``device="cpu"``. The last layer of the field-type head is shrunk
first, as ``tests/test_torch_model.py`` does, so that the class scores of the
random network are O(1) and an argmax is not decided by saturation. Then:

- ``predict``, an empty OCR request, ``predict_many`` of three documents
  padded to four (one of more than 510 tokens: two windows),
  ``predict_stream`` and ``BatchingEngine`` give the JAX engine's fields,
  the class scores within 1e-4 (fp32 on both sides, summed in other orders);
- the uint8 wire against the fp32 wire: probabilities within 0.05, fields
  equal where every top-2 margin exceeds twice the measured change
  (``tests/test_serve.py``'s rule);
- ``parse_ocr_result`` in all four modes and ``_extract_multipart``;
- an HTTP round trip through the port's ``serve()`` with a stub OCR service
  on localhost;
- the reference-checkpoint loader: a seeded state dict with the reference's
  names through the JAX ``load_reference_checkpoint`` and the port's, for the
  three classifier modes: ``from_flax`` of the first equals the second, and
  every parameter and buffer of the port's model is overwritten.

No JAX train step is compiled; the JAX forwards compile for four shapes.
"""

import io
import json
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from tests.torch_checkpoints import checkpoints_dropped  # noqa: F401
from vibertgrid_tpu.data.synthetic import (
    CLASS_WORDS,
    make_synthetic_root,
    make_test_tokenizer,
    synthetic_spec,
)
from vibertgrid_tpu.serve.app import _extract_multipart as jax_extract_multipart
from vibertgrid_tpu.serve.engine import InferenceEngine as JaxEngine
from vibertgrid_tpu.serve.ocr_client import parse_ocr_result as jax_parse
from vibertgrid_tpu_torch.convert import from_flax
from vibertgrid_tpu_torch.data.synthetic import synthetic_spec as port_spec
from vibertgrid_tpu_torch.serve.app import _extract_multipart, serve
from vibertgrid_tpu_torch.serve.batching import BatchingEngine
from vibertgrid_tpu_torch.serve.engine import InferenceEngine
from vibertgrid_tpu_torch.serve.ocr_client import parse_ocr_result

# each test's checkpoints go once it has read them back
pytestmark = pytest.mark.usefixtures("checkpoints_dropped")

HYP = {
    "num_classes": 5,
    "bert_version": "tiny-bert-test",
    "backbone": "resnet_18_fpn",
    "classifier_mode": "simp",
    "layer_mode": "single",
    "image_min_size": [256],
    "test_image_min_size": 256,
    "image_max_size": 400,
    "image_mean": [0.9] * 3,
    "image_std": [0.15] * 3,
    "tag_mode": "B",
}
SCORE_ATOL = 1e-4
WORDS = [w for ws in CLASS_WORDS.values() for w in ws]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """``(jax_engine, port_engine, tokenizer)`` on one set of weights."""
    root = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_root(root, n_train=1, n_test=1)
    tokenizer = make_test_tokenizer(root)
    jeng = JaxEngine(HYP, tokenizer=tokenizer, spec=synthetic_spec())
    params = jax.tree_util.tree_map(np.asarray, jeng.state.params)
    out = params["field_type_head"]["category_net"]["out"]
    out["kernel"] = out["kernel"] * 0.01
    jeng.state = jeng.state.replace(params=params)
    state = from_flax({"params": params, "batch_stats": jeng.state.batch_stats})
    peng = InferenceEngine(HYP, tokenizer=tokenizer, spec=port_spec(), state=state,
                           device="cpu")
    return jeng, peng, tokenizer


def _request(seed: int, n_seg: int, words: tuple = (1, 3), hw=(200, 160)):
    """A page with ``n_seg`` OCR segments of synthetic words, boxes inside it."""
    rng = np.random.default_rng(seed)
    h, w = hw
    image = np.full((h, w, 3), 0.95, np.float32)
    texts, boxes = [], []
    for _ in range(n_seg):
        texts.append(" ".join(rng.choice(WORDS, int(rng.integers(*words)))))
        x0, y0 = int(rng.integers(0, w - 40)), int(rng.integers(0, h - 16))
        box = [x0, y0, x0 + int(rng.integers(10, 40)), y0 + int(rng.integers(6, 16))]
        image[box[1]:box[3], box[0]:box[2]] = rng.uniform(0.1, 0.8)
        boxes.append(box)
    return image, texts, boxes


REQUESTS = [_request(1, 6), _request(2, 3), _request(3, 12)]
LONG = _request(4, 30, words=(18, 24))  # > 510 tokens: two windows


def _scores(engine, requests, to_numpy):
    """The padded class scores of one dispatched micro-batch, and its aux."""
    pred, aux, _, keep = engine._dispatch(requests)
    return to_numpy(pred), aux, keep


def _assert_same(jeng, peng, requests):
    want, aux, keep = _scores(jeng, requests, lambda p: np.asarray(p, np.float32))
    got, port_aux, port_keep = _scores(peng, requests, lambda p: p.float().numpy())
    assert keep == port_keep and aux.n_segments == port_aux.n_segments
    assert got.shape == want.shape
    for row, n in enumerate(aux.n_segments):
        np.testing.assert_allclose(got[row, :n], want[row, :n], rtol=0, atol=SCORE_ATOL)
    return got.shape


def test_predict_matches_jax(engines):
    jeng, peng, _ = engines
    for req in REQUESTS:
        assert peng.predict(*req) == jeng.predict(*req)
        assert _assert_same(jeng, peng, [req])[0] == 1
    fields = [peng.predict(*req) for req in REQUESTS]
    assert any(v for f in fields for v in f.values()), "every field empty: nothing compared"


def test_empty_ocr_matches_jax(engines):
    jeng, peng, _ = engines
    image = np.full((200, 160, 3), 0.95, np.float32)
    for texts, boxes in (([], np.zeros((0, 4), np.int32)), (["  ", ""], [[1, 1, 5, 5]] * 2)):
        got = peng.predict(image, texts, boxes)
        assert got == jeng.predict(image, texts, boxes)
        assert got == {c: "" for c in peng.spec.class_list[1:]}


def test_predict_many_two_windows_matches_jax(engines):
    """Three documents padded to four, one of them two windows long."""
    jeng, peng, tokenizer = engines
    n_tokens = sum(len(tokenizer.tokenize(t)) for t in LONG[1])
    assert 510 < n_tokens <= 1020
    requests = [REQUESTS[0], LONG, REQUESTS[1]]
    assert peng.predict_many(requests) == jeng.predict_many(requests)
    assert _assert_same(jeng, peng, requests)[0] == 4
    batch, _ = peng.collator([peng._make_sample(*LONG)], train=False)
    assert batch.tokens.shape[1] == 1020


def test_predict_stream_matches_jax(engines):
    jeng, peng, _ = engines
    empty = (np.full((200, 160, 3), 0.95, np.float32), [], np.zeros((0, 4), np.int32))
    requests = [REQUESTS[0], REQUESTS[1], empty, REQUESTS[2], REQUESTS[0]]
    got = peng.predict_stream(requests, batch_size=2, depth=2)
    assert got == jeng.predict_stream(requests, batch_size=2, depth=2)
    serial = []
    for i in range(0, len(requests), 2):
        serial.extend(peng.predict_many(requests[i:i + 2]))
    assert got == serial


def test_batching_engine_matches_jax(engines):
    """Concurrent callers through the port's micro-batching worker get the
    JAX engine's per-request answers; the worker's forward runs with autograd
    off (the engine enters inference mode on that thread)."""
    jeng, peng, _ = engines
    requests = [_request(10 + i, 2 + i) for i in range(6)]
    want = [jeng.predict(*r) for r in requests]
    modes = []
    hook = peng.model.bert_model.register_forward_hook(
        lambda *_: modes.append((torch.is_grad_enabled(), torch.is_inference_mode_enabled())))
    be = BatchingEngine(peng, max_batch=4, max_wait_ms=20)
    try:
        results = [None] * len(requests)

        def call(i):
            results[i] = be.predict(*requests[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        be.close()
        hook.remove()
    assert results == want
    assert modes and all(m == (False, True) for m in modes)


def test_uint8_wire_matches_fp32_wire(engines):
    _, peng, tokenizer = engines
    f32 = InferenceEngine(dict(HYP, serve_uint8_upload=False), tokenizer=tokenizer,
                          spec=port_spec(), state=peng.model.state_dict(), device="cpu")
    rng = np.random.default_rng(3)
    image = rng.random((220, 170, 3)).astype(np.float32)
    texts = ["company corp", "total", "12.50", "main street"]
    boxes = [[10, 10, 90, 24], [10, 40, 50, 54], [60, 40, 100, 54], [10, 80, 120, 94]]

    def probs(engine):
        pred, aux, _, _ = engine._dispatch([(image, texts, boxes)])
        logits = pred.float().numpy()[0, : aux.n_segments[0]]
        z = np.exp(logits - logits.max(-1, keepdims=True))
        return z / z.sum(-1, keepdims=True)

    p_u8, p_f32 = probs(peng), probs(f32)
    delta = float(np.abs(p_u8 - p_f32).max())
    assert delta < 0.05, f"uint8 wire perturbs probabilities by {delta}"
    top2 = np.sort(p_f32, axis=-1)[:, -2:]
    if float((top2[:, 1] - top2[:, 0]).min()) > 2 * delta:
        assert peng.predict(image, texts, boxes) == f32.predict(image, texts, boxes)


OCR_API = {
    "code": 200,
    "result": {"lines": [
        {"text": "ab cd", "position": [0, 0, 50, 0, 50, 12, 0, 12],
         "char_positions": [[i * 10, 0, i * 10 + 9, 0, i * 10 + 9, 12, i * 10, 12]
                            for i in range(5)]},
        {"text": "total 12", "position": [5, 30, 90, 30, 90, 44, 5, 44],
         "char_positions": [[5 + i * 10, 30, 14 + i * 10, 30, 14 + i * 10, 44, 5 + i * 10, 44]
                            for i in range(8)]},
    ]},
}


@pytest.mark.parametrize("mode", ["eng_line", "eng_word", "chn_char", "chn_ltp"])
def test_parse_ocr_result_matches_jax(mode):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # chn_ltp without ltp falls back, with a warning
        got, want = parse_ocr_result(OCR_API, mode), jax_parse(OCR_API, mode)
        assert got == want and got[0] == 200 and got[1]
        assert parse_ocr_result({"code": -1}, mode) == jax_parse({"code": -1}, mode) == (-1, [], [])


def _multipart(content: bytes, boundary: str = "xyz") -> bytes:
    return (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.png\"\r\nContent-Type: image/png\r\n\r\n").encode() + content + \
        f"\r\n--{boundary}--\r\n".encode()


def test_extract_multipart_matches_jax():
    for content in (b"IMAGE_BYTES_HERE", b"\x89PNG\r\n\x1a\n\x00\x01"):
        body = _multipart(content)
        for ctype in ('multipart/form-data; boundary="xyz"', "multipart/form-data; boundary=xyz",
                      "application/octet-stream"):
            got = _extract_multipart(body, ctype)
            assert got == jax_extract_multipart(body, ctype)
        assert _extract_multipart(body, 'multipart/form-data; boundary="xyz"') == content


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_http_round_trip_with_stub_ocr(engines):
    """``POST /core`` with a PNG through the port's stdlib server and the
    engine's OCR client against a stub OCR service: the answers are the
    engine's ``predict`` on the decoded image and the OCR segments, and the
    JAX engine's."""
    from PIL import Image

    jeng, peng, _ = engines

    class Ocr(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            payload = json.dumps(OCR_API).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):
            pass

    ocr = ThreadingHTTPServer(("127.0.0.1", 0), Ocr)
    threading.Thread(target=ocr.serve_forever, daemon=True).start()
    peng.ocr_url = f"http://127.0.0.1:{ocr.server_address[1]}/ocr"
    port = _free_port()
    threading.Thread(target=serve, args=(peng,), kwargs={"port": port}, daemon=True).start()
    try:
        _, texts, boxes = parse_ocr_result(OCR_API, peng.parse_mode)
        for seed in (0, 1):
            rgb = (np.random.default_rng(seed).random((120, 100, 3)) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, format="PNG")
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/core", data=_multipart(buf.getvalue()),
                headers={"Content-Type": 'multipart/form-data; boundary="xyz"'})
            deadline = time.time() + 30
            while True:
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        out = json.loads(r.read())
                    break
                except OSError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.2)
            image = rgb.astype(np.float32) / 255.0
            want = peng.predict(image, texts, boxes)
            assert out == {"result": want}
            assert want == jeng.predict(image, texts, boxes)
    finally:
        ocr.shutdown()
        peng.ocr_url = HYP.get("ocr_url", "")


# ---- the reference-checkpoint loader ----

_BLOCK = {"conv1": "conv_1", "bn1": "bn_1", "conv2": "conv_2", "bn2": "bn_2",
          "shortcut_conv": "conv_shortcut.0", "shortcut_bn": "conv_shortcut.1"}
_ROI = {"conv1": "conv_1", "bn1": "bn_1", "conv2": "conv_2", "bn2": "bn_2",
        "linear": "linear"}
_SEG = {"conv1": "conv_1", "bn1": "bn_1", "conv2": "conv_2", "bn2": "bn_2",
        "mask_proj": "conv_3_1", "class_proj": "conv_3_2"}


def _reference_name(name: str, mode: str, encoder: str) -> str | None:
    """The reference module path of one of the port's modules (``name``
    without its leaf), or None where the port's tensor is a stack of the
    reference's (handled by the caller)."""
    parts = name.split(".")
    top = parts[0]
    if top == "backbone":
        sub = parts[1]
        if sub == "stem_conv":
            return "backbone.conv_1.0"
        if sub == "stem_bn":
            return "backbone.conv_1.1"
        if sub == "early_fusion":
            return "backbone.conv_3_x.early_fusion"
        if sub in ("conv6",):
            return "backbone.conv_6_x"
        if sub[:4] in ("skip", "merg"):
            return f"backbone.{sub[:-1]}_{sub[-1]}"
        if sub == "fuse":
            return "backbone.fuse"
        stage, block = int(sub[5]), int(sub.split("block")[1])
        if stage == 3:
            where = "conv_3_x.block_1" if block == 0 else f"conv_3_x.layers.{block - 1}"
        else:
            where = f"conv_{stage}_x.{block}"
        return f"backbone.{where}.{_BLOCK[parts[2]]}"
    if top == "late_fusion":
        if parts[1] == "fuse":
            return "late_fusion_net.fuse_embedding_net.linear"
        return f"late_fusion_net.ROI_embedding_net.{_ROI[parts[2]]}"
    if top == "semantic_segmentation_head":
        if parts[1] == "binary_bank":
            return None
        return f"semantic_segmentation_head.{encoder}.{_SEG[parts[2]]}"
    fh = "field_type_classification_head"
    if parts == ["field_type_head"]:  # the CRF's transitions
        return f"{fh}.crf_layer"
    net = {"pos_neg_net": "pos_neg_classification_net",
           "category_net": "category_classification_net"}[parts[1]]
    if mode == "simp":
        return f"{fh}.{net}.{ {'hidden': 'linear_1', 'out': 'linear_2'}[parts[2]] }"
    if mode == "crf":
        return f"{fh}.{net}.linear"
    return None if net.startswith("category") else f"{fh}.{net}.layer.linear"


def _reference_state_dict(model, mode: str, seed: int, encoder: str) -> dict:
    """Seeded tensors under the reference's names and layouts for every
    parameter and buffer of ``model`` (a port model of ``mode``), with the
    extras a real checkpoint carries (BatchNorm counters, the pooler, the
    generator's alias of the encoder) and, for the full head, the per-class
    layers the port stacks."""
    from vibertgrid_tpu_torch.models.bert import _HF_EMBEDDINGS, _HF_LAYER

    g = torch.Generator().manual_seed(seed)
    rand = lambda shape: torch.randn(shape, generator=g)
    sd = {}
    enc = model.bert_model
    for theirs, ours in _HF_EMBEDDINGS.items():
        sd[f"bert_model.{theirs}"] = rand(enc.get_parameter(ours).shape)
    for i in range(enc.config.num_layers):
        for theirs, ours in _HF_LAYER.items():
            for leaf in ("weight", "bias"):
                shape = enc.get_parameter(f"layer.{i}.{ours}.{leaf}").shape
                sd[f"bert_model.encoder.layer.{i}.{theirs}.{leaf}"] = rand(shape)
    sd["bert_model.pooler.dense.weight"] = rand((8, 8))
    sd["BERTgrid_generator.model.embeddings.word_embeddings.weight"] = rand((4, 4))
    for name, tensor in model.state_dict().items():
        if name.startswith("bert_model."):
            continue
        module, leaf = name.rsplit(".", 1)
        ref = _reference_name(module, mode, encoder)
        if ref is None:  # stacked in the port: one row (output channel) per class
            if module.endswith("binary_bank"):
                rows = [f"semantic_segmentation_head.ss_binary_classifier_{i}.conv1"
                        for i in range(tensor.shape[0])]
            else:
                rows = [f"field_type_classification_head.category_classification_net_{i}"
                        ".layer.linear" for i in range(tensor.shape[0])]
            for row in rows:
                sd[f"{row}.{leaf}"] = rand((1, *tensor.shape[1:]))
            continue
        if leaf == "running_var":
            sd[f"{ref}.{leaf}"] = rand(tensor.shape).abs() + 0.5
            sd[f"{ref}.num_batches_tracked"] = torch.tensor(7)
        else:
            sd[f"{ref}.{leaf}"] = rand(tensor.shape)
    return sd


@pytest.mark.parametrize("mode", ["simp", "full", "crf"])
def test_reference_checkpoint_loader_matches_jax(mode, tmp_path):
    from vibertgrid_tpu.models.convert_reference import (
        load_reference_checkpoint as jax_load,
    )
    from vibertgrid_tpu.models.vibertgrid import ModelConfig as JaxConfig
    from vibertgrid_tpu.models.vibertgrid import ViBERTgridNet as JaxNet
    from vibertgrid_tpu_torch.models import ModelConfig, ViBERTgridNet
    from vibertgrid_tpu_torch.models.convert_reference import load_reference_checkpoint
    from vibertgrid_tpu_torch.train.driver import load_pretrained_into_state
    from __graft_entry__ import _make_batch

    kw = dict(num_classes=5, bert_version="tiny-bert-test", backbone="resnet_18_fpn",
              classifier_mode=mode)
    model = ViBERTgridNet(ModelConfig(**kw), device="cpu")
    encoder = "ss_encoder" if mode == "full" else "semantic_segmentation_encoder"
    sd = _reference_state_dict(model, mode, seed=11, encoder=encoder)
    if mode == "crf":  # a DDP checkpoint
        sd = {f"module.{k}": v for k, v in sd.items()}
    # the JAX variables' structure and shapes (their values are all replaced)
    shapes = jax.eval_shape(
        lambda: JaxNet(JaxConfig(**kw)).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            _make_batch(b=1, h=64, w=64, t=510, s=4, vocab=512), train=False,
            compute_loss=True, key=jax.random.PRNGKey(2)))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = from_flax(jax_load(variables, {k: v.numpy() for k, v in sd.items()}))

    with torch.no_grad():
        for tensor in model.state_dict().values():
            tensor.fill_(float("nan"))
    if mode == "simp":  # through the driver's loader, from a file
        path = str(tmp_path / "reference.pt")
        torch.save({"model": sd}, path)
        load_pretrained_into_state(model, {"reference_weights": path})
    else:
        load_reference_checkpoint(model, sd)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, tensor in got.items():
        assert not torch.isnan(tensor).any(), f"{name} was not overwritten"
        torch.testing.assert_close(tensor, want[name], rtol=0, atol=0, msg=name)


def test_engine_loads_weights_and_reference_weights(engines, tmp_path):
    """``weights`` restores only the model of a port checkpoint directory
    (strict); ``reference_weights`` loads a ViBERTgrid-PyTorch file."""
    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN_HYP
    from vibertgrid_tpu_torch.models.convert_reference import load_reference_checkpoint
    from vibertgrid_tpu_torch.train.checkpoint import CheckpointManager
    from vibertgrid_tpu_torch.train.optim import make_optimizer
    from vibertgrid_tpu_torch.train.state import create_train_state

    _, peng, tokenizer = engines
    model = peng.model
    optimizer = make_optimizer(FLAGSHIP_TRAIN_HYP, num_epochs=1, niter_per_ep=1,
                               named_parameters=model.named_parameters())
    path = CheckpointManager(str(tmp_path / "ckpt")).save(create_train_state(model, optimizer))
    restored = InferenceEngine(dict(HYP, weights=path), tokenizer=tokenizer, spec=port_spec(),
                               device="cpu")
    for name, tensor in model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[name], tensor), name
    request = REQUESTS[0]
    assert restored.predict(*request) == peng.predict(*request)

    sd = _reference_state_dict(model, "simp", seed=3, encoder="semantic_segmentation_encoder")
    torch.save(sd, tmp_path / "reference.pth")
    served = InferenceEngine(dict(HYP, reference_weights=str(tmp_path / "reference.pth")),
                             tokenizer=tokenizer, spec=port_spec(), device="cpu")
    load_reference_checkpoint(restored.model, sd)
    for name, tensor in restored.model.state_dict().items():
        assert torch.equal(served.model.state_dict()[name], tensor), name


@pytest.mark.cuda
def test_roi_align_whole_pixel_bins_card_vs_host():
    """RoIAlign's bin size on the card, where dividing by a Python scalar is
    a product with its reciprocal: a whole-pixel bin must keep its sample
    count (pinned by ``chip_smoke.roi_align_card_vs_host``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: python -m pytest --noconftest -m cuda)")
    import chip_smoke

    chip_smoke.roi_align_card_vs_host(torch.device("cuda"))

