"""Serving: OCR client, inference engine, micro-batching and the HTTP app
(port of ``vibertgrid_tpu/serve``): a ``POST /core`` endpoint taking an image
file and returning ``{"result": {field: value}}``, backed by an external OCR
HTTP service and the model's forward on the card."""

from vibertgrid_tpu_torch.serve.app import create_app, serve  # noqa: F401
from vibertgrid_tpu_torch.serve.batching import BatchingEngine  # noqa: F401
from vibertgrid_tpu_torch.serve.engine import InferenceEngine  # noqa: F401
from vibertgrid_tpu_torch.serve.ocr_client import (  # noqa: F401
    ocr_extraction,
    parse_ocr_result,
)
