"""HTTP serving app: ``POST /core`` with an image file →
``{"result": {field: value}}``.

Port of ``vibertgrid_tpu/serve/app.py`` (itself the reference's
``deployment/main_SROIE.py:16-37`` and the identical ``main_EPHOIE.py``).
Uses Flask when installed, otherwise a stdlib ``http.server`` implementation
with the same route and JSON contract.

    python -m vibertgrid_tpu_torch.serve.app -c vibertgrid_tpu_torch/configs/deployment_sroie.yaml
"""

from __future__ import annotations

import argparse
import io
import json
import re


def create_app(engine):
    """Flask app when available, else None (use :func:`serve`)."""
    try:
        from flask import Flask, jsonify, request
    except ImportError:
        return None

    app = Flask("vibertgrid_tpu_torch")

    @app.route("/core", methods=["POST"])
    def kie_system():  # noqa: ANN202
        file = request.files["file"]
        result = engine.predict_bytes(file.read())
        return jsonify({"result": result})

    return app


def _extract_multipart(body: bytes, content_type: str) -> bytes:
    """Minimal multipart/form-data file extraction (stdlib path)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return body  # raw bytes
    boundary = m.group(1).encode()
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" not in part:
            continue
        header, _, content = part.partition(b"\r\n\r\n")
        if b"filename=" in header:
            return content.rstrip(b"\r\n")
    return body


def serve(engine, host: str = "127.0.0.1", port: int = 11451):
    """Run the HTTP service (Flask if present, stdlib otherwise)."""
    app = create_app(engine)
    if app is not None:
        app.run(host=host, port=port, debug=False)
        return

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            if self.path != "/core":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            image_bytes = _extract_multipart(
                body, self.headers.get("Content-Type", "")
            )
            result = engine.predict_bytes(image_bytes)
            payload = json.dumps({"result": result}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):  # quiet
            pass

    print(f"serving on http://{host}:{port}/core")
    # Threaded so concurrent requests can reach the micro-batching engine
    # (a sequential HTTPServer could never form a batch).
    ThreadingHTTPServer((host, port), Handler).serve_forever()


def main(argv=None):
    import yaml

    from vibertgrid_tpu_torch.serve.engine import InferenceEngine

    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-d", "--dataset", default="sroie")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=11451)
    args = parser.parse_args(argv)
    with open(args.config) as f:
        hyp = yaml.safe_load(f)
    engine = InferenceEngine(hyp, dataset=args.dataset)
    if hyp.get("batching", False):
        # micro-batch concurrent requests into shared device calls
        # (serve/batching.py); both fronts are threaded (Flask's werkzeug
        # and the stdlib ThreadingHTTPServer fallback).
        from vibertgrid_tpu_torch.serve.batching import BatchingEngine

        engine = BatchingEngine(
            engine,
            max_batch=hyp.get("batch_max", 8),
            max_wait_ms=hyp.get("batch_wait_ms", 5.0),
        )
    serve(engine, args.host, args.port)


if __name__ == "__main__":
    main()
