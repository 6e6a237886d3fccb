"""External OCR service client + result parsing.

A copy of ``vibertgrid_tpu/serve/ocr_client.py``, itself a port of the
reference's ``deployment/inference_preporcessing.py:13-136``: the
OCR API receives raw image bytes and returns
``{"code": int, "result": {"lines": [{"text", "position", "char_positions"}]}}``.
Four parse modes mirror the reference:

- ``eng_line``: one segment per line (line box corners 0,1 / 2,5).
- ``eng_word``: split line text on spaces, box from first/last char.
- ``chn_char``: one segment per character.
- ``chn_ltp``: LTP Chinese word segmentation over the line text (the ``ltp``
  package is optional here; absent, ``chn_ltp`` degrades to ``chn_char`` with
  a warning — the reference hard-imports it).
"""

from __future__ import annotations

import warnings
from typing import Dict


def _parse_eng_line(res: Dict):
    out_text, out_coor = [], []
    for line in res["result"]["lines"]:
        pos = line["position"]
        out_text.append(line["text"])
        out_coor.append([pos[0], pos[1], pos[2], pos[5]])
    return out_text, out_coor


def _parse_eng_word(res: Dict):
    out_text, out_coor = [], []
    for line in res["result"]["lines"]:
        text = line["text"]
        chars = line["char_positions"]
        start = 0
        for word in text.split():
            end = start + len(word)
            first, last = chars[start], chars[min(end, len(chars) - 1)]
            out_text.append(word)
            out_coor.append([first[0], first[1], last[2], last[5]])
            start = end + 1
    return out_text, out_coor


def _parse_chn_char(res: Dict):
    out_text, out_coor = [], []
    for line in res["result"]["lines"]:
        for ch, pos in zip(line["text"], line["char_positions"]):
            out_text.append(ch)
            out_coor.append([pos[0], pos[1], pos[4], pos[5]])
    return out_text, out_coor


def _parse_chn_ltp(res: Dict):
    try:
        from ltp import LTP  # optional dependency
    except ImportError:
        warnings.warn("ltp not installed; chn_ltp falls back to chn_char")
        return _parse_chn_char(res)
    ltp = LTP()
    out_text, out_coor = [], []
    for line in res["result"]["lines"]:
        text = line["text"]
        chars = line["char_positions"]
        words = ltp.seg([text])[0][0]
        start = 0
        for seg in words:
            end = start + len(seg)
            coors = chars[start:end]
            out_text.append(seg)
            out_coor.append(
                [
                    min(c[0] for c in coors),
                    min(c[1] for c in coors),
                    max(c[2] for c in coors),
                    max(c[3] for c in coors),
                ]
            )
            start = end
    return out_text, out_coor


_PARSERS = {
    "eng_line": _parse_eng_line,
    "eng_word": _parse_eng_word,
    "chn_char": _parse_chn_char,
    "chn_ltp": _parse_chn_ltp,
}


def parse_ocr_result(api_result: Dict, parse_mode: str):
    """→ (status_code, texts, boxes)."""
    code = api_result.get("code", -1)
    if code != 200:
        return code, [], []
    texts, coors = _PARSERS[parse_mode](api_result)
    return code, texts, coors


def ocr_extraction(image_bytes: bytes, ocr_url: str, parse_mode: str):
    """POST the image to the OCR service and parse
    (reference :116-136; requests → urllib fallback)."""
    api_result: Dict = {"code": -1}
    try:
        try:
            import requests

            res = requests.post(
                ocr_url,
                data=image_bytes,
                headers={
                    "Content-Type": "application/octet-stream",
                    "accept": "application/json",
                },
            )
            if res.status_code == 200:
                api_result = res.json()
        except ImportError:
            import json as _json
            import urllib.request

            req = urllib.request.Request(
                ocr_url,
                data=image_bytes,
                headers={"Content-Type": "application/octet-stream"},
            )
            with urllib.request.urlopen(req) as r:
                if r.status == 200:
                    api_result = _json.loads(r.read())
    except Exception as e:  # noqa: BLE001 — mirror reference's catch-all
        print(f"[ERROR] ocr engine failed, {e}")
    return parse_ocr_result(api_result, parse_mode)
