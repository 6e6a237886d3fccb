"""Sliding-window framing for long corpora (port of
``vibertgrid_tpu/ops/windows.py``).

Token streams ``[B, W·payload]`` fold into ``[B·W, payload+2]`` windows
framed ``[CLS] chunk [SEP]`` so one encoder call covers every window of
every document.
"""

from __future__ import annotations

import torch

PAYLOAD = 510  # tokens per window, excluding [CLS]/[SEP]


def frame_windows(
    tokens: torch.Tensor,
    token_mask: torch.Tensor,
    *,
    cls_id: int = 101,
    sep_id: int = 102,
    payload: int = PAYLOAD,
    seq_len: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold ``[B, W·payload]`` streams into framed ``[B·W, payload+2]`` ids
    and attention mask (int32).

    With ``seq_len`` (a 0-d tensor: the batch-max count of valid tokens)
    [SEP] sits right after each window's slice of the corpus, at
    ``1 + clip(seq_len − w·payload, 0, payload)``, as the reference frames
    it; the position is computed on the device, with no host sync. Without
    it [SEP] closes every window.
    """
    b, t = tokens.shape
    if t % payload:
        raise ValueError(f"token length {t} not a multiple of {payload}")
    w = t // payload
    dev = tokens.device
    chunks = tokens.reshape(b * w, payload).to(torch.int32)
    mchunks = token_mask.reshape(b * w, payload).to(torch.int32)
    ones = torch.ones((b * w, 1), dtype=torch.int32, device=dev)
    if seq_len is None:
        ids = torch.cat([ones * cls_id, chunks, ones * sep_id], dim=1)
        mask = torch.cat([ones, mchunks, ones], dim=1)
        return ids, mask
    window = torch.arange(w, dtype=torch.int32, device=dev).repeat(b)  # [B·W]
    widths = (seq_len.to(torch.int32) - window * payload).clamp(0, payload)
    zeros = torch.zeros_like(ones)
    ids = torch.cat([ones * cls_id, chunks, zeros], dim=1)
    mask = torch.cat([ones, mchunks, zeros], dim=1)
    pos = torch.arange(payload + 2, dtype=torch.int32, device=dev)[None, :]
    at_sep = pos == (1 + widths)[:, None]
    ids = torch.where(at_sep, sep_id, ids)
    mask = torch.where(at_sep, 1, mask)
    return ids, mask


def unframe_windows(
    window_embeddings: torch.Tensor, *, batch_size: int, payload: int = PAYLOAD
) -> torch.Tensor:
    """Drop the frame positions: ``[B·W, payload+2, D]`` → ``[B, W·payload, D]``."""
    bw, lw, d = window_embeddings.shape
    if lw != payload + 2:
        raise ValueError(f"window length {lw} is not payload + 2 = {payload + 2}")
    w = bw // batch_size
    return window_embeddings[:, 1 : 1 + payload, :].reshape(batch_size, w * payload, d)
