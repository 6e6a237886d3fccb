"""Checkpoints with the reference's top-F1 retention policy (port of
``vibertgrid_tpu/train/checkpoint.py``).

A checkpoint is a directory holding ``state.pt`` and ``meta.json``.
``state.pt`` is one ``torch.save`` of plain containers of tensors and ints,
read back with ``torch.load(weights_only=True)``: the model's state dict
(parameters and BatchNorm statistics), the dual optimizer's momentum and
moment slots by parameter name in their storage dtype, its schedule arrays
and update count, and the step. Metadata (epoch, F1, anything the caller
adds) lives in the JSON file beside it.

Restoring copies into an existing :class:`TrainState` in place, as the
train step updates it in place; the state's model and optimizer fix the
shapes, dtypes and device.

With more than one process every rank calls the save: a ZeRO-1 optimizer
gathers its state slices first, so that a checkpoint holds the whole state
and resumes under any number of processes; then rank 0 alone writes and the
others wait for it at a barrier (the ranks share one file system, where the
JAX package's per-host save writes from every host).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from vibertgrid_tpu_torch.parallel.mesh import get_world_size, is_main_process
from vibertgrid_tpu_torch.train.state import TrainState

_STATE_FILE = "state.pt"
_META_FILE = "meta.json"


def _payload(state: TrainState) -> dict:
    named = dict(state.model.named_parameters())
    optimizer = state.optimizer
    slots = optimizer.gathered_state()  # whole tensors, also under ZeRO-1
    return {
        "model": state.model.state_dict(),
        "optimizer": {
            "count": optimizer.count,
            "slots": {name: slots[p] for name, p in named.items() if p in slots},
            "schedules": {k: torch.from_numpy(np.asarray(v, dtype=np.float64))
                          for k, v in optimizer.schedules.items()},
        },
        "step": state.step,
    }


class CheckpointManager:
    def __init__(self, directory: str, top_f1_thresh: float = 0.0) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.top_f1_thresh = top_f1_thresh

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def _write(self, path: str, state: TrainState, meta: dict) -> str:
        payload = _payload(state)  # on every rank: it may gather ZeRO-1 slices
        if is_main_process():
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, _STATE_FILE + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(path, _STATE_FILE))  # never a half-written state.pt
            with open(os.path.join(path, _META_FILE), "w") as f:
                json.dump(meta, f)
        if get_world_size() > 1:
            dist.barrier()
        return path

    def maybe_save(self, state: TrainState, epoch: int, f1: float,
                   extra: dict | None = None) -> str | None:
        """The reference's policy: save on a new best F1 or every 10 epochs."""
        if not (f1 > self.top_f1_thresh or epoch % 10 == 0):
            return None
        if f1 > self.top_f1_thresh:
            self.top_f1_thresh = f1
        tag = f"epoch{epoch}_F1_{f1:.4f}"
        return self._write(self._path(tag), state, {"epoch": epoch, "f1": f1, **(extra or {})})

    def save(self, state: TrainState, tag: str = "latest", **meta) -> str:
        return self._write(self._path(tag), state, dict(meta))

    def restore(self, tag_or_path: str, state: TrainState) -> tuple[TrainState, dict]:
        path = tag_or_path if os.path.isabs(tag_or_path) else self._path(tag_or_path)
        return restore_checkpoint(path, state)

    def latest_best(self) -> str | None:
        """The tag of the saved epoch with the highest F1, or None."""
        entries = [e for e in os.listdir(self.directory) if e.startswith("epoch")]
        if not entries:
            return None
        return max(entries, key=lambda e: float(e.rsplit("_", 1)[-1]))


def _read(path: str, model: torch.nn.Module) -> tuple[dict, dict]:
    """``(payload, meta)`` of the checkpoint directory ``path``, the tensors
    on ``model``'s device, and its model state loaded into ``model``."""
    path = os.path.abspath(path)
    meta: dict = {"epoch": 0, "f1": 0.0}
    meta_path = os.path.join(path, _META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta.update(json.load(f))
    device = next(model.parameters()).device
    payload = torch.load(os.path.join(path, _STATE_FILE), map_location=device,
                         weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return payload, meta


def restore_model(path: str, model: torch.nn.Module) -> dict:
    """Restore only the model (parameters and BatchNorm statistics) of the
    checkpoint directory ``path`` into ``model`` in place, for a caller with
    no optimizer (the serving engine); returns the metadata."""
    return _read(path, model)[1]


def restore_checkpoint(path: str, state: TrainState) -> tuple[TrainState, dict]:
    """Restore the checkpoint directory ``path`` into ``state`` in place;
    returns ``(state, meta)``. The entry point for a caller that holds a whole
    checkpoint path and no checkpoint root."""
    payload, meta = _read(path, state.model)
    saved = payload["optimizer"]
    state.optimizer.load_named_state(state.model.named_parameters(), saved["slots"],
                                     saved["count"])
    state.optimizer.schedules = {k: v.cpu().numpy() for k, v in saved["schedules"].items()}
    state.step = payload["step"]
    return state, meta
