"""Evaluation CLI (port of ``vibertgrid_tpu/eval/cli.py``): one entry for all
datasets in place of the reference's ``eval_SROIE.py``, ``eval_EPHOIE.py``
and ``eval_FUNSD.py``::

    python -m vibertgrid_tpu_torch.eval.cli -c cfg.yaml -d sroie

Reads the YAML config and a checkpoint (``weights``: a checkpoint directory
of :mod:`vibertgrid_tpu_torch.train.checkpoint`; or ``reference_weights``: a
ViBERTgrid-PyTorch checkpoint file), runs the test split through the
dataset's entity join and filters, prints the method's P/R/F1 and writes the
per-sample JSON report to ``<result_dir>/<checkpoint>.json``
(``eval_SROIE.py:364-369``). Runs on the card unless the caller asks for the
CPU. Under torchrun's environment the processes form the ``(mesh_data,
mesh_model)`` mesh of the training driver: each data shard scores its share
``[d::data]`` of the test split (a model group of ``mesh_model`` processes
runs the tensor-parallel encoder on it once) and the metrics are gathered
from every data shard, as the training driver's validate does; rank 0 writes
the report.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import yaml

from vibertgrid_tpu_torch.data.dataset import (
    Collator,
    KIEDataset,
    bucketed_eval_loader,
    data_loader,
    prefetch_to_device,
)
from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.eval.harness import validate
from vibertgrid_tpu_torch.parallel.mesh import (
    init_distributed_mode,
    is_main_process,
    make_mesh,
    setup_rank0_print,
)
from vibertgrid_tpu_torch.train.checkpoint import restore_model
from vibertgrid_tpu_torch.train.driver import (
    build_all,
    build_tokenizer,
    load_pretrained_into_state,
    process_device,
)
from vibertgrid_tpu_torch.train.state import TrainState, make_eval_step


def evaluate(hyp: dict, dataset: str, spec=None, state: TrainState | None = None, *,
             device="cuda") -> dict:
    """Evaluate ``state`` (else the checkpoint that ``hyp`` names) on the test
    split under ``hyp["data_root"]``; returns :func:`validate`'s metrics."""
    init_distributed_mode(device=resolve_device(device))
    setup_rank0_print()
    layout = make_mesh(hyp.get("mesh_data"), hyp.get("mesh_model") or 1)
    dev = process_device(device)
    shard = (layout.data_index, layout.data)
    tokenizer = build_tokenizer(hyp)
    spec, cfg, model, transform, collator, tag_to_idx = build_all(
        hyp, dataset, tokenizer, spec, device=dev, layout=layout)
    test_ds = KIEDataset(os.path.join(hyp["data_root"], "test"), spec, tokenizer, train=False)

    if state is None:
        weights = hyp.get("weights", "")
        if not (weights or hyp.get("reference_weights", "")):
            raise ValueError("weights (or reference_weights for a ViBERTgrid-PyTorch "
                             "checkpoint) must be given (eval_SROIE.py:333-340)")
        if hyp.get("reference_weights"):
            load_pretrained_into_state(model, {"reference_weights": hyp["reference_weights"]})
        else:
            restore_model(weights, model)
        state = TrainState(model=model, optimizer=None)

    # eval_uint8_upload: the serving engine's uint8 wire (4x fewer
    # host-to-device bytes, <= 0.5/255 quantization); off by default, exact
    # fp32 numerics for published metrics
    if hyp.get("eval_uint8_upload", False):
        collator = Collator(transform, emit_uint8=True)
        eval_step = make_eval_step(image_stats=(transform.image_mean, transform.image_std))
    else:
        eval_step = make_eval_step()
    # batch size 1 is the reference's eval loop; a larger eval_batch_size
    # groups documents by collation signature
    ebs = hyp.get("eval_batch_size", 1)
    if ebs > 1:
        loader = bucketed_eval_loader(test_ds, collator, batch_size=ebs, shard=shard)
    else:
        loader = data_loader(test_ds, collator, batch_size=1, train=False, shard=shard)
    with contextlib.closing(prefetch_to_device(loader, dev)) as batches:
        results = validate(eval_step, state, batches, spec,
                           eval_mode=hyp.get("eval_mode", spec.default_eval_mode),
                           tag_to_idx=tag_to_idx,
                           seqeval_average=hyp.get("seqeval_average", spec.seqeval_average))

    print(f"precision[{results.get('precision', 0):.4f}] "
          f"recall[{results.get('recall', 0):.4f}] "
          f"F1[{results.get('primary_F1', 0):.4f}]")
    if not is_main_process():  # the same metrics; rank 0 writes them
        return results
    result_dir = hyp.get("result_dir", "result")
    os.makedirs(result_dir, exist_ok=True)
    tag = os.path.basename(os.path.normpath(hyp.get("weights") or "eval")) or "eval"
    out_path = os.path.join(result_dir, tag + ".json")
    with open(out_path, "w") as f:
        json.dump(results, f, ensure_ascii=False, default=str)
    print(f"report written to {out_path}")
    return results


def main(argv=None) -> dict:
    """The command line; returns :func:`evaluate`'s metrics."""
    parser = argparse.ArgumentParser(description="ViBERTgrid evaluation (PyTorch)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-d", "--dataset", default="sroie",
                        choices=["sroie", "ephoie", "funsd", "synthetic"])
    args = parser.parse_args(argv)
    with open(args.config) as f:
        hyp = yaml.safe_load(f)
    spec = None
    dataset = args.dataset
    if dataset == "synthetic":
        from vibertgrid_tpu_torch.data.synthetic import synthetic_spec

        hyp.setdefault("data_root", "./synthetic_data")
        hyp.setdefault("tokenizer_path", os.path.join(hyp["data_root"], "vocab.txt"))
        spec = synthetic_spec()
        dataset = "sroie"
    return evaluate(hyp, dataset, spec=spec)


if __name__ == "__main__":
    main()
