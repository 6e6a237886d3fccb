"""The training driver (port of ``vibertgrid_tpu/train/driver.py``): one
parameterised driver in place of the reference's three train CLIs
(``train_SROIE.py``, ``train_EPHOIE.py``, ``train_FUNSD.py``)::

    python -m vibertgrid_tpu_torch.train.driver -c cfg.yaml -d sroie

The YAML schema is the reference's (``example_config.yaml``): optimizer
blocks, OHEM counts, classifier / eval / tag modes, backbone and BERT
versions, dataset statistics and sizes, save directories, resume weights;
besides, ``tokenizer_path`` (a local tokenizer; nothing is downloaded),
``seed`` (the train steps' dropout and loss seeds), ``eval_batch_size``,
``eval_uint8_upload``, ``iter_msg`` / ``log_interval`` and
``val_epoch_interval``.

The flow is ``train_SROIE.py:51-423``'s: seed, tokenizer, datasets, model,
dual optimizer and schedules, local pretrained weights, resume, an initial
validate, then the epoch loop (train an epoch, validate, keep checkpoints by
F1). It trains on the card unless the caller asks for the CPU.

Under torchrun (``WORLD_SIZE`` and the rendezvous in the environment) it
trains data-parallel, one process per card (``LOCAL_RANK`` modulo the
cards; NCCL on the card, gloo when the caller asks for the CPU): each
process loads its share ``[rank::world]`` of every epoch and of the test
split, ``batch_size`` documents a step (the global batch is ``batch_size ·
world``), the train step computes the global batch's loss and gradients
(``parallel/``), ``zero1: true`` splits the optimizer state over the
processes, and validate gathers the metrics from every process. ``mesh_model > 1`` (tensor parallelism) raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch
import yaml

from vibertgrid_tpu_torch.data.dataset import (
    Collator,
    KIEDataset,
    bucketed_eval_loader,
    compute_mean_std,
    data_loader,
    prefetch_to_device,
)
from vibertgrid_tpu_torch.data.spec import get_spec
from vibertgrid_tpu_torch.data.transform import ImageTransform
from vibertgrid_tpu_torch.device import resolve_device
from vibertgrid_tpu_torch.eval.harness import validate
from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig, ViBERTgridNet
from vibertgrid_tpu_torch.parallel.mesh import (
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_main_process,
    local_device_index,
    make_mesh,
    replicate,
    setup_rank0_print,
)
from vibertgrid_tpu_torch.parallel.sharding import shard_optimizer_state
from vibertgrid_tpu_torch.train.checkpoint import CheckpointManager
from vibertgrid_tpu_torch.train.optim import make_optimizer
from vibertgrid_tpu_torch.train.seeds import step_seeds
from vibertgrid_tpu_torch.train.state import create_train_state, make_eval_step, make_train_step
from vibertgrid_tpu_torch.utils.logging import MetricsLogger, TerminalLogger, setup_seed


def build_tokenizer(hyp: dict):
    """Local tokenizer only (no hub). ``tokenizer_path`` points at a dir with
    vocab/tokenizer files or at a bare ``vocab.txt``; without it
    ``bert_version`` is read as a local path. Fast (Rust) tokenizers unless
    ``fast_tokenizer: false``."""
    import transformers

    fast = hyp.get("fast_tokenizer", True)
    path = hyp.get("tokenizer_path") or hyp["bert_version"]

    def pick(name: str):
        # transformers 5 folds the *Fast classes into the plain names
        slow = getattr(transformers, name)
        return getattr(transformers, name + "Fast", slow) if fast else slow

    if "roberta" in hyp["bert_version"]:
        return pick("RobertaTokenizer").from_pretrained(path)
    cls = pick("BertTokenizer")
    if os.path.isfile(path):  # bare vocab.txt
        return cls(vocab_file=path)
    return cls.from_pretrained(path)


def build_all(hyp: dict, dataset: str, tokenizer=None, spec=None, *, device="cuda",
              seed: int = 0):
    """``(spec, cfg, model, transform, collator, tag_to_idx)`` from a YAML
    dict: the model built on ``device`` with weights drawn from a generator
    seeded with ``seed`` (in eval mode), the [CLS] / [SEP] ids taken from the
    tokenizer. Besides the reference's keys it reads ``attn_epilogue``
    (``"auto"``, or ``"fused"`` for the encoder's fused attention epilogue)."""
    spec = spec or get_spec(dataset)
    tag_mode = hyp.get("tag_mode", "B")
    tag_to_idx = spec.tag_to_idx(tag_mode)
    model_cfg_dict = dict(hyp)
    model_cfg_dict["num_classes"] = hyp.get("num_classes", spec.num_classes)
    if hyp.get("classifier_mode") == "crf" or tag_mode == "BIO":
        model_cfg_dict["tag_to_idx"] = tag_to_idx
    cfg = ModelConfig.from_yaml_dict(model_cfg_dict)
    if hyp.get("attn_epilogue", "auto") != "auto":
        # the encoder's attention epilogue; "fused": one kernel for the output
        # projection, dropout, residual and LayerNorm
        cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
            cfg.resolved_text_config(), attn_epilogue=hyp["attn_epilogue"]))
    if tokenizer is not None:
        # RoBERTa's <s> id is 0 (falsy): explicit None checks only
        cls_id, sep_id = tokenizer.cls_token_id, tokenizer.sep_token_id
        cfg = dataclasses.replace(
            cfg,
            cls_token_id=cls_id if cls_id is not None else 101,
            sep_token_id=sep_id if sep_id is not None else 102,
        )
    dev = resolve_device(device)
    model = ViBERTgridNet(cfg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed)).eval()
    transform = ImageTransform(
        hyp.get("image_mean", spec.image_mean),
        hyp.get("image_std", spec.image_std),
        hyp.get("image_min_size", [320, 416, 512, 608, 704]),
        hyp.get("test_image_min_size", 512),
        hyp.get("image_max_size", 800),
    )
    return spec, cfg, model, transform, Collator(transform), tag_to_idx


def _load_torch_state_dict(path: str) -> dict:
    """A ``.safetensors`` file, or a ``torch.save`` file holding a state dict
    (or a checkpoint dict with one under ``"model"``), as CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("model", sd) if isinstance(sd, dict) else sd


def load_pretrained_into_state(state, hyp: dict):
    """Load local pretrained weights into a model (or the model of a
    ``TrainState``) in place and return ``state``:

    - ``reference_weights``: a trained ViBERTgrid-PyTorch checkpoint (the full
      model ``state_dict``), every component through
      :func:`~vibertgrid_tpu_torch.models.convert_reference.load_reference_checkpoint`;
    - ``bert_weights``: a HuggingFace BERT / RoBERTa state dict into the text
      encoder;
    - ``backbone_weights``: a torchvision ResNet state dict into the trunk.
    """
    model = getattr(state, "model", state)
    if hyp.get("reference_weights"):
        from vibertgrid_tpu_torch.models.convert_reference import load_reference_checkpoint

        load_reference_checkpoint(model, _load_torch_state_dict(hyp["reference_weights"]))
        print("==> loaded reference (ViBERTgrid-PyTorch) checkpoint")
    if hyp.get("bert_weights"):
        from vibertgrid_tpu_torch.models.bert import load_hf_weights

        load_hf_weights(model.bert_model, _load_torch_state_dict(hyp["bert_weights"]))
        print("==> loaded local BERT weights")
    if hyp.get("backbone_weights"):
        from vibertgrid_tpu_torch.models.resnet_fpn import load_pretrained_backbone

        load_pretrained_backbone(model, _load_torch_state_dict(hyp["backbone_weights"]))
        print("==> loaded local backbone weights")
    return state


def process_device(device) -> torch.device:
    """This process's device: in a process group of more than one, the card
    ``LOCAL_RANK`` modulo the cards (made current) where ``device`` names the
    card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and get_world_size() > 1:
        dev = torch.device("cuda", local_device_index())
        torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def _tee_stdout(hyp: dict, comment: str):
    """With ``tee_logs`` (the default) stdout also goes to a log file under
    ``save_log`` for the run's length (rank 0's only)."""
    if not hyp.get("tee_logs", True) or not is_main_process():
        yield
        return
    save_log = hyp.get("save_log", "./log/")
    os.makedirs(save_log, exist_ok=True)
    tee = TerminalLogger(os.path.join(save_log, f"train_{comment.strip()}_{int(time.time())}.log"))
    sys.stdout = tee
    try:
        yield
    finally:
        sys.stdout = tee.terminal
        tee.log.close()


def _learned_types(res: dict) -> int:
    return sum(1 for v in res.get("per_type_F1", {}).values() if v > 0)


def train(hyp: dict, dataset: str, spec=None, max_steps: int | None = None, *,
          device="cuda") -> dict:
    """A whole training run; returns the last validate's metrics with
    ``best_F1``, ``best_learned_types``, ``final_state`` and ``timings``
    (each epoch's steps, losses, wall seconds and seconds waited on the
    loader; each validate's documents and wall seconds). ``max_steps`` cuts
    the run short (smoke runs); the run then validates and may save once more.
    ``device`` is the card unless the caller asks for the CPU (the tests).
    Under torchrun's environment it trains data-parallel (module docstring);
    a bootstrap that fails raises."""
    # the torchrun / NCCL bootstrap and the rank-0 print (the reference's
    # distributed_utils.py:73-100, 57-70); no-ops in one process
    init_distributed_mode(device=resolve_device(device))
    setup_rank0_print()
    make_mesh(hyp.get("mesh_data"), hyp.get("mesh_model") or 1)
    dev = process_device(device)
    comment = hyp.get("comment", dataset)
    with _tee_stdout(hyp, comment):
        return _train(hyp, dataset, spec, max_steps, dev, comment)


def _train(hyp, dataset, spec, max_steps, dev, comment) -> dict:
    setup_seed(42)
    tokenizer = build_tokenizer(hyp)
    batch_size = hyp.get("batch_size", 2)
    num_workers = hyp.get("num_workers", 0)
    spec, cfg, model, transform, collator, tag_to_idx = build_all(
        hyp, dataset, tokenizer, spec, device=dev, seed=42)
    data_root = hyp["data_root"]
    start_epoch = hyp.get("start_epoch", 0)
    end_epoch = hyp.get("end_epoch", 1)
    eval_mode = hyp.get("eval_mode", spec.default_eval_mode)
    if hyp.get("classifier_mode") == "crf" and eval_mode != "seqeval":
        # the CRF head emits decoded tags, not class scores (train_SROIE.py:134-137)
        raise ValueError("When using the crf classifier, only the seqeval metric is available")

    train_ds = KIEDataset(os.path.join(data_root, "train"), spec, tokenizer, train=True)
    test_ds = KIEDataset(os.path.join(data_root, "test"), spec, tokenizer, train=False)
    if hyp.get("compute_dataset_stats", False):
        # the reference's return_mean_std option (data/SROIE_dataset.py:263-278)
        m, s = compute_mean_std(train_ds, num_workers=num_workers)
        print(f"==> dataset stats: mean={m.tolist()} std={s.tolist()}")
        transform.image_mean = m.tolist()
        transform.image_std = s.tolist()

    # each process takes its share of an epoch, batch_size documents a step:
    # the schedules count its steps (DistributedSampler's length)
    rank, world = get_rank(), get_world_size()
    niter_per_ep = max(len(train_ds) // world // batch_size, 1)
    optimizer, schedules = make_optimizer(hyp, end_epoch, niter_per_ep, model.named_parameters(),
                                          return_schedules=True)
    state = create_train_state(model, optimizer)
    # pretrained weights from local files only (no hub)
    if hyp.get("bert_weights") or hyp.get("backbone_weights") or hyp.get("reference_weights"):
        load_pretrained_into_state(state, hyp)
    replicate(state.model)  # every process starts from rank 0's weights

    ckpt = CheckpointManager(hyp.get("save_top", "./weights/"), hyp.get("top_F1_tresh", 0.0))
    if hyp.get("weights"):
        state, meta = ckpt.restore(hyp["weights"], state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        print(f"==> resumed from {hyp['weights']} at epoch {start_epoch}")
    if hyp.get("zero1", False):
        # ZeRO-1: each process keeps and updates its slices of the large
        # optimizer-state leaves (a no-op in one process)
        shard_optimizer_state(state.optimizer, rank, world)

    train_step = make_train_step()
    # eval_uint8_upload: validation on the serving engine's uint8 wire (4x
    # fewer host-to-device bytes, <= 0.5/255 quantization); off by default,
    # so that the F1 that ranks checkpoints is the exact fp32 path's
    if hyp.get("eval_uint8_upload", False):
        eval_collator = Collator(transform, emit_uint8=True)
        eval_step = make_eval_step(image_stats=(transform.image_mean, transform.image_std))
    else:
        eval_collator, eval_step = collator, make_eval_step()
    logger = MetricsLogger(hyp.get("save_log", "./log/"), comment, enabled=is_main_process())
    timings: dict = {"train": [], "validate": []}

    def run_validate(epoch):
        # documents grouped by collation signature, eval_batch_size a batch
        t0 = time.perf_counter()
        loader = bucketed_eval_loader(test_ds, eval_collator,
                                      batch_size=hyp.get("eval_batch_size", 8),
                                      shard=(rank, world), num_workers=num_workers)
        with contextlib.closing(prefetch_to_device(loader, dev)) as batches:
            res = validate(eval_step, state, batches, spec, eval_mode=eval_mode,
                           tag_to_idx=tag_to_idx,
                           seqeval_average=hyp.get("seqeval_average", spec.seqeval_average))
        timings["validate"].append(dict(epoch=epoch, docs=len(test_ds),
                                        wall_s=time.perf_counter() - t0))
        return res

    # the initial validate of the untrained model (train_SROIE.py:324-335),
    # labelled so that a log tells it from an epoch's
    print(f"== validate (initial, epoch {start_epoch})")
    results = run_validate(start_epoch)
    best_f1 = results["primary_F1"]
    best_learned_types = _learned_types(results)

    # The per-iteration log (train_val_utils.py:293-335) reads the loss back,
    # a host sync, so it is asked for with iter_msg and strided by
    # log_interval; lr and wd come from the host's schedule arrays.
    iter_msg = hyp.get("iter_msg", False)
    log_interval = max(int(hyp.get("log_interval", 1)), 1)

    def _iter_log(epoch, it, loss_v, sched_idx, t_iter):
        idx = min(sched_idx, len(schedules["lr_cnn"]) - 1)
        mem = ""
        if dev.type == "cuda":
            mem = f"  max mem: {torch.cuda.max_memory_allocated(dev) / 1048576:.0f}MB"
        print(
            f"\t epoch[{epoch + 1}]  iter[{it}]/[{niter_per_ep}]  "
            f"train_loss: {loss_v:.4f}  "
            f"lr_cnn: {schedules['lr_cnn'][idx]:.3e}  "
            f"lr_bert: {schedules['lr_bert'][idx]:.3e}  "
            f"wd: {schedules['wd_cnn'][idx]:.3e}  "
            f"time used: {t_iter:.2f}s{mem}"
        )
        logger.update(head="opt", step=idx, lr_cnn=float(schedules["lr_cnn"][idx]),
                      lr_bert=float(schedules["lr_bert"][idx]),
                      wd_cnn=float(schedules["wd_cnn"][idx]),
                      wd_bert=float(schedules["wd_bert"][idx]))
        logger.update(head="loss", step=idx, iter_loss=loss_v)

    seed = hyp.get("seed", 42)
    start_step = state.step
    steps_done = 0
    for epoch in range(start_epoch, end_epoch):
        t_ep = t_iter = time.perf_counter()
        it_in_epoch = 0
        waited = 0.0
        epoch_losses = []
        loader = data_loader(train_ds, collator, batch_size, train=True, seed=epoch,
                             shard=(rank, world), num_workers=num_workers)
        # a background thread reads and collates the next batches and copies
        # them to the device while the device runs this step
        with contextlib.closing(prefetch_to_device(loader, dev)) as batches:
            t_wait = time.perf_counter()
            for batch, _aux in batches:
                waited += time.perf_counter() - t_wait
                state, loss = train_step(state, batch, step_seeds(seed, state.step))
                epoch_losses.append(loss)
                steps_done += 1
                it_in_epoch += 1
                logger.set_step()
                if iter_msg and steps_done % log_interval == 0:
                    now = time.perf_counter()
                    _iter_log(epoch, it_in_epoch, loss.item(), start_step + steps_done - 1,
                              now - t_iter)
                    t_iter = now
                if max_steps and steps_done >= max_steps:
                    break
                t_wait = time.perf_counter()
        step_losses = torch.stack(epoch_losses).cpu().tolist() if epoch_losses else []
        wall = time.perf_counter() - t_ep
        mean_loss = float(np.mean(step_losses)) if step_losses else float("nan")
        # docs: the global batch's, every process's together
        timings["train"].append(dict(epoch=epoch, steps=it_in_epoch,
                                     docs=it_in_epoch * batch_size * world,
                                     losses=step_losses, wall_s=wall, loader_wait_s=waited))
        print(f"\tepoch[{epoch + 1}] train_loss: {mean_loss:.4f} time: {wall:.0f}s "
              f"({it_in_epoch} steps, {waited:.1f}s waiting on the loader)")
        logger.update(head="loss", step=epoch + 1, train_loss=mean_loss)

        # validate every val_epoch_interval epochs, after the last, and at a
        # max_steps stop, so that `results` is always the final model's
        val_interval = max(int(hyp.get("val_epoch_interval", 1)), 1)
        stopping = bool(max_steps and steps_done >= max_steps)
        if (epoch + 1) % val_interval == 0 or epoch + 1 == end_epoch or stopping:
            print(f"== validate (epoch {epoch + 1})")
            results = run_validate(epoch + 1)
            f1 = results["primary_F1"]
            logger.update(head="criteria", step=epoch + 1, label_F1=f1)
            best_f1 = max(best_f1, f1)
            best_learned_types = max(best_learned_types, _learned_types(results))
            saved = ckpt.maybe_save(state, epoch, f1)
            if saved:
                print(f"==> checkpoint saved: {saved}")
        if stopping:
            break

    logger.close()
    results["best_F1"] = best_f1
    # the most entity types with a nonzero F1 in any validate: a model
    # collapsed onto the majority class never has more than one
    results["best_learned_types"] = best_learned_types
    results["final_state"] = state
    results["timings"] = timings
    return results


def main(argv=None) -> dict:
    """The command line; returns :func:`train`'s results."""
    parser = argparse.ArgumentParser(description="ViBERTgrid training (PyTorch)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-d", "--dataset", default="sroie",
                        choices=["sroie", "ephoie", "funsd", "synthetic"])
    parser.add_argument("--max-steps", type=int, default=None,
                        help="truncate training after N steps (smoke runs)")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        hyp = yaml.safe_load(f)
    spec = None
    dataset = args.dataset
    if dataset == "synthetic":
        # self-contained: the dataset is generated where data_root is missing
        from vibertgrid_tpu_torch.data.synthetic import make_synthetic_root, synthetic_spec

        root = hyp.setdefault("data_root", "./synthetic_data")
        if not os.path.exists(os.path.join(root, "train")):
            make_synthetic_root(root, n_train=8, n_test=4, seed=0)
        hyp.setdefault("tokenizer_path", os.path.join(root, "vocab.txt"))
        spec = synthetic_spec()
        dataset = "sroie"
    return train(hyp, dataset, spec=spec, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
