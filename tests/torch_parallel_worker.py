"""One rank of the multi-process runs of ``tests/test_torch_parallel.py`` (two
processes) and ``tests/test_torch_tensor_parallel.py`` (two or four), on
the CPU over gloo.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_worker.py TASK INPUTS OUT_DIR

Reads the inputs that the test wrote (``torch.save`` of plain containers),
takes this rank's share, runs ``TASK`` and writes ``OUT_DIR/TASK_<rank>.pt``.
It imports torch and the port only, never JAX: the test compares the ranks'
results with one process of the port and with the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vibertgrid_tpu_torch.parallel import collectives, mesh  # noqa: E402
from vibertgrid_tpu_torch.parallel.mesh import shard_batch  # noqa: E402

# ------------------------------------------------------------------ ops


def _leaf(x):
    return x.clone().requires_grad_()


def _norms(inp, rank, world):
    from vibertgrid_tpu_torch.models.norm import BatchNorm, MaskedBatchNorm

    out = {}
    for name, cls, args in (("bn", BatchNorm, ()), ("mbn", MaskedBatchNorm, ("mask",))):
        case = {k: shard_batch(v, rank, world) if k in ("x", "g", "mask") else v
                for k, v in inp[name].items()}
        norm = cls(case["x"].shape[1])
        with torch.no_grad():
            norm.weight.copy_(case["w"])
            norm.bias.copy_(case["b"])
        x = _leaf(case["x"])
        with collectives.global_batch():
            y = norm(x, *(case[a] for a in args), train=True)
            collectives.all_sum((y * case["g"]).sum()).backward()
        out[name] = dict(y=y.detach(), dx=x.grad, dw=norm.weight.grad, db=norm.bias.grad,
                         mean=norm.running_mean.clone(), var=norm.running_var.clone())
    return out


def _losses(inp, rank, world):
    from vibertgrid_tpu_torch.ops import losses

    out = {}
    for name, case in inp["losses"].items():
        arrays = [shard_batch(a, rank, world) for a in case["arrays"]]
        logits = _leaf(arrays[0])
        with collectives.global_batch():
            loss = getattr(losses, case["fn"])(logits, *arrays[1:], **case["kw"])
            loss.backward()
        out[name] = dict(loss=loss.detach(), grad=logits.grad)
    return out


def _dropout(inp, rank, world):
    from vibertgrid_tpu_torch.ops.dropout import hash_dropout
    from vibertgrid_tpu_torch.ops.flash_attention import flash_attention
    from vibertgrid_tpu_torch.ops.fused_ffn import fused_ffn_saved, fused_proj_ln

    d = inp["dropout"]
    rate, seed = d["rate"], d["seed"]
    sh = lambda name: shard_batch(d[name], rank, world)
    with collectives.global_batch(), torch.no_grad():
        return dict(
            mask=hash_dropout(sh("x"), seed, rate),
            attention=flash_attention(sh("q"), sh("k"), sh("v"), sh("bias"), d["scale"],
                                      d["heads"], rate=rate, seed=seed),
            ffn=fused_ffn_saved(sh("ffn_x"), *d["ffn_params"], d["eps"], rate=rate, seed=seed),
            proj_ln=fused_proj_ln(sh("ctx"), sh("res"), *d["proj_params"], d["eps"], rate=rate,
                                  seed=seed),
        )


def task_ops(inp, rank, world):
    return dict(norms=_norms(inp, rank, world), losses=_losses(inp, rank, world),
                dropout=_dropout(inp, rank, world))


# ---------------------------------------------------------------- train


def tiny_train_state(inp, ohem_random: bool, classifier_mode: str = "simp"):
    """The tiny config (dropout off) and its train state, seeded; the full
    and CRF heads on the fused attention epilogue."""
    from vibertgrid_tpu_torch.entry import train_entry
    from vibertgrid_tpu_torch.models.bert import TextEncoderConfig
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig

    text = dataclasses.replace(TextEncoderConfig.tiny("bert"), hidden_dropout=0.0,
                               attention_dropout=0.0,
                               attn_epilogue="auto" if classifier_mode == "simp" else "fused")
    cfg = ModelConfig(text_config=text, ohem_random=ohem_random,
                      **dict(inp["model_kw"], classifier_mode=classifier_mode))
    state, _, batch = train_entry("cpu", config=cfg, hyp=inp["hyp"], shape=inp["shape"])
    return state, batch


# tensors compared whole; of every other tensor its sum and sum of squares
WATCH = ("bert_model.layer.0.attention.query.weight", "bert_model.layer.0.attention.key.bias",
         "bert_model.layer.1.intermediate.weight", "bert_model.layer.1.output_ln.bias",
         "backbone.stem_conv.weight", "backbone.early_fusion.weight",
         "backbone.stage3_block1.bn1.weight", "backbone.stem_bn.running_var",
         "late_fusion.roi_embedding.bn1.bias", "late_fusion.roi_embedding.bn1.running_mean",
         "semantic_segmentation_head.encoder.conv1.weight",
         "semantic_segmentation_head.binary_bank.weight", "field_type_head.pos_neg_net.out.weight",
         "field_type_head.category_net.out.bias", "field_type_head.transitions")


def kept(named: dict) -> dict:
    """``{"full": the watched tensors, "stats": [sum, sum of squares, size]
    of each tensor in float64}``: what the test compares, a small part of
    the model."""
    def stats(t):
        t = t.detach().double()
        return torch.stack([t.sum(), t.square().sum(), t.new_tensor(t.numel())])

    return dict(full={n: t.detach().clone() for n, t in named.items() if n in WATCH},
                stats={n: stats(t) for n, t in named.items()})


def run_steps(state, batch, seed: int, steps: int, clip_steps: int = 0):
    """``steps`` train steps, then ``clip_steps`` more with a clip that
    fires; each step's loss, the first step's gradients and the parameters
    after ``steps`` and after all."""
    from vibertgrid_tpu_torch.train.seeds import step_seeds
    from vibertgrid_tpu_torch.train.state import clip_scale, make_train_step

    plain, clip = dict(loss_clip_tresh=10.0, clip_norm=2.0), dict(loss_clip_tresh=0.0,
                                                                  clip_norm=1e-3)
    losses, scales, grads, params = [], [], None, None
    for i in range(steps + clip_steps):
        kw = plain if i < steps else clip
        _, loss = make_train_step(**kw)(state, batch, step_seeds(seed, state.step))
        losses.append(loss.item())
        # the factor the step applied, from the gradients it left
        scales.append(clip_scale(loss, [p.grad for p in state.model.parameters()
                                        if p.grad is not None], **kw).item())
        if i == 0:
            grads = kept({n: p.grad for n, p in state.model.named_parameters()
                          if p.grad is not None})
        if i == steps - 1:
            params = kept(state.model.state_dict())
    return dict(losses=losses, scales=scales, grads=grads, params=params,
                final=kept(state.model.state_dict()))


def task_train(inp, rank, world):
    from vibertgrid_tpu_torch.parallel.sharding import shard_optimizer_state, state_bytes
    from vibertgrid_tpu_torch.train.checkpoint import CheckpointManager

    out = {}
    for ohem_random in (False, True):
        state, batch = tiny_train_state(inp, ohem_random)
        out[f"ohem_random={ohem_random}"] = run_steps(
            state, shard_batch(batch, rank, world), inp["seed"], 2,
            clip_steps=0 if ohem_random else 1)

    for mode in ("full", "crf"):
        state, batch = tiny_train_state(inp, True, mode)
        out[mode] = run_steps(state, shard_batch(batch, rank, world), inp["seed"], 1)

    state, batch = tiny_train_state(inp, False)
    opt = state.optimizer
    full = state_bytes(opt)
    shard_optimizer_state(opt, rank, world, min_size=inp["min_size"])
    split = sum(t.numel() * t.element_size() * world for p in opt.shards
                for t in opt.state[p].values())
    run = run_steps(state, shard_batch(batch, rank, world), inp["seed"], 2)
    run["bytes"] = dict(replicated=full, zero1=state_bytes(opt), split=split)
    run["shards"] = {n: state.optimizer.shards[p] for n, p in state.model.named_parameters()
                     if p in state.optimizer.shards}
    CheckpointManager(inp["ckpt_dir"]).save(state, "zero1")
    out["zero1"] = run
    return out


# ----------------------------------------------------------- eval, driver


def task_eval(inp, rank, world):
    from vibertgrid_tpu_torch.data.dataset import KIEDataset, data_loader, prefetch_to_device
    from vibertgrid_tpu_torch.data.synthetic import synthetic_spec
    from vibertgrid_tpu_torch.eval.cli import evaluate
    from vibertgrid_tpu_torch.eval.harness import validate
    from vibertgrid_tpu_torch.train import driver
    from vibertgrid_tpu_torch.train.state import TrainState, make_eval_step

    hyp, spec = inp["hyp"], synthetic_spec()
    tokenizer = driver.build_tokenizer(hyp)
    spec, _, model, _, collator, tag_to_idx = driver.build_all(
        hyp, "sroie", tokenizer, spec, device="cpu")
    test_ds = KIEDataset(os.path.join(hyp["data_root"], "test"), spec, tokenizer, train=False)
    loader = list(prefetch_to_device(
        data_loader(test_ds, collator, 1, train=False, shard=(rank, world)), torch.device("cpu")))
    state = TrainState(model=model, optimizer=None)
    results = validate(make_eval_step(), state, loader, spec, eval_mode=hyp["eval_mode"],
                       tag_to_idx=tag_to_idx, verbose=False)
    # the eval CLI's evaluate on the same weights, its loader sharded as well
    cli = evaluate(dict(hyp, eval_batch_size=1), "sroie", spec=spec, state=state, device="cpu")
    return dict(results=results, batches=len(loader), cli=cli)


def task_driver(inp, rank, world):
    from vibertgrid_tpu_torch.train import driver

    driver.resolve_device = lambda device: torch.device("cpu")
    steps = inp.get("max_steps", 2)
    results = driver.main(["-c", inp["config"], "-d", "synthetic",
                           *(["--max-steps", str(steps)] if steps else [])])
    optimizer = results["final_state"].optimizer
    return dict(losses=[x for e in results["timings"]["train"] for x in e["losses"]],
                f1=results["primary_F1"], loss=results["loss"],
                steps=results["final_state"].step, schedule_len=len(optimizer.schedules["lr_cnn"]),
                docs=[e["docs"] for e in results["timings"]["train"]])


# ------------------------------------------------------ tensor parallelism


def tp_config(inp, layout=None, hidden_dropout: float = 0.0):
    """The tiny config with the layout threaded in (tensor-parallel where it
    has a model axis above 1), attention dropout 0."""
    from vibertgrid_tpu_torch.models.bert import TextEncoderConfig
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig

    text = dataclasses.replace(TextEncoderConfig.tiny("bert"), hidden_dropout=hidden_dropout,
                               attention_dropout=0.0)
    return ModelConfig(text_config=text, mesh=layout, **inp["model_kw"])


def run_tp_steps(state, batch, seed: int, steps: int, layout, clip_steps: int = 0):
    """``run_steps`` on a tensor-parallel state: the gradients and
    parameters gathered whole before they are kept, and the clip factor as
    each step applied it."""
    from vibertgrid_tpu_torch.parallel.sharding import gather_whole
    from vibertgrid_tpu_torch.train import state as state_module
    from vibertgrid_tpu_torch.train.seeds import step_seeds

    applied = []
    clip_scale = state_module.clip_scale

    def kept_scale(*args, **kwargs):
        applied.append(clip_scale(*args, **kwargs))
        return applied[-1]

    plain, clip = dict(loss_clip_tresh=10.0, clip_norm=2.0), dict(loss_clip_tresh=0.0,
                                                                  clip_norm=1e-3)
    state_module.clip_scale = kept_scale
    losses, grads, params = [], None, None
    try:
        for i in range(steps + clip_steps):
            kw = plain if i < steps else clip
            _, loss = state_module.make_train_step(**kw)(state, batch,
                                                         step_seeds(seed, state.step))
            losses.append(loss.item())
            if i == 0:
                grads = kept(gather_whole({n: p.grad for n, p in state.model.named_parameters()
                                    if p.grad is not None}, layout))
            if i == steps - 1:
                params = kept(gather_whole(state.model.state_dict(), layout))
    finally:
        state_module.clip_scale = clip_scale
    return dict(losses=losses, scales=[x.item() for x in applied], grads=grads, params=params,
                final=kept(gather_whole(state.model.state_dict(), layout)))


def task_tp_forward(inp, rank, world):
    """``model = world``: the converted tiny weights cut to this rank's
    slices, an evaluation forward; the local shapes of the split weights."""
    from vibertgrid_tpu_torch.convert import megatron_slices
    from vibertgrid_tpu_torch.entry import make_batch
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig, ViBERTgridNet

    layout = mesh.make_mesh(1, world)
    model = ViBERTgridNet(ModelConfig(mesh=layout, **inp["model_kw"]), device="cpu").eval()
    model.load_state_dict(megatron_slices(inp["state"], layout))
    with torch.no_grad():
        pred = model(make_batch(**inp["shape"], device="cpu")).pred_label
    return dict(pred=pred, index=(layout.data_index, layout.model_index),
                shapes={n: tuple(p.shape) for n, p in model.named_parameters()})


def task_tp_train(inp, rank, world):
    """``data = 2 x model = 2``, hidden dropout on: a step and a clipped one
    replicated over the data group, then from a one-process checkpoint one
    step under ZeRO-1 over the data group, saved as a checkpoint."""
    from vibertgrid_tpu_torch.entry import train_entry
    from vibertgrid_tpu_torch.parallel.sharding import shard_optimizer_state
    from vibertgrid_tpu_torch.train.checkpoint import CheckpointManager

    layout = mesh.make_mesh(2, world // 2)
    cfg = tp_config(inp, layout, inp["hidden_dropout"])
    out = {"layout": (layout.data, layout.model, layout.data_index, layout.model_index)}
    state, _, batch = train_entry("cpu", config=cfg, hyp=inp["hyp"], shape=inp["shape"])
    batch = shard_batch(batch, layout.data_index, layout.data)
    out["plain"] = run_tp_steps(state, batch, inp["seed"], 1, layout, clip_steps=1)

    state, _, _ = train_entry("cpu", config=cfg, hyp=inp["hyp"], shape=inp["shape"])
    ckpt = CheckpointManager(inp["ckpt_dir"])
    ckpt.restore("one", state)
    shard_optimizer_state(state.optimizer, layout.data_index, layout.data,
                          min_size=inp["min_size"], group=layout.data_group)
    out["zero1"] = run_tp_steps(state, batch, inp["seed"], 1, layout)
    out["zero1"].update(step=state.step, split=len(state.optimizer.shards))
    ckpt.save(state, "tp")
    return out


def digests(named: dict) -> dict:
    """Each tensor's bytes as a SHA-256: equal digests are equal bits."""
    return {n: hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()
            for n, t in named.items()}


def tp_three_steps(inp, layout=None) -> dict:
    """The tiny config from its seed, hidden dropout on: two steps and a
    clipped one on this data shard (one process where ``layout`` is None);
    the losses and the digests of the whole state after the third."""
    from vibertgrid_tpu_torch.entry import train_entry
    from vibertgrid_tpu_torch.parallel.sharding import gather_whole

    cfg = tp_config(inp, layout, inp["hidden_dropout"])
    state, _, batch = train_entry("cpu", config=cfg, hyp=inp["hyp"], shape=inp["shape"])
    if layout is not None:
        batch = shard_batch(batch, layout.data_index, layout.data)
    run = run_tp_steps(state, batch, inp["seed"], 2, layout, clip_steps=1)
    return dict(losses=run["losses"],
                digests=digests(gather_whole(state.model.state_dict(), layout)))


def task_tp_repeat(inp, rank, world):
    """``data = 2 x model = 2``: :func:`tp_three_steps`."""
    return tp_three_steps(inp, mesh.make_mesh(2, world // 2))


def task_tp_driver(inp, rank, world):
    return task_driver(dict(inp, max_steps=None), rank, world)


TASKS = dict(ops=task_ops, train=task_train, eval=task_eval, driver=task_driver,
             tp_forward=task_tp_forward, tp_train=task_tp_train, tp_repeat=task_tp_repeat,
             tp_driver=task_tp_driver)


def main(task: str, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    mesh.init_distributed_mode(timeout=120, backend="gloo")
    rank, world = mesh.get_rank(), mesh.get_world_size()
    inp = torch.load(inputs, weights_only=False)
    out = TASKS[task](inp, rank, world)
    torch.save(out, os.path.join(out_dir, f"{task}_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
