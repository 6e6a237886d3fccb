"""Weights in and out of the port: the HuggingFace and torchvision loaders
against the JAX package's on seeded state dicts, the checkpoint round trip,
and every YAML configuration in each classifier mode.
"""

import dataclasses
import glob

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.torch_checkpoints import checkpoints_dropped  # noqa: F401
from vibertgrid_tpu_torch.convert import from_flax

# each test's checkpoints go once it has read them back
pytestmark = pytest.mark.usefixtures("checkpoints_dropped")


# ---------------------------------------------------------------- HuggingFace


def _hf_state_dict(cfg, rng, prefix=""):
    d, f = cfg.hidden_size, cfg.intermediate_size
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    sd = {
        "embeddings.word_embeddings.weight": r(cfg.vocab_size, d),
        "embeddings.position_embeddings.weight": r(cfg.max_position_embeddings, d),
        "embeddings.token_type_embeddings.weight": r(cfg.type_vocab_size, d),
        "embeddings.LayerNorm.weight": r(d), "embeddings.LayerNorm.bias": r(d),
    }
    for i in range(cfg.num_layers):
        hf = f"encoder.layer.{i}"
        for name, shape in (("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
                            ("attention.self.value", (d, d)), ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (f, d)), ("output.dense", (d, f))):
            sd[f"{hf}.{name}.weight"] = r(*shape)
            sd[f"{hf}.{name}.bias"] = r(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{hf}.{name}.weight"] = r(d)
            sd[f"{hf}.{name}.bias"] = r(d)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix,as_torch", [("", False), ("bert.", True)])
def test_load_hf_weights_matches_jax(prefix, as_torch):
    from vibertgrid_tpu.models.bert import TextEncoder as JaxEncoder
    from vibertgrid_tpu.models.bert import TextEncoderConfig as JaxCfg
    from vibertgrid_tpu.models.bert import load_hf_weights as jax_load
    from vibertgrid_tpu_torch.models.bert import TextEncoder, TextEncoderConfig, load_hf_weights

    cfg = TextEncoderConfig.tiny()
    sd = _hf_state_dict(cfg, np.random.default_rng(60), prefix)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = JaxEncoder(JaxCfg.tiny()).init(
        jax.random.PRNGKey(0), ids, jnp.ones_like(ids))["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    want = from_flax({"params": jax_load(params, sd, cfg.num_layers)})

    encoder = TextEncoder(cfg, device="cpu")
    load_hf_weights(encoder, {k: torch.from_numpy(v) for k, v in sd.items()} if as_torch else sd)
    got = encoder.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)

    bad = dict(sd)
    key = prefix + "encoder.layer.1.output.dense.weight"
    bad[key] = bad[key].T
    with pytest.raises(ValueError, match="output.dense"):
        load_hf_weights(encoder, bad)
    del bad[key]
    with pytest.raises(KeyError):
        load_hf_weights(encoder, bad)


# ---------------------------------------------------------------- torchvision


def _resnet18_state_dict(rng):
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    sd = {}

    def bn(name, c):
        sd.update({f"{name}.weight": r(c), f"{name}.bias": r(c), f"{name}.running_mean": r(c),
                   f"{name}.running_var": np.abs(r(c)) + 0.5,
                   f"{name}.num_batches_tracked": np.asarray(7)})

    sd["conv1.weight"] = r(64, 3, 7, 7)
    bn("bn1", 64)
    c_in = 64
    for si, c in enumerate((64, 128, 256, 512)):
        for b in range(2):
            t = f"layer{si + 1}.{b}"
            sd[f"{t}.conv1.weight"] = r(c, c_in if b == 0 else c, 3, 3)
            bn(f"{t}.bn1", c)
            sd[f"{t}.conv2.weight"] = r(c, c, 3, 3)
            bn(f"{t}.bn2", c)
            if b == 0 and si > 0:
                sd[f"{t}.downsample.0.weight"] = r(c, c_in, 1, 1)
                bn(f"{t}.downsample.1", c)
        c_in = c
    sd["fc.weight"], sd["fc.bias"] = r(10, 512), r(10)  # the classifier is not read
    return sd


def test_load_torchvision_resnet_matches_jax():
    from vibertgrid_tpu.models.resnet_fpn import BACKBONE_REGISTRY as JREG
    from vibertgrid_tpu.models.resnet_fpn import ResNetFPN as JaxFPN
    from vibertgrid_tpu.models.resnet_fpn import load_pretrained_backbone as jax_load
    from vibertgrid_tpu_torch.models.resnet_fpn import (
        BACKBONE_REGISTRY,
        ResNetFPN,
        load_pretrained_backbone,
        load_torchvision_resnet,
    )

    name = "resnet_18_fpn_pretrained"
    sd = _resnet18_state_dict(np.random.default_rng(61))
    images, grid = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 8, 8, 16))
    v = JaxFPN(**JREG[name]).init(jax.random.PRNGKey(1), images, grid)
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
    variables = {"params": {"backbone": v["params"]}, "batch_stats": {"backbone": v["batch_stats"]}}
    loaded = jax_load(variables, sd, name)
    want = from_flax({"params": loaded["params"]["backbone"],
                      "batch_stats": loaded["batch_stats"]["backbone"]})

    backbone = ResNetFPN(grid_channels=16, device="cpu", **BACKBONE_REGISTRY[name])
    backbone.load_state_dict(from_flax(v), strict=True)  # the FPN layers keep this init
    load_torchvision_resnet(backbone, {k: torch.from_numpy(np.asarray(a)) for k, a in sd.items()})
    got = backbone.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    np.testing.assert_array_equal(got["stage4_block0.shortcut_bn.running_var"].numpy(),
                                  sd["layer3.0.downsample.1.running_var"])

    class Net(torch.nn.Module):  # anything with a `backbone`
        def __init__(self):
            super().__init__()
            self.backbone = ResNetFPN(grid_channels=16, device="cpu", **BACKBONE_REGISTRY[name])

    net = Net()
    load_pretrained_backbone(net, sd)  # numpy arrays
    np.testing.assert_array_equal(net.backbone.stem_conv.weight.detach().numpy(), sd["conv1.weight"])
    bad = dict(sd, **{"layer2.0.conv1.weight": sd["layer2.0.conv1.weight"][:, :32]})
    with pytest.raises(ValueError, match="layer2.0.conv1"):
        load_torchvision_resnet(backbone, bad)


# ----------------------------------------------------------------- checkpoint


def _tiny_state(seed):
    from vibertgrid_tpu_torch.entry import FLAGSHIP_TRAIN, train_entry

    config = dataclasses.replace(FLAGSHIP_TRAIN, bert_version="tiny-bert-test",
                                 backbone="resnet_18_fpn", compute_dtype=torch.float32)
    return train_entry(device="cpu", seed=seed, config=config,
                       shape=dict(b=2, h=64, w=64, t=510, s=6, vocab=512))


def test_checkpoint_restores_a_state_that_steps_alike(tmp_path):
    from vibertgrid_tpu_torch.train.checkpoint import CheckpointManager, restore_checkpoint
    from vibertgrid_tpu_torch.train.seeds import SeedStream

    state, train_step, batch = _tiny_state(seed=0)
    train_step(state, batch, SeedStream(1))
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    path = manager.save(state, "latest", epoch=3, note="x")

    fresh, _, _ = _tiny_state(seed=9)  # other weights, empty optimizer state
    fresh.optimizer.schedules = {k: v * 0 for k, v in fresh.optimizer.schedules.items()}
    restored, meta = manager.restore("latest", fresh)
    assert restored is fresh and meta == {"epoch": 3, "f1": 0.0, "note": "x"}
    assert fresh.step == 1 and fresh.optimizer.count == 1
    for key, value in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[key], value), key
    for key, value in state.optimizer.schedules.items():
        np.testing.assert_array_equal(fresh.optimizer.schedules[key], value)
    slot = fresh.optimizer.state[fresh.model.backbone.stem_conv.weight]["momentum"]
    assert slot.dtype == torch.bfloat16 and slot.abs().sum() > 0

    _, a = train_step(state, batch, SeedStream(2))
    _, b = train_step(fresh, batch, SeedStream(2))
    assert a.item() == b.item() and fresh.step == 2
    for (name, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), name
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        for slot_name, value in state.optimizer.state[p].items():
            assert torch.equal(fresh.optimizer.state[q][slot_name], value)

    # the manager-free entry point, by path
    again, _, _ = _tiny_state(seed=5)
    restore_checkpoint(path, again)
    assert again.step == 1


def test_checkpoint_manager_keeps_the_reference_policy(tmp_path):
    from vibertgrid_tpu_torch.train.checkpoint import CheckpointManager

    state, _, _ = _tiny_state(seed=0)
    manager = CheckpointManager(str(tmp_path), top_f1_thresh=0.5)
    assert manager.latest_best() is None
    assert manager.maybe_save(state, epoch=3, f1=0.4) is None            # neither best nor 10th
    assert manager.maybe_save(state, epoch=10, f1=0.4).endswith("epoch10_F1_0.4000")
    assert manager.maybe_save(state, epoch=11, f1=0.7, extra={"lr": 1e-3}) is not None
    assert manager.top_f1_thresh == 0.7
    assert manager.maybe_save(state, epoch=12, f1=0.6) is None
    assert manager.latest_best() == "epoch11_F1_0.7000"
    _, meta = manager.restore("epoch11_F1_0.7000", state)
    assert meta == {"epoch": 11, "f1": 0.7, "lr": 1e-3}


# ------------------------------------------------------------ configurations


@pytest.mark.parametrize("path", sorted(glob.glob("vibertgrid_tpu/configs/*.yaml")))
@pytest.mark.parametrize("mode", ["simp", "full", "crf"])
def test_every_yaml_config_builds_in_every_mode(path, mode):
    import yaml

    from vibertgrid_tpu.models.vibertgrid import ModelConfig as JaxConfig
    from vibertgrid_tpu_torch.models.vibertgrid import ModelConfig, ViBERTgridNet

    with open(path) as f:
        hyp = dict(yaml.safe_load(f), classifier_mode=mode)
    cfg, want = ModelConfig.from_yaml_dict(hyp), JaxConfig.from_yaml_dict(hyp)
    assert cfg.classifier_mode == mode
    for field in dataclasses.fields(cfg):
        if field.name != "compute_dtype":
            assert getattr(cfg, field.name) == getattr(want, field.name), field.name
    assert dataclasses.asdict(cfg.resolved_text_config()) == dataclasses.asdict(
        want.resolved_text_config())
    # the model itself at a width the CPU builds in a moment
    small = dataclasses.replace(cfg, bert_version="tiny-bert-test", backbone="resnet_18_fpn")
    net = ViBERTgridNet(small, device="cpu")
    head = type(net.field_type_head).__name__
    assert head == {"simp": "SimplifiedFieldTypeClassification", "full": "FieldTypeClassification",
                    "crf": "CRFFieldTypeClassification"}[mode]
