"""The CRF, the full and CRF field-type heads and the two-stage segmentation
head against the JAX package's (CPU, fp32), from converted weights and with
the seeds the JAX modules derive from their PRNG keys.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vibertgrid_tpu_torch.convert import from_flax

NEG = -10000.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _seeds(keys):
    from vibertgrid_tpu.ops.dropout import derive_seed

    return [int(derive_seed(k)) for k in keys]


# --------------------------------------------------------------------- the CRF


def _crf_case(seed=50, b=6, t=7, classes=4):
    rng = np.random.default_rng(seed)
    k = classes + 2
    trans = rng.standard_normal((k, k)).astype(np.float32)
    trans[k - 2, :] = NEG
    trans[:, k - 1] = NEG
    feats = (2 * rng.standard_normal((b, t, k))).astype(np.float32)
    tags = rng.integers(0, classes, (b, t)).astype(np.int32)
    lengths = np.array([t, 3, 1, 0, 5, t - 1], np.int32)[:b]  # ragged, incl. 0 and 1
    return trans, feats, tags, lengths


def test_init_transitions_pins_start_and_stop():
    from vibertgrid_tpu_torch.ops.crf import init_transitions

    t = init_transitions(6, generator=torch.Generator().manual_seed(0))
    assert t.shape == (6, 6) and bool((t[4, :] == NEG).all()) and bool((t[:, 5] == NEG).all())
    free = t[[0, 1, 2, 3, 5]][:, :5]
    assert free.abs().max() < 10 and free.std() > 0.5


def test_crf_nll_value_and_gradient_match_jax():
    from vibertgrid_tpu.ops.crf import crf_nll_batch as jax_nll
    from vibertgrid_tpu_torch.ops.crf import crf_nll_batch

    trans, feats, tags, lengths = _crf_case()
    want, (want_dt, want_df) = jax.value_and_grad(jax_nll, argnums=(0, 1))(
        jnp.asarray(trans), jnp.asarray(feats), jnp.asarray(tags), jnp.asarray(lengths))
    tt, ft = _t(trans).requires_grad_(), _t(feats).requires_grad_()
    got = crf_nll_batch(tt, ft, _t(tags), _t(lengths))
    got.backward()
    # fp32 on both sides, the same order of operations
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_dt), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_df), atol=1e-5, rtol=1e-5)
    assert bool((ft.grad[3] == 0).all())  # the empty sequence reaches no emission


def test_crf_decode_matches_jax():
    from vibertgrid_tpu.ops.crf import crf_decode_batch as jax_decode
    from vibertgrid_tpu_torch.ops.crf import crf_decode_batch

    trans, feats, _, lengths = _crf_case(seed=51)
    want_scores, want_paths = jax_decode(jnp.asarray(trans), jnp.asarray(feats),
                                         jnp.asarray(lengths))
    scores, paths = crf_decode_batch(_t(trans), _t(feats), _t(lengths))
    assert paths.shape == (6, 7) and paths.dtype == torch.int64
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want_paths))
    # positions past the length hold the last real tag
    assert bool((paths[1, 3:] == paths[1, 2]).all())


# ------------------------------------------------------------------- the heads

HEAD_KW = dict(num_hard_positive_1=3, num_hard_negative_1=4, num_hard_positive_2=2,
               num_hard_negative_2=3)


def _head_inputs(n=24, d=32, classes=5, n_valid=20, seed=52):
    rng = np.random.default_rng(seed)
    fuse = rng.standard_normal((n, d)).astype(np.float32)
    seg_classes = rng.integers(0, classes, n).astype(np.int32)
    valid = np.arange(n) < n_valid
    return fuse, seg_classes, valid


@pytest.mark.parametrize("decision,layer_mode,ohem_random,n_valid", [
    ("reference", "single", False, 20),
    ("gated", "multi", True, 20),
    ("reference", "multi", True, 0),  # nothing valid: the class losses drop out
])
def test_full_head_matches_jax(decision, layer_mode, ohem_random, n_valid):
    from tests.test_torch_model import _perturb
    from vibertgrid_tpu.models.heads import FieldTypeClassification as JaxHead
    from vibertgrid_tpu_torch.models.heads import FieldTypeClassification

    c = 5
    fuse, seg_classes, valid = _head_inputs(classes=c, n_valid=n_valid)
    kw = dict(layer_mode=layer_mode, ohem_random=ohem_random, decision=decision, **HEAD_KW)
    jhead = JaxHead(num_classes=c, **kw)
    jargs = (jnp.asarray(fuse), jnp.asarray(seg_classes), jnp.asarray(valid))
    key = jax.random.PRNGKey(3)
    variables = _perturb(jhead.init(jax.random.PRNGKey(0), *jargs, compute_loss=True, key=key))
    # the gate must decide both ways for the second loss to see a real subset
    variables["params"]["pos_neg_net"]["out"]["kernel"] *= 20

    def jax_loss(fuse_):
        loss, _, pred = jhead.apply(variables, fuse_, *jargs[1:], compute_loss=True, key=key)
        return loss, pred

    (want_loss, want_pred), want_dfuse = jax.value_and_grad(jax_loss, has_aux=True)(jargs[0])
    head = FieldTypeClassification(32, c, dtype=torch.float32, device="cpu",
                                   generator=torch.Generator().manual_seed(0), **kw)
    head.load_state_dict(from_flax(variables), strict=True)
    ft = _t(fuse).requires_grad_()
    loss, pred = head(ft, _t(seg_classes), _t(valid), compute_loss=True,
                      seeds=_seeds(jax.random.split(key, c)))
    loss.backward()
    pos = pred[:, 1:].detach().sum(1) > 0
    if n_valid:
        assert 0 < int(pos.sum()) < len(pos)
    # fp32 on both sides: one or two small products, then the same selections
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_pred), atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_dfuse), atol=1e-6, rtol=1e-4)
    none, pred_only = head(_t(fuse))
    assert none is None and torch.equal(pred_only, pred.detach())
    want_col0 = torch.sigmoid(head.pos_neg_net(_t(fuse))[:, 0])
    if decision == "gated":
        want_col0 = 1 - want_col0
    torch.testing.assert_close(pred_only[:, 0], want_col0.detach())


@pytest.mark.parametrize("layer_mode", ["single", "multi"])
def test_crf_head_matches_jax(layer_mode):
    from tests.test_torch_model import _perturb
    from vibertgrid_tpu.models.heads import CRFFieldTypeClassification as JaxHead
    from vibertgrid_tpu_torch.models.heads import CRFFieldTypeClassification

    c, b, s, d = 4, 3, 6, 32
    rng = np.random.default_rng(53)
    fuse = rng.standard_normal((b, s, d)).astype(np.float32)
    seg_classes = rng.integers(0, c, (b, s)).astype(np.int32)
    lengths = np.array([6, 2, 0], np.int32)
    jhead = JaxHead(num_classes=c, layer_mode=layer_mode)
    jargs = (jnp.asarray(fuse), jnp.asarray(seg_classes), jnp.asarray(lengths))
    # flax creates `transitions` in every mode; the perturbation leaves START
    # and STOP within 0.1 of their pin, which the comparison does not need exact
    variables = _perturb(jhead.init(jax.random.PRNGKey(0), *jargs, train=True))
    want_nll, _, want_feats = jhead.apply(variables, *jargs, train=True, compute_loss=True)
    want_score, _, want_paths = jhead.apply(variables, *jargs, train=False, compute_loss=True)

    head = CRFFieldTypeClassification(d, c, layer_mode=layer_mode, dtype=torch.float32,
                                      device="cpu", generator=torch.Generator().manual_seed(0))
    assert head.transitions.shape == (c + 2, c + 2)
    assert bool((head.transitions[c] == NEG).all())
    assert bool((head.transitions[:, c + 1] == NEG).all())
    head.load_state_dict(from_flax(variables), strict=True)
    args = (_t(fuse), _t(seg_classes), _t(lengths))
    nll, feats = head(*args, train=True, compute_loss=True)
    np.testing.assert_allclose(nll.item(), float(want_nll), rtol=1e-5)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(want_feats), atol=1e-5)
    nll.backward()
    assert head.transitions.grad.abs().sum() > 0
    with torch.no_grad():
        score, paths = head(*args, train=False, compute_loss=True)
        none, paths_only = head(*args)
    np.testing.assert_allclose(score.item(), float(want_score), rtol=1e-5)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want_paths))
    assert none is None and torch.equal(paths_only, paths)


@pytest.mark.parametrize("train", [True, False])
def test_two_stage_seg_head_matches_jax(train):
    from tests.test_torch_model import _perturb
    from vibertgrid_tpu.models.seg_head import SemanticSegmentationHead as JaxHead
    from vibertgrid_tpu_torch.models.seg_head import SemanticSegmentationHead

    c, ch = 5, 8
    rng = np.random.default_rng(54)
    p_fuse = rng.standard_normal((2, 16, 24, ch)).astype(np.float32)
    x0, y0 = rng.integers(0, 60, (2, 6)), rng.integers(0, 40, (2, 6))
    boxes = np.stack([x0, y0, x0 + rng.integers(8, 36, (2, 6)), y0 + rng.integers(6, 24, (2, 6))],
                     -1).astype(np.int32)
    seg_classes = rng.integers(0, c, (2, 6)).astype(np.int32)
    box_mask = np.ones((2, 6), bool)
    box_mask[1, 4:] = False
    kw = dict(loss_1_sample_list=[40, 60, 40], num_hard_positive=50, num_hard_negative=70)
    jhead = JaxHead(num_classes=c, **kw)
    jargs = tuple(jnp.asarray(a) for a in (p_fuse, seg_classes, boxes, box_mask))
    key = jax.random.PRNGKey(4)
    variables = _perturb(jhead.init(jax.random.PRNGKey(0), *jargs, train=True, key=key))
    # the mask must predict class 1 on part of the page for the gate to matter
    variables["params"]["encoder"]["mask_proj"]["kernel"] *= 10
    (want_loss, want_mask, want_cls), _ = jhead.apply(
        variables, *jargs, train=train, key=key, mutable=["batch_stats"])

    head = SemanticSegmentationHead(ch, c, dtype=torch.float32, device="cpu",
                                    generator=torch.Generator().manual_seed(0), **kw)
    head.load_state_dict(from_flax(variables), strict=True)
    # the JAX head splits C + 1 keys and uses the first C
    seeds = _seeds(jax.random.split(key, c + 1))[:c]
    loss, mask_logits, class_logits = head(_t(p_fuse), _t(seg_classes), _t(boxes), _t(box_mask),
                                           train=train, seeds=seeds)
    share = (mask_logits.argmax(-1) == 1).float().mean().item()
    assert 0.05 < share < 0.95
    assert mask_logits.shape == (2, 64, 96, 3) and class_logits.shape == (2, 64, 96, c)
    # fp32 on both sides: two 3x3 convolutions and BatchNorm summed in other orders
    np.testing.assert_allclose(mask_logits.detach().numpy(), np.asarray(want_mask), atol=1e-4)
    np.testing.assert_allclose(class_logits.detach().numpy(), np.asarray(want_cls), atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5)
    loss.backward()
    assert head.binary_bank.weight.grad.abs().sum() > 0
