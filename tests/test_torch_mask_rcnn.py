"""The port's Mask R-CNN against ``nuhtc_tpu``'s.

Tiny model (Swin embed 32, depths 1-1-1-1, drop-path 0, FPN 32, 4 classes)
as tests/test_semi_train.py builds it, f32 on the CPU, JAX products at full
f32 precision, weights carried by ``state_dict_from_jax``, inputs from a
numpy seed. JAX's ``multilevel_roi_features`` RoIAligns with bf16 products
(``exact=False``) even on the CPU; the tests hand it ``exact=True`` through
a ``functools.partial`` of the extractor's ``roi_align`` in this file's
namespace (the JAX package is not edited). Tolerances:

- ``Shared2FCBBoxHead`` and the class-specific ``HTCMaskHead``: 1e-5 of the
  output's largest magnitude;
- ``roi_levels``: equal to the level JAX's extractor gives each RoI, over
  √(wh) within ±64·1e-7 (relative) of 56, 112, 224 and 448, where both the
  1e-6 shift and the log2 rounding decide; ``multilevel_roi_features``
  within 1e-5 of the output's scale at out 7 and 14;
- ``MaskRCNN.forward``: every slot (valid or not) of every output: boxes
  within 1e-3 px, scores, probs and mask probs within 1e-4, labels and
  valid flags equal (the stable sort fills slots past the valid ones as
  ``lax.top_k``);
- ``compute_losses``: each loss within 1e-4 relative, each parameter's
  gradient within 1e-4 of that leaf's largest JAX gradient, both samplers
  taking one table of uniform draws (``jax.random.uniform`` and the port's
  ``targets.uniform`` patched). Two facts this needs: (1) the bins of a gt
  box's own RoI sample its mask patch at half-pixel offsets, where jitted
  XLA rounds the bilinear weights the other way from the function's op by
  op semantics (which the port computes); the JAX side's targets are taken
  op by op through a host callback. (2) ~10⁶ ReLU pre-activations in the
  RoI heads put some within f32 noise of 0 (seen: 1e-8 to 1e-6), which
  flip between two right answers and move a gradient by ~1e-3 of its
  scale; the gradient case lifts those biases above the kink
  (``lift_relu_biases``), the forward case keeps them;
- ``InferenceEngine`` in both contracts on shared weights: detection sets
  matched one to one, scores and probs within 2e-4, boxes within 5e-3 px,
  ≥ 99.9 % of the label-map pixels equal (WSI mode), at most 3 flipped
  pixels a mask (strict path).
``state_dict_from_jax`` covers every leaf of the JAX tree under mmdet's Mask
R-CNN names, and ``load_reference_checkpoint`` reads such a ``.pth``.
"""

import contextlib
import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nuhtc_tpu.models.roi_extractor as JRE
import nuhtc_tpu.train.targets as JT
from nuhtc_tpu.apis.inference import InferenceEngine as JaxEngine
from nuhtc_tpu.models.bbox_head import Shared2FCBBoxHead as JBBoxHead
from nuhtc_tpu.models.mask_head import HTCMaskHead as JMaskHead
from nuhtc_tpu.models.mask_rcnn import MaskRCNN as JMaskRCNN
from nuhtc_tpu.utils.checkpoint import map_torch_key
from nuhtc_tpu_torch.apis.inference import InferenceEngine, init_detector
from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.models.bbox_head import Shared2FCBBoxHead
from nuhtc_tpu_torch.models.build import build_detector
from nuhtc_tpu_torch.models.mask_head import HTCMaskHead
from nuhtc_tpu_torch.models.mask_rcnn import MaskRCNN
from nuhtc_tpu_torch.models.roi_extractor import multilevel_roi_features, roi_levels
from nuhtc_tpu_torch.ops.roi_align import roi_align
from nuhtc_tpu_torch.train import targets as T
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax, torch_key
from test_torch_train_step import _Draws
from torch_oracle import match_detections
from torch_port_util import blob_tiles, f32, n, port_sd, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

SEMI_CONFIG = "configs/nuhtc/semi_base.py"
TINY_BACKBONE = dict(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=7,
                     drop_path_rate=0.0)
TINY = dict(num_classes=4, fpn_channels=32, rpn_nms_pre=128, rpn_max_per_img=64,
            rcnn_max_per_img=16, nms_candidates=128)
SIDE, B, G = 64, 2, 10
LOSS_RTOL = GRAD_TOL = 1e-4


@contextlib.contextmanager
def exact_rois():
    """JAX's multilevel extractor with f32 RoIAlign products."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JRE, "roi_align", functools.partial(JRE.roi_align, exact=True))
    try:
        with f32():
            yield
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def _tiny_params(seed: int):
    model = JMaskRCNN(backbone_cfg=TINY_BACKBONE, **TINY)
    init = jax.jit(functools.partial(model.init, method="init_forward"))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jnp.zeros((1, SIDE, SIDE, 3))))


def tiny_pair(seed: int = 0, scale_factor: float = 1.0, **kw):
    """(JAX MaskRCNN, its params as numpy (flax's initialisers from
    ``seed``), the port's MaskRCNN on the same weights); ``kw`` overrides the
    tiny settings of both."""
    settings = dict(TINY, scale_factor=scale_factor, **kw)
    jmodel = JMaskRCNN(backbone_cfg=TINY_BACKBONE, **settings)
    params = jax.tree.map(np.copy, _tiny_params(seed))
    port = MaskRCNN(backbone_cfg=TINY_BACKBONE, **settings)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, port


def _close(got, want, tol, err=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(n(got).astype(np.float64), want, atol=tol * scale, rtol=0,
                               err_msg=err)


# --------------------------------------------------------------------------- #
# heads and the extractor
# --------------------------------------------------------------------------- #
def test_shared2fc_bbox_head_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(30, 7, 7, 16).astype(np.float32)
    head = JBBoxHead(num_classes=6, in_channels=16, fc_out_channels=64)
    variables = head.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree.map(lambda v: v + 0.05 * np.random.RandomState(2).randn(*v.shape)
                             .astype(np.float32), variables)  # biases off zero
    with f32():
        jcls, jreg = head.apply(variables, jnp.asarray(x))
    port = Shared2FCBBoxHead(num_classes=6, in_channels=16, fc_out_channels=64)
    port.load_state_dict(port_sd("bbox_head", variables, "roi_head.bbox_head."), strict=True)
    cls, reg = port(t(x))
    assert cls.shape == (30, 7) and reg.shape == (30, 24)
    _close(cls, jcls, 1e-5)
    _close(reg, jreg, 1e-5)


def test_class_specific_mask_head_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(12, 14, 14, 16).astype(np.float32)
    head = JMaskHead(in_channels=16, conv_out_channels=16, num_classes=5, class_agnostic=False,
                     with_conv_res=False)
    variables = head.init(jax.random.PRNGKey(4), jnp.asarray(x), res_feat=None,
                          return_logits=True, return_feat=False)
    with f32():
        want = head.apply(variables, jnp.asarray(x), res_feat=None, return_logits=True,
                          return_feat=False)
    port = HTCMaskHead(in_channels=16, conv_out_channels=16, num_classes=5, class_agnostic=False)
    port.load_state_dict(port_sd("mask_head", variables, "roi_head.mask_head."), strict=True)
    got = port(t(x))
    assert got.shape == (12, 28, 28, 5) == want.shape
    _close(got, want, 1e-5)


def _boundary_rois():
    """Square boxes at the origin whose side crosses each level boundary in
    steps of 1e-7 (relative), and the same boxes shifted and stretched."""
    sides = np.concatenate([np.float32(56 * 2 ** k) * (1 + np.arange(-64, 65) * 1e-7)
                            for k in range(4)]).astype(np.float32)
    sq = np.stack([np.zeros_like(sides), np.zeros_like(sides), sides, sides], -1)
    wide = np.stack([sides * 0 + 3.0, sides * 0 + 5.0, 3.0 + 2 * sides, 5.0 + sides / 2], -1)
    return np.concatenate([sq, wide]).astype(np.float32)[None]  # (1, R, 4)


def test_roi_levels_match_jax_at_the_boundaries():
    """JAX's level of each RoI read through its own extractor: level i's map
    is the constant i + 1, every box lies inside the maps, so each output
    bin is (level + 1)."""
    rois = _boundary_rois()
    strides = (4, 8, 16, 32)
    side = 1024
    feats = [np.full((side // s, side // s, 1), i + 1.0, np.float32)
             for i, s in enumerate(strides)]
    with exact_rois():
        out = JRE.multilevel_roi_features([jnp.asarray(f) for f in feats], jnp.asarray(rois[0]),
                                          output_size=2)
    want = np.rint(np.asarray(out)[:, 0, 0, 0]).astype(np.int64) - 1
    got = n(roi_levels(t(rois), 4))[0]
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2, 3}
    # both sides of every boundary occur
    for k in (1, 2, 3):
        assert (got[:4 * 129] == k - 1).any() and (got[:4 * 129] == k).any()


@pytest.mark.parametrize("out", [7, 14])
def test_multilevel_roi_features_match_jax(out):
    rng = np.random.RandomState(out)
    feats = [rng.randn(B, SIDE // s, SIDE // s, 8).astype(np.float32) for s in (4, 8, 16, 32)]
    xy = rng.uniform(-6, SIDE - 8, (B, 60, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(600), (B, 60, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, :20] = _boundary_rois()[:, ::52][:, :20]  # sizes at the level boundaries
    before = roi_align.launches
    got = multilevel_roi_features([t(f) for f in feats], t(rois), out)
    assert roi_align.launches == before  # CPU tensors: the plain version
    with exact_rois():
        want = jax.vmap(lambda fs, r: JRE.multilevel_roi_features(fs, r, out))(
            tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois))
    assert got.shape == (B, 60, out, out, 8)
    _close(got, want, 1e-5)
    lv = n(roi_levels(t(rois), 4))
    assert len(np.unique(lv)) == 4


# --------------------------------------------------------------------------- #
# the detector
# --------------------------------------------------------------------------- #
def test_state_dict_from_jax_covers_the_mask_rcnn_tree():
    jmodel, params, port = tiny_pair()
    flat = dict(jax.tree_util.tree_flatten_with_path(params["params"])[0])
    paths = [tuple(k.key for k in path) for path in flat]
    keys = [torch_key(p)[0] for p in paths]
    assert sorted(keys) == sorted(port.state_dict()) and len(set(keys)) == len(keys)
    for key in ("roi_head.bbox_head.shared_fcs.0.weight", "roi_head.bbox_head.shared_fcs.1.bias",
                "roi_head.bbox_head.fc_cls.weight", "roi_head.bbox_head.fc_reg.weight",
                "roi_head.mask_head.convs.3.conv.weight", "roi_head.mask_head.upsample.weight",
                "roi_head.mask_head.conv_logits.weight", "conv_last.weight", "conv_last.bias"):
        assert key in keys, key
    assert port.conv_last.weight.shape == (1, 3 + 32 // 16, 3, 3)
    assert port.roi_head.bbox_head.fc_reg.weight.shape == (16, 1024)
    # the JAX package's loader cannot read the un-indexed bbox head back
    with pytest.raises(ValueError):
        map_torch_key("roi_head.bbox_head.shared_fcs.0.weight")
    assert map_torch_key("conv_last.weight") is None


def test_reference_pth_of_mask_rcnn_loads(tmp_path, capsys):
    cfg = Config.fromfile(SEMI_CONFIG)
    src = build_detector(cfg.model, None, 2.0)
    gen = torch.Generator().manual_seed(3)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in src.state_dict().items()}
    path = tmp_path / "semi_maskrcnn.pth"
    torch.save({"state_dict": sd}, path)
    engine = init_detector(SEMI_CONFIG, str(path), batch_size=1, device="cpu")
    assert isinstance(engine.model, MaskRCNN) and engine.num_classes == 8
    for k, v in engine.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert "unmatched" not in capsys.readouterr().out


def test_build_detector_dispatches_on_type(caplog):
    cfg = Config.fromfile(SEMI_CONFIG)
    model = build_detector(cfg.model, None, 2.0, swin_kernel="attn")
    assert isinstance(model, MaskRCNN)
    assert (model.num_classes, model.rcnn_score_thr, model.rcnn_nms_iou, model.rcnn_max_per_img,
            model.scale_factor, model.with_mid_seg) == (8, 0.05, 0.5, 100, 2.0, True)
    assert model.backbone.stages[2].blocks[0].kernel == "attn"
    assert [len(s.blocks) for s in model.backbone.stages] == [2, 2, 6, 2]
    # a reference-style test_cfg fills what the keys leave out; other keys are dropped
    mcfg = dict(type="MaskRCNN", num_classes=3, fpn_channels=32, roi_head=dict(x=1))
    tc = dict(rcnn=dict(score_thr=0.3, nms=dict(iou_threshold=0.6), max_per_img=50,
                        mask_thr_binary=0.4))
    with caplog.at_level(logging.WARNING, logger="nuhtc_tpu_torch"):
        model = build_detector(mcfg, tc, 1.0)
    assert (model.rcnn_score_thr, model.rcnn_nms_iou, model.rcnn_max_per_img,
            model.mask_thr_binary, model.num_classes) == (0.3, 0.6, 50, 0.4, 3)
    assert "ignoring config keys ['roi_head']" in caplog.text
    with pytest.raises(KeyError, match="not registered"):
        build_detector(dict(type="CascadeRCNN"), None, 1.0)


def test_mask_rcnn_forward_matches_jax():
    jmodel, params, port = tiny_pair(scale_factor=2.0, rcnn_score_thr=0.3, rcnn_max_per_img=32)
    img = np.random.RandomState(5).randn(B, SIDE, SIDE, 3).astype(np.float32)
    with exact_rois():
        want = jax.jit(jmodel.apply)(params, jnp.asarray(img))
    port.eval()
    got = port(t(img))
    assert sorted(got) == sorted(want) == ["boxes", "labels", "mask_probs", "probs", "scores",
                                           "valid"]
    valid = np.asarray(want["valid"])
    assert 0 < valid.sum() < valid.size  # valid and empty slots both occur
    np.testing.assert_array_equal(n(got["valid"]), valid)
    np.testing.assert_array_equal(n(got["labels"]), np.asarray(want["labels"]))
    np.testing.assert_allclose(n(got["boxes"]), np.asarray(want["boxes"]), atol=1e-3, rtol=0)
    for k in ("scores", "probs", "mask_probs"):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), atol=1e-4, rtol=0, err_msg=k)
    assert got["boxes"].max() <= SIDE / 2.0 + 1e-4  # the original frame


def _loss_batch(rng):
    """Blob nuclei with 64² mask patches, every third one box-only
    (``ismask`` 0), the second image with padding slots."""
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_valid = np.zeros((B, G), bool)
    patches = np.zeros((B, G, 64, 64), np.float32)
    sem = np.zeros((B, SIDE // 4, SIDE // 4), np.int32)
    yy, xx = np.mgrid[:64, :64]
    for i in range(B):
        k = G - 3 * i
        c = rng.uniform(10, SIDE - 10, (k, 2))
        half = rng.uniform(4, 9, (k, 2))
        gt_boxes[i, :k] = np.concatenate([c - half, c + half], 1)
        gt_valid[i, :k] = True
        for j in range(k):
            patches[i, j] = (yy - 31.5) ** 2 / 30 ** 2 + (xx - 31.5) ** 2 / 24 ** 2 <= 1
            x1, y1, x2, y2 = (gt_boxes[i, j] / 4).astype(int)
            sem[i, y1:y2 + 1, x1:x2 + 1] = 1
    ismask = np.ones((B, G), np.float32)
    ismask[:, ::3] = 0.0
    return dict(gt_boxes=gt_boxes, gt_labels=rng.randint(0, 4, (B, G)).astype(np.int32),
                gt_valid=gt_valid, gt_patches=patches, gt_ismask=ismask, gt_semantic=sem)


def _eager_mask_targets(orig):
    """JAX's ``mask_targets_from_patches`` evaluated op by op (a host
    callback inside the jitted loss): the bins of a gt box's own RoI sample
    its patch at half-pixel offsets, and XLA's fused arithmetic rounds
    those ties the other way from the function's eager semantics, which the
    port computes."""
    def targets(r, gi, gtb, gtp, mask_size=28):
        def host(*a):
            with jax.disable_jit():
                return np.asarray(orig(*a, mask_size=mask_size))

        out = jax.ShapeDtypeStruct((r.shape[0], mask_size, mask_size), jnp.float32)
        return jax.pure_callback(host, out, r, gi, gtb, gtp, vmap_method="sequential")

    return targets


def run_losses_both(jmodel, params, port, img, batch, draws_seed=2):
    """compute_losses of both on one table of draws → (JAX losses, JAX
    gradients as a port state dict, port losses, draws); the port's
    gradients are on its parameters."""
    draws = _Draws(draws_seed)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", draws.jax_uniform)
    mp.setattr(T, "uniform", draws.port_uniform)
    mp.setattr(JT, "mask_targets_from_patches", _eager_mask_targets(JT.mask_targets_from_patches))
    try:
        def loss_fn(p):
            losses = jmodel.apply(p, jnp.asarray(img), {k: jnp.asarray(v) for k, v in batch.items()},
                                  method="compute_losses",
                                  rngs={"sampling": jax.random.PRNGKey(3),
                                        "dropout": jax.random.PRNGKey(4)})
            return losses["total"], losses

        with exact_rois():
            (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        port.train()
        port.zero_grad(set_to_none=True)
        cum = torch.zeros(1, 4)
        losses, cum_out = port.compute_losses(t(img), {k: t(v) for k, v in batch.items()}, cum,
                                              torch.Generator())
        assert cum_out is cum  # the counts pass through
        losses["total"].backward()
    finally:
        mp.undo()
    return jlosses, state_dict_from_jax(jax.tree.map(np.asarray, jgrads)), losses, draws


# the ReLU layers of the RoI heads, in order: (flax path of the bias, port module)
RELU_LAYERS = [(("bbox_head", "shared_fc0"), "roi_head.bbox_head.shared_fcs.0"),
               (("bbox_head", "shared_fc1"), "roi_head.bbox_head.shared_fcs.1")] + [
    (("mask_head", f"conv{i}"), f"roi_head.mask_head.convs.{i}.conv") for i in range(4)] + [
    (("mask_head", "upsample"), "roi_head.mask_head.upsample")]
# the output layers after them, brought back to unit scale
OUT_LAYERS = [(("bbox_head", "fc_cls"), "roi_head.bbox_head.fc_cls"),
              (("bbox_head", "fc_reg"), "roi_head.bbox_head.fc_reg"),
              (("mask_head", "conv_logits"), "roi_head.mask_head.conv_logits")]


def lift_relu_biases(params, img, batch):
    """Shifts the bias of each ReLU layer of the RoI heads, layer by layer,
    so that every pre-activation on this batch (under the test's draws) is
    at least half a standard deviation above the kink. A pre-activation
    within the two packages' f32 noise of 0 (1e-8 to 1e-6 here, over ~10⁶
    of them) takes opposite sides of the ReLU and moves one sample's share
    of a gradient by ~1e-3 of its scale while both results are right
    (tests/test_torch_train_step.py); the forward test keeps the ReLUs'
    cut. The output layers after them are then rescaled to outputs of mean
    0 and deviation 1, so the losses stay off saturation. The heads' inputs
    are taken once from the port's ``compute_losses``."""
    port = MaskRCNN(backbone_cfg=TINY_BACKBONE, **TINY)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    heads = port.roi_head
    inputs = {}

    def keep_input(module, args, out):
        inputs.setdefault(module, args[0].detach())

    for head in (heads.bbox_head, heads.mask_head):
        head.register_forward_hook(keep_input)
    mp = pytest.MonkeyPatch()
    mp.setattr(T, "uniform", _Draws(2).port_uniform)
    try:
        with torch.no_grad():
            port.train().compute_losses(t(img), {k: t(v) for k, v in batch.items()},
                                        torch.zeros(1, 4), torch.Generator())
    finally:
        mp.undo()
    for path, name in RELU_LAYERS + OUT_LAYERS:
        seen = []
        hook = port.get_submodule(name).register_forward_hook(
            lambda m, i, o: seen.append(o.detach()))
        head = heads.bbox_head if path[0] == "bbox_head" else heads.mask_head
        with torch.no_grad():
            head(inputs[head])
        hook.remove()
        z = seen[0]
        node = params["params"]
        for p in path:
            node = node[p]
        if (path, name) in RELU_LAYERS:
            node["bias"] = node["bias"] + np.float32(max(0.0, -z.min().item())
                                                     + 0.5 * z.std().item())
        else:
            mean, std = np.float32(z.mean().item()), np.float32(z.std().item())
            node["kernel"] = node["kernel"] / std
            node["bias"] = (node["bias"] - mean) / std
        port.load_state_dict(state_dict_from_jax(params), strict=True)
    return params


@pytest.fixture(scope="module")
def loss_run():
    jmodel, params, _ = tiny_pair(seed=1)
    rng = np.random.RandomState(4)
    img = rng.randn(B, SIDE, SIDE, 3).astype(np.float32)
    batch = _loss_batch(rng)
    params = lift_relu_biases(params, img, batch)
    port = MaskRCNN(backbone_cfg=TINY_BACKBONE, **TINY)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    jl, jg, tl, draws = run_losses_both(jmodel, params, port, img, batch)
    return dict(jl=jl, jg=jg, tl=tl, draws=draws, port=port)


def test_compute_losses_match_jax(loss_run):
    jl, tl = loss_run["jl"], loss_run["tl"]
    assert loss_run["draws"].jax_calls == loss_run["draws"].port_calls == 6  # RPN, bbox, mask
    assert sorted(jl) == sorted(tl) == ["loss_bbox", "loss_cls", "loss_mask", "loss_mid_seg",
                                        "loss_rpn_bbox", "loss_rpn_cls", "total"]
    for k in jl:
        want, got = float(jl[k]), tl[k].item()
        assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1e-6), (k, got, want)
        assert got > 1e-3, k  # every term exercised


def test_compute_losses_gradients_match_jax(loss_run):
    params = dict(loss_run["port"].named_parameters())
    jg = loss_run["jg"]
    assert sorted(jg) == sorted(params)
    nonzero = 0
    for k, want in jg.items():
        want = want.numpy()
        g = params[k].grad
        got = np.zeros_like(want) if g is None else n(g)
        scale = float(np.abs(want).max())
        nonzero += scale > 0
        np.testing.assert_allclose(got, want, atol=GRAD_TOL * max(scale, 1e-12), rtol=0,
                                   err_msg=k)
    # at 64² the two coarse levels' output convs take none: their anchors
    # (128 and 256 px) lie outside the image and every RoI reads level 0
    assert sorted(k for k, w in jg.items() if not w.abs().max()) == [
        f"neck.fpn_convs.{i}.conv.{p}" for i in (2, 3) for p in ("bias", "weight")]
    assert nonzero == len(jg) - 4
    for k in ("neck.fpn_convs.0.conv.weight", "conv_last.weight", "rpn_head.rpn_reg.weight",
              "roi_head.mask_head.conv_logits.weight", "roi_head.bbox_head.fc_reg.weight"):
        assert np.abs(n(params[k].grad)).max() > 0, k


def test_compute_losses_without_cum_samples_returns_the_losses():
    _, _, port = tiny_pair()
    batch = _loss_batch(np.random.RandomState(6))
    img = np.random.RandomState(7).randn(B, SIDE, SIDE, 3).astype(np.float32)
    del batch["gt_ismask"]  # default: every gt has a mask
    losses = port.compute_losses(t(img), {k: t(v) for k, v in batch.items()},
                                 generator=torch.Generator().manual_seed(0))
    assert isinstance(losses, dict) and torch.isfinite(losses["total"])


# --------------------------------------------------------------------------- #
# the engine in both contracts
# --------------------------------------------------------------------------- #
TILE = 48


@pytest.mark.parametrize("wsi", [False, True], ids=["strict", "wsi"])
def test_inference_engine_matches_jax(wsi):
    jmodel, params, port = tiny_pair(scale_factor=2.0, rcnn_score_thr=0.25)
    mode = dict(device_preprocess=wsi, compact_masks=wsi)
    jax_engine = JaxEngine(jmodel, params, batch_size=2, tile_size=TILE, **mode)
    engine = InferenceEngine(port.eval(), batch_size=2, tile_size=TILE, **mode)
    tiles = blob_tiles(np.random.RandomState(8), 2, TILE, blobs=3)
    tiles[1] = tiles[1][:40, :44]  # an undersized tile
    with exact_rois():
        want = jax_engine.run_batch(tiles)
    got = engine.run_batch(tiles)
    total = 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        pairs, un_got, un_want = match_detections(g, w, iou_thr=0.5)
        assert len(un_got) == 0 and len(un_want) == 0, (len(un_got), len(un_want))
        gi = np.asarray([p[0] for p in pairs], int)
        wi = np.asarray([p[1] for p in pairs], int)
        total += len(gi)
        np.testing.assert_allclose(g["scores"][gi], w["scores"][wi], atol=2e-4, rtol=0)
        np.testing.assert_allclose(g["probs"][gi], w["probs"][wi], atol=2e-4, rtol=0)
        np.testing.assert_allclose(g["boxes"][gi], w["boxes"][wi], atol=5e-3, rtol=0)
        assert g["probs"].shape[1:] == (4,) and g["masks"].shape[1:] == (TILE, TILE)
        if wsi:
            lab_g = (g["masks"] * np.arange(1, len(gi) + 1)[:, None, None]).max(0)
            lab_w = (w["masks"] * np.arange(1, len(wi) + 1)[:, None, None]).max(0)
            remap = np.zeros(len(g["masks"]) + 1, int)
            remap[gi + 1] = wi + 1
            assert np.mean(remap[lab_g] == lab_w) >= 0.999
        else:
            flips = (g["masks"][gi] != w["masks"][wi]).reshape(len(gi), -1).sum(1)
            assert flips.max(initial=0) <= 3, flips.max()
    assert total > 4
    bboxes, segms = engine.to_reference_format(got[0])
    assert len(bboxes) == len(segms) == 4
