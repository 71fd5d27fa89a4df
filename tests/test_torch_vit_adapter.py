"""ViT-Adapter (``models/vit_adapter.py``, core ``ops/ms_deform_attn.py``)
on the port's Mask R-CNN, against the benchmark's plain reference
(``portbench/reference``: ``model.py``'s Mask R-CNN on the parts
``parts/ViTAdapter.py`` and ``parts/FPN.py``), on the CPU in f32.

Weights: ``portbench.harness.weights.make`` from a seed (γ 1, the level
embeddings std 1), with every batch-norm's weight, bias, running mean and
running variance then drawn at random, the same in both models, so that a
program that ignored one of them differs. The size: a non-square 160 × 224
input (so (H_l, W_l) and (W_l, H_l) differ), embed 64, 4 heads, 4 blocks
with windows of 4 in blocks 0, 1, 3 over the 10 × 14 ViT grid (padded to
12 × 16), 4 deformable heads of 8 channels, conv_inplane 16, four
interactions of one block each (4 injectors, 6 extractors), FPN 16.

Tolerance: each pyramid map within 1e-5 of its largest magnitude. The
detections match one to one (label, IoU > 0.5) with a median score gap
within 1e-5 and a median box gap within 1e-5 of the input's side, the
largest coordinate difference of a pair over the side. The box gap is not
``check.pair_gaps``' 1 − IoU: the reference samples by index gathers and
the port by ``grid_sample``, so the two differ by f32 rounding (~4e-7 of
the pyramid's scale), which the random heads carry to ~1e-4 pixels a
coordinate, and on boxes two pixels high that reads 1 − IoU ~ 5e-5.

Each of these, made in the port alone, breaks the pyramid's agreement: γ
zeroed; the offsets' x and y swapped; (H_l, W_l) as the normaliser; the
levels' starts reordered in the core; the depthwise conv run over the
concatenated tokens as one map; the batch-norm's running variance ignored;
the ViT's last map added to every level, in place of its map after
interaction i to level i.

Also: the core against the reference's explicit gather at points inside,
on the borders, outside and at negative coordinates, in f32 and bf16; the
spans and counters; the constants as buffers built once; batch-norms that
raise in training; ``init_detector`` serving the detector through
``dispatch`` and ``collect``; the published widths building the
reference's keys; and every existing configuration (``configs/nuhtc/*.py``
and the benchmark's three) building the keys, shapes and seed-0 random
weights of ``tests/goldens/init_digests.json``, written from the tree before
the adapter came (``python tests/test_torch_vit_adapter.py`` writes it
anew).
"""

import copy
import glob
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import nuhtc_tpu_torch.ops.ms_deform_attn as core_mod
from nuhtc_tpu_torch.apis.inference import init_detector
from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.models import vit_adapter as va
from nuhtc_tpu_torch.models.build import build_detector, init_random_weights
from nuhtc_tpu_torch.models.fpn import FPN
from nuhtc_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from nuhtc_tpu_torch.utils import profiling
from portbench.harness import check, common, traffic, weights
from portbench.reference import model as ref_model
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "init_digests.json")
H, W, BATCH, SEED = 160, 224, 2, 5
TOL = 1e-5
SMALL = {"type": "ViTAdapter", "img_size": [H, W], "embed_dim": 64,
         "depth": 4, "num_heads": 4, "mlp_ratio": 4, "qkv_bias": True,
         "window_attn": [True, True, False, True], "window_size": [4, 4, None, 4],
         "pretrain_size": 224, "conv_inplane": 16, "n_points": 4, "deform_num_heads": 4,
         "cffn_ratio": 0.25, "deform_ratio": 0.5,
         "interaction_indexes": [[0, 0], [1, 1], [2, 2], [3, 3]]}
REF = ref_model.part("ViTAdapter")


def _bench_cfg(name):
    return common.config(common.benchmark(), name)


def _small_cfg(img_size=(H, W)):
    """``vitadapter-b-nucls`` at the test's size."""
    cfg = copy.deepcopy(_bench_cfg("vitadapter-b-nucls"))
    cfg["model"].update(backbone=dict(SMALL, img_size=list(img_size)),
                        neck={"type": "FPN", "in_channels": [64] * 4, "out_channels": 16},
                        rpn_nms_pre=256, rpn_max_per_img=128, nms_candidates=256,
                        rcnn_max_per_img=32)
    return dict(cfg, tile=img_size[1], scale_factor=1.0)


def _state(cfg):
    """The benchmark's weights with every batch-norm's four tensors drawn."""
    state = weights.make(cfg, SEED, torch.device("cpu"), torch.float32)
    gen = torch.Generator().manual_seed(SEED + 1)
    draws = {"weight": lambda s: 1.0 + 0.2 * torch.randn(s, generator=gen),
             "bias": lambda s: 0.2 * torch.randn(s, generator=gen),
             "running_mean": lambda s: 0.3 * torch.randn(s, generator=gen),
             "running_var": lambda s: 0.5 + 1.5 * torch.rand(s, generator=gen)}
    bn = {k for k in state if k.endswith(".running_var")}
    for key in sorted(bn):
        stem = key[: -len("running_var")]
        for name, draw in draws.items():
            state[stem + name] = draw(state[stem + name].shape)
    return state


def _input(seed, side_h=H, side_w=W):
    tiles = np.stack(traffic.tiles(np.random.RandomState(seed), BATCH, side_w))
    return ref_model.prep(torch.from_numpy(tiles), 1.0)[:, :side_h].contiguous()


@pytest.fixture(scope="module")
def pair():
    """(port, reference, state dict, the normalized input) at the test size."""
    cfg = _small_cfg()
    state = _state(cfg)
    port = build_detector(cfg["model"], None, cfg["scale_factor"]).eval()
    port.load_state_dict(state, strict=True)
    ref = ref_model.build(cfg).eval()
    ref.load_state_dict(state, strict=True)
    return port, ref, state, _input(SEED)


def _pyramid_close(got, want) -> bool:
    return all(g.shape == w.shape and (g - w).abs().max() <= TOL * w.abs().max()
               for g, w in zip(got, want, strict=True))


def _per_image(det):
    out = []
    for i in range(det["valid"].shape[0]):
        v = det["valid"][i]
        out.append({k: det[k][i][v].numpy() for k in ("boxes", "scores", "labels")})
    return out


def _box_gap(got, want, side: int) -> float:
    """Median over the matched pairs of their largest coordinate difference,
    over ``side``."""
    gaps = [np.abs(g["boxes"][gi] - w["boxes"][wi]).max() / side
            for g, w in zip(got, want, strict=True) for gi, wi, _ in check.match(g, w)]
    return float(np.median(gaps)) if gaps else 1.0


def test_pyramid_and_detections_equal_the_reference(pair):
    port, ref, _, x = pair
    with torch.no_grad():
        backbone = port.backbone(x)
        got, want = port.features(x), ref.neck(ref.backbone(x))
    assert [tuple(f.shape[1:3]) for f in backbone] == [(H // s, W // s) for s in (4, 8, 16, 32)]
    assert [tuple(f.shape) for f in got] == [(BATCH, H // s, W // s, 16) for s in (4, 8, 16, 32)]
    assert _pyramid_close(backbone, ref.backbone(x)) and _pyramid_close(got, want)
    g, w = _per_image(port(x)), _per_image(ref(x))
    assert all(len(d["scores"]) > 0 for d in w)
    det_unmatched, counts = check.unmatched(g, w)
    assert det_unmatched == 0.0, counts
    assert check.pair_gaps(g, w)[0] <= TOL and _box_gap(g, w, W) <= TOL


def _gamma_zeroed(port, monkeypatch):
    with torch.no_grad():
        for it in port.backbone.interactions:
            it.injector.gamma.zero_()


def _offsets_xy_swapped(port, monkeypatch):
    orig = va.MSDeformAttn.locations
    monkeypatch.setattr(va.MSDeformAttn, "locations",
                        lambda self, ref, off: orig(self, ref, off.flip(-1)))


def _normalizer_hw(port, monkeypatch):
    def locations(self, ref, off):
        return ref[None, :, None, None, None, :] + off / self.normalizer.flip(-1)[:, None, :]

    monkeypatch.setattr(va.MSDeformAttn, "locations", locations)


def _level_starts_reordered(port, monkeypatch):
    """The starts of levels stacked last to first, in the core alone."""
    def starts(shapes):
        sizes = [h * w for h, w in shapes]
        return [sum(sizes[i + 1:]) for i in range(len(sizes))]

    monkeypatch.setattr(core_mod, "level_starts", starts)


def _dwconv_over_concatenated(port, monkeypatch):
    """All the prior's tokens as one map of the first level's width."""
    def depthwise(self, x, shapes):
        b, n, c = x.shape
        w = shapes[0][1]
        rows = -(-n // w)
        m = torch.nn.functional.pad(x, (0, 0, 0, rows * w - n)).transpose(1, 2)
        out = self.dwconv.dwconv(m.reshape(b, c, rows, w)).flatten(2).transpose(1, 2)
        return out[:, :n]

    monkeypatch.setattr(va.ConvFFN, "depthwise", depthwise)


def _final_vit_map_at_every_level(port, monkeypatch):
    """The ViT's last map added to all four levels, not its map after each
    interaction to its own level."""
    orig = va.ViTAdapter.fuse
    monkeypatch.setattr(va.ViTAdapter, "fuse",
                        lambda self, c1, c, xs: orig(self, c1, c, [xs[-1]] * len(xs)))


def _running_var_ignored(port, monkeypatch):
    def forward(self, x):
        scale = self.weight * torch.rsqrt(torch.ones_like(self.running_var) + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]

    monkeypatch.setattr(va.FrozenBatchNorm2d, "forward", forward)


FAULTS = {"gamma_zeroed": _gamma_zeroed, "offsets_xy_swapped": _offsets_xy_swapped,
          "normalizer_hw": _normalizer_hw, "level_starts_reordered": _level_starts_reordered,
          "dwconv_over_concatenated": _dwconv_over_concatenated,
          "running_var_ignored": _running_var_ignored,
          "final_vit_map_at_every_level": _final_vit_map_at_every_level}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_in_the_port_breaks_the_agreement(pair, fault, monkeypatch):
    port, ref, _, x = pair
    broken = copy.deepcopy(port)
    FAULTS[fault](broken, monkeypatch)
    with torch.no_grad():
        assert not _pyramid_close(broken.backbone(x), ref.backbone(x))


def _core_inputs(dtype, seed=0):
    """A value map of two levels (5 × 7, 3 × 4), two heads of 8, and 11
    queries × 3 points a level at centres, on borders, outside the unit
    square and at negative coordinates."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(5, 7), (3, 4)]
    value = torch.randn(2, 35 + 12, 2, 8, generator=gen).to(dtype)
    special = torch.tensor([[0.5 / 7, 0.5 / 5], [0.0, 0.0], [1.0, 1.0], [0.0, 0.7], [1.0, 0.3],
                            [-0.05, 0.5], [1.08, 0.5], [0.4, -0.2], [-0.3, -0.4], [1.3, 1.2],
                            [-0.9, 0.2]])
    loc = special[None, :, None, None, None, :].repeat(2, 1, 2, 2, 3, 1)
    loc[..., 1:, :] += 0.3 * torch.randn(loc[..., 1:, :].shape, generator=gen)
    weights = torch.rand(2, 11, 2, 2, 3, generator=gen)
    weights = weights / weights.sum((-1, -2), keepdim=True)
    return value, shapes, loc, weights


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_core_equals_the_explicit_gather(dtype):
    value, shapes, loc, weights = _core_inputs(dtype)
    got = ms_deform_attn(value, shapes, loc, weights)
    want = REF.sample_and_sum(value.float(), shapes, loc, weights)
    assert got.dtype == dtype and got.shape == (2, 11, 16)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    assert (got.float() - want).abs().max() <= tol * want.abs().max()
    # the fully outside points read zero
    outside = torch.zeros_like(loc)
    outside[..., 0] = torch.tensor([-0.2, 1.2, 2.0])
    assert ms_deform_attn(value, shapes, outside, weights).abs().max() == 0


def _sample_bytes(b, lq, shapes_q, shapes_v, m, dh, p):
    """Bytes of the f32 tensors one core call writes before its output."""
    nl, n = len(shapes_v), b * m
    per = 4 * (b * lq * m * nl * p * 2)  # grids
    per += sum(4 * (n * dh * h * w + n * lq * p * 2 + n * dh * lq * p) for h, w in shapes_v)
    return per + 4 * (2 * n * dh * lq * nl * p + n * lq * nl * p + n * dh * lq)


def test_spans_and_counters(pair):
    port, _, _, x = pair
    with profiling.spans(), torch.no_grad():
        port.backbone(x)
        seconds, counters = dict(profiling.SECONDS), dict(profiling.COUNTERS)
    names = {"model.adapter_spm", "model.adapter_injector", "model.adapter_extractor",
             "model.deform_attn", "model.adapter_out", "model.vit_window_attn",
             "model.vit_global_attn"}
    assert names <= set(seconds)
    assert counters["deform.attn_plain"] == 4 + 6
    vit, c_shapes, dh = (H // 16, W // 16), [(H // s, W // s) for s in (8, 16, 32)], 8
    n_c = sum(h * w for h, w in c_shapes)
    want = (4 * _sample_bytes(BATCH, vit[0] * vit[1], [vit], c_shapes, 4, dh, 4)
            + 6 * _sample_bytes(BATCH, n_c, c_shapes, [vit], 4, dh, 4))
    assert counters["deform.sample_bytes"] == want


def test_constants_are_buffers_built_once(pair, monkeypatch):
    port, _, _, x = pair
    bb = copy.deepcopy(port.backbone)
    buffers = dict(bb.named_buffers())
    assert not set(buffers) & set(bb.state_dict())
    assert {"pos_resize_h", "pos_resize_w", "ref_vit_num", "ref_vit_den", "ref_c_num",
            "ref_c_den", "interactions.0.injector.attn.normalizer"} <= set(buffers)
    assert buffers["interactions.0.injector.attn.normalizer"].tolist() == [[28, 20], [14, 10],
                                                                          [7, 5]]
    with torch.no_grad():
        first = bb(x)

        def built_again(*args):
            raise AssertionError("a constant was built again")

        monkeypatch.setattr(va, "centres", built_again)
        monkeypatch.setattr(va, "cubic_resize_matrix", built_again)
        again = bb(x)
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))
    half = copy.deepcopy(bb).to(torch.bfloat16)
    assert half.ref_c_num.dtype == torch.int32 and torch.equal(half.ref_c_num, bb.ref_c_num)
    with pytest.raises(ValueError, match="grids are built for"):
        bb(x[:, :-32])
    with pytest.raises(RuntimeError, match="inference only"):
        bb.train()(x)


def test_init_random_weights_draws_the_adapters_own_rows():
    model = va.ViTAdapter(**{k: v for k, v in SMALL.items() if k != "type"})
    init_random_weights(model, torch.Generator().manual_seed(0))
    bn = model.spm.stem[1]
    assert [t.unique().tolist() for t in (bn.weight, bn.bias, bn.running_mean,
                                          bn.running_var)] == [[1.0], [0.0], [0.0], [1.0]]
    assert model.interactions[2].injector.gamma.unique().tolist() == [1.0]
    assert 0.8 < model.level_embed.std().item() < 1.2
    out = torch.cat([n.weight for n in (model.norm1, model.norm2, model.norm3, model.norm4)])
    assert 0.2 < out.std().item() < 0.3
    assert [t.unique().tolist() for t in (model.norm4.bias, model.norm4.running_mean,
                                          model.norm4.running_var)] == [[0.0], [0.0], [1.0]]


def test_init_detector_serves_the_adapter(pair):
    cfg = _small_cfg(img_size=(H, H))
    state = _state(cfg)
    ref = ref_model.build(cfg).eval()
    ref.load_state_dict(state, strict=True)
    eng = init_detector(Config({"model": cfg["model"], "scale_factor": 1.0}), None,
                        batch_size=BATCH, device="cpu", device_preprocess=True,
                        compact_masks=True, scale_factor=1.0, tile_size=H)
    assert type(eng.model.backbone) is va.ViTAdapter and type(eng.model.neck) is FPN
    eng.model.load_state_dict(state, strict=True)
    tiles = traffic.tiles(np.random.RandomState(SEED + 1), BATCH, H)
    got = eng.collect(eng.dispatch(tiles))
    want = ref_model.split_results({k: v.numpy() for k, v in ref_model.detect(
        ref, torch.from_numpy(np.stack(tiles)), 1.0).items()}, BATCH)
    assert all(len(w["scores"]) > 0 for w in want)
    assert check.unmatched(got, want)[0] == 0.0


def test_published_widths_build_the_reference_keys():
    cfg = _bench_cfg("vitadapter-b-nucls")
    with torch.device("meta"):
        port = build_detector(cfg["model"], None, cfg["scale_factor"])
        skeleton = ref_model.build(cfg)
    bb = port.backbone
    assert type(bb) is va.ViTAdapter and type(port.neck) is FPN
    assert [blk.window_size for blk in bb.blocks] == [14, 14, 0] * 4
    assert [it.extra_extractors is not None for it in bb.interactions] == [False] * 3 + [True]
    assert bb.c_shapes == [(128, 128), (64, 64), (32, 32)] and bb.vit_shape == (64, 64)
    assert bb.interactions[0].injector.attn.sampling_offsets.out_features == 12 * 3 * 4 * 2
    assert bb.interactions[0].extractor.ffn.fc1.out_features == 192
    assert bb.interactions[0].extractor.attn.value_proj.out_features == 384
    assert port.rpn_head.rpn_conv.in_channels == 64
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in skeleton.state_dict().items()}


# -- every configuration that was there before builds as it did --------------

def _configs():
    """(name, model config, test config, scale factor, Swin kernel tier)."""
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "nuhtc", "*.py"))):
        cfg = Config.fromfile(path)
        out.append((os.path.basename(path), cfg.model, cfg.model.get("test_cfg"),
                    float(cfg.get("scale_factor", 2.0)), "block"))
    for name in ("nuhtc-pannuke", "maskrcnn-nucls", "vitdet-b-nucls"):
        cfg = _bench_cfg(name)
        out.append((name, cfg["model"], cfg["model"].get("test_cfg"), cfg["scale_factor"],
                    cfg["swin_kernel"]))
    return out


def _digest(model_cfg, test_cfg, scale, tier) -> dict:
    model = build_detector(model_cfg, test_cfg, scale, swin_kernel=tier)
    init_random_weights(model, torch.Generator().manual_seed(0))
    keys, values = hashlib.sha256(), hashlib.sha256()
    state = sorted(model.state_dict().items())
    for key, t in state:
        keys.update(f"{key} {tuple(t.shape)} {t.dtype};".encode())
        values.update(t.detach().contiguous().numpy().tobytes())
    return {"type": type(model.backbone).__name__, "tensors": len(state),
            "keys_shapes_sha256": keys.hexdigest(), "values_sha256": values.hexdigest()}


@pytest.mark.parametrize("name", [c[0] for c in _configs()])
def test_existing_configs_build_as_before(name):
    want = common.load_json(GOLDEN)[name]
    _, model_cfg, test_cfg, scale, tier = next(c for c in _configs() if c[0] == name)
    assert _digest(model_cfg, test_cfg, scale, tier) == want


if __name__ == "__main__":
    with open(GOLDEN, "w") as f:
        json.dump({c[0]: _digest(*c[1:]) for c in _configs()}, f, indent=1, sort_keys=True)
        f.write("\n")
