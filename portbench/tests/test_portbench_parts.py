"""Backbones and necks as parts looked up by type
(``reference/parts/<type>.py``): the two configurations' weights, drawn
through each module's ``INIT``, are bit for bit those the harness drew
before the parts existed; a backbone and a neck of a new type, written as
files alone, are built, given weights and counted; an unknown type names
the file it lacks."""

import hashlib
import os
import re
import textwrap

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import common, weights
from portbench.reference import model as ref_model
from portbench.work import flops, roofline

# sha256 over (name, shape, bf16 bits) of each entry of weights.make at the
# configuration's weights_seed on the CPU, as drawn before the parts existed
DIGESTS = {
    "nuhtc-pannuke": "d5e3525e81683c5b40d8e1c9a4005b58adedbfedc8b30753a3e711072358ba8c",
    "maskrcnn-nucls": "2450bc7c15b03212a780bc69e4615e97c6a11b6fe243c068aeace9df39bb9976",
}

TOY_BACKBONE = '''
    """A conv backbone: a stride-4 stem scaled by a bare gain, then three
    stride-2 convs; four maps of ``dim`` channels at strides 4 to 32."""
    import torch
    from torch import nn


    class ToyConvNet(nn.Module):
        INIT = {"gain": 0.02}

        def __init__(self, in_channels, dim):
            super().__init__()
            self.stem = nn.Conv2d(in_channels, dim, 4, stride=4)
            self.gain = nn.Parameter(torch.zeros(dim))
            self.downs = nn.ModuleList(nn.Conv2d(dim, dim, 3, stride=2, padding=1)
                                       for _ in range(3))

        def forward(self, img):
            x = self.stem(img.permute(0, 3, 1, 2)) * (1.0 + self.gain[:, None, None])
            outs = [x]
            for down in self.downs:
                x = down(x)
                outs.append(x)
            return tuple(o.permute(0, 2, 3, 1) for o in outs)


    def build(spec, in_channels):
        return ToyConvNet(in_channels, spec["dim"]), [spec["dim"]] * 4


    def flops(spec, side, in_channels):
        c, s = spec["dim"], side // 4
        total = 2.0 * s * s * in_channels * c * 16
        for _ in range(3):
            s = (s + 1) // 2
            total += 2.0 * s * s * c * c * 9
        return total
'''

TOY_NECK = '''
    """A neck of one 1x1 conv, shared by every level."""
    from torch import nn

    from portbench.reference.model import conv_nhwc


    class ToyNeck(nn.Module):
        def __init__(self, in_channels, out_channels):
            super().__init__()
            self.conv = nn.Conv2d(in_channels, out_channels, 1)

        def forward(self, feats):
            return tuple(conv_nhwc(self.conv, f) for f in feats)


    def build(spec, in_channels):
        return ToyNeck(in_channels[0], spec["out_channels"]), [spec["out_channels"]] * 4


    def flops(spec, side, in_channels):
        total, s = 0.0, side // 4
        for c in in_channels:
            total += 2.0 * s * s * c * spec["out_channels"]
            s = (s + 1) // 2
        return total
'''


def _cfg(name):
    return common.config(common.benchmark(), name)


def _digest(sd):
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().view(torch.int16).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(DIGESTS))
def test_weights_are_the_draws_of_before_the_parts(config):
    cfg = _cfg(config)
    sd = weights.make(cfg, cfg["weights_seed"], torch.device("cpu"), torch.bfloat16)
    assert _digest(sd) == DIGESTS[config]


@pytest.fixture
def toy_cfg(tmp_path, monkeypatch):
    """The Mask R-CNN configuration on a toy backbone and neck whose part
    files are the only ones in the parts directory."""
    (tmp_path / "ToyConvNet.py").write_text(textwrap.dedent(TOY_BACKBONE))
    (tmp_path / "ToyNeck.py").write_text(textwrap.dedent(TOY_NECK))
    monkeypatch.setattr(ref_model, "PARTS_DIR", str(tmp_path))
    cfg = dict(_cfg("maskrcnn-nucls"), tile=64, scale_factor=1.0)
    model = dict(cfg["model"], rpn_nms_pre=128, rpn_max_per_img=64, rcnn_max_per_img=16,
                 nms_candidates=128, neck={"type": "ToyNeck", "out_channels": 16})
    model["backbone_cfg"] = {"type": "ToyConvNet", "dim": 8}
    cfg["model"] = model
    return cfg


def test_toy_parts_are_built_drawn_and_counted(toy_cfg):
    model = ref_model.build(toy_cfg).eval()
    assert type(model.backbone).__name__ == "ToyConvNet"
    assert type(model.neck).__name__ == "ToyNeck"
    with torch.device("meta"):
        skeleton = ref_model.build(toy_cfg)
    assert ("backbone.gain", (8,), 0.02) in weights._rule(skeleton)
    sd = weights.make(toy_cfg, 3, torch.device("cpu"), torch.float32)
    assert sd["backbone.gain"].abs().max() > 0
    assert {"neck.conv.weight", "backbone.stem.weight"} <= set(sd)
    model.load_state_dict(sd, strict=True)
    tiles = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (2, 64, 64, 3), np.uint8))
    det = ref_model.detect(model, tiles, toy_cfg["scale_factor"])
    assert det["label_map"].shape == (2, 64, 64)
    side = roofline.input_side(toy_cfg)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.neck(model.backbone(torch.zeros(1, side, side, 3)))
    count = flops.count(toy_cfg)
    assert count["parts"]["backbone_fpn"] == fc.get_total_flops() == flops.feats_flops(
        toy_cfg, side)


@pytest.mark.parametrize("entry", ["build", "weights", "flops"])
def test_unknown_type_names_the_missing_file(entry):
    cfg = _cfg("nuhtc-pannuke")
    cfg["model"] = dict(cfg["model"], neck=dict(cfg["model"]["neck"], type="NoSuchNeck"))
    call = {"build": lambda: ref_model.build(cfg),
            "weights": lambda: weights.make(cfg, 0, torch.device("cpu"), torch.float32),
            "flops": lambda: flops.count(cfg)}[entry]
    path = os.path.join(ref_model.PARTS_DIR, "NoSuchNeck.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        call()
