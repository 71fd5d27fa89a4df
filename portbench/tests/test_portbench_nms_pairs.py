"""``slide.nms_pair_share`` on a constructed tile: three masks, two of
them with boxes that meet, through the port's ``postprocess_tile`` with the
spans on. The counters read one pair met of three, and the metric 33.3 %."""

import numpy as np
import pytest

from nuhtc_tpu_torch.utils import profiling
from nuhtc_tpu_torch.wsi import infer
from portbench.harness.common import metric_reader


def test_nms_pair_share_on_three_masks(monkeypatch):
    masks = np.zeros((3, 32, 32), np.uint8)
    masks[0, 2:8, 2:8] = 1
    masks[1, 6:12, 7:13] = 1  # shares rows 6-7 of column 7 with mask 0
    masks[2, 20:28, 20:28] = 1
    res = dict(boxes=np.asarray([[2, 2, 8, 8], [7, 6, 13, 12], [20, 20, 28, 28]], np.float32),
               scores=np.asarray([0.9, 0.8, 0.7], np.float32),
               labels=np.zeros(3, np.int64), masks=masks)
    with profiling.spans():
        conts, *_ = infer.postprocess_tile(res, (0, 0), 32, infer.TilePostprocessConfig())
        counters = dict(profiling.COUNTERS)
    assert len(conts) == 3  # IoU 2 / 70: none suppressed
    assert counters["wsi.nms_pairs"] == 1 and counters["wsi.nms_pairs_all"] == 3
    monkeypatch.setattr(profiling, "SECONDS", {"engine.dispatch": 1.0})
    monkeypatch.setattr(profiling, "COUNTERS", counters)
    assert metric_reader("slide.nms_pair_share")({"trace": {"tiles": 1}}) == pytest.approx(
        100 / 3)
