"""The readers of the ViT attention kernel's metrics
(``metrics/forward.vit_attn_fused_share.py``,
``metrics/forward.vit_attn_roofline.py``): null without the counters or
the kernel, the share's arithmetic, and the roofline's work for the cell's
configuration written out by hand."""

import pytest

from portbench.harness import common
from portbench.work.roofline import PEAK_BF16, PEAK_BYTES

CELL = "vitdet-b-nucls-forward-b8"


def _ctx(kernel_s=None, batches=12, config="vitdet-b-nucls"):
    cfg = common.config(common.benchmark(), config)
    tr = {"batches": batches, "kernel_s": dict(kernel_s or {})}
    return {"cfg": cfg, "traffic": {"batch": 8}, "trace": tr}


def test_share_reads_nothing_without_the_counters(monkeypatch):
    read = common.metric_reader("forward.vit_attn_fused_share")
    swin = ({"engine.dispatch": 1.0}, {"nms.rounds": 3})
    for got in (swin, None):
        monkeypatch.setitem(read.__globals__, "totals", lambda got=got: got)
        assert read(_ctx()) is None


@pytest.mark.parametrize("fused,plain,want", [(48, 0, 100.0), (0, 48, 0.0), (36, 12, 75.0),
                                              (1, 2, 100.0 / 3)])
def test_share_is_fused_over_all_calls(monkeypatch, fused, plain, want):
    read = common.metric_reader("forward.vit_attn_fused_share")
    counters = {"vit.attn_fused": fused, "vit.attn_plain": plain}
    counters = {k: v for k, v in counters.items() if v}
    monkeypatch.setitem(read.__globals__, "totals",
                        lambda: ({"engine.dispatch": 1.0}, counters))
    assert read(_ctx()) == pytest.approx(want)


def test_roofline_reads_nothing_without_the_kernel():
    read = common.metric_reader("forward.vit_attn_roofline")
    assert read(_ctx({"elementwise_kernel_128": 1.0, "cunn_SoftMaxForward": 2.0})) is None
    assert read({**_ctx(), "trace": None}) is None
    swin = _ctx({"vit_attention_kernel<2>": 1.0}, config="maskrcnn-nucls")
    assert read(swin) is None


def test_roofline_work_of_the_cell_by_hand():
    """ViTDet-B at 1024²: 64² tokens, 12 heads of 64, width 768, B8. Four
    global blocks of 4,096 tokens: 4·8·12·4096²·64 FLOP, q, k, v and the
    output 4·8·4096·768 bf16 values: operations bound. Eight window blocks
    of 25 windows (64 padded to 70, 5²) of 196 tokens: 4·8·25·12·196²·64
    FLOP against 4·8·25·196·768 bf16 values: bytes bound."""
    read = common.metric_reader("forward.vit_attn_roofline")
    g = read.__globals__
    ctx = _ctx()
    work = g["attention_work"](ctx["cfg"]["model"]["backbone"], 8)
    glob = (4.0 * 8 * 12 * 4096 ** 2 * 64, 4 * 8 * 4096 * 768 * 2)
    win = (4.0 * 8 * 25 * 12 * 196 ** 2 * 64, 4 * 8 * 25 * 196 * 768 * 2)
    assert work == [win, win, glob, win, win, glob, win, win, glob, win, win, glob]
    assert glob[0] / PEAK_BF16 > glob[1] / PEAK_BYTES and win[1] / PEAK_BYTES > win[0] / PEAK_BF16
    least = 4 * glob[0] / PEAK_BF16 + 8 * win[1] / PEAK_BYTES
    assert g["bound_s"](ctx["cfg"], 8) == pytest.approx(least)
    # 12 traced batches whose kernel time is four times the least time: 25 %
    t = 12 * 4 * least
    assert read(_ctx({"void vit_attention_kernel<2>(...)": 0.75 * t,
                      "void vit_attention_kernel<1>(...)": 0.25 * t})) == pytest.approx(25.0)


def test_both_metrics_are_declared_for_the_cell_alone():
    bench = common.benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in ("forward.vit_attn_fused_share", "forward.vit_attn_roofline"):
        m = names[name]
        assert m["workloads"] == [CELL] and m["moves"] == "forward_img_per_s"
        assert m["layer"] == names["forward.vit_score_gb_per_batch"]["layer"]
