"""Share of the ViT backbone's attention calls that ran the hand kernel
(``ops/vit_attention.py``), in %: counter ``vit.attn_fused`` over
``vit.attn_fused`` + ``vit.attn_plain`` (``models/backbones.py
ViTAttention``) in the traced segment (``harness/spans.py``). None where the
program counts neither (no ViT, or a program without the counters)."""

from portbench.harness.spans import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    fused = got[1].get("vit.attn_fused", 0)
    plain = got[1].get("vit.attn_plain", 0)
    if fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)
