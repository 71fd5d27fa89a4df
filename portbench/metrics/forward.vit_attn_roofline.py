"""The ViT attention kernel's share of its roofline: the least time of one
batch's attention cores over the trace's ``vit_attention_kernel`` time a
batch. The work is q·kᵀ and attn·v at the true sequence lengths, read from
the configuration's backbone and the traffic's batch whatever implements
it: 4·B·heads·n²·hd FLOP a global block (n tokens of the image's grid) and
4·B·nW·heads·ws⁴·hd a window block (nW windows of ws² tokens over the grid
padded to a multiple of ws); the bytes are q, k, v and the output in bf16,
each once. No padding, bias or tile tail is counted. A launch's least time
is the larger of its FLOP at the bf16 peak and its bytes at the memory's.
None where the backbone is no ViT or the trace has no such kernel (a
program without it)."""

from portbench.harness.trace import kernel_seconds
from portbench.work.roofline import PEAK_BF16, bound_ms


def attention_work(backbone: dict, batch: int):
    """[(FLOP, bytes)] of one forward's attention cores, a block each."""
    side = backbone.get("img_size", 1024) // backbone.get("patch_size", 16)
    c = backbone.get("embed_dims", 768)
    heads = backbone.get("num_heads", 12)
    hd = c // heads
    ws = backbone.get("window_size", 0)
    windowed = set(backbone.get("window_block_indexes", ())) if ws > 0 else set()
    out = []
    for i in range(backbone.get("depth", 12)):
        if i in windowed:
            seqs, n = batch * (-(-side // ws)) ** 2, ws * ws
        else:
            seqs, n = batch, side * side
        out.append((4.0 * seqs * heads * n * n * hd, 4 * seqs * n * c * 2))
    return out


def bound_s(cfg: dict, batch: int) -> float:
    backbone = cfg["model"]["backbone"]
    return sum(bound_ms(f, PEAK_BF16, by)[0] for f, by in attention_work(backbone, batch)) * 1e-3


def read(ctx):
    tr = ctx["trace"]
    backbone = ctx["cfg"]["model"].get("backbone") or {}
    if not tr or backbone.get("type") != "ViT":
        return None
    t = kernel_seconds(tr, ("vit_attention_kernel",))
    if t <= 0:
        return None
    return 100.0 * bound_s(ctx["cfg"], ctx["traffic"]["batch"]) * tr["batches"] / t
