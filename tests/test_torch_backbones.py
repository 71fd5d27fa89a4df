"""The alternative backbones and ViT_FPN of the PyTorch port against the JAX package.

Every module gets its weights from the JAX tree through
``state_dict_from_jax(..., family=...)``, with every leaf drawn from a seed
(the JAX initialisers leave the relative position tables at zero), and the
same input; JAX runs in f32 products. Tolerance: 1e-4 of the output's
largest magnitude.

- ``cubic_resize_matrix`` against ``jax.image.resize(..., "cubic")`` at the
  ViTDet sizes: the 14² pretrain grid grown to 32² (a 512² input) and shrunk
  to 10² and 7² (inputs below 224, the antialiased kernel);
- ``ViT`` with relative position, windowed and global blocks: its grid grown
  (14 → 32), shrunk (14 → 10) and at an odd side that pads its windows
  (13 tokens, window 4); ``ViTAttention`` on a 5×7 grid;
- ``SwinUnet`` (plain tier on the CPU) on a 44×36 input;
- ``ViT_FPN`` at a 6×7 input: the transposed convolutions' flip, and the
  stride-2 SAME padding, (0, 1) on the even side and (1, 1) on the odd one;
- the registries' names, and the state-dict round trip: every JAX leaf
  lands on a port key, no port key is left over, an unknown leaf raises.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.models.backbones import SwinUnet as JaxSwinUnet
from nuhtc_tpu.models.backbones import ViT as JaxViT
from nuhtc_tpu.models.backbones import ViTAttention as JaxViTAttention
from nuhtc_tpu.models.extra_heads import ViT_FPN as JaxViTFPN
from nuhtc_tpu.registry import BACKBONES as JAX_BACKBONES
from nuhtc_tpu.registry import NECKS as JAX_NECKS
from nuhtc_tpu_torch.models.backbones import (
    SwinUnet, ViT, ViTAttention, cubic_resize_matrix,
)
from nuhtc_tpu_torch.models.extra_heads import ViT_FPN
from nuhtc_tpu_torch.models.fpn import FPN  # noqa: F401  (registers the neck)
from nuhtc_tpu_torch.models.swin import SwinTransformer  # noqa: F401
from nuhtc_tpu_torch.registry import BACKBONES, NECKS
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_util import f32, n, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REL = 1e-4
# patch 2 over a 28² pretrain image: the 14² grid of ViTDet's 224 / 16
VIT = dict(patch_size=2, embed_dims=32, depth=3, num_heads=2, use_rel_pos=True, window_size=4,
           window_block_indexes=(0, 2), pretrain_img_size=28, out_every=1)
UNET = dict(embed_dims=16, depths=(2, 2), num_heads=(2, 4), window_size=4)


def _seeded(module, x, seed):
    """The module's JAX param tree (its shapes from ``eval_shape``) with
    every leaf drawn from ``seed`` (std 0.3)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), want, rtol=0, atol=REL * np.abs(want).max())


def _jax_apply(module, x, seed):
    x = jax.tree.map(jnp.asarray, x)
    params = _seeded(module, x, seed)
    with f32():
        out = jax.jit(module.apply)({"params": params}, x)
    return params, out


@pytest.mark.parametrize("grid,out", [(14, 32), (14, 10), (14, 7), (5, 13)])
def test_cubic_resize_matrix_is_jax_image_resize(grid, out):
    x = np.random.RandomState(grid + out).randn(1, grid, grid, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, out, out, 3), method="cubic")
    m = cubic_resize_matrix(grid, out)
    got = np.einsum("bhwc,hH,wW->bHWc", x, m, m)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("side", [64, 20, 26], ids=["grow14to32", "shrink14to10", "odd13"])
def test_vit_matches_jax(side):
    x = np.random.RandomState(side).randn(2, side, side, 3).astype(np.float32)
    params, want = _jax_apply(JaxViT(**VIT), x, seed=1)
    model = ViT(img_size=side, **VIT).eval()
    model.load_state_dict(state_dict_from_jax(params, family="vit"), strict=True)
    with torch.no_grad():
        got = model(t(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w)


def test_vit_attention_relative_position_on_a_non_square_grid():
    x = np.random.RandomState(3).randn(2, 5, 7, 32).astype(np.float32)
    mod = JaxViTAttention(dim=32, num_heads=4, use_rel_pos=True, input_size=(5, 7))
    params, want = _jax_apply(mod, x, seed=4)
    attn = ViTAttention(32, 4, use_rel_pos=True, input_size=(5, 7))
    sd = state_dict_from_jax({"block0": {"attn": params}}, family="vit")
    attn.load_state_dict({k[len("blocks.0.attn."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        _close(attn(t(x)), want)
    with pytest.raises(ValueError, match="do not fit"):
        attn(t(x[:, :4]))


def test_swin_unet_matches_jax():
    x = np.random.RandomState(5).randn(2, 44, 36, 3).astype(np.float32)
    params, want = _jax_apply(JaxSwinUnet(**UNET), x, seed=6)
    model = SwinUnet(**UNET).eval()
    model.load_state_dict(state_dict_from_jax(params, family="swin_unet"), strict=True)
    with torch.no_grad():
        got = model(t(x))
    assert [tuple(g.shape) for g in got] == [(2, 11, 9, 16), (2, 6, 5, 32)]
    for g, w in zip(got, want):
        _close(g, w)


def test_vit_fpn_matches_jax_at_an_even_and_an_odd_side():
    x = np.random.RandomState(7).randn(2, 6, 7, 32).astype(np.float32)
    params, want = _jax_apply(JaxViTFPN(out_channels=8), (x,), seed=8)
    neck = ViT_FPN(in_channels=32, out_channels=8).eval()
    neck.load_state_dict(state_dict_from_jax(params, family="vit_fpn"), strict=True)
    with torch.no_grad():
        got = neck((t(x),))
    assert [tuple(g.shape) for g in got] == [(2, 24, 28, 8), (2, 12, 14, 8), (2, 6, 7, 8),
                                             (2, 3, 4, 8)]
    for g, w in zip(got, want):
        _close(g, w)


def test_registries_hold_the_jax_names():
    for name in ("SwinTransformer", "ViT", "SwinUnet"):
        assert name in BACKBONES and name in JAX_BACKBONES
    for name in ("FPN", "ViT_FPN"):
        assert name in NECKS and name in JAX_NECKS
    assert BACKBONES.get("ViT") is ViT and NECKS.get("ViT_FPN") is ViT_FPN


@pytest.mark.parametrize("family", ["vit", "swin_unet", "vit_fpn"])
def test_state_dict_round_trip_uses_every_leaf(family):
    """The JAX tree's leaves map one to one onto the port module's keys and
    load strictly."""
    if family == "vit":
        jax_mod, port = JaxViT(**VIT), ViT(img_size=20, **VIT)
        x = jnp.zeros((1, 20, 20, 3))
    elif family == "swin_unet":
        jax_mod, port = JaxSwinUnet(**UNET), SwinUnet(**UNET)
        x = jnp.zeros((1, 32, 32, 3))
    else:
        jax_mod, port = JaxViTFPN(out_channels=8), ViT_FPN(32, 8)
        x = (jnp.zeros((1, 4, 4, 32)),)
    tree = _seeded(jax_mod, x, 9)
    sd = state_dict_from_jax(tree, family=family)
    leaves = jax.tree.leaves(tree)
    assert len(sd) == len(leaves)
    assert set(sd) == set(port.state_dict())
    assert sorted(v.numel() for v in sd.values()) == sorted(a.size for a in leaves)
    port.load_state_dict(sd, strict=True)
    bad = dict(tree)
    bad["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="no port key for extra/kernel"):
        state_dict_from_jax(bad, family=family)
    with pytest.raises(ValueError, match="family"):
        state_dict_from_jax(tree, family="resnet")
