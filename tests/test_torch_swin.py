"""Swin backbone and K1 of the PyTorch port against the JAX package.

- The port's ``SwinTransformer`` (plain path: exact softmax, erf GELU)
  against JAX's XLA path in f32, padding and shifted windows included:
  atol 1e-4.
- In training mode with stochastic depth (rate 0.3, rising over the blocks
  as ``np.linspace``): the same output as JAX's ``deterministic=False``
  path when both take the same keep masks (``jax.random.bernoulli`` and the
  port's ``swin.keep_mask`` patched to hand out one table), atol 1e-4; the
  port raises without a generator and is the identity in eval mode.
- K1's plain twin ``window_block_plain`` against the Pallas kernel
  ``window_block_fused`` in interpret mode at the shapes of
  test_fused_attention.py (ws 4, C 16, 2 heads, 6×7 map padded to 8×8,
  shift 0 and 2), with that test's atol of 0.06.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.models.swin import SwinBlock as JaxSwinBlock
from nuhtc_tpu.models.swin import SwinTransformer as JaxSwin
from nuhtc_tpu.models.swin import _rel_position_index
from nuhtc_tpu.ops.window_attention_pallas import window_block_fused
from nuhtc_tpu_torch.models import swin as port_swin
from nuhtc_tpu_torch.models.swin import SwinTransformer
from nuhtc_tpu_torch.ops.window_block import window_block, window_block_plain
from torch_port_util import f32, n, port_sd, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

CFG = dict(embed_dims=16, depths=(2, 2), num_heads=(2, 4), window_size=4)


def test_swin_matches_jax_xla_path():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 44, 36, 3).astype(np.float32)
    jsw = JaxSwin(**CFG, drop_path_rate=0.0, out_indices=(0, 1))
    with f32():
        variables = jax.jit(jsw.init)(jax.random.PRNGKey(0), jnp.asarray(img))
        want = jax.jit(jsw.apply)(variables, jnp.asarray(img))
    model = SwinTransformer(**CFG, out_indices=(0, 1)).eval()
    model.load_state_dict(port_sd("backbone", variables, "backbone."), strict=True)
    with torch.no_grad():
        got = model(t(img))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0)


def _block_case(shift: bool):
    """Inputs of test_fused_attention.test_block_fused_tiny, both layouts."""
    ws, c, nh = 4, 16, 2
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(1, 6, 7, c).astype(np.float32) * 0.5)
    blk = JaxSwinBlock(dim=c, num_heads=nh, window_size=ws, shift=shift,
                       fused_attention=False, dtype=jnp.float32)
    prm = blk.init(jax.random.PRNGKey(1), x, True)["params"]
    n1 = prm["norm1"]
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    h1 = (x - mu) * jax.lax.rsqrt(var + 1e-5) * n1["scale"] + n1["bias"]
    s = ws // 2 if shift else 0
    pad = ((0, 0), (0, 2), (0, 1), (0, 0))
    xp, h1p = jnp.pad(x, pad), jnp.pad(h1, pad)
    if s:
        xp = jnp.roll(xp, (-s, -s), axis=(1, 2))
        h1p = jnp.roll(h1p, (-s, -s), axis=(1, 2))
    attn = prm["attn"]
    idx = _rel_position_index(ws)
    bias49 = attn["relative_position_bias_table"][idx.reshape(-1)]
    bias49 = bias49.reshape(ws * ws, ws * ws, nh).transpose(2, 0, 1)
    jax_args = (xp, h1p, attn["qkv"]["kernel"], attn["qkv"]["bias"], attn["proj"]["kernel"],
                attn["proj"]["bias"], bias49, prm["norm2"]["scale"], prm["norm2"]["bias"],
                prm["ffn"]["fc1"]["kernel"], prm["ffn"]["fc1"]["bias"],
                prm["ffn"]["fc2"]["kernel"], prm["ffn"]["fc2"]["bias"])
    # the port takes weights in PyTorch's (out, in) layout
    kernels = {2, 4, 9, 11}
    torch_args = [t(np.asarray(a).T if i in kernels else np.asarray(a))
                  for i, a in enumerate(jax_args)]
    return jax_args, torch_args, dict(ws=ws, num_heads=nh, shift=s)


def test_drop_path_training_matches_jax(monkeypatch):
    rng = np.random.RandomState(1)
    img = rng.randn(3, 32, 28, 3).astype(np.float32)
    masks = [rng.rand(3, 1, 1, 1) < 0.75 for _ in range(8)]  # 4 blocks × 2 branches
    calls = {"jax": 0, "port": 0}

    def jax_bernoulli(key, p, shape):
        calls["jax"] += 1
        return jnp.asarray(masks[calls["jax"] - 1])

    def port_keep(gen, shape, keep, device):
        calls["port"] += 1
        return torch.from_numpy(masks[calls["port"] - 1]).to(device)

    jsw = JaxSwin(**CFG, drop_path_rate=0.3, out_indices=(0, 1))
    with f32():
        variables = jax.jit(jsw.init)(jax.random.PRNGKey(0), jnp.asarray(img))
        monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
        want = jsw.apply(variables, jnp.asarray(img), deterministic=False,
                         rngs={"dropout": jax.random.PRNGKey(1)})
    monkeypatch.setattr(port_swin, "keep_mask", port_keep)
    model = SwinTransformer(**CFG, drop_path_rate=0.3, out_indices=(0, 1))
    model.load_state_dict(port_sd("backbone", variables, "backbone."), strict=True)
    rates = [b.drop_path_rate for st in model.stages for b in st.blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 4))
    model.train()
    with torch.no_grad():
        got = model(t(img), torch.Generator())
        with pytest.raises(ValueError, match="Generator"):
            model(t(img))
    assert calls == {"jax": 6, "port": 6}  # the first block's rate is 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0)
    model.eval()
    with torch.no_grad():
        plain = model(t(img))
    assert not np.allclose(n(plain[1]), np.asarray(want[1]), atol=1e-3)


@pytest.mark.parametrize("shift", [False, True])
def test_block_twin_matches_pallas_interpret(shift):
    jax_args, torch_args, kw = _block_case(shift)
    want = window_block_fused(*jax_args, **kw, interpret=True)
    got = window_block_plain(*torch_args, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), atol=0.06)
    # the CPU wrapper takes the twin
    np.testing.assert_array_equal(n(window_block(*torch_args, **kw)), n(got))
