"""Component proposals and K3 of the PyTorch port against the JAX package.

All comparisons are exact: the labels, the roots, the proposal boxes, and
K3's plain version against both the Pallas kernel (interpret mode) and the
XLA ``boxes_from_roots``. The spiral needs more propagation than the
bounded schedule (2 scan rounds, then ≤ 24×8 steps) allows, so it also pins
that the port stops where JAX stops.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.ops import components as jc
from nuhtc_tpu.ops.components_pallas import boxes_from_roots_pallas_batched
from nuhtc_tpu_torch.ops import components as tc
from torch_port_util import f32, n, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

SIZE = 64


def _blobs(rng, b=2, size=SIZE, count=14):
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((b, size, size), bool)
    for i in range(b):
        for _ in range(count):
            cy, cx = rng.randint(0, size, 2)
            r = rng.randint(2, 7)
            mask[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return mask


def _spiral(size=SIZE):
    """A one-pixel-wide square spiral corridor, walls two pixels apart."""
    m = np.zeros((size, size), bool)
    top, left, bottom, right = 0, 0, size - 1, size - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = True
        m[top:bottom + 1, right] = True
        if bottom - top >= 2:
            m[bottom, left:right + 1] = True
        if right - left >= 4:
            m[top + 2:bottom + 1, left] = True
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
        if top <= bottom and left <= right:
            m[top - 1, left] = True  # connect to the next ring
    return m


@pytest.fixture(scope="module")
def masks():
    blobs = _blobs(np.random.RandomState(0))
    return {"blobs": blobs, "spiral": np.stack([_spiral(), _spiral().T])}


@pytest.mark.parametrize("kind", ["blobs", "spiral"])
def test_labels_and_roots_match_jax(masks, kind):
    mask = masks[kind]
    got = tc.label_components_raw(t(mask))
    want = np.asarray(jax.jit(jax.vmap(jc.label_components_raw))(jnp.asarray(mask)))
    np.testing.assert_array_equal(n(got), want)
    if kind == "spiral":
        # the bounded schedule stops short of the fixpoint: several labels
        assert len(np.unique(want[0][mask[0]])) > 1

    roots, valid = tc.first_roots(got, t(mask), 128)
    wr, wv = jax.jit(jax.vmap(lambda lab, m: jc.first_roots(lab, m, 128, 96)))(
        jnp.asarray(want), jnp.asarray(mask))
    np.testing.assert_array_equal(n(roots), np.asarray(wr))
    np.testing.assert_array_equal(n(valid), np.asarray(wv))


@pytest.mark.parametrize("kind", ["blobs", "spiral"])
def test_component_stats_plain_matches_pallas_and_xla(masks, kind):
    mask = masks[kind]
    lab = tc.label_components_raw(t(mask))
    roots, _ = tc.first_roots(lab, t(mask), 128)
    roots = roots.clone()
    roots[:, -2] = SIZE * SIZE // 2 + 1  # an id that owns no pixel
    roots[:, -1] = roots[:, 0]  # a duplicate
    boxes, areas = tc.component_stats_plain(lab, roots)
    lab_j, roots_j = jnp.asarray(n(lab)), jnp.asarray(n(roots))
    pb, pa = boxes_from_roots_pallas_batched(lab_j, roots_j, interpret=True)
    xb, xa = jax.vmap(jc.boxes_from_roots)(lab_j, roots_j)
    for wb, wa in ((pb, pa), (xb, xa)):
        np.testing.assert_array_equal(n(boxes), np.asarray(wb))
        np.testing.assert_array_equal(n(areas), np.asarray(wa))
    # the CPU wrapper takes the plain version
    kb, ka = tc.component_stats(lab, roots)
    assert torch.equal(kb, boxes) and torch.equal(ka, areas)


def test_component_proposals_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 16, 16).astype(np.float32) * 2.0 + 0.5
    got_boxes, got_valid = tc.component_proposals_batched(t(logits), (SIZE, SIZE))
    with f32():
        want_boxes, want_valid = jax.jit(
            lambda x: jc.component_proposals_batched(x, (SIZE, SIZE)))(jnp.asarray(logits))
    assert int(np.asarray(want_valid).sum()) > 2
    np.testing.assert_array_equal(n(got_valid), np.asarray(want_valid))
    np.testing.assert_array_equal(n(got_boxes), np.asarray(want_boxes))
