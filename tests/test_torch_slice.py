"""The whole patch-inference slice through both packages' entry points.

JAX: ``build_detector`` → ``.clone(exact_rois=True)`` → ``InferenceEngine``
(device preprocess + compact label maps). Port: ``init_detector`` with the
same config and the JAX params carried over by ``state_dict_from_jax``.
Same seeded uint8 blob tiles; detection sets must agree under
``torch_oracle.match_detections`` with the f32 gates of
test_full_scale_parity.py, and ≥ 99.9 % of label-map pixels must be equal.
"""

import numpy as np
import jax
import jax.numpy as jnp

from nuhtc_tpu.apis.inference import InferenceEngine
from nuhtc_tpu.config import Config
from nuhtc_tpu.models.build import build_detector
from nuhtc_tpu_torch.apis.inference import init_detector
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax
from torch_oracle import OracleArch, apply_sd, build_full_sd, match_detections
from torch_port_util import blob_tiles, f32
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

CONFIG = "configs/nuhtc/htc_lite_tiny_synthetic.py"
TILE = 64


def test_slice_matches_jax_engine():
    cfg = Config.fromfile(CONFIG)
    model = build_detector(cfg.model, cfg.model.get("test_cfg"), 1.0,
                           dtype=jnp.float32).clone(exact_rois=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, TILE, TILE, 3)), method="init_forward"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    arch = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=32)
    sd = build_full_sd(np.random.RandomState(0), arch)
    # centre the random semantic logits so the component branch proposes boxes
    sd["roi_head.semantic_head.conv_logits.bias"] += 2.0
    params = apply_sd(sd, template)

    tiles = blob_tiles(np.random.RandomState(1), 2, TILE, blobs=3)
    jax_engine = InferenceEngine(model, params, batch_size=2, tile_size=TILE,
                                 device_preprocess=True, compact_masks=True)
    with f32():
        want = jax_engine.run_batch(tiles)

    engine = init_detector(CONFIG, None, batch_size=2, tile_size=TILE, device="cpu",
                           device_preprocess=True, compact_masks=True)
    engine.model.load_state_dict(state_dict_from_jax(params), strict=True)
    got = engine.run_batch(tiles)

    total = 0
    for g, w in zip(got, want):
        total += len(w["scores"])
        pairs, un_got, un_want = match_detections(g, w, iou_thr=0.5)
        assert len(un_got) == 0 and len(un_want) == 0, (len(un_got), len(un_want))
        gi = np.asarray([p[0] for p in pairs], int)
        wi = np.asarray([p[1] for p in pairs], int)
        np.testing.assert_allclose(g["scores"][gi], w["scores"][wi], rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(g["boxes"][gi], w["boxes"][wi], rtol=1e-3, atol=5e-3)
        np.testing.assert_allclose(g["probs"][gi], w["probs"][wi], rtol=1e-3, atol=2e-4)
        lab_g = (g["masks"] * np.arange(1, len(g["masks"]) + 1)[:, None, None]).max(0)
        lab_w = (w["masks"] * np.arange(1, len(w["masks"]) + 1)[:, None, None]).max(0)
        # label ids follow detection order; compare through the matching
        remap = np.zeros(len(g["masks"]) + 1, int)
        remap[gi + 1] = wi + 1
        assert np.mean(remap[lab_g] == lab_w) >= 0.999
    assert total > 0
