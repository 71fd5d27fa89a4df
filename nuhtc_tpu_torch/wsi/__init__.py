"""Whole-slide inference: tissue segmentation, patch grid, streamed tile
inference, per-tile post-processing and the exporters; and the offline tools
after it: cross-tile merge, per-nucleus features, stain normalization and
score heatmaps."""
