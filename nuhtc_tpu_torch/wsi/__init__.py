"""Whole-slide inference: tissue segmentation, patch grid, streamed tile
inference, per-tile post-processing and the exporters."""
