"""The CoNSeP metric suite (``compute_stats``: HoVer-Net's type and instance
statistics over .mat maps)."""
