"""The CoNIC metric suite (``compute_stats``: multi-PQ+, AJI, Dice, or the
multiclass R² of nucleus counts) and its patch extractor (``misc``)."""
