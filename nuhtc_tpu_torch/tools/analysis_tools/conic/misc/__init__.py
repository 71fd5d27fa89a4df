"""CoNIC preprocessing helpers (``patch_extractor``)."""
