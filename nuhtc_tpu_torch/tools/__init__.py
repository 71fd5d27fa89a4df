"""Command lines of the port (``test``, ``infer``, ``infer_patch``,
``image_demo``, ``feat_map``, ``preprocess_pannuke``, ``infer_wsi``,
``nuclei_merge``, ``wsi_feat_extract``, ``nuclei_feat_extract``,
``extract_features_nuhtc``) and its measurement scripts (run on a CUDA
device)."""
