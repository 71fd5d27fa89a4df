"""Tensor ops of the port; the kernel wrappers live in window_block (K1, K2),
components (K3), roi_align (K4) and vit_attention (the ViT's attention)."""
