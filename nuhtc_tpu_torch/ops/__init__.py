"""Tensor ops of the port; the kernel wrappers live in window_block (K1, K2),
components (K3) and roi_align (K4)."""
