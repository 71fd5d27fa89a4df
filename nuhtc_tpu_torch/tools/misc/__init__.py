"""The port's miscellaneous command lines (tools/misc of the JAX package):
``browse_dataset`` (the train pipeline's samples drawn as PNGs),
``make_synthetic_pannuke`` (a synthetic PanNuke release, byte-equal to the
JAX tool's) and ``run_e2e_golden`` (the end-to-end chain over it and its
golden summary), each run as ``python -m nuhtc_tpu_torch.tools.misc.<name>``."""
