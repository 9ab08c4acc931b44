"""Diagnostic scripts of the port, run on a CUDA card as
``python3 -m tfqmrgpu_tpu_torch.tools.<name>``."""
