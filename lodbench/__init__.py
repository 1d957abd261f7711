"""The benchmark of simlod_tpu_torch on one CUDA card (see run.py)."""
