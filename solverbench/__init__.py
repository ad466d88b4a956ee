"""The benchmark of pflare_tpu_torch on one NVIDIA H100 (see run.py)."""
