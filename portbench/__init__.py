"""The benchmark of oryx_tpu_torch, the PyTorch and CUDA port: one cell a
run, ``python3 -m portbench.run`` (README.md)."""
