"""Device compute (counterpart of ``oryx_tpu/ops``): the streaming top-N
scan and the Lloyd sweep with their hand-written CUDA kernels, and ALS
training and fold-in and random-forest training in PyTorch ops.
"""
