"""Device compute (counterpart of ``oryx_tpu/ops``): the streaming top-N
scan and its hand-written CUDA kernels.
"""
