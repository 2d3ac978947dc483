"""oryx_tpu_torch — the PyTorch/CUDA port of ``oryx_tpu``.

The port runs the lambda-architecture framework on an NVIDIA GPU: plain
tensor code is PyTorch, and every Pallas kernel of ``oryx_tpu`` on a
ported path is a CUDA kernel written by hand for Hopper
(``oryx_tpu_torch/csrc``). It imports neither jax nor any module of
``oryx_tpu``: what it needs of the JAX package's JAX-free modules it
keeps as its own copies. The modules mirror ``oryx_tpu``'s layout and
names, so each has an obvious counterpart.

Ported so far: the ALS, k-means and random-decision-forest lambda
loops, each as ``python -m oryx_tpu_torch batch|speed|serving`` on one
``file:`` bus: ALS training, fold-in and serving, k-means training, drift
and serving, forest training, leaf updates and serving; and the operator
surface around them: the open-loop load generator (``loadgen``), the
fleet harness and its autoscaler (``tools/fleet.py``,
``serving/autoscale.py``) and the CLI's operator commands; and the
multi-device layer (``parallel/``): meshes of explicit shards, their
collectives within a process and over ``torch.distributed``, sharded
ALS, k-means, forests and item scans, sub-mesh candidates and the
kernels' compile cache.
"""

__version__ = "0.1.0"
