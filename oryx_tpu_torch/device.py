"""Where the port's tensors live (no counterpart in ``oryx_tpu``: JAX picks
its backend per process, the port picks a ``torch.device`` per call).

The port runs on CUDA. ``default_device()`` returns ``cuda`` and raises
when no CUDA device is present, unless the caller chose the CPU with
``set_device("cpu")`` — the tests do, to run the plain PyTorch version
of every kernel. Nothing picks the CPU silently: no environment variable
and no fallback.
"""

from __future__ import annotations

import contextlib

import torch

_chosen: torch.device | None = None


def set_device(device: str | torch.device | None) -> None:
    """Pin the device the port's entry points use when a call names none;
    ``None`` restores the default (CUDA, or an error without it)."""
    global _chosen
    _chosen = None if device is None else torch.device(device)


def chosen() -> torch.device | None:
    """The device ``set_device`` pinned, or None."""
    return _chosen


def default_device() -> torch.device:
    if _chosen is not None:
        return _chosen
    if not torch.cuda.is_available():
        raise RuntimeError(
            "oryx_tpu_torch runs on CUDA and no CUDA device is available; "
            "call oryx_tpu_torch.device.set_device('cpu') to run the plain "
            "PyTorch versions of its kernels on the CPU"
        )
    return torch.device("cuda")


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``, or the default when None."""
    return default_device() if device is None else torch.device(device)


@contextlib.contextmanager
def full_float32():
    """Scope TF32 off for the float32 products inside: the JAX package
    runs them at ``Precision.HIGHEST``, and a caller may have switched
    TF32 on for its own matmuls."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
