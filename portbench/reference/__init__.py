"""Plain references that decide ``correct``: float32 PyTorch with TF32 off,
written from the published algorithms. They import nothing of the program
and take nothing it made: only the inputs the drivers generate."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
