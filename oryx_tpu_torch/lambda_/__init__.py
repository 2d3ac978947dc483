"""Lambda-tier runtimes (counterpart of ``oryx_tpu/lambda_``): the batch
layer (``batch.py``) and the speed layer (``speed.py``).
"""

from oryx_tpu_torch.lambda_.batch import BatchLayer  # noqa: F401
