"""Lambda-tier runtimes (counterpart of ``oryx_tpu/lambda_``): the batch
layer. The speed layer is not ported yet.
"""

from oryx_tpu_torch.lambda_.batch import BatchLayer  # noqa: F401
