"""ML tier: the batch-training harness with hyperparameter search
(counterpart of ``oryx_tpu/ml``).
"""

from oryx_tpu_torch.ml.param import (  # noqa: F401
    HyperParamValues,
    fixed,
    range_param,
    around,
    unordered,
    from_config,
    choose_hyper_parameter_combos,
    choose_values_per_hyper_param,
)
from oryx_tpu_torch.ml.update import MLUpdate  # noqa: F401
