"""Operator tools of the port (counterpart of the repo's ``tools/``
scripts): ``python -m oryx_tpu_torch.tools.fleet`` drives a serving
fleet under open-loop load, and ``python -m
oryx_tpu_torch.tools.crash_sweep`` kills the pipeline at every
crashpoint and audits its recovery."""
