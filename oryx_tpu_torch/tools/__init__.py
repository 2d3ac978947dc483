"""Operator tools of the port (counterpart of the repo's ``tools/``
scripts): ``python -m oryx_tpu_torch.tools.fleet`` drives a serving
fleet under open-loop load."""
