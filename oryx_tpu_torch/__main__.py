"""python -m oryx_tpu_torch — see oryx_tpu_torch.cli (counterpart of
``oryx_tpu/__main__.py``)."""

from oryx_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
