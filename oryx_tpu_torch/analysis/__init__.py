"""oryxlint for the port (counterpart of ``oryx_tpu/analysis``).

Run it as ``python -m oryx_tpu_torch.analysis`` or ``python -m
oryx_tpu_torch lint``. Passes: the lockset race detector, the
lock-order analyzer (static half of the common/locks.py runtime
watchdog), the resource-lifecycle and crash-durability passes, the
torch hot-path hygiene pass (``torchhot``, in place of the JAX
package's ``jaxhot``), and the four repo lints (config-keys, registry,
deploy, metrics). The rules are the JAX package's (its
docs/static-analysis.md); the pass catalog is in the README.
"""

from oryx_tpu_torch.analysis.core import (  # noqa: F401
    DEFAULT_BASELINE,
    AnalysisPass,
    Finding,
    RunResult,
    all_passes,
    load_baseline,
    main,
    register,
    run_passes,
    write_baseline,
)
