"""ASan/UBSan leg for the port's native library (counterpart of
tests/native/test_sanitizer.py).

The port's parse parity suite, its concurrent feature-store suite and
its tiered cell store suite re-run in a subprocess whose native library
(``oryx_tpu_torch/native``'s three sources) was compiled with
``-fsanitize=address,undefined``. A heap overflow, a use-after-free or
undefined behaviour in ``parse.cpp`` or ``feature_store.cpp`` aborts that
subprocess and fails here with the sanitizer's report.

The subprocess gets ``LD_PRELOAD=<libasan.so>`` (a sanitized .so loaded
into an uninstrumented CPython needs the runtime first),
``ASAN_OPTIONS=detect_leaks=0`` (CPython itself is not leak-clean) and
``ORYX_NATIVE_SANITIZE=1`` (the port's loader takes the sanitized
build). The JAX package's side of each parity case keeps that package's
production library, loaded before the switch is set: its loader writes
its sanitized build in place, and the JAX package's own sanitizer suite
may be building it at the same time. Cases that compile through XLA
stay out: XLA aborts under a preloaded ASan runtime, and the target is
the store.

Skips only where ``g++`` or the ASan runtime is absent.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")


@pytest.fixture(scope="module")
def sanitized_env():
    from oryx_tpu_torch import native

    if native.build_sanitized_library() is None:
        pytest.skip("sanitized native build unavailable")
    runtime = native.find_asan_runtime()
    if runtime is None:
        pytest.skip("libasan.so not found; cannot preload the ASan runtime")
    env = dict(os.environ)
    env.update({
        "LD_PRELOAD": runtime,
        "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
        "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
        "ORYX_NATIVE_SANITIZE": "1",
        "ORYX_NATIVE": "1",
        "JAX_PLATFORMS": "cpu",
    })
    return env


# each subprocess loads the JAX package's library first, with the
# sanitize switch unset, then sets it for the port's loader
_PRELUDE = """
import os, sys
from oryx_tpu import native as jax_native
os.environ.pop("ORYX_NATIVE_SANITIZE")
jax_native.get_library()
os.environ["ORYX_NATIVE_SANITIZE"] = "1"
"""


def _run(env, *pytest_args, timeout=600):
    runner = _PRELUDE + "import pytest\nsys.exit(pytest.main(sys.argv[1:]))\n"
    return subprocess.run(
        [sys.executable, "-c", runner, "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "no:xdist", "-rs", *pytest_args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
    )


def _assert_clean(proc, what):
    output = proc.stdout + proc.stderr
    assert proc.returncode == 0, f"sanitized {what} run failed:\n{output[-8000:]}"
    # belt and braces: a recovered (non-fatal) report still fails
    assert "ERROR: AddressSanitizer" not in output, output[-8000:]
    assert "runtime error:" not in output, output[-8000:]
    # the native cases ran: a silent fall back to Python would skip them
    assert "native library unavailable" not in output, output[-8000:]


def test_the_sanitized_library_is_what_loads(sanitized_env):
    """The port's side loads the instrumented build from its own _build/;
    the JAX package's side keeps its production library."""
    probe = subprocess.run(
        [sys.executable, "-c", _PRELUDE + "from oryx_tpu_torch import native\n"
         "print(jax_native.get_library()._name, native.get_library()._name)\n"],
        cwd=ROOT, env=sanitized_env, capture_output=True, text=True, timeout=300,
    )
    assert probe.returncode == 0, probe.stderr[-4000:]
    jax_path, port_path = map(Path, probe.stdout.split())
    assert port_path.name.startswith("liboryx_native_san_"), port_path
    assert port_path.parent == ROOT / "oryx_tpu_torch" / "_build"
    assert "_san_" not in jax_path.name, jax_path


def test_parse_parity_suite_clean_under_asan_ubsan(sanitized_env):
    """Every corpus block, the adversarial frames included, through both
    packages' instrumented parsers."""
    _assert_clean(_run(sanitized_env, "tests/test_torch_native_parse.py",
                       "-k", "corpus or empty_batch or list_input"), "parse parity")


def test_feature_store_suite_clean_under_asan_ubsan(sanitized_env):
    """The store suite: set/get/remove/pack under threads, hostile ids,
    the formatters past the buffer budget, parse_float_csv."""
    _assert_clean(_run(sanitized_env, "tests/test_torch_native_store.py"), "feature store")


def test_tier_store_suite_clean_under_asan_ubsan(sanitized_env):
    """The ts_* store: readers racing the prefetch worker and drop_ram
    churn over the mmap'd cold tier and the RAM LRU, residency, eviction
    and prefetch, TieredHostPlane's gathers, and the port's tiered IVF
    scan behind the batcher and the maintainer (the case that builds the
    JAX package's index stays out)."""
    _assert_clean(_run(sanitized_env, "tests/test_torch_tier_store.py",
                       "-k", "not scan_parity"),
                  "tier store")
