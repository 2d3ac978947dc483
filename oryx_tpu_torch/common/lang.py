"""Concurrency and class-loading helpers.

Rebuilds, from the reference's framework/oryx-common:
- AutoReadWriteLock (lang/AutoReadWriteLock.java): a reader-writer lock with
  context-manager acquire, guarding all in-memory model state.
- ExecUtils (lang/ExecUtils.java:32-121): bounded-parallelism helpers used
  for parallel hyperparameter candidates and partition scans.
- ClassUtils (lang/ClassUtils.java:24-130): instantiate user classes named
  in config — here by Python import path — trying a (Config) constructor
  first, then no-arg (reference BatchLayer.java:153-184 usage).
- JVMUtils ordered shutdown (lang/JVMUtils.java:26-60) via atexit.

Port note: a copy of ``oryx_tpu/common/lang.py`` (JAX-free), with its imports
pointed at ``oryx_tpu_torch``, plus ``check_port_module``, which the
layers use to refuse config-named classes of the JAX package.
"""

from __future__ import annotations

import atexit
import importlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, TypeVar

T = TypeVar("T")

__all__ = [
    "ReadWriteLock",
    "do_in_parallel",
    "collect_in_parallel",
    "load_instance_of",
    "close_at_shutdown",
]


class ReadWriteLock:
    """Writer-preference reader-writer lock with context managers.

    with lock.read():  ... shared ...
    with lock.write(): ... exclusive ...
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    class _Guard:
        def __init__(self, acquire: Callable[[], None], release: Callable[[], None]):
            self._acquire, self._release = acquire, release

        def __enter__(self):
            self._acquire()
            return self

        def __exit__(self, *exc):
            self._release()
            return False

    def read(self) -> "_Guard":
        return self._Guard(self._acquire_read, self._release_read)

    def write(self) -> "_Guard":
        return self._Guard(self._acquire_write, self._release_write)

    def _acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def _release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def _acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def _release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


def do_in_parallel(num_tasks: int, fn: Callable[[int], Any], parallelism: int = 1) -> None:
    """Run fn(0..num_tasks-1), at most `parallelism` at a time."""
    collect_in_parallel(num_tasks, fn, parallelism)


def collect_in_parallel(
    num_tasks: int, fn: Callable[[int], T], parallelism: int = 1
) -> list[T]:
    """Run fn(i) for i in range(num_tasks) with bounded parallelism and
    return results in index order. First raised exception propagates."""
    parallelism = max(1, min(parallelism, num_tasks)) if num_tasks else 1
    if parallelism == 1:
        return [fn(i) for i in range(num_tasks)]
    with ThreadPoolExecutor(max_workers=parallelism) as pool:
        return list(pool.map(fn, range(num_tasks)))


def load_class(name: str) -> type:
    """Resolve 'pkg.mod:Class' or 'pkg.mod.Class' to a class object."""
    if ":" in name:
        mod_name, cls_name = name.split(":", 1)
    else:
        mod_name, _, cls_name = name.rpartition(".")
        if not mod_name:
            raise ValueError(f"cannot resolve class name {name!r}")
    mod = importlib.import_module(mod_name)
    try:
        obj: Any = mod
        for part in cls_name.split("."):
            obj = getattr(obj, part)
        return obj
    except AttributeError as e:
        raise ImportError(f"no class {cls_name!r} in module {mod_name!r}") from e


def check_port_module(name: str, key: str) -> None:
    """Config must name the port's own modules: a class or resource under
    ``oryx_tpu`` would pull the JAX package into the process."""
    head = name.split(":", 1)[0].split(".", 1)[0]
    if head == "oryx_tpu":
        raise ValueError(
            f"{key} = {name!r} names the JAX package; the PyTorch port runs "
            f"{name.replace('oryx_tpu', 'oryx_tpu_torch', 1)!r}"
        )


def load_instance_of(name: str, *args: Any) -> Any:
    """Instantiate a config-named class, preferring ctor(*args) when the
    signature accepts it, else no-arg (ClassUtils.loadInstanceOf semantics,
    reference ClassUtils.java:59-95). Signature is checked up front so a
    TypeError raised *inside* a matching constructor propagates instead of
    being masked by a silent no-arg retry."""
    import inspect

    cls = load_class(name)
    if args:
        try:
            inspect.signature(cls).bind(*args)
        except TypeError:
            return cls()
        except ValueError:  # no introspectable signature (C types): just try
            pass
        return cls(*args)
    return cls()


_shutdown_lock = threading.Lock()
_closeables: list[Any] = []
_hook_registered = False


def close_at_shutdown(closeable: Any) -> None:
    """Register an object with .close() to be closed at interpreter exit,
    in reverse registration order (JVMUtils.closeAtShutdown analogue)."""
    global _hook_registered
    with _shutdown_lock:
        _closeables.append(closeable)
        if not _hook_registered:
            atexit.register(_run_shutdown)
            _hook_registered = True


def _run_shutdown() -> None:
    with _shutdown_lock:
        items = list(reversed(_closeables))
        _closeables.clear()
    for c in items:
        try:
            c.close()
        except Exception:  # pragma: no cover - best effort at exit
            pass
