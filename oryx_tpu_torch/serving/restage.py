"""Atomic local restage of MODEL-REF generation dirs.

A MODEL-REF update message names a *generation dir* in the registry
store (local path or ``gs://...``). Replicas that want the artifacts on
local disk — repeated resolves of a large model, side artifacts the
scan engine mmaps — restage the dir into a local cache. The restage is
a commit sequence of its own and must be crash-faithful: artifacts copy
into a hidden ``.stage-<generation>-<pid>`` temp dir (model.pmml last,
mirroring ``storage.upload_dir`` so a visible model.pmml implies its
siblings are complete, each file fsynced), and one atomic rename makes
the staged generation appear whole or not at all. A replica SIGKILLed
mid-download leaves only temp litter that ``repair()`` sweeps on the
next start — never a half-written model dir the server could load.

Enabled per layer with ``oryx.serving.restage-dir``; the serving layer
registers its stager process-wide (``set_active``) and
``app/pmml.read_pmml_from_update_message`` resolves MODEL-REFs through
it. The cache is keyed by generation id, so every replica in a process
(tools/fleet.py) shares one staged copy.

Port note: a copy of ``oryx_tpu/serving/restage.py`` (JAX-free), with
its imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from pathlib import Path

from oryx_tpu_torch.common import metrics, storage
from oryx_tpu_torch.common.crashpoints import crashpoint
from oryx_tpu_torch.registry.store import MODEL_FILE_NAME, generation_id_from_ref

log = logging.getLogger(__name__)

__all__ = ["ModelStager", "active", "set_active"]

_STAGE_MARKER = ".stage-"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - pid exists, other user
        return True
    return True


class ModelStager:
    """Downloads generation dirs into a local cache, atomically."""

    def __init__(self, stage_dir: str | Path) -> None:
        self.root = Path(stage_dir)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self.swept_on_open = self.repair()

    # -- cache ---------------------------------------------------------------

    def staged_path(self, generation_id: str) -> Path:
        return self.root / generation_id

    def is_staged(self, generation_id: str) -> bool:
        # the stage commit is atomic, so the presence of the dir (always
        # renamed complete, model.pmml included) is the whole check
        return (self.staged_path(generation_id) / MODEL_FILE_NAME).is_file()

    def stage(self, ref: str) -> Path | None:
        """Restage a MODEL-REF generation dir into the cache; returns the
        local dir, or None when the ref isn't registry-shaped / vanished
        (callers fall back to direct resolution). Idempotent and cheap
        once staged. Thread-safe within the process; cross-process races
        are benign (both writers stage identical bytes, last rename wins
        atomically)."""
        gen = generation_id_from_ref(ref)
        if gen is None:
            return None
        with self._lock:
            if self.is_staged(gen):
                metrics.registry.counter("serving.restage.hits").inc()
                return self.staged_path(gen)
            names = self._artifact_files(ref)
            if names is None:
                return None
            tmp = self.root / f"{_STAGE_MARKER}{gen}-{os.getpid()}"
            if tmp.exists():
                shutil.rmtree(tmp)
            try:
                # model.pmml LAST (upload_dir's ordering contract): a
                # kill mid-copy can never leave a readable model whose
                # side artifacts are missing
                names.sort(key=lambda rel: (rel.split("/")[-1] == MODEL_FILE_NAME, rel))
                for k, rel in enumerate(names):
                    if rel.split("/")[-1] == MODEL_FILE_NAME:
                        crashpoint("serving.restage.mid")
                    dst = tmp.joinpath(*rel.split("/"))
                    dst.parent.mkdir(parents=True, exist_ok=True)
                    with storage.open_read(storage.join(ref, rel), "rb") as src, open(
                        dst, "wb"
                    ) as out:
                        shutil.copyfileobj(src, out)
                        out.flush()
                        os.fsync(out.fileno())
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            crashpoint("serving.restage.pre-commit")
            final = self.staged_path(gen)
            if final.exists():  # lost a cross-process race; theirs is whole
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                os.rename(tmp, final)
            storage.fsync_dir(self.root)
            metrics.registry.counter("serving.restage.staged").inc()
            log.info("restaged generation %s (%d files) from %s", gen, len(names), ref)
            return final

    def _artifact_files(self, ref: str) -> list[str] | None:
        """Relative paths of every file under the generation dir."""
        if storage.is_remote(ref):
            import fsspec

            fs, path = fsspec.core.url_to_fs(ref)
            if not fs.exists(path):
                return None
            base = path.rstrip("/")
            return [
                p[len(base) :].lstrip("/")
                for p in fs.find(base)
            ]
        d = storage.local_path(ref)
        if not d.is_dir():
            return None
        return [p.relative_to(d).as_posix() for p in d.rglob("*") if p.is_file()]

    # -- repair --------------------------------------------------------------

    def repair(self) -> int:
        """Sweep ``.stage-*`` temp dirs left by dead stagers (kill mid-
        download). Counted on ``serving.restage.swept``."""
        removed = 0
        for p in self.root.iterdir():
            if not (p.is_dir() and p.name.startswith(_STAGE_MARKER)):
                continue
            try:
                pid = int(p.name.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                continue
            if pid == os.getpid() or _pid_alive(pid):
                continue
            shutil.rmtree(p, ignore_errors=True)
            removed += 1
            log.warning("restage repair: swept dead staging dir %s", p)
        if removed:
            metrics.registry.counter("serving.restage.swept").inc(removed)
        return removed


# -- process-wide hook (read by app/pmml.read_pmml_from_update_message) ------

_active: ModelStager | None = None


def active() -> ModelStager | None:
    return _active


def set_active(stager: ModelStager | None) -> None:
    global _active
    _active = stager
