"""Registry store: generation listing, CHAMPION pointer, retention GC.

A thin, stateless view over ``oryx.batch.storage.model-dir`` through
``common/storage``, so it works identically on a local filesystem and on
an object store (``gs://...``). Layout::

    model_dir/
      CHAMPION                  <- pointer file: JSON {"generation_id": ...}
      <timestampMs>/            <- one generation
        model.pmml
        manifest.json
        ...side artifacts (X/, Y/, ...)

The CHAMPION pointer is updated by atomic rename (``storage.write_text``
goes through temp+rename locally, temp+mv on object stores) so every
reader sees either the old champion or the new one, never a torn write.

Port note: a copy of ``oryx_tpu/registry/store.py`` (JAX-free),
with its imports pointed at ``oryx_tpu_torch``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time

from oryx_tpu_torch.common import metrics, storage
from oryx_tpu_torch.common.crashpoints import crashpoint
from oryx_tpu_torch.registry.manifest import MANIFEST_FILE_NAME, GenerationManifest

log = logging.getLogger(__name__)

CHAMPION_FILE_NAME = "CHAMPION"
MODEL_FILE_NAME = "model.pmml"

_GENERATION_RE = re.compile(r"^\d+$")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - pid exists, other user
        return True
    return True


def is_generation_id(name: str) -> bool:
    return bool(_GENERATION_RE.match(name))


def generation_id_from_ref(ref: str) -> str | None:
    """Parse the generation id out of a registry-resolvable MODEL-REF
    path (a generation dir, or a file directly under one). None when the
    path does not point into a registry layout."""
    parts = str(ref).rstrip("/").split("/")
    for name in reversed(parts):
        if is_generation_id(name):
            return name
    return None


class RegistryStore:
    """List/read generations and maintain the CHAMPION pointer."""

    def __init__(self, model_dir: str) -> None:
        self.model_dir = str(model_dir).rstrip("/")

    # -- paths ---------------------------------------------------------------

    def generation_dir(self, generation_id: str) -> str:
        return storage.join(self.model_dir, str(generation_id))

    def pmml_uri(self, generation_id: str) -> str:
        return storage.join(self.generation_dir(generation_id), MODEL_FILE_NAME)

    def manifest_uri(self, generation_id: str) -> str:
        return storage.join(self.generation_dir(generation_id), MANIFEST_FILE_NAME)

    # -- listing / manifests -------------------------------------------------

    def list_generations(self) -> list[str]:
        """Generation ids (numeric dir names), oldest first."""
        return sorted(
            (n for n in storage.list_names(self.model_dir) if is_generation_id(n)),
            key=int,
        )

    def read_manifest(self, generation_id: str) -> GenerationManifest | None:
        uri = self.manifest_uri(generation_id)
        try:
            if not storage.exists(uri):
                return None
            return GenerationManifest.from_json(storage.read_text(uri))
        except Exception:
            log.warning("unreadable manifest for generation %s", generation_id, exc_info=True)
            return None

    def write_manifest(self, manifest: GenerationManifest) -> None:
        storage.write_text(self.manifest_uri(manifest.generation_id), manifest.to_json())

    def read_pmml_text(self, generation_id: str) -> str | None:
        uri = self.pmml_uri(generation_id)
        if not storage.exists(uri):
            return None
        return storage.read_text(uri)

    def has_generation(self, generation_id: str) -> bool:
        return storage.exists(self.pmml_uri(generation_id))

    # -- champion pointer ----------------------------------------------------

    def champion_id(self) -> str | None:
        uri = storage.join(self.model_dir, CHAMPION_FILE_NAME)
        try:
            if not storage.exists(uri):
                return None
            data = json.loads(storage.read_text(uri))
            return str(data["generation_id"])
        except Exception:
            log.warning("unreadable CHAMPION pointer under %s", self.model_dir, exc_info=True)
            return None

    def champion_manifest(self) -> GenerationManifest | None:
        champion = self.champion_id()
        return self.read_manifest(champion) if champion else None

    def set_champion(self, generation_id: str, now_ms: int | None = None) -> None:
        """Atomic-rename update of the CHAMPION pointer."""
        crashpoint("registry.champion.pre")
        storage.write_text(
            storage.join(self.model_dir, CHAMPION_FILE_NAME),
            json.dumps(
                {
                    "generation_id": str(generation_id),
                    "updated_at_ms": int(time.time() * 1000) if now_ms is None else now_ms,
                }
            ),
        )

    # -- fsck / repair -------------------------------------------------------

    def fsck(self, repair: bool = False) -> dict:
        """Startup/operator audit of the registry layout: stale commit
        temp litter, a CHAMPION pointer that doesn't parse or points at
        a generation with no model.pmml, half-written generation dirs
        (promoted but never given their model.pmml), and manifests that
        no longer parse. Repair is recover-or-refuse, never silently
        wrong: damaged files are quarantined aside (forensics, not
        deletion) and the pointer falls back to the newest *intact*
        generation — consumers re-resolve, nothing serves a torn model.

        Must not run concurrently with an in-flight promote of the same
        store (a generation mid-upload looks half-written); MLUpdate runs
        it before promoting, the CLI runs it with the batch layer down.
        Returns a count report; repairs also land on registry.repair.*
        counters."""
        report = {
            "tmp-swept": 0, "champion-quarantined": 0, "champion-reset": 0,
            "generations-quarantined": 0, "manifests-quarantined": 0,
        }
        local = not storage.is_remote(self.model_dir)
        if local:
            report["tmp-swept"] += storage.sweep_tmp(self.model_dir)
            report["tmp-swept"] += self._sweep_promote_litter()
        intact: list[str] = []
        for gen in self.list_generations():
            gen_dir = self.generation_dir(gen)
            if local:
                report["tmp-swept"] += storage.sweep_tmp(gen_dir)
            manifest_uri = self.manifest_uri(gen)
            if storage.exists(manifest_uri):
                try:
                    GenerationManifest.from_json(storage.read_text(manifest_uri))
                except Exception:
                    report["manifests-quarantined"] += 1
                    if repair and local:
                        self._quarantine(storage.local_path(manifest_uri))
                        metrics.registry.counter(
                            "registry.repair.manifest-quarantined"
                        ).inc()
            if self.has_generation(gen):
                intact.append(gen)
                continue
            # a generation dir without model.pmml is a promote that died
            # mid-copy: nothing can ever serve it
            report["generations-quarantined"] += 1
            if repair and local:
                self._quarantine(storage.local_path(gen_dir))
                metrics.registry.counter("registry.repair.generation-quarantined").inc()
                log.warning(
                    "registry repair: quarantined half-written generation %s", gen
                )
        report.update(self._fsck_champion(repair, intact))
        return report

    def _fsck_champion(self, repair: bool, intact: list[str]) -> dict:
        report = {"champion-quarantined": 0, "champion-reset": 0}
        uri = storage.join(self.model_dir, CHAMPION_FILE_NAME)
        if not storage.exists(uri):
            return report
        champion: str | None = None
        try:
            champion = str(json.loads(storage.read_text(uri))["generation_id"])
        except Exception:
            report["champion-quarantined"] = 1
            if repair:
                if storage.is_remote(self.model_dir):
                    storage.delete(uri)
                else:
                    self._quarantine(storage.local_path(uri))
                metrics.registry.counter("registry.repair.champion-quarantined").inc()
                log.warning(
                    "registry repair: quarantined unreadable CHAMPION under %s",
                    self.model_dir,
                )
        if champion is not None and champion not in intact:
            # pointer at a missing/half-written generation: fall back to
            # the newest intact one (lineage stays within published gens)
            report["champion-reset"] = 1
            if repair:
                if intact:
                    self.set_champion(intact[-1])
                else:
                    storage.delete(uri)
                metrics.registry.counter("registry.repair.champion-reset").inc()
                log.warning(
                    "registry repair: CHAMPION pointed at unusable generation "
                    "%s; reset to %s", champion, intact[-1] if intact else "(none)",
                )
        return report

    def _sweep_promote_litter(self) -> int:
        """Remove ``.promote-<gen>-<pid>`` staging dirs whose promoter is
        dead (MLUpdate stages a candidate there before its atomic rename
        into the generation slot; a kill mid-copy strands the dir)."""
        import shutil

        root = storage.local_path(self.model_dir)
        if not root.is_dir():
            return 0
        removed = 0
        for p in root.iterdir():
            if not (p.is_dir() and p.name.startswith(".promote-")):
                continue
            try:
                pid = int(p.name.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                continue
            if pid == os.getpid() or _pid_alive(pid):
                continue
            shutil.rmtree(p, ignore_errors=True)
            removed += 1
            log.warning("registry repair: swept dead promote staging dir %s", p)
        return removed

    @staticmethod
    def _quarantine(path) -> None:
        aside = path.with_name(f".quarantine-{path.name}-{os.getpid()}")
        try:
            os.replace(path, aside)
        except OSError:
            log.warning("registry repair: could not quarantine %s", path, exc_info=True)
            return
        # durable quarantine: a crash right after fsck must not resurrect
        # the corrupt file the repair just moved aside
        storage.fsync_dir(path.parent)

    # -- retention GC --------------------------------------------------------

    def gc(self, max_generations: int, never_delete: set[str] | None = None) -> list[str]:
        """Keep the newest ``max_generations`` generations plus the
        champion plus every id in ``never_delete`` (the serving layer's
        live generation). Returns the deleted ids. ``max_generations < 0``
        disables."""
        if max_generations < 0:
            return []
        keep: set[str] = set(never_delete or ())
        champion = self.champion_id()
        if champion:
            keep.add(champion)
        gens = self.list_generations()
        newest = gens[len(gens) - max_generations :] if max_generations > 0 else []
        keep.update(newest)
        deleted = []
        for gen in gens:
            if gen in keep:
                continue
            storage.delete(self.generation_dir(gen), recursive=True)
            deleted.append(gen)
            metrics.registry.counter("ml.registry.gc.deleted").inc()
        if deleted:
            log.info(
                "registry GC: deleted %d generation(s) %s (kept %d)",
                len(deleted), deleted, len(gens) - len(deleted),
            )
        return deleted


def publish_generation(
    store: RegistryStore,
    generation_id: str,
    producer,
    max_message_size: int,
    retry_policy=None,
) -> str:
    """(Re)publish an archived generation onto the update topic: inline
    MODEL when the PMML fits the topic's max message size, MODEL-REF to
    the *generation dir* otherwise (the registry-resolvable form — never
    a bare file path). Shared by MLUpdate's publish path and the serving
    layer's rollback endpoint. Returns the key used."""
    pmml_text = store.read_pmml_text(generation_id)
    if pmml_text is None:
        raise FileNotFoundError(f"generation {generation_id} has no {MODEL_FILE_NAME}")
    if len(pmml_text.encode("utf-8")) <= max_message_size:
        key, payload = "MODEL", pmml_text
    else:
        key, payload = "MODEL-REF", store.generation_dir(generation_id)
    crashpoint("registry.publish.pre")
    if retry_policy is not None:
        retry_policy.call(
            lambda: producer.send(key, payload),
            retry_on=(ConnectionError, OSError),
            metrics_prefix="batch.publish",
        )
    else:
        producer.send(key, payload)
    crashpoint("registry.publish.post")
    return key
