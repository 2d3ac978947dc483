"""MLUpdate: the batch-training harness.

Rebuild of framework/oryx-ml/.../MLUpdate.java:59-373. Per generation:

1. split new data into train/test (random by default; apps may override
   with e.g. a time-ordered split — MLUpdate.java:338-372),
2. enumerate hyperparameter combos (param.py),
3. build + evaluate one candidate per combo, in parallel
   (findBestCandidatePath, MLUpdate.java:251-288) — each candidate trains
   via the abstract `build_model` and persists `model.pmml` under a
   temporary candidates dir,
4. promote the best candidate dir to `model_dir/<timestampMs>/`
   (temp→rename, MLUpdate.java:192-210),
5. publish ("MODEL", <pmml xml>) inline when it fits the update topic's
   max-size, else ("MODEL-REF", <generation dir>) (MLUpdate.java:212-241),
6. call `publish_additional_model_data` (ALS streams its factor matrices
   here, ALSUpdate.java:194-230).

Registry integration (oryx_tpu/registry/): each promoted generation gets
its id + parent stamped into the PMML as Extensions and a manifest.json
written next to model.pmml; a champion/challenger gate can archive a
regressed candidate instead of publishing it; the champion's model is
surfaced to `build_model` for warm-starting; and count-based retention GC
trims old generations after each successful run.

Port note: a copy of ``oryx_tpu/ml/update.py`` with its imports pointed at
``oryx_tpu_torch``. With ``oryx.ml.eval.parallelism > 1`` candidates
train on threads, each inside the ``device_scope`` of its own disjoint
sub-mesh (``parallel.mesh.partition_devices``); with one card every
candidate's group is that card.
"""

from __future__ import annotations

import abc
import contextlib
import logging
import math
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Iterable, Sequence
from xml.etree.ElementTree import Element

from oryx_tpu_torch.api.batch import BatchLayerUpdate
from oryx_tpu_torch.bus.core import KeyMessage, TopicProducer
from oryx_tpu_torch.common import pmml as pmml_io, rng, storage, tracing
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.crashpoints import crashpoint
from oryx_tpu_torch.common.lang import collect_in_parallel
from oryx_tpu_torch.common.records import ChainRecords, ListRecords, as_records
from oryx_tpu_torch.common.resilience import RetryPolicy
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.registry.gate import ChampionGate
from oryx_tpu_torch.registry.manifest import (
    GENERATION_EXTENSION,
    ONLINE_PENDING,
    PARENT_EXTENSION,
    STATUS_GATED,
    STATUS_PUBLISHED,
    GenerationManifest,
    content_hash_of,
)
from oryx_tpu_torch.registry.store import RegistryStore

log = logging.getLogger(__name__)

MODEL_FILE_NAME = "model.pmml"


class MLUpdate(BatchLayerUpdate, abc.ABC):
    """Apps subclass this and implement get_hyper_parameter_values,
    build_model, and evaluate."""

    def __init__(self, config: Config) -> None:
        self.config = config
        self.test_fraction = config.get_float("oryx.ml.eval.test-fraction")
        candidates = config.get_int("oryx.ml.eval.candidates")
        self.eval_parallelism = config.get_int("oryx.ml.eval.parallelism")
        self.threshold = config.get_optional_float("oryx.ml.eval.threshold")
        self.hyperparam_search = config.get_string("oryx.ml.eval.hyperparam-search")
        if self.hyperparam_search not in ("grid", "random"):
            raise ValueError(
                f"oryx.ml.eval.hyperparam-search must be grid or random, "
                f"got {self.hyperparam_search!r}"
            )
        self.max_message_size = config.get_int("oryx.update-topic.message.max-size")
        if not 0.0 <= self.test_fraction <= 1.0:
            raise ValueError("test-fraction must be in [0,1]")
        if self.test_fraction == 0.0 and candidates > 1:
            log.info("test-fraction = 0 so forcing candidates to 1")
            candidates = 1
        self.candidates = max(1, candidates)
        # a trained model that fails to publish over a transient bus fault
        # is an entire generation of compute lost — retry under the batch
        # layer's policy before giving up
        self.publish_retry = RetryPolicy.from_config(config, "oryx.batch.retry")
        self.gate = ChampionGate(config)
        self.warm_start = config.get_bool("oryx.ml.warm-start")
        self.retention_max_generations = config.get_int(
            "oryx.ml.retention.max-generations"
        )
        # champion state surfaced to build_model for warm-starting; set per
        # run by load_previous_model
        self.previous_model: Element | None = None
        self.previous_model_dir: str | None = None
        self.previous_generation_id: str | None = None
        # per-phase wall of the winning candidate ({"build": s, "eval": s}),
        # refreshed each run — read by operators/benchmarks to see where a
        # generation's wall went without a profiler
        self.last_phase_seconds: dict[str, float] = {}

    # -- abstract app hooks --------------------------------------------------

    def get_hyper_parameter_values(self) -> list[hp.HyperParamValues]:
        """Ranges of hyperparameters to try; order matters and must match
        what build_model expects (MLUpdate.java:110-117)."""
        return []

    @abc.abstractmethod
    def build_model(
        self,
        train_data: Iterable[KeyMessage],
        hyper_parameters: Sequence,
        candidate_path: Path,
    ) -> Element:
        """Train and return the model as a PMML element tree; large side
        artifacts (e.g. factor matrices) go under candidate_path.
        train_data is re-iterable and may be a common.records.Records
        (columnar blocks for vectorized consumers)."""

    @abc.abstractmethod
    def evaluate(
        self,
        model: Element,
        model_parent_path: Path,
        test_data: list[KeyMessage],
        train_data: Iterable[KeyMessage],
    ) -> float:
        """Higher is better (MLUpdate.java evaluation contract)."""

    def publish_additional_model_data(
        self,
        pmml: Element,
        new_data: list[KeyMessage],
        past_data: Iterable[KeyMessage],
        model_parent_path: Path,
        model_update_topic: TopicProducer | None,
    ) -> None:
        """Optionally stream extra model payloads after MODEL
        (ALSUpdate.publishAdditionalModelData analogue)."""

    def split_new_data_to_train_test(
        self, new_data: list[KeyMessage]
    ) -> tuple[list[KeyMessage], list[KeyMessage]]:
        """Default random split by test-fraction (MLUpdate.java:360-372)."""
        if self.test_fraction <= 0.0:
            return new_data, []
        if self.test_fraction >= 1.0:
            return [], new_data
        gen = rng.get_random()
        mask = gen.random(len(new_data)) < self.test_fraction
        train = [d for d, is_test in zip(new_data, mask) if not is_test]
        test = [d for d, is_test in zip(new_data, mask) if is_test]
        return train, test

    # -- warm-start ----------------------------------------------------------

    def load_previous_model(self, store: RegistryStore) -> Element | None:
        """Surface the champion generation's PMML (and dir, for side
        artifacts like ALS factor shards) to ``build_model``. Called at
        the top of every run when ``oryx.ml.warm-start`` is on; apps read
        ``self.previous_model`` / ``self.previous_model_dir`` and decide
        whether shapes still match. Any read failure degrades to a cold
        start — warm-start is an optimization, never a correctness
        dependency."""
        self.previous_model = None
        self.previous_model_dir = None
        self.previous_generation_id = None
        try:
            champion = store.champion_id()
            if champion is None:
                return None
            text = store.read_pmml_text(champion)
            if text is None:
                return None
            self.previous_model = pmml_io.from_string(text)
            self.previous_model_dir = store.generation_dir(champion)
            self.previous_generation_id = champion
            log.info("warm-start: loaded champion generation %s", champion)
        except Exception:
            log.warning("failed to load previous model; cold-starting", exc_info=True)
            self.previous_model = None
            self.previous_model_dir = None
            self.previous_generation_id = None
        return self.previous_model

    # -- the harness ---------------------------------------------------------

    def run_update(
        self,
        timestamp_ms: int,
        new_data: Iterable[KeyMessage],
        past_data: Iterable[KeyMessage],
        model_dir: str,
        model_update_topic: TopicProducer | None,
    ) -> None:
        new_data = list(new_data)
        past_records = as_records(past_data)
        if not new_data and past_records.is_empty():
            log.info("no data at all; nothing to do")
            return

        train_new, test_new = self.split_new_data_to_train_test(new_data)
        # lazy concat: past data streams from storage block by block
        # (BatchUpdateFunction's union of past RDD + new RDD), so training
        # at 100M-rating scale never holds history as one Python list
        all_train = ChainRecords([past_records, ListRecords(train_new)])

        if self.hyperparam_search == "random":
            combos = hp.sample_hyper_parameter_combos(
                self.get_hyper_parameter_values(), self.candidates
            )
        else:
            combos = hp.choose_hyper_parameter_combos(
                self.get_hyper_parameter_values(),
                self.candidates,
                hp.choose_values_per_hyper_param(
                    len(self.get_hyper_parameter_values()), self.candidates
                ),
            )

        store = RegistryStore(str(model_dir))
        # repair-on-open: quarantine half-written generations / torn
        # pointers a killed predecessor left behind, BEFORE computing the
        # parent lineage against them (no concurrent promote can be in
        # flight — this process is the promoter)
        store.fsck(repair=True)
        generation_id = str(timestamp_ms)
        parent_id = store.champion_id()
        if self.warm_start:
            self.load_previous_model(store)

        candidates_root = Path(tempfile.mkdtemp(prefix="oryx-candidates-"))
        t0 = time.monotonic()
        try:
            best = self._find_best_candidate(candidates_root, combos, all_train, test_new)
            if best is None:
                log.info("unable to build any model")
                return
            best_score, best_path, best_pmml, best_params = best

            # stamp generation identity into the document itself, so an
            # inline MODEL message is self-describing on the wire (the
            # serving tracker reads it back out)
            from oryx_tpu_torch.app import pmml as app_pmml

            app_pmml.add_extension(best_pmml, GENERATION_EXTENSION, generation_id)
            if parent_id is not None:
                app_pmml.add_extension(best_pmml, PARENT_EXTENSION, parent_id)
            local_pmml = Path(best_path) / MODEL_FILE_NAME
            pmml_io.write_pmml(best_pmml, local_pmml)

            decision = self.gate.decide(store, best_score)

            # promote to model_dir/<timestampMs>/: temp -> rename locally,
            # recursive upload (PMML last) to an object store. Capture the
            # PMML bytes before the local copy disappears — publishing must
            # not re-download what was on local disk a moment ago. A gated
            # generation is promoted too (archived for forensics), it just
            # never reaches the update topic or the CHAMPION pointer.
            pmml_bytes = local_pmml.read_bytes()
            pmml_text = (
                pmml_bytes.decode("utf-8")
                if len(pmml_bytes) <= self.max_message_size
                else None
            )
            if storage.is_remote(model_dir):
                final_dir = storage.join(model_dir, generation_id)
                # list, don't exists(): on object stores a bare prefix can
                # report absent while stale blobs from a previous partial
                # upload still live under it
                if storage.list_names(final_dir):
                    storage.delete(final_dir, recursive=True)
                storage.upload_dir(best_path, final_dir)
                shutil.rmtree(best_path, ignore_errors=True)
            else:
                final_dir = storage.local_path(model_dir) / generation_id
                final_dir.parent.mkdir(parents=True, exist_ok=True)
                if final_dir.exists():
                    shutil.rmtree(final_dir)
                # stage on the registry's OWN filesystem first, then one
                # atomic rename: moving straight from the /tmp candidate
                # dir can cross devices, where shutil.move degrades to
                # copy+delete and a crash mid-copy leaves a half-written
                # generation (ORX602). Dead .promote- litter is swept by
                # RegistryStore.fsck.
                promote_tmp = final_dir.parent / f".promote-{generation_id}-{os.getpid()}"
                if promote_tmp.exists():
                    shutil.rmtree(promote_tmp)
                shutil.move(str(best_path), str(promote_tmp))
                os.rename(promote_tmp, final_dir)
                storage.fsync_dir(final_dir.parent)
            crashpoint("ml.promote.mid")

            # online (evidence-gated) promotion: when the online gate is
            # enabled and a champion already exists, a publish-worthy
            # candidate goes out WITHOUT moving the CHAMPION pointer —
            # serving classifies it as the challenger arm and the online
            # gate moves the pointer only once live evidence clears the
            # bars (docs/experiments.md). Bootstrap (no champion yet)
            # promotes immediately, as offline mode does.
            online_pending = (
                decision.publish
                and self.gate.online.enabled
                and store.champion_id() is not None
            )

            store.write_manifest(
                GenerationManifest(
                    generation_id=generation_id,
                    parent_id=parent_id,
                    status=STATUS_PUBLISHED if decision.publish else STATUS_GATED,
                    hyperparams=list(best_params),
                    eval_metric=best_score,
                    train_count=sum(len(b) for b in all_train.blocks()),
                    test_count=len(test_new),
                    wall_time_sec=time.monotonic() - t0,
                    content_hash=content_hash_of(pmml_bytes),
                    created_at_ms=timestamp_ms,
                    gate_reason=None if decision.publish else decision.reason,
                    online_status=ONLINE_PENDING if online_pending else None,
                )
            )

            if not decision.publish:
                log.warning(
                    "generation %s gated, not published: %s", generation_id, decision.reason
                )
                return

            crashpoint("ml.champion.pre")
            if online_pending:
                log.info(
                    "generation %s published as online challenger: champion "
                    "pointer stays until the online gate promotes it",
                    generation_id,
                )
            else:
                store.set_champion(generation_id, now_ms=timestamp_ms)

            if model_update_topic is None:
                log.info("not publishing model to update topic since none is configured")
            else:
                # publish under a (sampled-root) trace span, with a "@trc"
                # header stamped with publish time: every replica that
                # applies this generation records a serving.model.apply
                # span in the same trace and derives its propagation skew
                # from the timestamp
                publish_ms = int(time.time() * 1000)
                with tracing.span(
                    "batch.publish-model",
                    attrs={"generation": generation_id},
                    root=True,
                ):
                    if pmml_text is not None:
                        records, _ = tracing.with_header(
                            [("MODEL", pmml_text)], ingest_ms=publish_ms
                        )
                    else:
                        # a MODEL-REF names the *generation dir* — registry-
                        # resolvable (manifest + side artifacts travel with
                        # the document), never a bare file path
                        ref = store.generation_dir(generation_id)
                        records, _ = tracing.with_header(
                            [("MODEL-REF", ref)], ingest_ms=publish_ms
                        )
                    crashpoint("ml.publish.pre")
                    self.publish_retry.call(
                        lambda: model_update_topic.send_many(records),
                        retry_on=(ConnectionError, OSError),
                        metrics_prefix="batch.publish",
                    )
                    self.publish_additional_model_data(
                        best_pmml, new_data, past_records, final_dir, model_update_topic
                    )
                    crashpoint("ml.publish.post")
        finally:
            shutil.rmtree(candidates_root, ignore_errors=True)
        store.gc(self.retention_max_generations, never_delete={generation_id})

    def _find_best_candidate(
        self,
        candidates_root: Path,
        combos: list[list],
        all_train: Iterable[KeyMessage],
        test_data: list[KeyMessage],
    ) -> tuple[float, Path, Element, Sequence] | None:
        # Disjoint sub-meshes: with N>1 parallel candidates and enough
        # devices, each candidate trains on its own contiguous device
        # subset, the analogue of MLUpdate.java:256-288's parallel Spark
        # jobs. With one device (or parallelism 1) every group is the full
        # device set: the serial fallback costs nothing.
        from oryx_tpu_torch.parallel import mesh as mesh_mod

        groups = (
            mesh_mod.partition_devices(self.eval_parallelism)
            if self.eval_parallelism > 1 and len(combos) > 1
            else None
        )

        def build_and_eval(i: int) -> tuple[float, Path, Element, Sequence] | None:
            candidate_path = candidates_root / str(i)
            candidate_path.mkdir(parents=True, exist_ok=True)
            hyper_parameters = combos[i]
            scope = (
                mesh_mod.device_scope(groups[i % len(groups)])
                if groups
                else contextlib.nullcontext()
            )
            t_build = time.monotonic()
            try:
                with scope:
                    model = self.build_model(all_train, hyper_parameters, candidate_path)
            except Exception:
                log.exception("failed to build candidate %d (%s)", i, hyper_parameters)
                return None
            build_sec = time.monotonic() - t_build
            pmml_io.write_pmml(model, candidate_path / MODEL_FILE_NAME)
            t_eval = time.monotonic()
            if not test_data and len(combos) == 1:
                eval_score = math.nan  # nothing to evaluate against; only candidate wins
            else:
                try:
                    eval_score = self.evaluate(
                        model, candidate_path, test_data, all_train
                    )
                except Exception:
                    log.exception("failed to evaluate candidate %d", i)
                    return None
            eval_sec = time.monotonic() - t_eval
            log.info(
                "candidate %d params=%s eval=%s (build %.2fs, eval %.2fs)",
                i, hyper_parameters, eval_score, build_sec, eval_sec,
            )
            return eval_score, candidate_path, model, hyper_parameters, build_sec, eval_sec

        results = collect_in_parallel(
            len(combos), build_and_eval, parallelism=self.eval_parallelism
        )
        best = None
        for r in results:
            if r is None:
                continue
            score = r[0]
            if self.threshold is not None and not math.isnan(score) and score < self.threshold:
                log.info("candidate %s below threshold %s; discarded", score, self.threshold)
                continue
            if best is None or (
                not math.isnan(score) and (math.isnan(best[0]) or score > best[0])
            ):
                best = r
        if best is None:
            return None
        score, path, model, params, build_sec, eval_sec = best
        self.last_phase_seconds = {"build": build_sec, "eval": eval_sec}
        log.info(
            "best candidate eval=%s (build %.2fs, eval %.2fs)", score, build_sec, eval_sec
        )
        return score, path, model, params
