#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``oryx_tpu_torch``) runs on the GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each printing one JSON line:

1. card and build: the card, torch and CUDA versions, the seconds
   ``nvcc`` took to build the kernels from ``oryx_tpu_torch/csrc``, and
   those ``g++`` took, beside it, to build the native library from its
   three sources (``oryx_tpu_torch/native/feature_store.cpp``,
   ``parse.cpp`` and ``httpfront.cpp``);
1b. lint, beside the build: the port's static-analysis gate as an
   operator runs it, ``python -m oryx_tpu_torch lint`` in a process of
   its own over this checkout: exit 0, no finding and no stale baseline
   entry, with the findings, the baseline's entries and the findings
   they accept, the passes and the seconds;
2. kernels: every kernel of the serving path (``topn_scan`` and
   ``topn_candidates`` on the tensor cores for every plane type,
   ``topn_merge``) against its plain PyTorch version on the same inputs,
   at 1,000,000 items x 250 features, dot and cosine: float32, bfloat16
   and int8 at every batcher bucket (b = 8 to 256), and the candidates
   kernel at b = 512; planted exact ties (duplicated item columns) must
   come back in lowest-id order; the widest query tile (N = 128) at
   b = 128 and 256 on a 50-feature plane (bfloat16, int8) and a
   10-feature one (float32); wide planes of 1,056 and 4,096
   features x 32,768 items, whose query pieces stream beside the items,
   every plane type, topn_scan at b = 8 and 256 and topn_candidates at
   b = 512, dot and cosine, on the ``tc`` / ``tc_f32`` launch keys; the
   merge bit for bit on synthetic lists
   (S = 1 to 1221 lists, m = 1 to 128, b = 1 and 512, padding, equal
   values across lists); with CUDA-event times of the kernel (on the
   device alone, and calls back to back), the plain version and two
   PyTorch library yardsticks that the port never calls
   (``torch.matmul`` with a stable ``torch.sort``; ``torch.matmul`` in
   the plane's working type with ``torch.topk``); and
   ``ops/topn.upload_random`` at 1,000,000 x 250, float32 and int8: its
   handle equal bit for bit to ``upload()`` of its matrix read back but
   for the norms, summed on the card (within 2e-6 relative), a scan over
   it (b = 256) equal to its plain version;
3. serving, int8: the port's ServingLayer fed MODEL + UP messages over
   the update topic and bulk-loaded with 1,000,000 items and users,
   answering concurrent /recommend (index submit through the batcher),
   /recommendToAnonymous, /similarity and /estimate; /recommend recall@10
   against an exact float32 scan on the card must reach 0.99, and so
   must a 512-query batch through ``topn.top_k_scores_batch`` (the
   candidates kernel); every scan takes the ``tc`` path;
4. serving, float32, on the same factors: /recommend ids must equal the
   exact top-10 (ties to the lowest id), and a 512-query batch through
   ``topn.top_k_scores_batch`` (the candidates kernel) must too; every
   scan takes the ``tc_f32`` path (six bf16 passes); with
   ``oryx.serving.compute.profile-dir`` set, a ``POST /debug/profile``
   of 2 s while 64 clients keep sending /recommend: its Chrome trace
   must hold ``topn_tc_kernel`` and ``topn_merge_kernel`` events (or the
   phase prints that the profiler saw no CUDA activity), with the card's
   busy share over the window and its five costliest device ops;
5. kmeans-kernels: the Lloyd sweep (``pallas_kmeans.sweep``, one launch
   of ``kmeans_sweep.tc``) against its plain version on Gaussian blobs at
   200,000 x 20 (k = 10, the repo's k-means shape), 10,000,000 x 20
   (cut since the tenants phase joined the run, printed on the "cuts" line)
   (k = 10) and 1,000,000 x 256 (k = 256), and at the shapes of the
   kernel's other paths: 100,000 x 7 (k = 5: d * 4 not a multiple of 16,
   also from an address that is not 16-byte aligned), 200,000 x 32
   (k = 300: more centers than one tile of 256), 200,000 x 768 (k = 10)
   and 50,000 x 601 (k = 300: rows staged in chunks) and 20,000 x 16
   (k = 10,000): counts equal but for near ties (two smallest
   distances within 1e-5 relative), sums within rtol 1e-5 of max |sum|
   (plus the near ties' share), cost within rtol 1e-5, two launches bit
   for bit, NaN and inf rows to no center; with CUDA-event times of the
   sweep (on the device alone, and calls back to back), its plain version
   and a PyTorch yardstick that the port never calls (f32 matmul
   distances, ``torch.min``, ``index_add_``, ``bincount``);
6. kmeans-batch: the port's BatchLayer with KMeansUpdate on an inproc
   bus (reference.conf defaults: 30 iterations, 3 runs, k-means||,
   SILHOUETTE, test-fraction 0.1) trains on 200,000 CSV points of 20
   features in 10 blobs; the port's ServingLayer answers /assign and
   /distanceToNearest for 1,000 sampled points exactly as a float64
   numpy nearest-center search does, and every true blob center has a
   trained center within 0.5; a second generation with mini-batch size
   10,000 warm-starts from the champion under the same checks; the
   first generation runs under ``oryx.batch.compute.profile-dir`` and its
   trace must hold the ``sweep_kernel`` events of its sweeps;
7. kmeans-lambda: the k-means lambda loop as three OS processes
   (``python -m oryx_tpu_torch batch|speed|serving``) on one ``file:``
   bus: wave 1, the phase-6 training set (200,000 x 20, k = 10), POSTed
   to serving's /add with the batch group's offsets committed first, then
   trained by the batch process, started after the POST (which must have
   launched ``kmeans_sweep.tc``, read from its metrics UI), served as in
   phase 6; the batch process is then stopped, so that its next
   generation cannot replace the speed layer's folds; wave 2, 20,000
   points around blob 0 moved by +1.0 in every feature, folded by the
   speed process and served as the float64 running mean (within 1e-9
   relative); the speed process restarted; wave 3, 20,000 more, with
   every cluster's count the model's plus waves 2 and 3 (nothing
   consumed twice or lost); with the generation and micro-batch
   seconds and each wave's staleness (last POST to serving's answer);
8. als-train: ALS training and fold-in through ``ops/als.py`` on the
   card (PyTorch ops: the JAX package runs them through XLA, no Pallas
   kernel): (a) the MovieLens-100K shape of tools/train_benchmark.py
   (943 x 1,682, 100,000 explicit 1-5 ratings, 90/10 split, rank 25,
   lam 0.1, 10 sweeps, seed 42) trained on the card and on the CPU by the
   same code, held-out predictions within 1e-3 and RMSE within 1e-4, in
   float32; bfloat16 Gramians printed beside it; (b) a MovieLens-25M-
   shaped implicit set (162,541 x 59,047, 25,000,095 power-law ratings)
   at rank 200, lam 0.01, alpha 1, 3 iterations (reference.conf's 10, cut),
   float32 and bfloat16:
   packing through forked workers after CUDA is up, finite factors, one
   half-sweep each way timed by stage (gather + Gramian, solve), 512 of
   its user rows solved again on the CPU within rtol 2e-2, atol 2e-3,
   the Cholesky solve against a batched LU on one piece, mean_auc; (c)
   ``fold_in_batch`` of 100,000 events at k = 50 and 200 on the card
   against the host within rtol 1e-4, atol 1e-5, a singular Gramian
   with no non-finite output, events per second;
9. als-lambda: the ALS lambda loop as three processes (``python -m
   oryx_tpu_torch batch|speed|serving``) on one ``file:`` bus, and a
   second serving process scoring int8: a MovieLens-1M-shaped implicit
   set (6,040 x 3,706, 1,000,209 lines) POSTed to /ingest, one batch
   generation (50 features, 10 iterations) whose /recommend equals the
   float64 exact top-10 from the published X/Y (float32, through
   ``topn_scan.tc_f32``) or reaches recall@10 0.99 (int8, ``topn_scan.tc``),
   read off each serving process's /metrics; the batch process stopped;
   two waves of 2,000 interactions of 200 new users and 2,000 of existing
   users, folded on the card by the speed process (restarted between
   them): every new user served the exact top-10 of the vector the speed
   layer published, and that vector the float64 fold-in of its events
   within 1e-4 relative; with the generation's seconds and phases, the
   held-out AUC, the micro-batch seconds and each wave's staleness; the
   speed and serving processes on the native store and parser, as each
   one's start-up line says;
9b. buses: the fault, shm and TCP buses under the ALS loop, each layer
   a ``python -m oryx_tpu_torch`` process. (a) conf/chaos-example.conf
   as packaged (its ``fault+file:`` bus at drop 0.1, delay 20 ms, dup
   0.01, seed 7; 10 features; its retry and dead-letter blocks), but
   for its directories (under a temp dir), its ports (free ones, and
   the batch and speed metrics UIs on them), the generation interval
   (30 s) and the class names (the port's): the MovieLens-1M-shaped
   set through /ingest in bodies of 4,000 lines from 4 clients (a body
   answered with an error sent again) as the batch process starts, one
   generation: every posted line in the batch layer's data, /recommend
   for 100 probe users the exact top-10 of the published factors; a
   poison UP on the update topic dead-lettered to
   OryxUpdate.dead-letter after 3 failures, then a wave of 100 new
   users each served the exact top-10 of its published vector; drops,
   duplicates and injected errors each counted above 0, summed over the
   processes' metrics; no layer thread dead (/healthz). (b) run while
   (a)'s batch process waits out its interval: a ``bus-serve`` process
   holding the update topic (``tcp://``), the input topic one
   ``shm:`` ring of 8 MiB under /dev/shm; a MODEL at MovieLens-1M's
   shape (6,040 x 3,706, 50 features) with X and Y as UP lines from a
   seed; the speed (pipelined) and serving layers; a wave of 100 new
   users as typed events, each published as the float64 fold-in within
   1e-4 and served its exact top-10; then 2,000,000 typed implicit
   events through ``send_interactions``, the bus server killed
   (SIGKILL) and restarted on its port and directory halfway: the speed
   group's committed offset equal to the events sent, the ring's head
   past twice its size with no CRC resync, every user's and item's
   /estimate the dot of the last published X and Y; with the events
   per second over shm and the publish-to-served seconds; both serving
   processes launching the scans and ``topn_merge``;
9c. tenants: tenancy, an online experiment and the lineage endpoints.
   (a) four tenants trained in one ``TenantPipelines`` round on an inproc
   bus and served by one ``ServingLayer`` on the default request path
   (the native front, the ladder with one ladder per tenant): ``movies``
   (ALS, weight 2, a MovieLens-1M-shaped set, 50 features), ``shop``
   (ALS, weight 1, a second draw of that shape less its last 40 users,
   10 features), ``sensors`` (k-means, 200,000 x 20, k = 10) and
   ``churn`` (RDF, conf/rdf-example.conf's schema and model on 50,000
   covtype-shaped rows: the cut); topics and model dirs namespaced, every
   tenant's live generation on /healthz; a user of both ALS tenants gets
   shop's answer under /t/shop/, a movies-only user 404; clients in
   another process (``client_main``), 32 on each ALS tenant, 4 on
   /t/sensors/assign and 4 on /t/churn/predict, for 5 s (10 s before a
   cut): p50, p99 and
   requests per second by tenant, recall@10 of every ALS answer against
   the exact float32 scan of its tenant's factors at least 0.99, each
   ALS tenant at least 25% of the ALS answers; then the served k-means
   centers equal to the published ones, /assign against the float64
   nearest center, /predict on 1,000 held-out lines against the
   published forest on the host, and ``serving.requests.tenant.<id>``
   counted for all four; (b) one ALS layer on a ``file:`` bus with
   ``oryx.serving.ab.fraction = 0.5``, the online gate at 50 samples and
   a restage dir: generation 1 the champion, generation 2 (the same
   ratings and seed, warm start off) the online challenger; 1,000 users
   (2,000 before a cut)
   twice each, every arm ``bucket_of``'s and sticky; the challenger arm
   interacting with its first item, the champion arm with another, until
   the gate promotes (within 30 s: the manifest, CHAMPION, /healthz,
   both arms resolved at least 50 times on GET /experiments); then
   ``POST /model/rollback/<generation 1>``: CHAMPION back, generation 1
   live again, 64 probe users answered byte for byte as before the
   experiment, ``GET /model/generations`` listing both, and each
   MODEL-REF generation staged whole under the restage dir; the whole
   phase under the port's lock-order watchdog (``common/locks.py``,
   strict, 120 s acquire budget, armed before any layer is built): the
   order edges it observed and its violations printed, and none allowed;
9d. fleet: the fleet harness, the autoscaler and the CLI's operator
   commands (``oryx_tpu_torch/tools/fleet.py``), each replica a port
   ServingLayer serving the probe app (which launches no kernel), in a
   process of its own (``--alone fleet``): (a) the fleet command's
   default scenario over 3 replicas on a ``fault+inproc:`` bus at 150
   req/s for 10 s (a chaos window opened, a generation published, the
   window closed, a rollback): zero failed requests, the fleet converged
   with skew 0; (d) the CLI against (a)'s replica 0 and model dir:
   ``health`` in sync with ``/healthz`` and the CHAMPION, ``models list``
   and ``show`` against ``GET /model/generations``, ``experiments``
   against ``GET /experiments``, ``tenants list`` (1 on the untenanted
   fleet; then list and show with two tenants set), ``repair`` clean,
   ``models rollback`` of the second generation (every replica on it),
   ``models gc`` at one generation kept, ``config``; (b) the autoscaler
   over a diurnal ramp (15 to 45 req/s over 14 s, 30 req/s per replica)
   against one replica: out before the peak, in after it, no failed
   request; (c) the crash campaign: 3 subprocess replicas, one SIGKILLed
   mid-run, no failed request, its recovery seconds; the whole phase
   under the port's lock-order watchdog, as 9c (the crash campaign's
   replica processes are not watched);
10. rdf-train: random-forest training through ``ops/forest.py`` on the
   card (PyTorch ops: the JAX package runs them through XLA, no Pallas
   kernel): (a) tools/train_benchmark.py:215-248's configuration
   (100,000 covtype-shaped rows plus 20,000 held out, numerics quantile-
   binned to 32 bins, 20 trees, depth 10, entropy, seed 77) on the card
   (device path, ``hist_mode = "auto"``) and on the CPU (host path)
   through the same code: all 20 trees split for split with equal node
   counts, or a first differing node whose two best candidate gains are
   within 1e-6 relative on both sides (a near tie of the last bit of
   ``log``); held-out accuracy within 0.005; the card's vote sums on the
   CPU's forest bit for bit; one tree of depth 6 identical under the
   matmul, scalar and reference formulations; a regression forest (a
   function of features 0-3 plus noise) whose held-out RMSE is within
   1% of the CPU's, with the share of agreeing splits; (b) covtype's
   published size, 581,012 rows x 54 features, 7 classes, binned through
   ``app/rdf/encode.build_binning`` (100 split candidates), with
   conf/rdf-example.conf's model: 20 trees, depth 8, entropy,
   min-node-size 16, min-info-gain 0.001: children summing to their
   parents, init and iterate seconds, ms per level by stage
   (histograms, split selection, routing; CUDA events) and each level's
   formulation, rows x trees per second, peak memory (above what earlier
   phases still hold), held-out accuracy,
   and a 2-tree run against the CPU under the near-tie rule of (a);
   ``--rdf-rows`` shrinks (a) and (b) for a quick call;
11. rdf-lambda: the RDF lambda loop as three processes (``python -m
   oryx_tpu_torch batch|speed|serving``) on one ``file:`` bus with
   conf/rdf-example.conf's schema (55 columns, numerics 0-9, target 54)
   and the port's class names: 100,000 covtype-shaped lines POSTed to
   /train, one generation (20 trees, depth 8, test-fraction 0.1) whose
   MiningModel's held-out accuracy is read from the batch log, the batch
   process stopped; /predict on 1,000 held-out lines equal to the
   published forest's own predictions; /feature/importance naming the 54
   features, a rule's feature first; two waves of 2,000 labelled lines
   at 10 probe points, the speed process restarted between them, each
   followed by /classificationDistribution at every probe equal (1e-12)
   to the published forest with every wave's leaf counts added; each
   wave's staleness (last POST to the served answer);
12. ivf-ops: the IVF tier (``ops/ivf.py``) at the reference load
   benchmark's widest catalog, 250 features x 20,000,000 items clustered
   around 4,096 centers (tests/ops/test_ivf_scan.py:69-82's mixture, made
   on the card; 5,000,000 items, and the cut printed, when the host has
   not the memory for it): ``build_ivf`` by stage (sample k-means,
   assignment, quantize, upload, layout), the index's device bytes and
   the build's B3 launches; B3 at the build's shape (200,000 x 250,
   k = 4,472) against its plain version, with its times and bound;
   recall@10 against the exact int8 scan over the same items (its planes
   un-permuted from the index's on the card, checked bit for bit against
   ``upload_streaming`` on 65,536 of them; B1 at b = 256, B2 at b = 512)
   at probe-fraction 0.01 (at least 0.95) and 0.3 (at least 0.99), with
   ms per batch beside the exact scan's; each batch on the device path
   with one host round trip; full probe at 1,000,000 items against the
   exact scan (ids equal but for near ties, within check_topk's rtol);
13. ivf-serving: phase 3's serve() with ``oryx.serving.scan.ann.enabled``
   (and overload control off: the admission ladder would answer at
   fewer probes under this load) on a ``file:`` bus: 250 features x 1,000,000 int8 items around 1,000
   centers, 100,000 users near them; 64 concurrent /recommend (p50, p99,
   recall@10 against the exact float32 top-10 at least 0.95, the first
   request's seconds with the build); a second layer on the bus that
   builds its own index; 6,000 item fold-ins (10,000 before a cut;
   and a user pointing at
   each) as UP lines, past the overlay's 4,096 slots: the spill wakes the
   maintainer (interval 1 s), whose compaction publishes an index
   generation under the model dir; the second layer adopts the INDEX-REF
   (both on one generation); every folded item in its user's /recommend,
   and both layers answering the 64 probe users alike;
14. serving-front: the JAX package's default request path (the
   admission ladder with the reference's overload defaults, the native
   HTTP front) over phase 13's catalog on an inproc bus, the MODEL
   carrying a generation; clients in another process (``client_main``),
   threads over keep-alive connections: (a) 64 clients, 1,024
   /recommend (4,096, then 2,048, before cuts) over 4,096
   users, through the stdlib front and then the
   native one, each with its ladder held at full (idle signals fed to
   its controller) so that both do the same work (p50, p99, requests
   per second, recall@10 against the exact float32 top-10 at least
   0.95, every answer 200 and full, the native front's own request
   count, the ladder's real signals), then /healthz, /readyz, /ready
   and one /recommend equal byte for byte between the fronts (less
   Date, and /healthz's staleness seconds); (b) the native front under
   16, 256 and 16 clients for 10, 15 and 10 s, /healthz's shed_stage
   and the controller's signals sampled every 100 ms, its moves
   printed: no 5xx, the overload step's in flight up to the dispatch
   pool, 429s (each with Retry-After 1) if and only if the controller
   moved to shed (in flight counts once a dispatch worker takes a
   request, as in the JAX package, so it stops at the pool, 64 =
   inflight-target, and only a queue wait past about 65 ms sheds), at
   least one reduced-probe answer (each value x_u . y_id within 1e-4 of
   the answer's largest) and one stale answer (an earlier full answer's
   bytes), IVF batches below the full nprobe, back at full within 10 x
   hold-s of the last step and every answer full from then on;
14c. open-loop: one ALS ServingLayer on the default request path (the
   native front, the ladder) with phase 3's factors in float32, driven
   by the port's ``OpenLoopEngine`` from another process: Poisson
   arrivals over PowerLawUsers (the JAX package's defaults), 8 s at 0.5x
   and 8 s at 1.5x the requests/s serving-front (a) measured through
   the native front: offered and achieved rates, p50/p99 from the
   scheduled arrival and of the service time, queued arrivals, failures
   by kind, answers by served stage, the ``topn_scan.tc_f32`` and
   ``topn_merge`` launches of each rate; while the last rate left every
   answer full with no queued arrival, twice that rate for 4 s (at most
   twice), and the first rate that overloaded the layer printed; no
   failure at 0.5x, no 5xx or connection failure at any higher rate and
   every failure classified, a sample of full answers the exact float32
   top-10;
14b. serving-surface: one ServingLayer over TLS (a self-signed
   ``localhost`` PEM pair made by ``openssl``) with HTTP Basic auth and a
   profile dir, serving ALS at ``oryx.als.sample-rate = 0.3`` (LSH) over
   phase 3's 250 x 1,000,000 item factors: (a) plain HTTP to the TLS port
   fails, no or wrong credentials get 401 with ``WWW-Authenticate``, the
   right ones 200, and nothing reaches the native front (it declined);
   (b) 512 /recommend over HTTPS from 8 clients on kept-alive
   connections, each answer's ids the exact float32 top-10 of its
   candidate rows (the model's partitions, held against float64 signs of
   the hash dots, and its ``candidate_indices``), values within 1e-5,
   with the mean candidate share, recall@10 against the exact float32
   scan, p50, p99 and answers/s beside ``BASELINE.md:21``'s, the host's
   core count and the hash count it chose; (c) ``GET /trace?trace=<id>``
   holding a traced request's ``serving.request`` span; (d) ``GET /``
   the ALS console's bytes;
15. native-host: the C++ host code the JAX package moved out of the
   interpreter, each part against its Python path on the same inputs,
   with the seconds of both: (a) 1,000,209 MovieLens-1M-shaped lines
   through the native columnar parser at the speed layer's thread count
   and through the Python parser (the same columns, ids, values and
   timestamps, and the same RatingMatrix); (b) update messages with
   known-id lists and vector JSON for 25,000 rows (100,000 before a
   cut) at 50 and 250
   features, every vector read back equal to its row and non-finite
   values as 0, the Python path on the first 10,000 rows (a cut); (c) the
   native and the Python store filled with the same 250,000 x 50 vectors
   (1M, then 500,000, before cuts):
   ``get_batch`` of 4,096 ids, ``to_matrix``, ``get_vtv`` (within 1e-9
   relative) and ``retain_recent_and_ids`` alike; (d) an IVF index on
   phase 13's catalog and centroids (250 x 1M int8 items, 1,000 cells)
   with the host stage-1 plane, scanned through the flat plane and
   through the tiered cell store (32 hot cells, 64 MiB of RAM, the rest
   in a spill file under a temp dir) at probe-fraction 0.01 with 512
   queries and 0.3 with the first 64 (a cut), each in 4 concurrent
   calls: ids and score bits equal, cells
   on disk, in RAM and hot; then 64
   queries behind the batcher, each group hinting its cells (the hints
   counted);
16. the tables of the XLA-ported ALS ops (phase 8), RDF ops (phase 10)
   and IVF ops (phases 12-13), then the kernel table: launches on the
   main paths (ALS during phases 3-4, k-means during phase 6, each
   counted from zero just before; the scans also by batch rows, per path;
   the als-lambda serving processes' own; those of phase 9b's two; the
   IVF phases' builds and serving; phase 9c's; phase 14's; phase 14b's;
   and phase 14c's) and the numbers of phases 2 and 5, B3's also
   at phase 12's shape;
17. the card's name and power limit, then ``{"ok": true, "device": ...}``.

The run's order is not the phases' numbers: 1 (with 1b beside the
build), 2-5, 8, 10 and 12 one after another; then 7, 9, 9b and 11 (each in a thread of this process,
their layers processes of their own) and 9c (in a process of its own,
``--alone tenants``) at once, beside 6 and then 13 in this process, and
9d (``--alone fleet``) from the end of 6; then 14, 14c, 14b and 15. The phases that time kernels or host code run with nothing
beside them; each phase's clock line gives its own seconds, and the
"beside" line the rest of the wait.

Any failure raises and the exit code is not 0. Without CUDA, or run
from a directory that holds no ``oryx_tpu_torch``, it exits 2 before
printing any result. Weights are random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# peak operations per second by the type of the function's product (see
# kernel_bound()); float32 is the least time of an f32-accurate product
# on this card: six bf16 tensor-core passes over three-piece splits of
# both operands, the TPU's Precision.HIGHEST
PEAK_OPS = {"float32": 989e12 / 6, "bfloat16": 989e12, "int8": 989e12}
SOURCES = {
    "topn_scan.tc": "oryx_tpu_torch/csrc/topn.cu",
    "topn_scan.tc_f32": "oryx_tpu_torch/csrc/topn.cu",
    "topn_merge": "oryx_tpu_torch/csrc/topn.cu",
    "topn_candidates.tc": "oryx_tpu_torch/csrc/topn.cu",
    "topn_candidates.tc_f32": "oryx_tpu_torch/csrc/topn.cu",
    "kmeans_sweep.tc": "oryx_tpu_torch/csrc/kmeans.cu",
}
REPLACES = {
    "topn_scan.tc": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_scan.tc_f32": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_merge": "oryx_tpu/ops/pallas_topn.py:300",
    "topn_candidates.tc": "oryx_tpu/ops/pallas_topn.py:364",
    "topn_candidates.tc_f32": "oryx_tpu/ops/pallas_topn.py:364",
    "kmeans_sweep.tc": "oryx_tpu/ops/pallas_kmeans.py:59",
}
RTOL = 1e-5
# batch rows of the phase-2 scans: the batcher's buckets (serving/batcher.py
# _b_bucket, up to LOCAL_TOPK_BATCH), and one batch past them
SCAN_BATCHES = (8, 16, 32, 64, 128, 256)
CANDIDATES_BATCH = 512
# phase 2 times the plain and library versions in these dot cases only
# (the kernel table's); every case is checked and its kernel timed. All
# 42 cases were once timed: cut to keep the run inside its limit with the
# IVF phases (printed on the "cuts" line)
PHASE2_TIMED = (256, CANDIDATES_BATCH)
# the wide scans: feature counts past the 1,024 whose query pieces stay
# resident in shared memory, on planes of this many items
# (2,048 too until the tenants phase joined the run: cut, with the items
# below, to keep the whole run inside its limit; printed on the "cuts"
# line)
WIDE_FEATURES = (1056, 4096)
# (262,144 until the serving-front phase joined the run, 131,072 until
# the tenants phase did; printed on the "cuts" line)
WIDE_ITEMS = 32_768
WIDE_RUNS = ((8, "topn_scan"), (256, "topn_scan"), (CANDIDATES_BATCH, "topn_candidates"))
# the merge check's synthetic shapes: lists (1221 = the candidates kernel's
# blocks at 20M items), list length and rows
MERGE_LISTS = (1, 2, 7, 33, 1221)
MERGE_M = (1, 16, 64, 128)
MERGE_ROWS = (1, CANDIDATES_BATCH)
# (points, features, clusters) of the k-means kernel phase; the first is
# the repo's k-means training shape (tools/train_benchmark.py:161-170)
# (10,000,000 x 20, k = 10 too until the tenants phase joined the run: cut
# to keep the whole run inside its limit; printed on the "cuts" line)
KMEANS_SHAPES = ((200_000, 20, 10), (1_000_000, 256, 256))
# shapes that take the kernel's other paths: d * 4 not a multiple of 16
# (checked from an unaligned address too), kp > 256 (two center tiles),
# rows too wide for a whole 64-point tile in shared memory (staged in
# chunks; 601 features also by 4-byte copies, with two center tiles), and
# more centers than |c|^2 keeps in shared memory
KMEANS_EXTRA_SHAPES = (
    (100_000, 7, 5), (200_000, 32, 300), (200_000, 768, 10), (50_000, 601, 300),
    (20_000, 16, 10_000),
)

# the IVF phases: the reference load benchmark's widest catalog
# (BASELINE.md:25-31, 250 features x 20M items) clustered around this many
# centers; probe fractions (the default, and the load benchmark's LSH
# sampleRate 0.3 as tools/load_benchmark.py maps it) and batch rows (B1's
# largest bucket, then B2); full probe held to the exact scan within
# check_topk's rtol
IVF_ITEMS = 20_000_000
IVF_CENTERS = 4096
IVF_PROBE_FRACTIONS = (0.01, 0.3)
IVF_BATCHES = (256, 512)
IVF_FULL_RTOL = 1e-5
# ivf-serving: 1M items around as many centers as its 1,000 cells (with
# more centers than cells a cell's centroid mixes several and a center's
# items spread over many cells), users near the same centers, and
# fold-ins past the overlay's 4,096 slots
IVF_SERVING_CENTERS = 1000
IVF_SERVING_USERS = 100_000
IVF_FOLDS = 6_000  # 10,000 before a cut (the cuts line)
# users and items that arrive as UP lines on the update topic in serve();
# the rest go through the batched setters
SERVE_TOPIC_ROWS = 256
PROFILE_S = 2.0  # phase 4's POST /debug/profile window
# the CUDA function of each kernel family, as a profiler trace names it
KERNEL_FUNCTIONS = {"topn_scan": "topn_tc_kernel", "topn_merge": "topn_merge",
                    "kmeans_sweep": "sweep_kernel"}


_OUT = threading.Lock()  # phases beside the main thread print too (main())


def say(line: str) -> None:
    """One line to stdout, whole, whichever thread prints it."""
    with _OUT:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def emit(obj) -> None:
    say(json.dumps(obj))


ALONE_PHASES = ("tenants", "fleet")  # the phases main() runs in a process of their own
# the lock-order watchdog over the alone phases: tests/conftest.py's
# acquire budget for fleet cases
WATCHDOG_ACQUIRE_S = 120.0
LINT_TIMEOUT_S = 300


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--items", type=int, default=1_000_000)
    p.add_argument("--users", type=int, default=1_000_000)
    p.add_argument("--features", type=int, default=250)
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--concurrency", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--als-iterations", type=int, default=ALS_RUN_ITERATIONS,
                   help="iterations of the MovieLens-25M-shaped ALS run (phase 8)")
    p.add_argument("--rdf-rows", type=int, default=RDF_ROWS,
                   help="training rows of rdf-train's parity run and of rdf-lambda; "
                        "rdf-train's covtype-size run scales with it (phases 10-11)")
    # main() runs a phase so, in a process of its own, beside others
    p.add_argument("--alone", choices=ALONE_PHASES, help=argparse.SUPPRESS)
    p.add_argument("--alone-out", help=argparse.SUPPRESS)
    # phase_mesh_procs() runs each of its ranks so
    p.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--mesh-dir", help=argparse.SUPPRESS)
    p.add_argument("--mesh-device", default="cuda", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def factors(gen, rows: int, features: int) -> np.ndarray:
    """Random ALS factors, N(0, 1/features) so that scores are near 1."""
    return gen.standard_normal((rows, features), dtype=np.float32) * (1.0 / np.sqrt(features))


def full_float32(torch) -> None:
    """The float32 references (plain versions, exact_top) in full float32,
    never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(log) -> list[str]:
    """Each kernel of the build log (``-Xptxas -v``) with its registers,
    stack frame and spills, as 'kernel<template args>: ...'."""
    out, name, frame = [], None, ""
    for _, line in log:
        if "Compiling entry function" in line:
            found = re.search(r"\d+([a-z_]+_kernel)(I(?:Li\d+E)+E)?", line)
            args = re.findall(r"Li(\d+)E", found.group(2) or "")
            name = found.group(1) + (f"<{','.join(args)}>" if args else "")
        elif "stack frame" in line:
            frame = line
        elif line.startswith("ptxas info    : Used") and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {frame}")
            name, frame = None, ""
    return out


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """CUDA-event time of reps launches of fn on the device alone: a sleep
    kernel holds the stream while the host queues all of them, so the
    host's own time per call (Python, the wrapper's checks) does not
    count, as it does in time_ms when the host is the slower side."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_topk(what, got_v, got_i, ref_v, ref_i, rtol=RTOL) -> float:
    """Values within rtol*|ref| + rtol*max|ref|; ids identical except at
    positions whose reference score lies within that tolerance of a
    neighbour (a near-tie the two summation orders may break apart).
    Returns the largest absolute value difference."""
    gv, gi = np.asarray(got_v, np.float64), np.asarray(got_i)
    rv, ri = np.asarray(ref_v, np.float64), np.asarray(ref_i)
    if gv.shape != rv.shape or gi.shape != ri.shape:
        raise AssertionError(f"{what}: shapes {gv.shape} vs {rv.shape}")
    if not np.isfinite(gv).all():
        raise AssertionError(f"{what}: non-finite values")
    err = np.abs(gv - rv)
    tol = rtol * np.abs(rv) + rtol * float(np.abs(rv).max())
    if (err > tol).any():
        raise AssertionError(f"{what}: max |err| {err.max()} exceeds tolerance")
    near = np.zeros(ri.shape, bool)
    near[:, 1:] |= np.abs(rv[:, 1:] - rv[:, :-1]) <= tol[:, 1:]
    near[:, :-1] |= np.abs(rv[:, :-1] - rv[:, 1:]) <= tol[:, :-1]
    near[:, -1] = True
    bad = (gi != ri) & ~near
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise AssertionError(f"{what}: id {gi[r, c]} != {ri[r, c]} at row {r} rank {c}")
    return float(err.max())


def kernel_bound(dtype: str, b: int, kf: int, n: int, out_bytes: int) -> tuple[float, str]:
    """Least time for a scan: the bytes it must move (item plane at its
    dtype, the aux row, the queries, the outputs) over 3.35 TB/s against
    2*b*kf*n operations over the peak for their type. float32 planes
    score at float32 accuracy, as the TPU kernel does at
    Precision.HIGHEST; the fastest such product on this card is six
    bfloat16 tensor-core passes (989/6 TFLOP/s). bfloat16 and int8
    planes score a bfloat16 product with float32 accumulation, as the TPU
    kernel does (int8 codes are exact in bfloat16 and take bfloat16 MXU
    passes there), so both count at the bfloat16 tensor-core rate (989
    TFLOP/s), whatever passes the port's kernel makes."""
    item_bytes = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    moved = kf * n * item_bytes + 4 * n + 4 * b * kf + out_bytes
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * kf * n / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2 --------------------------------------------------------------------


def library_sort(torch, q, plane, m):
    """The first yardstick: PyTorch's own matmul and stable sort over the
    whole plane (no aux, no masking); the port never calls it."""
    v, i = torch.sort(torch.matmul(q, plane), dim=1, descending=True, stable=True)
    return v[:, :m], i[:, :m]


def library_topk(torch, q, plane, m):
    """The second yardstick: matmul in the plane's working type and
    torch.topk (no tie order, no aux, no masking); the port never calls
    it."""
    return torch.topk(torch.matmul(q, plane), m, dim=1)


def scan_queries(torch, stn, gen, b: int, features: int, kf: int):
    q = torch.from_numpy(gen.standard_normal((b, features), dtype=np.float32)).cuda()
    return stn._pad_queries(q, kf).contiguous()


def launched(stn, before: dict) -> str:
    """The one launch key whose count grew since ``before`` (a
    ``launch_counts()``): the kernel and path a scan took."""
    grew = [name for name, count in stn.launch_counts().items() if count > before.get(name, 0)]
    if len(grew) != 1:
        raise AssertionError(f"one scan launched {grew}")
    return grew[0]


def phase_kernels(torch, stn, y: np.ndarray, seed: int) -> dict:
    """Every kernel against its plain version on the card; returns, by
    launch key, the record of the representative cases (topn_scan at
    b = 256 and topn_candidates at b = 512, dot: int8 for the ``tc``
    path, float32 for ``tc_f32``; topn_merge after the int8 scan at
    b = 256) with the largest error seen over all cases of that kernel.
    The path of each case is read from the launch counts, so the same
    cases run on another checkout's package (``scan_bench.py --root``)."""
    gen = np.random.default_rng(seed + 1)
    rec: dict[str, dict] = {}
    worst: dict[str, float] = {"topn_merge": 0.0}
    n = y.shape[0]
    k = 16  # the batcher's smallest k bucket
    for dtype in ("float32", "bfloat16", "int8"):
        up = stn.upload_streaming(y, dtype=stn.torch_dtype(dtype), device="cuda")
        quantized = up.scales is not None
        kf = up.mat_t.shape[0]
        m = stn._scan_k(k, n, up.resid)
        sort_plane = up.mat_t.float() if dtype != "bfloat16" else up.mat_t
        work_plane = up.mat_t if dtype != "int8" else up.mat_t.to(torch.bfloat16)
        runs = [(b, "topn_scan") for b in SCAN_BATCHES] + [(CANDIDATES_BATCH, "topn_candidates")]
        for cosine in (False, True):
            aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
            for b, kernel in runs:
                q = scan_queries(torch, stn, gen, b, y.shape[1], kf)
                scan = getattr(stn, kernel)
                plain = getattr(stn, kernel + "_plain")
                before = stn.launch_counts()
                cv, ci = scan(q, up.mat_t, aux, n, m, cosine, quantized)
                name = launched(stn, before)
                kv, ki = stn.topn_merge(cv, ci, m)
                pv, pi = stn.topn_merge_plain(*plain(q, up.mat_t, aux, n, m, cosine, quantized), m)
                torch.cuda.synchronize()
                case = f"{kernel} {dtype} {'cosine' if cosine else 'dot'} b={b} m={m}"
                err = check_topk(case, kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
                worst[name] = max(worst.get(name, 0.0), err)
                # the merge kernel against its plain version on the same lists
                mv, mi = stn.topn_merge_plain(cv, ci, m)
                if not (torch.equal(mv, kv) and torch.equal(mi, ki)):
                    raise AssertionError(f"topn_merge disagrees with its plain version: {case}")
                merge_err = float(torch.where(mv == kv, 0.0, (mv - kv).abs()).max())
                worst["topn_merge"] = max(worst["topn_merge"], merge_err)
                run = lambda: scan(q, up.mat_t, aux, n, m, cosine, quantized)  # noqa: E731
                ms = device_ms(torch, run, 10)
                call_ms = time_ms(torch, run, 10)
                # the plain and library times (each a [b, n] product and a
                # sort) only where the kernel table reads them (PHASE2_TIMED)
                plain_ms = library_ms = library_topk_ms = None
                merge_plain_ms = merge_lib_ms = merge_topk_ms = None
                merge_ms = device_ms(torch, lambda: stn.topn_merge(cv, ci, m), 10)
                if not cosine and b in PHASE2_TIMED:
                    plain_ms = time_ms(
                        torch, lambda: plain(q, up.mat_t, aux, n, m, cosine, quantized), 3
                    )
                    qs, qw = q.to(sort_plane.dtype), q.to(work_plane.dtype)
                    library_ms = time_ms(torch, lambda: library_sort(torch, qs, sort_plane, m), 3)
                    library_topk_ms = time_ms(
                        torch, lambda: library_topk(torch, qw, work_plane, m), 3
                    )
                    merge_plain_ms = time_ms(torch, lambda: stn.topn_merge_plain(cv, ci, m), 3)
                    flat = cv.permute(1, 0, 2).reshape(b, -1).contiguous()
                    merge_lib_ms = time_ms(
                        torch, lambda: torch.sort(flat, dim=1, descending=True, stable=True), 10
                    )
                    merge_topk_ms = time_ms(torch, lambda: torch.topk(flat, m, dim=1), 10)
                    del flat
                cand_bytes = cv.numel() * 8
                bound_ms, bound_by = kernel_bound(dtype, b, y.shape[1], n, cand_bytes)
                merge_bound = (cand_bytes + b * m * 8) / HBM_BYTES_PER_S * 1e3
                emit({
                    "phase": "kernels", "case": case, "path": name, "lists": int(cv.shape[0]),
                    "max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library_topk_ms": library_topk_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
                    "merge_max_abs_err": merge_err, "merge_ms": merge_ms,
                    "merge_plain_ms": merge_plain_ms, "merge_library_ms": merge_lib_ms,
                    "merge_library_topk_ms": merge_topk_ms, "merge_bound_ms": merge_bound,
                })
                if not cosine and dtype in ("float32", "int8") and b in (256, CANDIDATES_BATCH):
                    rec[name] = dict(
                        ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                        library_topk_ms=library_topk_ms, bound_ms=bound_ms, bound_by=bound_by,
                    )
                    if dtype == "int8" and b == 256:
                        rec["topn_merge"] = dict(
                            ms=merge_ms, plain_ms=merge_plain_ms, library_ms=merge_lib_ms,
                            library_topk_ms=merge_topk_ms, bound_ms=merge_bound,
                            bound_by="bytes",
                        )
                del cv, ci, kv, ki, pv, pi, mv, mi
        del up, sort_plane, work_plane
        torch.cuda.empty_cache()
    check_planted_ties(torch, stn, y, seed)
    check_merge(torch, stn, seed)
    for name in rec:
        rec[name]["max_abs_err"] = worst[name]
    return rec


def check_planted_ties(torch, stn, y: np.ndarray, seed: int) -> None:
    """Exact ties through the scan, every plane type: item 1234 scaled by 3 and
    copied into items 60,000-60,299 of a 131,067-item plane (bit-identical
    columns, so every summation order ties them exactly), and row 0 of
    each query batch is that item, so its whole top-m is the tie run. The
    kernel's ids must be the plain version's exactly (the lowest ids of
    the run, in order), its row-0 values one value; the other rows are
    held to check_topk."""
    gen = np.random.default_rng(seed + 2)
    n, dup = 131_072 - 5, 1234
    yt = y[:n].copy()
    yt[dup] *= 3.0
    yt[60_000:60_300] = yt[dup]
    for dtype in ("float32", "bfloat16", "int8"):
        up = stn.upload_streaming(yt, dtype=stn.torch_dtype(dtype), device="cuda")
        quantized = up.scales is not None
        kf = up.mat_t.shape[0]
        m = stn._scan_k(16, n, up.resid)
        want = [dup] + list(range(60_000, 60_000 + m - 1))
        for cosine in (False, True):
            aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
            runs = ((8, "topn_scan"), (64, "topn_scan"), (CANDIDATES_BATCH, "topn_candidates"))
            for b, kernel in runs:
                q = torch.from_numpy(gen.standard_normal((b, y.shape[1]), dtype=np.float32))
                q[0] = torch.from_numpy(yt[dup])
                q = stn._pad_queries(q.cuda(), kf).contiguous()
                scan = getattr(stn, kernel)
                plain = getattr(stn, kernel + "_plain")
                kv, ki = stn.topn_merge(*scan(q, up.mat_t, aux, n, m, cosine, quantized), m)
                pv, pi = stn.topn_merge_plain(*plain(q, up.mat_t, aux, n, m, cosine, quantized), m)
                kv, ki, pv, pi = kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu()
                case = f"planted ties {kernel} {dtype} {'cosine' if cosine else 'dot'} b={b} m={m}"
                if pi[0].tolist() != want:
                    raise AssertionError(f"{case}: the plain version does not see the ties")
                if ki[0].tolist() != want:
                    raise AssertionError(f"{case}: ids {ki[0].tolist()[:8]}... out of id order")
                if len(set(kv[0].tolist())) != 1:
                    raise AssertionError(f"{case}: the tied scores differ in the kernel")
                err = check_topk(case, kv[1:], ki[1:], pv[1:], pi[1:])
                emit({"phase": "kernels", "case": case, "ties_in_lowest_id_order": True,
                      "tied_value": float(kv[0, 0]), "plain_tied_value": float(pv[0, 0]),
                      "other_rows_max_abs_err": err})
        del up
        torch.cuda.empty_cache()


def check_widest_query_tile(torch, stn, n: int, seed: int) -> None:
    """The scan's widest query tile, N = 128, which the 250-feature plane
    never gets (its staged products and candidate buffers leave no room):
    at the reference's narrower published shape, 50 features, a bfloat16
    plane at k = 16 (m = 16) and an int8 plane at k = 8 (m = 32, a direct
    call: the batcher asks for k >= 16); a float32 plane, whose three
    resident query pieces leave room for N = 128 only up to 32 features,
    at the ALS default of 10 features, k = 16. Each takes it at b = 128
    and 256, as ``tc_plan`` must confirm; each case, dot and cosine,
    against its plain version under check_topk."""
    gen = np.random.default_rng(seed + 3)
    planes = {d: factors(gen, n, d) for d in (50, 10)}
    for dtype, k, d in (("bfloat16", 16, 50), ("int8", 8, 50), ("float32", 16, 10)):
        up = stn.upload_streaming(planes[d], dtype=stn.torch_dtype(dtype), device="cuda")
        quantized = up.scales is not None
        kf = up.mat_t.shape[0]
        m = stn._scan_k(k, n, up.resid)
        for b in (128, 256):
            tile = stn.tc_plan(b, kf, m, up.mat_t.dtype)[0]
            if tile != 128:
                raise AssertionError(f"{dtype} b={b} m={m} kf={d} took query tile {tile}, not 128")
            q = scan_queries(torch, stn, gen, b, d, kf)
            for cosine in (False, True):
                aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
                case = f"topn_scan {dtype} {'cosine' if cosine else 'dot'} b={b} m={m} kf={d}"
                kv, ki = stn.topn_merge(*stn.topn_scan(q, up.mat_t, aux, n, m, cosine, quantized),
                                        m)
                pv, pi = stn.topn_merge_plain(
                    *stn.topn_scan_plain(q, up.mat_t, aux, n, m, cosine, quantized), m
                )
                err = check_topk(case, kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
                ms = device_ms(
                    torch, lambda: stn.topn_scan(q, up.mat_t, aux, n, m, cosine, quantized), 10
                )
                bound_ms, bound_by = kernel_bound(dtype, b, d, n, 0)
                emit({"phase": "kernels", "case": case, "query_tile": tile, "max_abs_err": err,
                      "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by})
        del up
        torch.cuda.empty_cache()


def check_wide_scans(torch, stn, seed: int) -> None:
    """The scans past 1,024 features, whose query pieces no longer stay in
    shared memory and stream beside the items (``ScanPlan.streamed``):
    every plane type, dot and cosine, topn_scan at b = 8 and 256 and
    topn_candidates at b = 512, at WIDE_FEATURES x WIDE_ITEMS, each
    against its plain version under check_topk and on the ``tc`` /
    ``tc_f32`` launch key of its plane type, with its device time beside
    kernel_bound() and the matmul + topk yardstick."""
    gen = np.random.default_rng(seed + 5)
    for d in WIDE_FEATURES:
        y = factors(gen, WIDE_ITEMS, d)
        for dtype in ("float32", "bfloat16", "int8"):
            up = stn.upload_streaming(y, dtype=stn.torch_dtype(dtype), device="cuda")
            quantized = up.scales is not None
            kf = up.mat_t.shape[0]
            m = stn._scan_k(16, WIDE_ITEMS, up.resid)
            work_plane = up.mat_t if dtype != "int8" else up.mat_t.to(torch.bfloat16)
            path = "tc_f32" if dtype == "float32" else "tc"
            for cosine in (False, True):
                aux = stn._fold_aux(up.norms, up.scales, cosine).contiguous()
                for b, kernel in WIDE_RUNS:
                    q = scan_queries(torch, stn, gen, b, d, kf)
                    scan = getattr(stn, kernel)
                    plain = getattr(stn, kernel + "_plain")
                    case = f"wide {kernel} {dtype} {'cosine' if cosine else 'dot'} b={b} m={m} kf={d}"
                    plan = stn.tc_plan(b, kf, m, up.mat_t.dtype)
                    if not plan.streamed:
                        raise AssertionError(f"{case}: the plan keeps the query resident: {plan}")
                    before = stn.launch_counts()
                    cv, ci = scan(q, up.mat_t, aux, WIDE_ITEMS, m, cosine, quantized)
                    name = launched(stn, before)
                    if name != f"{kernel}.{path}":
                        raise AssertionError(f"{case}: took {name}, not {kernel}.{path}")
                    kv, ki = stn.topn_merge(cv, ci, m)
                    pv, pi = stn.topn_merge_plain(
                        *plain(q, up.mat_t, aux, WIDE_ITEMS, m, cosine, quantized), m
                    )
                    torch.cuda.synchronize()
                    err = check_topk(case, kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
                    del kv, ki, pv, pi
                    ms = device_ms(
                        torch, lambda: scan(q, up.mat_t, aux, WIDE_ITEMS, m, cosine, quantized), 5
                    )
                    qw = q.to(work_plane.dtype)
                    library_topk_ms = time_ms(
                        torch, lambda: library_topk(torch, qw, work_plane, m), 3
                    )
                    bound_ms, bound_by = kernel_bound(dtype, b, d, WIDE_ITEMS, cv.numel() * 8)
                    emit({
                        "phase": "kernels", "case": case, "path": name,
                        "plan": {"query_tile": plan.tile, "stages": plan.stages,
                                 "streamed": plan.streamed},
                        "max_abs_err": err, "ms": ms, "library_topk_ms": library_topk_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
                    })
                    del cv, ci, qw
            del up, work_plane
            torch.cuda.empty_cache()
        del y


UPLOAD_RANDOM_NORM_RTOL = 2e-6  # card against numpy norms: float32 sums in two orders


def check_upload_random(torch, stn, n: int, features: int, seed: int) -> None:
    """``ops/topn.upload_random`` on the card at the serving shape, float32
    and int8: the handle equals ``upload()`` of its matrix read back
    (``random_items``), plane for plane and bit for bit, but for the norms,
    summed on the card and held to ``upload()``'s within
    UPLOAD_RANDOM_NORM_RTOL relative; and a scan over it (topn_scan,
    b = 256, dot, merged) equals its plain version."""
    from oryx_tpu_torch.ops import topn

    gen = np.random.default_rng(seed + 5)
    out = {"phase": "upload-random", "items": n, "features": features}
    for dtype in ("float32", "int8"):
        t0 = time.perf_counter()
        h = topn.upload_random(n, features, dtype, seed=seed)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
        mat = topn.random_items(n, features, seed=seed).cpu().numpy()
        t0 = time.perf_counter()
        ref = topn.upload(mat, dtype)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        del mat
        if (h.n_items, h.features) != (ref.n_items, ref.features):
            raise AssertionError(f"upload_random {dtype}: shape {h.n_items, h.features}")
        for name in ("mat_t", "scales", "resid", "resid_scales"):
            a, b = getattr(h, name), getattr(ref, name)
            same = (a is None and b is None) or (
                a is not None and b is not None and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
            if not same:
                raise AssertionError(f"upload_random {dtype}: its {name} is not upload()'s "
                                     "of its matrix read back")
        # the norms are summed on the card, in another order than numpy's
        if h.norms.shape != ref.norms.shape or h.norms.dtype != ref.norms.dtype:
            raise AssertionError(f"upload_random {dtype}: its norms' shape or type")
        norm_err = float(((h.norms - ref.norms).abs()
                          / ref.norms.clamp_min(torch.finfo(torch.float32).tiny)).max())
        if not norm_err <= UPLOAD_RANDOM_NORM_RTOL or bool((h.norms[0, n:] != 0).any()):
            raise AssertionError(f"upload_random {dtype}: its norms differ from upload()'s "
                                 f"by {norm_err} relative (tolerance {UPLOAD_RANDOM_NORM_RTOL})")
        del ref
        q = scan_queries(torch, stn, gen, 256, features, h.mat_t.shape[0])
        aux = stn._fold_aux(h.norms, h.scales, False).contiguous()
        m = stn._scan_k(16, n, h.resid)
        before = stn.launch_counts()
        cv, ci = stn.topn_scan(q, h.mat_t, aux, n, m, False, h.quantized)
        path = launched(stn, before)
        kv, ki = stn.topn_merge(cv, ci, m)
        pv, pi = stn.topn_merge_plain(
            *stn.topn_scan_plain(q, h.mat_t, aux, n, m, False, h.quantized), m)
        err = check_topk(f"upload_random {dtype} topn_scan b=256", kv.cpu(), ki.cpu(),
                         pv.cpu(), pi.cpu())
        out[dtype] = {"generate_s": generate_s, "upload_s": upload_s, "path": path,
                      "max_abs_err": err, "norms_max_rel_err": norm_err}
        del h, q, aux, cv, ci, kv, ki, pv, pi
        torch.cuda.empty_cache()
    emit(out)


def merge_lists(torch, gen, s: int, b: int, m: int):
    """[S, b, m] lists as the scans leave them: each best first, values on
    a coarse grid (so equal values meet within and across lists), ids of
    list s below list s + 1's and ascending among equal values, each list
    ending in a random run of (-inf, INT_MAX) padding (whole lists
    included); at b > 1, row 1 holds a single value in every list and
    row 0 is padding but for the first half of list 0, so that padding
    reaches the merged list."""
    dev = "cuda"
    # + 0.0 leaves no -0.0, which the ordering of one sort or another may
    # set apart from 0.0
    v = torch.round(torch.randn((s, b, m), generator=gen, device=dev) * 2) / 4 + 0.0
    v = torch.sort(v, dim=2, descending=True).values
    rank = torch.arange(m, device=dev)
    ids = (torch.arange(s, device=dev)[:, None, None] * m + rank).expand(s, b, m)
    kept = m - torch.randint(0, m + 1, (s, b, 1), generator=gen, device=dev)
    if b > 1:
        v[:, 1] = 0.5
        kept[:, 0] = 0
        kept[0, 0] = m // 2
    v = torch.where(rank >= kept, -math.inf, v)
    ids = torch.where(rank >= kept, 2**31 - 1, ids)
    return v.contiguous(), ids.to(torch.int32).contiguous()


def check_merge(torch, stn, seed: int) -> None:
    """topn_merge bit for bit against topn_merge_plain on synthetic lists
    (merge_lists) at every S of MERGE_LISTS, m of MERGE_M and b of
    MERGE_ROWS; at b = 512 with its time beside both yardsticks (a stable
    torch.sort and torch.topk over the flattened lists, which the port
    never calls) and its byte bound."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 4)
    for s in MERGE_LISTS:
        for m in MERGE_M:
            for b in MERGE_ROWS:
                cv, ci = merge_lists(torch, gen, s, b, m)
                kv, ki = stn.topn_merge(cv, ci, m)
                pv, pi = stn.topn_merge_plain(cv, ci, m)
                case = f"topn_merge S={s} b={b} m={m}"
                if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
                    raise AssertionError(f"{case}: disagrees with its plain version")
                out = {"phase": "kernels", "case": case, "bit_identical": True}
                if b > 1:
                    flat = cv.permute(1, 0, 2).reshape(b, -1).contiguous()
                    out.update(
                        ms=device_ms(torch, lambda: stn.topn_merge(cv, ci, m), 10),
                        plain_ms=time_ms(torch, lambda: stn.topn_merge_plain(cv, ci, m), 3),
                        library_ms=time_ms(
                            torch, lambda: torch.sort(flat, dim=1, descending=True, stable=True),
                            3,
                        ),
                        library_topk_ms=time_ms(torch, lambda: torch.topk(flat, m, dim=1), 3),
                        bound_ms=(cv.numel() + b * m) * 8 / HBM_BYTES_PER_S * 1e3,
                        bound_by="bytes",
                    )
                    del flat
                emit(out)
                del cv, ci, kv, ki, pv, pi
    torch.cuda.empty_cache()


# -- profiler traces (phases 4 and 6) ---------------------------------------------


def read_trace(directory: str) -> list:
    """The events of the Chrome trace ``common/profiling.py`` wrote."""
    with open(os.path.join(directory, "trace.json")) as f:
        return json.load(f)["traceEvents"]


def device_op_name(name: str) -> str:
    """A device event's name less ``void``, the anonymous namespace and
    the argument list: ``topn_tc_kernel<8, 0, false>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0][:80]


def trace_summary(events: list, window: str) -> dict:
    """The card's side of a trace over the ``window`` annotation's span:
    its busy share (the union of kernel intervals over the window), the
    kernel events by function, the five device ops (kernels, copies,
    memsets) that took the most time, and the CPU-side events by kind."""
    (win,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == window]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    spans = sorted(
        (max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
        for e in events if e.get("cat") == "kernel"
    )
    busy, end = 0.0, w0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    totals, counts = {}, {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            name = device_op_name(e["name"])
            totals[name] = totals.get(name, 0.0) + e["dur"] / 1e3
            if e["cat"] == "kernel":
                fn = name.split("<")[0]
                counts[fn] = counts.get(fn, 0) + 1
    cpu = {}
    for e in events:
        if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation", "python_function"):
            cpu[e["cat"]] = cpu.get(e["cat"], 0) + 1
    return {
        "window_ms": win["dur"] / 1e3, "busy_share": busy / win["dur"] if win["dur"] else 0.0,
        "kernel_events": counts, "cpu_events": cpu,
        "top_device_ops_ms": sorted(totals.items(), key=lambda t: -t[1])[:5],
    }


def check_trace_kernels(what: str, summary: dict, families) -> bool:
    """Each kernel family of ``families`` in the trace; False, with the
    finding printed on a line of its own, when the profiler recorded no
    CUDA activity at all on this host."""
    if not summary["kernel_events"]:
        emit({"finding": f"{what}: torch.profiler recorded no CUDA activity on this host"})
        return False
    for family in families:
        fn = KERNEL_FUNCTIONS[family]
        if not any(name.startswith(fn) for name in summary["kernel_events"]):
            raise AssertionError(f"{what}: no {fn} events in the trace: {summary}")
    return True


def profile_under_load(base: str, urls: list, seconds: float = PROFILE_S) -> dict:
    """POST /debug/profile?seconds=N while ``len(urls)`` clients keep
    sending ``urls``; returns the capture's trace summary."""
    result = {}

    def post():
        req = urllib.request.Request(f"{base}/debug/profile?seconds={seconds}", data=b"",
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                result["status"], result["body"] = resp.status, json.loads(resp.read())
        except Exception as e:  # raised again below, in the phase's thread
            result["error"] = e

    poster = threading.Thread(target=post)
    by_status = {}
    with ThreadPoolExecutor(len(urls)) as pool:
        poster.start()
        while poster.is_alive():
            for status, _, _ in pool.map(http_get, urls):
                by_status[status] = by_status.get(status, 0) + 1
    poster.join()
    # the clients never pause, so the admission ladder may shed some (429)
    if set(by_status) - {200, 429}:
        raise AssertionError(f"/recommend under the profiler: {by_status}")
    if "error" in result:
        raise result["error"]
    if result["status"] != 200 or result["body"]["seconds"] != seconds:
        raise AssertionError(f"POST /debug/profile answered {result}")
    summary = trace_summary(read_trace(result["body"]["path"]), "serving-ondemand")
    if summary["cpu_events"].get("user_annotation", 0) < 1:
        raise AssertionError("the profile holds no CPU events")
    return {"requests_during": by_status, **summary}


# -- phases 3 and 4 ---------------------------------------------------------------


def http_get(url: str) -> tuple[int, bytes, float]:
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, resp.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def exact_top(torch, stn, y_dev, x_rows: np.ndarray, k: int):
    """Exact float32 top-k on the card (plain scan, ties to the lowest
    id): (values, ids) as numpy."""
    q = torch.from_numpy(np.ascontiguousarray(x_rows)).to(y_dev.device)
    aux = y_dev.norms
    v, i = stn.topn_merge_plain(
        *stn.topn_scan_plain(q, y_dev.mat_t, aux, y_dev.n_items, k, False, False), k
    )
    return v.cpu().numpy(), i.cpu().numpy()


def serving_config(broker_loc: str, score_dtype: str, extra: str = ""):
    from oryx_tpu_torch.common import config as config_utils

    return config_utils.get_default().with_overlay(
        f"""
        oryx {{
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          als.serving.score-dtype = "{score_dtype}"
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
            application-resources = "oryx_tpu_torch.app.als"
          }}
          {extra}
        }}
        """
    )


def publish_model(broker_loc: str, features: int, x: np.ndarray, y: np.ndarray,
                  generation: str | None = None) -> None:
    """A MODEL naming the first SERVE_TOPIC_ROWS users and items (carrying
    ``generation`` as the batch layer's do, when given), then their rows
    as UP messages (each user knowing one item), on the update topic."""
    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.common import pmml as pmml_io
    from oryx_tpu_torch.common.text import join_json

    n_topic = SERVE_TOPIC_ROWS
    root = pmml_io.build_skeleton_pmml()
    app_pmml.add_extension(root, "features", features)
    app_pmml.add_extension(root, "implicit", "true")
    if generation is not None:
        app_pmml.add_extension(root, "generation", generation)
    app_pmml.add_extension_content(root, "XIDs", [f"u{j}" for j in range(n_topic)])
    app_pmml.add_extension_content(root, "YIDs", [f"i{j}" for j in range(n_topic)])
    with bus.get_broker(broker_loc).producer("OryxUpdate") as p:
        p.send("MODEL", pmml_io.to_string(root))
        for j in range(n_topic):
            p.send("UP", join_json(["Y", f"i{j}", [float(v) for v in y[j]]]))
        for j in range(n_topic):
            known = [f"i{(j + 1) % n_topic}"]
            p.send("UP", join_json(["X", f"u{j}", [float(v) for v in x[j]], known]))


def start_serving(args, score_dtype: str, x: np.ndarray, y: np.ndarray, first_user: int,
                  broker_loc: str | None = None, extra: str = "",
                  generation: str | None = None):
    """Start the port's ServingLayer (on an inproc bus unless
    ``broker_loc`` names one, ``extra`` added to its config), feed it over
    the update topic (the MODEL carrying ``generation`` as the batch
    layer's do, when given) and the batched setters, and send one
    /recommend (for ``first_user``), which builds the card copy of Y and
    stages X; returns (layer, model, base URL, the seconds of each step)."""
    from oryx_tpu_torch.serving.layer import ServingLayer

    broker_loc = broker_loc or f"inproc://chip-smoke-{score_dtype}"
    t_start = time.perf_counter()
    layer = ServingLayer(serving_config(broker_loc, score_dtype, extra))
    layer.start()
    n_topic = SERVE_TOPIC_ROWS
    publish_model(broker_loc, args.features, x, y, generation)
    base = f"http://127.0.0.1:{layer.port}"
    deadline = time.monotonic() + 120
    while http_get(base + "/ready")[0] != 200:
        if time.monotonic() > deadline:
            raise AssertionError("/ready never turned 200")
        time.sleep(0.05)
    ready_s = time.perf_counter() - t_start
    model = layer.model_manager.get_model()
    # the rest arrives through the batched setters the columnar replay uses
    t0 = time.perf_counter()
    model.set_item_vectors([f"i{j}" for j in range(n_topic, len(y))], y[n_topic:])
    model.set_user_vectors([f"u{j}" for j in range(n_topic, len(x))], x[n_topic:])
    load_s = time.perf_counter() - t0
    # first request builds the card copy of Y and starts the X restage
    status, _, first_s = http_get(f"{base}/recommend/u{first_user}")
    if status != 200:
        raise AssertionError(f"warm-up /recommend answered {status}")
    t0 = time.perf_counter()
    model._x_restage_thread.join(600)
    restage_s = time.perf_counter() - t0
    if model._x_matrix is None:
        raise AssertionError("the user matrix was not staged on the card")
    return layer, model, base, dict(ready_s=ready_s, load_s=load_s, first_request_s=first_s,
                                    restage_s=restage_s)


def serve(torch, args, score_dtype: str, x: np.ndarray, y: np.ndarray, probe_users,
          broker_loc: str | None = None, extra: str = "", generation: str | None = None):
    """start_serving(), then the requests: ``args.requests`` /recommend
    from ``args.concurrency`` threads over ``probe_users``, then
    /recommendToAnonymous, /similarity and /estimate; returns (layer,
    model, {user: ids}, {user: values}, latencies, statuses)."""
    n_topic = SERVE_TOPIC_ROWS
    layer, model, base, info = start_serving(args, score_dtype, x, y, probe_users[0],
                                             broker_loc, extra, generation)
    urls = [f"{base}/recommend/u{u}" for u in probe_users]
    urls = (urls * (args.requests // len(urls) + 1))[: max(args.requests, len(urls))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.concurrency) as pool:
        results = list(pool.map(http_get, urls))
    requests_s = time.perf_counter() - t0
    statuses = [r[0] for r in results]
    bodies = {}
    for url, (status, body, _) in zip(urls, results):
        if status == 200:
            bodies[url.rsplit("/u", 1)[1]] = json.loads(body)
    others = [
        f"{base}/recommendToAnonymous/i{n_topic + 1}=1.0/i{n_topic + 2}",
        f"{base}/similarity/i{n_topic + 3}/i{n_topic + 4}",
        f"{base}/estimate/u{probe_users[1]}/i0/i{n_topic + 5}",
    ]
    others_s = []
    for url in others:
        status, body, seconds = http_get(url)
        others_s.append(seconds)
        statuses.append(status)
        if status != 200 or not json.loads(body):
            raise AssertionError(f"{url} answered {status}")
    lat = sorted(r[2] * 1e3 for r in results)
    # the seconds of each step: start to /ready, the setters, the first
    # request (the card copy of Y or the IVF build), the X restage, the
    # timed requests, /recommendToAnonymous, /similarity and /estimate
    return layer, model, bodies, statuses, lat, dict(
        **info, requests_s=requests_s, others_s=others_s)


# -- phases 5 and 6: k-means -------------------------------------------------------


def gaussian_blobs(n: int, d: int, k: int, seed: int):
    """(points [n, d] f32, true centers [k, d]): k centers at 6 N(0, 1),
    unit noise, as tools/train_benchmark.py:163-166 makes them."""
    gen = np.random.default_rng(seed)
    centers = 6.0 * gen.standard_normal((k, d))
    labels = gen.integers(0, k, n)
    pts = centers[labels].astype(np.float32)
    pts += gen.standard_normal((n, d), dtype=np.float32)
    return pts, centers


def sweep_bound(n: int, d: int, kp: int, k: int) -> tuple[float, str]:
    """Least time for one Lloyd sweep: the bytes it must move (points,
    centers in, sums, counts and cost out) over 3.35 TB/s against
    2*n*k*d + n*d float32 operations (the TPU kernel's HIGHEST; the
    kp - k padded centers need no product) at the card's f32-accurate
    rate, six bf16 tensor-core passes (PEAK_OPS)."""
    t_bytes = (n * d + 2 * kp * d + kp + 1) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = (2.0 * n * k * d + n * d) / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_sweep(torch, what, pts, ctr, n, k, got, ref):
    """Kernel sweep ``got`` against the plain ``ref`` (each sums, counts,
    cost): counts equal except where a point's two smallest distances lie
    within 1e-5 relative (a near tie the two summation orders may break
    apart); sums within rtol 1e-5 of max |sum| plus those points' share;
    cost within rtol 1e-5. Returns the comparison's numbers."""
    sums, counts, cost = (t.double() for t in got)
    rsums, rcounts, rcost = (t.double() for t in ref)
    d2 = torch.cat([
        torch.topk(
            torch.where(
                torch.arange(ctr.shape[0], device=ctr.device)[None, :] < k,
                torch.sum(blk * blk, 1, keepdim=True) - 2.0 * (blk @ ctr.T)
                + torch.sum(ctr * ctr, 1)[None, :],
                torch.inf,
            ),
            2, dim=1, largest=False,
        ).values
        for blk in torch.split(pts[:n], 1 << 20)
    ])
    near = (d2[:, 1] - d2[:, 0]) <= 1e-5 * d2[:, 1].abs()
    n_near = int(near.sum())
    share = float(pts[:n][near].abs().sum(0).max()) if n_near else 0.0
    count_diff = (counts - rcounts).abs()
    sums_err = float((sums - rsums).abs().max())
    scale = float(rsums.abs().max())
    cost_rel = float((cost - rcost).abs().max() / rcost.abs().max())
    out = {
        "near_ties": n_near, "count_abs_diff": float(count_diff.sum()),
        "sums_max_abs_err": sums_err, "sums_scale": scale, "near_share": share,
        "cost_rel_err": cost_rel,
    }
    if float(count_diff.max()) > n_near or float(count_diff.sum()) > 2 * n_near:
        raise AssertionError(
            f"{what}: counts differ by {count_diff.sum()} with {n_near} near ties"
        )
    if sums_err > RTOL * scale + share:
        raise AssertionError(f"{what}: sums differ by {sums_err} (scale {scale}, share {share})")
    if cost_rel > RTOL:
        raise AssertionError(f"{what}: cost differs by {cost_rel} relative")
    if float(counts.sum()) != n:
        raise AssertionError(f"{what}: counts sum to {float(counts.sum())}, not {n}")
    return out


def library_sweep(torch, pts, ctr, n: int, k: int):
    """The yardstick: the fewest PyTorch calls that compute the sweep (f32
    matmul distances, padded centers masked, torch.min, index_add_,
    bincount, the cost's sum); the port never calls it."""
    p = pts[:n]
    d2 = torch.sum(p * p, 1, keepdim=True) - 2.0 * (p @ ctr.T) + torch.sum(ctr * ctr, 1)
    d2[:, k:] = torch.inf
    mind2, a = torch.min(d2, dim=1)
    sums = torch.zeros_like(ctr).index_add_(0, a, p)
    counts = torch.bincount(a, minlength=ctr.shape[0])
    return sums, counts, mind2.clamp_min(0).sum()


def check_non_finite_rows(torch, pk, pts, ctr, k) -> dict:
    """The sweep against its plain version on 3,000 rows (2,900 real) with a
    NaN row, a row with one inf feature, a row whose squared norm
    overflows float32, and a NaN padding row: counts equal, sums within
    rtol 1e-5 and finite, cost NaN in both."""
    bad = pts[:3000].clone()
    n = 2900
    bad[5] = math.nan
    bad[777, 2] = math.inf
    bad[1500] = 1e20
    bad[2950] = math.nan  # padding: counts for nothing
    got = pk.sweep(bad, ctr, n, k)
    ref = pk.sweep_plain(bad, ctr, n, k)
    torch.cuda.synchronize()
    what = "sweep non-finite rows"
    if not torch.equal(got[1], ref[1]):
        raise AssertionError(f"{what}: counts differ")
    if float(got[1].sum()) != n - 2:  # the NaN and inf rows go to no center
        raise AssertionError(f"{what}: counts sum to {float(got[1].sum())}, not {n - 2}")
    if not (bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(ref[0]).all())):
        raise AssertionError(f"{what}: a sum is not finite")
    err = float((got[0].double() - ref[0].double()).abs().max())
    if err > RTOL * float(ref[0].abs().max()):
        raise AssertionError(f"{what}: sums differ by {err}")
    if not (math.isnan(float(got[2][0])) and math.isnan(float(ref[2][0]))):
        raise AssertionError(f"{what}: cost {float(got[2][0])}, plain {float(ref[2][0])}")
    out = {"phase": "kmeans-kernels", "case": what, "counts": float(got[1].sum()),
           "sums_max_abs_err": err, "cost": "nan"}
    emit(out)
    return out


def phase_kmeans_kernels(torch, pk, seed: int, scale: float = 1.0, device="cuda") -> dict:
    """The sweep against its plain version on the card at KMEANS_SHAPES and
    KMEANS_EXTRA_SHAPES (the odd-d one also from an unaligned address),
    the sweep through the public ``pk.sweep`` only, so that ``scan_bench.py
    --phase kmeans`` runs it on another checkout's package; returns the record of
    the first shape (the main path's) with the largest error and the near
    ties over all shapes, keyed by the launch key the sweeps took."""
    dev = torch.device(device)
    first = None
    worst, near_ties = 0.0, 0
    shapes = [(s, False) for s in KMEANS_SHAPES] + [(s, False) for s in KMEANS_EXTRA_SHAPES]
    shapes.insert(len(KMEANS_SHAPES) + 1, (KMEANS_EXTRA_SHAPES[0], True))
    for i, ((n, d, k), unaligned) in enumerate(shapes):
        n = max(1024, int(n * scale))
        pts_np, _ = gaussian_blobs(n, d, k, seed + 100 + i)
        gen = np.random.default_rng(seed + 200 + i)
        kp = pk.padded_k(k)
        pts = torch.from_numpy(pk.pad_to_block(pts_np)).to(dev)
        ctr = torch.zeros((kp, d), dtype=torch.float32, device=dev)
        ctr[:k] = torch.from_numpy(pts_np[gen.choice(n, size=k, replace=False)]).to(dev)
        del pts_np
        if unaligned:  # row 1 on: 28 bytes past the allocation, not 16-byte aligned
            pts = pts[1:]
            n -= 1
        before = pk.launch_counts()
        got = pk.sweep(pts, ctr, n, k)
        keys = sorted(name for name, c in pk.launch_counts().items() if c > before.get(name, 0))
        ref = pk.sweep_plain(pts, ctr, n, k)
        again = pk.sweep(pts, ctr, n, k)
        torch.cuda.synchronize()
        case = f"sweep n={n} d={d} k={k}" + (" unaligned" if unaligned else "")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{case}: two launches disagree")
        cmp = check_sweep(torch, case, pts, ctr, n, k, got, ref)
        if i == 0:
            check_non_finite_rows(torch, pk, pts, ctr, k)
        del ref, again
        torch.cuda.empty_cache()
        run = lambda: pk.sweep(pts, ctr, n, k)  # noqa: E731
        ms = device_ms(torch, run, 10)
        call_ms = time_ms(torch, run, 10)
        plain_ms = time_ms(torch, lambda: pk.sweep_plain(pts, ctr, n, k), 3)
        library_ms = time_ms(torch, lambda: library_sweep(torch, pts, ctr, n, k), 10)
        bound_ms, bound_by = sweep_bound(n, d, kp, k)
        worst = max(worst, cmp["sums_max_abs_err"])
        near_ties += cmp["near_ties"]
        plan = pk.sweep_plan(kp, d, n, dev)[1] if dev.type == "cuda" else None
        emit({
            "phase": "kmeans-kernels", "case": case, "kp": kp, "launch_keys": keys,
            "plan": plan, **cmp, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / ms,
        })
        if i == 0:
            first = (keys, dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound_ms, bound_by=bound_by))
        del pts, ctr, got
        torch.cuda.empty_cache()
    keys, rec = first
    rec.update(max_abs_err=worst, near_ties=near_ties)
    return {name: dict(rec) for name in keys}


def kmeans_config(broker_loc: str, root: str, d: int, k: int, minibatch: int | None,
                  extra: str = ""):
    from oryx_tpu_torch.common import config as config_utils

    features = ", ".join(f'"{j}"' for j in range(d))
    mb = f"ml.kmeans.minibatch-size = {minibatch}" if minibatch else ""
    return config_utils.get_default().with_overlay(
        f"""
        oryx {{
          id = "ChipSmokeKMeans"
          input-topic.broker = "{broker_loc}"
          update-topic.broker = "{broker_loc}"
          input-schema {{ num-features = {d}, numeric-features = [{features}] }}
          kmeans.hyperparams.k = {k}
          batch {{
            update-class = "oryx_tpu_torch.app.kmeans.update:KMeansUpdate"
            storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
          }}
          serving {{
            api.port = 0
            model-manager-class = "oryx_tpu_torch.app.kmeans.serving:KMeansServingModelManager"
            application-resources = "oryx_tpu_torch.app.kmeans.serving"
          }}
          {mb}
          {extra}
        }}
        """
    )


def check_served_clusters(what, base, clusters, lines, pts, true_centers, gen):
    """/assign and /distanceToNearest for 1,000 sampled points against a
    float64 numpy nearest-center search over the served centers (a list
    of ClusterInfo); every true center given within 0.5 of a trained one."""
    ids = np.array([c.id for c in clusters])
    centers = np.stack([c.center for c in clusters]).astype(np.float64)
    for true in true_centers:
        gap = float(np.min(np.linalg.norm(centers - true, axis=1)))
        if gap > 0.5:
            raise AssertionError(f"{what}: a true center is {gap} from every trained one")
    sample = gen.choice(len(lines), size=1000, replace=False)
    exp_d = np.linalg.norm(pts[sample][:, None, :] - centers[None, :, :], axis=2)
    exp_id = ids[np.argmin(exp_d, axis=1)]
    exp_dist = exp_d.min(axis=1)
    body = "\n".join(lines[j] for j in sample).encode()
    req = urllib.request.Request(base + "/assign", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        got = [int(v) for v in json.loads(resp.read())]
    if got != exp_id.tolist():
        bad = int(np.sum(np.asarray(got) != exp_id))
        raise AssertionError(f"{what}: /assign disagrees with numpy on {bad} points")
    for n_probe, (j, e_id, e_dist) in enumerate(zip(sample, exp_id, exp_dist)):
        if n_probe < 100:  # the GET route too, on a tenth of the sample
            status, body, _ = http_get(f"{base}/assign/{lines[j]}")
            if status != 200 or int(json.loads(body)) != int(e_id):
                raise AssertionError(f"{what}: GET /assign answered {status} {body!r}")
        status, body, _ = http_get(f"{base}/distanceToNearest/{lines[j]}")
        if status != 200 or abs(float(json.loads(body)) - e_dist) > 1e-6 * e_dist:
            raise AssertionError(
                f"{what}: /distanceToNearest answered {status} {body!r}, not {e_dist!r}"
            )


def phase_kmeans_batch(pk, seed: int, scale: float = 1.0) -> dict:
    """Two generations of the port's k-means batch layer, served by the
    port's serving layer; returns the kernels' launches (from zero at the
    start of this phase, the k-means main path)."""
    import io
    import tempfile

    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app.kmeans import common as km
    from oryx_tpu_torch.common import pmml as pmml_io
    from oryx_tpu_torch.lambda_.batch import BatchLayer
    from oryx_tpu_torch.ops import kmeans as km_ops
    from oryx_tpu_torch.serving.layer import ServingLayer

    n, d, k = max(1024, int(KMEANS_SHAPES[0][0] * scale)), 20, 10
    pts32, true_centers = gaussian_blobs(n, d, k, seed + 300)
    buf = io.StringIO()
    np.savetxt(buf, pts32, fmt="%.6f", delimiter=",")
    lines = buf.getvalue().splitlines()
    pts = np.loadtxt(io.StringIO(buf.getvalue()), delimiter=",", dtype=np.float64)
    del buf
    gen = np.random.default_rng(seed + 301)
    loc = "inproc://chip-smoke-kmeans"
    root = tempfile.mkdtemp(prefix="chip-smoke-kmeans-")
    serving = ServingLayer(kmeans_config(loc, root, d, k, None))
    serving.start()
    base = f"http://127.0.0.1:{serving.port}"
    pk.reset_launch_counts()  # the k-means main path starts here
    profile_dir = os.path.join(root, "profile")
    try:
        # the first generation traced (oryx.batch.compute.profile-dir)
        batch = BatchLayer(kmeans_config(
            loc, root, d, k, None, f'batch.compute.profile-dir = "{profile_dir}"'))
        batch.prepare()
        with bus.get_broker(loc).producer("OryxInput") as producer:
            producer.send_many([(None, line) for line in lines])
        out = {"phase": "kmeans-batch", "points": n, "features": d, "k": k}
        for gen_no, minibatch in ((1, None), (2, 10_000)):
            if minibatch:
                batch.close()  # the next generation's layer resumes the group's offsets
                batch = BatchLayer(kmeans_config(loc, root, d, k, minibatch))
                batch.prepare()
            ts = int(time.time() * 1000)
            sweeps0 = pk.launch_counts()["kmeans_sweep.tc"]
            t0 = time.perf_counter()
            batch.run_one_generation(timestamp_ms=ts)
            gen_s = time.perf_counter() - t0
            profile = None
            if gen_no == 1:
                (traced,) = os.listdir(profile_dir)
                profile = trace_summary(read_trace(os.path.join(profile_dir, traced)),
                                        "batch-generation")
                profile["sweep_launches"] = pk.launch_counts()["kmeans_sweep.tc"] - sweeps0
                check_trace_kernels("kmeans-batch generation 1", profile, ("kmeans_sweep",))
                shutil.rmtree(profile_dir)
            update = batch._update
            if minibatch and (update.minibatch_size != minibatch
                              or update.previous_generation_id is None):
                raise AssertionError("the second generation did not warm-start mini-batch")
            published = os.path.join(root, "model", str(ts), "model.pmml")
            want = np.stack([c.center for c in km.pmml_to_clusters(pmml_io.read_pmml(published))])
            deadline = time.monotonic() + 120
            while True:
                model = serving.model_manager.get_model()
                if model is not None and http_get(base + "/ready")[0] == 200:
                    have = np.stack([c.center for c in model.clusters()])
                    if have.shape == want.shape and np.array_equal(have, want):
                        break
                if time.monotonic() > deadline:
                    raise AssertionError(f"generation {gen_no} never reached serving")
                time.sleep(0.05)
            check_served_clusters(
                f"generation {gen_no}", base, model.clusters(), lines, pts, true_centers, gen
            )
            out[f"gen{gen_no}"] = {
                "seconds": gen_s, "minibatch": minibatch, "profile": profile,
                "warm_start_from": update.previous_generation_id,
                "train_kmeans_phase_s": dict(km_ops.last_phase_seconds),
                "mlupdate_phase_s": dict(update.last_phase_seconds),
            }
        batch.close()
    finally:
        serving.close()
    launches = pk.launch_counts()  # the k-means main path ends here
    out["launches"] = launches
    emit(out)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the k-means batch path")
    return launches


# -- phase 7: the k-means lambda loop as three processes ----------------------------

LAMBDA_WAVE = 20_000  # points of waves 2 and 3
LAMBDA_BODY_LINES = 4_000  # CSV lines per POST /add
# the batch process's generation interval, which the lambda phases wait
# out: once 45 s, cut to keep the whole run inside its limit (printed as
# a cut): 20 s where the phase posts its input after the batch process
# starts (als-lambda, rdf-lambda: 20 s leaves the POSTs more than 10 s),
# 30 s for kmeans-lambda, which posts wave 1 before it starts and whose
# checks stop it after generation 1 (15 s until PR 17, when a loaded
# window delayed the stop past the interval and a second generation
# began), 30 s for buses (a), whose POSTs take 12 s under the faults
LAMBDA_BATCH_INTERVAL_S = 20
KMEANS_LAMBDA_INTERVAL_S = 30
CHAOS_BATCH_INTERVAL_S = 30
LAMBDA_TIMEOUT_S = 600  # the longest any one step may take


_PORTS_GIVEN: set = set()  # never hand out one port twice, to phases running at once
_PORTS_LOCK = threading.Lock()


def free_port() -> int:
    import socket

    with _PORTS_LOCK:
        while True:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            if port not in _PORTS_GIVEN:
                _PORTS_GIVEN.add(port)
                return port


def lambda_conf(root: str, d: int, k: int, ports: dict, batch_interval: int) -> str:
    """The three layers' config: one file: bus, oryx.id set (offsets
    persist), reference.conf defaults otherwise, the batch and speed
    metrics UIs on the given ports."""
    features = ", ".join(f'"{j}"' for j in range(d))
    return f"""
    oryx {{
      id = "ChipSmokeLambda"
      input-topic.broker = "file:{root}/bus"
      update-topic.broker = "file:{root}/bus"
      input-schema {{ num-features = {d}, numeric-features = [{features}] }}
      kmeans.hyperparams.k = {k}
      batch {{
        streaming.generation-interval-sec = {batch_interval}
        update-class = "oryx_tpu_torch.app.kmeans.update:KMeansUpdate"
        storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
        ui.port = {ports["batch"]}
      }}
      speed {{
        streaming.generation-interval-sec = 1
        model-manager-class = "oryx_tpu_torch.app.kmeans.speed:KMeansSpeedModelManager"
        ui.port = {ports["speed"]}
      }}
      serving {{
        api.port = {ports["serving"]}
        model-manager-class = "oryx_tpu_torch.app.kmeans.serving:KMeansServingModelManager"
        application-resources = "oryx_tpu_torch.app.kmeans.serving"
      }}
    }}
    """


def start_layer(layer: str, conf: str, root: str, device: str, run: int, extra=()):
    """``python -m oryx_tpu_torch <layer> --conf <conf> [extra]`` from the
    checkout, its output in <root>/logs/<layer>-<run>.log: (process, log
    path)."""
    log_path = os.path.join(root, "logs", f"{layer}-{run}.log")
    cmd = [sys.executable, "-m", "oryx_tpu_torch", layer, "--conf", conf, *extra]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=log_file, stderr=subprocess.STDOUT)
    return proc, log_path


def wait_until(what: str, pred, timeout: float = LAMBDA_TIMEOUT_S, procs=()):
    """Poll pred() every 50 ms until it is truthy (returned), failing when
    the time runs out or one of procs has exited."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        for name, proc in procs:
            if proc.poll() is not None:
                raise AssertionError(f"{what}: the {name} process exited ({proc.returncode})")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.05)


def print_tails(logs: list[str]) -> None:
    """The last 3,000 characters of each log, to standard error."""
    for path in logs:
        with open(path, errors="replace") as f:
            tail = f.read()[-3000:]
        print(f"--- {path} (tail) ---\n{tail}", file=sys.stderr, flush=True)


def log_has(path: str, text: str, count: int = 1) -> bool:
    with open(path, errors="replace") as f:
        return f.read().count(text) >= count


# the native HTTP front's body ceiling (oryx.serving.native.max-body-bytes,
# reference.conf's default): it answers a larger body 413
MAX_BODY_BYTES = 1 << 20


def split_bodies(lines: list[str], max_lines: int) -> list[list[str]]:
    """``lines`` in bodies of at most ``max_lines`` lines and
    MAX_BODY_BYTES bytes."""
    bodies, body, size = [], [], 0
    for line in lines:
        n = len(line.encode()) + 1
        if body and (len(body) == max_lines or size + n > MAX_BODY_BYTES):
            bodies.append(body)
            body, size = [], 0
        body.append(line)
        size += n
    bodies.append(body)
    return bodies


def post_bodies(url: str, lines: list[str], max_lines: int) -> float:
    """POST ``lines`` to ``url`` in split_bodies' bodies, each answered
    204; the monotonic time the last answer came."""
    for body in split_bodies(lines, max_lines):
        req = urllib.request.Request(url, data=("\n".join(body) + "\n").encode(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            if resp.status != 204:
                raise AssertionError(f"POST {url} answered {resp.status}")
    return time.monotonic()


def post_lines(base: str, lines: list[str]) -> float:
    return post_bodies(base + "/add", lines, LAMBDA_BODY_LINES)


def hist_summary(snapshot: dict) -> dict:
    """count, sum, mean and max of a histogram's snapshot (seconds)."""
    return {key: snapshot.get(key) for key in ("count", "sum", "mean", "max")}


def scrape(port: int) -> dict:
    """A layer's metrics registry, from its UI."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        return json.loads(resp.read())


def update_topic_state(loc: str):
    """(clusters of the last MODEL, {id: (center, count)} after the UPs
    that followed it, the MODELs on the topic, the ids those UPs moved),
    read off the update topic as serving replays it."""
    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.app.kmeans import common as km

    consumer = bus.get_broker(loc).consumer("OryxUpdate", from_beginning=True)
    model, state, models, moved = None, {}, 0, set()
    try:
        while True:
            records = consumer.poll(10_000, 0.2)
            if not records:
                break
            for rec in records:
                if rec.key in ("MODEL", "MODEL-REF"):
                    pmml = app_pmml.read_pmml_from_update_message(rec.key, rec.message)
                    model = km.pmml_to_clusters(pmml)
                    state = {c.id: (np.asarray(c.center, np.float64), c.count) for c in model}
                    models, moved = models + 1, set()
                elif rec.key == "UP" and model is not None:
                    cid, center, count = json.loads(rec.message)
                    state[int(cid)] = (np.asarray(center, np.float64), int(count))
                    moved.add(int(cid))
    finally:
        consumer.close()
    return model, state, models, moved


def running_mean(state: dict, pts: np.ndarray):
    """The speed layer's fold, in float64: each point to its nearest
    center, each center the weighted mean of itself and its points.
    Returns (new state, {id: points folded})."""
    ids = sorted(state)
    centers = np.stack([state[i][0] for i in ids])
    near = np.argmin(((pts[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2), axis=1)
    new, added = dict(state), {}
    for j in np.unique(near):
        cid, (center, count) = ids[j], state[ids[j]]
        sel = pts[near == j]
        new[cid] = ((center * count + sel.sum(axis=0)) / (count + len(sel)), count + len(sel))
        added[cid] = len(sel)
    return new, added


def status_of(url: str) -> int | None:
    """The HTTP status of a GET, or None while nothing listens."""
    try:
        return http_get(url)[0]
    except (urllib.error.URLError, ConnectionError):
        return None


def first_generation(what: str, base: str, batch_port: int, procs: dict, stop) -> tuple[float, dict]:
    """Poll serving's /ready at base and the batch process's generation
    count together, and stop the batch process (``stop("batch")``) the
    moment its first generation has ended: its next generation begins one
    interval after this one's end, and one cut short by the stop can leave
    a MODEL with only part of its UPs on the update topic. Returns (the
    monotonic time /ready first answered 200, the batch process's metrics
    at the generation's end). ``procs`` is the phase's live {name: process}."""
    got: dict = {}

    def both():
        if "ready" not in got and status_of(base + "/ready") == 200:
            got["ready"] = time.monotonic()
        if "metrics" not in got:
            try:
                m = scrape(batch_port)
            except (urllib.error.URLError, ConnectionError):
                return False  # its UI not listening yet
            if m.get("batch.generations", {}).get("value", 0) >= 1:
                got["metrics"] = m
                if stop("batch") != 0:
                    raise AssertionError(f"{what}: the batch process did not stop cleanly")
        return len(got) == 2

    # procs.items() is a view: once stopped, the batch process leaves it
    wait_until(what, both, procs=procs.items())
    return got["ready"], got["metrics"]


def served_matches(base: str, want: dict, cid: int) -> bool:
    """Serving answers cluster cid's expected center with cid at distance
    0 (within 1e-9 of its norm), and the bus's center agrees to 1e-9."""
    center = want[cid][0]
    path = ",".join(repr(float(v)) for v in center)
    status, body, _ = http_get(f"{base}/distanceToNearest/{path}")
    if status != 200 or float(json.loads(body)) > 1e-9 * float(np.linalg.norm(center)):
        return False
    status, body, _ = http_get(f"{base}/assign/{path}")
    return status == 200 and int(json.loads(body)) == cid


def phase_kmeans_lambda(seed: int, scale: float = 1.0, device: str = "cuda",
                        batch_interval: int = KMEANS_LAMBDA_INTERVAL_S) -> dict:
    """The k-means lambda loop as three OS processes on one file: bus
    (``python -m oryx_tpu_torch batch|speed|serving``): wave 1, the
    training set, through serving's /add; the batch process, started
    after it at offsets committed before it, trains one generation on all
    of it, served exactly; wave 2 folded by the speed process and
    served as the float64 running mean; the speed process restarted;
    wave 3 folded with no record consumed twice or lost. Returns the
    phase's record, the batch process's kernel launches included."""
    import io
    import signal
    import tempfile

    n = max(2_000, int(KMEANS_SHAPES[0][0] * scale))
    d, k = KMEANS_SHAPES[0][1], KMEANS_SHAPES[0][2]
    wave = max(200, int(LAMBDA_WAVE * scale))
    pts32, true_centers = gaussian_blobs(n, d, k, seed + 400)
    gen = np.random.default_rng(seed + 401)
    # waves 2 and 3 around blob 0 moved by +1.0 in every feature
    moved = true_centers[0] + 1.0
    later = [(moved + gen.standard_normal((wave, d))).astype(np.float32) for _ in range(2)]
    texts = []
    for block in [pts32] + later:
        buf = io.StringIO()
        np.savetxt(buf, block, fmt="%.6f", delimiter=",")
        texts.append(buf.getvalue())
    lines = [t.splitlines() for t in texts]
    values = [np.loadtxt(io.StringIO(t), delimiter=",", dtype=np.float64) for t in texts]
    del texts, pts32, later

    root = tempfile.mkdtemp(prefix="chip-smoke-lambda-")
    os.makedirs(os.path.join(root, "logs"))
    ports = {name: free_port() for name in ("batch", "speed", "serving")}
    conf = os.path.join(root, "oryx.conf")
    with open(conf, "w") as f:
        f.write(lambda_conf(root, d, k, ports, batch_interval))
    loc = f"file:{root}/bus"
    base = f"http://127.0.0.1:{ports['serving']}"
    procs: dict = {}
    logs: list[str] = []
    out = {"phase": "kmeans-lambda", "points": n, "features": d, "k": k, "wave_points": wave,
           "bus": "file:", "batch_interval_s": batch_interval}

    def start(layer: str, run: int = 1):
        procs[layer], path = start_layer(layer, conf, root, device, run)
        logs.append(path)
        return path

    def stop(layer: str) -> int:
        procs[layer].send_signal(signal.SIGTERM)
        return procs.pop(layer).wait(timeout=120)

    def live():
        return list(procs.items())

    try:
        from oryx_tpu_torch import bus
        from oryx_tpu_torch.app.kmeans import common as km

        start("serving")
        speed_log = start("speed")
        # consumer groups start at the topic's end: wave 1 waits until the
        # speed layer has attached its group, and until the batch group's
        # offsets are committed at the end of the (empty) input topic
        wait_until("layers up", lambda: log_has(speed_log, "SpeedLayer started")
                   and status_of(base + "/ready") == 503, procs=live())
        input_broker = bus.get_broker(loc)
        batch_group = "OryxGroup-batch-ChipSmokeLambda"
        attach = input_broker.consumer("OryxInput", group=batch_group)
        attach.commit()
        attach.close()
        t_post = time.monotonic()
        t_last = post_lines(base, lines[0])
        out["wave1_post_s"] = t_last - t_post
        # the batch process starts after wave 1 is in and resumes at the
        # committed offsets: its first generation drains all of wave 1,
        # wherever its interval timer falls against the POST
        start("batch")

        # wave 1: the batch process's generation, served exactly; the
        # batch process stops as soon as generation 1 ends, before
        # serving is checked: its next generation, one interval after this
        # one's end, retrains on wave 1 and publishes a second MODEL, which
        # on a loaded host lands while the check's 2,100 requests run (and
        # later ones would retrain on waves 2-3 over the speed layer's folds)
        ready_at, metrics_batch = first_generation("generation 1", base, ports["batch"], procs, stop)
        out["wave1_staleness_s"] = ready_at - t_last
        latest = input_broker.latest_offsets("OryxInput")
        drained = input_broker.get_offsets(batch_group, "OryxInput")
        if drained != latest or sum(latest.values()) != n:
            raise AssertionError(f"generation 1 drained {drained} of {latest} ({n} posted)")
        out["batch_generation_s"] = hist_summary(metrics_batch["batch.generation.seconds"])
        out["batch_launches"] = {
            name.split(".", 1)[1].rsplit(".", 1)[0]: int(m["value"])
            for name, m in metrics_batch.items()
            if name.startswith("kernels.") and name.endswith(".launches")
        }
        # the speed process holds the model and has read all of wave 1, so
        # no UP moves a center while the check runs
        wait_until("the speed model", lambda: log_has(speed_log, "k-means speed model"),
                   procs=live())
        speed_group = "OryxGroup-speed-ChipSmokeLambda"
        wait_until("wave 1 committed by the speed process",
                   lambda: input_broker.get_offsets(speed_group, "OryxInput") == latest,
                   timeout=30, procs=live())
        _, state, models, moved = update_topic_state(loc)  # the model and any UP since
        if models != 1:
            raise AssertionError(f"the update topic holds {models} MODELs, not generation 1's")
        out["wave1_speed_moved"] = len(moved)
        wait_until("wave 1's UPs served",
                   lambda: all(served_matches(base, state, c) for c in moved),
                   timeout=30, procs=live())
        served = [km.ClusterInfo(cid, center, count) for cid, (center, count) in state.items()]
        check_served_clusters("wave 1", base, served, lines[0], values[0], true_centers, gen)
        expected = dict(state)
        base_counts = {cid: count for cid, (_, count) in state.items()}
        folded = {cid: 0 for cid in state}
        out["speed_batch_s"] = []
        for wave_no, (wave_lines, wave_pts) in enumerate(zip(lines[1:], values[1:]), start=2):
            if wave_no == 3:  # restart the speed process: it resumes, and replays the updates
                out["speed_batch_s"].append(
                    hist_summary(scrape(ports["speed"])["speed.batch.seconds"])
                )
                if stop("speed") != 0:
                    raise AssertionError("the speed process did not stop cleanly")
                speed_log = start("speed", run=2)
                wait_until("the restarted speed model",
                           lambda: log_has(speed_log, "k-means speed model"), procs=live())
                # the UPs behind the MODEL replay in the same pass, in
                # microseconds; a second's margin before wave 3 arrives
                time.sleep(1.0)
            expected, added = running_mean(expected, wave_pts)
            for cid, c in added.items():
                folded[cid] += c
            t_last = post_lines(base, wave_lines)
            moved_ids = sorted(added)
            wait_until(f"wave {wave_no} served",
                       lambda: all(served_matches(base, expected, c) for c in moved_ids),
                       procs=live())
            out[f"wave{wave_no}_staleness_s"] = time.monotonic() - t_last
            # every cluster as the bus has it (serving replays the same):
            # the running mean, and the model's count plus the waves' points
            _, state, _, _ = update_topic_state(loc)
            for cid, (center, count) in expected.items():
                got_center, got_count = state[cid]
                rel = float(np.linalg.norm(got_center - center) / np.linalg.norm(center))
                if rel > 1e-9 or got_count != base_counts[cid] + folded[cid]:
                    raise AssertionError(
                        f"wave {wave_no}: cluster {cid} holds {got_count} points, not "
                        f"{base_counts[cid]} + {folded[cid]}, at {rel:.3g} relative from "
                        "the running mean"
                    )
            wait_until(f"wave {wave_no} committed",
                       lambda: input_broker.get_offsets(speed_group, "OryxInput")
                       == input_broker.latest_offsets("OryxInput"), timeout=30, procs=live())
            out[f"wave{wave_no}_folded"] = {str(c): added[c] for c in moved_ids}
        out["speed_batch_s"].append(hist_summary(scrape(ports["speed"])["speed.batch.seconds"]))
        for layer in list(procs):
            if stop(layer) != 0:
                raise AssertionError(f"the {layer} process did not stop cleanly")
    except BaseException:
        print_tails(logs)
        raise
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=60)
    emit(out)
    return out


# -- phase 8: ALS training and fold-in on the card ------------------------------------

# MovieLens-shaped synthetic ratings (tools/train_benchmark.py:60-79 and
# :109-125), at published dataset shapes: (users, items, ratings)
ML100K = (943, 1682, 100_000)
ML1M = (6_040, 3_706, 1_000_209)
ML25M = (162_541, 59_047, 25_000_095)
ALS_SCALE_RANK = 200  # BASELINE.json's MovieLens-25M configuration
ALS_SCALE_ITERATIONS = 10  # reference.conf; bench_als_scale's 3 is the cut
# the scale run's iterations by default: cut to 5, then 3, to
# keep the whole run inside its limit; the phase prints the cut
ALS_RUN_ITERATIONS = 3
ALS_CHECK_ROWS = 512  # user rows of the scale run solved again on the CPU
ALS_FOLD_EVENTS = 100_000
ALS_FOLD_RANKS = (50, 200)
FACTOR_TOL = dict(rtol=2e-2, atol=2e-3)  # tests/ops/test_als_ops.py:378
FOLD_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/ops/test_als_ops.py:178


def movielens_shape(num_users: int, num_items: int, nnz: int, seed: int):
    """tools/train_benchmark.py:60-79's generator at any size: uniform
    users, power-law items (zipf 1.3), unique pairs in random order and a
    rank-8 taste plus noise mapped to 1-5 stars by quantile. At the
    MovieLens-100K shape and seed 17 it gives that tool's data bit for
    bit; larger shapes draw more pairs until enough are unique."""
    gen = np.random.default_rng(seed)
    r = 8
    xt = gen.standard_normal((num_users, r)) / np.sqrt(r)
    yt = gen.standard_normal((num_items, r)) / np.sqrt(r)
    draws = 2 * nnz
    while True:
        pop = gen.zipf(1.3, size=draws) % num_items
        u = gen.integers(0, num_users, draws).astype(np.int32)
        key = np.unique(u.astype(np.int64) * num_items + pop)
        if len(key) >= nnz:
            break
        draws *= 2
    gen.shuffle(key)
    key = key[:nnz]
    u, i = (key // num_items).astype(np.int32), (key % num_items).astype(np.int32)
    raw = np.einsum("nk,nk->n", xt[u], yt[i]) + 0.35 * gen.standard_normal(nnz)
    qs = np.quantile(raw, [0.1, 0.3, 0.6, 0.85])
    return u, i, (1.0 + np.digitize(raw, qs)).astype(np.float32)


def power_law_ratings(num_users: int, num_items: int, nnz: int, seed: int = 99):
    """tools/train_benchmark.py:109-125's implicit set: power-law users and
    items (pareto-like weights), strengths in [1, 2)."""
    gen = np.random.default_rng(seed)
    uw = (1.0 / (np.arange(num_users) + 10.0)) ** 0.8
    iw = (1.0 / (np.arange(num_items) + 10.0)) ** 0.9
    u = gen.choice(num_users, size=nnz, p=uw / uw.sum()).astype(np.int32)
    i = gen.choice(num_items, size=nnz, p=iw / iw.sum()).astype(np.int32)
    return u, i, (1.0 + gen.random(nnz)).astype(np.float32)


def ops_bound(moved_bytes: float, operations: float) -> tuple[float, str]:
    """The larger of bytes over 3.35 TB/s and float32 operations over
    989/6 TFLOP/s (kernel_bound()'s float32 rate), in ms."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = operations / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(what: str, got, want, rtol: float, atol: float) -> float:
    """|got - want| <= atol + rtol * |want| everywhere; the largest
    absolute difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape}, or non-finite")
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.size} beyond rtol {rtol}, atol {atol} "
            f"(max |err| {err.max():.3g})"
        )
    return float(err.max())


class StageTimer:
    """``_sweep_buckets``' stage hook: CUDA events around every "gram" and
    "solve" piece, summed into device ms."""

    def __init__(self, torch):
        self.torch = torch
        self.events: dict[str, list] = {"gram": [], "solve": []}

    def __call__(self, name: str):
        import contextlib

        torch, events = self.torch, self.events[name]

        @contextlib.contextmanager
        def span():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            events.append((start, end))

        return span()

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        return {n: sum(s.elapsed_time(e) for s, e in ev) for n, ev in self.events.items()}

    def pieces(self) -> dict:
        return {n: len(ev) for n, ev in self.events.items()}


def als_parity(als, device: str) -> dict:
    """(a) tools/train_benchmark.py:81-105: MovieLens-100K shape, 90/10
    split, explicit, rank 25, lam 0.1, 10 sweeps, seed 42; the card
    against the CPU through the same port code, float32 and bfloat16."""
    num_users, num_items, nnz = ML100K
    u, i, v = movielens_shape(num_users, num_items, nnz, 17)
    test = np.random.default_rng(5).random(len(u)) < 0.1
    out = {}
    for md in (None, "bfloat16"):
        runs = {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            model = als.train_als(
                u[~test], i[~test], v[~test], num_users, num_items, features=25, lam=0.1,
                implicit=False, iterations=10, seed=42, matmul_dtype=md, device=dev,
            )
            wall = time.perf_counter() - t0
            phases = dict(als.last_phase_seconds)
            pred = als.predict_pairs(model.x, model.y, u[test], i[test], device=dev)
            rmse = float(np.sqrt(np.mean((pred - v[test]) ** 2)))
            runs[dev] = (pred, rmse, {"wall_s": wall, **phases})
        (pred_d, rmse_d, secs_d), (pred_c, rmse_c, secs_c) = runs[device], runs["cpu"]
        name = md or "float32"
        pred_err = float(np.abs(pred_d.astype(np.float64) - pred_c).max())
        out[name] = {"rmse_card": rmse_d, "rmse_cpu": rmse_c, "max_pred_diff": pred_err,
                     "seconds_card": secs_d, "seconds_cpu": secs_c}
        if md is None and (pred_err > 1e-3 or abs(rmse_d - rmse_c) > 1e-4):
            raise AssertionError(
                f"ALS at the MovieLens-100K shape: card and CPU predictions differ by "
                f"{pred_err:.3g}, RMSE {rmse_d} against {rmse_c}"
            )
        if not (np.isfinite(pred_d).all() and np.isfinite(rmse_d)):
            raise AssertionError(f"ALS {name}: non-finite predictions on the card")
    return out


def als_scale(torch, als, packing, iterations: int, seed: int, device: str = "cuda",
              scale: float = 1.0) -> tuple[dict, dict]:
    """(b) the MovieLens-25M-shaped implicit set, rank 200, lam 0.01,
    alpha 1, float32 and bfloat16: times, memory, the multi-worker pack,
    finite factors, one half-sweep by stage, 512 users of it solved again
    on the CPU, the solve against a batched LU, mean_auc. Returns (record,
    ops rows)."""
    num_users, num_items, nnz = (max(1_000, int(n * scale)) for n in ML25M)
    k = ALS_SCALE_RANK
    t0 = time.perf_counter()
    u, i, v = power_law_ratings(num_users, num_items, nnz)
    out = {"shape": [num_users, num_items, nnz], "rank": k, "iterations": iterations, "lam": 0.01,
           "alpha": 1.0, "data_s": time.perf_counter() - t0}
    models = {}
    for md in (None, "bfloat16"):
        torch.cuda.reset_peak_memory_stats()
        model = als.train_als(u, i, v, num_users, num_items, features=k, lam=0.01, alpha=1.0,
                              implicit=True, iterations=iterations, seed=seed,
                              matmul_dtype=md, device=device)
        secs = dict(als.last_phase_seconds)
        workers = int(packing.last_pack_stats.get("workers", 0))
        if workers <= 1:
            raise AssertionError(f"ALS packing took {workers} worker(s), not the forked path")
        if not (np.isfinite(model.x).all() and np.isfinite(model.y).all()):
            raise AssertionError(f"ALS {md or 'float32'} at scale: non-finite factors")
        out[md or "float32"] = {
            **secs, "pack_workers": workers,
            "ratings_per_s": nnz * iterations / secs["iterate"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        models[md or "float32"] = model
    model = models["float32"]

    # one half-sweep each way on the trained factors, by stage
    users_pad, items_pad = als._pow2_at_least(num_users + 1), als._pow2_at_least(num_items + 1)
    u_buckets = als.build_neighbor_buckets(u, i, v, num_users, features=k)
    i_buckets = als.build_neighbor_buckets(i, u, v, num_items, features=k)
    y = torch.zeros((items_pad, k), device=device)
    y[:num_items] = torch.from_numpy(model.y).to(device)
    x = torch.zeros((users_pad, k), device=device)
    x[:num_users] = torch.from_numpy(model.x).to(device)
    u_args, i_args = als.bucket_tensors(u_buckets, device), als.bucket_tensors(i_buckets, device)
    als._sweep_buckets(y, users_pad, u_args, 0.01, 1.0, True)  # warm
    sweeps = {}
    for side, other, pad, args in (("users", y, users_pad, u_args),
                                   ("items", x, items_pad, i_args)):
        timer = StageTimer(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solved = als._sweep_buckets(other, pad, args, 0.01, 1.0, True, stage=timer)
        torch.cuda.synchronize()
        sweeps[side] = {"wall_ms": (time.perf_counter() - t0) * 1e3, "ms": timer.ms(),
                        "pieces": timer.pieces(),
                        "rows": int(sum(len(a[0]) for a in args))}
        if side == "users":
            x_dev = solved[:num_users].cpu().numpy()
    out["half_sweep"] = sweeps

    # 512 users of that half-sweep solved again by the port on the CPU
    gen = np.random.default_rng(seed)
    real = [(b, int(np.count_nonzero(b.rows >= 0))) for b in u_buckets]
    total = sum(n for _, n in real)
    pick = np.sort(gen.choice(total, size=ALS_CHECK_ROWS, replace=False))
    sub, start = [], 0
    for b, n in real:
        sel = pick[(pick >= start) & (pick < start + n)] - start
        start += n
        if len(sel):
            sub.append((torch.from_numpy(b.rows[sel].astype(np.int64)),
                        torch.from_numpy(b.idx[sel]), torch.from_numpy(b.val[sel]),
                        torch.from_numpy(b.deg[sel]), b.chunk))
    y_cpu = y.cpu()
    t0 = time.perf_counter()
    x_cpu = als._sweep_buckets(y_cpu, users_pad, sub, 0.01, 1.0, True).numpy()
    rows = np.concatenate([a[0].numpy() for a in sub])
    out["cpu_check"] = {
        "rows": len(rows), "cpu_s": time.perf_counter() - t0,
        "max_abs_err": check_close("half-sweep users, card against CPU", x_dev[rows],
                                   x_cpu[rows], **FACTOR_TOL),
    }

    # the solve against a batched LU on one piece of real systems
    b0 = max(u_args, key=lambda a: len(a[0]))
    piece = min(len(b0[0]), als.SOLVE_ELEMS // (k * k))
    cidx, cval, cdeg = b0[1][:piece], b0[2][:piece], b0[3][:piece]
    cmask = (torch.arange(cidx.shape[1], device=device)[None, :] < cdeg[:, None]).float()
    vg = y.index_select(0, cidx.reshape(-1)).view(*cidx.shape, k) * cmask[..., None]
    a, bvec = als._normal_equations(vg, cval, cmask, y.T @ y, 0.01, 1.0, True, k)
    chol_ms = device_ms(torch, lambda: als._solve(a, bvec), 5)
    lu_ms = device_ms(torch, lambda: torch.linalg.solve_ex(a, bvec[..., None])[0], 5)
    lu_err = float((als._solve(a, bvec) - torch.linalg.solve_ex(a, bvec[..., None])[0][..., 0])
                   .abs().max())
    out["solve_piece"] = {"rows": piece, "k": k, "cholesky_ms": chol_ms, "lu_ms": lu_ms,
                          "max_abs_diff": lu_err}
    del a, bvec, vg

    # mean_auc on 1% of the ratings as test pairs
    test = gen.random(nnz) < 0.01
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    auc = als.mean_auc(model.x, model.y, u[test], i[test], np.random.default_rng(seed), device=device)
    auc_ms = (time.perf_counter() - t0) * 1e3
    out["mean_auc"] = {"pairs": int(test.sum()), "auc": auc, "wall_ms": auc_ms}
    if not 0.5 < auc <= 1.0:
        raise AssertionError(f"ALS at scale: AUC {auc} on training pairs")

    # the ops table: one generation = `iterations` sweeps of both sides
    r_u, r_i = sweeps["users"]["rows"], sweeps["items"]["rows"]
    gram_bytes = nnz * 2 * (8 + 4 * k) + (r_u + r_i) * (4 + 4 * k * k + 4 * k)
    gram_ops = 2 * nnz * 2 * (k * k + k) + 2 * 2 * (num_users + num_items) * k * k
    solve_bytes = (r_u + r_i) * (4 * k * k + 8 * k)
    solve_ops = (r_u + r_i) * 2 * k ** 3 / 3
    auc_slots = int(test.sum()) * 2
    rows = {
        "als_gram": {
            "what": "gather + normal equations, one sweep (users + items)",
            "ms": sweeps["users"]["ms"]["gram"] + sweeps["items"]["ms"]["gram"],
            "launches": (sweeps["users"]["pieces"]["gram"] + sweeps["items"]["pieces"]["gram"])
            * iterations,
            "bound": ops_bound(gram_bytes, gram_ops),
        },
        "als_solve": {
            "what": "batched Cholesky solves, one sweep (users + items)",
            "ms": sweeps["users"]["ms"]["solve"] + sweeps["items"]["ms"]["solve"],
            "launches": (sweeps["users"]["pieces"]["solve"] + sweeps["items"]["pieces"]["solve"])
            * iterations,
            "bound": ops_bound(solve_bytes, solve_ops),
            "library_ms_one_piece": lu_ms, "ms_one_piece": chol_ms,
        },
        "mean_auc": {
            "what": f"mean_auc over {int(test.sum())} pairs (wall, host sampling included)",
            "ms": auc_ms, "launches": 1,
            "bound": ops_bound(auc_slots * 4 * k, 2 * auc_slots * k),
        },
    }
    return out, rows


def als_fold(torch, als, seed: int, device: str = "cuda") -> tuple[dict, dict]:
    """(c) fold_in_batch of 100,000 events at k = 50 and 200, on the card
    against the host, a singular Gramian, and events per second."""
    out, rows = {}, {}
    gen = np.random.default_rng(seed + 500)
    n = ALS_FOLD_EVENTS
    for k in ALS_FOLD_RANKS:
        y = factors(gen, 20_000, k).astype(np.float32)
        x = factors(gen, 20_000, k).astype(np.float32)
        yty, xtx = y.T.astype(np.float64) @ y, x.T.astype(np.float64) @ x
        xu, yi = x[gen.integers(0, 20_000, n)], y[gen.integers(0, 20_000, n)]
        xu_ok, yi_ok = gen.random(n) < 0.95, gen.random(n) < 0.95
        values = (1.0 + 4.0 * gen.random(n)).astype(np.float32)
        args = (xu, xu_ok, yi, yi_ok, values, True)
        t0 = time.perf_counter()
        host = als.fold_in_batch(yty, xtx, *args, backend="host")
        t_host = time.perf_counter() - t0
        als.fold_in_batch(yty, xtx, *args, backend="device")  # first call
        t0 = time.perf_counter()
        card = als.fold_in_batch(yty, xtx, *args, backend="device")
        t_card = time.perf_counter() - t0
        for j in (1, 3):
            if not np.array_equal(card[j], host[j]):
                raise AssertionError(f"fold-in k={k}: the updated flags differ")
        err = max(check_close(f"fold-in k={k} {side}", card[j], host[j], **FOLD_TOL)
                  for j, side in ((0, "users"), (2, "items")))
        # a singular Gramian: half the features never occur
        ys = y.copy()
        ys[:, k // 2:] = 0.0
        sing = als.fold_in_batch(ys.T.astype(np.float64) @ ys, xtx, *args, backend="device")
        if not (np.isfinite(sing[0]).all() and np.isfinite(sing[2]).all()):
            raise AssertionError(f"fold-in k={k}: a singular Gramian gave non-finite vectors")
        # _fold_half alone on the card, the inputs resident
        dev = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (xu, xu_ok, yi, yi_ok, values)]
        g = torch.from_numpy(yty.astype(np.float32)).to(device)
        half_ms = device_ms(torch, lambda: als._fold_half(g, dev[0], dev[1], dev[2], dev[3], dev[4], True), 5)
        out[f"k{k}"] = {"events": n, "host_events_per_s": n / t_host,
                        "device_events_per_s": n / t_card, "max_abs_err": err,
                        "fold_half_ms": half_ms}
        rows[f"fold_half_k{k}"] = {
            "what": f"_fold_half, {n} events, k = {k}", "ms": half_ms, "launches": 2,
            "bound": ops_bound(n * (3 * 4 * k + 8) + 4 * k * k, 2 * 2 * n * k * k + k ** 3 / 3),
        }
    out["baseline_events_per_s"] = 100_000  # BASELINE.json's speed-layer figure; nothing claimed
    return out, rows


def phase_als_train(torch, seed: int, iterations: int = ALS_SCALE_ITERATIONS,
                    device: str = "cuda", scale: float = 1.0) -> dict:
    """Phase 8 (als-train): (a) parity at the MovieLens-100K shape, (b)
    the MovieLens-25M shape at rank 200, (c) fold-in. Returns the ALS ops
    rows for the table of XLA-ported ops."""
    from oryx_tpu_torch.ops import als, packing

    torch.zeros(1, device=device)  # the packing workers fork after CUDA is up
    record = {"phase": "als-train", "parity": als_parity(als, device)}
    if iterations != ALS_SCALE_ITERATIONS:
        record["cut"] = f"scale run cut to {iterations} iterations (from {ALS_SCALE_ITERATIONS})"
    record["scale"], rows = als_scale(torch, als, packing, iterations, seed, device, scale)
    record["fold"], fold_rows = als_fold(torch, als, seed, device)
    rows.update(fold_rows)
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
    record["ops"] = rows
    emit(record)
    torch.cuda.empty_cache()
    return rows


# -- phase 9: the ALS lambda loop as three processes ------------------------------------

ALS_LAMBDA_FEATURES = 50  # the reference LoadBenchmark's narrower published width
ALS_WAVE_NEW_USERS = 200
ALS_WAVE_EVENTS_PER_NEW_USER = 10
ALS_WAVE_EXISTING_EVENTS = 2_000
ALS_INGEST_LINES = 50_000  # lines per POST /ingest
ALS_PROBE_USERS = 200  # users checked against the exact top-10 after the generation


def als_lambda_conf(root: str, ports: dict, batch_interval: int, score_dtype: str,
                    serving_port: int) -> str:
    """The ALS layers' config: one file: bus, oryx.id set, reference.conf
    defaults otherwise (10 iterations, implicit, lambda 0.001, alpha 1,
    test-fraction 0.1), 50 features, the device fold-in."""
    return f"""
    oryx {{
      id = "ChipSmokeALS"
      input-topic.broker = "file:{root}/bus"
      update-topic.broker = "file:{root}/bus"
      als {{
        hyperparams.features = {ALS_LAMBDA_FEATURES}
        serving.score-dtype = "{score_dtype}"
      }}
      batch {{
        streaming.generation-interval-sec = {batch_interval}
        update-class = "oryx_tpu_torch.app.als.update:ALSUpdate"
        storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
        ui.port = {ports["batch"]}
      }}
      speed {{
        streaming.generation-interval-sec = 1
        model-manager-class = "oryx_tpu_torch.app.als.speed:ALSSpeedModelManager"
        fold-in-backend = "device"
        ui.port = {ports["speed"]}
      }}
      serving {{
        api.port = {serving_port}
        model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
        application-resources = "oryx_tpu_torch.app.als.endpoints"
      }}
    }}
    """


def post_ingest(base: str, lines: list[str]) -> float:
    return post_bodies(base + "/ingest", lines, ALS_INGEST_LINES)


def als_topic_state(loc: str, start: int = 0):
    """The update topic read as serving replays it: (X {id: vector}, Y
    {id: vector}, the UP messages after record ``start`` in order as
    (X or Y, id, vector, known ids), records read)."""
    from oryx_tpu_torch import bus

    consumer = bus.get_broker(loc).consumer("OryxUpdate", from_beginning=True)
    state, after, seen = {"X": {}, "Y": {}}, [], 0
    try:
        while True:
            records = consumer.poll(100_000, 0.5)
            if not records:
                break
            for rec in records:
                seen += 1
                if rec.key != "UP" or (rec.key, rec.message) == BUS_POISON:
                    continue
                up = json.loads(rec.message)
                vec = np.asarray(up[2], np.float32)
                state[up[0]][up[1]] = vec
                if seen > start:
                    after.append((up[0], up[1], vec, up[3] if len(up) > 3 else []))
    finally:
        consumer.close()
    return state["X"], state["Y"], after, seen


def topic_models(loc: str) -> int:
    """The MODEL and MODEL-REF messages on the update topic."""
    from oryx_tpu_torch import bus

    consumer = bus.get_broker(loc).consumer("OryxUpdate", from_beginning=True)
    models = 0
    try:
        while records := consumer.poll(100_000, 0.5):
            models += sum(1 for rec in records if rec.key in ("MODEL", "MODEL-REF"))
    finally:
        consumer.close()
    return models


def exact_top10(y_ids: list[str], y_mat: np.ndarray, xu: np.ndarray):
    """float64 scores of every item, the top-10 (ties to the lowest id):
    (values [1, 10], item rows [1, 10])."""
    scores = y_mat @ xu.astype(np.float64)
    order = np.lexsort((np.arange(len(scores)), -scores))[:10]
    return scores[order][None, :], order[None, :]


def served_top10(base: str, user: str, index: dict):
    status, body, _ = http_get(f"{base}/recommend/{user}?howMany=10&considerKnownItems=true")
    if status != 200:
        return None
    recs = json.loads(body)
    return (np.array([[r["value"] for r in recs]]),
            np.array([[index.get(r["id"], -1) for r in recs]]))


def served_exactly(base: str, user: str, y_ids, y_mat, index, xu) -> bool:
    got = served_top10(base, user, index)
    if got is None or got[1].shape != (1, 10):
        return False
    want_v, want_i = exact_top10(y_ids, y_mat, xu)
    try:
        check_topk(f"/recommend/{user}", got[0], got[1], want_v, want_i)
    except AssertionError:
        return False
    return True


def phase_als_lambda(seed: int, scale: float = 1.0, device: str = "cuda",
                     batch_interval: int = LAMBDA_BATCH_INTERVAL_S) -> dict:
    """The ALS lambda loop as three OS processes on one file: bus
    (``python -m oryx_tpu_torch batch|speed|serving``), and a second
    serving process scoring int8: the MovieLens-1M-shaped set through
    /ingest, one batch generation served exactly (float32) and at recall
    0.99 (int8) through the scan kernels, the batch process stopped; two
    waves of new and existing users' interactions folded on the card by
    the speed process, restarted between them; each new user served the
    exact top-10 of the vector the speed layer published, which is the
    float64 fold-in of its events (``compute_updated_xu``, ALSUtils'
    one-event fold) within 1e-4."""
    import signal
    import tempfile

    num_users, num_items, nnz = ML1M
    nnz = max(20_000, int(nnz * scale))
    u, i, v = movielens_shape(num_users, num_items, nnz, seed + 600)
    lines = [f"u{a},i{b},{c:.0f},{t}" for t, (a, b, c) in
             enumerate(zip(u.tolist(), i.tolist(), v.tolist()), start=1)]
    gen = np.random.default_rng(seed + 601)
    split = int(round(nnz * 0.9))  # test-fraction 0.1: the newest lines are held out
    train_users, used_items = np.unique(u[:split]), np.unique(i[:split])
    new_users = max(20, int(ALS_WAVE_NEW_USERS * min(1.0, scale * 10)))
    existing = max(200, int(ALS_WAVE_EXISTING_EVENTS * min(1.0, scale * 10)))
    waves = []
    for w in range(2):
        events = []
        for j in range(new_users):
            for item in gen.choice(used_items, ALS_WAVE_EVENTS_PER_NEW_USER, replace=False):
                events.append((f"n{w}-{j}", f"i{item}", float(gen.integers(1, 6))))
        for a, b in zip(gen.choice(train_users, existing), gen.choice(used_items, existing)):
            events.append((f"u{a}", f"i{b}", float(gen.integers(1, 6))))
        waves.append(events)

    root = tempfile.mkdtemp(prefix="chip-smoke-als-")
    os.makedirs(os.path.join(root, "logs"))
    ports = {name: free_port() for name in ("batch", "speed", "serving", "serving8")}
    confs = {}
    for dtype, port in (("float32", ports["serving"]), ("int8", ports["serving8"])):
        confs[dtype] = os.path.join(root, f"oryx-{dtype}.conf")
        with open(confs[dtype], "w") as f:
            f.write(als_lambda_conf(root, ports, batch_interval, dtype, port))
    loc = f"file:{root}/bus"
    base = f"http://127.0.0.1:{ports['serving']}"
    base8 = f"http://127.0.0.1:{ports['serving8']}"
    procs: dict = {}
    logs: list[str] = []
    out = {"phase": "als-lambda", "users": num_users, "items": num_items, "ratings": nnz,
           "features": ALS_LAMBDA_FEATURES, "bus": "file:", "batch_interval_s": batch_interval,
           "wave_new_users": new_users, "wave_existing_events": existing}

    def start(layer: str, run: int = 1, dtype: str = "float32"):
        name = layer if dtype == "float32" else f"{layer}-{dtype}"
        procs[name], path = start_layer(layer, confs[dtype], root, device, run)
        logs.append(path)
        return path

    def stop(name: str) -> int:
        procs[name].send_signal(signal.SIGTERM)
        return procs.pop(name).wait(timeout=120)

    def live():
        return list(procs.items())

    try:
        from oryx_tpu_torch import bus

        serving_log = start("serving")
        batch_log = start("batch")
        speed_log = start("speed")
        wait_until("layers up", lambda: log_has(batch_log, "BatchLayer started")
                   and log_has(speed_log, "SpeedLayer started")
                   and status_of(base + "/ready") == 503, procs=live())
        # the speed and serving processes took the native store and parser
        # (each says so in its start-up line)
        from oryx_tpu_torch import native

        store_kind = "NativeFeatureVectors" if native.get_library() is not None else "FeatureVectors"
        if device == "cuda" and store_kind != "NativeFeatureVectors":
            raise AssertionError("als-lambda: the native library did not build")
        parser = "native (" if store_kind == "NativeFeatureVectors" else "Python parser"
        checks = ((serving_log, f"ALS serving: {store_kind} vector store"),
                  (speed_log, f"ALS speed layer: {store_kind} vector store, {parser}"))
        for path, line in checks:
            if not log_has(path, line):
                raise AssertionError(f"als-lambda: {os.path.basename(path)} has no line {line!r}")
        out["native_store_and_parser"] = store_kind == "NativeFeatureVectors"
        t_post = time.monotonic()
        t_last = post_ingest(base, lines)
        out["ingest_s"] = t_last - t_post

        ready_at, metrics_batch = first_generation("the generation", base, ports["batch"],
                                                   procs, stop)
        out["generation_staleness_s"] = ready_at - t_last
        input_broker = bus.get_broker(loc)
        latest = input_broker.latest_offsets("OryxInput")
        drained = input_broker.get_offsets("OryxGroup-batch-ChipSmokeALS", "OryxInput")
        if drained != latest or sum(latest.values()) != nnz:
            raise AssertionError(f"the generation drained {drained} of {latest} ({nnz} posted)")
        out["batch_generation_s"] = hist_summary(metrics_batch["batch.generation.seconds"])
        out["batch_phase_s"] = {
            name[len("batch.phase."):-len(".seconds")]: metrics_batch[name].get("sum")
            for name in metrics_batch if name.startswith("batch.phase.")
        }
        with open(batch_log, errors="replace") as f:
            found = re.findall(r"best candidate eval=([-0-9.e+naN]+)", f.read())
        out["held_out_auc"] = float(found[-1]) if found else None

        # the generation, served: float32 exactly, int8 at recall 0.99
        models = topic_models(loc)
        if models != 1:
            raise AssertionError(f"the update topic holds {models} MODELs, not the generation's one")
        x_state, y_state, _, _ = als_topic_state(loc)
        if (sorted(x_state) != sorted(f"u{a}" for a in train_users)
                or sorted(y_state) != sorted(f"i{b}" for b in used_items)):
            raise AssertionError(f"published {len(x_state)} users and {len(y_state)} items, not "
                                 f"{len(train_users)} and {len(used_items)}")
        y_ids = sorted(y_state)
        index = {iid: n for n, iid in enumerate(y_ids)}
        y_mat = np.stack([y_state[iid] for iid in y_ids]).astype(np.float64)
        probe = gen.choice(sorted(x_state), size=min(ALS_PROBE_USERS, len(x_state)), replace=False)
        time.sleep(1.0)  # past the serving model's device-cache refresh window
        launches0 = serving_launches(ports["serving"])
        for user in probe:
            if not served_exactly(base, user, y_ids, y_mat, index, x_state[user]):
                raise AssertionError(f"float32 /recommend/{user} is not the exact top-10")
        out["float32_launches"] = launches1 = serving_launches(ports["serving"])
        if device == "cuda" and launches1.get("topn_scan.tc_f32", 0) <= launches0.get("topn_scan.tc_f32", 0):
            raise AssertionError(f"float32 serving launched {launches0} -> {launches1}")
        # the int8 process's port, taken now: one chosen at the phase's
        # start can be taken meanwhile as a client connection's ephemeral
        # port (the phase polls over thousands of short connections)
        ports["serving8"] = free_port()
        base8 = f"http://127.0.0.1:{ports['serving8']}"
        with open(confs["int8"], "w") as f:
            f.write(als_lambda_conf(root, ports, batch_interval, "int8", ports["serving8"]))
        serving8_log = start("serving", run=8, dtype="int8")
        # ready at the load fraction, and then every UP of the generation
        # replayed, before the probes
        wait_until("int8 serving", lambda: status_of(base8 + "/ready") == 200
                   and scrape(ports["serving8"]).get("serving.model.fraction_loaded", {})
                   .get("value") == 1.0, procs=live())
        if not log_has(serving8_log, f"ALS serving: {store_kind} vector store"):
            raise AssertionError(f"als-lambda: the int8 serving process took no {store_kind}")
        time.sleep(1.0)
        hits = 0
        for user in probe:
            got = served_top10(base8, user, index)
            want = exact_top10(y_ids, y_mat, x_state[user])[1]
            hits += len(set(got[1][0].tolist()) & set(want[0].tolist()))
        out["int8_recall_at_10"] = recall = hits / (10.0 * len(probe))
        out["int8_launches"] = launches8 = serving_launches(ports["serving8"])
        if recall < 0.99:
            raise AssertionError(f"int8 /recommend recall@10 {recall} below 0.99")
        if device == "cuda" and launches8.get("topn_scan.tc", 0) <= 0:
            raise AssertionError(f"int8 serving launched {launches8}")
        if stop("serving-int8") != 0:
            raise AssertionError("the int8 serving process did not stop cleanly")

        # two waves folded by the speed process, restarted between them
        wait_until("the speed model", lambda: log_has(speed_log, "ALS speed model"), procs=live())
        speed_group = "OryxGroup-speed-ChipSmokeALS"
        out["speed_batch_s"] = []
        for w, events in enumerate(waves, start=1):
            if w == 2:
                out["speed_batch_s"].append(hist_summary(scrape(ports["speed"])["speed.batch.seconds"]))
                if stop("speed") != 0:
                    raise AssertionError("the speed process did not stop cleanly")
                speed_log = start("speed", run=2)
                wait_until("the restarted speed model",
                           lambda: log_has(speed_log, "ALS speed model"), procs=live())
                if not log_has(speed_log, checks[1][1]):
                    raise AssertionError("als-lambda: the restarted speed process's parser")
                time.sleep(2.0)  # the UPs behind the MODEL replay in the same pass
            x_pre, y_pre, _, seen = als_topic_state(loc)
            t_last = post_ingest(base, [f"{a},{b},{c:.0f},{t}" for t, (a, b, c) in
                                        enumerate(events, start=10_000_000 * w)])
            users = sorted({a for a, _, _ in events if a.startswith(f"n{w - 1}-")})
            probe_user = users[-1]

            def probe_right():
                x_now, y_now, _, _ = als_topic_state(loc)
                if probe_user not in x_now:
                    return False
                ids = sorted(y_now)
                mat = np.stack([y_now[iid] for iid in ids]).astype(np.float64)
                return served_exactly(base, probe_user, ids, mat,
                                      {iid: n for n, iid in enumerate(ids)}, x_now[probe_user])

            wait_until(f"wave {w}: {probe_user} served", probe_right, procs=live())
            out[f"wave{w}_staleness_s"] = time.monotonic() - t_last
            wait_until(f"wave {w} committed",
                       lambda: input_broker.get_offsets(speed_group, "OryxInput")
                       == input_broker.latest_offsets("OryxInput"), timeout=60, procs=live())
            time.sleep(2.0)  # past the last micro-batch's publish
            x_now, y_now, ups, _ = als_topic_state(loc, start=seen)
            ids = sorted(y_now)
            mat = np.stack([y_now[iid] for iid in ids]).astype(np.float64)
            idx = {iid: n for n, iid in enumerate(ids)}
            for user in users:
                wait_until(f"wave {w}: /recommend/{user} the exact top-10",
                           lambda: served_exactly(base, user, ids, mat, idx, x_now[user]),
                           timeout=30, procs=live())
            out[f"wave{w}_fold_max_rel_err"] = check_fold_ins(
                f"wave {w}", ups, {(a, b): c for a, b, c in events}, set(users), x_pre, y_pre)
        out["speed_batch_s"].append(hist_summary(scrape(ports["speed"])["speed.batch.seconds"]))
        out["serving_launches"] = serving_launches(ports["serving"])
        for name in list(procs):
            if stop(name) != 0:
                raise AssertionError(f"the {name} process did not stop cleanly")
    except BaseException:
        print_tails(logs)
        raise
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=60)
    emit(out)
    return out

# -- phase 9b: the fault, shm and TCP buses ------------------------------------

CHAOS_CONF = os.path.join("conf", "chaos-example.conf")
BUS_WAVE_NEW_USERS = 100  # new users of each part's speed wave
BUS_PROBE_USERS = 100  # users checked against the exact top-10 after the generation
BUS_SHM_EVENTS = 2_000_000  # typed implicit events through the shm ring: about 24 MB of frames
BUS_SHM_RING_MB = 8
BUS_SHM_CHUNK = 50_000  # events per send_interactions call
BUS_ESTIMATE_ITEMS = 400  # item ids per /estimate call of part (b)'s item check
BUS_ESTIMATE_RTOL = 1e-5  # of |x| |y|: /estimate's float32 dot against float64
# lines per POST /ingest of part (a): one produce, so one fault roll, in
# the serving process each; the seed's first dup is its 245th roll
CHAOS_INGEST_LINES = 4_000
CHAOS_CLIENTS = 4  # threads POSTing those bodies
# an update the ALS speed manager cannot read: its consume raises, so the
# block is dead-lettered after max-consume-failures
BUS_POISON = ("UP", "poison: not an update")
NET_RETRY = ("connect_timeout=5&retry_max_attempts=400&retry_initial_backoff_ms=20"
             "&retry_max_backoff_ms=200")


def chaos_conf(root: str, ports: dict, batch_interval: int) -> str:
    """conf/chaos-example.conf as packaged, but for its directories (under
    root), its ports (free ones, and the batch and speed metrics UIs on
    them), the generation interval and the class names (the port's)."""
    with open(os.path.join(HERE, CHAOS_CONF)) as f:
        text = f.read()
    swaps = (("/tmp/OryxTPU/chaos", root),
             ("generation-interval-sec = 300", f"generation-interval-sec = {batch_interval}"),
             ("port = 8080", f"port = {ports['serving']}"),
             ('"oryx_tpu.', '"oryx_tpu_torch.'))
    for old, new in swaps:
        if old not in text:
            raise AssertionError(f"buses: {CHAOS_CONF} holds no {old!r}")
        text = text.replace(old, new)
    return text + f"""
oryx.batch.ui.port = {ports["batch"]}
oryx.speed.ui.port = {ports["speed"]}
"""


def post_retrying(url: str, lines: list[str], max_lines: int,
                  clients: int = CHAOS_CLIENTS) -> tuple[float, int]:
    """POST ``lines`` in split_bodies' bodies from ``clients`` threads, a
    body answered with an error sent again, as a client would: (the
    monotonic time the last answer came, the bodies sent again)."""

    def post(body: list[str]) -> int:
        data = ("\n".join(body) + "\n").encode()
        for again in range(1000):
            req = urllib.request.Request(url, data=data, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    if resp.status == 204:
                        return again
            except urllib.error.HTTPError as e:
                if e.code < 500:
                    raise
            time.sleep(0.02)
        raise AssertionError(f"POST {url}: a body answered with errors 1,000 times")

    with ThreadPoolExecutor(clients) as pool:
        again = sum(pool.map(post, split_bodies(lines, max_lines)))
    return time.monotonic(), again


def fault_counts(port: int) -> dict:
    """The bus.fault.* counters of the process behind a metrics port."""
    snap = scrape(port)
    return {name: int(snap.get(f"bus.fault.{name}", {}).get("value", 0))
            for name in ("dropped", "duplicated", "injected-errors")}


def serving_launches(port: int) -> dict:
    """The scan kernels' launch counts of a serving process, off its metrics."""
    return {
        name.split(".", 1)[1].rsplit(".", 1)[0]: int(m["value"])
        for name, m in scrape(port).items()
        if name.startswith("kernels.topn_") and name.endswith(".launches")
    }


def wave_served(base: str, loc: str, users: list[str]) -> bool:
    """Every user in users published, and served the exact top-10 of its
    published vector against the published items."""
    x_now, y_now, _, _ = als_topic_state(loc)
    if any(user not in x_now for user in users):
        return False
    ids = sorted(y_now)
    mat = np.stack([y_now[iid] for iid in ids]).astype(np.float64)
    idx = {iid: n for n, iid in enumerate(ids)}
    return all(served_exactly(base, user, ids, mat, idx, x_now[user]) for user in users)


def check_fold_ins(what: str, ups: list, values: dict, users: set, x_pre: dict,
                   y_pre: dict) -> float:
    """Each published X of a user in users: the float64 fold-in of the
    event behind it (the last of its known list) against the state before
    its micro-batch, within 1e-4 relative. A micro-batch publishes all its
    X, then all its Y: an X after a Y opens the next one. Returns the
    largest relative difference."""
    from oryx_tpu_torch.app.als.common import compute_updated_xu
    from oryx_tpu_torch.common.vectormath import Solver

    state = {"X": dict(x_pre), "Y": dict(y_pre)}
    worst, checked, yty, last = 0.0, set(), None, "Y"
    for which, user, vec, known in ups:
        if which == "X" and last == "Y":
            mat_y = np.stack(list(state["Y"].values())).astype(np.float64)
            yty = Solver(mat_y.T @ mat_y)
        if which == "X" and user in users:
            item = known[-1]
            ref = compute_updated_xu(yty, values[(user, item)], state["X"].get(user),
                                     state["Y"][item], True).astype(np.float64)
            rel = float(np.linalg.norm(vec - ref) / np.linalg.norm(ref))
            worst = max(worst, rel)
            checked.add(user)
            if rel > 1e-4:
                raise AssertionError(
                    f"{what}: {user}'s published vector is {rel:.3g} from the float64 fold-in")
        state[which][user] = vec
        last = which
    if checked != users:
        raise AssertionError(f"{what}: {len(checked)} of {len(users)} new users published")
    return worst


def wave_events(gen, prefix: str, n_users: int, items: np.ndarray) -> list[tuple]:
    """ALS_WAVE_EVENTS_PER_NEW_USER events of distinct items for each of
    n_users new users: (user, item, value)."""
    return [(f"{prefix}{j}", f"i{item}", float(gen.integers(1, 6)))
            for j in range(n_users)
            for item in gen.choice(items, ALS_WAVE_EVENTS_PER_NEW_USER, replace=False)]


def chaos_part(seed: int, scale: float, device: str, batch_interval: int) -> dict:
    """Part (a): conf/chaos-example.conf's three layers as processes on its
    fault+file: bus. The MovieLens-1M-shaped set POSTed to /ingest (a body
    answered with an error sent again) as the batch process starts, its
    group committed at the topic's start; every posted line in the batch
    layer's data, the generation served exactly once the speed layer has
    folded its backlog; a poison block dead-lettered while the speed
    layer goes on folding a wave of new users, each served the exact
    top-10 of its published vector; every kind of fault injected, no
    layer thread dead."""
    import signal
    import tempfile

    from oryx_tpu_torch import bus
    from oryx_tpu_torch.lambda_ import data as data_store

    num_users, num_items, nnz = ML1M
    nnz = max(20_000, int(nnz * scale))
    u, i, v = movielens_shape(num_users, num_items, nnz, seed + 1200)
    lines = [f"u{a},i{b},{c:.0f},{t}" for t, (a, b, c) in
             enumerate(zip(u.tolist(), i.tolist(), v.tolist()), start=1)]
    items = np.unique(i)
    gen = np.random.default_rng(seed + 1201)
    root = tempfile.mkdtemp(prefix="chip-smoke-chaos-")
    os.makedirs(os.path.join(root, "logs"))
    ports = {name: free_port() for name in ("batch", "speed", "serving")}
    conf = os.path.join(root, "chaos.conf")
    with open(conf, "w") as f:
        f.write(chaos_conf(root, ports, batch_interval))
    base = f"http://127.0.0.1:{ports['serving']}"
    loc = f"file:{root}/bus"  # the fault+ bus's inner bus, read without faults
    procs: dict = {}
    logs: list[str] = []
    out = {"part": "chaos", "ratings": nnz, "users": num_users, "items": num_items,
           "batch_interval_s": batch_interval, "device": device}
    live = lambda: list(procs.items())  # noqa: E731

    def start(layer: str):
        procs[layer], path = start_layer(layer, conf, root, device, 1)
        logs.append(path)
        return path

    def stop(name: str) -> None:
        procs[name].send_signal(signal.SIGTERM)
        if procs.pop(name).wait(timeout=120) != 0:
            raise AssertionError(f"chaos: the {name} process did not stop cleanly")

    try:
        t0 = time.perf_counter()
        start("serving")
        speed_log = start("speed")
        wait_until("chaos: layers up", lambda: log_has(speed_log, "SpeedLayer started")
                   and status_of(base + "/ready") == 503, procs=live())
        inner = bus.get_broker(loc)
        attach = inner.consumer("OryxInput", group="OryxGroup-batch-ChaosExample")
        attach.commit()
        attach.close()
        # the batch process starts beside the POST: its interval timer
        # starts once it is up, seconds after the POST, which takes a few
        start("batch")
        t_post = time.monotonic()
        t_last, again = post_retrying(base + "/ingest", lines, CHAOS_INGEST_LINES)
        out["ingest_s"], out["ingest_bodies_sent_again"] = t_last - t_post, again

        wait_until("chaos: the generation", lambda: status_of(base + "/ready") == 200,
                   procs=live())
        out["generation_staleness_s"] = time.monotonic() - t_last
        metrics_batch = wait_until(
            "chaos: the batch generation's end",
            lambda: (m := scrape(ports["batch"])).get("batch.generations", {}).get("value", 0) >= 1
            and m,
            procs=live(),
        )
        out["batch_generation_s"] = hist_summary(metrics_batch["batch.generation.seconds"])
        out["batch_phase_s"] = {
            name[len("batch.phase."):-len(".seconds")]: metrics_batch[name].get("sum")
            for name in metrics_batch if name.startswith("batch.phase.")
        }
        # every posted line reached the batch layer's data at least once
        # (the next generation's data, were the POST to outlast the
        # first's interval)
        def data_missing():
            stored = {m if isinstance(m, bytes) else m.encode()
                      for block in data_store.FileRecords(os.path.join(root, "data")).blocks()
                      for m in block.messages}
            return sum(1 for line in lines if line.encode() not in stored)

        wait_until("chaos: every posted line in the batch data", lambda: data_missing() == 0,
                   timeout=120, procs=live())
        faults = {"batch": fault_counts(ports["batch"])}
        out["generations"] = int(scrape(ports["batch"])["batch.generations"]["value"])
        stop("batch")
        t_step = time.monotonic()

        # the generation served, once the speed layer has folded the
        # input it drained before the model came
        speed_group = "OryxGroup-speed-ChaosExample"
        wait_until("chaos: the speed layer's backlog",
                   lambda: inner.get_offsets(speed_group, "OryxInput")
                   == inner.latest_offsets("OryxInput"), procs=live())
        time.sleep(2.0)  # past the last micro-batch's publish
        out["backlog_s"] = time.monotonic() - t_step
        x_state, y_state, _, _ = als_topic_state(loc)
        y_ids = sorted(y_state)
        index = {iid: n for n, iid in enumerate(y_ids)}
        y_mat = np.stack([y_state[iid] for iid in y_ids]).astype(np.float64)
        probe = gen.choice(sorted(x_state), size=min(BUS_PROBE_USERS, len(x_state)),
                           replace=False)
        for user in probe:
            wait_until(f"chaos: /recommend/{user} the exact top-10",
                       lambda: served_exactly(base, user, y_ids, y_mat, index, x_state[user]),
                       timeout=30, procs=live())

        # a poison block on the update topic and a wave of new users
        with inner.producer("OryxUpdate") as producer:
            producer.send(*BUS_POISON)
        dead = "OryxUpdate.dead-letter"
        events = wave_events(gen, "c", BUS_WAVE_NEW_USERS, items)
        t_last, again = post_retrying(base + "/ingest",
                                      [f"{a},{b},{c:.0f},{t}" for t, (a, b, c) in
                                       enumerate(events, start=20_000_000)], CHAOS_INGEST_LINES)

        def dead_lettered():
            if not inner.topic_exists(dead):
                return False
            consumer = inner.consumer(dead, from_beginning=True)
            try:
                return [(r.key, r.message) for r in consumer.poll(100, 0.2)]
            finally:
                consumer.close()

        out["dead_letter"] = got = wait_until("chaos: the poison dead-lettered", dead_lettered,
                                              timeout=120, procs=live())
        if tuple(got[0]) != BUS_POISON:
            raise AssertionError(f"chaos: the dead-letter topic holds {got}")
        users = sorted({a for a, _, _ in events})
        wait_until("chaos: the wave served", lambda: wave_served(base, loc, users),
                   procs=live())
        out["wave_staleness_s"] = time.monotonic() - t_last
        out["wave_new_users"], out["wave_bodies_sent_again"] = len(users), again

        health = {"serving": json.loads(http_get(base + "/healthz")[1]),
                  "speed": json.loads(http_get(f"http://127.0.0.1:{ports['speed']}/healthz")[1])}
        out["healthz"] = health
        if not health["serving"]["alive"] or not health["speed"]["healthy"]:
            raise AssertionError(f"chaos: a layer thread died: {health}")
        faults["speed"] = fault_counts(ports["speed"])
        faults["serving"] = fault_counts(ports["serving"])
        out["faults"] = faults
        out["faults_total"] = total = {
            name: sum(f[name] for f in faults.values()) for name in faults["speed"]}
        if min(total.values()) <= 0:
            raise AssertionError(f"chaos: not every kind of fault was injected: {total}")
        out["serving_launches"] = serving_launches(ports["serving"])
        for name in list(procs):
            stop(name)
        out["part_s"] = time.perf_counter() - t0
    except BaseException:
        print_tails(logs)
        raise
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=60)
    emit(out)
    return out


def up_line(which: str, ident: str, vec: np.ndarray) -> str:
    return json.dumps([which, ident, vec.tolist()])


def shm_tcp_conf(shm_loc: str, tcp_loc: str, ports: dict) -> str:
    """The speed and serving layers of part (b): the input topic one shm
    ring, the update topic behind a bus server, the speed layer
    pipelined, folding on the card, 50 features."""
    return f"""
    oryx {{
      id = "ChipSmokeBuses"
      input-topic {{
        broker = "{shm_loc}"
        message.partitions = 1
      }}
      update-topic.broker = "{tcp_loc}"
      als.hyperparams.features = {ALS_LAMBDA_FEATURES}
      speed {{
        streaming.generation-interval-sec = 1
        model-manager-class = "oryx_tpu_torch.app.als.speed:ALSSpeedModelManager"
        fold-in-backend = "device"
        pipeline.enabled = true
        ui.port = {ports["speed"]}
      }}
      serving {{
        api.port = {ports["serving"]}
        model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
        application-resources = "oryx_tpu_torch.app.als.endpoints"
      }}
    }}
    """


def estimates_right(base: str, x: dict, y: dict, users: list[str], item_ids: list[str]) -> float:
    """/estimate of every user in users at one item each, and of one user
    at every item, against the float64 dot of the published vectors
    (each within BUS_ESTIMATE_RTOL of |x| |y|): every X and Y the serving
    layer holds is the last one published. Returns the largest
    difference, relative."""
    calls = [(user, [item_ids[n % len(item_ids)]]) for n, user in enumerate(users)]
    calls += [(users[0], item_ids[a:a + BUS_ESTIMATE_ITEMS])
              for a in range(0, len(item_ids), BUS_ESTIMATE_ITEMS)]

    def one(call):
        user, items = call
        status, body, _ = http_get(f"{base}/estimate/{user}/{'/'.join(items)}")
        if status != 200:
            raise AssertionError(f"buses: /estimate/{user} answered {status}")
        worst = 0.0
        for item, got in zip(items, json.loads(body)):
            xu, yi = x[user].astype(np.float64), y[item].astype(np.float64)
            scale = np.linalg.norm(xu) * np.linalg.norm(yi)
            worst = max(worst, abs(got - float(xu @ yi)) / scale)
        return worst

    with ThreadPoolExecutor(16) as pool:
        return max(pool.map(one, calls))


def shm_tcp_part(seed: int, device: str, events: int = BUS_SHM_EVENTS,
                 ring_mb: float = BUS_SHM_RING_MB) -> dict:
    """Part (b): the speed layer's high-rate transport with its updates
    over the network. A ``bus-serve`` process holds the update topic; the
    input topic is one shm ring (under /dev/shm where it exists); a MODEL
    at MovieLens-1M's shape, 50 features, with X and Y as UP lines from a
    seed; the speed (pipelined) and serving layers as processes; a wave of
    new users as typed events, each published as the float64 fold-in and
    served its exact top-10; then ``events`` implicit typed events through
    ``send_interactions``, the bus server killed (SIGKILL) and restarted
    on its port and directory halfway: the speed group commits every
    event, the ring wraps at least twice without a CRC resync, and every
    published X and Y is the one the serving layer holds."""
    import shutil
    import signal
    import tempfile

    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app.pmml import add_extension, add_extension_content
    from oryx_tpu_torch.bus import shmbus
    from oryx_tpu_torch.common import pmml as pmml_io

    num_users, num_items, _ = ML1M
    root = tempfile.mkdtemp(prefix="chip-smoke-buses-")
    os.makedirs(os.path.join(root, "logs"))
    shm_dir = tempfile.mkdtemp(prefix="chip-smoke-shm-",
                               dir="/dev/shm" if os.path.isdir("/dev/shm") else root)
    ports = {name: free_port() for name in ("bus", "speed", "serving")}
    shm_loc = f"shm:{shm_dir}?ring_mb={ring_mb}"
    tcp_loc = f"tcp://127.0.0.1:{ports['bus']}?{NET_RETRY}"
    conf = os.path.join(root, "buses.conf")
    with open(conf, "w") as f:
        f.write(shm_tcp_conf(shm_loc, tcp_loc, ports))
    net_dir = os.path.join(root, "netbus")
    base = f"http://127.0.0.1:{ports['serving']}"
    procs: dict = {}
    logs: list[str] = []
    out = {"part": "shm_tcp", "users": num_users, "items": num_items,
           "features": ALS_LAMBDA_FEATURES, "events": events, "ring_mb": ring_mb,
           "shm_dir": os.path.dirname(shm_dir), "device": device}
    t_part = time.perf_counter()
    live = lambda: list(procs.items())  # noqa: E731

    def start(layer: str, run: int = 1, extra=()):
        procs[layer], path = start_layer(layer, conf, root, device, run, extra)
        logs.append(path)
        return path

    def start_bus(run: int):
        path = start("bus-serve", run, ("--bind", f"127.0.0.1:{ports['bus']}",
                                        "--data-dir", net_dir))
        wait_until("buses: the bus server", lambda: log_has(path, "bus-serve: tcp://"),
                   timeout=60, procs=live())

    def update_state(start_at: int = 0):
        return als_topic_state(f"file:{net_dir}", start=start_at)

    try:
        start_bus(1)
        gen = np.random.default_rng(seed + 1300)
        x = factors(gen, num_users, ALS_LAMBDA_FEATURES)
        y = factors(gen, num_items, ALS_LAMBDA_FEATURES)
        pmml = pmml_io.build_skeleton_pmml()
        add_extension(pmml, "features", ALS_LAMBDA_FEATURES)
        add_extension(pmml, "implicit", "true")
        add_extension_content(pmml, "XIDs", [f"u{j}" for j in range(num_users)])
        add_extension_content(pmml, "YIDs", [f"i{j}" for j in range(num_items)])
        net = bus.get_broker(tcp_loc)
        net.create_topic("OryxUpdate", 1)
        with net.producer("OryxUpdate") as producer:
            producer.send("MODEL", pmml_io.to_string(pmml))
            producer.send_many(("UP", up_line("X", f"u{j}", x[j])) for j in range(num_users))
            producer.send_many(("UP", up_line("Y", f"i{j}", y[j])) for j in range(num_items))
        shm = bus.get_broker(shm_loc)
        shm.create_topic("OryxInput", 1)
        speed_log = start("speed")
        start("serving")
        wait_until("buses: layers up", lambda: log_has(speed_log, "ALS speed model")
                   and status_of(base + "/ready") == 200, procs=live())
        time.sleep(2.0)  # the UPs behind the MODEL replay in the same pass

        # a wave of new users, typed: each one's published vector the
        # float64 fold-in of its events, its /recommend the exact top-10
        x_pre, y_pre, _, seen = update_state()
        wave = wave_events(gen, "u", BUS_WAVE_NEW_USERS, np.arange(num_items))
        codes = {f"u{j}": num_users + j for j in range(BUS_WAVE_NEW_USERS)}
        wave = [(f"u{codes[a]}", b, c) for a, b, c in wave]
        users = sorted({a for a, _, _ in wave})
        t0 = time.monotonic()
        with shm.producer("OryxInput") as producer:
            producer.send_interactions(
                np.array([int(a[1:]) for a, _, _ in wave], np.int32),
                np.array([int(b[1:]) for _, b, _ in wave], np.int32),
                np.array([c for _, _, c in wave], np.float32))
        wait_until("buses: the wave served",
                   lambda: wave_served(base, f"file:{net_dir}", users), procs=live())
        out["wave_publish_to_served_s"] = time.monotonic() - t0
        _, _, ups, seen = update_state(seen)
        out["wave_fold_max_rel_err"] = check_fold_ins(
            "buses", ups, {(a, b): c for a, b, c in wave}, set(users), x_pre, y_pre)

        # the flood, the bus server killed and restarted halfway
        flood_users = gen.integers(0, num_users, events, dtype=np.int32)
        flood_items = gen.integers(0, num_items, events, dtype=np.int32)
        flood_values = np.ones(events, np.float32)
        sent, blocked, restart_s = 0, 0, None
        t0 = time.monotonic()
        with shm.producer("OryxInput") as producer:
            for a in range(0, events, BUS_SHM_CHUNK):
                b = min(events, a + BUS_SHM_CHUNK)
                while True:
                    try:
                        sent += producer.send_interactions(
                            flood_users[a:b], flood_items[a:b], flood_values[a:b])
                        break
                    except BlockingIOError:  # the ring is full: the speed layer lags
                        blocked += 1
                if restart_s is None and sent >= events // 2:
                    t_kill = time.monotonic()
                    procs["bus-serve"].kill()
                    procs.pop("bus-serve").wait(timeout=60)
                    start_bus(2)
                    restart_s = time.monotonic() - t_kill
        out["flood_send_s"] = time.monotonic() - t0
        out["producer_blocked"] = blocked
        out["bus_restart_s"] = restart_s
        total = len(wave) + events
        group = "OryxGroup-speed-ChipSmokeBuses"
        wait_until("buses: every event committed",
                   lambda: sum(shm.get_offsets(group, "OryxInput").values()) >= total,
                   procs=live())
        out["flood_events_per_s"] = events / (time.monotonic() - t0)
        committed = sum(shm.get_offsets(group, "OryxInput").values())
        out["committed"] = committed
        if committed != total:
            raise AssertionError(f"buses: the speed group committed {committed} of {total} events")
        ring = shm._ring("OryxInput", 0)
        out["ring_head_bytes"] = head = ring.u64(shmbus._OFF_HEAD)
        out["ring_bytes"] = ring.ring_bytes
        speed_metrics = scrape(ports["speed"])
        out["crc_resyncs"] = resyncs = int(
            speed_metrics.get("bus.shm.crc-resyncs", {}).get("value", 0))
        out["speed_batch_s"] = hist_summary(speed_metrics.get("speed.batch.seconds", {}))
        if head < 2 * ring.ring_bytes or resyncs:
            raise AssertionError(f"buses: ring head {head} of {ring.ring_bytes} bytes, "
                                 f"{resyncs} CRC resyncs")

        # every UP line reached the serving layer: the last X and Y it
        # holds for each id are the last published
        x_now, y_now, ups, _ = update_state()
        out["up_lines"] = len(ups)
        last_x = next(up for up in reversed(ups) if up[0] == "X")[1]
        last_y = next(up for up in reversed(ups) if up[0] == "Y")[1]
        item_ids = sorted(y_now)
        wait_until("buses: the last UP served",
                   lambda: estimates_right(base, x_now, y_now, [last_x], [last_y]) <= BUS_ESTIMATE_RTOL,
                   timeout=120, procs=live())
        out["served_after_s"] = time.monotonic() - t0
        out["estimate_max_rel_err"] = err = estimates_right(base, x_now, y_now, sorted(x_now), item_ids)
        if err > BUS_ESTIMATE_RTOL:
            raise AssertionError(f"buses: a served vector is not the last published ({err:.3g})")
        y_ids = sorted(y_now)
        mat = np.stack([y_now[iid] for iid in y_ids]).astype(np.float64)
        idx = {iid: n for n, iid in enumerate(y_ids)}
        for user in users:
            if not served_exactly(base, user, y_ids, mat, idx, x_now[user]):
                raise AssertionError(f"buses: /recommend/{user} is not the exact top-10")
        out["serving_launches"] = serving_launches(ports["serving"])
        for name in list(procs):
            # bus-serve stops at an interrupt, the layers at SIGTERM
            procs[name].send_signal(signal.SIGINT if name == "bus-serve" else signal.SIGTERM)
            if procs.pop(name).wait(timeout=120) != 0:
                raise AssertionError(f"buses: the {name} process did not stop cleanly")
        out["part_s"] = time.perf_counter() - t_part
    except BaseException:
        print_tails(logs)
        raise
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(shm_dir, ignore_errors=True)
    emit(out)
    return out


def phase_buses(seed: int, scale: float = 1.0, device: str = "cuda",
                batch_interval: int = CHAOS_BATCH_INTERVAL_S,
                events: int = BUS_SHM_EVENTS, ring_mb: float = BUS_SHM_RING_MB) -> dict:
    """The fault, shm and TCP buses under the ALS loop, as processes:
    (a) conf/chaos-example.conf's deployment and (b) the shm ring with a
    bus server, the two at once (part (a) waits most of its time on its
    generation interval)."""
    t0 = time.perf_counter()
    result: dict = {}

    def part_b():
        try:
            result["shm_tcp"] = shm_tcp_part(seed, device, events, ring_mb)
        except BaseException as e:  # noqa: BLE001 - raised below, after part (a)
            result["error"] = e

    thread = threading.Thread(target=part_b, name="buses-shm-tcp")
    thread.start()
    try:
        chaos = chaos_part(seed, scale, device, batch_interval)
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    shm_tcp = result["shm_tcp"]
    launches = {name: chaos["serving_launches"].get(name, 0)
                + shm_tcp["serving_launches"].get(name, 0)
                for name in set(chaos["serving_launches"]) | set(shm_tcp["serving_launches"])}
    out = {"phase": "buses", "launches": launches, "s": time.perf_counter() - t0}
    emit(out)
    if device == "cuda":
        for part in (chaos, shm_tcp):
            got = part["serving_launches"]
            if got.get("topn_scan.tc", 0) + got.get("topn_scan.tc_f32", 0) <= 0 or \
                    got.get("topn_merge", 0) <= 0:
                raise AssertionError(f"buses: the {part['part']} serving process launched {got}")
    return out


# -- phase 9c: tenants, an online experiment, lineage ---------------------------------

TENANT_ALS_CLIENTS = 32  # closed-loop clients on each ALS tenant at once
TENANT_SIDE_CLIENTS = 4  # on /t/sensors/assign and on /t/churn/predict each
TENANT_LOAD_S = 5.0  # 10 s before a cut (the cuts line)
TENANT_RDF_ROWS = 50_000  # covtype's 581,012 cut (the cuts line)
TENANT_SHOP_FEATURES = 10  # conf/als-example.conf's width
TENANT_SHOP_DROPPED = 40  # shop's draw leaves out movies' last 40 users: /t/shop/ 404s them
TENANT_PROBE_USERS = 4096  # users of each ALS tenant's load paths
TENANT_MIN_SHARE = 0.25  # of the ALS answers, for either ALS tenant
EXP_SHAPE = (3_000, 1_500, 150_000)  # (b)'s MovieLens-shaped set: users, items, ratings
EXP_FEATURES = 10
EXP_USERS = 1_000  # 2,000 before a cut (the cuts line)
EXP_MIN_SAMPLES = 50
EXP_PROMOTE_S = 30.0
EXP_PROBES = 64


def tenants_config(loc: str, root: str):
    """One base config on an inproc bus, four tenants (docs/multi-tenancy.md):
    two ALS apps (50 and 10 features), k-means at phase 6's shape and RDF
    with conf/rdf-example.conf's schema and model; every other setting is
    reference.conf's, the default request path included."""
    from oryx_tpu_torch.common import config as config_utils

    sensors = ", ".join(f'"{j}"' for j in range(20))
    numerics = ", ".join(f'"{j}"' for j in range(10))
    return config_utils.get_default().with_overlay(f"""
    oryx {{
      id = "ChipSmokeTenants"
      input-topic.broker = "{loc}"
      update-topic.broker = "{loc}"
      batch {{
        streaming.generation-interval-sec = 3600
        storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
      }}
      serving.api.port = 0
      tenancy {{
        enabled = true
        tenants {{
          movies = {{ app = als, weight = 2,
                      config {{ oryx.als.hyperparams.features = {ALS_LAMBDA_FEATURES} }} }}
          shop = {{ app = als, weight = 1,
                    config {{ oryx.als.hyperparams.features = {TENANT_SHOP_FEATURES} }} }}
          sensors = {{ app = kmeans, config {{ oryx {{
            input-schema {{ num-features = 20, numeric-features = [{sensors}] }}
            kmeans.hyperparams.k = 10 }} }} }}
          churn = {{ app = rdf, config {{ oryx {{
            input-schema {{ num-features = 55, numeric-features = [{numerics}],
                            target-feature = "54" }}
            rdf {{ num-trees = {RDF_LAMBDA_TREES},
                   hyperparams {{ max-depth = {RDF_LAMBDA_DEPTH}, impurity = "entropy" }} }}
            ml.eval.test-fraction = 0.1 }} }} }}
        }}
      }}
    }}
    """)


def recall_of_answers(model, answers: dict) -> float:
    """recall@10 of served (user -> ids) against the exact float32 scan of
    the model's own factors (all items: the answers consider known ones)."""
    y_ids = model.all_item_ids()
    y = np.stack([model.get_item_vector(i) for i in y_ids]).astype(np.float32)
    users = sorted(answers)
    xu = np.stack([model.get_user_vector(u) for u in users]).astype(np.float32)
    scores = xu @ y.T
    top = np.argpartition(-scores, 10, axis=1)[:, :10]
    hits = sum(len(set(answers[u]) & {y_ids[j] for j in top[r]}) for r, u in enumerate(users))
    return hits / (10.0 * len(users))


def tenants_part(torch, stn, pk, seed: int, scale: float, device: str,
                 rdf_rows: int, load_s: float) -> dict:
    """(a): four tenants trained in one TenantPipelines round and served by
    one ServingLayer (native front, admission ladder with a ladder per
    tenant), clients in another process on all four at once."""
    import io
    import tempfile

    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app.rdf.serving import RDFServingModel
    from oryx_tpu_torch.app.schema import InputSchema
    from oryx_tpu_torch.serving.layer import ServingLayer
    from oryx_tpu_torch.tenancy import TenantRegistry, tenant_config
    from oryx_tpu_torch.tenancy.pipelines import TenantPipelines

    num_users, num_items, nnz = ML1M
    nnz = max(20_000, int(nnz * scale))
    lines = {}
    for tid, s in (("movies", seed + 1300), ("shop", seed + 1301)):
        u, i, v = movielens_shape(num_users, num_items, nnz, s)
        if tid == "shop":
            keep = u < num_users - TENANT_SHOP_DROPPED
            u, i, v = u[keep], i[keep], v[keep]
        lines[tid] = [f"u{a},i{b},{c:.0f},{t}" for t, (a, b, c) in
                      enumerate(zip(u.tolist(), i.tolist(), v.tolist()), start=1)]
    n = max(1024, int(KMEANS_SHAPES[0][0] * scale))
    pts32, true_centers = gaussian_blobs(n, 20, 10, seed + 1302)
    buf = io.StringIO()
    np.savetxt(buf, pts32, fmt="%.6f", delimiter=",")
    lines["sensors"] = buf.getvalue().splitlines()
    pts = np.loadtxt(io.StringIO(buf.getvalue()), delimiter=",", dtype=np.float64)
    del buf
    x, y = covtype_shape(rdf_rows + RDF_PREDICT_LINES, seed=seed + 1303)
    lines["churn"] = covtype_lines(x[:rdf_rows], y[:rdf_rows])
    held_out = covtype_lines(x[rdf_rows:], None)
    gen = np.random.default_rng(seed + 1304)

    loc = "inproc://chip-smoke-tenants"
    root = tempfile.mkdtemp(prefix="chip-smoke-tenants-")
    cfg = tenants_config(loc, root)
    tenants = TenantRegistry.from_config(cfg)
    out = {"phase": "tenants", "part": "four tenants", "bus": "inproc",
           "tenants": {tid: {"app": s.app, "weight": s.weight, "lines": len(lines[tid])}
                       for tid, s in tenants.specs.items()}}
    serving = ServingLayer(cfg)
    serving.start()
    base = f"http://127.0.0.1:{serving.port}"
    batch = TenantPipelines(cfg, tenants, "batch")
    try:
        if serving.admission is None or (device == "cuda" and serving._native_front is None):
            raise AssertionError("tenants: the default request path is not up")
        batch.start()
        broker = bus.get_broker(loc)
        t0 = time.perf_counter()
        for tid, ls in lines.items():
            tcfg = tenant_config(cfg, tenants.require(tid))
            topic = tcfg.get_string("oryx.input-topic.message.topic")
            want = (f"OryxInput.{tid}", f"OryxUpdate.{tid}", f"{root}/model/{tid}")
            got = (topic, tcfg.get_string("oryx.update-topic.message.topic"),
                   tcfg.get_string("oryx.batch.storage.model-dir").rstrip("/"))
            if got != want:
                raise AssertionError(f"tenants: {tid} is namespaced as {got}, not {want}")
            with broker.producer(topic) as p:
                for s in range(0, len(ls), 100_000):
                    p.send_many([(None, line) for line in ls[s:s + 100_000]])
        out["ingest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        done = batch.run_round()
        out["round_s"] = time.perf_counter() - t0
        if done != {tid: 1 for tid in tenants.ids()}:
            raise AssertionError(f"tenants: one round trained {done}")
        out["mlupdate_phase_s"] = {
            tid: dict(getattr(layer._update, "last_phase_seconds", {}))
            for tid, layer in batch.layers.items()
        }
        generations = {}
        for tid in tenants.ids():
            d = os.path.join(root, "model", tid)
            gens = [g for g in os.listdir(d) if os.path.isfile(os.path.join(d, g, "model.pmml"))]
            if len(gens) != 1:
                raise AssertionError(f"tenants: {d} holds generations {gens}")
            generations[tid] = gens[0]
        runtimes = serving.tenant_mux.runtimes()

        def loaded():
            for rt in runtimes.values():
                model = rt.manager.get_model()
                if (model is None or rt.health.live_generation is None
                        or model.get_fraction_loaded() < 1.0):
                    return False
            return http_get(base + "/ready")[0] == 200

        t0 = time.perf_counter()
        wait_until("tenants: every tenant served", loaded, timeout=300)
        out["served_after_s"] = time.perf_counter() - t0
        health = json.loads(http_get(base + "/healthz")[1])
        if health.get("tenants") != generations:
            raise AssertionError(f"tenants: /healthz lists {health.get('tenants')}, "
                                 f"not {generations}")
        models = {tid: rt.manager.get_model() for tid, rt in runtimes.items()}

        # a tenant's answers are its own: a user of both ALS tenants gets
        # shop's answer under /t/shop/, a movies-only user 404s there
        both = [u for u in (f"u{j}" for j in range(num_users - TENANT_SHOP_DROPPED))
                if models["movies"].get_user_vector(u) is not None
                and models["shop"].get_user_vector(u) is not None][:20]
        movies_only = [f"u{num_users - 1 - j}" for j in range(5)]
        got: dict = {"movies": {}, "shop": {}}
        for user in both:
            for tid in ("movies", "shop"):
                status, body, _ = http_get(
                    f"{base}/t/{tid}/recommend/{user}?howMany=10&considerKnownItems=true")
                if status != 200:
                    raise AssertionError(f"tenants: /t/{tid}/recommend/{user} answered {status}")
                got[tid][user] = [r["id"] for r in json.loads(body)]
        own = recall_of_answers(models["shop"], got["shop"])
        other = recall_of_answers(models["movies"], got["shop"])
        out["shop_answers_recall"] = {"shop": own, "movies": other}
        if own < 0.99 or other > 0.5:
            raise AssertionError(f"tenants: /t/shop/ answers hold {own} of shop's top-10s "
                                 f"and {other} of movies'")
        for user in movies_only:
            if models["movies"].get_user_vector(user) is None:
                raise AssertionError(f"tenants: movies does not know {user}")
            status = http_get(f"{base}/t/shop/recommend/{user}")[0]
            if status != 404:
                raise AssertionError(f"tenants: /t/shop/recommend/{user} answered {status}")
        if http_get(f"{base}/t/nope/recommend/u0")[0] != 404:
            raise AssertionError("tenants: an undeclared tenant was served")

        # the load: 32 clients on each ALS tenant, 4 on /assign, 4 on /predict
        als_users = {}
        for tid in ("movies", "shop"):
            known = [u for u in (f"u{j}" for j in range(num_users))
                     if models[tid].get_user_vector(u) is not None]
            als_users[tid] = [known[j] for j in
                              gen.choice(len(known), min(TENANT_PROBE_USERS, len(known)),
                                         replace=False)]
        groups = [
            {"clients": TENANT_ALS_CLIENTS,
             "paths": [f"/t/{tid}/recommend/{u}?howMany=10&considerKnownItems=true"
                       for u in als_users[tid]]}
            for tid in ("movies", "shop")
        ] + [
            {"clients": TENANT_SIDE_CLIENTS,
             "paths": [f"/t/sensors/assign/{lines['sensors'][j]}"
                       for j in gen.choice(len(lines["sensors"]), 512, replace=False)]},
            {"clients": TENANT_SIDE_CLIENTS,
             "paths": [f"/t/churn/predict/{line}" for line in held_out[:512]]},
        ]
        res = run_clients({"base": base, "paths": [], "steps": [
            {"seconds": load_s, "groups": groups}]}, timeout=load_s + 300)
        seconds = res["end"] - res["step_starts"][0]
        by_tenant: dict = {tid: [] for tid in tenants.ids()}
        for r in res["records"]:
            by_tenant[r[6].split("/")[2]].append(r)
        load = {}
        for tid, recs in by_tenant.items():
            statuses: dict = {}
            for r in recs:
                statuses[str(r[3])] = statuses.get(str(r[3]), 0) + 1
            stages: dict = {}
            for r in recs:
                stages[r[4] or "full"] = stages.get(r[4] or "full", 0) + 1
            load[tid] = {**latency_summary(recs, seconds), "statuses": statuses,
                         "stages": stages}
            bad = [r for r in recs if r[3] != 200 and r[3] != 429]
            if not recs or bad:
                raise AssertionError(f"tenants: {tid} load: {len(recs)} requests, "
                                     f"{len(bad)} failed, e.g. {bad[:1]}")
        ok = {tid: [r for r in by_tenant[tid] if r[3] == 200] for tid in ("movies", "shop")}
        share = len(ok["movies"]) / max(1, len(ok["movies"]) + len(ok["shop"]))
        out["load"] = load
        out["load_s"] = seconds
        out["served_ratio_movies_to_shop"] = len(ok["movies"]) / max(1, len(ok["shop"]))
        if not TENANT_MIN_SHARE <= share <= 1.0 - TENANT_MIN_SHARE:
            raise AssertionError(f"tenants: movies took {share:.3f} of the ALS answers")
        out["recall_at_10"] = {}
        for tid in ("movies", "shop"):
            answers = {r[6].split("/")[4].split("?")[0]: [a["id"] for a in json.loads(r[7])]
                       for r in ok[tid]}
            out["recall_at_10"][tid] = recall_of_answers(models[tid], answers)
            if out["recall_at_10"][tid] < 0.99:
                raise AssertionError(f"tenants: {tid} recall@10 {out['recall_at_10'][tid]}")
        for r in by_tenant["sensors"] + by_tenant["churn"]:
            if r[3] == 200 and not json.loads(r[7]):
                raise AssertionError(f"tenants: an empty answer on {r[6]}")

        # the ladders walk back to full once the load stops
        adm = serving.admission
        wait_until("tenants: the ladders back at full",
                   lambda: adm.evaluate() == 0 and all(adm.tenant_stage(t) == 0
                                                       for t in tenants.ids()), timeout=120)
        # /assign against the float64 nearest center; /predict against the
        # trained forest's host prediction
        # the served centers are the published generation's, bit for bit
        # (no blob-recovery bar: k-means|| at reference.conf's 3 runs
        # misses a blob in a few percent of generations at this shape,
        # on the card and on the CPU alike; ROADMAP, Queue C)
        from oryx_tpu_torch.app.kmeans import common as km
        from oryx_tpu_torch.common import pmml as pmml_io

        published = km.pmml_to_clusters(pmml_io.read_pmml(
            os.path.join(root, "model", "sensors", generations["sensors"], "model.pmml")))
        served = models["sensors"].clusters()
        if not np.array_equal(np.stack([c.center for c in served]),
                              np.stack([c.center for c in published])):
            raise AssertionError("tenants: sensors serves other centers than it published")
        out["sensors_blob_gap"] = max(float(np.min(np.linalg.norm(
            np.stack([c.center for c in served]) - t, axis=1))) for t in true_centers)
        check_served_clusters("tenants: sensors", base + "/t/sensors", served,
                              lines["sensors"], pts, [], gen)
        schema = InputSchema(tenant_config(cfg, tenants.require("churn")))
        forest, encodings, kind = rdf_published(loc, schema, topic="OryxUpdate.churn")
        if kind != "MiningModel" or len(forest.trees) != RDF_LAMBDA_TREES:
            raise AssertionError(f"tenants: churn published a {kind} of {len(forest.trees)}")
        local = RDFServingModel(forest, encodings, schema)
        tfi = schema.target_feature_index
        req = urllib.request.Request(base + "/t/churn/predict", method="POST",
                                     data="\n".join(held_out).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            served = json.loads(resp.read())
        want = [encodings.value_for(tfi, local.predict(d).most_probable_index) for d in held_out]
        if served != want:
            bad = sum(a != b for a, b in zip(served, want))
            raise AssertionError(f"tenants: /t/churn/predict: {bad} of {len(want)} lines differ")
        out["predict_lines_checked"] = len(want)

        # every tenant counted through the front's dispatch core
        if serving._native_front is not None:
            serving._native_front.push_control()  # drains the native stats
        snap = serving.instance_metrics.snapshot()
        counted = {tid: snap.get(f"serving.requests.tenant.{tid}", {}).get("value", 0)
                   for tid in tenants.ids()}
        out["requests_by_tenant"] = counted
        out["native_front"] = serving._native_front is not None
        if not all(counted.values()):
            raise AssertionError(f"tenants: per-tenant request counters {counted}")
    finally:
        serving.close()
        batch.close()
    emit(out)
    return out


def experiment_config(loc: str, root: str):
    """One ALS layer on a file: bus: half the users in the challenger arm,
    the online gate on at 50 samples, MODEL-REF generations (the update
    topic's message bound below the PMML) restaged under root/stage."""
    from oryx_tpu_torch.common import config as config_utils

    return config_utils.get_default().with_overlay(f"""
    oryx {{
      id = "ChipSmokeExperiment"
      input-topic.broker = "{loc}"
      update-topic.broker = "{loc}"
      update-topic.message.max-size = 16384
      als.hyperparams.features = {EXP_FEATURES}
      batch.storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
      ml {{
        warm-start = false
        gate.online {{ enabled = true, min-samples = {EXP_MIN_SAMPLES},
                      check-interval-s = 0.5 }}
      }}
      serving {{
        api.port = 0
        model-manager-class = "oryx_tpu_torch.app.als.serving_model:ALSServingModelManager"
        application-resources = "oryx_tpu_torch.app.als.endpoints"
        ab.fraction = 0.5
        restage-dir = "{root}/stage"
      }}
    }}
    """)


def experiment_part(seed: int, device: str) -> dict:
    """(b): generation 1 the champion, generation 2 the online challenger
    (the same ratings and seed, warm start off: its factors equal
    generation 1's), 2,000 users split by arm and their interactions fed
    back until the gate promotes; then a rollback to generation 1 and
    the lineage endpoints."""
    import tempfile

    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app.als.update import ALSUpdate, _load_features
    from oryx_tpu_torch.bus.core import KeyMessage
    from oryx_tpu_torch.common import rng
    from oryx_tpu_torch.experiments.routing import ABConfig, bucket_of
    from oryx_tpu_torch.registry.store import RegistryStore
    from oryx_tpu_torch.serving.layer import ServingLayer

    users, items, nnz = EXP_SHAPE
    u, i, v = movielens_shape(users, items, nnz, seed + 1400)
    data = [KeyMessage(None, f"u{a},i{b},{c:.0f},{t}") for t, (a, b, c) in
            enumerate(zip(u.tolist(), i.tolist(), v.tolist()), start=1)]
    root = tempfile.mkdtemp(prefix="chip-smoke-experiment-")
    loc = f"file:{root}/bus"
    cfg = experiment_config(loc, root)
    salt = ABConfig.from_config(cfg).salt
    store = RegistryStore(f"{root}/model")
    out = {"phase": "tenants", "part": "experiment", "bus": "file:", "users": users,
           "items": items, "ratings": nnz, "features": EXP_FEATURES}
    layer = ServingLayer(cfg)
    layer.start()
    base = f"http://127.0.0.1:{layer.port}"
    broker = bus.get_broker(loc)

    def generation(ts: int) -> float:
        t0 = time.perf_counter()
        rng.use_test_seed()  # one seed for both generations
        try:
            with broker.producer("OryxUpdate") as p:
                ALSUpdate(cfg).run_update(ts, data, [], f"{root}/model", p)
        finally:
            rng.clear_test_seed()
        return time.perf_counter() - t0

    def fetch(user: str, header: bool = True):
        req = urllib.request.Request(f"{base}/recommend/{user}",
                                     headers={"X-Oryx-User": user} if header else {})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read(), resp.headers.get("X-Oryx-Experiment-Arm")

    try:
        if layer.experiments is None or layer.model_stager is None:
            raise AssertionError("experiment: no coordinator or no restage cache")
        g1, g2 = "1700000000000", "1700000100000"
        out["generation_s"] = [generation(int(g1))]
        if store.champion_id() != g1:
            raise AssertionError(f"experiment: CHAMPION is {store.champion_id()}, not {g1}")
        wait_until("experiment: generation 1 served", lambda: layer.health.live_generation == g1
                   and layer.model_manager.get_model() is not None
                   and layer.model_manager.get_model().get_fraction_loaded() >= 1.0, timeout=120)
        probes = [f"u{j}" for j in range(EXP_PROBES)]
        before = {p: fetch(p, header=False)[0] for p in probes}
        out["generation_s"].append(generation(int(g2)))
        manifest = store.read_manifest(g2)
        if store.champion_id() != g1 or manifest.online_status != "pending":
            raise AssertionError(f"experiment: generation 2 is {manifest.online_status}, "
                                 f"CHAMPION {store.champion_id()}")
        wait_until("experiment: the challenger tracked",
                   lambda: layer.health.challenger_generation == g2
                   and layer.experiments.active, timeout=120)
        out["factors_equal"] = all(
            np.array_equal(_load_features(f"{root}/model/{g1}/{m}")[1],
                           _load_features(f"{root}/model/{g2}/{m}")[1]) for m in ("X", "Y"))
        time.sleep(1.0)  # the serving model's refresh window after generation 2's rows

        # 2,000 users, twice each, from the client process: the arm is
        # bucket_of's and sticky
        exp_users = [f"u{j}" for j in range(EXP_USERS)]
        res = run_clients({
            "base": base, "paths": [f"/recommend/{u}" for u in exp_users],
            "user_header": "X-Oryx-User",
            # 8 clients: in flight stays far below the ladder's budget
            "steps": [{"clients": 8, "partition": True}, {"clients": 8, "partition": True}],
        }, timeout=300)
        out["arm_requests_s"] = res["end"]
        asked: dict = {}
        for r in res["records"]:
            if r[3] != 200:
                raise AssertionError(f"experiment: {r[6]} answered {r[3]}")
            asked.setdefault(r[6].rsplit("/", 1)[1], []).append((r[7], r[8]))
        events, arms = [], {"champion": 0, "challenger": 0}
        for user in exp_users:
            want = "challenger" if bucket_of(user, salt) < 0.5 else "champion"
            got = [arm for _, arm in asked.get(user, [])]
            if got != [want, want]:
                raise AssertionError(f"experiment: {user} got arms {got}, not twice {want}")
            arm, body = want, asked[user][0][0]
            arms[arm] += 1
            served = [r["id"] for r in json.loads(body)]
            # the challenger arm interacts with its first item, the
            # champion arm with an item outside its list
            item = served[0] if arm == "challenger" else next(
                f"i{j}" for j in range(items) if f"i{j}" not in served)
            events.append((None, f"{user},{item},1"))
        out["arms"] = arms
        t0 = time.perf_counter()
        with broker.producer("OryxInput") as p:
            p.send_many(events)

        def promoted():
            m = store.read_manifest(g2)
            return (m.online_status == "promoted" and store.champion_id() == g2
                    and json.loads(http_get(base + "/healthz")[1])["live_generation"] == g2)

        wait_until("experiment: the gate promoted generation 2", promoted, timeout=EXP_PROMOTE_S)
        out["promoted_after_s"] = time.perf_counter() - t0
        report = json.loads(http_get(base + "/experiments")[1])
        resolved = {arm: s["resolved"] for arm, s in report["report"]["arms"].items()}
        out["resolved"] = resolved
        out["decision"] = report["decision"]
        if min(resolved.values()) < EXP_MIN_SAMPLES:
            raise AssertionError(f"experiment: resolved {resolved}")

        # rollback: CHAMPION back, generation 1 republished and adopted
        req = urllib.request.Request(f"{base}/model/rollback/{g1}", method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out["rollback"] = json.loads(resp.read())
        if store.champion_id() != g1:
            raise AssertionError(f"experiment: CHAMPION is {store.champion_id()} after rollback")
        wait_until("experiment: generation 1 live again",
                   lambda: json.loads(http_get(base + "/healthz")[1])["live_generation"] == g1,
                   timeout=60)
        time.sleep(1.0)  # the refresh window
        after = {p: fetch(p, header=False)[0] for p in probes}
        if after != before:
            bad = sum(after[p] != before[p] for p in probes)
            raise AssertionError(f"experiment: {bad} of {len(probes)} probe answers changed")
        listing = json.loads(http_get(base + "/model/generations")[1])
        statuses = {g["generation_id"]: g["status"] for g in listing["generations"]}
        out["generations"] = statuses
        if statuses != {g1: "published", g2: "published"} or listing["champion"] != g1:
            raise AssertionError(f"experiment: /model/generations lists {listing}")
        staged = sorted(os.listdir(f"{root}/stage"))
        out["staged"] = staged
        if staged != [g1, g2] or not all(
                os.path.isfile(f"{root}/stage/{g}/model.pmml") for g in staged):
            raise AssertionError(f"experiment: the restage dir holds {staged}")
    finally:
        layer.close()
    emit(out)
    return out


def phase_tenants(torch, stn, pk, seed: int, scale: float = 1.0, device: str = "cuda",
                  rdf_rows: int = TENANT_RDF_ROWS, load_s: float = TENANT_LOAD_S) -> dict:
    """Tenancy, an online experiment and the lineage endpoints: (a) four
    tenants on one layer, (b) one experiment, then a rollback. Returns the
    kernels' launches of both, counted from zero here."""
    t0 = time.perf_counter()
    stn.reset_launch_counts()  # the tenants' main path starts here
    pk.reset_launch_counts()
    tenants_part(torch, stn, pk, seed, scale, device, rdf_rows, load_s)
    experiment_part(seed, device)
    launches = {**stn.launch_counts(), **pk.launch_counts()}  # and ends here
    torch.cuda.empty_cache()
    out = {"phase": "tenants", "launches": launches, "s": time.perf_counter() - t0}
    emit(out)
    if device == "cuda":
        scans = launches.get("topn_scan.tc", 0) + launches.get("topn_scan.tc_f32", 0)
        if scans <= 0 or launches.get("topn_merge", 0) <= 0 or \
                launches.get("kmeans_sweep.tc", 0) <= 0:
            raise AssertionError(f"tenants: launched {launches}")
    return out


# -- phase 9d: fleet, the operator surface -------------------------------------------

FLEET_REPLICAS = 3
FLEET_RATE = 150.0  # req/s: the fleet command's default scenario
FLEET_SECONDS = 10.0
AUTOSCALE_PERIOD_S = 14.0  # (b): the diurnal ramp of tests/serving/test_fleet.py:366-410
AUTOSCALE_RAMP = (15.0, 45.0)  # req/s at the trough and at the peak
AUTOSCALE_PER_REPLICA = 30.0  # req/s one replica is sized for
AUTOSCALE_SEED = 17  # that test's arrivals and users
CRASH_RATE = 60.0  # (c): tests/chaos/test_fleet_crash.py's offered rate
CRASH_SECONDS = 8.0
CRASH_RECOVERY_BUDGET_S = 45.0
FLEET_TENANTS = {"movies": {"weight": 2.0, "slo_p99_ms": 250.0},
                 "shop": {"weight": 1.0, "slo_p99_ms": 500.0}}


def cli_lines(argv: list[str]) -> tuple[int, list[str]]:
    """One command of the port's CLI through its ``main()``, in this
    process (the fleet's bus is an inproc one): (exit code, lines)."""
    import io

    from oryx_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def fleet_cli(fleet, tmp: str) -> dict:
    """(d): the CLI against replica 0 of ``fleet`` and its model dir, each
    command's exit code and lines held against the endpoints' JSON and
    the registry: health, models list / show / rollback / gc,
    experiments, tenants list / show, repair and config."""
    from oryx_tpu_torch.registry.store import RegistryStore

    base = fleet.targets[0].base_url
    conf = os.path.join(tmp, "fleet.conf")
    with open(conf, "w") as f:
        f.write(fleet._replica_config().serialize())
    common = ["--conf", conf, "--set", f"oryx.serving.api.port={base.rsplit(':', 1)[1]}"]
    store = RegistryStore(fleet.model_dir)
    out = {}

    def run(*argv, want: int = 0, extra=()):
        rc, lines = cli_lines([*argv, *common, *extra])
        out[" ".join(argv)] = {"rc": rc, "lines": len(lines)}
        if rc != want:
            raise AssertionError(f"fleet: cli {' '.join(argv)} exited {rc}, not {want}:\n"
                                 + "\n".join(lines[-20:]))
        return lines

    def endpoint(path: str):
        status, body, _ = http_get(base + path)
        if status != 200:
            raise AssertionError(f"fleet: {path} answered {status}")
        return json.loads(body)

    def in_sync(lines):
        live = endpoint("/healthz")["live_generation"]
        want = f"generations: live={live} champion={store.champion_id()} (in sync)"
        if want not in lines or not any(l.startswith("/readyz: 200") for l in lines):
            raise AssertionError(f"fleet: cli health said {lines}, want {want!r}")
        return live

    saved = os.environ.get("ORYX_CONF")  # main() points ORYX_CONF at --conf
    try:
        in_sync(run("health"))
        listing = endpoint("/model/generations")
        lines = run("models", "list")
        listed = [line.split("\t")[0] for line in lines]
        champion = [line.split("\t")[0] for line in lines if line.endswith("*champion*")]
        if listed != [g["generation_id"] for g in listing["generations"]] or \
                champion != [listing["champion"]]:
            raise AssertionError(f"fleet: cli models list {lines} against {listing}")
        first, second = fleet.generations[0], fleet.generations[1]
        shown = json.loads("\n".join(run("models", "show", second)))
        entry = next(g for g in listing["generations"] if g["generation_id"] == second)
        if any(shown[k] != entry[k] for k in ("status", "parent_id", "eval_metric",
                                               "created_at_ms")):
            raise AssertionError(f"fleet: cli models show {second}: {shown} against {entry}")
        report = json.loads("\n".join(run("experiments")))
        if report != endpoint("/experiments"):
            raise AssertionError(f"fleet: cli experiments {report}")
        lines = run("tenants", "list", want=1)
        if lines != ["tenancy disabled (oryx.tenancy.enabled = false or no tenants declared)"]:
            raise AssertionError(f"fleet: cli tenants list on an untenanted fleet: {lines}")
        tenancy = []
        for tid, spec in FLEET_TENANTS.items():
            tenancy += [f"oryx.tenancy.tenants.{tid}.app=\"probe\"",
                        f"oryx.tenancy.tenants.{tid}.weight={spec['weight']}",
                        f"oryx.tenancy.tenants.{tid}.slo.p99-ms={spec['slo_p99_ms']}"]
        tenancy = [a for kv in ["oryx.tenancy.enabled=true", *tenancy] for a in ("--set", kv)]
        lines = run("tenants", "list", extra=tenancy)
        if sorted(line.split("\t")[0] for line in lines) != sorted(FLEET_TENANTS):
            raise AssertionError(f"fleet: cli tenants list {lines}")
        shop = json.loads("\n".join(run("tenants", "show", "shop", extra=tenancy)))
        if (shop["app"], shop["weight"], shop["slo"]["p99_ms"]) != ("probe", 1.0, 500.0) or \
                shop["update_topic"] != "OryxUpdate.shop":
            raise AssertionError(f"fleet: cli tenants show shop {shop}")
        lines = run("repair")
        if lines[-1] != "repair: all stores clean":
            raise AssertionError(f"fleet: cli repair {lines}")
        # rollback to the second generation: republished on the update topic
        # through the chaos bus (levers closed), CHAMPION moved, every
        # replica live on it
        lines = run("models", "rollback", second)
        if lines != [f"republished generation {second} as MODEL; champion moved"] or \
                store.champion_id() != second or not fleet.wait_converged(second, timeout=15.0):
            raise AssertionError(f"fleet: cli models rollback {second}: {lines}, champion "
                                 f"{store.champion_id()}, replicas {fleet.replica_generations()}")
        if in_sync(run("health")) != second:
            raise AssertionError("fleet: replica 0 is not live on the rolled-back generation")
        lines = run("models", "gc", extra=["--set", "oryx.ml.retention.max-generations=1"])
        if lines != [f"deleted 1 generation(s): {[first]}"] or \
                store.list_generations() != [second]:
            raise AssertionError(f"fleet: cli models gc {lines}, left {store.list_generations()}")
        lines = run("config")
        for want in (f"oryx.batch.storage.model-dir={fleet.model_dir}/",
                     f"oryx.serving.api.port={common[-1].rsplit('=', 1)[1]}"):
            if want not in lines:
                raise AssertionError(f"fleet: cli config has no {want!r}")
    finally:
        if saved is None:
            os.environ.pop("ORYX_CONF", None)
        else:
            os.environ["ORYX_CONF"] = saved
    return out


def phase_fleet(seed: int, device: str = "cuda") -> dict:
    """Phase 9d: the fleet harness, the autoscaler and the CLI's operator
    commands (``oryx_tpu_torch.tools.fleet``), each replica a port
    ServingLayer with the probe app (which launches no kernel). (a) the
    fleet command's default scenario over FLEET_REPLICAS in-process
    replicas on a ``fault+inproc:`` bus at FLEET_RATE for FLEET_SECONDS:
    a chaos window, a publish, the window closed, a rollback; zero failed
    requests and skew 0 at the end; (b) the autoscaler over a diurnal
    ramp against one replica: out before the peak, in (a drain) after
    the out, no failed request; (c) the crash campaign: FLEET_REPLICAS
    subprocess replicas, one SIGKILLed mid-run, no failed request, its
    recovery seconds within CRASH_RECOVERY_BUDGET_S; (d) the CLI against
    (a)'s replica 0 (``fleet_cli``). The SLO verdicts (p99 within 1 s) are
    printed, not held: the phase runs in the window. Returns the phase's
    numbers."""
    from oryx_tpu_torch.loadgen import DiurnalRampProcess, OpenLoopEngine, PowerLawUsers
    from oryx_tpu_torch.registry.tracking import record_fleet_skew
    from oryx_tpu_torch.serving.autoscale import AutoscaleConfig
    from oryx_tpu_torch.tools import fleet as fleet_tool

    def summary(result) -> dict:
        s = result.summary()
        return {k: s[k] for k in ("offered", "offered_rate", "achieved_rate", "ok", "failed",
                                  "shed", "error_kinds", "p50_ms", "p99_ms", "service_p99_ms",
                                  "queued_arrivals", "retried")}

    out = {"phase": "fleet", "replicas": FLEET_REPLICAS}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as tmp:
        # (a) rotation under chaos, then (d) the CLI against its replica 0
        with fleet_tool.FleetHarness(FLEET_REPLICAS, os.path.join(tmp, "a"),
                                     bus_name="chip-smoke-fleet", chaos_seed=seed) as fleet:
            first = fleet.publish(metric=0.90)
            if not fleet.wait_converged(first, timeout=15.0):
                raise AssertionError("fleet (a): replicas never converged on the first generation")
            scenario = fleet_tool.default_scenario(FLEET_RATE, FLEET_SECONDS, seed)
            result, verdict, runner = fleet_tool.run_scenario(fleet, scenario)
            settled = fleet.wait_converged(fleet.generations[-1], timeout=10.0)
            skew = record_fleet_skew(fleet.replica_generations())
            out["a"] = {**summary(result), "actions": [a.do for a in runner.executed],
                        "generations": list(fleet.generations), "final_skew": skew,
                        "max_skew_observed": max((k for _, _, k in fleet.skew_samples),
                                                 default=0),
                        "slo_passed": verdict.passed, "violations": verdict.violations}
            out["a_s"] = time.perf_counter() - t0
            if runner.errors or out["a"]["actions"] != ["chaos", "publish", "chaos", "rollback"]:
                raise AssertionError(f"fleet (a): actions {out['a']['actions']}, "
                                     f"errors {runner.errors}")
            # the scenario's p99 SLO is printed, not held: in the window this
            # process shares the host's cores with every lambda phase, and
            # its load generator's own lag lands in the latencies
            if result.failed or not settled or skew != 0:
                emit(out)
                raise AssertionError(f"fleet (a): {result.failed} failed, settled {settled}, "
                                     f"skew {skew}, {verdict.violations}")
            t = time.perf_counter()
            out["d"] = fleet_cli(fleet, tmp)
            out["d_s"] = time.perf_counter() - t
        # (b) the autoscaler over a diurnal ramp
        t = time.perf_counter()
        with fleet_tool.FleetHarness(1, os.path.join(tmp, "b"),
                                     bus_name="chip-smoke-autoscale") as fleet:
            gen = fleet.publish(metric=0.90)
            if not fleet.wait_converged(gen, timeout=15.0):
                raise AssertionError("fleet (b): the replica never took the generation")
            fleet.rate_window_s = 1.5
            policy = fleet.start_autoscaler(AutoscaleConfig(
                enabled=True, min_replicas=1, max_replicas=3, interval_s=0.25, lead_s=3.0,
                period_s=AUTOSCALE_PERIOD_S, per_replica_rate=AUTOSCALE_PER_REPLICA,
                cooldown_s=1.5, burn_hi=1e9, queue_wait_hi_ms=1e9, scale_in_quiet_evals=3,
                min_fit_samples=6))
            engine = OpenLoopEngine(fleet.targets, template="/probe/recommend/u%d",
                                    readiness_poll_s=0.1)
            t_run = time.monotonic()
            result = engine.run(
                DiurnalRampProcess(*AUTOSCALE_RAMP, AUTOSCALE_PERIOD_S, seed=AUTOSCALE_SEED),
                PowerLawUsers(100_000, seed=AUTOSCALE_SEED), AUTOSCALE_PERIOD_S)
            fleet.stop_autoscaler()
            events = [{"t": e.t - t_run, "direction": e.direction, "reason": e.reason,
                       "replicas": e.replicas} for e in policy.events]
            out["b"] = {**summary(result), "events": events,
                        "replicas_at_end": fleet.replica_count()}
            peak = AUTOSCALE_PERIOD_S / 2
            outs = [e for e in events if e["direction"] == "out"]
            ins = [e for e in events if e["direction"] == "in"]
            if result.failed or not outs or outs[0]["t"] >= peak or not ins or \
                    ins[0]["t"] <= outs[0]["t"] or fleet.replica_count() != 1:
                emit(out)
                raise AssertionError(f"fleet (b): {result.failed} failed, events {events}")
        out["b_s"] = time.perf_counter() - t
        # (c) one SIGKILL in a fleet of subprocess replicas
        t = time.perf_counter()
        report = fleet_tool.run_crash_campaign(
            FLEET_REPLICAS, CRASH_RATE, CRASH_SECONDS, os.path.join(tmp, "c"), seed=seed,
            recovery_budget_s=CRASH_RECOVERY_BUDGET_S)
        out["c"] = {k: report[k] for k in ("crashes", "recovery_seconds",
                                           "recovery_within_budget", "scenario_actions",
                                           "offered", "ok", "failed", "retried", "p99_ms")}
        out["c"]["slo_passed"] = report["slo"]["passed"]
        out["c_s"] = time.perf_counter() - t
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    c = out["c"]
    if c["crashes"] != 1 or c["failed"] or not c["recovery_within_budget"]:
        raise AssertionError(f"fleet (c): {c}")
    return out


# -- phases 10-11: random decision forests -------------------------------------------

RDF_ROWS = 100_000  # bench_rdf's training rows (tools/train_benchmark.py:215-248)
RDF_HELD_OUT = 20_000
RDF_BINS = 32  # bench_rdf's quantile bins for the numerics
COVTYPE_ROWS = 581_012  # UCI covtype's published size
COVTYPE_CLASSES = 7
RDF_NEAR_TIE_RTOL = 1e-6
RDF_ACCURACY_TOL = 0.005
RDF_RMSE_RTOL = 0.01
RDF_LAMBDA_TREES = 20  # conf/rdf-example.conf
RDF_LAMBDA_DEPTH = 8
RDF_TRAIN_LINES = 10_000  # lines per POST /train
RDF_PREDICT_LINES = 1_000
RDF_PROBES = 10
RDF_WAVE = 2_000


def covtype_shape(n: int, seed: int = 23):
    """tools/train_benchmark.py:196-212's covtype-shaped synthetic: 54
    features (10 numeric + 44 binary, like covtype's one-hots), 7 classes
    from axis-aligned rules, 10% label noise."""
    gen = np.random.default_rng(seed)
    num = gen.standard_normal((n, 10)).astype(np.float32)
    binary = (gen.random((n, 44)) < 0.15).astype(np.float32)
    x = np.concatenate([num, binary], axis=1)
    yc = (
        (num[:, 0] > 0).astype(int)
        + 2 * (num[:, 1] > 0.5).astype(int)
        + (binary[:, 3] > 0).astype(int)
        + 2 * ((num[:, 2] + num[:, 3]) > 0).astype(int)
    ) % 7
    flip = gen.random(n) < 0.1
    yc[flip] = gen.integers(0, 7, flip.sum())
    return x, yc.astype(np.int32)


def quantile_binner(xtr: np.ndarray, num_bins: int):
    """bench_rdf's binning: the 10 numerics quantile-cut on the training
    rows to num_bins bins, the binaries as they are."""
    cuts = [np.quantile(xtr[:, j], np.linspace(0, 1, num_bins)[1:-1]) for j in range(10)]

    def binize(m):
        out = np.zeros(m.shape, np.int32)
        for j in range(10):
            out[:, j] = np.searchsorted(cuts[j], m[:, j], side="left")
        out[:, 10:] = m[:, 10:].astype(np.int32)
        return out

    return binize


class LevelTimer:
    """``train_forest``'s stage hook: CUDA events (host clock on the CPU)
    around every tree-level's "histograms", "splits" and "routing" work,
    grouped by level (the chunk's trees run each level in turn)."""

    def __init__(self, torch, trees: int, device: str):
        self.torch, self.trees, self.cuda = torch, trees, device != "cpu"
        self.events: list = []  # (stage, level, start, end)
        self.calls: dict[str, int] = {}

    def __call__(self, name: str):
        import contextlib

        level = self.calls.get(name, 0) // self.trees
        self.calls[name] = self.calls.get(name, 0) + 1
        torch, events, cuda = self.torch, self.events, self.cuda

        @contextlib.contextmanager
        def span():
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
            else:
                start = time.perf_counter()
                yield
                end = time.perf_counter()
            events.append((name, level, start, end))

        return span()

    def ms(self) -> dict:
        """{level: {stage: ms summed over the level's trees}}."""
        if self.cuda:
            self.torch.cuda.synchronize()
        out: dict = {}
        for name, level, start, end in self.events:
            ms = start.elapsed_time(end) if self.cuda else (end - start) * 1e3
            out.setdefault(level, {}).setdefault(name, 0.0)
            out[level][name] += ms
        return out


def forest_parity(tf, card, cpu, binned, targets, kw: dict, num_bins: int, device: str) -> dict:
    """Tree for tree: identical splits and node counts, or a first
    differing node that is a near tie of the last bit of log: on each
    side the two best candidates' gains within RDF_NEAR_TIE_RTOL, and the
    other side's choice within RDF_NEAR_TIE_RTOL of the best. Below that
    node nothing is compared."""
    identical, ties = 0, []
    for t in range(card.num_trees):
        diff = np.nonzero((card.split_feature[t] != cpu.split_feature[t])
                          | (card.split_bin[t] != cpu.split_bin[t]))[0]
        if not len(diff):
            if not np.array_equal(card.node_counts[t], cpu.node_counts[t]):
                raise AssertionError(f"tree {t}: the same splits with other node counts")
            identical += 1
            continue
        node = int(diff[0])
        chosen = {side: int(f.split_feature[t, node]) * num_bins + int(f.split_bin[t, node])
                  for side, f in (("card", card), ("cpu", cpu))}
        seen, near = {}, True
        for side, forest, dev, other in (("card", card, device, "cpu"),
                                         ("cpu", cpu, "cpu", "card")):
            gains, flats = tf.node_top_gains(binned, targets, forest, t, node, num_bins,
                                             device=dev, **kw)
            at = np.nonzero(flats == chosen[other])[0]
            other_gain = float(gains[at[0]]) if len(at) else float("-inf")
            seen[side] = {"top_gains": gains[:2].tolist(), "top_flats": flats[:2].tolist(),
                          "chosen": chosen[side], "gain_of_other_choice": other_gain}
            tol = RDF_NEAR_TIE_RTOL * abs(float(gains[0]))
            near &= (len(gains) >= 2 and flats[0] == chosen[side]
                     and float(gains[0] - gains[1]) <= tol and float(gains[0]) - other_gain <= tol)
        tie = {"tree": t, "node": node, **seen}
        ties.append(tie)
        say(f"rdf: tree {t} differs first at node {node}: {json.dumps(tie)}")
        if not near:
            raise AssertionError(f"tree {t} node {node}: not a near tie: {json.dumps(tie)}")
    return {"trees": card.num_trees, "identical_trees": identical, "near_ties": ties}


def split_agreement(a, b) -> float:
    """Share of the nodes split on either side whose (feature, bin) agree."""
    either = (a.split_feature >= 0) | (b.split_feature >= 0)
    same = (a.split_feature == b.split_feature) & (a.split_bin == b.split_bin)
    return float((same & either).sum() / max(1, either.sum()))


def timed_train(torch, tf, binned, targets, device: str, host: bool = False, **kw):
    """train_forest on ``device``: its device path, or with ``host`` the
    CPU's host path (np.bincount histograms)."""
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest = tf.train_forest(binned, targets, device=device, host_hist=host, **kw)
    return forest, {"wall_s": time.perf_counter() - t0, **tf.last_phase_seconds}


def rdf_ops_rows(n, p, bins, s, timer_ms: dict, formulations: list, trees: int) -> dict:
    """Rows of the table of XLA-ported ops for one run: device ms summed
    over the run's tree-levels, launches (tree-levels), and the bound as
    ops_bound() counts it. A level histogram reads the binned rows, the
    weights and the node ids and writes its [p, L, B, S] float32 tensor."""
    rows = {}
    for how in ("scalar", "matmul", "vector"):
        levels = [d for d, f in enumerate(formulations) if f == how]
        if not levels:
            continue
        moved = sum(n * p * 4 + n * 8 + p * (2 ** d) * bins * s * 4 for d in levels)
        ops = sum((2.0 * n * (2 ** d) * s * p * bins) if how == "matmul" else n * p * s
                  for d in levels)
        rows[f"rdf_hist_{how}"] = {
            "what": f"level histogram ({how}), {n} rows x {p} features x {bins} bins, "
                    f"levels {levels}",
            "ms": sum(timer_ms[d]["histograms"] for d in levels),
            "launches": trees * len(levels),
            "bound": ops_bound(trees * moved, trees * ops),
        }
    levels = list(range(len(formulations)))
    cand = sum(p * (2 ** d) * bins for d in levels)
    rows["rdf_split_selection"] = {
        "what": f"split selection (cumsum, {s}-class entropy gains, argmax), levels 0-{levels[-1]}",
        "ms": sum(timer_ms[d]["splits"] for d in levels),
        "launches": trees * len(levels),
        "bound": ops_bound(trees * (cand * s * 4 + sum((2 ** d) * p * 4 for d in levels)),
                           trees * cand * (8 * s + 10)),
    }
    rows["rdf_routing"] = {
        "what": f"routing (gather, compare, children), {n} rows, levels 0-{levels[-1]}",
        "ms": sum(timer_ms[d]["routing"] for d in levels),
        "launches": trees * len(levels),
        "bound": ops_bound(trees * len(levels) * n * 12, trees * len(levels) * n * 4),
    }
    return rows


def rdf_parity(torch, tf, seed: int, rows: int, device: str) -> tuple[dict, dict]:
    """(a) bench_rdf's configuration on the card and on the CPU through
    the same port code: splits tree for tree under the near-tie rule,
    held-out accuracy, the card's vote sums on the CPU's forest bit for
    bit; the three histogram formulations on one tree; a regression forest
    at the same size. Returns (record, the matmul histogram's ops row)."""
    x, y = covtype_shape(rows + RDF_HELD_OUT)
    xtr, ytr, xte, yte = x[:rows], y[:rows], x[rows:], y[rows:]
    binize = quantile_binner(xtr, RDF_BINS)
    btr, bte = binize(xtr), binize(xte)
    kw = dict(num_trees=20, max_depth=10, impurity="entropy", seed=77)
    timer = LevelTimer(torch, kw["num_trees"], device)
    card, secs_card = timed_train(torch, tf, btr, ytr, device, num_bins=RDF_BINS,
                                  num_classes=COVTYPE_CLASSES, hist_mode="auto", stage=timer, **kw)
    cpu, secs_cpu = timed_train(torch, tf, btr, ytr, "cpu", True, num_bins=RDF_BINS,
                                num_classes=COVTYPE_CLASSES, **kw)
    out = {"rows": rows, "held_out": RDF_HELD_OUT, "bins": RDF_BINS, **kw,
           "seconds_card": secs_card, "seconds_cpu": secs_cpu}
    out["parity"] = forest_parity(tf, card, cpu, btr, ytr, kw, RDF_BINS, device)
    votes_card = tf.predict_forest_binned(card, bte, device=device)
    votes_cpu = tf.predict_forest_binned(cpu, bte, device="cpu")
    out["accuracy_card"] = acc_card = float((votes_card.argmax(axis=1) == yte).mean())
    out["accuracy_cpu"] = acc_cpu = float((votes_cpu.argmax(axis=1) == yte).mean())
    if abs(acc_card - acc_cpu) > RDF_ACCURACY_TOL:
        raise AssertionError(f"held-out accuracy {acc_card} on the card, {acc_cpu} on the CPU")
    if not np.array_equal(tf.predict_forest_binned(cpu, bte, device=device), votes_cpu):
        raise AssertionError("the card's vote sums on the CPU's forest differ from the CPU's")
    levels = 1 + int(np.log2(np.nonzero((card.split_feature >= 0).any(axis=0))[0].max() + 1)) + 1
    forms = [tf.formulation(rows, btr.shape[1], COVTYPE_CLASSES, 2 ** d, RDF_BINS, "entropy",
                            "auto") for d in range(min(levels, kw["max_depth"] + 1))]
    out["formulations"] = forms
    ops = rdf_ops_rows(rows, btr.shape[1], RDF_BINS, COVTYPE_CLASSES, timer.ms(), forms,
                       kw["num_trees"])
    matmul_row = {"rdf_hist_matmul": ops["rdf_hist_matmul"]} if "rdf_hist_matmul" in ops else {}

    # the three formulations on one tree, depth 6
    one = {}
    for mode in ("matmul", "scalar", "reference"):
        f, secs = timed_train(torch, tf, btr, ytr, device, num_bins=RDF_BINS,
                              num_classes=COVTYPE_CLASSES, num_trees=1, max_depth=6,
                              impurity="entropy", seed=77, hist_mode=mode)
        one[mode] = (f, secs["iterate"])
    ref = one["reference"][0]
    for mode in ("matmul", "scalar"):
        f = one[mode][0]
        if not (np.array_equal(f.split_feature, ref.split_feature)
                and np.array_equal(f.split_bin, ref.split_bin)
                and np.array_equal(f.node_counts, ref.node_counts)):
            raise AssertionError(f"hist_mode {mode} grew another tree than reference")
    out["one_tree_depth6_iterate_s"] = {mode: secs for mode, (_, secs) in one.items()}

    # regression: a numeric function of features 0-3 plus noise
    noise = np.random.default_rng(seed + 700).standard_normal(len(x)).astype(np.float32)
    yr = (2.0 * x[:, 0] + x[:, 1] * x[:, 2] - np.abs(x[:, 3]) + 0.3 * noise).astype(np.float32)
    kwr = dict(num_trees=20, max_depth=10, impurity="variance", seed=77)
    reg = []
    for dev, host in ((device, False), ("cpu", True)):
        f, secs = timed_train(torch, tf, btr, yr[:rows], dev, host, num_bins=RDF_BINS,
                              num_classes=None, **kwr)
        pooled = tf.predict_forest_binned(f, bte, device=dev)
        rmse = float(np.sqrt(np.mean((pooled[:, 1] / pooled[:, 0] - yr[rows:]) ** 2)))
        reg.append((f, rmse, secs))
    (f_d, rmse_d, secs_d), (f_c, rmse_c, secs_c) = reg
    out["regression"] = {"rmse_card": rmse_d, "rmse_cpu": rmse_c, "seconds_card": secs_d,
                         "seconds_cpu": secs_c, "split_agreement": split_agreement(f_d, f_c)}
    if not (np.isfinite(rmse_d) and abs(rmse_d - rmse_c) <= RDF_RMSE_RTOL * rmse_c):
        raise AssertionError(f"regression RMSE {rmse_d} on the card, {rmse_c} on the CPU")
    return out, matmul_row


def covtype_binned(encode, schema, rows: int, seed: int):
    """covtype's shape at ``rows`` (plus RDF_HELD_OUT) binned through the
    port's encode.build_binning as RDFUpdate bins it: the 10 numerics
    quantile-cut to max-split-candidates = 100, the 44 binaries
    categorical, the target in its predictor slot. (binned train, targets,
    binned held-out, held-out targets, num_bins)."""
    x, y = covtype_shape(rows + RDF_HELD_OUT, seed=seed)
    feats = np.concatenate([x.astype(np.float64), y[:, None].astype(np.float64)], axis=1)
    binning = encode.build_binning(feats[:rows], y[:rows].astype(np.float64), schema, 100, True)
    binned = encode.bin_features(feats, binning)
    return binned[:rows], y[:rows], binned[rows:], y[rows:], binning.num_bins


def rdf_schema_config(extra: str = "") -> str:
    """conf/rdf-example.conf's schema: 55 columns, numerics 0-9, target 54."""
    numerics = ", ".join(f'"{j}"' for j in range(10))
    return f"""
    oryx {{
      input-schema {{
        num-features = 55
        numeric-features = [{numerics}]
        target-feature = "54"
      }}
      {extra}
    }}
    """


def rdf_scale(torch, tf, encode, seed: int, rows: int, device: str) -> tuple[dict, dict]:
    """(b) covtype's published size with conf/rdf-example.conf's model and
    the app defaults it inherits: 20 trees, depth 8, entropy, 100 split
    candidates, min-node-size 16, min-info-gain 0.001; by-level times,
    children summing to their parents, a 2-tree run against the CPU."""
    from oryx_tpu_torch.app.schema import InputSchema
    from oryx_tpu_torch.common import config

    schema = InputSchema(config.get_default().with_overlay(rdf_schema_config()))
    t0 = time.perf_counter()
    btr, ytr, bte, yte, num_bins = covtype_binned(encode, schema, rows, seed + 800)
    n, p = btr.shape
    kw = dict(num_trees=20, max_depth=8, impurity="entropy", min_node_size=16.0,
              min_info_gain=0.001, seed=seed, exclude_features={54})
    out = {"rows": n, "predictors": p, "bins": num_bins, "data_s": time.perf_counter() - t0,
           **{k: v for k, v in kw.items() if k != "exclude_features"}}
    held = 0.0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
    timer = LevelTimer(torch, kw["num_trees"], device)
    forest, secs = timed_train(torch, tf, btr, ytr, device, num_bins=num_bins,
                               num_classes=COVTYPE_CLASSES, stage=timer, **kw)
    by_level = timer.ms()
    forms = [tf.formulation(n, p, COVTYPE_CLASSES, 2 ** d, num_bins, "entropy", "auto")
             for d in sorted(by_level)]
    out.update(seconds=secs, rows_x_trees_per_s=n * kw["num_trees"] / secs["iterate"],
               ms_by_level={d: {"formulation": forms[d], **v} for d, v in by_level.items()},
               peak_memory_gb=((torch.cuda.max_memory_allocated() - held) / 1e9
                               if device != "cpu" else None))
    # every split node's children partition its stats exactly
    for t in range(forest.num_trees):
        for node in np.nonzero(forest.split_feature[t] >= 0)[0]:
            kids = forest.node_stats[t, 2 * node + 1] + forest.node_stats[t, 2 * node + 2]
            if not np.array_equal(kids, forest.node_stats[t, node]):
                raise AssertionError(f"tree {t} node {node}: children do not sum to the parent")
    out["split_nodes"] = int((forest.split_feature >= 0).sum())
    if device != "cpu":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    votes = tf.predict_forest_binned(forest, bte, device=device)
    predict_ms = (time.perf_counter() - t1) * 1e3
    out["accuracy"] = float((votes.argmax(axis=1) == yte).mean())
    out["predict_ms"] = predict_ms
    # two trees, the same seed, against the host path at full size
    kw2 = dict(kw, num_trees=2)
    card2, secs2 = timed_train(torch, tf, btr, ytr, device, num_bins=num_bins,
                               num_classes=COVTYPE_CLASSES, **kw2)
    cpu2, secs2c = timed_train(torch, tf, btr, ytr, "cpu", True, num_bins=num_bins,
                               num_classes=COVTYPE_CLASSES, **kw2)
    out["two_trees"] = {"seconds_card": secs2, "seconds_cpu": secs2c,
                        **forest_parity(tf, card2, cpu2, btr, ytr, kw2, num_bins, device)}

    rows_ = rdf_ops_rows(n, p, num_bins, COVTYPE_CLASSES, by_level, forms, kw["num_trees"])
    depth = kw["max_depth"]
    nodes = forest.split_feature.shape[1]
    rows_["predict_forest_binned"] = {
        "what": f"predict_forest_binned, {len(bte)} rows x {kw['num_trees']} trees, depth "
                f"{depth} (wall: upload, descent, read-back)",
        "ms": predict_ms, "launches": 1,
        "bound": ops_bound(len(bte) * p * 4 + kw["num_trees"] * nodes * (8 + COVTYPE_CLASSES * 4)
                           + len(bte) * COVTYPE_CLASSES * 4,
                           len(bte) * kw["num_trees"] * ((depth + 1) * 4 + COVTYPE_CLASSES)),
    }
    return out, rows_


def phase_rdf_train(torch, seed: int, rows: int = RDF_ROWS, device: str = "cuda") -> dict:
    """Phase 10 (rdf-train): random-forest training through
    ``ops/forest.py`` on the card (PyTorch ops: the JAX package runs them
    through XLA, no Pallas kernel): (a) bench_rdf's configuration against
    the CPU, (b) covtype's published size (both scaled by rows / 100,000).
    Returns the RDF ops rows for the table of XLA-ported ops."""
    from oryx_tpu_torch.app.rdf import encode
    from oryx_tpu_torch.ops import forest as tf

    scale_rows = max(2_000, int(COVTYPE_ROWS * rows / RDF_ROWS))
    record = {"phase": "rdf-train"}
    record["parity"], matmul_row = rdf_parity(torch, tf, seed, rows, device)
    record["scale"], rows_ = rdf_scale(torch, tf, encode, seed, scale_rows, device)
    rows_.update(matmul_row)  # (b) takes no matmul level at covtype's size
    for row in rows_.values():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
    record["ops"] = rows_
    emit(record)
    if device != "cpu":
        torch.cuda.empty_cache()
    return rows_


def rdf_lambda_conf(root: str, ports: dict, batch_interval: int) -> str:
    """conf/rdf-example.conf with the port's class names, one file: bus
    under root, 20 trees, depth 8, test-fraction 0.1, the metrics UIs."""
    return rdf_schema_config(f"""
      id = "ChipSmokeRDF"
      input-topic.broker = "file:{root}/bus"
      update-topic.broker = "file:{root}/bus"
      rdf {{
        num-trees = {RDF_LAMBDA_TREES}
        hyperparams {{ max-depth = {RDF_LAMBDA_DEPTH}, impurity = "entropy" }}
      }}
      ml.eval.test-fraction = 0.1
      batch {{
        streaming.generation-interval-sec = {batch_interval}
        update-class = "oryx_tpu_torch.app.rdf.update:RDFUpdate"
        storage {{ data-dir = "{root}/data/", model-dir = "{root}/model/" }}
        ui.port = {ports["batch"]}
      }}
      speed {{
        streaming.generation-interval-sec = 1
        model-manager-class = "oryx_tpu_torch.app.rdf.speed:RDFSpeedModelManager"
        ui.port = {ports["speed"]}
      }}
      serving {{
        api.port = {ports["serving"]}
        model-manager-class = "oryx_tpu_torch.app.rdf.serving:RDFServingModelManager"
        application-resources = "oryx_tpu_torch.app.rdf.serving"
      }}
    """)


def covtype_lines(x: np.ndarray, y) -> list[str]:
    """CSV lines of conf/rdf-example.conf's schema: 10 numerics (4
    decimals), 44 binaries, then the class (or an empty target)."""
    cols = [np.char.mod("%.4f", x[:, :10])] + [x[:, 10:].astype(np.int32).astype(str)]
    target = np.asarray([""] * len(x)) if y is None else np.asarray(y).astype(str)
    table = np.concatenate(cols + [target[:, None]], axis=1)
    return [",".join(r) for r in table.tolist()]


def post_train(base: str, lines: list[str]) -> float:
    return post_bodies(base + "/train", lines, RDF_TRAIN_LINES)


def rdf_published(loc: str, schema, topic: str = "OryxUpdate"):
    """The last MODEL on the update topic as the port's forest: (forest,
    encodings, the PMML's model element name)."""
    from oryx_tpu_torch import bus
    from oryx_tpu_torch.app import pmml as app_pmml
    from oryx_tpu_torch.app.rdf import forest_pmml
    from oryx_tpu_torch.common import pmml as pmml_io

    consumer = bus.get_broker(loc).consumer(topic, from_beginning=True)
    last = None
    try:
        while True:
            records = consumer.poll(10_000, 0.5)
            if not records:
                break
            last = next((r for r in reversed(records) if r.key in ("MODEL", "MODEL-REF")), last)
    finally:
        consumer.close()
    if last is None:
        raise AssertionError("no MODEL on the update topic")
    root = app_pmml.read_pmml_from_update_message(last.key, last.message)
    kind = "MiningModel" if pmml_io.find(root, "MiningModel") is not None else "TreeModel"
    forest, encodings = forest_pmml.pmml_to_forest(root, schema)
    return forest, encodings, kind


def phase_rdf_lambda(seed: int, rows: int = RDF_ROWS, device: str = "cuda",
                     batch_interval: int = LAMBDA_BATCH_INTERVAL_S) -> dict:
    """Phase 11 (rdf-lambda): the RDF lambda loop as three OS processes on
    one file: bus (``python -m oryx_tpu_torch batch|speed|serving``):
    ``rows`` covtype-shaped lines POSTed to /train, one generation (20
    trees, depth 8, test-fraction 0.1), the batch process stopped; /predict
    on held-out lines equal to the published forest's own predictions,
    /feature/importance; two speed waves of labelled lines at fixed probe
    points, the speed process restarted between them, after each the
    served /classificationDistribution equal (1e-12) to the published
    forest with every wave's leaf counts added."""
    import signal
    import tempfile

    from oryx_tpu_torch.app.rdf.serving import RDFServingModel
    from oryx_tpu_torch.app.schema import InputSchema
    from oryx_tpu_torch.common import config

    x, y = covtype_shape(rows + RDF_PREDICT_LINES, seed=seed + 900)
    lines = covtype_lines(x[:rows], y[:rows])
    held_out = covtype_lines(x[rows:], None)
    gen = np.random.default_rng(seed + 901)
    px, _ = covtype_shape(RDF_PROBES, seed=seed + 902)
    probes = covtype_lines(px, None)
    waves = []
    for _ in range(2):
        at = gen.integers(0, RDF_PROBES, RDF_WAVE)
        labels = gen.integers(0, COVTYPE_CLASSES, RDF_WAVE)
        waves.append([probes[a] + str(c) for a, c in zip(at.tolist(), labels.tolist())])

    root = tempfile.mkdtemp(prefix="chip-smoke-rdf-")
    os.makedirs(os.path.join(root, "logs"))
    ports = {name: free_port() for name in ("batch", "speed", "serving")}
    conf = os.path.join(root, "oryx-rdf.conf")
    with open(conf, "w") as f:
        f.write(rdf_lambda_conf(root, ports, batch_interval))
    schema = InputSchema(config.get_default().with_overlay(rdf_lambda_conf(root, ports, 1)))
    loc = f"file:{root}/bus"
    base = f"http://127.0.0.1:{ports['serving']}"
    procs: dict = {}
    logs: list[str] = []
    out = {"phase": "rdf-lambda", "lines": rows, "trees": RDF_LAMBDA_TREES,
           "depth": RDF_LAMBDA_DEPTH, "bus": "file:", "batch_interval_s": batch_interval,
           "wave_lines": RDF_WAVE, "probes": RDF_PROBES}

    def start(layer: str, run: int = 1):
        procs[layer], path = start_layer(layer, conf, root, device, run)
        logs.append(path)
        return path

    def stop(name: str) -> int:
        procs[name].send_signal(signal.SIGTERM)
        return procs.pop(name).wait(timeout=120)

    def live():
        return list(procs.items())

    def post(path: str, body: str):
        req = urllib.request.Request(base + path, data=body.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())

    try:
        from oryx_tpu_torch import bus

        start("serving")
        batch_log = start("batch")
        speed_log = start("speed")
        wait_until("layers up", lambda: log_has(batch_log, "BatchLayer started")
                   and log_has(speed_log, "SpeedLayer started")
                   and status_of(base + "/ready") == 503, procs=live())
        t_post = time.monotonic()
        t_last = post_train(base, lines)
        out["train_post_s"] = t_last - t_post
        ready_at, metrics_batch = first_generation("the generation", base, ports["batch"],
                                                   procs, stop)
        out["generation_staleness_s"] = ready_at - t_last
        input_broker = bus.get_broker(loc)
        latest = input_broker.latest_offsets("OryxInput")
        drained = input_broker.get_offsets("OryxGroup-batch-ChipSmokeRDF", "OryxInput")
        if drained != latest or sum(latest.values()) != rows:
            raise AssertionError(f"the generation drained {drained} of {latest} ({rows} posted)")
        out["batch_generation_s"] = hist_summary(metrics_batch["batch.generation.seconds"])
        out["batch_phase_s"] = {
            name[len("batch.phase."):-len(".seconds")]: metrics_batch[name].get("sum")
            for name in metrics_batch if name.startswith("batch.phase.")
        }
        with open(batch_log, errors="replace") as f:
            text = f.read()
        found = re.findall(r"best candidate eval=([-0-9.e+naN]+)", text)
        out["held_out_accuracy"] = float(found[-1]) if found else None
        trained = re.findall(r"forest of \d+ trees on \d+ rows: init ([0-9.]+) s, "
                             r"iterate ([0-9.]+) s", text)
        out["train_forest_s"] = ({"init": float(trained[-1][0]), "iterate": float(trained[-1][1])}
                                 if trained else None)

        forest, encodings, kind = rdf_published(loc, schema)
        out["published"] = kind
        if kind != "MiningModel" or len(forest.trees) != RDF_LAMBDA_TREES:
            raise AssertionError(f"published a {kind} of {len(forest.trees)} trees")
        local = RDFServingModel(forest, encodings, schema)
        tfi = schema.target_feature_index

        # /predict on held-out lines: the published forest's own answers
        status, served = post("/predict", "\n".join(held_out))
        want = [encodings.value_for(tfi, local.predict(d).most_probable_index) for d in held_out]
        if status != 200 or served != want:
            bad = sum(a != b for a, b in zip(served, want))
            raise AssertionError(f"/predict: {bad} of {len(want)} lines differ from the forest")
        out["predict_lines_checked"] = len(want)
        status, body, _ = http_get(base + "/feature/importance")
        importances = json.loads(body)
        names = sorted(importances, key=lambda k: -importances[k])
        if status != 200 or sorted(importances) != sorted(str(j) for j in range(54)):
            raise AssertionError(f"/feature/importance named {sorted(importances)}")
        out["top_features"] = names[:5]
        if names[0] not in ("0", "1", "2", "3", "13"):
            raise AssertionError(f"the most important feature is {names[0]}, not a rule's")

        # two speed waves at the probe points, the speed process restarted
        wait_until("the speed model", lambda: log_has(speed_log, "RDF speed model"), procs=live())
        probe_rows = [local._features_from(d) for d in probes]
        expected = forest  # the published trees; each wave's leaf counts are added to it
        for w, wave in enumerate(waves, start=1):
            if w == 2:
                out["speed_batch_s"] = hist_summary(scrape(ports["speed"])["speed.batch.seconds"])
                if stop("speed") != 0:
                    raise AssertionError("the speed process did not stop cleanly")
                speed_log = start("speed", run=2)
                wait_until("the restarted speed model",
                           lambda: log_has(speed_log, "RDF speed model"), procs=live())
            for line in wave:
                row = local._features_from(line)
                cat = encodings.index_for(tfi, line.rsplit(",", 1)[1])
                for tree in expected.trees:
                    tree.find_terminal(row).update(cat, 1)
            want = [{encodings.value_for(tfi, i): float(q)
                     for i, q in enumerate(expected.predict(r).probabilities)}
                    for r in probe_rows]
            t_last = post_train(base, wave)

            def served_right():
                for datum, exp in zip(probes, want):
                    status, body, _ = http_get(
                        f"{base}/classificationDistribution/{urllib.request.quote(datum)}")
                    got = json.loads(body) if status == 200 else {}
                    if sorted(got) != sorted(exp) or any(
                            abs(got[k] - exp[k]) > 1e-12 for k in exp):
                        return False
                return True

            wait_until(f"wave {w} served", served_right, procs=live())
            out[f"wave{w}_staleness_s"] = time.monotonic() - t_last
        out.setdefault("speed_batch_s_run2", hist_summary(
            scrape(ports["speed"])["speed.batch.seconds"]))
        for name in list(procs):
            if stop(name) != 0:
                raise AssertionError(f"the {name} process did not stop cleanly")
    except BaseException:
        print_tails(logs)
        raise
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=60)
    emit(out)
    return out


# -- phases 12 and 13: the IVF tier ---------------------------------------------------


def clustered_catalog(torch, n: int, f: int, n_centers: int, seed: int, queries: int,
                      spread: float = 0.3, device: str = "cuda"):
    """tests/ops/test_ivf_scan.py:69-82's mixture at scale, made on the
    device from ``seed`` in blocks of 1M rows: (items [n, f] f32 on the
    host, queries [queries, f] f32 near the same centers, centers)."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((n_centers, f), generator=g, device=device)
    out = np.empty((n, f), np.float32)
    host = torch.from_numpy(out)
    for beg in range(0, n, 1 << 20):
        m = min(1 << 20, n - beg)
        lab = torch.randint(0, n_centers, (m,), generator=g, device=device)
        host[beg : beg + m].copy_(centers[lab] + spread * torch.randn((m, f), generator=g, device=device))
    lab = torch.randint(0, n_centers, (queries,), generator=g, device=device)
    q = centers[lab] + spread * torch.randn((queries, f), generator=g, device=device)
    return out, q.cpu().numpy(), centers.cpu().numpy()


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def tensor_bytes(torch, index) -> int:
    """Device bytes of every tensor an IVFIndex holds."""
    return sum(
        v.numel() * v.element_size() for v in vars(index).values() if isinstance(v, torch.Tensor)
    )


def exact_from_ivf(torch, stn, index):
    """The exact int8 scan's handle over the IVF index's items, its planes
    un-permuted on the card: per-row codes are the same function of each
    row in both layouts (checked against ``upload_streaming`` on a
    sample by the caller)."""
    n = index.n_items
    n_pad = max(stn.BLOCK_N, stn._ceil_to(n, stn.BLOCK_N))
    dev = index.device
    slots = torch.from_numpy(index.id_to_slot.astype(np.int64)).to(dev)
    kf = index.mat_t.shape[0]

    def plane(src):
        out = torch.zeros((kf, n_pad), dtype=torch.int8, device=dev)
        out[:, :n] = src[:, slots]
        return out

    def row(src, fill):
        out = torch.full((1, n_pad), fill, dtype=torch.float32, device=dev)
        out[0, :n] = src[0, slots]
        return out

    return stn.StreamingItemMatrix(
        mat_t=plane(index.mat_t), norms=row(index.norms, 0.0), n_items=n,
        scales=row(index.scales, 1.0),
        features=index.features if kf != index.features else None,
        resid=plane(index.resid), resid_scales=row(index.resid_scales, 1.0),
    )


def check_exact_codes(torch, stn, exact, mat: np.ndarray, rows: int = 65_536) -> None:
    """The un-permuted planes equal a fresh ``upload_streaming`` of the
    first ``rows`` items, bit for bit."""
    fresh = stn.upload_streaming(mat[:rows], dtype=torch.int8, device=exact.device)
    for name in ("mat_t", "resid", "scales", "resid_scales", "norms"):
        a = getattr(fresh, name)[:, :rows]
        b = getattr(exact, name)[:, :rows]
        if not torch.equal(a, b):
            raise AssertionError(f"ivf-ops: the exact handle's {name} differs from upload_streaming")


def recall_of(got: np.ndarray, want: np.ndarray) -> float:
    return sum(len(set(g) & set(w)) for g, w in zip(got.tolist(), want.tolist())) / want.size


def ivf_sweep_check(torch, pk, mat: np.ndarray, index) -> dict:
    """B3 at the build's shape: the sweep of a 200,000-row sample (the
    build's own draw) against the trained k = round(sqrt(n)) centers of
    250 features, against its plain version, with its times and bound."""
    n = min(200_000, len(mat))
    rows = np.random.default_rng(0).choice(len(mat), n, replace=False) if len(mat) > n else slice(None)
    dev = index.device
    pts = torch.from_numpy(pk.pad_to_block(np.ascontiguousarray(mat[rows]))).to(dev)
    k = index.n_cells
    kp = pk.padded_k(k)
    d = index.features
    ctr = torch.zeros((kp, d), dtype=torch.float32, device=dev)
    ctr[:k] = index.centroids_t[:d].T
    got = pk.sweep(pts, ctr, n, k)
    ref = pk.sweep_plain(pts, ctr, n, k)
    torch.cuda.synchronize()
    case = f"sweep n={n} d={d} k={k}"
    cmp = check_sweep(torch, case, pts, ctr, n, k, got, ref)
    del ref
    run = lambda: pk.sweep(pts, ctr, n, k)  # noqa: E731
    out = {
        "case": case, "kp": kp, **cmp,
        "plan": pk.sweep_plan(kp, d, n, dev)[1] if dev.type == "cuda" else None,
        "ms": device_ms(torch, run, 5), "call_ms": time_ms(torch, run, 5),
        "plain_ms": time_ms(torch, lambda: pk.sweep_plain(pts, ctr, n, k), 2),
        "library_ms": time_ms(torch, lambda: library_sweep(torch, pts, ctr, n, k), 3),
    }
    out["bound_ms"], out["bound_by"] = sweep_bound(n, d, kp, k)
    return out


def ivf_op_rows(torch, stn, ivf, index, queries: np.ndarray, k: int, nprobe: int,
                build_counts: dict, batch_counts: dict) -> dict:
    """CUDA-event times of the tier's PyTorch ops at this run's shapes,
    each beside its bound (ops_bound): one assignment block of the build,
    one stage-1 piece (gather, convert, product, chunk max) of the first
    query group, that group's two-plane rescore and its overlay scan at
    full capacity."""
    from oryx_tpu_torch.device import full_float32 as no_tf32

    kf = index.mat_t.shape[0]
    feat = index.features
    cells = index.n_cells
    dev = index.device
    cents = index.centroids_t[:feat].T.contiguous()
    blk = torch.randn((ivf._ASSIGN_BLOCK, feat), device=dev)
    half = 0.5 * torch.sum(cents * cents, 1)[None, :]
    cent_t = cents.T.contiguous()

    def assign():
        with no_tf32():
            return torch.argmin(-(blk @ cent_t - half), dim=1)

    q = ivf._padded_queries(index, queries[: ivf.QUERY_BLOCK])
    cells_np = ivf._route_cells(index, q, nprobe, False).cpu().numpy()
    tl = ivf._group_tile_lists(index, cells_np, len(q))[0]
    ts = index.tile_chunks * index.chunk
    per = max(1, ivf._PIECE_BYTES // (ts * kf * 4))
    tiles = torch.from_numpy(tl[:per]).to(dev)
    rows3 = index.mat_rows.view(-1, ts, kf)
    scales_t = index.scales.view(-1, ts)
    sids_t = index.slot_ids.view(-1, ts)

    def stage1():
        slab = rows3.index_select(0, tiles).reshape(-1, kf).float()
        with no_tf32():
            sc = slab @ q.T
        sc = sc * scales_t.index_select(0, tiles).reshape(-1, 1)
        sc = torch.where(sids_t.index_select(0, tiles).reshape(-1, 1) >= 0, sc, -math.inf)
        return sc.view(-1, index.chunk, q.shape[0]).amax(dim=1)

    kc = stn._chunk_k(k, ivf._pow2_ceil(len(tl)) * index.tile_chunks)
    m = kc * index.chunk
    iid = torch.randint(0, index.n_slots, (q.shape[0], m), device=dev)

    def rescore():
        return stn.gathered_pair_scores(
            index.mat_t, index.resid, index.scales, index.resid_scales, index.norms,
            q, None, iid, cosine=False,
        )

    ov = index.ov_rows

    def overlay():
        with no_tf32():
            return q @ ov.T

    g = q.shape[0]
    piece_slots = len(tiles) * ts
    return {
        "ivf_assign": {
            "what": f"assignment, one block of {ivf._ASSIGN_BLOCK} rows x {cells} cells x {feat}",
            "ms": device_ms(torch, assign, 10), "launches": build_counts["assign_blocks"],
            "bound": ops_bound(ivf._ASSIGN_BLOCK * feat * 4 + cells * feat * 4 + ivf._ASSIGN_BLOCK * 8,
                               2.0 * ivf._ASSIGN_BLOCK * cells * feat),
        },
        "ivf_stage1": {
            "what": f"stage-1 piece: {len(tiles)} tiles ({piece_slots} slots) x {g} queries, "
                    f"gather + float32 + product + chunk max",
            "ms": device_ms(torch, stage1, 10), "launches": batch_counts["pieces"],
            "bound": ops_bound(piece_slots * (kf + 8) + piece_slots // index.chunk * g * 4,
                               2.0 * piece_slots * kf * g),
        },
        "ivf_rescore": {
            "what": f"two-plane rescore of {g} queries x {m} candidates (gathered_pair_scores)",
            "ms": device_ms(torch, rescore, 10), "launches": batch_counts["groups"],
            "bound": ops_bound(g * m * (2 * kf + 12) + g * m * 4, 4.0 * g * m * kf),
        },
        "ivf_overlay": {
            "what": f"overlay scan, {g} queries x {ov.shape[0]} rows (full capacity)",
            "ms": device_ms(torch, overlay, 10), "launches": batch_counts["groups"],
            "bound": ops_bound(ov.numel() * 4 + g * ov.shape[0] * 4, 2.0 * g * ov.numel()),
        },
    }


def phase_ivf_ops(torch, stn, pk, seed: int, items: int = IVF_ITEMS, features: int = 250,
                  device: str = "cuda") -> dict:
    """The IVF tier's ops at the reference load benchmark's widest shape
    (BASELINE.md: 250 features x 20M items): build by stage, B3 at
    k = round(sqrt(n)) against its plain version, recall@10 and ms per
    batch against the exact int8 scan (B1 at b = 256, B2 at b = 512) at
    probe-fraction 0.01 and 0.3, and full probe at 1M items against the
    exact scan. Returns {"launches", "sweep", "ops"}."""
    from oryx_tpu_torch.ops import ivf

    need = items * features * 4 * 2.2  # the catalog, the build's transients, the yardstick
    cut = None
    if mem_available_bytes() < need:
        cut = {"items": items, "to": 5_000_000, "mem_available_gb": mem_available_bytes() / 2**30}
        items = 5_000_000
        emit({"phase": "ivf-ops", "cut": cut})
    t0 = time.perf_counter()
    mat, queries, _ = clustered_catalog(
        torch, items, features, IVF_CENTERS, seed + 900, 512, device=device
    )
    data_s = time.perf_counter() - t0
    ivf.configure_ann(host_stage1=None)
    pk.reset_launch_counts()
    stn.reset_launch_counts()
    t0 = time.perf_counter()
    index = ivf.build_ivf(mat, device=device)
    build_s = time.perf_counter() - t0
    build_launches = {**pk.launch_counts(), **stn.launch_counts()}
    stages = dict(ivf.last_build_seconds)
    out = {
        "phase": "ivf-ops", "items": items, "features": features, "centers": IVF_CENTERS,
        "cells": index.n_cells, "n_slots": index.n_slots, "data_s": data_s, "build_s": build_s,
        "build_stages_s": stages, "index_device_bytes": tensor_bytes(torch, index),
        "build_launches": build_launches,
        "cell_items_min_median_max": [
            int(c) for c in np.percentile(index.chunk_count_host * index.chunk, [0, 50, 100])
        ],
    }
    if build_launches["kmeans_sweep.tc"] <= 0 and device == "cuda":
        raise AssertionError("ivf-ops: the build launched no kmeans_sweep.tc")
    if any(build_launches[n] for n in build_launches if n != "kmeans_sweep.tc"):
        raise AssertionError(f"ivf-ops: the build launched {build_launches}")
    sweep = ivf_sweep_check(torch, pk, mat, index)
    emit({"phase": "ivf-ops", "b3": sweep})

    exact = exact_from_ivf(torch, stn, index)
    check_exact_codes(torch, stn, exact, mat)
    runs = []
    batch_counts = None
    for pf in IVF_PROBE_FRACTIONS:
        nprobe = max(1, int(round(pf * index.n_cells)))
        for b in IVF_BATCHES:
            q = queries[:b]
            stn.reset_launch_counts()
            ev, ei = stn.top_k_streaming_device(exact, q, 10)
            exact_keys = {n: c for n, c in stn.launch_counts().items() if c}
            if device != "cuda":  # the plain versions count no launch
                exact_keys = {"topn_scan.tc" if b <= stn.LOCAL_TOPK_BATCH else "topn_candidates.tc": 1}
            ivf.reset_counts()
            _, ii = ivf.top_k_device(index, q, 10, nprobe=nprobe)
            counts = ivf.counts()
            if counts["device"] != 1 or counts["host"] or counts["route_syncs"] != 1:
                raise AssertionError(f"ivf-ops: the batch took {counts}, not the device path once")
            if pf == IVF_PROBE_FRACTIONS[0] and b == IVF_BATCHES[-1]:
                batch_counts = counts
            rec = recall_of(ii.cpu().numpy(), ei.cpu().numpy())
            reps = 1 if pf > 0.1 else 5  # 2 at 0.3 before a cut (the cuts line)
            run = {
                "probe_fraction": pf, "nprobe": nprobe, "b": b, "recall_at_10": rec,
                "groups": counts["groups"], "stage1_pieces": counts["pieces"],
                "ms": time_ms(torch, lambda: ivf.top_k_device(index, q, 10, nprobe=nprobe), reps),
                "exact_ms": time_ms(torch, lambda: stn.top_k_streaming_device(exact, q, 10), 5),
                "exact_launch_keys": sorted(exact_keys),
            }
            runs.append(run)
            emit({"phase": "ivf-ops", **run})
            bar = 0.95 if pf < 0.1 else 0.99
            if rec < bar:
                raise AssertionError(f"ivf-ops: recall@10 {rec} at probe-fraction {pf}, b = {b}: below {bar}")
    want = {256: "topn_scan.tc", 512: "topn_candidates.tc"}
    for run in runs:
        if want[run["b"]] not in run["exact_launch_keys"]:
            raise AssertionError(f"ivf-ops: the exact scan at b = {run['b']} took {run['exact_launch_keys']}")
    ops = ivf_op_rows(
        torch, stn, ivf, index, queries, 10, max(1, int(round(IVF_PROBE_FRACTIONS[0] * index.n_cells))),
        {"assign_blocks": -(-items // ivf._ASSIGN_BLOCK)}, batch_counts,
    )
    del exact, index
    torch.cuda.empty_cache()

    # full probe at 1M items: every item rescored, against the exact scan
    n1 = min(1_000_000, items)
    small = ivf.build_ivf(mat[:n1], device=device)
    exact1 = stn.upload_streaming(mat[:n1], dtype=torch.int8, device=device)
    del mat
    q = queries[:64]
    ivf.reset_counts()
    fv, fi = ivf.top_k_device(small, q, 10, nprobe=small.n_cells)
    if ivf.counts()["full"] != 1:
        raise AssertionError(f"ivf-ops: full probe took {ivf.counts()}")
    ev, ei = stn.top_k_streaming_device(exact1, q, 10)
    err = check_topk("ivf full probe against the exact int8 scan", fv.cpu().numpy(), fi.cpu().numpy(),
                     ev.cpu().numpy(), ei.cpu().numpy(), rtol=IVF_FULL_RTOL)
    differ = int((fi.cpu().numpy() != ei.cpu().numpy()).sum())
    out.update(cut=cut, runs=runs, full_probe={
        "items": n1, "cells": small.n_cells, "queries": len(q), "max_abs_err": err,
        "rtol": IVF_FULL_RTOL, "ids_differing_at_near_ties": differ,
        "ms": time_ms(torch, lambda: ivf.top_k_device(small, q, 10, nprobe=small.n_cells), 2),
    })
    emit({k: v for k, v in out.items() if k != "runs"})
    del small, exact1
    torch.cuda.empty_cache()
    return {"launches": build_launches, "sweep": sweep, "ops": ops}


def ivf_serving_extra(root: str) -> str:
    # the phase holds the tier's full-probe answers (every fold-in
    # visible under 64 concurrent requests): overload control, which trades
    # probes for latency at that load, is the serving-front phase's
    return f"""
        batch.storage.model-dir = "{root}/model"
        serving.overload.enabled = false
        serving.scan.ann {{
          enabled = true
          maintain {{ enabled = true, interval-sec = 1.0, publish = true }}
        }}
    """


def start_replica(broker_loc: str, extra: str, x: np.ndarray, y: np.ndarray):
    """A second port ServingLayer on the same bus: it replays the MODEL
    and UP lines there, then takes the bulk of the vectors through the
    batched setters, as serve() loads its layer."""
    from oryx_tpu_torch.serving.layer import ServingLayer

    layer = ServingLayer(serving_config(broker_loc, "int8", extra))
    layer.start()
    deadline = time.monotonic() + 120
    while True:
        model = layer.model_manager.get_model() if layer.model_manager else None
        if model is not None and model.y.size() >= SERVE_TOPIC_ROWS and model.x.size() >= SERVE_TOPIC_ROWS:
            break
        if time.monotonic() > deadline:
            raise AssertionError("the replica never loaded the model")
        time.sleep(0.05)
    model.set_item_vectors([f"i{j}" for j in range(SERVE_TOPIC_ROWS, len(y))], y[SERVE_TOPIC_ROWS:])
    model.set_user_vectors([f"u{j}" for j in range(SERVE_TOPIC_ROWS, len(x))], x[SERVE_TOPIC_ROWS:])
    return layer, model


def wait_for(what: str, pred, timeout: float, phase: str = "ivf-serving") -> float:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{phase}: {what} within {timeout} s")
        time.sleep(0.05)
    return time.monotonic() - t0


def phase_ivf_serving(torch, args, stn, pk, seed: int, items: int = 1_000_000,
                      folds: int = IVF_FOLDS, device: str = "cuda") -> dict:
    """Phase 3's serve() path with the IVF tier on: 250 features x 1M
    clustered int8 items on a file: bus, 64 concurrent /recommend (p50,
    p99, recall@10 against the exact float32 top-10, the first request's
    seconds with the build), 10,000 item fold-ins past the overlay's 4,096
    slots (spill, background compaction at a 1 s interval, every folded
    item visible in /recommend), and a second layer on the bus adopting
    the published INDEX-REF. Returns the launches of the serving path."""
    import tempfile

    from oryx_tpu_torch.ops import ivf
    from oryx_tpu_torch.serving import maintain

    users, f = min(IVF_SERVING_USERS, items // 10), args.features
    n_centers = min(IVF_SERVING_CENTERS, items // 1000)
    y, x, centers = clustered_catalog(torch, items, f, n_centers, seed + 901, users, device=device)
    gen = np.random.default_rng(seed + 902)
    probe = sorted(gen.choice(np.arange(SERVE_TOPIC_ROWS, users), size=args.concurrency, replace=False))
    y_exact = stn.upload_streaming(y, dtype=torch.float32, device=device)
    _, ref_i = exact_top(torch, stn, y_exact, x[probe], 10)
    del y_exact
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip-smoke-ivf-")
    broker_loc = f"file:{root}/bus"
    extra = ivf_serving_extra(root)
    ivf.reset_counts()
    pk.reset_launch_counts()
    stn.reset_launch_counts()
    layer, model, bodies, statuses, lat, info = serve(
        torch, args, "int8", x, y, probe, broker_loc=broker_loc, extra=extra
    )
    replica = None
    try:
        build_stages = dict(ivf.last_build_seconds)
        index = model._ensure_y_matrix()[2]
        if not isinstance(index, ivf.IVFIndex):
            raise AssertionError(f"ivf-serving: the model serves {type(index).__name__}, not IVF")
        if any(s != 200 for s in statuses):
            raise AssertionError(f"ivf-serving: statuses {sorted(set(statuses))}")
        recall = sum(
            len({r["id"] for r in bodies[str(u)]} & {f"i{j}" for j in ref_i[row]})
            for row, u in enumerate(probe)
        ) / (10.0 * len(probe))
        served = ivf.counts()
        launches = {**pk.launch_counts(), **stn.launch_counts()}
        out = {
            "phase": "ivf-serving", "items": items, "users": users, "features": f,
            "centers": n_centers, "cells": index.n_cells,
            "nprobe": index.resolve_nprobe(), "requests": len(lat),
            "concurrency": args.concurrency, "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))], "recall_at_10": recall,
            "build_stages_s": build_stages, "ann_batches": served, "launches": launches, **info,
        }
        if recall < 0.95:
            raise AssertionError(f"ivf-serving: recall@10 {recall}, below 0.95")
        if served["device"] <= 0 or served["host"] or served["route_syncs"] != served["device"]:
            raise AssertionError(f"ivf-serving: the scans took {served}")
        if launches["kmeans_sweep.tc"] <= 0 and device == "cuda":
            raise AssertionError("ivf-serving: the index build launched no kmeans_sweep.tc")

        # the replica builds its own index first, as a fresh replica would
        replica, rmodel = start_replica(broker_loc, extra, x, y)
        rbase = f"http://127.0.0.1:{replica.port}"
        status, _, out["replica_first_request_s"] = http_get(f"{rbase}/recommend/u{probe[0]}")
        if status != 200:
            raise AssertionError(f"ivf-serving: the replica answered {status}")

        # fold-ins: items near the catalog's centers, scaled by 1.5, and a
        # user pointing at each, over the update topic to both layers
        n_fold = folds
        lab = gen.integers(0, n_centers, n_fold)
        folds = (1.5 * (centers[lab] + 0.3 * gen.standard_normal((n_fold, f)))).astype(np.float32)
        from oryx_tpu_torch import bus
        from oryx_tpu_torch.common.text import join_json

        wait_for("the maintainer hooked the model", lambda: model._index_pressure_cb is not None, 60)
        t0 = time.perf_counter()
        lines = []
        for j, vec in enumerate(folds.tolist()):
            lines += [("UP", join_json(["Y", f"f{j}", vec])), ("UP", join_json(["X", f"v{j}", vec]))]
        with bus.get_broker(broker_loc).producer("OryxUpdate") as p:
            p.send_many(lines)
        send_s = time.perf_counter() - t0
        for m in (model, rmodel):
            wait_for("the fold-ins arrived", lambda m=m: m.y.size() == items + n_fold
                     and m.x.size() == users + n_fold, 300)
        base = f"http://127.0.0.1:{layer.port}"
        t_fold = time.monotonic()
        # the refresh after the model's throttle folds them into the overlay
        time.sleep(0.3)
        http_get(f"{base}/recommend/u{probe[0]}")
        folded = model._ensure_y_matrix()[2]
        spilled = len(folded.pending_spill or {}) if isinstance(folded, ivf.IVFIndex) else None
        wait_for("a compaction installed and published", lambda: model.index_generation is not None, 300)
        published_s = time.monotonic() - t_fold
        gid = model.index_generation
        wait_for("the replica adopted the generation", lambda: rmodel.index_generation == gid, 300)
        adopted_s = time.monotonic() - t_fold
        stats = dict(layer._index_maintainer.last_stats or {})
        stats.pop("born", None)
        compacted = model._ensure_y_matrix()[2]
        if compacted.pending_spill or compacted.ov_used:
            raise AssertionError(
                f"ivf-serving: {compacted.ov_used} overlay rows and "
                f"{len(compacted.pending_spill)} spilled left after compaction"
            )

        # every folded item is visible: /recommend/v{j} holds f{j}
        urls = [f"{base}/recommend/v{j}" for j in range(n_fold)]
        with ThreadPoolExecutor(args.concurrency) as pool:
            res = list(pool.map(http_get, urls))
        missing, top1 = [], 0
        for j, (status, body, _) in enumerate(res):
            ids = [r["id"] for r in json.loads(body)] if status == 200 else []
            if f"f{j}" not in ids:
                missing.append(j)
            top1 += bool(ids) and ids[0] == f"f{j}"
        if missing:
            # what each of the first few saw: the answer, the item's own
            # score, and whether a full probe of the index finds its row
            _, y_index, *_ = model._ensure_y_matrix()
            seen = []
            for j in missing[:3]:
                status, body, _ = res[j]
                row = y_index.get(f"f{j}")
                full_i, full_v = ivf.top_k(compacted, folds[j : j + 1], 10, nprobe=compacted.n_cells)
                probed_i, _ = ivf.top_k(compacted, folds[j : j + 1], 10)
                seen.append({
                    "fold": j, "status": status, "row": row,
                    "answer": [(r["id"], r["value"]) for r in json.loads(body)] if status == 200 else None,
                    "self_score": float(folds[j].astype(np.float64) @ folds[j]),
                    "full_probe_has_it": row in full_i[0].tolist(),
                    "probed_has_it": row in probed_i[0].tolist(),
                    "full_probe_values": full_v[0].tolist(),
                })
            raise AssertionError(
                f"ivf-serving: {len(missing)} folded items not visible, e.g. f{missing[0]}: {seen}")

        # both replicas on one generation answer alike
        same = 0
        for u in probe:
            a = [r["id"] for r in json.loads(http_get(f"{base}/recommend/u{u}")[1])]
            b = [r["id"] for r in json.loads(http_get(f"{rbase}/recommend/u{u}")[1])]
            same += a == b
        if same != len(probe):
            raise AssertionError(f"ivf-serving: the replicas agree on {same} of {len(probe)} users")
        out.update(
            folds=n_fold, fold_send_s=send_s, spilled_at_refresh=spilled,
            published_after_s=published_s, adopted_after_s=adopted_s, index_generation=gid,
            compaction=stats, freshness_s=metrics_gauge(maintain.FRESHNESS_GAUGE),
            folds_visible=n_fold - len(missing), folds_top1=top1, replicas_agree=same,
            ann_batches=ivf.counts(), launches={**pk.launch_counts(), **stn.launch_counts()},
        )
        emit(out)
        live = stats.get("live", 0) + stats.get("folded", 0)
        kf = compacted.mat_t.shape[0]
        compact_row = {
            "what": f"compact_ivf of {stats.get('folded')} fold-ins into {live} items "
                    f"(wall, host included)",
            "ms": 1e3 * stats.get("compact_seconds", math.nan),
            "launches": layer._index_maintainer.compactions,
            # read back the live rows' planes, write the new layout
            "bound": ops_bound(2.0 * live * (3 * kf + 16), 0.0),
        }
        # native-host's tiered plane is laid out on this catalog and index
        cents = np.ascontiguousarray(index.centroids_t.cpu().numpy().T[:, :f])
        return {"launches": {**pk.launch_counts(), **stn.launch_counts()},
                "compact_row": compact_row, "catalog": (y, x[:TIER_QUERIES], cents)}
    finally:
        if replica is not None:
            replica.close()
        layer.close()
        torch.cuda.empty_cache()


# -- phase 14: serving-front, the default request path -----------------------------

# each front's closed loop (a): clients and requests
FRONT_CLIENTS = 64
FRONT_REQUESTS = 1024  # 4,096, then 2,048, before cuts (the cuts line)
# the ladder's load (b), from the client process: (clients, seconds) per
# step: below budget, overload (four clients for each of the front's 64
# dispatch workers), back below
LADDER_STEPS = ((16, 10.0), (256, 15.0), (16, 10.0))
# the URL set of (a) and (b): /recommend of this many users, drawn from
# the catalog's 100,000 (16 times the stale rung's 256 cached answers)
FRONT_USERS = 4096
FRONT_GENERATION = "1700000000000"  # the MODEL's generation extension
STAGE_SAMPLE_S = 0.1  # /healthz's shed_stage and the ladder's signals, sampled
# reduced-probe answers against x_u . y_id in float64: the two-plane int8
# rescore's error, relative to the largest score of the answer
FRONT_VALUE_RTOL = 1e-4


def client_main(spec_path: str, out_path: str) -> None:
    """The load of the serving-front phase, run in a process of its own
    so that its clients do not share the server's interpreter lock:
    closed-loop threads over keep-alive ``http.client`` connections, one
    step after another, each response recorded as [step, start s,
    latency ms, status, X-Oryx-Shed-Stage, Retry-After, path, body,
    X-Oryx-Experiment-Arm]; a step with ``groups`` runs each group's
    clients on the group's own paths, all at once, and one with
    ``partition`` asks each path once, client c taking paths[c::clients];
    ``user_header`` names a header sent with each path's last segment;
    with ``sample``, a thread reads that path every ``sample_s`` and
    records [s, status, shed_stage]."""
    import http.client
    from urllib.parse import urlsplit

    with open(spec_path) as f:
        spec = json.load(f)
    host = urlsplit(spec["base"])
    paths = spec["paths"]
    t_zero, t_zero_mono = time.perf_counter(), time.monotonic()
    records, samples, lock = [], [], threading.Lock()
    stop_sampling = threading.Event()

    def connect():
        return http.client.HTTPConnection(host.hostname, host.port, timeout=120)

    def sampler():
        conn = connect()
        while not stop_sampling.is_set():
            t = time.perf_counter() - t_zero
            try:
                conn.request("GET", spec["sample"])
                resp = conn.getresponse()
                body = json.loads(resp.read())
                samples.append([t, resp.status, body.get("shed_stage")])
            except (OSError, http.client.HTTPException, ValueError):
                conn.close()
                conn = connect()
                samples.append([t, -1, None])
            stop_sampling.wait(max(0.0, spec["sample_s"] - (time.perf_counter() - t_zero - t)))
        conn.close()

    def client(step: int, slot: int, deadline, budget, paths, once=None):
        conn = connect()
        i = slot
        local = []
        while True:
            if deadline is not None and time.perf_counter() >= deadline:
                break
            if budget is not None:
                with lock:
                    if budget[0] <= 0:
                        break
                    budget[0] -= 1
            if once is not None:  # a partition of the paths, each asked once
                if not once:
                    break
                path = once.pop()
            else:
                path = paths[i % len(paths)]
                i += 7
            headers = ({spec["user_header"]: path.split("?")[0].rsplit("/", 1)[1]}
                       if spec.get("user_header") else {})
            t0 = time.perf_counter()
            try:
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
                body = resp.read().decode("utf-8", "replace")
                local.append([step, t0 - t_zero, 1e3 * (time.perf_counter() - t0), resp.status,
                              resp.getheader("X-Oryx-Shed-Stage"), resp.getheader("Retry-After"),
                              path, body, resp.getheader("X-Oryx-Experiment-Arm")])
            except (OSError, http.client.HTTPException) as e:
                local.append([step, t0 - t_zero, 1e3 * (time.perf_counter() - t0), -1, None,
                              None, path, repr(e)])
                conn.close()
                conn = connect()
        conn.close()
        with lock:
            records.extend(local)

    sampling = None
    if spec.get("sample"):
        sampling = threading.Thread(target=sampler, daemon=True)
        sampling.start()
    starts = []
    for step, st in enumerate(spec["steps"]):
        starts.append(time.perf_counter() - t_zero)
        deadline = None if st.get("seconds") is None else time.perf_counter() + st["seconds"]
        budget = None if st.get("requests") is None else [st["requests"]]
        groups = st.get("groups") or [{"clients": st["clients"], "paths": paths}]
        threads = [
            threading.Thread(target=client, args=(
                step, c * 7919, deadline, budget, g["paths"],
                g["paths"][c::g["clients"]][::-1] if st.get("partition") else None))
            for g in groups
            for c in range(g["clients"])
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    stop_sampling.set()
    if sampling is not None:
        sampling.join()
    with open(out_path, "w") as f:
        json.dump({"t_zero_mono": t_zero_mono, "step_starts": starts,
                   "end": time.perf_counter() - t_zero,
                   "records": records, "samples": samples}, f)


def run_clients(spec: dict, timeout: float) -> dict:
    """client_main in a child process; its records."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip-smoke-clients-") as tmp:
        spec_path, out_path = os.path.join(tmp, "spec.json"), os.path.join(tmp, "out.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                f"chip_smoke.client_main({spec_path!r}, {out_path!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, timeout=timeout,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise AssertionError(f"the client process failed:\n{proc.stderr[-3000:]}")
        with open(out_path) as f:
            return json.load(f)


def latency_summary(records: list, seconds: float) -> dict:
    lat = sorted(r[2] for r in records)
    return {"requests": len(lat), "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "rps": len(lat) / seconds}


def raw_fetch(port: int, path: str) -> bytes:
    """One GET on its own connection, the response's bytes as sent."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n\r\n".encode())
        chunks = []
        while True:
            b = s.recv(65536)
            if not b:
                break
            chunks.append(b)
    return b"".join(chunks)


def masked(resp: bytes) -> bytes:
    """A response's bytes less the Date header, and for /healthz the
    staleness seconds (and the Content-Length they move): the two layers
    read their clocks at different instants, as in the JAX package's
    native-front parity tests."""
    resp = re.sub(rb"\r\nDate: [^\r\n]+", b"\r\nDate: -", resp)
    if b'"staleness_seconds"' in resp:
        resp = re.sub(rb'"staleness_seconds": [0-9.eE+-]+', b'"staleness_seconds": 0', resp)
        resp = re.sub(rb"\r\nContent-Length: \d+", b"\r\nContent-Length: -", resp)
    return resp


@contextlib.contextmanager
def ladder_held_at_full(layer):
    """The layer's admission controller fed idle signals while the block
    runs, so that it walks down to full (one rung each hold-s) and stays
    there; budgets, rungs and fronts stay as configured."""
    from oryx_tpu_torch.serving.overload import STAGE_FULL

    adm = layer.admission
    signals, adm._signals = adm._signals, lambda: (0.0, 0, 0)
    try:
        wait_for("the ladder at full", lambda: adm.evaluate() == STAGE_FULL, 60,
                 phase="serving-front")
        yield
    finally:
        adm._signals = signals


class SignalSampler:
    """The admission controller's inputs and state, read in the server's
    process every STAGE_SAMPLE_S while the block runs: [monotonic s,
    queue-wait EWMA ms, batcher queue depth, in flight, pressure, stage];
    the signals are the layer's own, whatever the controller is fed."""

    def __init__(self, layer) -> None:
        self.layer, self.samples = layer, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        adm = self.layer.admission
        while not self._stop.wait(STAGE_SAMPLE_S):
            wait_ms, depth, inflight = self.layer._overload_signals()
            self.samples.append([time.monotonic(), wait_ms, depth, inflight, adm.pressure,
                                 adm.stage])

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def _ratio(self, s: list) -> float:
        """One sample's signals over their budgets: the controller's raw
        pressure before smoothing."""
        cfg = self.layer.overload_config
        return max(s[1] / cfg.target_queue_wait_ms, s[3] / max(1, cfg.inflight_target),
                   s[2] / cfg.max_queue if cfg.max_queue else 0.0)

    def peaks(self, lo: float, hi: float) -> dict:
        """The signals' largest values between monotonic lo and hi."""
        w = [s for s in self.samples if lo <= s[0] < hi]
        if not w:
            return {"samples": 0}
        return {"samples": len(w), "queue_wait_ms_max": max(s[1] for s in w),
                "depth_max": max(s[2] for s in w), "inflight_max": max(s[3] for s in w),
                "signal_ratio_max": max(self._ratio(s) for s in w),
                "pressure_max": max(s[4] for s in w),
                "pressure_mean": sum(s[4] for s in w) / len(w)}


def stage_runs(samples: list) -> list:
    """The /healthz samples as runs: [shed_stage, first s, last s, samples]."""
    runs = []
    for t, _, stage in samples:
        if runs and runs[-1][0] == stage:
            runs[-1][2] = t
            runs[-1][3] += 1
        else:
            runs.append([stage, t, t, 1])
    return [[st, round(a, 3), round(b, 3), n] for st, a, b, n in runs]


def phase_serving_front(torch, args, stn, pk, seed: int, items: int = 1_000_000,
                        device: str = "cuda") -> dict:
    """The JAX package's default request path in the port: the IVF tier
    behind the admission ladder, served (a) by the pooled stdlib front and
    by the native front in turn, 64 clients in another process each, then
    (b) the native front under LADDER_STEPS, the reference's overload
    defaults unchanged. Returns the path's kernel launches and the
    requests/s of (a) through the native front."""
    from oryx_tpu_torch.common.metrics import registry
    from oryx_tpu_torch.ops import ivf
    from oryx_tpu_torch.serving import overload

    # the phase's wall seconds by step, each since the one before
    steps_s, t_step = {}, [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        steps_s[name], t_step[0] = now - t_step[0], now

    users, f = min(IVF_SERVING_USERS, items // 10), args.features
    n_centers = min(IVF_SERVING_CENTERS, items // 1000)
    y, x, _ = clustered_catalog(torch, items, f, n_centers, seed + 1001, users, device=device)
    gen = np.random.default_rng(seed + 1002)
    probe = sorted(gen.choice(np.arange(SERVE_TOPIC_ROWS, users), size=FRONT_USERS, replace=False))
    y_exact = stn.upload_streaming(y, dtype=torch.float32, device=device)
    _, ref_i = exact_top(torch, stn, y_exact, x[probe], 10)
    del y_exact
    torch.cuda.empty_cache()
    exact = {f"/recommend/u{u}": {f"i{j}" for j in ref_i[row]} for row, u in enumerate(probe)}
    paths = list(exact)

    def recall(records) -> float:
        hits = sum(len({r["id"] for r in json.loads(rec[7])} & exact[rec[6]]) for rec in records)
        return hits / (10.0 * max(1, len(records)))

    def by_stage(records) -> dict:
        out = {}
        for rec in records:
            key = str(rec[3]) if rec[3] != 200 else (rec[4] or "full")
            out[key] = out.get(key, 0) + 1
        return out

    pk.reset_launch_counts()  # this slice's path starts here
    stn.reset_launch_counts()
    out = {"phase": "serving-front", "items": items, "users": users, "features": f,
           "centers": n_centers, "url_users": FRONT_USERS, "steps_s": steps_s}
    layers, native_full = {}, []
    step("catalog")
    try:
        for front, enabled in (("stdlib", "false"), ("native", '"true"')):
            extra = f"serving.scan.ann.enabled = true\nserving.native.enabled = {enabled}"
            layer, model, _, statuses, _, info = serve(
                torch, args, "int8", x, y, probe[: args.concurrency],
                broker_loc=f"inproc://chip-smoke-front-{front}", extra=extra,
                generation=FRONT_GENERATION,
            )
            layers[front] = layer
            step(f"{front}_load")
            if any(s != 200 for s in statuses):
                raise AssertionError(f"serving-front ({front}): warm-up statuses {set(statuses)}")
            if (layer._native_front is not None) != (front == "native"):
                raise AssertionError(f"serving-front: the {front} layer serves through "
                                     f"{type(layer._native_front).__name__}")
            if not isinstance(model._ensure_y_matrix()[2], ivf.IVFIndex):
                raise AssertionError("serving-front: the model does not serve from IVF")
            if layer.health.live_generation != FRONT_GENERATION:
                raise AssertionError(f"serving-front: live generation {layer.health.live_generation}")
            before = registry.counter("serving.http.requests").value
            ivf.reset_counts()
            launched_before = {**pk.launch_counts(), **stn.launch_counts()}
            # the fronts compared on the same work: at 64 clients in flight
            # sits at its budget and the queue wait near its own, so a free
            # ladder serves each front a different mix of rungs (and may
            # shed); it is held at full here, its signals still sampled,
            # and (b) drives it
            with ladder_held_at_full(layer), SignalSampler(layer) as sig:
                res = run_clients({
                    "base": f"http://127.0.0.1:{layer.port}", "paths": paths,
                    "steps": [{"clients": FRONT_CLIENTS, "requests": FRONT_REQUESTS}],
                    "sample": "/healthz", "sample_s": STAGE_SAMPLE_S,
                }, timeout=600)
            recs = res["records"]
            launched = {**pk.launch_counts(), **stn.launch_counts()}
            row = {**latency_summary(recs, res["end"] - res["step_starts"][0]),
                   "served": by_stage(recs), "signals": sig.peaks(-math.inf, math.inf),
                   "stage_timeline": stage_runs(res["samples"]),
                   "ann_batches": ivf.counts(),
                   "nprobe_batches": {str(k): v for k, v in sorted(ivf.nprobe_counts().items())},
                   "launches": {k: v - launched_before[k] for k, v in launched.items()}, **info}
            bad = sorted({str(r[3]) if r[3] != 200 else r[4] for r in recs
                          if r[3] != 200 or r[4] is not None})
            if bad or len(recs) != FRONT_REQUESTS:
                emit({"phase": "serving-front", front: row})
                raise AssertionError(f"serving-front ({front}): statuses or rungs {bad}, "
                                     f"{len(recs)} of {FRONT_REQUESTS} answered")
            row["recall_at_10"] = recall(recs)
            if layer._native_front is not None:
                layer._native_front.push_control()  # drains the native stats
                row["native_http_requests"] = registry.counter("serving.http.requests").value - before
                if row["native_http_requests"] < FRONT_REQUESTS:
                    raise AssertionError(f"serving-front: the native front counted {row}")
            out[front] = row
            if front == "native":  # earlier full answers for the stale rung's check
                native_full = [r for r in recs if r[4] is None]
            if row["recall_at_10"] < 0.95:
                raise AssertionError(f"serving-front ({front}): recall@10 {row['recall_at_10']}")
            step(f"{front}_a")

        # byte parity, with both ladders back at full (the stdlib layer's
        # ladder moves only on requests or an evaluation) and held there
        # while the fronts are read: the native front's control tick
        # evaluates its ladder on the real signals every 50 ms, and the
        # queue-wait EWMA of (a)'s load can lift it a rung between the
        # wait and the reads
        def ladders_full():
            for layer in layers.values():
                layer.admission.evaluate()
            return all(layer.admission.stage == overload.STAGE_FULL for layer in layers.values())

        wait_for("both ladders back at full", ladders_full, 60, phase="serving-front")
        parity = {}
        with contextlib.ExitStack() as held:
            for layer in layers.values():
                held.enter_context(ladder_held_at_full(layer))
            layers["native"]._native_front.push_control()
            for path in ("/healthz", "/readyz", "/ready", paths[0]):
                got = {front: raw_fetch(layer.port, path) for front, layer in layers.items()}
                if masked(got["native"]) != masked(got["stdlib"]):
                    raise AssertionError(
                        f"serving-front: {path} differs between the fronts:\n"
                        f"native {got['native'][:600]!r}\nstdlib {got['stdlib'][:600]!r}")
                parity[path] = len(got["native"])
        layers["native"]._native_front.push_control()
        snapshots = registry.counter("serving.http.native-answered.snapshot").value
        if snapshots <= 0:
            raise AssertionError("serving-front: the native front answered no snapshot")
        out["parity_bytes"] = parity
        out["native_answered_snapshots"] = snapshots
        layers.pop("stdlib").close()
        step("parity")

        # (b) the ladder on the native front
        layer = layers["native"]
        out["overload"] = vars(layer.overload_config)
        index = layer.model_manager.get_model()._ensure_y_matrix()[2]
        full_nprobe = index.resolve_nprobe()
        ivf.reset_counts()
        moves_before = len(layer.admission.transitions)
        with SignalSampler(layer) as sig:
            res = run_clients({
                "base": f"http://127.0.0.1:{layer.port}", "paths": paths,
                "steps": [{"clients": c, "seconds": s} for c, s in LADDER_STEPS],
                "sample": "/healthz", "sample_s": STAGE_SAMPLE_S,
            }, timeout=600)
        recs, starts, samples = res["records"], res["step_starts"], res["samples"]
        step("ladder")
        mono = [res["t_zero_mono"] + t for t in starts] + [res["t_zero_mono"] + res["end"]]
        nprobes = ivf.nprobe_counts()
        steps = []
        for i, (clients, seconds) in enumerate(LADDER_STEPS):
            sr = [r for r in recs if r[0] == i]
            steps.append({"clients": clients, "seconds": seconds, **latency_summary(sr, seconds),
                          "served": by_stage(sr), "signals": sig.peaks(mono[i], mono[i + 1])})
        # the controller's moves in this run: [s from the first step's start,
        # from stage, to stage, pressure]
        moves = [[t - mono[0], a, b, p] for t, a, b, p in
                 layer.admission.transitions[moves_before:]]
        pool = layer._native_front._pool._max_workers
        out["ladder"] = {"steps": steps, "stage_timeline": stage_runs(samples), "moves": moves,
                         "dispatch_workers": pool,
                         "nprobe_batches": {str(k): v for k, v in sorted(nprobes.items())},
                         "full_nprobe": full_nprobe}
        emit(out)
        server_errors = [r for r in recs if r[3] >= 500 or r[3] < 0]
        if server_errors:
            raise AssertionError(f"serving-front: {len(server_errors)} 5xx or failed requests, "
                                 f"e.g. {server_errors[0][3:]}")
        # the overload step fills the front's dispatch pool; the ladder
        # counts a request in flight once a worker takes it (as the JAX
        # package does), so in flight stops at the pool, whose default size
        # is inflight-target, and pressure passes engage-shed only through
        # the queue wait: shed is checked where the controller moved there
        cfg = layer.overload_config
        overload_sig = steps[1]["signals"]
        if overload_sig.get("inflight_max", 0) < pool:
            raise AssertionError(f"serving-front: the overload step never filled the {pool} "
                                 f"dispatch workers: {overload_sig}")
        shed = [r for r in recs if r[3] == 429]
        shed_moved = any(b == overload.STAGE_SHED for _, _, b, _ in moves)
        if shed_moved:
            if not shed or any(r[4] != "shed" or r[5] != "1" for r in shed):
                raise AssertionError(f"serving-front: the ladder shed, and (b) answered "
                                     f"{len(shed)} 429s")
            if not any(s[2] == "shed" for s in samples):
                raise AssertionError("serving-front: the ladder shed, /healthz never showed it")
        elif shed or any(s[2] == "shed" for s in samples):
            raise AssertionError(f"serving-front: {len(shed)} 429s, the controller never at shed")
        other = [r for r in recs if r[3] not in (200, 429)]
        if other:
            raise AssertionError(f"serving-front: statuses {sorted({r[3] for r in other})}")
        reduced = [r for r in recs if r[3] == 200 and r[4] == "reduced-probe"]
        stale = [r for r in recs if r[3] == 200 and r[4] == "stale"]
        if not reduced or not stale:
            raise AssertionError(f"serving-front: {len(reduced)} reduced-probe and "
                                 f"{len(stale)} stale answers")
        worst = 0.0
        for rec in reduced:
            xu = x[int(rec[6].rsplit("/u", 1)[1])].astype(np.float64)
            got = json.loads(rec[7])
            want = np.array([y[int(r["id"][1:])].astype(np.float64) @ xu for r in got])
            err = np.abs(np.array([r["value"] for r in got]) - want) / max(1e-12, np.abs(want).max())
            worst = max(worst, float(err.max()))
        if worst > FRONT_VALUE_RTOL:
            raise AssertionError(f"serving-front: a reduced-probe value is {worst} off x_u . y_id")
        # a stale body must be a full answer that came earlier: in (a), or
        # in (b) before this one ended
        full = {}
        for r in native_full:
            full.setdefault(r[6], []).append((-math.inf, r[7]))
        for r in recs:
            if r[3] == 200 and r[4] is None:
                full.setdefault(r[6], []).append((r[1] + r[2] / 1e3, r[7]))
        for rec in stale:
            end = rec[1] + rec[2] / 1e3
            if not any(body == rec[7] and t <= end for t, body in full.get(rec[6], ())):
                raise AssertionError(f"serving-front: a stale answer to {rec[6]} is no earlier "
                                     "full answer")
        if not any(k < full_nprobe for k in nprobes):
            raise AssertionError(f"serving-front: no IVF batch below nprobe {full_nprobe}: {nprobes}")
        last = [s for s in samples if s[0] >= starts[2]]
        tail = next((i for i in range(len(last)) if all(s[2] == "full" for s in last[i:])), None)
        if tail is None or last[tail][0] - starts[2] > 10 * layer.overload_config.hold_s:
            raise AssertionError(f"serving-front: not back at full within 10 x hold-s: {stage_runs(last)}")
        t_full = last[tail][0]
        late = [r for r in recs if r[1] >= t_full and (r[3] != 200 or r[4] is not None)]
        if late:
            raise AssertionError(f"serving-front: {len(late)} answers below full after {t_full} s")
        launches = {**pk.launch_counts(), **stn.launch_counts()}
        result = {
            "shed_reached": shed_moved, "engage_shed": cfg.engage_shed,
            "overload_pressure_max": overload_sig["pressure_max"],
            "overload_queue_wait_ms_max": overload_sig["queue_wait_ms_max"],
            "overload_inflight_max": overload_sig["inflight_max"],
            "reduced_probe_answers": len(reduced), "stale_answers": len(stale),
            "reduced_probe_recall_at_10": recall(reduced),
            "full_recall_at_10": recall([r for r in recs if r[3] == 200 and r[4] is None]),
            "reduced_value_max_rel_err": worst, "back_at_full_after_s": t_full - starts[2],
            "launches": launches,
        }
        emit({"phase": "serving-front-checks", **result})
        if device == "cuda" and launches["kmeans_sweep.tc"] <= 0:
            raise AssertionError("serving-front: the index builds launched no kmeans_sweep.tc")
        return launches, out["native"]["rps"]
    finally:
        for layer in layers.values():
            layer.close()
        torch.cuda.empty_cache()


# -- phase 14c: open-loop, the port's load generator against ALS serving --------


OPEN_LOOP_SECONDS = 8.0
OPEN_LOOP_FACTORS = (0.5, 1.5)  # of the requests/s serving-front (a) measured, native front
# serving-front (a) measures IVF int8 under closed-loop clients, which may
# sit below what float32 exact serving takes open-loop: while the last rate
# left the ladder at full with no queued arrival, the rate doubles, for
# OPEN_LOOP_STEP_SECONDS, at most OPEN_LOOP_MAX_STEPS times
OPEN_LOOP_STEP_SECONDS = 4.0
OPEN_LOOP_MAX_STEPS = 2
OPEN_LOOP_SAMPLE = 64  # full answers per rate held against the exact top-10
FAILURE_KINDS = ("timeout", "connection", "no-ready-replica", "http-3xx", "http-4xx", "http-5xx")


class OffsetUsers:
    """PowerLawUsers' indices moved past the users the MODEL names (they
    know an item each, which /recommend leaves out)."""

    def __init__(self, users, offset: int) -> None:
        self.users, self.offset = users, offset

    def one(self) -> int:
        return self.users.one() + self.offset


def open_loop_main(out_path: str) -> None:
    """The open-loop phase's load, in a process of its own so that its
    clients share no interpreter lock with the server: reads the spec as
    one JSON line on standard input, drives each rate with the port's
    ``OpenLoopEngine`` (Poisson arrivals, PowerLawUsers with the JAX
    package's defaults), writes the rate's result to ``<out_path>.<i>``
    and prints ``done <i>`` once every request of the rate has come back;
    while the last rate did not overload the layer (every answer full, no
    queued arrival), runs twice that rate for ``step_seconds``, at most
    ``max_steps`` times; prints ``end <rates run>`` last."""
    import random

    from oryx_tpu_torch.loadgen import OpenLoopEngine, PoissonProcess, PowerLawUsers, Target
    from oryx_tpu_torch.loadgen.engine import SHED_HEADER

    spec = json.loads(sys.stdin.readline())
    rates = list(spec["rates"])
    for i, rate in enumerate(rates):  # grows while it runs
        seconds = spec["seconds"] if i < len(spec["rates"]) else spec["step_seconds"]
        pick, samples, seen, lock = random.Random(spec["seed"] + i), [], [0], threading.Lock()

        def keep(user, status, headers, body):
            # a reservoir of the full answers, spread over the whole run
            if (headers.get(SHED_HEADER) or "full") != "full":
                return
            with lock:
                seen[0] += 1
                if len(samples) < spec["sample"]:
                    samples.append([user, body.decode()])
                elif pick.random() < spec["sample"] / seen[0]:
                    samples[pick.randrange(spec["sample"])] = [user, body.decode()]

        engine = OpenLoopEngine([Target("open-loop", spec["base"])],
                                template="/recommend/u%d", on_response=keep)
        users = OffsetUsers(PowerLawUsers(spec["users"], seed=spec["seed"] + i), spec["offset"])
        result = engine.run(PoissonProcess(rate, seed=spec["seed"] + i), users, seconds)
        answered = [r for r in result.records if r.ok or r.kind == "shed"]
        by_stage = collections.Counter(r.shed_stage for r in answered)
        row = {
            **result.summary(),
            "service_p50_ms": result.service_quantile(0.50) * 1e3,
            "service_p99_ms": result.service_quantile(0.99) * 1e3,
            "answers_by_stage": dict(by_stage),
            "overloaded": result.queued_arrivals > 0 or set(by_stage) - {"full"} != set(),
            "samples": samples,
        }
        with open(f"{out_path}.{i}", "w") as f:
            json.dump(row, f)
        print(f"done {i}", flush=True)
        if (i == len(rates) - 1 and not row["overloaded"]
                and len(rates) < len(spec["rates"]) + spec["max_steps"]):
            rates.append(2.0 * rate)
    print(f"end {len(rates)}", flush=True)


def phase_open_loop(torch, args, stn, x: np.ndarray, y: np.ndarray, seed: int,
                    front_rps: float, smi: str, device: str = "cuda") -> dict:
    """Phase 14c: one ALS ServingLayer on the default request path (the
    native front, the admission ladder), phase 3's factors in float32,
    driven open-loop by the port's load generator, in another process, at
    OPEN_LOOP_FACTORS times ``front_rps`` for OPEN_LOOP_SECONDS each, and
    then at doubled rates until one overloads the layer (OPEN_LOOP_STEP_*):
    latency from the scheduled arrival and service time, queued arrivals,
    failures by kind and answers by stage; no failure at the first rate,
    at every other no 5xx or connection failure and every failure
    classified, and the rate that first overloaded the layer printed (the
    overload checks bit only if one did); a sample of full answers held
    against the exact float32 top-10; the scan and merge launches counted
    from zero at the phase's start. Returns those launches."""
    t0 = time.perf_counter()
    stn.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-open-loop-") as tmp:
        out_path = os.path.join(tmp, "rate")
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                f"chip_smoke.open_loop_main({out_path!r})")
        # started first: it imports the load generator while the layer loads
        child = subprocess.Popen([sys.executable, "-c", code], cwd=HERE, text=True,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        try:
            layer, model, base, info = start_serving(
                args, "float32", x, y, SERVE_TOPIC_ROWS,
                broker_loc="inproc://chip-smoke-open-loop")
            try:
                if layer._native_front is None or layer.admission is None:
                    raise AssertionError("open-loop: the layer is not on the default request "
                                         "path (native front and admission ladder)")
                counts = [stn.launch_counts()]
                child.stdin.write(json.dumps({
                    "base": base, "rates": [f * front_rps for f in OPEN_LOOP_FACTORS],
                    "seconds": OPEN_LOOP_SECONDS, "step_seconds": OPEN_LOOP_STEP_SECONDS,
                    "max_steps": OPEN_LOOP_MAX_STEPS,
                    "users": len(x) - SERVE_TOPIC_ROWS, "offset": SERVE_TOPIC_ROWS,
                    "seed": seed, "sample": OPEN_LOOP_SAMPLE}) + "\n")
                child.stdin.flush()
                while True:
                    line = child.stdout.readline().strip()
                    if line == f"end {len(counts) - 1}" and len(counts) > len(OPEN_LOOP_FACTORS):
                        break
                    if line != f"done {len(counts) - 1}":
                        raise AssertionError(f"open-loop: the load process said {line!r} "
                                             f"(exit {child.poll()})")
                    counts.append(stn.launch_counts())
                n_rates = len(counts) - 1
                if child.wait(60) != 0:
                    raise AssertionError(f"open-loop: the load process exited {child.returncode}")
            finally:
                layer.close()
            del model, layer
            rows = []
            for i in range(n_rates):
                with open(f"{out_path}.{i}") as f:
                    rows.append(json.load(f))
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    # the sampled full answers against the exact float32 top-10
    y_exact = stn.upload_streaming(y, dtype=torch.float32, device=device)
    checked, worst = 0, 0.0
    for i, row in enumerate(rows):
        samples = row.pop("samples")
        if samples:
            users = np.array([u for u, _ in samples])
            ref_v, ref_i = exact_top(torch, stn, y_exact, x[users], 10)
            bodies = [json.loads(b) for _, b in samples]
            got_i = np.array([[int(r["id"][1:]) for r in b] for b in bodies])
            got_v = np.array([[r["value"] for r in b] for b in bodies])
            worst = max(worst, check_topk(f"open-loop rate {i} full answers", got_v, got_i,
                                          ref_v, ref_i))
            checked += len(samples)
        row["launches"] = {k: counts[i + 1][k] - counts[i][k]
                           for k in ("topn_scan.tc_f32", "topn_merge")}
    del y_exact
    torch.cuda.empty_cache()
    launches = stn.launch_counts()
    overloaded_at = next((row["offered_rate"] for row in rows if row["overloaded"]), None)
    emit({"phase": "open-loop", "nvidia_smi": smi, "front_rps": front_rps,
          "factors": list(OPEN_LOOP_FACTORS), "seconds_per_rate": OPEN_LOOP_SECONDS,
          "step_seconds": OPEN_LOOP_STEP_SECONDS, "rates": rows,
          # None: no rate overloaded the layer, so the overload checks did not bite
          "overloaded_at_offered_rate": overloaded_at,
          "full_answers_checked": checked, "full_answers_max_abs_err": worst,
          "launches_since_phase_start": {k: launches[k] for k in ("topn_scan.tc_f32",
                                                                  "topn_merge")},
          "setup_s": info, "phase_s": time.perf_counter() - t0})
    calm = rows[0]
    if calm["failed"] or calm["error_kinds"]:
        raise AssertionError(f"open-loop: {calm['failed']} failed requests at "
                             f"{OPEN_LOOP_FACTORS[0]}x: {calm['error_kinds']}")
    for over in rows[1:]:
        kinds, rate = over["error_kinds"], over["offered_rate"]
        if "http-5xx" in kinds or "connection" in kinds:
            raise AssertionError(f"open-loop: 5xx or connection failures at {rate}/s: {kinds}")
        if sum(kinds.values()) != over["failed"] or not set(kinds) <= set(FAILURE_KINDS):
            raise AssertionError(f"open-loop: unclassified failures at {rate}/s: "
                                 f"{over['failed']} failed, kinds {kinds}")
    if checked == 0:
        raise AssertionError("open-loop: no full answer to hold against the exact top-10")
    if device == "cuda" and (launches["topn_scan.tc_f32"] <= 0 or launches["topn_merge"] <= 0):
        raise AssertionError(f"open-loop: the scans were not launched: {launches}")
    return launches


# -- phase 14b: serving-surface, TLS, Basic auth, LSH, /trace and the console ----

SURFACE_SAMPLE_RATE = 0.3  # BASELINE.md:21's LSH setting
SURFACE_REQUESTS = 512
SURFACE_CLIENTS = 8
SURFACE_VALUE_ATOL = 1e-5
SURFACE_USER = ("oryx", "chip-smoke")
SURFACE_PARTITION_EPS = 1e-4  # |h . y| below which float32 and float64 may hash apart
SURFACE_REFERENCE = {
    "qps": 151, "ms": 13,
    "source": "BASELINE.md:21: LSH 0.3, 250 features x 1M items, 32-core Xeon, "
              "1-3 concurrent requests (a reference point, not a target)",
}


def self_signed_pem(directory: str) -> tuple[str, str]:
    """A throwaway self-signed ``localhost`` certificate and its key, made
    by the ``openssl`` command."""
    cert, key = os.path.join(directory, "cert.pem"), os.path.join(directory, "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:prime256v1",
         "-nodes", "-days", "1",
         "-subj", "/CN=localhost", "-addext", "subjectAltName=DNS:localhost",
         "-keyout", key, "-out", cert],
        check=True, capture_output=True, timeout=120,
    )
    return cert, key


def https_call(conn, path: str, headers=None):
    """One GET on a kept-alive HTTPS connection: (status, body, headers,
    seconds)."""
    t0 = time.perf_counter()
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    body = resp.read()
    return resp.status, body, dict(resp.getheaders()), time.perf_counter() - t0


def lsh_partitions_hold(lsh, y_host: np.ndarray, parts: np.ndarray) -> int:
    """The model's partition of every item row against the float64 sign
    pattern of its hash dots; a row may differ only where some dot lies
    within SURFACE_PARTITION_EPS of its hyperplane. Returns those rows."""
    hv = lsh.hash_vectors.astype(np.float64)
    bits = np.arange(lsh.num_hashes)
    near = 0
    for lo in range(0, len(y_host), 1 << 17):
        dots = y_host[lo:lo + (1 << 17)].astype(np.float64) @ hv.T
        differ = ((dots > 0) << bits).sum(axis=1) != parts[lo:lo + (1 << 17)]
        if differ.any():
            if np.abs(dots[differ]).min(axis=1).max() > SURFACE_PARTITION_EPS:
                raise AssertionError("serving-surface: an item's LSH partition is not its "
                                     "hash vectors' sign pattern")
            near += int(differ.sum())
    return near


def phase_serving_surface(torch, args, x: np.ndarray, y: np.ndarray, seed: int, smi: str,
                          stn, device: str = "cuda") -> dict:
    """The serving layer's remaining settings on one port ServingLayer:
    TLS from a self-signed PEM pair, HTTP Basic auth, a profile dir and
    ALS at ``oryx.als.sample-rate = 0.3`` over phase 3's factors. (a) the
    TLS and auth gate; (b) 512 /recommend over HTTPS at 8 clients, each
    answer the exact float32 top-10 of its LSH candidate rows; (c) GET
    /trace for one traced request; (d) the console. Returns the path's
    kernel launches."""
    import base64
    import http.client
    import ssl

    from oryx_tpu_torch.app.als import endpoints
    from oryx_tpu_torch.common import tracing
    from oryx_tpu_torch.common.metrics import registry
    from oryx_tpu_torch.serving.layer import ServingLayer

    steps_s, t_step = {}, [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        steps_s[name], t_step[0] = now - t_step[0], now

    root = tempfile.mkdtemp(prefix="chip-smoke-surface-")
    cert, key = self_signed_pem(root)
    user, password = SURFACE_USER
    loc = "inproc://chip-smoke-surface"
    extra = "\n".join([
        f"als.sample-rate = {SURFACE_SAMPLE_RATE}",
        "serving.api.secure-port = 0",
        f'serving.api.keystore-file = "{cert}"',
        f'serving.api.key-file = "{key}"',
        f'serving.api.user-name = "{user}"',
        f'serving.api.password = "{password}"',
        f'serving.compute.profile-dir = "{root}/profile"',
    ])
    n_items, n_topic = len(y), SERVE_TOPIC_ROWS
    y32 = y.astype(np.float32)  # what the store holds (``factors()`` gives float64)
    gen = np.random.default_rng(seed + 1401)
    users = sorted(gen.choice(np.arange(n_topic, len(x)), size=SURFACE_REQUESTS,
                              replace=False).tolist())
    auth = {"Authorization": "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()}
    tls = ssl.create_default_context(cafile=cert)

    def connect():
        return http.client.HTTPSConnection("localhost", layer.port, context=tls, timeout=120)

    forwarded0 = registry.counter("serving.http.forwarded").value
    step("pem")
    stn.reset_launch_counts()  # this path starts here
    layer = ServingLayer(serving_config(loc, "float32", extra))
    layer.start()
    out = {"phase": "serving-surface", "items": n_items, "features": y.shape[1],
           "sample_rate": SURFACE_SAMPLE_RATE, "cpu_count": os.cpu_count(),
           "steps_s": steps_s}
    try:
        publish_model(loc, y.shape[1], x, y)
        conn = connect()
        deadline = time.monotonic() + 120
        while https_call(conn, "/ready", auth)[0] != 200:
            if time.monotonic() > deadline:
                raise AssertionError("serving-surface: /ready never turned 200")
            time.sleep(0.05)
        model = layer.model_manager.get_model()
        model.set_item_vectors([f"i{j}" for j in range(n_topic, n_items)], y32[n_topic:])
        model.set_user_vectors([f"u{u}" for u in users], x[users])
        step("load")

        # (a) TLS and Basic auth; the native front declined both
        try:
            urllib.request.urlopen(f"http://localhost:{layer.port}/ready", timeout=10)
            plain = "answered"
        except Exception as e:  # the handshake fails: any error will do
            plain = type(e).__name__
        if plain == "answered":
            raise AssertionError("serving-surface: plain HTTP answered on the TLS port")
        gate = {
            "none": https_call(conn, "/ready"),
            "wrong": https_call(conn, "/ready", {"Authorization": "Basic " + base64.b64encode(
                f"{user}:wrong".encode()).decode()}),
            "right": https_call(conn, "/ready", auth),
        }
        for case in ("none", "wrong"):
            status, _, headers, _ = gate[case]
            if status != 401 or headers.get("WWW-Authenticate") != 'Basic realm="Oryx"':
                raise AssertionError(f"serving-surface: {case} credentials got {status} {headers}")
        if gate["right"][0] != 200:
            raise AssertionError(f"serving-surface: the right credentials got {gate['right'][0]}")
        if layer._native_front is not None:
            raise AssertionError("serving-surface: the native front served TLS and auth")
        out["gate"] = {"plain_http": plain, **{k: v[0] for k, v in gate.items()}}

        # the first request builds the card copy of Y, the host copy and
        # the LSH partitions
        status, _, _, first_s = https_call(conn, f"/recommend/u{users[0]}", auth)
        if status != 200:
            raise AssertionError(f"serving-surface: the first /recommend answered {status}")
        ids, _, _, y_host, parts = model._ensure_y_matrix()
        lsh = model.lsh
        out.update(first_request_s=first_s, num_hashes=lsh.num_hashes,
                   max_bits_differing=lsh.max_bits_differing,
                   partitions=lsh.num_partitions)
        conn.close()
        step("first_request")

        # (b) 512 /recommend over HTTPS, 8 clients on kept-alive connections
        paths = [f"/recommend/u{u}" for u in users]
        results = [None] * len(paths)

        def client(w: int) -> None:
            c = connect()
            try:
                for j in range(w, len(paths), SURFACE_CLIENTS):
                    results[j] = https_call(c, paths[j], auth)
            finally:
                c.close()

        t0 = time.perf_counter()
        with ThreadPoolExecutor(SURFACE_CLIENTS) as pool:
            list(pool.map(client, range(SURFACE_CLIENTS)))
        load_s = time.perf_counter() - t0
        statuses = sorted({r[0] for r in results})
        if statuses != [200]:
            raise AssertionError(f"serving-surface: /recommend statuses {statuses}")
        lat = sorted(r[3] * 1e3 for r in results)
        step("requests")

        # (c) GET /trace holds a traced request's serving.request span (on
        # a new connection: the server drops one idle past its 30 s timeout)
        conn = connect()
        ctx = tracing.TraceContext(os.urandom(16).hex(), os.urandom(8).hex(), True)
        status = https_call(conn, f"/recommend/u{users[1]}",
                            {**auth, "traceparent": ctx.traceparent()})[0]
        status_t, body, _, _ = https_call(conn, f"/trace?trace={ctx.trace_id}", auth)
        spans = [e for e in json.loads(body)["traceEvents"]
                 if e["name"] == "serving.request" and e["args"]["trace"] == ctx.trace_id]
        if status != 200 or status_t != 200 or len(spans) != 1:
            raise AssertionError(f"serving-surface: /trace answered {status_t} with {spans}")
        # (d) the console
        status, body, headers, _ = https_call(conn, "/", auth)
        if (status, headers.get("Content-Type")) != (200, "text/html") or \
                body != endpoints._CONSOLE_HTML.encode("utf-8"):
            raise AssertionError(f"serving-surface: GET / answered {status} "
                                 f"{headers.get('Content-Type')}")
        conn.close()
        out.update(trace_span_ms=spans[0]["dur"] / 1e3, console_bytes=len(body))
        step("trace_console")

        # each answer against numpy: the query's candidate partitions from
        # the model's own LSH, then the exact float32 top-10 of those rows
        order = np.fromiter((int(i[1:]) for i in ids), np.int64, len(ids))
        if not np.array_equal(y_host, y32[order]):
            raise AssertionError("serving-surface: the model's host copy of Y is not the factors")
        near = lsh_partitions_hold(lsh, y_host, parts)
        # each partition's rows, ascending; queries that share a candidate
        # set share its rows: one gather each
        by_part = np.argsort(parts, kind="stable")
        bounds = np.searchsorted(parts[by_part], np.arange(lsh.num_partitions + 1))
        groups = {}
        for j, u in enumerate(users):
            q = x[u].astype(np.float32)
            groups.setdefault(lsh.candidate_indices(q).tobytes(), []).append((j, u, q))
        fractions, err, served = [], 0.0, [None] * len(users)
        for cand, members in groups.items():
            rows = np.sort(np.concatenate(
                [by_part[bounds[c]:bounds[c + 1]] for c in np.frombuffer(cand, np.int64)]))
            sub = y_host[rows]
            for j, u, q in members:
                fractions.append(len(rows) / n_items)
                scores = sub @ q
                top = np.argpartition(-scores, 9)[:10]
                top = top[np.lexsort((top, -scores[top]))]  # by score, ties to the lower row
                body = json.loads(results[j][1])
                got = [r["id"] for r in body]
                if got != [ids[r] for r in rows[top]]:
                    raise AssertionError(f"serving-surface: /recommend/u{u} answered {got}, "
                                         f"the candidates' exact top-10 is "
                                         f"{[ids[r] for r in rows[top]]}")
                err = max(err, float(np.max(np.abs(np.array([r["value"] for r in body])
                                                   - scores[top]))))
                served[j] = [int(i[1:]) for i in got]
        if err > SURFACE_VALUE_ATOL:
            raise AssertionError(f"serving-surface: values differ by {err}")
        step("recompute")
        # recall@10 against the exact float32 scan of every item, on the card
        y_dev = torch.from_numpy(y32).to(device)
        q_dev = torch.from_numpy(x[users]).to(device=device, dtype=torch.float32)
        exact = torch.topk(q_dev @ y_dev.T, 10, dim=1).indices.cpu().numpy()
        del y_dev, q_dev
        torch.cuda.empty_cache()
        recall = sum(len(set(g) & set(e)) for g, e in zip(served, exact.tolist()))
        recall /= 10.0 * len(users)
        out.update(
            requests=len(results), clients=SURFACE_CLIENTS, p50_ms=lat[len(lat) // 2],
            p99_ms=lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            answers_per_s=len(results) / load_s, candidate_fraction=float(np.mean(fractions)),
            recall_at_10=recall, max_abs_err=err, partition_rows_near_a_hyperplane=near,
            reference=SURFACE_REFERENCE, nvidia_smi=smi,
        )
        step("recall")

        forwarded = registry.counter("serving.http.forwarded").value - forwarded0
        if forwarded:
            raise AssertionError(f"serving-surface: {forwarded} requests reached the native front")
        out["forwarded"] = forwarded
    finally:
        layer.close()
        shutil.rmtree(root, ignore_errors=True)
    launches = stn.launch_counts()  # this path ends here
    step("checks")
    out["launches"] = launches
    out["seconds"] = sum(steps_s.values())
    emit(out)
    return launches


# -- phase 15: native-host, the C++ store, parser, formatters and tier -------------

NATIVE_FORMAT_ROWS = 25_000  # 100,000 before a cut (the cuts line)
# the Python formatter's rows, a prefix of the native one's (once all of
# them; cut to keep the run inside its limit, printed as a cut)
NATIVE_PY_FORMAT_ROWS = 10_000
NATIVE_FORMAT_FEATURES = (50, 250)
NATIVE_READBACK_PROCS = 8  # processes that json.loads the messages back, one per core
NATIVE_STORE_ROWS = 250_000  # 1,000,000, then 500,000, before cuts (the cuts line)
NATIVE_STORE_FEATURES = 50
NATIVE_STORE_BATCH = 4_096
NATIVE_VTV_RTOL = 1e-9  # the two stores sum the float64 Gramian in different orders
TIER_ITEMS = 1_000_000  # ivf-serving's catalog, when the phase makes its own
TIER_CENTERS = 1000
TIER_HOT_CELLS = 32
TIER_RAM_MB = 64
TIER_QUERIES = 512
TIER_PROBE_FRACTIONS = (0.01, 0.3)
# the queries of the 0.3 scans, a prefix of the 0.01 scans' (once all
# TIER_QUERIES; cut to keep the run inside its limit, printed as a cut)
TIER_WIDE_QUERIES = 64
# each scan's queries split over this many concurrent top_k_device calls,
# the same split for both planes: at 0.3 a host group of 8 queries
# gathers most of the plane, so one call of 512 queries runs 64 gathers
TIER_SCAN_THREADS = 4
TIER_BATCHER_QUERIES = 64


@contextlib.contextmanager
def native_declined(*modules):
    """Each module's ``get_library`` answers None inside: its callers take
    the Python paths, as on a host where g++ fails."""
    saved = [mod.get_library for mod in modules]
    for mod in modules:
        mod.get_library = lambda: None
    try:
        yield
    finally:
        for mod, fn in zip(modules, saved):
            mod.get_library = fn


def native_parser_part(seed: int, scale: float) -> dict:
    """(a) a MovieLens-1M-shaped block through the native columnar parser
    at the speed layer's thread count and through the Python parser."""
    from oryx_tpu_torch.app.als import data as als_data
    from oryx_tpu_torch.app.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.common import config
    from oryx_tpu_torch.native import parse as native_parse

    num_users, num_items, nnz = ML1M
    nnz = max(20_000, int(nnz * scale))
    u, i, v = movielens_shape(num_users, num_items, nnz, seed + 600)
    block = np.asarray([f"u{a},i{b},{c:.0f},{t}".encode() for t, (a, b, c) in
                        enumerate(zip(u.tolist(), i.tolist(), v.tolist()), start=1)], dtype="S")
    threads = ALSSpeedModelManager(config.get_default()).parse_threads
    t0 = time.perf_counter()
    cols = native_parse.parse_text_columns(block, threads=threads)
    if cols is None:
        raise AssertionError("native-host: the native parser declined a canonical block")
    rm_n = als_data.rating_matrix_from_int_columns(
        cols.users, cols.items, cols.values, cols.timestamps, True, cols.user_prefix,
        cols.item_prefix)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcols = als_data.parse_interaction_block(block)
    rm_p = als_data.rating_matrix_from_columns(pcols, True)
    python_s = time.perf_counter() - t0
    # the columns: ids byte for byte, values bit for bit, timestamps
    for ints, prefix, want in ((cols.users, cols.user_prefix, pcols.users),
                               (cols.items, cols.item_prefix, pcols.items)):
        got = np.char.add(prefix, np.char.mod("%d", ints).astype("S"))
        if not np.array_equal(got, want.astype("S")):
            raise AssertionError("native-host: the native parser's ids differ from Python's")
    if not np.array_equal(cols.values.view(np.uint32), pcols.values.view(np.uint32)):
        raise AssertionError("native-host: the native parser's values differ from Python's")
    if cols.timestamps is None or not np.array_equal(cols.timestamps, pcols.timestamps):
        raise AssertionError("native-host: the native parser's timestamps differ from Python's")
    # the RatingMatrix: the same ids and (user, item, value) entries; the
    # int path orders ids by code, the Python one by text
    if sorted(rm_n.user_ids) != sorted(rm_p.user_ids) or sorted(rm_n.item_ids) != sorted(rm_p.item_ids):
        raise AssertionError("native-host: the two RatingMatrix id sets differ")
    keys = []
    for rm in (rm_n, rm_p):
        pu = np.array([int(x[1:]) for x in rm.user_ids], np.int64)[rm.user_idx]
        pi = np.array([int(x[1:]) for x in rm.item_ids], np.int64)[rm.item_idx]
        key = pu * (num_items + 1) + pi
        order = np.argsort(key, kind="stable")
        keys.append((key[order], rm.values[order]))
    if not (np.array_equal(keys[0][0], keys[1][0])
            and np.array_equal(keys[0][1].view(np.uint32), keys[1][1].view(np.uint32))):
        raise AssertionError("native-host: the two RatingMatrix entries differ")
    return {"lines": nnz, "threads": threads, "entries": len(rm_n.values),
            "native_s": native_s, "python_s": python_s}


def read_back_messages(lines, want, ids, known) -> str | None:
    """Each update message through json.loads: None when every one holds
    its row (as float32), id and known list, else what differs."""
    parsed = [json.loads(m) for m in lines]
    if not np.array_equal(np.asarray([p[2] for p in parsed], np.float32), want):
        return "do not read back the rows"
    if any(p[:2] != ["X", i] or p[3] != k for p, i, k in zip(parsed, ids, known)):
        return "lost an id or a known list"
    return None


def native_formatter_part(seed: int, scale: float) -> dict:
    """(b) update messages with known-id lists and vector JSON, native
    and Python, read back with json.loads against the source rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from oryx_tpu_torch.app.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.native import store as nstore

    gen = np.random.default_rng(seed + 1001)
    n = max(1_000, int(NATIVE_FORMAT_ROWS * scale))
    n_py = min(n, max(1_000, int(NATIVE_PY_FORMAT_ROWS * scale)))
    out = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(NATIVE_READBACK_PROCS, mp_context=ctx) as pool:
        for k in NATIVE_FORMAT_FEATURES:
            mat = gen.standard_normal((n, k)).astype(np.float32)
            mat[::997, 0], mat[1::997, 1], mat[2::997, 2] = np.nan, np.inf, -np.inf
            want = np.nan_to_num(mat, nan=0.0, posinf=0.0, neginf=0.0)
            ids = [f"u{j}" for j in range(n)]
            known = [[f"i{(7 * j + m) % 3706}" for m in range(j % 5)] for j in range(n)]
            t0 = time.perf_counter()
            msgs = nstore.format_update_messages_multi(mat, ids, known, "X")
            multi_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            vecs = nstore.format_vectors_json(mat)
            vec_s = time.perf_counter() - t0
            if msgs is None:
                raise AssertionError("native-host: the native formatter declined")
            with native_declined(nstore):
                t0 = time.perf_counter()
                py_vecs = nstore.format_vectors_json(mat[:n_py])
                py_vec_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                # the speed layer's Python path: json.dumps vectors (timed
                # above, counted in both) spliced into messages
                py_msgs = [ALSSpeedModelManager._assemble(None, "X", ids[j], vec, known[j])
                           for j, vec in enumerate(py_vecs)]
                py_multi_s = py_vec_s + time.perf_counter() - t0
            # the native vector JSON read back by numpy's parser in one pass
            # (the Python vectors are read back inside the Python messages)
            if len(vecs) != n or not np.array_equal(
                    np.fromstring(",".join(v[1:-1] for v in vecs), np.float32, sep=","),
                    want.reshape(-1)):
                raise AssertionError(f"native-host: native vectors at k = {k} do not read back the rows")
            for what, lines, rows in (("native messages", msgs, n),
                                      ("Python messages", py_msgs, n_py)):
                if len(lines) != rows:
                    raise AssertionError(f"native-host: {len(lines)} {what} for {rows} rows")
                parts = np.array_split(np.arange(rows), NATIVE_READBACK_PROCS)
                faults = pool.map(read_back_messages,
                                  *zip(*[(lines[r[0] : r[-1] + 1], want[r[0] : r[-1] + 1],
                                          ids[r[0] : r[-1] + 1], known[r[0] : r[-1] + 1])
                                         for r in parts]))
                for fault in faults:
                    if fault is not None:
                        raise AssertionError(f"native-host: {what} at k = {k} {fault}")
            out[f"k{k}"] = {"rows": n, "python_rows": n_py, "native_multi_s": multi_s,
                            "native_vectors_s": vec_s, "python_multi_s": py_multi_s,
                            "python_vectors_s": py_vec_s,
                            "bytes": sum(map(len, msgs))}
    return out


def native_store_part(seed: int, scale: float) -> dict:
    """(c) the native and the Python store filled with the same vectors:
    get_batch, to_matrix, get_vtv and retain_recent_and_ids agree."""
    from oryx_tpu_torch.app.als.common import FeatureVectors
    from oryx_tpu_torch.native.store import NativeFeatureVectors, make_feature_vectors

    gen = np.random.default_rng(seed + 1002)
    n = max(10_000, int(NATIVE_STORE_ROWS * scale))
    ids = [f"u{j}" for j in range(n)]
    vecs = gen.standard_normal((n, NATIVE_STORE_FEATURES)).astype(np.float32)
    want_ids = gen.choice(n + n // 10, NATIVE_STORE_BATCH, replace=False)  # some miss
    batch = [f"u{j}" for j in want_ids.tolist()]
    keep = set(ids[: n // 2])
    fresh = [f"n{j}" for j in range(1_000)]
    stores = {"native": make_feature_vectors(), "python": FeatureVectors()}
    if not isinstance(stores["native"], NativeFeatureVectors):
        raise AssertionError("native-host: make_feature_vectors did not give the native store")
    times, res = {}, {}
    for name, st in stores.items():
        t, r = {}, {}
        t0 = time.perf_counter()
        st.set_batch(ids, vecs)
        t["set_batch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r["batch"] = st.get_batch(batch)
        t["get_batch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_ids, mat = st.to_matrix()
        t["to_matrix_s"] = time.perf_counter() - t0
        order = np.argsort(np.array([int(x[1:]) for x in got_ids], np.int64), kind="stable")
        r["matrix"] = mat[order]
        t0 = time.perf_counter()
        r["vtv"] = st.get_vtv()
        t["get_vtv_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        st.retain_recent_and_ids(keep)  # all recent: every id survives, recency resets
        st.set_batch(fresh, vecs[: len(fresh)])
        st.retain_recent_and_ids(keep)  # now: the kept ids and the fresh ones
        t["retain_s"] = time.perf_counter() - t0
        r["survivors"] = sorted(st.ids())
        times[name], res[name] = t, r
    a, b = res["native"], res["python"]
    if not (np.array_equal(a["batch"][0], b["batch"][0])
            and np.array_equal(a["batch"][1], b["batch"][1])
            and int(a["batch"][1].sum()) == int((want_ids < n).sum())):
        raise AssertionError("native-host: get_batch differs between the stores")
    if not np.array_equal(a["matrix"], b["matrix"]) or not np.array_equal(a["matrix"], vecs):
        raise AssertionError("native-host: to_matrix differs between the stores")
    vtv_err = float(np.max(np.abs(a["vtv"] - b["vtv"])) / np.max(np.abs(b["vtv"])))
    if vtv_err > NATIVE_VTV_RTOL:
        raise AssertionError(f"native-host: VtV differs by {vtv_err:.3g} relative")
    if a["survivors"] != b["survivors"] or a["survivors"] != sorted(keep | set(fresh)):
        raise AssertionError("native-host: retain_recent_and_ids differs between the stores")
    return {"rows": n, "features": NATIVE_STORE_FEATURES, "batch": NATIVE_STORE_BATCH,
            "vtv_max_rel_err": vtv_err, **{name: t for name, t in times.items()}}


def native_tier_part(torch, args, seed: int, scale: float, device: str,
                     catalog=None) -> dict:
    """(d) one IVF index at ivf-serving's shape with the host stage-1
    plane, scanned through the flat plane and through the tiered cell
    store (hot 32 cells, 64 MiB of RAM, the rest on disk), then behind the
    batcher, which hints each group's cells. ``catalog`` is ivf-serving's
    (items, queries, centroids): the layout is built on its centroids;
    without it the part makes and clusters its own."""
    import tempfile

    from oryx_tpu_torch.native import store as nstore
    from oryx_tpu_torch.ops import ivf
    from oryx_tpu_torch.serving.batcher import TopNBatcher

    if catalog is None:
        items = max(50_000, int(TIER_ITEMS * scale))
        n_centers = min(TIER_CENTERS, items // 1000)
        y, q, _ = clustered_catalog(torch, items, args.features, n_centers, seed + 1101,
                                    TIER_QUERIES, device=device)
        cents = None
    else:
        y, q, cents = catalog
        items = len(y)
    q = q[:TIER_QUERIES]
    saved = (ivf.HOST_STAGE1, ivf.NPROBE, ivf.PROBE_FRACTION)
    saved_tier = nstore.tier_config()
    tier_dir = tempfile.mkdtemp(prefix="chip-smoke-tier-")
    tiered = None

    def scan(index, nprobe, qs):
        """The queries qs over TIER_SCAN_THREADS concurrent calls."""
        parts = np.array_split(np.arange(len(qs)), TIER_SCAN_THREADS)
        with ThreadPoolExecutor(len(parts)) as pool:
            res = list(pool.map(
                lambda r: ivf.top_k_device(index, qs[r], 10, nprobe=nprobe), parts))
        return (np.concatenate([v.cpu().numpy() for v, _ in res]),
                np.concatenate([i.cpu().numpy() for _, i in res]), len(parts))

    try:
        ivf.configure_ann(host_stage1=True)
        t0 = time.perf_counter()
        flat = ivf.build_ivf(y, centroids=cents, device=device)
        build_s = time.perf_counter() - t0
        del y
        nstore.configure_tier(enabled=True, hot_cells=TIER_HOT_CELLS,
                              ram_bytes=TIER_RAM_MB << 20, spill_dir=tier_dir)
        t0 = time.perf_counter()
        tiered = ivf.attach_tiered_plane(flat)  # the same layout, its plane in the store
        spill_s = time.perf_counter() - t0
        if tiered.tier is None or not isinstance(tiered.tier._store, nstore.NativeTieredCellStore):
            raise AssertionError("native-host: the plane did not move into the native cell store")
        out = {"items": items, "cells": flat.n_cells, "features": args.features,
               "catalog": "ivf-serving's, on its centroids" if cents is not None else "its own",
               "hot_cells": TIER_HOT_CELLS, "ram_mb": TIER_RAM_MB, "queries": len(q),
               "scan_threads": TIER_SCAN_THREADS, "build_s": build_s, "spill_s": spill_s}
        for pf in TIER_PROBE_FRACTIONS:
            nprobe = max(1, int(round(pf * flat.n_cells)))
            qs = q if pf == TIER_PROBE_FRACTIONS[0] else q[:TIER_WIDE_QUERIES]
            out[f"queries_p{pf}"] = len(qs)
            got = {}
            for name, index in (("flat", flat), ("tiered", tiered)):
                before = ivf.counts()["host"]
                t0 = time.perf_counter()
                v, i, calls = scan(index, nprobe, qs)
                out[f"{name}_ms_p{pf}"] = 1e3 * (time.perf_counter() - t0)
                if ivf.counts()["host"] != before + calls:
                    raise AssertionError(f"native-host: the {name} scan missed the host path")
                got[name] = (v, i)
            (fv, fi), (tv, ti) = got["flat"], got["tiered"]
            if len(fi) != len(qs):
                raise AssertionError(f"native-host: {len(fi)} answers for {len(qs)} queries")
            if not np.array_equal(fi, ti) or not np.array_equal(fv.view(np.uint32), tv.view(np.uint32)):
                raise AssertionError(f"native-host: the tiered scan differs from the flat one at {pf}")
            out[f"nprobe_p{pf}"] = nprobe
        res = tiered.tier._store.residency()
        st = tiered.tier.stats()
        out["residency"] = {"disk": int((res == nstore.TIER_DISK).sum()),
                            "ram": int((res == nstore.TIER_RAM).sum()), "hot": st["hot_cells"]}
        out["store"] = {k: st[k] for k in ("hits", "misses", "promotions", "demotions")}
        if not (out["residency"]["disk"] > 0 and out["residency"]["ram"] > 0
                and out["residency"]["hot"] > 0):
            raise AssertionError(f"native-host: residency {out['residency']}")
        # the batcher: each group's hint before its submit, counted
        hints = []
        real = ivf.IVFIndex.prefetch_for_queries

        def counted(index, *a, **kw):
            hints.append(real(index, *a, **kw))
            return hints[-1]

        ivf.IVFIndex.prefetch_for_queries = counted
        ivf.configure_ann(nprobe=0, probe_fraction=TIER_PROBE_FRACTIONS[0])
        hit0 = metrics_counter("serving.store.prefetch.hit")
        miss0 = metrics_counter("serving.store.prefetch.miss")
        batcher = TopNBatcher()
        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(16) as pool:
                res_b = list(pool.map(lambda r: batcher.score(tiered, q[r], 10),
                                      range(TIER_BATCHER_QUERIES)))
            out["batcher_s"] = time.perf_counter() - t0
        finally:
            batcher.close()
            ivf.IVFIndex.prefetch_for_queries = real
        # a host group scans the union of its queries' cells, so answers
        # depend on how the batcher grouped them: each is checked whole
        for ids, vals in res_b:
            ids, vals = np.asarray(ids)[:10], np.asarray(vals)[:10]
            if len(ids) != 10 or (ids < 0).any() or (np.diff(vals) > 0).any():
                raise AssertionError(f"native-host: a batcher answer {ids} {vals}")
        out["batcher_hints"], out["cells_hinted"] = len(hints), sum(hints)
        out["prefetch_hit"] = metrics_counter("serving.store.prefetch.hit") - hit0
        out["prefetch_miss"] = metrics_counter("serving.store.prefetch.miss") - miss0
        if not hints or min(hints) <= 0:
            raise AssertionError(f"native-host: the batcher's prefetch hints {hints}")
        return out
    finally:
        if tiered is not None and tiered.tier is not None:
            tiered.tier.close()
        ivf.HOST_STAGE1, ivf.NPROBE, ivf.PROBE_FRACTION = saved
        nstore.configure_tier(**saved_tier)
        import shutil

        shutil.rmtree(tier_dir, ignore_errors=True)


def phase_native_host(torch, args, smi: str, seed: int, scale: float = 1.0,
                      device: str = "cuda", catalog=None) -> dict:
    """The native host code the JAX package moved out of the interpreter,
    on the card's host: (a) the columnar parser, (b) the update
    formatters, (c) the sharded store, (d) the tiered IVF cell store on
    ``catalog`` (ivf-serving's items, queries and centroids); each
    against its Python path on the same inputs, with the seconds of
    both."""
    from oryx_tpu_torch import native

    if native.get_library() is None:
        raise AssertionError("native-host: the native library did not build")
    out = {"phase": "native-host", "nvidia_smi": smi}
    t0 = time.perf_counter()
    for name, part in (("parser", lambda: native_parser_part(seed, scale)),
                       ("formatters", lambda: native_formatter_part(seed, scale)),
                       ("store", lambda: native_store_part(seed, scale)),
                       ("tier", lambda: native_tier_part(torch, args, seed, scale, device,
                                                         catalog))):
        t = time.perf_counter()
        out[name] = part()
        out[name]["part_s"] = time.perf_counter() - t
    out["s"] = time.perf_counter() - t0
    emit(out)
    return out


def metrics_gauge(name: str):
    from oryx_tpu_torch.common.metrics import registry

    return registry.gauge(name).value


def metrics_counter(name: str) -> int:
    from oryx_tpu_torch.common.metrics import registry

    return registry.counter(name).value


# -- phases 16 and 16b: the mesh (parallel/ on four shards of the one card) --------

MESH_SHARDS = 4  # the mesh's shards, all on cuda:0: the host has one card
MESH_BATCHES = (8, 64, 256, CANDIDATES_BATCH)
MESH_TIMED = (256, CANDIDATES_BATCH)  # batches whose sharded and one-card calls are timed
MESH_KMEANS = (200_000, 20, 10)  # phase 5's first shape
MESH_KMEANS_ITERATIONS = 10
MESH_ALS_ITERATIONS = 1  # ALS_SCALE_ITERATIONS before a cut (the cuts line)
MESH_RMSE_ATOL = 1e-4
MESH_PROCS = 4
MESH_PROCS_ALS_ITERATIONS = 3
MESH_PROCS_TIMEOUT_S = 600


def exact_top_plain(torch, stn, y_dev, q_np: np.ndarray, k: int, cosine: bool):
    """exact_top() for dot or cosine: the plain float32 scan of the whole
    plane on the card, ties to the lowest id; (values, ids) as numpy."""
    q = torch.from_numpy(np.ascontiguousarray(q_np)).to(y_dev.device)
    v, i = stn.topn_merge_plain(
        *stn.topn_scan_plain(q, y_dev.mat_t, y_dev.norms, y_dev.n_items, k, cosine, False), k
    )
    return v.cpu().numpy(), i.cpu().numpy()


def recall_at(got_i: np.ndarray, ref_i: np.ndarray) -> float:
    return sum(len(set(g) & set(r)) for g, r in zip(got_i.tolist(), ref_i.tolist())) / ref_i.size


def launch_delta(stn, pk, before: tuple) -> dict:
    """Launches of each kernel since ``before`` (stn's and pk's counts)."""
    now = {**stn.launch_counts(), **pk.launch_counts()}
    was = {**before[0], **before[1]}
    return {name: now[name] - was.get(name, 0) for name in now if now[name] != was.get(name, 0)}


def check_kmeans_parity(what: str, got, want, pts: np.ndarray) -> dict:
    """Mesh k-means against one card's after one Lloyd iteration from the
    same initial centers, with phase 5's tolerances: counts equal but for
    near ties (points whose two nearest of the reference centers lie
    within 1e-5 relative), centers within rtol 1e-5 of |center| plus 1e-5
    of the largest and the near-tie points' share (each moves its center by
    at most (|p| + |c|) / count), cost within rtol 1e-5."""
    (gc, gn, gcost), (wc, wn, wcost) = got, want
    wc64 = np.asarray(wc, np.float64)
    d2 = (np.sum(pts.astype(np.float64) ** 2, 1)[:, None] - 2.0 * pts @ wc64.T
          + np.sum(wc64 ** 2, 1)[None, :])
    two = np.sort(d2, axis=1)[:, :2]
    n_near = int(np.sum(two[:, 1] - two[:, 0] <= 1e-5 * np.abs(two[:, 1])))
    count_diff = np.abs(np.asarray(gn, np.float64) - np.asarray(wn, np.float64))
    err = np.abs(np.asarray(gc, np.float64) - wc64)
    share = n_near * (float(np.abs(pts).max()) + float(np.abs(wc64).max())) / max(
        1.0, float(np.min(wn)))
    tol = RTOL * np.abs(wc64) + RTOL * float(np.abs(wc64).max()) + share
    cost_rel = abs(float(gcost) - float(wcost)) / abs(float(wcost))
    out = {"near_ties": n_near, "count_abs_diff": float(count_diff.sum()),
           "centers_max_abs_err": float(err.max()), "near_share": share, "cost_rel_err": cost_rel}
    if float(count_diff.max()) > n_near or float(count_diff.sum()) > 2 * n_near:
        raise AssertionError(f"{what}: counts differ by {count_diff.sum()} with {n_near} near ties")
    if (err > tol).any():
        raise AssertionError(f"{what}: centers differ by {err.max()} (near-tie share {share})")
    if cost_rel > RTOL:
        raise AssertionError(f"{what}: cost differs by {cost_rel} relative")
    return out


def kmeans_runs(km, pts: np.ndarray, init: np.ndarray, mesh, reference) -> dict:
    """train_kmeans over ``mesh`` and over ``reference`` (None: one card, or
    another mesh) from ``init``: one iteration held by
    check_kmeans_parity(), MESH_KMEANS_ITERATIONS held to
    tests/app/kmeans/test_kmeans.py:58's bar (cost within rtol 1e-4; a
    flipped near tie moves a center, and Lloyd's later sweeps carry it);
    returns the comparison and the iterate seconds of both long runs."""
    k = init.shape[0]
    one = [km.train_kmeans(pts, k, iterations=1, initial_centers=init, mesh=m)
           for m in (mesh, reference)]
    out = {"one_iteration": check_kmeans_parity("mesh k-means, one iteration", *one, pts)}
    runs, secs = [], []
    for m in (reference, mesh):  # the mesh run last: its sweeps are the ones counted
        runs.append(km.train_kmeans(pts, k, iterations=MESH_KMEANS_ITERATIONS,
                                    initial_centers=init, mesh=m))
        secs.append(dict(km.last_phase_seconds))
    (_, rn, rcost), (_, mn, mcost) = runs
    rel = abs(mcost - rcost) / abs(rcost)
    out.update(iterations=MESH_KMEANS_ITERATIONS, cost_rel_err=rel, reference_s=secs[0],
               mesh_s=secs[1], count_abs_diff=float(np.abs(mn - rn).sum()))
    if rel > 1e-4 or float(mn.sum()) != len(pts):
        raise AssertionError(f"mesh k-means over {MESH_KMEANS_ITERATIONS} iterations: cost "
                             f"{mcost} against {rcost}, counts summing to {mn.sum()}")
    return out


def mesh_scans(torch, stn, pk, topn, mesh, x: np.ndarray, y: np.ndarray, smi: str,
               device: str = "cuda") -> dict:
    """(a) top_k_sharded on phase 3's factors over the 4-shard mesh, float32
    and int8, dot and cosine, at MESH_BATCHES: float32 ids the one-card
    kernel scan's (values within RTOL, ids but for near ties), int8
    recall@10 against the exact float32 scan at least 0.99; each call
    launched one scan of the right kernel per shard and shards + 1
    merges. Returns the timed records by launch key."""
    y_exact = stn.upload_streaming(y, dtype=torch.float32, device=device)
    rec = {}
    for dtype in ("float32", "int8"):
        t0 = time.perf_counter()
        up_s = topn.upload_sharded(y, mesh, dtype=dtype)
        upload_s = time.perf_counter() - t0
        up_1 = y_exact if dtype == "float32" else stn.upload_streaming(y, dtype=torch.int8,
                                                                       device=device)
        for cosine in (False, True):
            for b in MESH_BATCHES:
                q = x[1024 : 1024 + b]
                before = (stn.launch_counts(), pk.launch_counts())
                si, sv = topn.top_k_sharded(up_s, q, 10, cosine=cosine)
                grew = launch_delta(stn, pk, before)
                path = "tc_f32" if dtype == "float32" else "tc"
                scan = f"topn_scan.{path}" if b <= stn.LOCAL_TOPK_BATCH else f"topn_candidates.{path}"
                if device != "cpu" and grew != {scan: MESH_SHARDS, "topn_merge": MESH_SHARDS + 1}:
                    raise AssertionError(f"sharded {dtype} b={b}: launched {grew}")
                case = f"top_k_sharded {dtype} {'cosine' if cosine else 'dot'} b={b}"
                row = {"phase": "mesh", "case": case, "launched": grew}
                if dtype == "float32":
                    ui, uv = stn.top_k_streaming(up_1, q, 10, cosine=cosine)
                    row["max_abs_err"] = check_topk(case, sv, si, uv, ui)
                else:
                    _, ri = exact_top_plain(torch, stn, y_exact, q, 10, cosine)
                    row["recall_at_10"] = recall_at(si, ri)
                    if row["recall_at_10"] < 0.99:
                        raise AssertionError(f"{case}: recall@10 {row['recall_at_10']} < 0.99")
                    ui, _ = stn.top_k_streaming(up_1, q, 10, cosine=cosine)
                    row["one_card_recall_at_10"] = recall_at(ui, ri)
                if b in MESH_TIMED and not cosine:
                    row["sharded_call_ms"] = time_ms(
                        torch, lambda: topn.top_k_sharded(up_s, q, 10), 5)  # noqa: B023
                    row["one_card_call_ms"] = time_ms(
                        torch, lambda: stn.top_k_streaming(up_1, q, 10), 5)  # noqa: B023
                    rec[scan] = {"mesh_ms": row["sharded_call_ms"],
                                 "mesh_one_card_ms": row["one_card_call_ms"], "mesh_b": b}
                    if b == 256:
                        cand = torch.zeros((MESH_SHARDS, b, 10), dtype=torch.float32,
                                           device=device)
                        cand_i = torch.arange(MESH_SHARDS * b * 10, dtype=torch.int32,
                                              device=device).view(MESH_SHARDS, b, 10)
                        rec.setdefault("topn_merge", {}).update({
                            "mesh_merge_ms": device_ms(
                                torch, lambda: stn.topn_merge(cand, cand_i, 10), 10),
                            "mesh_merge_lists": MESH_SHARDS})
                emit({**row, "upload_s": upload_s, "nvidia_smi": smi})
        del up_s, up_1
        torch.cuda.empty_cache()
    del y_exact
    torch.cuda.empty_cache()
    return rec


def mesh_kmeans(torch, pk, km, mesh, seed: int, device: str = "cuda") -> tuple[dict, dict]:
    """(b) mesh train_kmeans at 200,000 x 20, k = 10, against one card from
    the same initial centers (kmeans_runs()); the long mesh run launched
    shards x sweeps."""
    n, d, k = MESH_KMEANS
    pts, _ = gaussian_blobs(n, d, k, seed + 1700)
    init = pts[np.random.default_rng(seed + 1701).choice(n, size=k, replace=False)]
    before = pk.launch_counts()["kmeans_sweep.tc"]
    out = {"shape": [n, d, k], **kmeans_runs(km, pts, init, mesh, None)}
    per = MESH_KMEANS_ITERATIONS + 1
    # the long mesh run's sweeps: the last launches of the phase so far
    out["sweeps"] = pk.launch_counts()["kmeans_sweep.tc"] - before
    want = MESH_SHARDS * (2 + per) + 2 + per  # both one-iteration runs, then both long ones
    if device != "cpu" and out["sweeps"] != want:
        raise AssertionError(f"mesh k-means launched {out['sweeps']} sweeps, not {want}")
    return out, {"mesh_ms": out["mesh_s"]["iterate"] * 1e3 / per,
                 "mesh_one_card_ms": out["reference_s"]["iterate"] * 1e3 / per}


def mesh_forest(torch, tf, mesh, seed: int, rows: int = COVTYPE_ROWS,
                device: str = "cuda") -> dict:
    """(c) mesh train_forest at covtype's shape with phase 10's model (20
    trees, depth 8): tree for tree with one card's forest but for near
    ties, held-out accuracy within RDF_ACCURACY_TOL."""
    from oryx_tpu_torch.app.rdf import encode
    from oryx_tpu_torch.app.schema import InputSchema
    from oryx_tpu_torch.common import config

    schema = InputSchema(config.get_default().with_overlay(rdf_schema_config()))
    btr, ytr, bte, yte, num_bins = covtype_binned(encode, schema, rows, seed + 800)
    kw = dict(num_trees=20, max_depth=8, impurity="entropy", min_node_size=16.0,
              min_info_gain=0.001, seed=seed, exclude_features={54})
    one, one_s = timed_train(torch, tf, btr, ytr, device, num_bins=num_bins,
                             num_classes=COVTYPE_CLASSES, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meshed = tf.train_forest(btr, ytr, num_bins=num_bins, num_classes=COVTYPE_CLASSES,
                             mesh=mesh, **kw)
    mesh_s = {"wall_s": time.perf_counter() - t0, **tf.last_phase_seconds}
    parity = forest_parity(tf, one, meshed, btr, ytr, kw, num_bins, device)
    acc = {name: float((tf.predict_forest_binned(f, bte, device=device).argmax(axis=1)
                        == yte).mean()) for name, f in (("one_card", one), ("mesh", meshed))}
    if abs(acc["mesh"] - acc["one_card"]) > RDF_ACCURACY_TOL:
        raise AssertionError(f"mesh forest accuracy {acc}")
    return {"rows": len(btr), "bins": num_bins, "trees": kw["num_trees"],
            "depth": kw["max_depth"], "one_card_s": one_s, "mesh_s": mesh_s,
            "accuracy": acc, "identical_trees": parity["identical_trees"],
            "near_ties": parity["near_ties"]}


def mesh_als(torch, als, mesh, seed: int, scale: float = 1.0) -> dict:
    """(d) train_als at als-train's MovieLens-25M shape and rank 200 on one
    card, replicated over the mesh and with sharded factors, at
    MESH_ALS_ITERATIONS: every run's training RMSE within MESH_RMSE_ATOL
    of one card's."""
    nu, ni, nnz = (max(1_000, int(n * scale)) for n in ML25M)
    u, i, v = power_law_ratings(nu, ni, nnz)
    out = {"shape": [nu, ni, nnz], "rank": ALS_SCALE_RANK, "iterations": MESH_ALS_ITERATIONS}
    for name, kw in (("one_card", {}), ("replicated", {"mesh": mesh}),
                     ("sharded_factors", {"mesh": mesh, "shard_factors": True})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = als.train_als(u, i, v, nu, ni, features=ALS_SCALE_RANK, lam=0.01, alpha=1.0,
                              implicit=True, iterations=MESH_ALS_ITERATIONS, seed=seed, **kw)
        wall = time.perf_counter() - t0
        if not (np.isfinite(model.x).all() and np.isfinite(model.y).all()):
            raise AssertionError(f"mesh ALS {name}: non-finite factors")
        out[name] = {"wall_s": wall, **als.last_phase_seconds,
                     "rmse": als.rmse(model.x, model.y, u, i, v)}
        del model
        torch.cuda.empty_cache()
    for name in ("replicated", "sharded_factors"):
        diff = abs(out[name]["rmse"] - out["one_card"]["rmse"])
        out[name]["rmse_diff"] = diff
        if diff > MESH_RMSE_ATOL:
            raise AssertionError(f"mesh ALS {name}: RMSE {out[name]['rmse']} against one "
                                 f"card's {out['one_card']['rmse']}")
    return out


def mesh_serving(args, topn, x: np.ndarray, y: np.ndarray, probe, ref_v, ref_i) -> dict:
    """(e) a ServingLayer with ``oryx.als.serving.shard-items = true`` on
    phase 4's float32 factors: Y sharded over ``get_mesh()``, the host's one
    card as in the JAX package; /recommend for phase 3's probe users equals
    phase 4's exact top-10."""
    from oryx_tpu_torch.serving.layer import ServingLayer

    loc = "inproc://chip-smoke-mesh"
    t0 = time.perf_counter()
    layer = ServingLayer(serving_config(loc, "float32", "als.serving.shard-items = true"))
    layer.start()
    try:
        publish_model(loc, args.features, x, y)
        base = f"http://127.0.0.1:{layer.port}"
        wait_until("the shard-items layer's /ready", lambda: http_get(base + "/ready")[0] == 200,
                   timeout=120)
        model = layer.model_manager.get_model()
        model.set_item_vectors([f"i{j}" for j in range(SERVE_TOPIC_ROWS, len(y))],
                               y[SERVE_TOPIC_ROWS:])
        model.set_user_vectors([f"u{u}" for u in probe], x[probe])
        ready_s = time.perf_counter() - t0
        answers = [http_get(f"{base}/recommend/u{u}") for u in probe]
        if any(status != 200 for status, _, _ in answers):
            raise AssertionError(f"shard-items /recommend: {sorted({a[0] for a in answers})}")
        bodies = [json.loads(body) for _, body, _ in answers]
        got_i = np.array([[int(r["id"][1:]) for r in b] for b in bodies])
        got_v = np.array([[r["value"] for r in b] for b in bodies])
        err = check_topk("shard-items /recommend", got_v, got_i, ref_v, ref_i)
        handle = model._ensure_y_matrix()[2]
        if not isinstance(handle, topn.ShardedItemMatrix) or model._x_staging:
            raise AssertionError(f"shard-items served from {type(handle).__name__}")
        lat = sorted(a[2] * 1e3 for a in answers)
        return {"requests": len(answers), "shards": len(handle.shards), "ready_s": ready_s,
                "max_abs_err": err, "p50_ms": lat[len(lat) // 2], "max_ms": lat[-1]}
    finally:
        layer.close()


def phase_mesh(torch, args, stn, pk, x: np.ndarray, y: np.ndarray, probe, ref_v, ref_i,
               smi: str, device: str = "cuda", rows: int = COVTYPE_ROWS,
               als_scale: float = 1.0) -> tuple[dict, dict]:
    """Phase 16 (mesh): the port's parallel/ on a 4-shard mesh whose shards
    are all ``cuda:0``, at full width, each sharded result held to the same
    computation on one card: (a) top_k_sharded, (b) k-means, (c) forests,
    (d) ALS in both mesh modes, (e) shard-items serving. Its launch counts
    start at 0 and are read at its end. Returns (launches, the kernel
    table's mesh times by launch key). ``device``, ``rows`` and
    ``als_scale`` shrink it for a rehearsal on the CPU."""
    from oryx_tpu_torch.ops import als, forest as tf, kmeans as km, topn
    from oryx_tpu_torch.parallel.mesh import get_mesh

    mesh = get_mesh(devices=[device if device == "cpu" else "cuda:0"] * MESH_SHARDS)
    stn.reset_launch_counts()
    pk.reset_launch_counts()  # the mesh phase's path starts here
    t0 = time.perf_counter()
    times = mesh_scans(torch, stn, pk, topn, mesh, x, y, smi, device)
    scans_s = time.perf_counter() - t0
    kmeans_rec, times["kmeans_sweep.tc"] = mesh_kmeans(torch, pk, km, mesh, args.seed, device)
    t1 = time.perf_counter()
    forest_rec = mesh_forest(torch, tf, mesh, args.seed, rows, device)
    t2 = time.perf_counter()
    als_rec = mesh_als(torch, als, mesh, args.seed, als_scale)
    t3 = time.perf_counter()
    serving_rec = mesh_serving(args, topn, x, y, probe, ref_v, ref_i)
    launches = {**stn.launch_counts(), **pk.launch_counts()}  # the mesh phase's path ends here
    emit({"phase": "mesh", "shards": MESH_SHARDS, "devices": [str(d) for d in mesh.local_devices()],
          "kmeans": kmeans_rec, "forest": forest_rec, "als": als_rec, "serving": serving_rec,
          "launches": launches, "seconds": {"scans": scans_s, "forest": t2 - t1, "als": t3 - t2,
                                            "serving": time.perf_counter() - t3},
          "nvidia_smi": smi})
    for name in SOURCES:
        if device != "cpu" and launches[name] <= 0:
            raise AssertionError(f"the mesh phase never launched {name}")
    return launches, times


def mesh_rank_main(torch, args) -> int:
    """One rank of phase 16b (mesh-procs), ``chip_smoke.py --mesh-rank R``:
    joins the run through the port's ``maybe_initialize`` from the
    ``oryx.batch.compute.distributed.*`` keys, its kernels built and loaded
    in ``oryx.compute.compile-cache-dir``; runs the cross-process reduction,
    mesh k-means and sharded-factor ALS over the 4-rank mesh; rank 0 then
    runs both over four shards in its own process and holds the two to each
    other. Writes its record to ``<mesh-dir>/rank<R>.json``."""
    from oryx_tpu_torch.common import config as config_utils
    from oryx_tpu_torch.ops import _build, als
    from oryx_tpu_torch.ops import kmeans as km
    from oryx_tpu_torch.ops import pallas_kmeans as pk
    from oryx_tpu_torch.ops import streaming_topn as stn
    from oryx_tpu_torch.parallel import distributed
    from oryx_tpu_torch.parallel import mesh as mesh_mod

    rank, device = args.mesh_rank, args.mesh_device
    cache = os.path.join(args.mesh_dir, "kernels")
    cfg = config_utils.get_default().with_overlay(f"""
        oryx {{
          batch.compute.distributed {{
            coordinator-address = "127.0.0.1:{args.mesh_port}"
            num-processes = {MESH_PROCS}
            process-id = {rank}
          }}
          compute.compile-cache-dir = "{cache}"
        }}""")
    t0 = time.perf_counter()
    distributed.maybe_enable_compile_cache(cfg)
    distributed.maybe_initialize(cfg)
    out = {"rank": rank, "backend": distributed.backend(), "init_s": time.perf_counter() - t0}
    say(f"mesh-procs rank {rank}: torch.distributed backend {distributed.backend()}, "
        f"{distributed.world_size()} ranks on {[str(p.device) for p in distributed.rank_placements()]}")
    t0 = time.perf_counter()
    if device != "cpu":
        _build.build()  # under the build lock: one rank compiles, the others find the libraries
        stn._kernels()
        pk._kernels()
    out["build_s"] = time.perf_counter() - t0
    out["build_events"] = [list(e) for e in _build.EVENTS]
    mesh = mesh_mod.get_mesh()
    total = mesh_mod.all_reduce_sum(mesh, [torch.ones(1, device=device) * (rank + 1)])[0]
    out["reduction"] = float(total)

    n, d, k = MESH_KMEANS
    pts, _ = gaussian_blobs(n, d, k, args.seed + 1700)
    init = pts[np.random.default_rng(args.seed + 1701).choice(n, size=k, replace=False)]
    nu, ni, nnz = ML1M
    u, i, v = movielens_shape(nu, ni, nnz, args.seed + 1702)
    als_kw = dict(features=ALS_LAMBDA_FEATURES, lam=0.1, implicit=False,
                  iterations=MESH_PROCS_ALS_ITERATIONS, seed=args.seed, shard_factors=True)
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    procs_km = [km.train_kmeans(pts, k, iterations=it, initial_centers=init, mesh=mesh)
                for it in (1, MESH_KMEANS_ITERATIONS)]
    out["kmeans_s"] = time.perf_counter() - t0
    out["launches"] = pk.launch_counts()
    t0 = time.perf_counter()
    model = als.train_als(u, i, v, nu, ni, mesh=mesh, **als_kw)
    out["als_s"] = time.perf_counter() - t0
    out["als_rmse"] = als.rmse(model.x, model.y, u, i, v)
    distributed.shutdown()
    if rank == 0:
        # the same runs over four shards of this process
        local = mesh_mod.get_mesh(devices=[mesh_mod.Placement(
            torch.device("cpu" if device == "cpu" else "cuda:0"), 0)] * MESH_PROCS)
        one_km = [km.train_kmeans(pts, k, iterations=it, initial_centers=init, mesh=local)
                  for it in (1, MESH_KMEANS_ITERATIONS)]
        out["kmeans_parity"] = check_kmeans_parity(
            "mesh-procs k-means, one iteration", procs_km[0], one_km[0], pts)
        rel = abs(procs_km[1][2] - one_km[1][2]) / abs(one_km[1][2])
        out["kmeans_parity"]["long_cost_rel_err"] = rel
        if rel > 1e-4:
            raise AssertionError(f"mesh-procs k-means over {MESH_KMEANS_ITERATIONS} "
                                 f"iterations: cost {procs_km[1][2]} against {one_km[1][2]}")
        ref = als.train_als(u, i, v, nu, ni, mesh=local, **als_kw)
        out["als_rmse_in_process"] = als.rmse(ref.x, ref.y, u, i, v)
        out["als_rmse_diff"] = abs(out["als_rmse"] - out["als_rmse_in_process"])
        out["cache_dir"] = cache
        out["cache_files"] = sorted(os.listdir(cache))
    with open(os.path.join(args.mesh_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_mesh_procs(seed: int, smi: str, device: str = "cuda", script: str | None = None) -> dict:
    """Phase 16b (mesh-procs): MESH_PROCS rank processes
    (``mesh_rank_main``) on the one card, joined over gloo (the ranks share
    ``cuda:0``, which NCCL refuses), beside the window. Checks each rank's
    backend and the reduction 1 + 2 + 3 + 4, that the kernels were built
    once in the compile-cache directory and loaded from there by every rank,
    every rank's sweeps (one shard each, 2 + 11 for a one-iteration and a
    long run), and rank 0's parity with four shards in one process: k-means
    as phase 16 holds it (kmeans_runs()), ALS RMSE within MESH_RMSE_ATOL.
    Returns the ranks' summed launches. ``device`` and ``script`` (a
    stand-in for this file that skips its CUDA check) rehearse it on the
    CPU, where nothing is built and nothing counted."""
    from oryx_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-procs-") as tmp:
        port = free_port()
        procs = []
        t0 = time.perf_counter()
        for r in range(MESH_PROCS):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            cmd = [sys.executable, script or os.path.abspath(__file__), "--mesh-rank", str(r),
                   "--mesh-port", str(port), "--mesh-dir", tmp, "--mesh-device", device,
                   "--seed", str(seed)]
            procs.append((subprocess.Popen(cmd, cwd=HERE, stdout=log, stderr=subprocess.STDOUT),
                          log))
        rcs = []
        try:
            deadline = time.monotonic() + MESH_PROCS_TIMEOUT_S
            for proc, _ in procs:
                rcs.append(proc.wait(timeout=max(1.0, deadline - time.monotonic())))
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        wall = time.perf_counter() - t0
        for r in range(MESH_PROCS):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                for line in f:
                    if line.startswith("mesh-procs") or rcs[r] != 0:
                        say(line.rstrip("\n"))
        if any(rcs):
            raise AssertionError(f"mesh-procs: the ranks exited {rcs}")
        ranks = []
        for r in range(MESH_PROCS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    zero = ranks[0]
    cache = zero["cache_dir"]
    built = collections.Counter(e[0] for rk in ranks for e in rk["build_events"] if e[1] == "built")
    loaded = [sorted(e[0] for e in rk["build_events"] if e[1] == "loaded"
                     and os.path.dirname(e[2]) == cache) for rk in ranks]
    launches = collections.Counter()
    for rk in ranks:
        launches.update(rk["launches"])
    out = {"phase": "mesh-procs", "ranks": MESH_PROCS, "wall_s": wall,
           "backends": [rk["backend"] for rk in ranks],
           "reductions": [rk["reduction"] for rk in ranks],
           "built": dict(built), "loaded_from_cache": loaded, "cache_files": zero["cache_files"],
           "kmeans_parity": zero["kmeans_parity"], "als_rmse": zero["als_rmse"],
           "als_rmse_in_process": zero["als_rmse_in_process"],
           "als_rmse_diff": zero["als_rmse_diff"], "launches": dict(launches),
           "seconds": {f"rank{rk['rank']}": {s: rk[s] for s in
                                             ("init_s", "build_s", "kmeans_s", "als_s")}
                       for rk in ranks},
           "nvidia_smi": smi}
    emit(out)
    if out["backends"] != ["gloo"] * MESH_PROCS:
        raise AssertionError(f"mesh-procs backends {out['backends']}: the ranks share one card")
    if out["reductions"] != [float(sum(range(1, MESH_PROCS + 1)))] * MESH_PROCS:
        raise AssertionError(f"mesh-procs reduction {out['reductions']}")
    if device != "cpu" and dict(built) != {name: 1 for name in _build.SOURCES}:
        raise AssertionError(f"mesh-procs: the kernels were built {dict(built)} times")
    if device != "cpu" and loaded != [sorted(_build.SOURCES)] * MESH_PROCS:
        raise AssertionError(f"mesh-procs: the ranks loaded {loaded} from {cache}")
    for rk in ranks:
        if device != "cpu" and rk["launches"].get("kmeans_sweep.tc") != MESH_KMEANS_ITERATIONS + 3:
            raise AssertionError(f"mesh-procs rank {rk['rank']} launched {rk['launches']}")
    if zero["als_rmse_diff"] > MESH_RMSE_ATOL:
        raise AssertionError(f"mesh-procs ALS RMSE {zero['als_rmse']} against "
                             f"{zero['als_rmse_in_process']} in one process")
    return {"launches": dict(launches)}


class PhaseClock:
    """Prints each phase's wall seconds, and the run's so far."""

    def __init__(self, start: float) -> None:
        self.start = self.last = start

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        emit({"phase": "clock", "after": phase, "s": now - self.last, "total_s": now - self.start})
        self.last = now


def phase_alone(name: str, seed: int) -> dict:
    """Runs ``chip_smoke.py --alone <name>``: one phase in a process of its
    own, so that its kernels' counts are its own while other phases run in
    this one. Prints its output when it ends; returns the phase's result."""
    with tempfile.TemporaryDirectory(prefix=f"chip-smoke-{name}-") as tmp:
        out, log = os.path.join(tmp, "result.json"), os.path.join(tmp, "out.log")
        cmd = [sys.executable, os.path.abspath(__file__), "--alone", name,
               "--alone-out", out, "--seed", str(seed)]
        with open(log, "w") as log_file:
            proc = subprocess.Popen(cmd, cwd=HERE, stdout=log_file, stderr=subprocess.STDOUT)
            try:
                rc = proc.wait(timeout=LAMBDA_TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        with open(log) as f:
            for line in f:
                say(line.rstrip("\n"))
        if rc != 0:
            raise AssertionError(f"{name}, in a process of its own, exited {rc}")
        with open(out) as f:
            return json.load(f)


def run_alone(torch, args) -> int:
    """The ``--alone`` side of phase_alone(): the phase under the port's
    lock-order watchdog (armed before the phase imports or builds
    anything of its own, with the settings the test suite gives fleet
    cases), then its result as JSON in ``--alone-out``. Prints the order
    edges the watchdog observed and its violations; any violation fails
    the phase."""
    from oryx_tpu_torch.common import locks

    locks.instrument(strict=True, acquire_timeout=WATCHDOG_ACQUIRE_S)
    try:
        from oryx_tpu_torch.ops import pallas_kmeans as pk
        from oryx_tpu_torch.ops import streaming_topn as stn

        t0 = time.perf_counter()
        if args.alone == "tenants":
            result = {"launches": phase_tenants(torch, stn, pk, args.seed)["launches"]}
        elif args.alone == "fleet":
            result = phase_fleet(args.seed)
        edges = locks.order_edges()
        found = locks.violations()
    finally:
        locks.deinstrument()
    result["watchdog"] = {
        "order_edges": sum(len(dst) for dst in edges.values()),
        "nodes": len(set(edges) | {d for dst in edges.values() for d in dst}),
        "violations": len(found), "strict": True, "acquire_timeout_s": WATCHDOG_ACQUIRE_S,
        "phase_s": time.perf_counter() - t0,
    }
    emit({"phase": f"{args.alone}-watchdog", **result["watchdog"], "found": found[:20]})
    if found:
        raise AssertionError(f"{args.alone}: the lock-order watchdog recorded {found}")
    with open(args.alone_out, "w") as f:
        json.dump(result, f)
    return 0


def phase_lint() -> dict:
    """Phase 1b: the port's static-analysis gate as an operator runs it,
    ``python -m oryx_tpu_torch lint`` in a process of its own over this
    checkout. Fails on a non-zero exit, on any finding and on any stale
    baseline entry; returns the findings, the baseline's entries and the
    findings they accept, the passes and the seconds."""
    from oryx_tpu_torch.analysis import DEFAULT_BASELINE, all_passes, load_baseline

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "oryx_tpu_torch", "lint"], cwd=HERE,
                          capture_output=True, text=True, timeout=LINT_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    verdict = lines[-1] if lines else ""
    stale = [ln for ln in lines[:-1] if ln.startswith("note: stale baseline entry")]
    findings = [ln for ln in lines[:-1] if ln not in stale]
    m = re.fullmatch(r"oryxlint: (clean|\d+ finding\(s\)) \((\d+) baselined\)", verdict)
    out = {"phase": "lint", "rc": proc.returncode, "findings": findings, "stale": stale,
           "baseline_entries": len(load_baseline(DEFAULT_BASELINE)),
           "baselined_findings": int(m.group(2)) if m else None,
           "passes": sorted(all_passes()), "s": seconds}
    emit(out)
    if proc.returncode != 0 or findings or stale or m is None or m.group(1) != "clean":
        raise AssertionError(f"lint: exit {proc.returncode}, {verdict!r}\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return out


class Beside:
    """Phases run in threads beside the main thread's phases. Each one's
    clock line gives its own wall seconds; join() waits for all of them
    and raises the first one's error."""

    def __init__(self) -> None:
        self.threads: list[threading.Thread] = []
        self.results: dict = {}

    def start(self, name: str, fn, *args) -> None:
        def run() -> None:
            t0 = time.perf_counter()
            try:
                self.results[name] = (True, fn(*args))
            except BaseException as e:  # noqa: BLE001 - raised again in join()
                self.results[name] = (False, e)
            emit({"phase": "clock", "after": name, "beside": True,
                  "s": time.perf_counter() - t0})

        thread = threading.Thread(target=run, name=name)
        thread.start()
        self.threads.append(thread)

    def join(self) -> dict:
        for thread in self.threads:
            thread.join()
        for ok, value in self.results.values():
            if not ok:
                raise value
        return {name: value for name, (_, value) in self.results.items()}


def main() -> int:
    args = parse_args()
    if not os.path.isdir(os.path.join(HERE, "oryx_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    full_float32(torch)
    if args.alone:
        return run_alone(torch, args)
    if args.mesh_rank is not None:
        return mesh_rank_main(torch, args)
    from oryx_tpu_torch.common.metrics import registry as metrics
    from oryx_tpu_torch.ops import _build, topn
    from oryx_tpu_torch.ops import pallas_kmeans as pk
    from oryx_tpu_torch.ops import streaming_topn as stn

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    # the native library's g++ build (the feature store, the parser and
    # the HTTP front) runs beside the kernels' nvcc
    native_build = {}

    def build_native():
        from oryx_tpu_torch import native

        t = time.perf_counter()
        native_build["ok"] = native.get_library() is not None
        native_build["s"] = time.perf_counter() - t

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    lint = Beside()  # phase 1b, a process of its own beside the build
    lint.start("lint", phase_lint)
    _build.build()
    build_s = time.perf_counter() - t0
    native_thread.join()
    lint_result = lint.join()["lint"]
    from oryx_tpu_torch import native

    native_sources = [os.path.basename(p) for p in native.source_paths()]
    if not native_build.get("ok"):
        raise AssertionError("the native library did not build (g++)")
    # the build log: spills, and ptxas warnings (a serialised wgmma is
    # C7510-C7520)
    log = [
        (name, line.strip())
        for name in _build.SOURCES
        for line in _build.log_path(name).read_text().splitlines()
    ]
    emit({
        "phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "build_s": build_s,
        "native_build_s": native_build["s"], "native_sources": native_sources,
        "ptxas_spills": sorted({
            f"{name}: {line}" for name, line in log
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
        }),
        "ptxas_warnings": sorted({f"{name}: {line}" for name, line in log if "warning" in line}),
        "ptxas_kernels": ptxas_kernels(log),
    })

    emit({"phase": "cuts", "lambda_batch_interval_s": {
              "kmeans-lambda": [45, KMEANS_LAMBDA_INTERVAL_S],
              "als-lambda": [45, LAMBDA_BATCH_INTERVAL_S],
              "rdf-lambda": [45, LAMBDA_BATCH_INTERVAL_S],
              "buses": [45, CHAOS_BATCH_INTERVAL_S]},
          "als_scale_iterations": [ALS_SCALE_ITERATIONS, args.als_iterations],
          "phase2_plain_and_library_times": f"dot, b in {PHASE2_TIMED} (once all cases)",
          "wide_scan_items": [262_144, WIDE_ITEMS],
          "wide_scan_features": [[1056, 2048, 4096], list(WIDE_FEATURES)],
          "kmeans_kernel_shapes": "10,000,000 x 20 dropped",
          "native_host_store_rows": [1_000_000, NATIVE_STORE_ROWS],
          "serving_front_requests": [4096, FRONT_REQUESTS],
          "tenants_load_s": [10.0, TENANT_LOAD_S],
          "tenants_experiment_users": [2_000, EXP_USERS],
          "ivf_serving_folds": [10_000, IVF_FOLDS],
          "ivf_ops_reps_at_0.3": [2, 1],
          "native_host_formatter_rows": [100_000, NATIVE_FORMAT_ROWS],
          "tenants_rdf_rows": [COVTYPE_ROWS, TENANT_RDF_ROWS],
          "native_host_tier_index": "ivf-serving's catalog and centroids, not its own",
          "native_host_python_formatter_rows": [100_000, NATIVE_PY_FORMAT_ROWS],
          "native_host_p0.3_queries": [TIER_QUERIES, TIER_WIDE_QUERIES],
          "mesh_als_25m_iterations": [ALS_SCALE_ITERATIONS, MESH_ALS_ITERATIONS],
          "mesh_procs_als_1m_iterations": [ALS_SCALE_ITERATIONS, MESH_PROCS_ALS_ITERATIONS],
          "run_at_once": "kmeans-lambda, als-lambda, buses, rdf-lambda and tenants (its own "
                         "process), beside kmeans-batch and ivf-serving; fleet (its own "
                         "process) and mesh-procs (four rank processes) from the end of "
                         "kmeans-batch"})
    clock = PhaseClock(t0)
    gen = np.random.default_rng(args.seed)
    y = factors(gen, args.items, args.features)
    x = factors(gen, args.users, args.features)

    clock("card")
    kernels = phase_kernels(torch, stn, y, args.seed)
    missing = [name for name in SOURCES if name.startswith("topn") and name not in kernels]
    if missing:
        raise AssertionError(f"no phase-2 case took {missing}")
    check_widest_query_tile(torch, stn, args.items, args.seed)
    check_upload_random(torch, stn, args.items, args.features, args.seed)
    clock("kernels")
    check_wide_scans(torch, stn, args.seed)
    clock("wide-scans")

    probe = sorted(gen.choice(np.arange(256, args.users), size=args.concurrency, replace=False))
    y_exact = stn.upload_streaming(y, dtype=torch.float32, device="cuda")
    ref_v, ref_i = exact_top(torch, stn, y_exact, x[probe], 10)
    stn.reset_launch_counts()  # the main path starts here

    layer, model, bodies, statuses, lat, info = serve(torch, args, "int8", x, y, probe)
    try:
        if any(s != 200 for s in statuses):
            raise AssertionError(f"int8 serving: statuses {sorted(set(statuses))}")
        hits = [
            len({r["id"] for r in bodies[str(u)]} & {f"i{j}" for j in ref_i[row]})
            for row, u in enumerate(probe)
        ]
        recall = sum(hits) / (10.0 * len(probe))
        indexed = metrics.counter("serving.batcher.submitted.indexed").value
        # bulk scoring: 512 users in one call takes the candidates kernel;
        # the handle's rows are the store's order, mapped back to item ids
        y_ids, _, handle, *_ = model._ensure_y_matrix()
        bulk = np.arange(256, 768)
        bi, _ = topn.top_k_scores_batch(handle, x[bulk], 10)
        bi = np.array([int(i[1:]) for i in y_ids])[bi]
        _, bulk_ref = exact_top(torch, stn, y_exact, x[bulk], 10)
        bulk_recall = sum(len(set(g) & set(r)) for g, r in zip(bi.tolist(), bulk_ref.tolist()))
        bulk_recall /= 10.0 * len(bulk)
        launches_int8 = stn.launch_counts()
        batches_int8 = stn.scan_batch_histogram()
        emit({
            "phase": "serving-int8", "requests": len(lat), "concurrency": args.concurrency,
            "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "recall_at_10": recall, "bulk_512_recall_at_10": bulk_recall,
            "indexed_entries": indexed, "launches": launches_int8, "scan_batches": batches_int8,
            **info,
        })
        if recall < 0.99 or bulk_recall < 0.99:
            raise AssertionError(f"int8 recall@10 {recall}, bulk {bulk_recall}: below 0.99")
        if indexed <= 0 or launches_int8["topn_scan.tc"] <= 0:
            raise AssertionError("int8 serving never reached index submit / topn_scan.tc")
        if launches_int8["topn_candidates.tc"] <= 0:
            raise AssertionError("the int8 bulk batch never reached topn_candidates.tc")
        if launches_int8["topn_scan.tc_f32"] or launches_int8["topn_candidates.tc_f32"]:
            raise AssertionError(f"an int8 scan took the float32 path: {launches_int8}")
    finally:
        layer.close()
    del model, layer

    profile_root = tempfile.mkdtemp(prefix="chip-smoke-profile-")
    layer, model, bodies, statuses, lat, info = serve(
        torch, args, "float32", x, y, probe,
        extra=f'serving.compute.profile-dir = "{profile_root}"')
    try:
        if any(s != 200 for s in statuses):
            raise AssertionError(f"float32 serving: statuses {sorted(set(statuses))}")
        got_i = np.array([[int(r["id"][1:]) for r in bodies[str(u)]] for u in probe])
        got_v = np.array([[r["value"] for r in bodies[str(u)]] for u in probe])
        err = check_topk("float32 /recommend", got_v, got_i, ref_v, ref_i)
        # bulk scoring: 512 users in one call takes the candidates kernel
        y_ids, _, handle, *_ = model._ensure_y_matrix()
        bulk = np.arange(256, 768)
        bi, bv = topn.top_k_scores_batch(handle, x[bulk], 10)
        bi = np.array([int(i[1:]) for i in y_ids])[bi]
        rv, ri = exact_top(torch, stn, y_exact, x[bulk], 10)
        bulk_err = check_topk("float32 top_k_scores_batch b=512", bv, bi, rv, ri)
        # the first profiler reading of the main path: a capture through
        # POST /debug/profile while the clients keep sending /recommend
        base = f"http://127.0.0.1:{layer.port}"
        scans0 = stn.launch_counts()["topn_scan.tc_f32"]
        profile = profile_under_load(base, [f"{base}/recommend/u{u}" for u in probe])
        # beside the requests: the batcher coalesces them into scans, and
        # the ladder's stale rung answers some with none
        profile["scan_launches_during"] = stn.launch_counts()["topn_scan.tc_f32"] - scans0
        check_trace_kernels("serving-float32 /debug/profile", profile,
                            ("topn_scan", "topn_merge"))
        shutil.rmtree(profile_root, ignore_errors=True)
        launches = stn.launch_counts()
        # phase 3 counted only the tc keys (checked there)
        batches_f32 = {
            name: hist for name, hist in stn.scan_batch_histogram().items()
            if name.endswith(".tc_f32")
        }
        emit({
            "phase": "serving-float32", "requests": len(lat),
            "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "recommend_max_abs_err": err, "bulk_512_max_abs_err": bulk_err,
            "scan_batches": batches_f32, "profile": profile, "nvidia_smi": smi, **info,
        })
        for name in ("topn_scan.tc", "topn_candidates.tc"):
            if launches[name] != launches_int8[name]:
                raise AssertionError(f"a float32 scan took the bf16/int8 path ({name})")
        if launches["topn_scan.tc_f32"] <= 0 or launches["topn_candidates.tc_f32"] <= 0:
            raise AssertionError(f"float32 serving never reached the float32 scans: {launches}")
    finally:
        layer.close()
    # the main path ends here
    del model, layer, y_exact
    torch.cuda.empty_cache()
    clock("serving")
    mesh_launches, mesh_times = phase_mesh(torch, args, stn, pk, x, y, probe, ref_v, ref_i, smi)
    torch.cuda.empty_cache()
    clock("mesh")

    kernels.update(phase_kmeans_kernels(torch, pk, args.seed))
    clock("kmeans-kernels")
    als_rows = phase_als_train(torch, args.seed, args.als_iterations)
    clock("als-train")
    rdf_rows = phase_rdf_train(torch, args.seed, args.rdf_rows)
    clock("rdf-train")
    ivf_ops = phase_ivf_ops(torch, stn, pk, args.seed, features=args.features)
    torch.cuda.empty_cache()  # the lambda phases' processes share the card
    clock("ivf-ops")
    # The four lambda phases run their layers as processes of their own
    # and wait most of their time on generation intervals, and the tenants
    # phase times no kernel either: these five run at once, beside
    # kmeans-batch and ivf-serving, which time nothing on the card and hold
    # no latency to a limit. The phases that time kernels or host code run
    # with nothing beside them, before and after.
    beside = Beside()
    beside.start("kmeans-lambda", phase_kmeans_lambda, args.seed)
    beside.start("als-lambda", phase_als_lambda, args.seed)
    beside.start("buses", phase_buses, args.seed)
    beside.start("rdf-lambda", phase_rdf_lambda, args.seed, args.rdf_rows)
    # the tenants phase counts its kernels from zero, as kmeans-batch and
    # ivf-serving do in this process: it runs in a process of its own
    beside.start("tenants", phase_alone, "tenants", args.seed)
    try:
        launches.update(phase_kmeans_batch(pk, args.seed))
        clock("kmeans-batch")
        # the fleet's replicas, load and CLI share no interpreter with the
        # phases here: a process of its own too, started past the window's
        # first minute, when every other phase starts its processes at once
        beside.start("fleet", phase_alone, "fleet", args.seed)
        # the mesh ranks (and their one nvcc pair) likewise: the window's
        # first minute holds kmeans-lambda's first generation, whose
        # check must stop the batch process within its interval
        beside.start("mesh-procs", phase_mesh_procs, args.seed, smi)
        ivf_srv = phase_ivf_serving(torch, args, stn, pk, args.seed)
        clock("ivf-serving")
    finally:
        done_beside = beside.join()
    clock("beside")
    # the alone phases under the port's lock-order watchdog, and phase 1b
    emit({"phase": "checks", "nvidia_smi": smi, "lint_s": lint_result["s"],
          "lint_findings": len(lint_result["findings"]),
          "lint_baseline_entries": lint_result["baseline_entries"],
          "lint_baselined_findings": lint_result["baselined_findings"],
          "lint_passes": len(lint_result["passes"]),
          "watchdog": {name: done_beside[name]["watchdog"] for name in ALONE_PHASES}})
    tenant_launches = done_beside["tenants"]["launches"]
    lam = done_beside["kmeans-lambda"]
    if lam["batch_launches"].get("kmeans_sweep.tc", 0) <= 0:
        raise AssertionError(f"the batch process launched {lam['batch_launches']}")
    als_lam = done_beside["als-lambda"]
    als_launches = {
        name: als_lam["serving_launches"].get(name, 0) + als_lam["int8_launches"].get(name, 0)
        for name in SOURCES
    }
    bus_launches = done_beside["buses"]["launches"]
    front_launches, front_rps = phase_serving_front(torch, args, stn, pk, args.seed)
    clock("serving-front")
    open_loop_launches = phase_open_loop(torch, args, stn, x, y, args.seed, front_rps, smi)
    clock("open-loop")
    surface_launches = phase_serving_surface(torch, args, x, y, args.seed, smi, stn)
    clock("serving-surface")
    phase_native_host(torch, args, smi, args.seed, catalog=ivf_srv.pop("catalog"))
    clock("native-host")
    ivf_launches = {
        name: ivf_ops["launches"].get(name, 0) + ivf_srv["launches"].get(name, 0)
        for name in SOURCES
    }
    ivf_rows = dict(ivf_ops["ops"])
    ivf_rows["ivf_compact"] = ivf_srv["compact_row"]

    emit({"als_ops": [{"name": name, **row} for name, row in als_rows.items()]})
    emit({"rdf_ops": [{"name": name, **row} for name, row in rdf_rows.items()]})
    emit({"ivf_ops": [{"name": name, **row} for name, row in ivf_rows.items()]})
    table = []
    for name in SOURCES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "als_lambda_launches": als_launches[name],
            "buses_launches": bus_launches.get(name, 0),
            "tenants_launches": tenant_launches.get(name, 0),
            "ivf_launches": ivf_launches[name], "front_launches": front_launches.get(name, 0),
            "surface_launches": surface_launches.get(name, 0),
            "open_loop_launches": open_loop_launches.get(name, 0),
            "mesh_launches": mesh_launches.get(name, 0),
            "mesh_procs_launches": done_beside["mesh-procs"]["launches"].get(name, 0),
            "parity": "ok", "library_topk_ms": None,
            **kernels[name], **mesh_times.get(name, {}),
        })
        if name == "kmeans_sweep.tc":
            table[-1]["ivf_sweep"] = ivf_ops["sweep"]
    emit({"kernels": table})
    say(smi)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
