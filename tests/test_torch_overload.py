"""The port's overload control (``oryx_tpu_torch.serving.overload``), its
batcher's reduced-probe groups and queue-wait signal, and its generation
tracker (``oryx_tpu_torch.registry.tracking``), held against the JAX
package's on the CPU.

- The two packages' ``AdmissionController`` fed the same scripted signals
  under the same injected clock walk the same stages, record the same
  transitions and take the same decisions (the cases of
  ``tests/serving/test_overload.py``, without its loadgen and autoscaler
  ones); ``OverloadConfig.from_config`` reads the same fields from the
  same config text; ``AnswerCache``, ``probe_override``, ``count_shed``
  and ``exempt`` behave alike.
- The port's batcher keys a dispatch group by the request's probe
  fraction, so mixed-probe entries never share a scan, and resolves the
  fraction into an ``nprobe`` as the JAX package's does. At that reduced
  ``nprobe``, on a clustered catalog with no empty cell, the port's IVF
  submits (every facade, host and device stage 1) give the JAX
  package's ids and scores.
- The same MODEL / MODEL-REF / INDEX-REF stream leaves both trackers on
  the same live generation, with the same records suppressed.
"""

import threading
import time

import numpy as np
import pytest

from oryx_tpu.common import config as jconfig
from oryx_tpu.common import metrics as jmetrics
from oryx_tpu.common.records import RecordBlock as JRecordBlock
from oryx_tpu.ops import ivf as jivf
from oryx_tpu.ops import topn as jtopn
from oryx_tpu.registry import tracking as jtracking
from oryx_tpu.serving import batcher as jbatcher
from oryx_tpu.serving import overload as jover
from oryx_tpu_torch import device as port_device
from oryx_tpu_torch.app import pmml as tapp_pmml
from oryx_tpu_torch.bus.inproc import InProcessBroker
from oryx_tpu_torch.common import config as tconfig
from oryx_tpu_torch.common import metrics as tmetrics
from oryx_tpu_torch.common import pmml as tpmml
from oryx_tpu_torch.common.records import RecordBlock as TRecordBlock
from oryx_tpu_torch.ops import ivf as tivf
from oryx_tpu_torch.ops import topn as ttopn
from oryx_tpu_torch.registry import tracking as ttracking
from oryx_tpu_torch.serving import batcher as tbatcher
from oryx_tpu_torch.serving import overload as tover
from oryx_tpu_torch.tenancy import context as tcontext

PACKAGES = pytest.mark.parametrize("over", [jover, tover], ids=["jax", "torch"])
_ANN_KNOBS = ("NPROBE", "PROBE_FRACTION", "HOST_STAGE1", "QUERY_BLOCK")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port_device.set_device("cpu")
    saved = [(mod, name, getattr(mod, name)) for mod in (jivf, tivf) for name in _ANN_KNOBS]
    yield
    for mod, name, value in saved:
        setattr(mod, name, value)
    port_device.set_device(None)
    InProcessBroker.reset_all()


# -- exemptions, the probe override, shed counters -------------------------------


@pytest.mark.parametrize("path, want", [
    ("/healthz", True), ("/readyz", True), ("/ready", True), ("/metrics", True),
    ("/trace", True), ("/model/rollback/123", True), ("/model/generations", True),
    ("/debug/profile", True), ("/experiments", True),
    ("/recommend/u1", False), ("/probe/recommend/u1", False), ("/assign/1,2", False),
    ("/readyzz", True), ("/model", True), ("/", False),
])
def test_exempt_paths_agree(path, want):
    assert tover.exempt(path) == jover.exempt(path) == want


@PACKAGES
def test_probe_override_scopes_to_context(over):
    assert over.active_probe_fraction() is None
    with over.probe_override(0.25):
        assert over.active_probe_fraction() == 0.25
        with over.probe_override(None):
            assert over.active_probe_fraction() is None
        assert over.active_probe_fraction() == 0.25
    assert over.active_probe_fraction() is None


def test_probe_override_is_per_thread():
    seen = []
    with tover.probe_override(0.5):
        t = threading.Thread(target=lambda: seen.append(tover.active_probe_fraction()))
        t.start()
        t.join()
        assert tover.active_probe_fraction() == 0.5
    assert seen == [None]


@pytest.mark.parametrize("stage_name", jover.STAGE_NAMES[1:])
def test_count_shed_counter_names_agree(stage_name):
    im_j, im_t = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    for over, reg, im in ((jover, jmetrics.registry, im_j), (tover, tmetrics.registry, im_t)):
        counter = reg.counter("serving.overload.shed." + stage_name)
        before = counter.value
        over.count_shed(stage_name, im, generation="7", tenant="acme")
        assert counter.value == before + 1
    assert im_t.snapshot() == im_j.snapshot()
    assert set(im_t.snapshot()) == {
        f"serving.overload.shed.{stage_name}",
        f"serving.overload.shed.{stage_name}.generation.7",
        f"serving.overload.shed.{stage_name}.tenant.acme",
    }


def test_constants_agree():
    assert tover.STAGE_NAMES == jover.STAGE_NAMES
    assert tover.SHED_HEADER == jover.SHED_HEADER
    assert tover._EXEMPT_PREFIXES == jover._EXEMPT_PREFIXES
    assert (tover.STAGE_FULL, tover.STAGE_REDUCED_PROBE, tover.STAGE_STALE, tover.STAGE_SHED) == (
        jover.STAGE_FULL, jover.STAGE_REDUCED_PROBE, jover.STAGE_STALE, jover.STAGE_SHED
    )


# -- configuration -----------------------------------------------------------------

_OVERLAYS = {
    "defaults": "",
    "custom": """oryx.serving.overload {
        enabled = false, target-queue-wait-ms = 25, inflight-target = 8, max-queue = null,
        engage-reduced = 0.5, engage-stale = 0.9, engage-shed = 2.5, release-fraction = 0.5,
        hold-s = 0.25, alpha = 1.0, probe-fraction = 0.1, cache-entries = 7,
        retry-after-s = 3, control-interval-ms = 10
    }""",
}


@pytest.mark.parametrize("overlay", list(_OVERLAYS))
def test_overload_config_from_the_same_text(overlay):
    text = _OVERLAYS[overlay]
    got = tover.OverloadConfig.from_config(tconfig.get_default().with_overlay(text))
    want = jover.OverloadConfig.from_config(jconfig.get_default().with_overlay(text))
    assert vars(got) == vars(want)
    if overlay == "defaults":
        assert vars(got) == vars(tover.OverloadConfig())


# -- the ladder under one scripted signal sequence -------------------------------


def _controllers(sig, now, **cfg_kw):
    """The JAX package's and the port's controller on the same config,
    signals and clock."""
    kw = dict(alpha=1.0, hold_s=1.0, control_interval_ms=0.0)
    kw.update(cfg_kw)
    return [
        over.AdmissionController(over.OverloadConfig(**kw), signals=lambda: sig[0],
                                 clock=lambda: now[0])
        for over in (jover, tover)
    ]


def _transitions(c):
    return [(t, f, to, round(p, 12)) for t, f, to, p in c.transitions]


def test_ladder_engages_one_rung_per_hold_interval():
    sig, now = [(10_000.0, 0, 0)], [0.0]  # queue wait 200x over budget
    cj, ct = _controllers(sig, now)
    want = [jover.STAGE_REDUCED_PROBE, jover.STAGE_REDUCED_PROBE, jover.STAGE_STALE,
            jover.STAGE_SHED, jover.STAGE_SHED]
    for t, stage in zip((0.0, 0.5, 1.1, 2.2, 3.3), want):
        now[0] = t
        assert ct.evaluate() == cj.evaluate() == stage
    assert [(f, to) for _, f, to, _ in ct.transitions] == [(0, 1), (1, 2), (2, 3)]
    assert _transitions(ct) == _transitions(cj)


def test_ladder_releases_with_hysteresis():
    sig, now = [(100.0, 0, 0)], [0.0]  # pressure 2.0, past engage-shed
    cj, ct = _controllers(sig, now)
    for t in (0.0, 1.1, 2.2):
        now[0] = t
        assert ct.evaluate() == cj.evaluate()
    assert ct.stage == cj.stage == jover.STAGE_SHED
    sig[0] = (55.0, 0, 0)  # 1.1: below engage-shed, above its release line
    now[0] = 3.3
    assert ct.evaluate() == cj.evaluate() == jover.STAGE_SHED
    sig[0] = (0.0, 0, 0)
    for t, want in ((4.4, jover.STAGE_STALE), (5.5, jover.STAGE_REDUCED_PROBE),
                    (6.6, jover.STAGE_FULL)):
        now[0] = t
        assert ct.evaluate() == cj.evaluate() == want
    assert _transitions(ct) == _transitions(cj)


@pytest.mark.parametrize("signal, cfg, pressure", [
    ((0.0, 0, 20), {"inflight_target": 10}, 2.0),  # in flight dominates
    ((0.0, 300, 0), {"max_queue": 100}, 3.0),  # queue depth dominates
    ((25.0, 10, 4), {}, 0.5),  # queue wait dominates
    ((0.0, 5000, 0), {"max_queue": None}, 0.0),  # an unbounded queue reads no depth
])
def test_pressure_is_the_max_of_normalised_signals(signal, cfg, pressure):
    sig, now = [signal], [0.0]
    cj, ct = _controllers(sig, now, **cfg)
    cj.evaluate()
    ct.evaluate()
    assert ct.pressure == cj.pressure == pressure


def test_smoothed_pressure_and_stages_agree_over_a_noisy_sequence():
    """A seeded random signal walk under the reference's smoothing: the
    same pressure (to the last bit) and stage after every evaluation."""
    gen = np.random.default_rng(11)
    sig, now = [(0.0, 0, 0)], [0.0]
    cj, ct = _controllers(sig, now, alpha=0.3, hold_s=0.5, control_interval_ms=50.0)
    for step in range(400):
        now[0] = step * 0.05
        sig[0] = (float(gen.gamma(2.0, 20.0)), int(gen.integers(0, 3000)),
                  int(gen.integers(0, 128)))
        assert ct.evaluate() == cj.evaluate()
        assert ct.pressure == cj.pressure
    assert len(ct.transitions) > 4
    assert _transitions(ct) == _transitions(cj)


def test_decide_carries_stage_payload_and_exemptions():
    sig, now = [(10_000.0, 0, 0)], [0.0]
    cj, ct = _controllers(sig, now, probe_fraction=0.2, retry_after_s=3)
    assert ct.decide("GET", "/healthz") is None and cj.decide("GET", "/healthz") is None
    for t, stage in ((0.0, jover.STAGE_REDUCED_PROBE), (1.1, jover.STAGE_STALE),
                     (2.2, jover.STAGE_SHED)):
        now[0] = t
        dt, dj = ct.decide("GET", "/recommend/u1"), cj.decide("GET", "/recommend/u1")
        assert (dt.stage, dt.probe_fraction, dt.retry_after_s, dt.name) == (
            dj.stage, dj.probe_fraction, dj.retry_after_s, dj.name
        )
        assert dt.stage == stage
    assert dt.name == "shed" and dt.retry_after_s == 3


def test_decide_rate_limits_evaluation():
    """Between control intervals a decision reads the stage without
    touching the signals, in both packages."""
    calls = {"jax": 0, "torch": 0}
    now = [0.0]

    def signals(name):
        def read():
            calls[name] += 1
            return (10_000.0, 0, 0)
        return read

    cs = [
        over.AdmissionController(over.OverloadConfig(alpha=1.0, control_interval_ms=100.0),
                                 signals=signals(name), clock=lambda: now[0])
        for over, name in ((jover, "jax"), (tover, "torch"))
    ]
    for t in (0.0, 0.01, 0.05, 0.099, 0.1, 0.15, 0.2):
        now[0] = t
        assert cs[0].decide("GET", "/x").stage == cs[1].decide("GET", "/x").stage
    assert calls["torch"] == calls["jax"] == 3


def test_tenant_ladders_agree():
    """The per-tenant ladders (copied whole, unused by the port's layer
    until tenancy is ported) walk alike."""
    depths = [{"a": 0, "b": 0}]
    sig, now = [(0.0, 0, 0)], [0.0]
    cs = _controllers(sig, now, max_queue=100)
    for c in cs:
        c.configure_tenants({"a": 3.0, "b": 1.0}, lambda: depths[0])
    for step, (a, b) in enumerate(((0, 10), (0, 60), (0, 60), (50, 60), (0, 0), (0, 0))):
        now[0] = step * 1.1
        depths[0] = {"a": a, "b": b}
        for c in cs:
            c.evaluate()
        assert [cs[1].tenant_stage(t) for t in "ab"] == [cs[0].tenant_stage(t) for t in "ab"]
        assert cs[1].decide("GET", "/x", tenant="b").stage == cs[0].decide("GET", "/x", tenant="b").stage
    assert max(cs[1].tenant_stage(t) for t in "ab") > 0 or cs[1].stage > 0


# -- the stale-answer cache --------------------------------------------------------


@PACKAGES
def test_answer_cache_hits_only_the_current_champion(over):
    cache = over.AnswerCache(max_entries=4)
    cache.put("/recommend/u1", over.CachedAnswer("100", 200, {"a": 1}, None))
    hit = cache.get("/recommend/u1", "100")
    assert hit is not None and hit.payload == {"a": 1}
    assert cache.get("/recommend/u1", "200") is None  # a new champion: the cache is cold
    assert cache.get("/recommend/u1", None) is None  # no champion: never stale
    assert cache.hits == 1 and cache.misses == 2


@PACKAGES
def test_answer_cache_is_a_bounded_lru(over):
    cache = over.AnswerCache(max_entries=2)
    for i in range(3):
        cache.put(f"k{i}", over.CachedAnswer("g", 200, i, None))
    assert len(cache) == 2
    assert cache.get("k0", "g") is None  # the oldest went
    assert cache.get("k2", "g").payload == 2
    cache.get("k1", "g")  # touched: now the newest
    cache.put("k3", over.CachedAnswer("g", 200, 3, None))
    assert cache.get("k2", "g") is None and cache.get("k1", "g").payload == 1


@PACKAGES
def test_answer_cache_listener_sees_every_put(over):
    cache, seen = over.AnswerCache(max_entries=1), []
    cache.listener = lambda key, answer: seen.append((key, answer.payload))
    cache.put("a", over.CachedAnswer("g", 200, 1, None))
    cache.put("b", over.CachedAnswer("g", 200, 2, None))
    assert seen == [("a", 1), ("b", 2)] and len(cache) == 1


# -- the batcher: queue-wait signal, probe groups ------------------------------------


def test_batcher_signals_never_create_a_batcher(monkeypatch):
    monkeypatch.setattr(tbatcher, "_default", None)
    assert tbatcher.default_batcher_signals() == (0.0, 0)
    assert tbatcher._default is None


def test_queue_wait_ewma_decays_when_idle_as_in_the_jax_package():
    bs = [jbatcher.TopNBatcher(max_queue=8), tbatcher.TopNBatcher(max_queue=8)]
    try:
        now = time.monotonic()
        for b in bs:
            with b._flight_cv:
                b._queue_wait_ewma_ms = 100.0
                b._last_wait_obs = now - 2.0  # idle past the grace
        got = [b.queue_wait_ewma_ms() for b in bs]
        # 2 s idle: 100 * 0.5 ** ((2 - 0.25) / 0.5), read a few us apart
        assert got[1] == pytest.approx(got[0], rel=1e-3)
        assert got[1] == pytest.approx(100.0 * 0.5 ** 3.5, rel=1e-3)
        for b in bs:
            with b._flight_cv:
                b._last_wait_obs = time.monotonic()
        assert [b.queue_wait_ewma_ms() for b in bs] == [100.0, 100.0]  # inside the grace
    finally:
        for b in bs:
            b.close()
    assert (tbatcher.WAIT_EWMA_ALPHA, tbatcher.WAIT_DECAY_GRACE_S, tbatcher.WAIT_DECAY_HALF_LIFE_S) == (
        jbatcher.WAIT_EWMA_ALPHA, jbatcher.WAIT_DECAY_GRACE_S, jbatcher.WAIT_DECAY_HALF_LIFE_S
    )


def test_queue_wait_is_measured_from_enqueue_to_dispatch():
    """The EWMA takes a group's worst wait from enqueue until the
    dispatcher holds an inflight slot for it."""
    b = tbatcher.TopNBatcher(max_queue=8)
    try:
        entries = [tbatcher._Entry(None, None, 1, False) for _ in range(3)]
        now = time.monotonic()
        for e, age in zip(entries, (0.010, 0.080, 0.030)):
            e.t_q = now - age
        b._observe_queue_wait(entries)
        assert b._queue_wait_ewma_ms == pytest.approx(0.3 * 80.0, rel=0.05)
    finally:
        b.close()


class _FakeIndex:
    """A handle with the IVF probe resolver and nothing else."""

    def __init__(self, nprobe):
        self._nprobe = nprobe

    def resolve_nprobe(self, nprobe=None):
        return self._nprobe if nprobe is None else nprobe


@pytest.mark.parametrize("fractions", [(None, 0.25, 0.25, 0.5), (0.25, None, 0.1, None, 0.25)])
def test_mixed_probe_entries_never_share_a_group(monkeypatch, fractions):
    """Entries queued together with different probe fractions go out in
    different submits, each at its own nprobe (JAX package:
    ``max(1, int(resolve_nprobe() * fraction))``)."""
    submits, gate, holding = [], threading.Event(), threading.Event()

    class _Handle:
        def __init__(self, n):
            self._n = n

        def result(self):
            return np.zeros((self._n, 16), np.int32), np.zeros((self._n, 16), np.float32)

    def fake_submit(uploaded, queries, k, cosine=False, nprobe=None):
        if not submits:
            holding.set()
            gate.wait(10)  # hold the first group while the rest queue up
        submits.append((nprobe, [float(q[0]) for q in queries if q[0] != 0]))
        return _Handle(len(queries))

    monkeypatch.setattr(tbatcher.topn_ops, "submit_top_k", fake_submit)
    index = _FakeIndex(12)
    b = tbatcher.TopNBatcher(max_inflight=4)
    try:
        first = threading.Thread(target=b.score, args=(index, np.full(4, -1.0, np.float32), 3))
        first.start()
        assert holding.wait(10)  # the dispatcher is inside the first submit
        threads = []
        for i, pf in enumerate(fractions):
            def run(i=i, pf=pf):
                with tover.probe_override(pf):
                    b.score(index, np.full(4, float(i + 1), np.float32), 3)
            threads.append(threading.Thread(target=run))
            threads[-1].start()
        deadline = time.monotonic() + 10
        while b._queue.qsize() < len(fractions) and time.monotonic() < deadline:
            time.sleep(0.001)
        assert b._queue.qsize() == len(fractions)
        gate.set()
        for t in [first] + threads:
            t.join(10)
    finally:
        gate.set()
        b.close()
    by_marker = {i + 1.0: pf for i, pf in enumerate(fractions)}
    assert submits[0] == (None, [-1.0])
    rest = submits[1:]
    assert sorted(m for _, ms in rest for m in ms) == sorted(by_marker)
    assert len(rest) == len(set(fractions))  # one submit per distinct fraction
    for nprobe, markers in rest:
        pfs = {by_marker[m] for m in markers}
        assert len(pfs) == 1
        pf = pfs.pop()
        assert nprobe == (None if pf is None else max(1, int(12 * pf)))


@pytest.fixture(scope="module")
def ivf_pair():
    """The JAX package's and the port's IVF index over one clustered
    catalog on the same centroids, every cell occupied."""
    port_device.set_device("cpu")  # module scope: before the autouse fixture
    gen = np.random.default_rng(21)
    n, f, n_centers = 12_000, 24, 48
    centers = gen.standard_normal((n_centers, f)).astype(np.float32)
    mat = (centers[gen.integers(0, n_centers, n)]
           + 0.3 * gen.standard_normal((n, f))).astype(np.float32)
    queries = (centers[gen.integers(0, n_centers, 24)]
               + 0.3 * gen.standard_normal((24, f))).astype(np.float32)
    jindex0 = jivf.build_ivf(mat, n_cells=48, seed=1)
    cents = np.ascontiguousarray(np.asarray(jindex0.centroids_t).T[:, :f])
    out = {}
    for host in (True, False):
        jivf.configure_ann(host_stage1=host)
        tivf.configure_ann(host_stage1=host)
        out[host] = (jivf.build_ivf(mat, centroids=cents), tivf.build_ivf(mat, centroids=cents))
    port_device.set_device(None)
    return mat, queries, out


def _same(j, t):
    j_ids, j_vals = (np.asarray(a) for a in j)
    t_ids, t_vals = t
    assert np.array_equal(t_ids, j_ids)
    scale = max(1.0, float(np.abs(j_vals).max()))
    assert float(np.abs(t_vals - j_vals).max()) <= 1e-5 * scale


@pytest.mark.parametrize("host_stage1", [True, False])
@pytest.mark.parametrize("facade", ["submit_top_k", "submit_top_k_multi", "submit_top_k_multi_indexed"])
def test_reduced_probe_ivf_equals_the_jax_package(ivf_pair, host_stage1, facade):
    import jax.numpy as jnp
    import torch

    mat, queries, pairs = ivf_pair
    jindex, tindex = pairs[host_stage1]
    assert (tindex.chunk_count_host > 0).all()  # no empty cell
    assert (tindex.host_plane is not None) == host_stage1
    jivf.configure_ann(nprobe=12, host_stage1=host_stage1)
    tivf.configure_ann(nprobe=12, host_stage1=host_stage1)
    reduced = max(1, int(tindex.resolve_nprobe() * 0.25))
    assert reduced == 3
    tivf.reset_counts()
    if facade == "submit_top_k_multi_indexed":
        rows = np.arange(len(queries))[::-1].copy()
        j = jtopn.submit_top_k_multi_indexed(jindex, jnp.asarray(queries), rows, 10, nprobe=reduced)
        t = ttopn.submit_top_k_multi_indexed(tindex, torch.from_numpy(queries), rows, 10,
                                             nprobe=reduced)
    else:
        j = getattr(jtopn, facade)(jindex, queries, 10, nprobe=reduced)
        t = getattr(ttopn, facade)(tindex, queries, 10, nprobe=reduced)
    _same(j.result(), t.result())
    assert tivf.nprobe_counts() == {reduced: 1}
    # and the full probe count differs from the reduced answer somewhere
    full = ttopn.submit_top_k(tindex, queries, 10).result()
    assert tivf.nprobe_counts() == {reduced: 1, tindex.resolve_nprobe(): 1}
    assert full[0].shape == t.result()[0].shape


@pytest.mark.parametrize("host_stage1", [True, False])
def test_batchers_under_the_override_agree(ivf_pair, host_stage1):
    """Each package's batcher under its own probe override scores at
    the reduced nprobe, and the two agree."""
    mat, queries, pairs = ivf_pair
    jindex, tindex = pairs[host_stage1]
    jivf.configure_ann(nprobe=12, host_stage1=host_stage1)
    tivf.configure_ann(nprobe=12, host_stage1=host_stage1)
    reduced = max(1, int(tindex.resolve_nprobe() * 0.25))
    jb, tb = jbatcher.TopNBatcher(), tbatcher.TopNBatcher()
    try:
        for q in queries[:6]:
            with jover.probe_override(0.25):
                j = jb.score(jindex, q, 10)
            with tover.probe_override(0.25):
                t = tb.score(tindex, q, 10)
            _same(j, t)
            want = tivf.top_k(tindex, q[None], 10, nprobe=reduced)
            assert np.array_equal(t[0], want[0][0])
    finally:
        jb.close()
        tb.close()


def test_current_tenant_is_untenanted_in_the_port():
    assert tcontext.current_tenant() is None
    with tcontext.tenant_scope("acme"):
        assert tcontext.current_tenant() == "acme"
    assert tcontext.split_tenant_path("/t/als/recommend/u1") == ("als", "/recommend/u1")
    assert tcontext.split_tenant_path("/t/als") == ("als", "/")
    assert tcontext.split_tenant_path("/recommend/u1") == (None, "/recommend/u1")
    assert tcontext.TENANT_HEADER == "X-Oryx-Tenant"


# -- the generation tracker -----------------------------------------------------------


def _model(generation):
    root = tpmml.build_skeleton_pmml()
    if generation is not None:
        tapp_pmml.add_extension(root, "generation", generation)
    return tpmml.to_string(root)


_STREAM = [
    # (key, message spec): ("MODEL", generation) builds inline PMML
    [("MODEL", "100"), ("UP", "x1")],
    [("UP", "x2"), ("MODEL", "100"), ("UP", "x3")],  # a duplicate of the live MODEL
    [("MODEL-REF", "/models/200/model.pmml")],
    [("MODEL-REF", "/models/200/model.pmml"), ("MODEL", "200")],  # two duplicates
    [("INDEX-REF", "/models/_index/300"), ("INDEX-REF", "/models/_index/300")],
    [("MODEL", None)],  # no generation: passes, tracking goes unknown
    [("MODEL", "100")],  # a rollback republish of an older generation passes
    [("UP", "x4")],
    [("MODEL", "100"), ("MODEL", "100")],
]


def _blocks():
    """The stream as (JAX package's, port's) RecordBlocks of the same bytes."""
    out = []
    for spec in _STREAM:
        keys = np.array([key.encode() for key, _ in spec], dtype="S")
        msgs = np.array([
            (_model(value) if key == "MODEL" else value).encode() for key, value in spec
        ], dtype="S")
        out.append((JRecordBlock(keys.copy(), msgs.copy()), TRecordBlock(keys, msgs)))
    return out


def test_tracker_follows_the_stream_as_the_jax_package():
    from oryx_tpu_torch.serving.layer import ServingHealth

    jt = jtracking.GenerationTracker()
    health = ServingHealth()
    tt = ttracking.GenerationTracker(health)
    jdup = jmetrics.registry.counter(jtracking.DUPLICATES_COUNTER)
    tdup = tmetrics.registry.counter(ttracking.DUPLICATES_COUNTER)
    for jb, tb in _blocks():
        j0, t0 = jdup.value, tdup.value
        jo, to = jt.filter_block(jb), tt.filter_block(tb)
        assert (jo is None) == (to is None)
        if jo is not None:
            assert to.keys.tolist() == jo.keys.tolist()
            assert to.messages.tolist() == jo.messages.tolist()
        assert tdup.value - t0 == jdup.value - j0
        assert (tt.live_generation, tt.live_index_generation) == (
            jt.live_generation, jt.live_index_generation
        )
        assert health.live_generation == tt.live_generation
    assert tt.live_generation == "100" and tt.live_index_generation is not None
    assert tt.challenger_generation is None


@pytest.mark.parametrize("key, message", [
    ("MODEL-REF", "/models/1700000000000/model.pmml"),
    ("MODEL-REF", "s3://bucket/models/123/"),
    ("MODEL-REF", "not a generation path"),
    ("UP", "[]"),
    ("MODEL", "<not pmml"),
    ("MODEL", None),  # a PMML with generation 42, built in the test
])
def test_generation_of_a_message_agrees(key, message):
    message = _model("42") if message is None else message
    got = ttracking.generation_of_model_message(key, message)
    assert got == jtracking.generation_of_model_message(key, message)


def test_fleet_skew_agrees():
    for gens in ([], ["1", "1", None], ["1", "2", None], ["1", "2", "3"]):
        assert ttracking.record_fleet_skew(gens) == jtracking.record_fleet_skew(gens)


def test_both_batchers_export_queue_depth_after_a_scored_batch():
    """``serving.batcher.queue_depth``, the name docs/observability.md
    catalogs, is set beside ``serving.batcher.queue.depth`` at each
    dispatch, by both packages' batchers."""
    y = np.random.default_rng(5).standard_normal((300, 8)).astype(np.float32)
    q = np.arange(8, dtype=np.float32)
    sides = [
        (jbatcher, jmetrics, jtopn.upload(y, streaming=False)),
        (tbatcher, tmetrics, ttopn.upload(y)),
    ]
    for batcher_mod, metrics_mod, handle in sides:
        reg = metrics_mod.registry
        reg.gauge("serving.batcher.queue_depth").set(-1.0)  # a value no dispatch sets
        b = batcher_mod.TopNBatcher()
        try:
            idx, _ = b.score(handle, q, 5)
        finally:
            b.close()
        assert len(idx) == 5
        depth = reg.gauge("serving.batcher.queue_depth").value
        assert depth == reg.gauge("serving.batcher.queue.depth").value
        assert depth >= 0, batcher_mod.__name__
