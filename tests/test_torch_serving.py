"""The port's serving tier against the JAX package, on the CPU.

One scenario runs on each package in this process (so `PYTHONHASHSEED`
tie-breaks match), with `uuid.uuid4` patched to one deterministic
sequence restarted per side (shard writers draw their tokens from it).
It builds a 4-shard `ShardedIndex` and an unsharded `Index` over one
log corpus, then drives `ClusterSearcher`'s per-shard path (under
`impl="sorted"` and `impl="bitmap"`) and its fused path (under
`budget="global"` and `"per_shard"`) over per-shard `SimCloudStore`
transports with fixed seeds, so virtual-clock latencies and every
`ScatterReport` field are exact; a `SearchService` over the cluster
with its result cache, and its `refresh` after a shard writer's commit;
a `Frontend` in stepped mode, shedding at its queue bound and expiring
on an injected clock; `control.py`'s pickers and controllers on seeded
inputs; `telemetry` histograms; and a `GenerationBus` fed by an index's
writes. The two traces must agree key by key: cluster manifests and
blobs byte for byte, results in refs, texts and `FetchStats`,
`ScatterReport`s, service stats, frontend counters, picks, windows,
quantiles and events. The JAX side runs its Pallas kernels in
interpret mode, the port its plain PyTorch versions (`device="cpu"`).

Then the port alone: the cluster equals the unsharded index, a cluster
the JAX package aliased with `split` is read the same by both, and so is
one the port aliased (its blobs equal the JAX package's byte for byte),
and the fused path refuses units on two devices. The management half
itself is held to the JAX package in `tests/test_torch_resharding.py`.
"""

import dataclasses
import itertools
import random
import uuid
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import repro.data as j_data
import repro.index as j_index
import repro.serving as j_serving
import repro.storage as j_storage
import repro_torch.data as t_data
import repro_torch.index as t_index
import repro_torch.serving as t_serving
import repro_torch.storage as t_storage

SIDES = {
    "j": SimpleNamespace(data=j_data, index=j_index, serving=j_serving,
                         storage=j_storage, dev={}),
    "t": SimpleNamespace(data=t_data, index=t_index, serving=t_serving,
                         storage=t_storage, dev={"device": "cpu"}),
}
SHARD_CFG = dict(B=900, F0=1.0, index_ngrams=3)
MONO_CFG = dict(B=1800, F0=1.0, index_ngrams=3)
N_SHARDS = 4
QUERIES = ["error", "info", "info AND block", "warn OR node7",
           "info AND NOT block", "(info AND block) OR node9",
           '"for block"', "re:/blk_1[0-9]2/"]


def uuid_sequence():
    counter = itertools.count(1)
    return mock.patch.object(uuid, "uuid4",
                             lambda: uuid.UUID(int=next(counter) << 96))


def _blobs(store, prefix=""):
    return {name: store.get(name) for name in store.list(prefix)}


def _plain(results):
    return [([dataclasses.astuple(r) for r in res.refs], res.texts,
             dataclasses.asdict(res.stats)) for res in results]


def _hits(results):
    return [([dataclasses.astuple(r) for r in res.refs], res.texts)
            for res in results]


def _sources(s, store, seed0):
    return lambda i: s.storage.SimCloudTransport(
        s.storage.SimCloudStore(store, seed=seed0 + i))


def serving_trace(s) -> dict:
    """The scenario on one package `s`; returns every observable."""
    trace: dict = {}
    store = s.storage.InMemoryBlobStore()
    docs = s.data.make_logs_like(700, seed=13)
    corpus = s.data.write_corpus(store, "corpus/sc", docs, n_blobs=4)
    queries = [s.index.parse(q) for q in QUERIES]
    with uuid_sequence():
        mono = s.index.Index.build(corpus, s.index.BuilderConfig(**MONO_CFG),
                                   store, "index/mono", **s.dev)
        cluster = s.serving.ShardedIndex.build(
            corpus, s.index.BuilderConfig(**SHARD_CFG), store, "cluster/sc",
            n_shards=N_SHARDS, **s.dev)
        trace["cluster_blobs"] = _blobs(store, "cluster/")
        trace["cluster_manifest"] = (cluster.manifest,
                                     cluster.reader_generation,
                                     cluster.n_docs)

        mono_s = mono.searcher(transport=_sources(s, store, 90)(0))
        trace["mono"] = {k: _plain(mono_s.query_batch(queries, top_k=k,
                                                      impl="sorted"))
                         for k in (None, 5)}

        cs = cluster.searcher(replica_sources=[_sources(s, store, 40)])
        legs = {}
        for impl in ("sorted", "bitmap"):
            for k in (None, 5):
                out = cs.query_batch(queries, top_k=k, impl=impl,
                                     fused=False)
                legs[f"{impl}/{k}"] = (_plain(out),
                                       dataclasses.asdict(cs.last_scatter))
        trace["per_shard"] = legs
        trace["boot"] = dataclasses.asdict(cs.init_stats)
        cs.close()

        fs = cluster.searcher(replica_sources=[_sources(s, store, 60)],
                              fused=True)
        fused = {}
        for k in (None, 1, 5):
            for budget in ("global", "per_shard"):
                out = fs.query_batch(queries, top_k=k, budget=budget)
                fused[f"{budget}/{k}"] = (_plain(out), dataclasses.asdict(
                    fs.last_scatter))
        trace["fused"] = fused
        fs.close()

        # a replica pair per shard: the picker's choices and in-flight
        # accounting, then a hedge against a straggling first replica
        slow = s.storage.NetworkModel().scaled(40.0, "far-away")
        hs = cluster.searcher(
            replica_sources=[lambda i: s.storage.SimCloudTransport(
                s.storage.SimCloudStore(store, model=slow, seed=70 + i)),
                _sources(s, store, 170)],
            hedge_after_s=0.25)
        out = hs.query_batch(queries[:3])
        trace["hedged"] = (_plain(out), dataclasses.asdict(hs.last_scatter))
        hs.close()

        # the service over the cluster: its result cache, then refresh
        # after one shard writer's commit
        svc = s.serving.SearchService(
            s.serving.ShardedIndex.open(store, "cluster/sc", **s.dev),
            cache_size=16)
        first = svc.search_batch(queries, top_k=5)
        again = svc.search_batch(queries, top_k=5)
        unchanged = svc.refresh()
        extra = s.data.write_corpus(store, "corpus/extra",
                                    ["zzznewdoc error sentinel"], n_blobs=1)
        routed = svc.index.partition(extra)
        target = next(i for i, part in enumerate(routed) if part.refs)
        w = svc.index.shard(target).writer()
        w.append(routed[target])
        w.commit()
        swapped = svc.refresh()
        after = svc.search_batch(["zzznewdoc", "error"], top_k=None)
        # its transport is a bare store's: wall-clock fields differ
        summary = {k: v for k, v in svc.stats.summary().items()
                   if not k.endswith("_ms")}
        trace["service"] = (_hits(first), _hits(again), unchanged, swapped,
                            _hits(after), svc.cache_hits, summary,
                            svc.index.reader_generation)
        trace["service_blobs"] = _blobs(store, "cluster/")
        svc.close()

        # the frontend, stepped: shedding at the queue bound, expiry on
        # an injected clock, micro-batches through the service
        svc = s.serving.SearchService(
            s.serving.ShardedIndex.open(store, "cluster/sc", **s.dev),
            cache_size=8)
        now = [0.0]
        fe = s.serving.Frontend(svc, s.serving.FrontendConfig(
            max_queue=4, max_batch=3), clock=lambda: now[0])
        futs, shed = [], 0
        for i, q in enumerate(["error", "info", "warn", "error", "block"]):
            try:
                futs.append(fe.submit(q, timeout_s=1.0 if i == 1 else 60.0))
            except s.serving.Overloaded as exc:
                shed += 1
                overloaded = (exc.depth, exc.limit)
        now[0] = 5.0
        served = []
        while fe.depth:
            served.append(fe.run_once())
        outcomes = []
        for f in futs:
            try:
                outcomes.append(_hits([f.result()])[0])
            except s.serving.DeadlineExceeded:
                outcomes.append("expired")
        stats = fe.stats.summary()
        trace["frontend"] = (
            shed, overloaded, served, outcomes, fe.stats.batch_sizes,
            {k: stats[k] for k in ("n_admitted", "n_shed", "n_expired",
                                   "n_served", "queue_high_water",
                                   "n_batches")},
            svc.stats.batch_sizes)
        fe.close()
        svc.close()

        # a bus fed by an index's writes
        bus = s.serving.GenerationBus()
        events = []
        bus.subscribe(lambda e: events.append(dataclasses.astuple(e)))
        mono.attach_bus(bus)
        w = mono.writer()
        w.add(extra)
        w.commit()
        bus.post_generation("elsewhere", "published", 7, seq=2)
        trace["bus"] = (bus.pending, bus.drain(), events, bus.n_posted,
                        bus.n_delivered, bus.n_callback_errors)
        bus.close()

    trace["control"] = control_trace(s.serving)
    trace["telemetry"] = telemetry_trace(s.serving)
    return trace


def control_trace(serving) -> list:
    """Pickers on seeded loads, a BatchController and a DeadlineShedder
    on a seeded arrival and service trace."""
    rng = random.Random(5)
    out = []
    p2c, least = serving.PowerOfTwoChoices(seed=11), serving.LeastLoaded()
    for _ in range(60):
        loads = [rng.randrange(0, 9) for _ in range(rng.randrange(2, 7))]
        exclude = rng.choice([None, 0, len(loads) - 1])
        out.append((p2c.pick(loads, exclude=exclude),
                    least.pick(loads, exclude=exclude)))
    ctl = serving.BatchController(max_batch=8, config=serving.ControlConfig(
        min_samples=3))
    shed = serving.DeadlineShedder(max_batch=8, quantile=0.9, min_samples=3)
    t = 0.0
    for i in range(40):
        t += rng.expovariate(50.0)
        ctl.on_arrival(t)
        if i % 4 == 3:
            size = rng.randrange(1, 9)
            service = 0.002 + 0.001 * size + rng.random() * 1e-3
            ctl.on_batch(service, size)
            shed.on_batch(service, size)
        depth = rng.randrange(0, 12)
        try:
            shed.admit(t, t + rng.random() * 0.02, depth)
            verdict = "admit"
        except serving.PredictedDeadlineMiss as exc:
            verdict = (exc.predicted_completion_s, exc.deadline_s)
        out.append((ctl.window(depth, now=t), ctl.arrival_rate(),
                    ctl.n_observations, verdict))
    out.append((shed.n_shed, shed.n_evaluated,
                [type(serving.as_picker(p)).__name__
                 for p in (None, "least_loaded", "p2c")]))
    return out


def telemetry_trace(serving) -> list:
    rng = np.random.default_rng(0)
    tel = serving.Telemetry()
    h = tel.histogram("lat", window=64)
    for x in rng.exponential(0.1, size=200):
        h.observe(float(x))
    tel.counter("requests").inc(3)
    tel.gauge("replica.s0.r0.in_flight").set(2)
    tel.gauge("replica.s0.r0.in_flight").dec(0.5)
    return [h.count, h.mean(), [h.quantile(q) for q in
                                (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)],
            h.summary(), tel.snapshot(),
            sorted(tel.gauges_matching("replica."))]


KEYS = ["cluster_blobs", "cluster_manifest", "mono", "per_shard", "boot",
        "fused", "hedged", "service", "service_blobs", "frontend", "bus",
        "control", "telemetry"]


@pytest.fixture(scope="module")
def traces():
    return {side: serving_trace(s) for side, s in SIDES.items()}


@pytest.mark.parametrize("key", KEYS)
def test_serving_matches_jax(traces, key):
    assert sorted(traces["j"]) == sorted(KEYS) == sorted(traces["t"])
    assert traces["t"][key] == traces["j"][key], key


def _refs_texts(plain):
    return [r[:2] for r in plain]


def test_cluster_equals_unsharded_index(traces):
    """Every path of the port's cluster answers as the unsharded index
    does; the two budgets differ in round-2 bytes only."""
    t = traces["t"]
    full = _refs_texts(t["mono"][None])
    assert any(refs for refs, _ in full)
    for k in (None, 5):
        for impl in ("sorted", "bitmap"):
            got = _refs_texts(t["per_shard"][f"{impl}/{k}"][0])
            if k is None:
                assert got == full
            else:
                for (refs, _texts), (all_refs, _) in zip(got, full):
                    assert set(map(tuple, refs)) <= set(map(tuple, all_refs))
    assert _refs_texts(t["fused"]["global/None"][0]) == full
    for k in (1, 5):
        glob, per = t["fused"][f"global/{k}"], t["fused"][f"per_shard/{k}"]
        assert _refs_texts(glob[0]) == _refs_texts(per[0])
        assert glob[1]["fused"] and glob[1]["budget"] == "global"
        assert sum(glob[1]["round2_bytes"]) > 0
    assert t["hedged"][1]["n_hedges_issued"] == N_SHARDS
    service = t["service"]
    assert service[0] == service[1] and service[5] == len(QUERIES)
    assert service[2] is False and service[3] is True
    assert service[4][0][1] == ["zzznewdoc error sentinel"]
    frontend = t["frontend"]
    assert frontend[0] == 1 and "expired" in frontend[3]
    assert t["bus"][1] == t["bus"][3] == 3


@pytest.fixture(scope="module")
def aliased():
    """A cluster the JAX package split in alias mode (its manifest's
    shard entries alias the source shard's blobs), copied into a port
    store."""
    store = j_storage.InMemoryBlobStore()
    docs = j_data.make_logs_like(400, seed=31)
    corpus = j_data.write_corpus(store, "corpus/al", docs, n_blobs=2)
    cluster = j_serving.ShardedIndex.build(
        corpus, j_index.BuilderConfig(**SHARD_CFG), store, "cluster/al",
        n_shards=2, n_slots=8)
    with uuid_sequence():
        cluster.split(0)
    assert cluster.aliased_shards
    return store, t_storage.from_items(_blobs(store).items())


@pytest.mark.parametrize("fused", [False, True])
def test_port_reads_an_aliased_cluster_as_jax_does(aliased, fused):
    j_store, t_store = aliased
    queries = ["error", "info AND block", "warn OR node7"]
    j_cs = j_serving.ShardedIndex.open(j_store, "cluster/al").searcher(
        replica_sources=[_sources(SIDES["j"], j_store, 20)], fused=fused)
    t_idx = t_serving.ShardedIndex.open(t_store, "cluster/al", device="cpu")
    assert t_idx.aliased_shards
    t_cs = t_idx.searcher(
        replica_sources=[_sources(SIDES["t"], t_store, 20)], fused=fused)
    for k in (None, 3):
        a = j_cs.query_batch([j_index.parse(q) for q in queries], top_k=k,
                             impl="bitmap")
        b = t_cs.query_batch([t_index.parse(q) for q in queries], top_k=k)
        assert _plain(a) == _plain(b)
        assert dataclasses.asdict(j_cs.last_scatter) == \
            dataclasses.asdict(t_cs.last_scatter)
    j_cs.close()
    t_cs.close()


@pytest.fixture(scope="module")
def aliased_by_port(aliased):
    """The same cluster, built and split in alias mode by the port, and
    copied into a JAX store."""
    store = t_storage.InMemoryBlobStore()
    docs = t_data.make_logs_like(400, seed=31)
    corpus = t_data.write_corpus(store, "corpus/al", docs, n_blobs=2)
    cluster = t_serving.ShardedIndex.build(
        corpus, t_index.BuilderConfig(**SHARD_CFG), store, "cluster/al",
        n_shards=2, n_slots=8, device="cpu")
    with uuid_sequence():
        cluster.split(0)
    assert cluster.aliased_shards
    assert _blobs(store) == _blobs(aliased[0])
    j_store = j_storage.InMemoryBlobStore()
    for name, data in _blobs(store).items():
        j_store.put(name, data)
    return j_store, store


@pytest.mark.parametrize("fused", [False, True])
def test_jax_reads_a_cluster_the_port_aliased_as_the_port_does(
        aliased_by_port, fused):
    j_store, t_store = aliased_by_port
    queries = ["error", "info AND block", "warn OR node7"]
    j_idx = j_serving.ShardedIndex.open(j_store, "cluster/al")
    assert j_idx.aliased_shards
    j_cs = j_idx.searcher(
        replica_sources=[_sources(SIDES["j"], j_store, 20)], fused=fused)
    t_cs = t_serving.ShardedIndex.open(t_store, "cluster/al",
                                       device="cpu").searcher(
        replica_sources=[_sources(SIDES["t"], t_store, 20)], fused=fused)
    for k in (None, 3):
        a = j_cs.query_batch([j_index.parse(q) for q in queries], top_k=k,
                             impl="bitmap")
        b = t_cs.query_batch([t_index.parse(q) for q in queries], top_k=k)
        assert _plain(a) == _plain(b)
        assert dataclasses.asdict(j_cs.last_scatter) == \
            dataclasses.asdict(t_cs.last_scatter)
    j_cs.close()
    t_cs.close()


def test_fused_path_refuses_units_on_two_devices():
    store = t_storage.InMemoryBlobStore()
    corpus = t_data.write_corpus(store, "c", t_data.make_logs_like(200,
                                                                   seed=3))
    cluster = t_serving.ShardedIndex.build(
        corpus, t_index.BuilderConfig(**SHARD_CFG), store, "cl",
        n_shards=2, device="cpu")
    cs = cluster.searcher(fused=True)
    assert [r.reader.device for rs in cs.shard_replicas for r in rs] == \
        [torch.device("cpu")] * 2
    cs.shard_replicas[1][0].reader.device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        cs.query_batch(["error"])
    cs.close()


def test_serving_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = t_storage.InMemoryBlobStore()
    corpus = t_data.write_corpus(store, "c", t_data.make_logs_like(120,
                                                                   seed=3))
    cfg = t_index.BuilderConfig(**SHARD_CFG)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_serving.ShardedIndex.build(corpus, cfg, store, "cl", n_shards=2)
    assert store.list("cl/") == []
    t_serving.ShardedIndex.build(corpus, cfg, store, "cl", n_shards=2,
                                 device="cpu")
    t_index.Index.build(corpus, cfg, store, "ix", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_serving.ShardedIndex.open(store, "cl")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_serving.SearchService(store, "ix")
    svc = t_serving.SearchService(store, "ix", device="cpu")
    assert svc.search_batch(["error"])[0].refs
    svc.close()
