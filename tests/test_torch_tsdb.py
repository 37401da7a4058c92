"""The port's Prometheus text parser (``telemetry/metrics.parse_text``),
TSDB (``telemetry/tsdb.py``) and fleet scrape (``telemetry/
fleetscrape.py``) against what the reference reads pages with
(``prometheus_client.parser``) and the reference's ``tsdb.py`` and
``fleetscrape.py``:

* the parser's samples equal ``prometheus_client``'s on the pages the
  port's registries render, on pages ``prometheus_client`` renders (the
  reference's serve and control-plane pages), on hand-written edge
  lines, and on every page torn at seeded offsets (both raise, or both
  give the same samples);
* seeded operations on both stores give the same reads (instant,
  values_at, window, latest_n, increase, rate, merged_at,
  bucket_increases, histogram_quantile, labelsets, drop, evictions);
* the same pages give the same stored series, the same ``serve_sample``
  pass after pass (bucket resets, outages, replicas coming and going),
  the same ``parse_serve_pages`` sample, the same targets and the same
  scrape-error reasons."""
import dataclasses
import math
import random

import pytest
from prometheus_client import (
    CollectorRegistry,
    generate_latest,
)
from prometheus_client import Counter as PCounter
from prometheus_client import Gauge as PGauge
from prometheus_client import Histogram as PHistogram
from prometheus_client.parser import text_string_to_metric_families

from kubeflow_tpu.platform.controllers import inferenceservice as ref_ctrl
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.telemetry import fleetscrape as ref_fs
from kubeflow_tpu.telemetry import tsdb as ref_tsdb
from kubeflow_tpu_torch.platform.controllers import inferenceservice as ctrl
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.telemetry import fleetscrape as fs
from kubeflow_tpu_torch.telemetry import tsdb
from kubeflow_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    parse_text,
)


def reference_samples(text):
    return [(s.name, dict(s.labels), s.value)
            for fam in text_string_to_metric_families(text)
            for s in fam.samples]


def same(a, b):
    """Sample lists equal, NaN equal to NaN."""
    if len(a) != len(b):
        return False
    for (n1, l1, v1), (n2, l2, v2) in zip(a, b):
        if (n1, l1) != (n2, l2):
            return False
        if not (v1 == v2 or (math.isnan(v1) and math.isnan(v2))):
            return False
    return True


def port_page():
    reg = Registry()
    c = Counter("generate_requests_total", "requests", ["outcome"],
                registry=reg)
    c.labels(outcome="ok").inc(3)
    c.labels(outcome='we"ird\\path\nline').inc()
    Gauge("serve_queue_depth", "depth", registry=reg).set(2.5)
    h = Histogram("serve_time_to_first_token_seconds", "ttft", ["model"],
                  registry=reg, buckets=(0.05, 0.2, 1.0))
    for v in (0.01, 0.1, 0.5, 3.0):
        h.labels(model="llama").observe(v)
    Counter("plain_counter", "no _total suffix", registry=reg).inc(7)
    Gauge("nan_gauge", "", registry=reg).set(float("nan"))
    Gauge("inf_gauge", "", registry=reg).set(float("-inf"))
    return reg.render()


def prometheus_page():
    reg = CollectorRegistry()
    c = PCounter("generate_requests", "requests", ["outcome"], registry=reg)
    c.labels(outcome="ok").inc(5)
    c.labels(outcome="a\\b\"c").inc()
    PGauge("serve_decode_slots", "slots", registry=reg).set(8)
    PGauge("serve_decode_slots_active", "active", registry=reg).set(3)
    h = PHistogram("serve_time_to_first_token_seconds", "ttft",
                   buckets=(0.05, 0.2, 1.0), registry=reg)
    for v in (0.01, 0.1, 0.5, 3.0):
        h.observe(v)
    return generate_latest(reg).decode()


EDGE = [
    'foo{a="b",} 1', 'foo{a=,b="c"} 1', "foo 1 1712345678000",
    'foo{a="x\\\\y\\"z\\n\\q"} NaN', '{__name__="y",a="b"} 2',
    "foo +Inf", "foo -Inf", 'foo{ a = "b" } 1', "a:b 1",
    "# TYPE foo counter\nfoo 3", "# HELP x doc\nx 1\nx_total 2",
    "# weird comment line\nfoo 1", "foo 1e-3", "foo -0", "foo 0x10",
    # malformed: each raises in both
    'x{__name__="y"} 1', "foo 1_0", "# TYPE foo", 'foo{a="b" c="d"} 1',
    'foo{__x="y"} 1', 'foo{a="b', 'foo{a="b"}', "foo", "foo ",
    "foo-bar 1", 'foo{a="b"} 1 x', "this is { not metrics",
]


def pages():
    return {"port-serve": port_page(), "prometheus": prometheus_page(),
            "port-control-plane": metrics.render(),
            "reference-control-plane": ref_metrics.render().decode(),
            **{f"edge{i}": e for i, e in enumerate(EDGE)}}


def outcome(fn, text):
    try:
        return "ok", fn(text)
    except ValueError:
        return "raises", None


@pytest.mark.parametrize("name", sorted(pages()))
def test_parser_equals_prometheus_client(name):
    text = pages()[name]
    a = outcome(reference_samples, text)
    b = outcome(lambda t: list(parse_text(t)), text)
    assert a[0] == b[0], (a, b)
    if a[0] == "ok":
        assert same(a[1], b[1]), (a[1], b[1])


@pytest.mark.parametrize("name", ["port-serve", "prometheus",
                                  "port-control-plane"])
def test_torn_pages_parse_or_raise_as_prometheus_client(name):
    text = pages()[name]
    rng = random.Random(len(text))
    cuts = sorted(rng.sample(range(1, len(text)), min(150, len(text) - 1)))
    raised = 0
    for cut in cuts:
        torn = text[:cut]
        a = outcome(reference_samples, torn)
        b = outcome(lambda t: list(parse_text(t)), torn)
        assert a[0] == b[0], (cut, torn[-60:], a, b)
        if a[0] == "ok":
            assert same(a[1], b[1]), (cut, torn[-60:])
        raised += a[0] == "raises"
    assert raised > 0


# -- the store ----------------------------------------------------------------


def test_seeded_operations_read_the_same():
    rng = random.Random(3)
    stores = [ref_tsdb.TSDB(capacity=6, max_series=12),
              tsdb.TSDB(capacity=6, max_series=12)]
    names = ["req_total", "lat_bucket", "depth"]
    reads = [[], []]
    t = 0.0
    for step in range(400):
        t += rng.choice((0.5, 1.0, 2.5))
        name = rng.choice(names)
        labels = {"service": rng.choice(("ns/a", "ns/b")),
                  "replica": f"r{rng.randrange(4)}"}
        if name == "lat_bucket":
            labels["le"] = rng.choice(("0.1", "1.0", "+Inf"))
        value = rng.choice((0.0, 3.0, 7.5, float(step)))
        for db in stores:
            db.append(name, labels, value, ts=t)
        if step % 7:
            continue
        at = t - rng.choice((0.0, 1.0, 4.0))
        m = rng.choice(({}, {"service": "ns/a"}, {"replica": "r1"}))
        for i, db in enumerate(stores):
            reads[i].append((
                sorted(map(repr, db.instant("depth", m, at=at,
                                            staleness=3.0))),
                sorted(map(repr, db.values_at("req_total", m, t))),
                sorted(map(repr, db.window("depth", m, start=at - 5,
                                           end=at))),
                db.latest_n("req_total", m, n=3),
                db.increase("req_total", m, window=10.0, at=at),
                db.rate("req_total", m, window=8.0, at=at),
                db.merged_at("lat_bucket", m, ts=t),
                db.merged_at("lat_bucket", m, ts=at, exact=False),
                db.bucket_increases("lat_bucket", m, window=6.0, at=at),
                db.histogram_quantile(0.9, "lat_bucket", m, window=6.0,
                                      at=at),
                db.histogram_quantile(0.5, "lat_bucket", m, at=at),
                sorted(map(repr, db.labelsets("depth", m))),
                len(db), db.names(), db.evictions, db.appends))
    assert reads[0] == reads[1]
    assert stores[1].evictions > 0
    drops = [db.drop("depth", {"service": "ns/a"}) for db in stores]
    assert drops[0] == drops[1] and len(stores[0]) == len(stores[1])


def test_drop_and_evictions_equal():
    out = []
    for mod in (ref_tsdb, tsdb):
        db = mod.TSDB(capacity=3, max_series=3)
        for i in range(5):
            db.append("a", {"service": f"ns/{i % 2}", "i": str(i)}, i,
                      ts=float(i))
        out.append((db.evictions, sorted(map(repr, db.labelsets("a"))),
                    db.drop(matcher={"service": "ns/1"}), len(db)))
    assert out[0] == out[1]


def test_ingest_page_stores_the_same_series():
    for text in (port_page(), prometheus_page(), ref_metrics.render().decode()):
        out = []
        for mod in (ref_tsdb, tsdb):
            db = mod.TSDB()
            n = db.ingest_page(text, labels={"replica": "r0"}, ts=3.0)
            keep = db.ingest_page(text, labels={"replica": "r1"}, ts=4.0,
                                  names={"serve_queue_depth",
                                         "serve_decode_slots"})
            out.append((n, keep, db.names(), sorted(
                (name, repr(db.instant(name))) for name in db.names())))
        assert out[0][:3] == out[1][:3]
        for (n1, i1), (n2, i2) in zip(out[0][3], out[1][3]):
            assert n1 == n2 and (i1 == i2 or "nan" in i1)
    for mod in (ref_tsdb, tsdb):
        with pytest.raises(ValueError):
            mod.TSDB().ingest_page("this is { not metrics", ts=4.0)


# -- the fleet scrape ---------------------------------------------------------


def page(*, queue=0.0, requests=0.0, slots=None, active=None, ttft=None):
    lines = [f"serve_queue_depth {queue}",
             f'generate_requests_total{{outcome="ok"}} {requests}']
    if slots is not None:
        lines += [f"serve_decode_slots {slots}",
                  f"serve_decode_slots_active {active or 0}"]
    for le, v in (ttft or {}).items():
        lines.append(
            f'serve_time_to_first_token_seconds_bucket{{le="{le}"}} {v}')
    return "\n".join(lines) + "\n"


def seeded_passes(seed):
    """Passes of 0-3 replicas' pages, with restarts (counters and buckets
    that drop), outages (None) and garbage pages."""
    rng = random.Random(seed)
    counts = {}
    out = []
    for _ in range(12):
        texts = []
        for r in range(rng.randint(0, 3)):
            kind = rng.random()
            if kind < 0.1:
                texts.append(None)
                continue
            if kind < 0.15:
                texts.append("{ garbage")
                continue
            if kind < 0.25:
                counts[r] = 0  # a restart
            counts[r] = counts.get(r, 0) + rng.randint(0, 20)
            n = counts[r]
            texts.append(page(
                queue=float(rng.randint(0, 9)), requests=float(n),
                slots=rng.choice((None, 8)), active=rng.randint(0, 8),
                ttft={"0.2": n // 3, "1.0": n // 2, "+Inf": n}))
        out.append(texts)
    return out


def scrape_passes(mod, db_mod, passes, frozen=False):
    db = db_mod.TSDB()
    box = {}
    sc = mod.FleetScraper(db, scraper=lambda url: box.get(url),
                          now=lambda: 100.0)
    out = []
    for i, texts in enumerate(passes):
        box = {f"u{j}": t for j, t in enumerate(texts)}
        targets = [mod.Target(url=f"u{j}", labels={"service": "ns/svc",
                                                   "replica": f"r{j}"},
                              names=mod.SERVE_SAMPLE_NAMES)
                   for j in range(len(texts))]
        stats = sc.scrape_service(
            "ns/svc", targets, ts=None if frozen else 100.0 + 10.0 * i)
        out.append((dataclasses.asdict(stats),
                    dataclasses.asdict(mod.serve_sample(db, "ns/svc"))))
    out.append(sorted(map(repr, db.window("serve_queue_depth"))))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_serve_sample_pass_by_pass_equals_the_reference(seed):
    passes = seeded_passes(seed)
    assert (scrape_passes(ref_fs, ref_tsdb, passes)
            == scrape_passes(fs, tsdb, passes))
    assert (scrape_passes(ref_fs, ref_tsdb, passes, frozen=True)
            == scrape_passes(fs, tsdb, passes, frozen=True))


@pytest.mark.parametrize("seed", range(5))
def test_parse_serve_pages_equals_the_reference(seed):
    for texts in seeded_passes(seed):
        texts = [t for t in texts if t and "garbage" not in t]
        a, ab = ref_ctrl.parse_serve_pages(texts)
        b, bb = ctrl.parse_serve_pages(texts)
        assert dataclasses.asdict(a) == dataclasses.asdict(b) and ab == bb


def test_scrape_error_reasons_equal():
    def scraper(url):
        if "dead" in url:
            return None
        if "slow" in url:
            raise TimeoutError()
        if "empty" in url:
            return ""
        return "{ not metrics"

    out = []
    for mod, db_mod, reg in ((ref_fs, ref_tsdb, None), (fs, tsdb, metrics)):
        own = []
        sc = mod.FleetScraper(db_mod.TSDB(), scraper=scraper,
                              on_error=own.append)
        stats = sc.scrape([mod.Target(url=f"http://{h}/metrics")
                           for h in ("dead", "slow", "bad", "empty")]
                          + [mod.Target(fetch=lambda: 1 / 0)])
        out.append((dataclasses.asdict(stats), sorted(own)))
    assert out[0] == out[1]
    assert out[1][1] == ["connect", "connect", "parse", "timeout"]


def test_targets_equal_the_reference():
    def pod(name, ip=None, endpoint=None):
        p = {"metadata": {"name": name, "namespace": "ns",
                          "annotations": {}}, "status": {}}
        if ip:
            p["status"]["podIP"] = ip
        if endpoint:
            p["metadata"]["annotations"][
                "inferenceservices.kubeflow.org/endpoint"] = endpoint
        return p

    pods = [pod("a", ip="10.0.0.1"), pod("b", endpoint="http://x:9/"),
            pod("c")]
    for kw in ({}, {"names": None}):
        a = ref_fs.inferenceservice_targets(pods, port=8080,
                                            service_key="ns/s", **kw)
        b = fs.inferenceservice_targets(pods, port=8080,
                                        service_key="ns/s", **kw)
        assert ([dataclasses.asdict(t) for t in a]
                == [dataclasses.asdict(t) for t in b])
    assert fs.SERVE_SAMPLE_NAMES == ref_fs.SERVE_SAMPLE_NAMES
    # A self-scrape reads the registry's page through the same path.
    db = tsdb.TSDB()
    stats = fs.FleetScraper(db).scrape(
        [fs.self_target(metrics.render, labels={"replica": "me"})], ts=1.0)
    assert stats.ok == 1 and stats.samples > 0
    assert db.labelsets("fleetscrape_targets") == [{"replica": "me"}]


def test_default_tsdb_is_one_store_sized_by_its_knobs(monkeypatch):
    monkeypatch.setattr(fs, "_default_tsdb", None)
    monkeypatch.setenv("KFT_TSDB_CAPACITY", "12")
    monkeypatch.setenv("KFT_TSDB_MAX_SERIES", "34")
    db = fs.default_tsdb()
    assert db is fs.default_tsdb()
    assert (db.capacity, db.max_series) == (12, 34)
