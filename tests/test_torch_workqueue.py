"""The port's work queue and ``Controller`` dispatch
(``kubeflow_tpu_torch/platform/runtime/controller.py``) against the
reference's: the five cases of ``tests/ctrlplane/test_workqueue.py`` run
on both queues, one script of adds, delays and backoffs handed out in
the same order by both, and the race tier's per-key exclusion
(``tests/ctrlplane/test_race_stress.py``) on the port's queue and on a
port ``Controller`` at several worker counts, at a few hundred keys."""
import random
import threading
import time
from collections import defaultdict

import pytest

from kubeflow_tpu.platform.runtime import controller as ref_controller
from kubeflow_tpu_torch.platform import FakeKube
from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK
from kubeflow_tpu_torch.platform.runtime import controller, metrics

QUEUES = {
    "reference": (ref_controller._WorkQueue, ref_controller.Request),
    "port": (controller._WorkQueue, controller.Request),
}


@pytest.fixture(params=sorted(QUEUES))
def impl(request):
    return QUEUES[request.param]


def test_dedup_of_pending_items(impl):
    Queue, Request = impl
    q = Queue()
    r = Request("ns", "a")
    q.add(r)
    q.add(r)
    assert q.get(timeout=0.5) == r
    assert q.get(timeout=0.05) is None


def test_immediate_add_preempts_backoff(impl):
    Queue, Request = impl
    q = Queue(base_delay=5.0)
    r = Request("ns", "a")
    q.add_rate_limited(r)
    q.add(r)   # a watch event: served now, not after the backoff
    t0 = time.monotonic()
    assert q.get(timeout=1.0) == r
    assert time.monotonic() - t0 < 1.0
    assert q.get(timeout=0.1) is None  # the delayed entry is superseded


def test_backoff_grows_and_forget_resets(impl):
    Queue, Request = impl
    q = Queue(base_delay=0.05, max_delay=0.2)
    r = Request("ns", "a")
    q.add_rate_limited(r)  # 0.05
    assert q.get(timeout=1.0) == r
    q.done(r)
    q.add_rate_limited(r)  # 0.1
    t0 = time.monotonic()
    assert q.get(timeout=1.0) == r
    assert time.monotonic() - t0 >= 0.08
    q.done(r)
    q.forget(r)
    q.add_rate_limited(r)  # back to 0.05
    t0 = time.monotonic()
    assert q.get(timeout=1.0) == r
    assert time.monotonic() - t0 < 0.09
    q.done(r)


def test_processing_key_parks_readds_until_done(impl):
    Queue, Request = impl
    q = Queue()
    r = Request("ns", "a")
    q.add(r)
    assert q.get(timeout=0.5) == r
    q.add(r)  # a watch event during the reconcile
    assert q.get(timeout=0.1) is None  # parked: no concurrent delivery
    q.done(r)
    assert q.get(timeout=0.5) == r  # fires after done
    q.done(r)
    assert q.get(timeout=0.05) is None


def test_dirty_readd_keeps_earliest_delay(impl):
    Queue, Request = impl
    q = Queue()
    r = Request("ns", "a")
    q.add(r)
    assert q.get(timeout=0.5) == r
    q.add(r, delay=0.3)   # the worker's backoff requeue
    q.done(r)
    assert q.get(timeout=0.05) is None  # still honoring the delay
    assert q.get(timeout=1.0) == r
    q.done(r)


def _script(Queue, Request):
    """One script of adds (immediate, delayed, rate-limited, repeated)
    with the order the queue hands the keys out in, and its backlog."""
    # Delays 0.2 s apart: the order holds through a pause of the test
    # process shorter than that.
    q = Queue(base_delay=0.1, max_delay=0.4)
    rng = random.Random(7)
    keys = [Request("ns", f"k{i}") for i in range(12)]
    for r in keys:
        q.add(r, delay=rng.choice([0.0, 0.2, 0.4, 0.6]))
    q.add(keys[2])                       # supersedes its delayed entry
    q.add_rate_limited(keys[1])          # 0.1 s, earlier than its 0.2 s
    q.add(keys[7], delay=0.8)            # a later duplicate is dropped
    backlog = q.pending()
    order = []
    while (r := q.get(timeout=0.5)) is not None:
        order.append(r.name)
        if r.name == "k11" and order.count("k11") == 1:
            q.add(r)                     # parked while processing
            q.add_rate_limited(r)
        q.done(r)
    q.shut_down()
    assert q.get(timeout=0.05) is None
    return order, backlog


def test_same_script_same_order_as_the_reference():
    ref = _script(*QUEUES["reference"])
    port = _script(*QUEUES["port"])
    assert port == ref
    order, backlog = port
    assert backlog == 12 and order.count("k11") == 2 and len(order) == 13
    assert order[:8] == ["k3", "k4", "k5", "k7", "k9", "k10", "k2", "k1"]


def test_named_queue_writes_the_workqueue_series():
    q = controller.make_workqueue(name="wq-series-test")
    r = controller.Request("ns", "a")
    q.add(r)
    q.add_rate_limited(r)
    assert q.get(timeout=0.5) == r
    q.done(r)
    q.shut_down()
    assert metrics.workqueue_adds_total.sample(name="wq-series-test") == 2
    assert metrics.workqueue_retries_total.sample(name="wq-series-test") == 1
    page = metrics.render()
    assert ('workqueue_queue_duration_seconds_count'
            '{name="wq-series-test"} 1') in page
    assert ('workqueue_work_duration_seconds_count'
            '{name="wq-series-test"} 1') in page


def test_port_queue_per_key_exclusion_under_fire():
    """Producers add, delay, back off and forget 300 keys while consumers
    hold each key briefly: no key is ever out twice, none is lost, and
    shutdown ends every thread."""
    q = controller._WorkQueue(base_delay=0.001, max_delay=0.01)
    keys = [controller.Request("ns", f"nb-{i}") for i in range(300)]
    in_flight = defaultdict(int)
    processed = defaultdict(int)
    lock = threading.Lock()
    stop = threading.Event()
    violations = []

    def producer(seed):
        rng = random.Random(seed)
        while not stop.is_set():
            r = rng.choice(keys)
            if rng.random() < 0.2:
                q.add_rate_limited(r)
            else:
                q.add(r, delay=rng.choice([0.0, 0.0, 0.002]))
            if rng.random() < 0.1:
                q.forget(r)

    def consumer():
        while True:
            r = q.get(timeout=0.05)
            if r is None:
                if stop.is_set():
                    return
                continue
            with lock:
                in_flight[r] += 1
                if in_flight[r] > 1:
                    violations.append(r)
            time.sleep(random.random() * 0.001)
            with lock:
                in_flight[r] -= 1
                processed[r] += 1
            q.done(r)

    for r in keys:
        q.add(r)
    threads = ([threading.Thread(target=producer, args=(i,), daemon=True)
                for i in range(4)]
               + [threading.Thread(target=consumer, daemon=True)
                  for _ in range(6)])
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    q.shut_down()
    assert not any(t.is_alive() for t in threads)
    assert not violations, f"concurrent processing of {set(violations)}"
    assert len(processed) == len(keys)


@pytest.mark.parametrize("workers", [1, 4, 8])
def test_controller_reconciles_each_key_once_at_a_time(workers):
    """A port ``Controller`` under a storm of watch events on 200
    Notebooks: one reconcile a key at a time at any worker count, and
    every key reconciled."""
    kube = FakeKube()
    kube.add_namespace("ns")
    lock = threading.Lock()
    in_flight = defaultdict(int)
    counts = defaultdict(int)
    violations = []

    class Probe(controller.Reconciler):
        def reconcile(self, req):
            with lock:
                in_flight[req] += 1
                if in_flight[req] > 1:
                    violations.append(req)
            time.sleep(random.random() * 0.001)
            with lock:
                in_flight[req] -= 1
                counts[req] += 1

    ctrl = controller.Controller("stress", Probe(), primary=NOTEBOOK,
                                 workers=workers)
    assert ctrl.workers == workers
    names = [f"nb-{i}" for i in range(200)]
    ctrl.start(kube)
    try:
        for name in names:
            kube.create({
                "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                "metadata": {"name": name, "namespace": "ns"},
                "spec": {"template": {"spec": {"containers": [
                    {"name": name, "image": "i"}]}}}})
        rng = random.Random(workers)
        deadline = time.monotonic() + 0.8
        while time.monotonic() < deadline:
            nb = kube.get(NOTEBOOK, rng.choice(names), "ns")
            nb["metadata"]["annotations"] = {"touch": str(rng.random())}
            kube.update(nb)
        deadline = time.monotonic() + 20
        while len(counts) < len(names) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        ctrl.stop()
    assert not violations, f"concurrent reconcile of {set(violations)}"
    assert len(counts) == len(names)
    assert ctrl.reconcile_count >= len(names)
