"""The port's GPUJob queue (``platform/runtime/jobqueue.py`` ``JobQueue``
and the reconciler's admission, preemption and elastic resume) against
the reference's TPUJob queue: the reference's queue cases, each run
through both packages on the same script of jobs, nodes, quotas and
InferenceServices.  Decisions (action, width, reason and message, in the
port's words), the waiting order, the victims and every status
transition are equal; the worlds are ``test_torch_gpujob.World``.

Left out: the reference's sharded replica kill, which waits for the
port's sharded controller runtime.  The priority storm runs on the bare
reconcilers without the reference's chaos proxy (not ported)."""
import time

import pytest

from kubeflow_tpu.platform.apis import inferenceservice as ref_svcapi
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu_torch.platform.apis import inferenceservice as svcapi
from kubeflow_tpu_torch.platform.gpu import pods, slice_spec
from kubeflow_tpu_torch.platform.runtime import jobqueue as jq
from kubeflow_tpu_torch.platform.runtime import metrics
from test_torch_gpujob import gpu_words, same, worlds

NS = "fleet"


def decision(w, q, name, ns=NS):
    d = q.decide(ns, name)
    out = (d.action, d.slices, d.reason, d.message)
    return out if w.port else gpu_words(out)


def both_decide(queues, name, ns=NS):
    """The decision for ``name`` in both queues, equal; returned."""
    (ref, rq), (port, pq) = queues
    got, want = decision(port, pq, name, ns), decision(ref, rq, name, ns)
    assert got == want
    return got


def queues(nodes=None, quota=None, **jobs):
    """A bare queue in each world, fed the same nodes (count, topology),
    quota and waiting jobs."""
    out = []
    for w in worlds():
        q = w.jq.JobQueue()
        if nodes is not None:
            q.set_nodes([w.node(f"n{i}", nodes[1]) for i in range(nodes[0])])
        if quota is not None:
            q.set_quotas([w.quota(quota)])
        for name, kw in jobs.items():
            q.observe(w.make_job(name, **kw))
        out.append((w, q))
    return out


def admitted_job(w, name, alloc, **kw):
    job = w.make_job(name, **kw)
    job["status"] = {"phase": "Running", "allocatedSlices": alloc,
                     "generation": 0, "restarts": 0}
    return job


def observe_both(qs, fn):
    for w, q in qs:
        q.observe(fn(w))


def service(w, name, replicas, **status):
    block = ({"accelerator": "h100-80gb", "gpus": 8} if w.port
             else {"accelerator": "v5e", "topology": "2x4"})
    return {"apiVersion": "kubeflow.org/v1alpha1", "kind": "InferenceService",
            "metadata": {"name": name, "namespace": NS},
            "spec": {"model": "llama_125m",
                     "gpu" if w.port else "tpu": block},
            "status": {"phase": "Ready", "replicas": replicas, **status}}


# -- ledger units ---------------------------------------------------------------


def test_rank_is_priority_then_fifo_then_name():
    qs = queues(**{
        "b": dict(priority=100, created="2026-01-01T00:00:01Z"),
        "a": dict(priority=100, created="2026-01-01T00:00:02Z"),
        "z": dict(priority=500, created="2026-01-01T00:00:09Z"),
        "c": dict(priority=100, created="2026-01-01T00:00:01Z")})
    orders = [[key for _r, key in q._waiting] for _w, q in qs]
    assert orders[1] == orders[0] == ["fleet/z", "fleet/b", "fleet/c",
                                      "fleet/a"]


def test_k_max_is_elastic_against_pool_and_quota():
    qs = queues(nodes=(3, "2x4"), quota=16,
                big=dict(slices=4, min_slices=1))
    ks = [q._k_max(q._entries["fleet/big"].demand) for _w, q in qs]
    assert ks[1] == ks[0] == 2
    assert both_decide(qs, "big")[:2] == ("admit", 2)


def test_quota_counts_other_consumers_stored_usage():
    qs = queues(**{"wants-four": dict(slices=4, min_slices=1)})
    for used, want in (("24", ("admit", 1)),
                       ("32", ("wait", 0, jq.REASON_QUOTA))):
        for w, q in qs:
            quota = w.quota(32)
            quota["status"] = {"used": {w.device_key: used}}
            q.set_quotas([quota])
        got = both_decide(qs, "wants-four")
        assert got[:len(want)] == want


def test_serving_charges_park_and_lift_a_gang():
    """An InferenceService's replica GPUs (``gpus_of``) are declared
    charges in the same ledger: a scale-up parks the gang with the quota
    reason, a scale-down lifts it."""
    qs = queues(quota=32, train=dict(slices=2))
    for replicas, want in ((2, "admit"), (3, "wait"), (1, "admit")):
        for w, q in qs:
            q.observe_service(service(w, "llm", replicas))
        got = both_decide(qs, "train")
        assert got[0] == want
        if want == "wait":
            assert got[2] == jq.REASON_QUOTA and "committed" in got[3]
    for w, q in qs:
        q.forget_service(NS, "llm")
    assert both_decide(qs, "train")[:2] == ("admit", 2)


def test_a_rollout_charges_both_revisions():
    ref_svc, port_svc = (service(w, "llm", 2) for w in worlds())
    assert svcapi.gpus_of(port_svc) == ref_svcapi.chips_of(ref_svc) == 16.0
    for svc in (ref_svc, port_svc):
        svc["status"].update(targetRevision=2, revision=1)
    assert svcapi.gpus_of(port_svc) == ref_svcapi.chips_of(ref_svc) == 32.0
    qs = queues(quota=32, train=dict(slices=1))
    for (w, q), svc in zip(qs, (ref_svc, port_svc)):
        q.observe_service(svc)
    assert both_decide(qs, "train")[:3] == ("wait", 0, jq.REASON_QUOTA)


def test_the_serving_charge_survives_a_rebuild():
    out = []
    for w in worlds():
        quotas, svc = [w.quota(32)], service(w, "llm", 3)
        job = w.make_job("train", slices=2)
        inc = w.jq.JobQueue()
        inc.set_quotas(quotas)
        inc.observe_service(svc)
        inc.observe(job)
        full = w.jq.JobQueue()
        full.refresh([job], quotas, [], [svc])
        for q in (inc, full):
            out.append(decision(w, q, "train"))
        out.append(full.snapshot() if w.port else gpu_words(full.snapshot()))
    assert out[3:] == out[:3]
    assert out[0][2] == jq.REASON_QUOTA
    assert out[5]["inferenceServiceGpus"] == {"fleet/llm": 24.0}
    assert out[5]["namespaceCommittedGpus"] == {"fleet": 24.0}


def test_serving_spec_fields_build_the_replicas_deployment():
    """The port's ``pods.serving_deployment`` over the InferenceService's
    fields equals the reference controller's Deployment but for the
    device fields and the owner reference."""
    from kubeflow_tpu.platform.controllers.inferenceservice import (
        InferenceServiceReconciler,
    )
    from kubeflow_tpu.platform.testing import FakeKube as RefKube

    ref_w, port_w = worlds()
    fields = dict(port=9000, checkpointDir="/ckpt", quantize="int8",
                  maxSeqLen=2048, image="server:1")
    ref_svc, port_svc = (service(w, "llm", 2) for w in (ref_w, port_w))
    for svc in (ref_svc, port_svc):
        svc["spec"].update(fields)
    ref_svcapi.validate(ref_svc)
    svcapi.validate(port_svc)
    ref_svc["metadata"]["uid"] = "u1"
    want = InferenceServiceReconciler(RefKube()).generate_deployment(
        ref_svc, 3, 2)
    got = pods.serving_deployment(
        ns=NS, name="llm", revision=3, replicas=2,
        model=svcapi.model_of(port_svc), spec=svcapi.gpu_slice(port_svc),
        image=port_svc["spec"]["image"], port=svcapi.port_of(port_svc),
        checkpoint_dir=svcapi.checkpoint_dir_of(port_svc),
        quantize=port_svc["spec"]["quantize"],
        max_seq_len=port_svc["spec"]["maxSeqLen"])
    want["metadata"].pop("ownerReferences")
    for dep, key in ((want, "google.com/tpu"), (got, "nvidia.com/gpu")):
        pod = dep["spec"]["template"]["spec"]
        pod.pop("nodeSelector")
        main = pod["containers"][0]
        for flavor in ("limits", "requests"):
            assert main["resources"][flavor].pop(key) == "8"
        main["command"] = main["command"][3:]   # past "python -m <module>"
        main["env"] = [e for e in main["env"]
                       if e["name"] != "KFT_GPUS_PER_HOST"]
    assert got == want
    assert svcapi.gpus_of(port_svc) == 16.0
    for bad in ({"gpus": 16}, {"slices": 2}):
        svc = service(port_w, "llm", 1)
        svc["spec"]["gpu"].update(bad)
        with pytest.raises(svcapi.ValidationError):
            svcapi.validate(svc)
    assert slice_spec("h100-80gb", 8).num_hosts == 1


def test_an_unknown_pool_is_unlimited_but_an_empty_pool_blocks():
    qs = queues(nofeed=dict(slices=3))
    assert both_decide(qs, "nofeed")[:2] == ("admit", 3)
    qs = queues(nodes=(1, "2x4"), toobig=dict(slices=3, min_slices=2))
    got = both_decide(qs, "toobig")
    assert got[:3] == ("wait", 0, jq.REASON_CAPACITY)
    assert got[3] == "pool h100-80gb/8: 1 free slice slot(s), need 2"


def test_head_of_line_blocks_only_behind_an_admissible_head():
    qs = queues(nodes=(2, "2x4"),
                head=dict(slices=4, min_slices=4, priority=200,
                          created="2026-01-01T00:00:01Z"),
                small=dict(slices=1, priority=100,
                           created="2026-01-01T00:00:02Z"))
    assert both_decide(qs, "head")[2] == jq.REASON_CAPACITY
    assert both_decide(qs, "small")[0] == "admit"
    for w, q in qs:
        q.set_nodes([w.node(f"n{i}") for i in range(4)])
    assert both_decide(qs, "head")[0] == "admit"
    assert both_decide(qs, "small")[2] == jq.REASON_QUEUED_BEHIND


def test_preemption_picks_the_lowest_priority_youngest_minimal_set():
    qs = queues(nodes=(4, "2x4"))
    for name, prio, alloc, created in (
            ("old-low", 50, 1, "2026-01-01T00:00:01Z"),
            ("young-low", 50, 1, "2026-01-01T00:00:05Z"),
            ("mid", 100, 2, "2026-01-01T00:00:02Z")):
        observe_both(qs, lambda w: admitted_job(
            w, name, alloc, priority=prio, slices=alloc, created=created))
    observe_both(qs, lambda w: w.make_job(
        "high", priority=500, slices=1, min_slices=1,
        created="2026-01-01T00:00:09Z"))
    for name, want in (("young-low", ("fleet/high", "priority")),
                       ("old-low", None), ("mid", None)):
        assert [q.should_yield(NS, name) for _w, q in qs] == [want] * 2
    got = both_decide(qs, "high")
    assert got[2:] == (jq.REASON_AWAITING_PREEMPTION,
                       "preempting fleet/young-low")


def test_preemption_skips_victims_that_relax_no_binding_constraint():
    """A pool-blocked head never evicts a gang of another pool that only
    shares its namespace.  (The reference's pools are 2x4 and 4x4; on the
    card's side those are one pool, so 2x2 stands for the other.)"""
    qs = queues()
    for w, q in qs:
        q.set_nodes([w.node("a", "2x4"), w.node("b", "2x2"),
                     w.node("c", "2x2")])
    observe_both(qs, lambda w: admitted_job(
        w, "other-pool", 1, priority=10, topology="2x2",
        created="2026-01-01T00:00:05Z"))
    observe_both(qs, lambda w: admitted_job(
        w, "same-pool", 1, priority=50, created="2026-01-01T00:00:01Z"))
    observe_both(qs, lambda w: w.make_job("head", priority=500))
    assert [q.should_yield(NS, "same-pool") for _w, q in qs] == \
        [("fleet/head", "priority")] * 2
    assert [q.should_yield(NS, "other-pool") for _w, q in qs] == [None] * 2


def test_equal_priority_never_preempts():
    qs = queues(nodes=(1, "2x4"))
    observe_both(qs, lambda w: admitted_job(w, "incumbent", 1,
                                            priority=100))
    observe_both(qs, lambda w: w.make_job("rival", priority=100))
    assert [q.should_yield(NS, "incumbent") for _w, q in qs] == [None] * 2
    assert both_decide(qs, "rival")[2] == jq.REASON_CAPACITY


def test_a_capacity_shrink_yields_the_lowest_ranked_gang():
    qs = queues(nodes=(2, "2x4"))
    for name, prio in (("keep", 200), ("shed", 50)):
        observe_both(qs, lambda w: admitted_job(
            w, name, 1, priority=prio, min_slices=1))
    assert [q.should_yield(NS, "shed") for _w, q in qs] == [None] * 2
    for w, q in qs:
        q.set_nodes([w.node("n0")])
    assert [q.should_yield(NS, "shed") for _w, q in qs] == \
        [("", "capacity")] * 2
    assert [q.should_yield(NS, "keep") for _w, q in qs] == [None] * 2


def test_incremental_observe_matches_a_full_rebuild():
    results = []
    for w in worlds():
        w.add_nodes(3)
        w.kube.create(w.quota(24))
        inc = w.jq.JobQueue()
        inc.set_nodes(w.kube.list(w.types.NODE, None))
        inc.set_quotas(w.kube.list(w.types.RESOURCEQUOTA, None))
        for i in range(8):
            w.kube.create(w.make_job(f"j{i}", slices=1 + i % 2,
                                     min_slices=1,
                                     priority=(i % 3 + 1) * 100))
            inc.observe(w.job(f"j{i}"))
        full = w.jq.JobQueue(w.kube)
        full.ensure_fresh()
        assert [k for _r, k in inc._waiting] == \
            [k for _r, k in full._waiting]
        for name in ("j0", "j3", "j7"):
            assert decision(w, inc, name) == decision(w, full, name)
        assert inc.depth_by_namespace() == full.depth_by_namespace()
        assert inc.allocated_total() == full.allocated_total()
        results.append(([k for _r, k in full._waiting],
                        [decision(w, full, f"j{i}") for i in range(8)]))
    assert results[1] == results[0]


def test_the_snapshot_equals_the_references():
    qs = queues(nodes=(2, "2x4"), quota=64,
                **{"waiting-job": dict(slices=2, min_slices=1,
                                       priority=300)})
    observe_both(qs, lambda w: admitted_job(w, "running-job", 2, slices=2))
    (ref, rq), (port, pq) = qs
    snap, want = pq.snapshot(), rq.snapshot()
    want["pools"] = {k: {"hosts": v["hosts"],
                         "product": "NVIDIA-H100-80GB-HBM3"}
                     for k, v in want["pools"].items()}
    assert snap == gpu_words(want)
    assert snap["waiting"][0]["key"] == "fleet/waiting-job"
    assert snap["admitted"][0]["allocatedSlices"] == 2
    assert snap["pools"] == {"h100-80gb/8": {
        "hosts": 2, "product": "NVIDIA-H100-80GB-HBM3"}}


# -- controller flows ---------------------------------------------------------------


def flow_worlds(slots, quota=None):
    """Both worlds with ``slots`` one-slice nodes, the reference tests'
    short preemption grace and queue poll, and a quota of ``quota``."""
    out = worlds()
    for w in out:
        w.defaults = dict(preemption_grace=0.05, queue_poll=0.05)
        w.add_nodes(slots)
        if quota is not None:
            w.kube.create(w.quota(quota))
    return out


def each(ws, fn):
    for w in ws:
        fn(w)


def test_a_job_parks_queued_with_its_reason_then_admits():
    ws = flow_worlds(1)
    ref, port = ws
    each(ws, lambda w: w.kube.create(w.make_job("holder")))
    each(ws, lambda w: w.drive(["holder"]))
    each(ws, lambda w: w.kube.create(w.make_job("parked")))
    results = [w.reconcile("parked") for w in ws]
    assert results[1].requeue_after == results[0].requeue_after == 0.05
    got = port.view(["holder", "parked"])
    assert got == ref.view(["holder", "parked"])
    parked = got["status"]["parked"]
    assert (parked["phase"], parked["reason"]) == ("Queued",
                                                   jq.REASON_CAPACITY)
    assert "free slice slot" in parked["conditions"][0]["message"]
    assert port.job("parked")["status"]["queuedAt"] > 0
    assert [s["metadata"]["name"] for s in got["StatefulSet"]] == ["holder"]
    each(ws, lambda w: (w.run_gang("holder"), w.drive(["holder"]),
                        w.finish_gang("holder"),
                        w.drive(["holder", "parked"])))
    got = port.view(["holder", "parked"])
    assert got == ref.view(["holder", "parked"])
    parked = got["status"]["parked"]
    assert parked["allocatedSlices"] == 1
    assert "reason" not in parked and "conditions" not in parked
    assert [s["metadata"]["name"] for s in got["StatefulSet"]] == ["parked"]


def _selected(nodes, selector):
    """The names of the nodes whose labels match ``selector``."""
    return sorted(n["metadata"]["name"] for n in nodes
                  if all(n["metadata"]["labels"].get(k) == v
                         for k, v in selector.items()))


def test_a_gangs_pods_select_the_pool_it_is_charged_to():
    """On two 8-GPU nodes and one 4-GPU node, 1-, 4- and 8-GPU jobs admit
    and park as the reference's 1x1, 2x2 and 2x4 slices do on the same
    nodes.  Each gang's pods select exactly the nodes of the pool the
    queue charges it to, so no pool holds more pods than nodes, a small
    job takes no node of a larger pool, and the job of a pool without
    nodes (unlimited, as the reference's) selects none."""
    ref, port = worlds()
    jobs = [("one", "1x1"), ("four-a", "2x2"), ("four-b", "2x2"),
            ("eight-a", "2x4"), ("eight-b", "2x4"), ("eight-c", "2x4")]
    names = [name for name, _ in jobs]
    for w in (ref, port):
        w.add_nodes(2, "2x4", prefix="big")
        w.add_nodes(1, "2x2", prefix="small")
        for i, (name, topo) in enumerate(jobs):
            w.kube.create(w.make_job(name, topology=topo,
                                     created=f"2026-01-01T00:00:0{i}Z"))
        w.drive(names, rounds=2)
    got = same(ref, port, names)
    parked = {n: (s.get("allocatedSlices"), s.get("reason"))
              for n, s in got["status"].items()}
    assert parked == {"one": (1, None), "four-a": (1, None),
                      "four-b": (None, jq.REASON_CAPACITY),
                      "eight-a": (1, None), "eight-b": (1, None),
                      "eight-c": (None, jq.REASON_CAPACITY)}
    want = {"one": [], "four-a": ["small-1"],
            "eight-a": ["big-1", "big-2"], "eight-b": ["big-1", "big-2"]}
    q = jq.JobQueue()
    q.set_nodes(port.kube.list(port.types.NODE))
    for w in (ref, port):
        nodes = w.kube.list(w.types.NODE)
        stses = w.kube.list(w.types.STATEFULSET, w.ns)
        assert {s["metadata"]["name"]: _selected(
            nodes, s["spec"]["template"]["spec"]["nodeSelector"])
            for s in stses} == want
    for name, selected in want.items():
        pool = jq.demand_of(port.job(name)).pool
        assert q._pool_hosts.get(pool, 0) == len(selected)


def test_the_queue_drains_in_priority_then_fifo_order():
    ws = flow_worlds(1)
    names = ["holder", "fifo-1", "fifo-2", "vip"]
    orders = []
    for w in ws:
        w.kube.create(w.make_job("holder"))
        w.drive(["holder"])
        w.run_gang("holder")
        for name, prio, sec in (("fifo-1", 100, 1), ("fifo-2", 100, 2),
                                ("vip", 400, 9)):
            w.kube.create(w.make_job(name, priority=prio,
                                     created=f"2026-01-01T00:00:0{sec}Z"))
        w.drive(names)
        assert [w.phase(n) for n in names[1:]] == ["Queued"] * 3
        order = []

        def drain_one(finishing):
            w.finish_gang(finishing)
            w.drive(names)
            for n in ("vip", "fifo-1", "fifo-2"):
                if n not in order and w.alloc(n) is not None:
                    order.append(n)
                    w.run_gang(n)
                    w.drive(names)

        drain_one("holder")
        drain_one(order[0])
        drain_one(order[1])
        orders.append(order)
    assert orders[1] == orders[0] == ["vip", "fifo-1", "fifo-2"]
    assert ws[1].view(names) == ws[0].view(names)


def test_a_quota_park_reports_insufficient_quota_and_lifts():
    ws = flow_worlds(4, quota=8)
    ref, port = ws
    each(ws, lambda w: (w.kube.create(w.make_job("first")),
                        w.drive(["first"]),
                        w.kube.create(w.make_job("second")),
                        w.drive(["second"])))
    got = port.view(["first", "second"])
    assert got == ref.view(["first", "second"])
    assert got["status"]["second"]["reason"] == jq.REASON_QUOTA
    for w in ws:
        quota = w.kube.get(w.types.RESOURCEQUOTA, "kf-resource-quota", NS)
        quota["spec"]["hard"][w.device_key] = "16"
        w.kube.update(quota)
        w.drive(["second"])
    assert port.view(["first", "second"]) == ref.view(["first", "second"])
    assert port.alloc("second") == 1


def test_two_phase_preemption_checkpoints_then_frees_never_half_admits():
    ws = flow_worlds(2)
    ref, port = ws
    names = ["victim", "vip"]
    for w in ws:
        w.kube.create(w.make_job("victim", slices=2, min_slices=1,
                                 priority=50, checkpoint_dir="/ckpt/victim"))
        w.drive(["victim"])
        w.run_gang("victim")
        w.drive(["victim"])
        assert w.phase("victim") == "Running"
        w.kube.create(w.make_job("vip", slices=2, min_slices=2,
                                 priority=500))
        w.reconcile("vip")
    got = same_view(ws, names)
    assert (got["status"]["vip"]["phase"],
            got["status"]["vip"]["reason"]) == \
        ("Queued", jq.REASON_AWAITING_PREEMPTION)
    each(ws, lambda w: w.reconcile("victim"))
    got = same_view(ws, names)
    victim = got["status"]["victim"]
    assert (victim["phase"], victim["allocatedSlices"]) == ("Preempting", 2)
    assert victim["preemption"] == {"by": "fleet/vip", "reason": "priority"}
    assert got["StatefulSet"] == []
    each(ws, lambda w: w.reconcile("vip"))
    got = same_view(ws, names)
    assert "allocatedSlices" not in got["status"]["vip"]
    time.sleep(0.08)
    each(ws, lambda w: w.drive(names))
    got = same_view(ws, names)
    victim = got["status"]["victim"]
    assert victim["phase"] == "Queued" and "allocatedSlices" not in victim
    assert victim["reason"] in (jq.REASON_PREEMPTED, jq.REASON_CAPACITY)
    assert (victim["restarts"], victim["generation"]) == (0, 0)
    assert got["status"]["vip"]["allocatedSlices"] == 2
    assert [s["metadata"]["name"] for s in got["StatefulSet"]] == \
        ["vip", "vip-s1"]


def same_view(ws, names):
    ref, port = ws
    got = port.view(names)
    assert got == ref.view(names)
    return got


def test_a_preempted_job_resumes_elastically_then_grows_back():
    ws = flow_worlds(3)
    ref, port = ws
    names = ["low", "vip"]
    for w in ws:
        w.kube.create(w.make_job("low", slices=3, min_slices=1, priority=50,
                                 checkpoint_dir="/ckpt/low"))
        w.drive(["low"])
        w.run_gang("low")
        w.drive(["low"])
        w.kube.create(w.make_job("vip", slices=2, priority=500))
        w.drive(names)
    time.sleep(0.08)
    for w in ws:
        w.drive(names)
        w.run_gang("vip")
        w.drive(names)
    got = same_view(ws, names)
    low = got["status"]["low"]
    assert (low["allocatedSlices"], low["generation"], low["restarts"]) == \
        (1, 1, 0)
    env = {e["name"]: e.get("value") for e in port.kube.get(
        port.types.STATEFULSET, "low", NS)["spec"]["template"]["spec"][
            "containers"][0]["env"]}
    assert (env["MEGASCALE_NUM_SLICES"], env["KFT_SPEC_SLICES"]) == \
        ("1", "3")
    each(ws, lambda w: (w.run_gang("low"), w.drive(names)))
    assert same_view(ws, names)["status"]["low"]["phase"] == "Running"
    each(ws, lambda w: (w.finish_gang("vip"), w.drive(names)))
    time.sleep(0.08)
    each(ws, lambda w: w.drive(names))
    got = same_view(ws, names)
    low = got["status"]["low"]
    assert (low["allocatedSlices"], low["generation"], low["restarts"]) == \
        (3, 2, 0)
    for s in ("low", "low-s1", "low-s2"):
        env = {e["name"]: e.get("value") for e in port.kube.get(
            port.types.STATEFULSET, s, NS)["spec"]["template"]["spec"][
                "containers"][0]["env"]}
        assert env["MEGASCALE_NUM_SLICES"] == "3"


def test_a_crashlooping_high_priority_job_cannot_starve_the_queue():
    ws = flow_worlds(1)
    names = ["looper", "patient"]
    for w in ws:
        w.kube.create(w.make_job("looper", priority=900, backoff_limit=1))
        w.kube.create(w.make_job("patient", priority=100))
        w.drive(names)
        assert (w.alloc("looper"), w.phase("patient")) == (1, "Queued")
        for _ in range(2):
            w.run_gang("looper")
            w.finish_gang("looper", "Failed")
            w.drive(names)
    got = same_view(ws, names)
    assert (got["status"]["looper"]["phase"],
            got["status"]["looper"]["restarts"]) == ("Failed", 1)
    assert (got["status"]["patient"]["phase"],
            got["status"]["patient"]["allocatedSlices"]) == ("Pending", 1)


def test_the_queue_survives_a_controller_restart():
    """Every decision input lives in statuses, quotas and nodes: a fresh
    reconciler (a fresh ledger) each pass reaches the same schedule."""
    ws = flow_worlds(1)
    names = ["holder", "waiter-b", "waiter-a"]
    for w in ws:
        for name, sec in (("holder", 0), ("waiter-b", 2), ("waiter-a", 1)):
            w.kube.create(w.make_job(name,
                                     created=f"2026-01-01T00:00:0{sec}Z"))
        w.drive(["holder", "waiter-a", "waiter-b"])
        assert w.alloc("holder") == 1
        w.run_gang("holder")
        w.finish_gang("holder")
        w.drive(names)
    got = same_view(ws, names)
    assert got["status"]["waiter-a"]["allocatedSlices"] == 1
    assert got["status"]["waiter-b"]["phase"] == "Queued"


def test_queue_metrics_depth_wait_preemptions_allocated():
    def reads(w):
        """(priority preemptions, queue waits observed, queue depth of the
        namespace, slices allocated)."""
        if w.port:
            return (metrics.gpujob_preemptions_total.sample(
                        reason="priority") or 0.0,
                    metrics.gpujob_queue_wait_seconds._only().count,
                    metrics.gpujob_queue_depth.sample(profile=NS),
                    metrics.gpujob_slices_allocated.sample())
        return (ref_metrics.tpujob_preemptions_total.labels(
                    reason="priority")._value.get(),
                sum(b.get() for b in
                    ref_metrics.tpujob_queue_wait_seconds._buckets),
                ref_metrics.tpujob_queue_depth.labels(
                    profile=NS)._value.get(),
                ref_metrics.tpujob_slices_allocated._value.get())

    ws = flow_worlds(1)
    names = ["m-holder", "m-waiter"]
    deltas = []
    for w in ws:
        w.kube.create(w.make_job("m-holder", priority=50))
        w.drive(["m-holder"])
        w.run_gang("m-holder")
        before = reads(w)
        w.kube.create(w.make_job("m-waiter", priority=100))
        w.drive(names)
        mid = reads(w)
        assert (mid[2], mid[3]) == (1.0, 1.0)
        time.sleep(0.08)
        w.drive(names)
        after = reads(w)
        assert w.alloc("m-waiter") == 1
        assert after[2] == 1.0   # the evicted holder re-queued
        deltas.append((after[0] - before[0], after[1] - before[1]))
    assert deltas[1] == deltas[0] == (1.0, 1)
    page = metrics.render()
    for series in ("gpujob_queue_depth{profile=\"fleet\"} 1.0",
                   "gpujob_slices_allocated 1.0",
                   "gpujob_queue_wait_seconds_count"):
        assert series in page
    port = ws[1]
    metrics.register_gpujob_collector(port.kube)
    try:
        page = metrics.render()
    finally:
        metrics.register_gpujob_collector(None)
    assert 'gpujob_jobs{phase="Pending"} 1.0' in page
    assert 'gpujob_jobs{phase="Queued"} 1.0' in page
    assert 'gpujob_slices{namespace="fleet"} 1.0' in page
    assert "gpujob_jobs{" not in metrics.render()


def test_a_priority_storm_drains_in_order():
    """Nine jobs of three priorities into a budget of two slots held by
    two unpreemptable holders, driven level-triggered with the gangs
    finishing as they run: both queues admit in priority-then-FIFO order
    and every job succeeds."""
    ws = flow_worlds(2)
    prios = [100, 100, 100, 300, 300, 300, 500, 500, 500]
    names = [f"sj-{p}-{i}" for i, p in enumerate(prios)]
    orders = []
    for w in ws:
        for h in range(2):
            w.kube.create(w.make_job(f"holder-{h}", priority=900))
        w.drive(["holder-0", "holder-1"], rounds=2)
        for i, (name, p) in enumerate(zip(names, prios)):
            w.kube.create(w.make_job(name, priority=p,
                                     created=f"2026-01-01T00:00:{i:02d}Z"))
        everyone = ["holder-0", "holder-1"] + names
        order = []
        for _ in range(40):
            w.drive(everyone, rounds=1)
            for name in names:
                if name not in order and w.alloc(name) is not None:
                    order.append(name)
            for name in everyone:
                if w.phase(name) == "Pending":
                    w.run_gang(name)
                elif w.phase(name) == "Running":
                    w.finish_gang(name)
            if all(w.phase(n) == "Succeeded" for n in everyone):
                break
        assert all(w.phase(n) == "Succeeded" for n in everyone)
        orders.append(order)
    want = sorted(names, key=lambda n: (-int(n.split("-")[1]),
                                        int(n.split("-")[2])))
    assert orders[1] == orders[0] == want
