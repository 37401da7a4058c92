"""The port's GPU goodput accountant (``kubeflow_tpu_torch/telemetry/
goodput.py``) against the JAX package's, mirroring ``tests/ctrlplane/
test_goodput.py``: the same GPUJob and TPUJob states (8 GPUs a slice
beside a 2x4 v5e slice of 8 chips) and InferenceService states go
through each package's decompositions and accountant on a fake clock,
and the per-state seconds, the ratio and the tiling must be equal.  The
port's names: ``WorkloadUse.gpus`` is the reference's ``chips``, the
snapshot's ``*GpuSeconds`` its ``*ChipSeconds``, and the series
``gpu_seconds_total``/``gpu_goodput_ratio`` its ``tpu_chip_seconds_total``/
``tpu_goodput_ratio``.  The tiling ``allocated == goodput + queued +
restarting + idle`` is held to 1e-9 relative."""
import json

import numpy as np
import pytest

from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.telemetry import goodput as ref_gp
from kubeflow_tpu.telemetry.tsdb import TSDB as RefTSDB
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.telemetry import goodput as gp
from kubeflow_tpu_torch.telemetry.tsdb import TSDB

PHASES = ("Pending", "Running", "Restarting", "Preempting", "Succeeded",
          "Failed", "Queued")


def job(torch, *, ns="team-a", phase="Running", alloc=2, ready=None,
        total=None, slices=2, name="j"):
    status = {"phase": phase, "generation": 0, "restarts": 0}
    if alloc is not None:
        status["allocatedSlices"] = alloc
    if ready is not None:
        status["slices"] = [{"slice": 0, "ready": ready, "total": total}]
    device = ({"gpu": {"accelerator": "h100-80gb", "gpus": 8,
                       "slices": slices}} if torch else
              {"tpu": {"accelerator": "v5e", "topology": "2x4",
                       "slices": slices}})
    return {
        "apiVersion": "kubeflow.org/v1alpha1",
        "kind": "GPUJob" if torch else "TPUJob",
        "metadata": {"name": name, "namespace": ns},
        "spec": {**device,
                 "template": {"spec": {"containers": [
                     {"name": "w", "command": ["train"]}]}}},
        "status": status,
    }


def service(torch, *, ns="team-a", replicas=2, ready=2, name="svc",
            revision=1, target=1):
    device = ({"gpu": {"accelerator": "h100-80gb", "gpus": 8}} if torch
              else {"tpu": {"accelerator": "v5e", "topology": "2x4"}})
    return {
        "apiVersion": "kubeflow.org/v1alpha1", "kind": "InferenceService",
        "metadata": {"name": name, "namespace": ns},
        "spec": {"model": "llama_125m", **device,
                 "replicas": {"min": 1, "max": 4}},
        "status": {"phase": "Ready", "replicas": replicas,
                   "readyReplicas": ready, "revision": revision,
                   "targetRevision": target},
    }


def use_tuple(u):
    if u is None:
        return None
    size = u.gpus if isinstance(u, gp.WorkloadUse) else u.chips
    return (u.profile, size, u.productive, u.queued, u.restarting, u.idle)


def ref_snapshot(snap):
    """The port's snapshot in the reference's words."""
    return json.loads(json.dumps(snap).replace("GpuSeconds", "ChipSeconds"))


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("ready,total", [(None, None), (2, 2), (1, 2),
                                         (0, 2), (3, 2)])
def test_job_use_equals_the_reference(phase, ready, total):
    kw = dict(phase=phase, ready=ready, total=total)
    got = use_tuple(gp.job_use(job(True, **kw)))
    assert got == use_tuple(ref_gp.job_use(job(False, **kw)))
    if phase == "Running" and ready == 2:
        assert got == ("team-a", 16.0, 16.0, 0.0, 0.0, 0.0)
    # Queued and legacy (no allocatedSlices) jobs.
    for alloc in (None, 0, 1):
        kw["alloc"] = alloc
        assert use_tuple(gp.job_use(job(True, **kw))) == \
            use_tuple(ref_gp.job_use(job(False, **kw)))


def test_service_use_occupancy_staleness_and_rollout():
    def dbs():
        out = []
        for db in (TSDB(), RefTSDB()):
            for replica, ts, active in (("p0", 100.0, 4.0),
                                        ("dead", 10.0, 8.0)):
                lab = {"service": "team-a/svc", "replica": replica}
                db.append("serve_decode_slots", lab, 8.0, ts=ts)
                db.append("serve_decode_slots_active", lab, active, ts=ts)
            out.append(db)
        return out

    db, ref_db = dbs()
    for replicas, ready, rev, target in [(2, 1, 1, 1), (1, 1, 1, 1),
                                         (2, 2, 1, 2), (0, 0, 1, 1),
                                         (3, 5, 1, 1)]:
        for staleness in (30.0, 200.0):
            kw = dict(replicas=replicas, ready=ready, revision=rev,
                      target=target)
            got = gp.service_use(service(True, **kw), tsdb=db, at=100.0,
                                 staleness=staleness)
            ref = ref_gp.service_use(service(False, **kw), tsdb=ref_db,
                                     at=100.0, staleness=staleness)
            assert use_tuple(got) == use_tuple(ref)
    got = gp.service_use(service(True, replicas=2, ready=1), tsdb=db,
                         at=100.0, staleness=30.0)
    assert (got.gpus, got.queued, got.productive, got.idle) == \
        (16.0, 8.0, 4.0, 4.0)


def test_tiling_and_clamps_equal_the_reference():
    snaps = []
    for mod in (gp, ref_gp):
        acct = mod.GoodputAccountant(now=lambda: 0.0)
        acct.tick([], at=0.0)
        acct.tick([
            mod.WorkloadUse("p-tile", 16.0, productive=20.0, queued=10.0,
                            restarting=10.0),
            mod.WorkloadUse("p-tile", 8.0, productive=-3.0),
            mod.WorkloadUse("q-tile", 4.0, productive=1.0, queued=1.0),
        ], at=10.0)
        snaps.append(acct.snapshot())
    assert ref_snapshot(snaps[0]) == snaps[1]
    p = snaps[0]["profiles"]
    assert p["p-tile"]["allocatedGpuSeconds"] == pytest.approx(240.0)
    assert p["q-tile"]["goodputRatio"] == pytest.approx(0.25)
    assert all(row["tiles"] for row in p.values())


def test_backwards_clock_never_reintegrates_an_interval():
    snaps = []
    for mod in (gp, ref_gp):
        acct = mod.GoodputAccountant(now=lambda: 0.0)
        use = [mod.WorkloadUse("p-clock", 8.0, productive=8.0)]
        for at in (0.0, 100.0, 95.0, 100.0):
            acct.tick(use, at=at)
        snaps.append(acct.snapshot())
    assert ref_snapshot(snaps[0]) == snaps[1]
    assert snaps[0]["profiles"]["p-clock"]["allocatedGpuSeconds"] == \
        pytest.approx(800.0)


@pytest.mark.parametrize("seed", range(6))
def test_drawn_fleet_on_a_fake_clock_equals_the_reference(seed):
    """Jobs and services walk their phases and readiness by draws from a
    seed across two profiles; each tick's snapshot, the GPU-seconds
    series and the ratio gauge are compared, and the four states tile
    the allocation to 1e-9 relative."""
    rng = np.random.default_rng(seed)
    plan = []
    for step in range(30):
        jobs = []
        for j in range(3):
            phase = PHASES[int(rng.integers(0, len(PHASES)))]
            total = int(rng.integers(1, 4))
            jobs.append(dict(name=f"j{j}", ns=f"s{seed}-{'ab'[j % 2]}",
                             phase=phase, total=total,
                             ready=int(rng.integers(0, total + 1)),
                             alloc=int(rng.integers(1, 3)),
                             slices=2))
        svcs = []
        for k in range(2):
            replicas = int(rng.integers(0, 4))
            svcs.append(dict(name=f"s{k}", ns=f"s{seed}-{'ab'[k]}",
                             replicas=replicas,
                             ready=int(rng.integers(0, replicas + 1)),
                             target=1 + int(rng.random() < 0.2)))
        occupancy = [float(rng.integers(0, 9)) for _ in range(2)]
        plan.append((float(step) * 1.5 + float(rng.uniform(0, 1)), jobs,
                     svcs, occupancy))

    def run(torch):
        mod, db = (gp, TSDB()) if torch else (ref_gp, RefTSDB())
        acct = mod.GoodputAccountant(now=lambda: 0.0, staleness=5.0)
        out = []
        for at, jobs, svcs, occupancy in plan:
            for k, active in enumerate(occupancy):
                lab = {"service": f"s{seed}-{'ab'[k]}/s{k}", "replica": "r0"}
                db.append("serve_decode_slots", lab, 8.0, ts=at)
                db.append("serve_decode_slots_active", lab, active, ts=at)
            acct.observe([job(torch, **j) for j in jobs],
                         [service(torch, **s) for s in svcs],
                         tsdb=db, at=at)
            out.append(acct.snapshot())
        return out, acct

    got, acct = run(True)
    ref, _ = run(False)
    assert [ref_snapshot(s) for s in got] == ref
    for profile in (f"s{seed}-a", f"s{seed}-b"):
        acc = acct._acc[profile]
        tiled = sum(acc[s] for s in gp.STATES)
        assert abs(tiled - acc["allocated"]) <= 1e-9 * acc["allocated"]
        for state in gp.STATES:
            series = metrics.gpu_seconds_total.sample(profile=profile,
                                                      state=state) or 0.0
            assert series == pytest.approx(acc[state], rel=1e-9)
            assert series == pytest.approx(
                ref_metrics.registry.get_sample_value(
                    "tpu_chip_seconds_total",
                    {"profile": profile, "state": state}) or 0.0, rel=1e-9)
        assert metrics.gpu_goodput_ratio.sample(profile=profile) == \
            pytest.approx(acc["goodput"] / acc["allocated"], rel=1e-9)


def test_debug_registry():
    acct = gp.GoodputAccountant(now=lambda: 0.0)
    gp.register_debug_goodput(acct)
    try:
        assert gp.debug_snapshot() == {"profiles": {}, "lastTickAt": None}
    finally:
        gp.register_debug_goodput(None)
    assert gp.debug_snapshot() is None
