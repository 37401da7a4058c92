"""The port's autoscaler (``kubeflow_tpu_torch/platform/runtime/
autoscale.py``) against the reference's: ``decide_scale`` gives exactly
the reference's decision, width, reason and next state, on
hypothesis-drawn samples, targets, states, clocks and wake stamps, one
step at a time and folded over drawn sequences; the status round trip
and ``targets_from_spec`` (the port's ``spec.gpu`` service against the
reference's ``spec.tpu`` one) agree too."""
import dataclasses

from hypothesis import given, settings
from hypothesis import strategies as st

from kubeflow_tpu.platform.runtime import autoscale as ref
from kubeflow_tpu_torch.platform.runtime import autoscale as port

small = st.floats(min_value=0.0, max_value=64.0, allow_nan=False)
positive = st.floats(min_value=0.01, max_value=64.0, allow_nan=False)
clock = st.floats(min_value=0.0, max_value=10_000.0, allow_nan=False)


@st.composite
def samples(draw):
    return dict(
        replicas_scraped=draw(st.integers(0, 6)),
        queue_depth=draw(small),
        ttft_p99_s=draw(st.none() | small),
        slot_occupancy=draw(st.none() | st.floats(0.0, 2.0)),
        requests_total=draw(st.floats(0.0, 1e6, allow_nan=False)))


@st.composite
def targets(draw):
    lo = draw(st.integers(-1, 4))
    return dict(
        min_replicas=lo, max_replicas=draw(st.integers(-1, 10)),
        queue_depth=draw(st.sampled_from((0.0, -1.0)) | positive),
        ttft_p99_s=draw(st.none() | positive),
        slot_occupancy=draw(positive),
        idle_seconds=draw(st.sampled_from((0.0, 5.0, 300.0)) | positive),
        cooldown_seconds=draw(st.sampled_from((0.0, 30.0)) | positive))


@st.composite
def states(draw):
    return dict(
        last_traffic_at=draw(st.sampled_from((0.0,)) | clock),
        last_requests_total=draw(st.floats(0.0, 1e6, allow_nan=False)),
        last_scale_down_at=draw(st.sampled_from((0.0,)) | clock),
        idle_since_zero=draw(st.booleans()),
        scraped=draw(st.booleans()))


def both(current, sample, target, state, now, wake):
    out = []
    for mod in (ref, port):
        d = mod.decide_scale(
            current, mod.ServeSample(**sample), mod.ScaleTargets(**target),
            mod.ScaleState(**state), now, wake_requested_at=wake)
        out.append((d.replicas, d.reason, dataclasses.asdict(d.state)))
    return out


@settings(max_examples=400, deadline=None)
@given(current=st.integers(0, 12), sample=samples(), target=targets(),
       state=states(), now=clock, wake=st.none() | clock)
def test_one_decision_equals_the_reference(current, sample, target, state,
                                           now, wake):
    a, b = both(current, sample, target, state, now, wake)
    assert a == b


@settings(max_examples=120, deadline=None)
@given(start=st.integers(0, 6), target=targets(),
       steps=st.lists(st.tuples(samples(), st.floats(0.0, 120.0),
                                st.none() | st.floats(-5.0, 5.0)),
                      min_size=1, max_size=25))
def test_decision_sequences_equal_the_reference(start, target, steps):
    """Each step feeds the last decision's width and state back in, on
    an advancing clock, with wake stamps drawn around it."""
    current, state, now = start, dataclasses.asdict(ref.ScaleState()), 0.0
    for sample, dt, wake in steps:
        now += dt
        a, b = both(current, sample, target, state, now,
                    None if wake is None else now + wake)
        assert a == b
        current, _, state = a


@settings(max_examples=200, deadline=None)
@given(state=states())
def test_status_round_trip_equals_the_reference(state):
    a = ref.state_to_status(ref.ScaleState(**state))
    b = port.state_to_status(port.ScaleState(**state))
    assert a == b
    assert (dataclasses.asdict(ref.state_from_status(a))
            == dataclasses.asdict(port.state_from_status(b)))
    assert (dataclasses.asdict(ref.state_from_status(None))
            == dataclasses.asdict(port.state_from_status(None)))


@settings(max_examples=200, deadline=None)
@given(replicas=st.fixed_dictionaries({}, optional={
           "min": st.integers(0, 3), "max": st.integers(1, 8),
           "initial": st.integers(0, 3)}),
       scale=st.fixed_dictionaries({}, optional={
           "queueDepthTarget": positive, "ttftP99TargetSeconds": positive,
           "slotOccupancyTarget": positive, "idleSeconds": positive,
           "cooldownSeconds": positive}))
def test_targets_from_spec_equal_the_reference(replicas, scale):
    def svc(device):
        return {"apiVersion": "kubeflow.org/v1alpha1",
                "kind": "InferenceService",
                "metadata": {"name": "llm", "namespace": "serve"},
                "spec": {"model": "m", **device, "replicas": replicas,
                         "scale": scale}}

    a = ref.targets_from_spec(svc({"tpu": {"accelerator": "v5e",
                                           "topology": "1x1"}}))
    b = port.targets_from_spec(svc({"gpu": {"accelerator": "h100-80gb",
                                            "gpus": 1}}))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
