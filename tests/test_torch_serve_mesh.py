"""Serving under a mesh in the port (``load_service(mesh_spec=)``,
``models/serve.py``, ``models/scheduler.py``, ``models/paged.py``,
``parallel/lockstep.py``, ``parallel/sharding.py``) against the JAX
package's sharded services and the port's own unsharded ones, on the CPU.

The reference serves under ``--mesh`` from one controller over its 8
virtual devices (computed once a module here, in this process); the port
runs one process a device in lock step, so its meshes are gloo worlds of
2 and 4 processes (``tests/test_torch_multirank.py``), each running many
checks.  Tokens are compared exactly: the greedy tokens of ``ROWS``
against the reference's, every request's greedy and seeded ones against
the port's unsharded service; a sharded product sums in another order, so equality holds as
long as no two logits tie within f32 rounding, as the reference's own
sharded-serving tests assume."""
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.moe import MoeMlp as JaxMoeMlp
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models import generate as tgen
from kubeflow_tpu_torch.models.convert import params_from_jax, state_from_flax
from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler
from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
from kubeflow_tpu_torch.models.serve import (
    GenerationService,
    Seq2SeqGenerationService,
    load_service,
)
from kubeflow_tpu_torch.parallel import sharding
from kubeflow_tpu_torch.train import run as trainer
from kubeflow_tpu_torch.train.steps import TrainState, make_lm_grad_fn
from test_torch_multirank import REPO, World, run_world, worker_env

ROWS = [[5, 9, 2, 7]]
PREFIX = list(range(20, 37))          # 17 tokens: two full 8-token pages
# (rows, max_new_tokens, temperature, top_k, seed)
REQUESTS = [
    # First, so its 16 pages are the pool's lowest: the later requests'
    # pages lie past a two-way split's boundary (page 17 of 34).
    ([list(range(100, 160)), list(range(160, 215))], 4, 0.0, None, 0),
    (ROWS, 6, 0.0, None, 0),
    (ROWS, 5, 0.9, 5, 11),
    ([[1, 2, 3], [4, 5, 6, 7, 8]], 5, 0.0, None, 0),
]
PREFIX_REQUESTS = [([PREFIX + [41, 42]], 4, 0.0, None, 0),
                   ([PREFIX + [51]], 4, 0.0, None, 0)]
# Three rows of 8 pages each: more than the pool has free while the first
# request holds its 16, so the paged engine picks it (third) and waits
# for pages; its deadline then passes (``_engine``).
LATE = ([list(range(30, 90)), list(range(90, 150)), list(range(150, 210))],
        4)


def _tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


def _port_llama(tree, name="llama_debug"):
    model = create_model(name, device="cpu", max_seq_len=64)
    model.load_state_dict(params_from_jax(tree, model.cfg))
    return model.eval()


def _submit_all(sched, requests):
    pend = [sched.submit(rows, max_new_tokens=n, temperature=t, top_k=k,
                         seed=seed) for rows, n, t, k, seed in requests]
    out = [p.result() for p in pend]
    sched.stop()
    return out


def _lock(svc, requests):
    return [svc.generate(rows, max_new_tokens=n, temperature=t, top_k=k,
                         seed=seed) for rows, n, t, k, seed in requests]


@pytest.fixture(scope="module")
def reference(devices8):
    """The reference's llama_debug and t5_debug services, unsharded and
    under ``tp=2,fsdp=4`` on its 8 virtual devices, and its mixtral_debug
    service unsharded: their params and the greedy tokens of ``ROWS``.  Each is built as its ``load_service``
    builds it (``model.init`` from seed 0, jitted here; the sharded ones
    on the same params by ``shard_params``)."""
    from kubeflow_tpu.models import create_model as jax_model
    from kubeflow_tpu.models.serve import (
        GenerationService as JaxService,
        Seq2SeqGenerationService as JaxSeq2Seq,
    )
    from kubeflow_tpu.parallel.sharding import rules_for_model, shard_params
    from kubeflow_tpu.train.run import parse_mesh

    mesh = parse_mesh("tp=2,fsdp=4", len(jax.devices()))
    tokens = jnp.ones((1, 8), jnp.int32)

    def init(model, *args):
        params = jax.jit(model.init)(jax.random.key(0), tokens, *args)
        return params["params"], shard_params(params["params"], mesh,
                                              rules_for_model(model))

    llama = jax_model("llama_debug", max_seq_len=64)
    params, sharded = init(llama)
    mixtral = jax_model("mixtral_debug", max_seq_len=64)
    mixtral_params, _ = init(mixtral)
    t5 = jax_model("t5_debug")
    t5_params, t5_sharded = init(t5, jnp.ones((1, 4), jnp.int32))
    return {
        "llama": _tree(params),
        "greedy": JaxService(llama, params).generate(ROWS, max_new_tokens=6),
        "spmd": JaxService(llama, sharded, mesh=mesh).generate(
            ROWS, max_new_tokens=6),
        "rows_index": REQUESTS.index((ROWS, 6, 0.0, None, 0)),
        "mixtral": _tree(mixtral_params),
        "mixtral_greedy": JaxService(mixtral, mixtral_params).generate(
            ROWS, max_new_tokens=6),
        "t5": _tree(t5_params),
        "t5_plain": JaxSeq2Seq(t5, t5_params).generate(ROWS,
                                                       max_new_tokens=5),
        "t5_spmd": JaxSeq2Seq(t5, t5_sharded).generate(ROWS,
                                                       max_new_tokens=5),
    }


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's own services on the reference's params, one process."""
    model = _port_llama(reference["llama"])
    knobs = dict(slots=4, slot_len=64, quantum=3)
    out = {"lock": _lock(GenerationService(model), REQUESTS),
           "fixed": _submit_all(DecodeScheduler(model, **knobs), REQUESTS),
           "paged": _submit_all(PagedDecodeScheduler(
               model, page_len=8, **knobs), REQUESTS + PREFIX_REQUESTS)}
    prompt = torch.tensor([[5, 9, 2, 7], [3, 1, 4, 0]])
    mask = torch.tensor([[True] * 4, [True] * 3 + [False]])
    out["seeded"] = tgen.generate(
        model, prompt, prompt_mask=mask, max_new_tokens=6, temperature=0.9,
        top_k=5, generators=tgen.row_generators(7, 2, "cpu")).tolist()
    out["beam"] = tgen.beam_search(model, prompt[:1], max_new_tokens=4,
                                   beams=2).tolist()
    whole = create_model("t5_debug", device="cpu")
    whole.load_state_dict(state_from_flax({"params": reference["t5"]}, whole))
    out["t5"] = Seq2SeqGenerationService(whole.eval()).generate(
        ROWS, max_new_tokens=5)
    return out


def _check_engines(results, reference, unsharded, pool_shards, num_pages):
    """The checks every world shares."""
    lead = results[0]
    rows = reference["rows_index"]
    assert lead["lock"] == unsharded["lock"]
    assert lead["lock"][rows] == reference["greedy"] == reference["spmd"]
    for r in results:
        # Every process ran every request: its own runs, by the lock path
        # and by each scheduler's bookkeeping, gave rank 0's tokens.
        if r is not lead:
            assert r["lock"] == lead["lock"]
            assert r["fixed_by_id"] == lead["fixed_by_id"]
            for pipeline in (True, False):
                late_id, error = lead["paged"][pipeline]["late"]
                assert error == "DeadlineExceeded"
                # The follower was sent the late request's pick, and ran
                # nothing of it.
                assert late_id in r["paged"][pipeline]["late"]
                by_id = dict(r["paged"][pipeline]["by_id"])
                assert by_id.pop(late_id) == [None] * len(LATE[0])
                assert by_id == lead["paged"][pipeline]["by_id"]
        # Seeded sampling: the same per-row generators on bit-equal logits
        # (the head is whole on every process), so every process draws
        # the same tokens, which are the unsharded port's.
        assert r["same_everywhere"]
        assert r["seeded"] == unsharded["seeded"]
        assert r["beam"] == unsharded["beam"]
        for pipeline, run in r["paged"].items():
            st = run["stats"]
            assert st["pool_shards"] == pool_shards
            assert st["pages_total"] == num_pages + (-num_pages) % pool_shards
            # Drained: every page is free or held by the prefix cache,
            # on every process (each applied rank 0's decisions).
            assert st["pages_active"] == 0 and st["active_rows"] == 0
            # The expired request is queued nowhere: rank 0 dropped it and
            # a follower never queues rank 0's picks.
            assert st["queued_rows"] == 0 and st["page_waits_total"] > 0
            assert st["pages_free"] + st["pages_shared"] == \
                st["pages_total"] - 1
            assert st["prefix_hits"] > 0
            assert run["pool_rows"] == (
                st["pages_total"] * 8 // pool_shards
                + (1 if pool_shards > 1 else 0))
            # Pages on both sides of a two-way split were written and read.
            assert run["max_page"] >= st["pages_total"] // 2
        assert r["fixed_stats"]["active_rows"] == 0
    assert lead["fixed"] == unsharded["fixed"]
    assert lead["paged"][True]["tokens"] == lead["paged"][False]["tokens"]
    assert lead["paged"][True]["tokens"] == unsharded["paged"]
    assert lead["fixed"][rows] == reference["greedy"]
    assert lead["paged"][True]["tokens"][rows] == reference["greedy"]


def test_tp_meshes_serve_the_reference_tokens(tmp_path, reference,
                                              unsharded):
    """World 2, ``tp=2``: the lock path, the fixed-slot pool and the paged
    engine (pool_shards 1: a tp-only mesh has no data axis to split the
    pool over, and is not a fallback), beam search, T5 and Mixtral (each
    against the reference's tokens), and a checkpoint written by the
    port's trainer, restored slice by slice.

    World 4, ``tp=2,fsdp=2``: the same tokens; the fixed pool's slots
    split over fsdp (each process steps its own two), the paged pool's
    positions too (pool_shards 2, 33 pages rounded to 34); a draft model
    under the mesh is recorded as spec-decode-mesh, and /debug/serve and
    /metrics show the mesh and the pool's shards.  (One test for both
    worlds: the reference's services are built once.)"""
    with World("serve_mesh", 2, tmp_path) as two, \
            World("serve_mesh", 4, tmp_path) as four:
        # Both worlds start while the trainer writes the checkpoint.
        ckpt = tmp_path / "ckpt"
        assert trainer.main(["--model", "llama_debug", "--batch", "2",
                             "--seq", "32", "--steps", "2", "--device", "cpu",
                             "--checkpoint-dir", str(ckpt),
                             "--checkpoint-every", "2",
                             "--log-every", "0"]) == 0
        restored = load_service("llama_debug", device="cpu", max_seq_len=64,
                                checkpoint_dir=ckpt)
        want_ckpt = restored.generate([[5, 9, 2]], max_new_tokens=4)
        results = two.result({
            "mesh": "tp=2", "llama": reference["llama"],
            "requests": REQUESTS, "prefix_requests": PREFIX_REQUESTS,
            "num_pages": 33, "late": LATE, "t5": reference["t5"],
            "mixtral": reference["mixtral"], "checkpoint": str(ckpt)})
        results4 = four.result({
            "mesh": "tp=2,fsdp=2", "llama": reference["llama"],
            "requests": REQUESTS, "prefix_requests": PREFIX_REQUESTS,
            "num_pages": 33, "late": LATE, "debug": True})
    _check_engines(results, reference, unsharded, 1, 33)
    lead = results[0]
    for r in results:
        assert r["kv_heads"] == 1            # n_kv_heads 2 over tp 2
        assert r["fixed_rows"] == (0, 4)     # no data axis: every slot
        assert r["slices_equal"]
        # q/k/v/o, gate/up/down, the embedding and the head are cut.
        assert len(r["sliced"]) == 2 * 7 + 2
    # T5 and Mixtral computed as their tp shards (heads, MLP and expert
    # columns, the vocabulary-parallel embedding and head).
    assert lead["t5"] == unsharded["t5"] == reference["t5_plain"] \
        == reference["t5_spmd"]
    assert lead["mixtral"] == reference["mixtral_greedy"]
    assert lead["checkpoint_tokens"] == want_ckpt
    for r in results[1:]:
        assert r["t5"] == [lead["t5"]]
        assert r["mixtral"] == [lead["mixtral"]]
        assert r["checkpoint_tokens"] == [want_ckpt]

    results = results4
    _check_engines(results, reference, unsharded, 2, 33)
    assert [r["fixed_rows"] for r in results] == [(0, 2), (0, 2), (2, 4),
                                                  (2, 4)]
    fallback = results[0]["debug"]["fallback"]
    assert fallback["fallback"]["reason"] == "spec-decode-mesh"
    assert ('serve_paged_fallback_total{reason="spec-decode-mesh"} 1.0'
            in fallback["metrics"])
    assert fallback["debug"]["engine"] == "DecodeScheduler"
    assert fallback["debug"]["paged_fallback"]["reason"] == "spec-decode-mesh"
    assert fallback["tokens"] == [
        unsharded["lock"][reference["rows_index"]][0][:4]]
    paged = results[0]["debug"]["paged"]
    assert paged["debug"]["engine"] == "PagedDecodeScheduler"
    assert paged["debug"]["paged_fallback"] is None
    assert paged["debug"]["mesh"] == {"pp": 1, "dp": 1, "fsdp": 2, "ep": 1,
                                      "tp": 2, "sp": 1}
    assert paged["debug"]["scheduler"]["pool_shards"] == 2
    assert "serve_page_pool_shards 2.0" in paged["metrics"]
    assert paged["tokens"] == fallback["tokens"]
    for r in results[1:]:
        assert r["debug"] == {"fallback": "DecodeScheduler",
                              "paged": "PagedDecodeScheduler"}


def test_follower_failure_ends_the_world(tmp_path):
    """A follower that raises in a quantum leaves the world; rank 0's
    request fails instead of hanging, its scheduler is dead and its
    channel broken, well inside the world's timeout."""
    t0 = time.monotonic()
    results = run_world("serve_failure", 2, tmp_path, timeout=90.0)
    assert time.monotonic() - t0 < 90.0
    assert "injected failure on rank 1" in results[1]["error"]
    assert results[0]["error"] is not None
    assert results[0]["seconds"] < 30.0
    assert not results[0]["alive"] and results[0]["broken"]


def test_leader_failure_on_the_lock_path_ends_the_world(tmp_path):
    """Rank 0 raises inside the lock path's decode, after it sent the
    request: its request fails with ``WorldBroken``, the next is refused
    at once, and the follower, waiting inside the same decode's
    collective, ends when rank 0 leaves: every process well inside the
    world's 60 s collective timeout."""
    t0 = time.monotonic()
    results = run_world("serve_failure", 2, tmp_path, {"leader": True},
                        timeout=90.0)
    assert time.monotonic() - t0 < 45.0
    lead, follower = results
    assert "WorldBroken" in lead["error"]
    assert "injected failure on rank 0" in lead["error"]
    assert "WorldBroken" in lead["second"]
    assert lead["broken"] and lead["seconds"] < 30.0
    assert follower["error"] is not None and follower["seconds"] < 45.0


def test_mixtral_experts_compute_as_their_ep_shards(tmp_path):
    """World 2, ``ep=2``: a MoE layer on each process's row against the
    one-process layer and the reference's ``MoeMlp`` on that row (f32,
    1e-5); a sharded step's expert gradients equal each process's slice
    of the one-process gradients (1e-6: f32 sum order); served tokens on
    the lock path and the fixed-slot pool equal the unsharded port's
    (the same random weights, whole in one process)."""
    with World("moe_ep", 2, tmp_path) as world:
        _check_mixtral(world)


def _check_mixtral(world):
    from kubeflow_tpu_torch.models.moe import MoeMlp

    e, d, f, k, cf = 4, 32, 48, 2, 1.25
    jm = JaxMoeMlp(n_experts=e, hidden_dim=f, top_k=k, capacity_factor=cf,
                   dtype=jnp.float32)
    params = _tree(jax.jit(jm.init)(jax.random.key(0),
                                    jnp.ones((2, 16, d)))["params"])
    apply = jax.jit(lambda x, m: jm.apply({"params": params}, x,
                                          token_mask=m, mutable=["losses"]))
    rs = np.random.RandomState(1)
    x = rs.randn(2, 16, d).astype(np.float32)
    mask = np.ones((2, 16), bool)
    mask[1, 9:] = False
    layer = {"router": np.ascontiguousarray(params["router"]["kernel"].T),
             **{n: params[n] for n in ("w_gate", "w_up", "w_down")}}
    one = MoeMlp(d, f, e, top_k=k, capacity_factor=cf, dtype=torch.float32)
    with torch.no_grad():
        one.router.weight.copy_(torch.from_numpy(layer["router"]))
        for n in ("w_gate", "w_up", "w_down"):
            getattr(one, n).copy_(torch.from_numpy(np.array(layer[n])))

    gen = torch.Generator().manual_seed(3)
    mixtral = create_model("mixtral_debug", device="cpu",
                           param_dtype=torch.float32, max_seq_len=64)
    mixtral.reset_parameters(gen)
    state_np = {n: t.detach().numpy().copy()
                for n, t in mixtral.state_dict().items()}
    tokens = np.random.RandomState(2).randint(0, 256, (2, 32))
    mixtral.requires_grad_(True)
    grads, _ = make_lm_grad_fn()(
        TrainState(mixtral, torch.optim.SGD(mixtral.parameters(), lr=1.0)),
        torch.from_numpy(tokens))

    served = create_model("mixtral_debug", device="cpu", max_seq_len=64)
    served.load_state_dict(mixtral.state_dict())
    served.eval()
    requests = [r for r in REQUESTS if r[2] == 0.0 or len(r[0]) == 1]
    want_lock = _lock(GenerationService(served), requests)
    want_fixed = _submit_all(DecodeScheduler(served, slots=2, slot_len=64,
                                             quantum=3), requests)

    results = world.result({
        "layer": layer, "x": x, "mask": mask, "top_k": k,
        "capacity_factor": cf, "mixtral": state_np, "tokens": tokens,
        "requests": requests})
    for rank, r in enumerate(results):
        xr, mr = x[rank:rank + 1], mask[rank:rank + 1]
        with torch.no_grad():
            y1, aux1 = one(torch.from_numpy(xr), torch.from_numpy(mr))
        jy, jaux = apply(jnp.asarray(xr), jnp.asarray(mr))
        y, aux = r["layer"]
        np.testing.assert_allclose(y, y1.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(aux, aux1.item(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            aux, float(jaux["losses"]["moe_aux_loss"][0]), atol=1e-6, rtol=0)
        assert set(r["expert_grads"]) == {
            f"layers.{i}.mlp.{n}" for i in range(2)
            for n in ("w_gate", "w_up", "w_down")}
        for name, g in r["expert_grads"].items():
            want = grads[name].chunk(2)[rank].numpy()
            assert g.shape == want.shape
            np.testing.assert_allclose(g, want, atol=1e-6, rtol=1e-4)
        assert r["expert_rows"] == 2           # 4 experts over ep 2
    assert results[0]["lock"] == results[1]["lock"] == want_lock
    assert results[0]["fixed"] == want_fixed


def test_serve_cli_under_a_mesh_over_gloo(tmp_path):
    """``torchrun``'s env, two processes: ``serve --mesh tp=2 --device
    cpu``; rank 0 serves HTTP, rank 1 follows and binds no port, and a
    request returns the one-process service's tokens."""
    import json
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        master = sock.getsockname()[1]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    args = [sys.executable, "-m", "kubeflow_tpu_torch.models.serve",
            "--model", "llama_debug", "--device", "cpu", "--mesh", "tp=2",
            "--max-seq-len", "64", "--host", "127.0.0.1", "--port",
            str(port)]
    procs = [subprocess.Popen(
        args, cwd=REPO, env=worker_env({
            "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(master),
            "KFT_SERVE_SCHEDULER": "0"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        # While the two processes start.
        want = load_service("llama_debug", device="cpu", max_seq_len=64,
                            use_scheduler=False).generate(
                                ROWS, max_new_tokens=6)
        first = [json.loads(next(ln for ln in p.stdout
                                 if ln.startswith("{"))) for p in procs]
        assert first[0]["serving"] == "llama_debug"
        assert first[0]["mesh"]["tp"] == 2
        assert first[1] == {"following": "llama_debug", "rank": 1,
                            "mesh": first[0]["mesh"]}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps({"tokens": ROWS, "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())["tokens"]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    assert got == want


def test_mesh_spec_and_quantize_fail_before_any_build(monkeypatch):
    """A malformed spec and int8 with a mesh raise ``ValueError`` before a
    model is built or a process group joined."""
    import kubeflow_tpu_torch.models as models

    def refuse(*a, **k):
        raise AssertionError("built a model")

    monkeypatch.setattr(models, "create_model", refuse)
    with pytest.raises(ValueError, match="quantize"):
        load_service("llama_debug", device="cpu", quantize="int8",
                     mesh_spec="tp=2")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        load_service("llama_debug", device="cpu", mesh_spec="tq=2")
    with pytest.raises(ValueError, match="needs an integer"):
        load_service("llama_debug", device="cpu", mesh_spec="tp=two")


def test_mesh_without_a_launcher_points_to_torchrun(monkeypatch):
    """``--mesh`` with neither torchrun's nor the platform's env: there is
    no world to serve over, and the error names the launcher."""
    import torch.distributed as dist

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT", "TPU_WORKER_HOSTNAMES",
                 "MEGASCALE_NUM_SLICES", "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node N"):
        load_service("llama_debug", device="cpu", mesh_spec="tp=1")
    assert not dist.is_initialized()


@pytest.mark.parametrize("axes,shards", [
    (dict(tp=2, fsdp=4), 4), (dict(dp=2, fsdp=2, tp=2), 4),
    (dict(tp=2, sp=4), 1), (dict(ep=2, tp=4), 2)], ids=str)
def test_page_pool_shards_equal_the_reference(devices8, axes, shards):
    from kubeflow_tpu.parallel import mesh as jax_mesh
    from kubeflow_tpu.parallel.sharding import page_pool_shards

    want = page_pool_shards(jax_mesh.make_mesh(devices=devices8, **axes))
    assert want == shards

    class Mesh:
        mesh_dim_names = ("pp", "dp", "fsdp", "ep", "tp", "sp")

        def size(self, i):
            return axes.get(self.mesh_dim_names[i], 1)

        def get_local_rank(self, axis):
            return axes.get(axis, 1) - 1     # the last process

    assert sharding.page_pool_shards(Mesh()) == shards
    first, count = sharding.page_pool_spec(Mesh(), 34 * 8 * shards)
    assert count == 34 * 8 and first == (shards - 1) * count
