#!/usr/bin/env python3
"""Drive the PyTorch port (``kubeflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. device:  the card's name and power limit (nvidia-smi); fails without
   CUDA.  TF32 is switched off so the plain references run in full f32.
2. build:   compiles every CUDA kernel of the serving path with nvcc for
   sm_90a from ``kubeflow_tpu_torch/ops/csrc`` into ``build/kernels``;
   meanwhile the platform's native engine (``platform/csrc``, g++) into
   ``build/native``, which must load with all four components (the
   JSON and merge patch, the work queue, the packer, the wire scanner)
   active.
3. kernels: each kernel against its plain PyTorch version at the shapes
   the serving path gives it, timed with CUDA events (median of 25 runs,
   L2 flushed before each), beside its bound and one PyTorch library call
   that computes the same function (a yardstick the port never calls);
   first, the timer's reading of a kernel that does no work.  K5 also at
   the scheduler's pool shape (8 slots of 1024 at mixed depths, one free
   slot fully masked, garbage behind the masks).
   Then the shapes the kernels accept beyond the serving path's.
4. compose: ``llama3_8b`` at full width, 2 layers, on the card: the
   kernel route (impl="auto") against impl="plain" on the logits of a
   ragged batch, after prefill and after one decode step; then a b2
   ragged prompt prefilled in two chunks (DENSE_CHUNKS) through the dense
   cache, the second at index 512 (K2 end-aligned causal over the
   written slots: exact launches, the route counter, the logits).
5. serve:   ``load_service("llama3_8b")`` (32 layers, random bf16 weights
   from seed 0 on the card) behind the HTTP app, pinned to the lock path
   (``use_scheduler=False``: one request at a time, whose launches it
   counts exactly); /readyz, then three POST /v1/generate: A greedy, B
   sampled, C = A again (token-identical).  The kernels' launch counts
   are set to 0 just before A and read just after it; each must equal
   what the path launches.  Around A the telemetry holds: the route
   counter rose by A's K2 launches, ``hbm_peak_bytes`` is the allocator's
   peak, ``device_memory_bytes`` has all three kinds for cuda:0.  C is
   sent with a traceparent while ``/debug/profile?seconds=1`` captures a
   registered profiler: samples under the model's role, and C's trace
   linked as ``causal_trace_id`` on /debug/traces.
6. profile: request A's device time by kernel class (torch.profiler).
6b. schedule: the same model behind the continuous-batching scheduler
   (8 slots of 1024 positions, quantum 8): 12 rows in 6 requests over
   HTTP at once, so rows wait for slots and refill them mid-flight.
   Each request's tokens equal the request sent alone; greedy tokens
   agree with the lock path under a teacher-forced prefill; pipelined and
   synchronous loops give equal tokens; launches are exact for a run
   queued before its loop starts; the counters balance, and
   ``serve_dispatch_overlap_ratio`` on /metrics equals ``stats()``.  This phase pins
   the fixed-slot pool (``KFT_SERVE_PAGED=0``).
6c. paged: the same model and requests through the paged engine, the
   service's default (8 lanes of 1024 slots, 64-token pages, 129 pages,
   512-token prefill chunks): exact launches over HTTP (K5 a pool step,
   K2 a prefill chunk, a layer each); a shared-prefix set whose later
   requests hit the trie; pipeline off = on and alone = pooled, bit for
   bit; the fixed pool's tokens, the cache-off run's and the
   non-speculative stream's held by token equality or the teacher-forced
   gap; a pool too small for the mix (admissions wait, tokens equal);
   speculative decoding with the target and a 2-layer draft (exact K5,
   K2 and verify-attention counts); a quantum at 1024 and 8192 slots
   with no host sync inside, its device time by class; the gather, K2 at
   a chunk's shape and K5 over null-page rows, timed.  Pages balance
   after every drain.
7. train-kernels: the training kernels (K1 forward and backward, K2-lse
   forward, K3 dq, K4 dk/dv) against their plain versions in f32 on the
   same bf16 inputs, K1 at llama_1b4's rows ([8192, 2048]), attention at
   llama_1b4's training shape (b1 s8192 h16 d128 causal), the same with
   the packed loader's segment ids, and llama3_8b's GQA shape (b1 s4096
   h32/8), timed beside each one's bound and the library call
   (``F.rms_norm``'s backward, SDPA's forward, or its backward, both
   through ``torch.autograd.grad``).
8. train-edges: the K1 backward at row counts around its grid, widths
   from 64 to 16384, f32 and bf16, zero rows and zero cotangents; the
   attention kernels at ragged, cross-length, head_dim 64, one-key, GQA
   1/2/4/8, segment-with-pad and nonzero-g_lse cases.
9. train-compose: ``llama_1b4`` at full width, 2 layers: one grad step on
   the kernel route, the bf16 plain route and an f32 plain model; the
   kernel route's gradients may be no farther from the f32 model's than
   COMPOSE_RATIO times the plain route's.
10. train-variants: the same model's step with remat "block" and "mlp"
   and with the chunked head and loss, against the base step, and with 2
   accumulated microbatches against the whole batch: exact launches per
   step (remat "block" re-runs each block's K1 and K2-lse), peak memory,
   and loss and gradients within VARIANT_TOL.
11. train:  ``kubeflow_tpu_torch.train.run.main`` trains ``llama_1b4``
   (24 layers, b1 s8192, bf16 grads) for 6 steps with the counts set to
   0 just before and read just after (exact launches per step), then one
   profiled step; then 2 packed steps (b4 s2048, segment ids through all
   three training kernels).
12. checkpoint: ``llama_1b4`` at full width, 2 layers: 4 unbroken steps
   against 2 steps, a stop and a resume for 2 more (restored state
   bit-equal to the saved one, also while training goes on during the
   write); then all 24 layers train 3 steps through ``train.run`` with
   ``--checkpoint-dir``, ``load_service`` restores them in bf16, and a
   request served through the scheduler equals ``generate()`` on the
   restored model.

Between 6c and 7 (llama3_8b is freed after beam):
6d. int8:   ``load_service("llama3_8b", quantize="int8")`` from the same
   seed: weight bytes against bf16, the service's int8 values equal to
   the bf16 model's quantized, layer 0's dequantized weights on the card
   bit-equal to the CPU's, the schedule requests over HTTP through the
   paged engine (exact launches, decode rate against 6c's bf16 run), and
   the greedy rows teacher-forced against the bf16 model (argmax
   agreement, logits' relative difference).
6d1. beam: ``beam_search`` on the bf16 llama3_8b of 6: b2 with
   prompts of 300 and 17 tokens, 4 beams, 32 new, no EOS, length penalty
   0: exact launches (K2 a layer at the prefill, K5 a layer a step over
   the 8 beam-folded rows, K1 65 a forward), beams 1 equal to
   ``generate``, the best beam rescored on the search's route and by
   one teacher-forced forward no worse than 1 beam's within
   BEAM_SCORE_TOL a token, ms a step.
6d1a. platform_serve: the serving front door on this card.  The
   accelerator table's product is this card's name.  Request A runs
   through the default paged engine in this process for reference.  In
   the port's ``FakeKube``: a 1-GPU quota, a 1-GPU node of this card's
   product, a PodDefault that sets SERVE_PODDEFAULT_ENV in the replica's
   pods, the PodDefault webhook over HTTPS on a pair the openssl command
   line makes, a ``Manager`` with the InferenceService controller (a
   pass every SERVE_SYNC_S), the fleet sim creating the Deployment's
   pods through the webhook, and the activator.  InferenceService
   ``llama`` (llama3_8b on one GPU, 0 to 1 replicas, its port a free
   port, idle window SERVE_IDLE_S) parks at zero, phase Idle.  Request A
   to the activator's ``/serve/smoke/llama/v1/generate`` is held and
   stamps ``wake-at``; the controller scales the Deployment to 1; the sim
   creates the pod, the webhook patches it; its container runs as a
   subprocess the way the kubelet would start it, the PodDefault's env in
   its environment; its /readyz (a warm generate) makes it Ready; the
   controller publishes the endpoint and the activator replays request A:
   tokens held to the in-process ones (equal, or the teacher-forced gap),
   the attention calls on the kernel route.  The controller's scrape
   holds ``generate_requests_total`` >= 1 from the one replica; after the
   idle window the service parks again, the pod goes and its process
   exits on SIGTERM.  Then the pair rotates (``write_pair``,
   ``reload_certs``: no failure, a handshake pinned to the old pair
   refused), and the same Deployment with ``mesh="tp=1"`` has its pod
   admitted through the rotated webhook and run under
   ``parallel/launch.py`` (NCCL at world size 1), token-equal to the
   first.  The phase prints the hold, the wake, the ready and the
   park's seconds, the activator's and the webhook's counts.
6d1b. platform_notebook: the notebook's control plane around this card,
   entered through the user's front door.  In the port's in-memory API
   server (``FakeKube``): an h100-80gb node (its product this card's
   name) and the Profile ``smoke`` (owner FRONT_OWNER, a quota of one
   ``nvidia.com/gpu``), which the port's ``ProfileReconciler`` turns
   into the namespace, the editor and viewer ServiceAccounts, the
   bindings, the AuthorizationPolicy and ``kf-resource-quota``; then
   ``gpu_pod_default``.  ``FakeKube.authz_policy`` (``front_door_authz``)
   grants a verb in a namespace only to a user a RoleBinding there
   names.  KFAM, the Jupyter web app and the tensorboards app serve on
   loopback (``test_server()``); as the owner, KFAM's POST makes
   FRONT_CONTRIBUTOR a contributor.  As the contributor, with the
   identity header and the CSRF cookie echoed in its header: the SPA's
   files with their types, the GPU picker (this card, quota 1 of 1
   free), and the spawn of ``nb`` (``gpus {h100-80gb, 1}``, the
   PodDefault's label, ``/dev/shm`` left to the PodDefault) whose
   Notebook and workspace claim the JWA writes.  ``nb`` is reconciled: a
   StatefulSet of 1 replica asking the form's cpu and memory and one GPU
   on the product, its env block, the Service, the headless Service and
   the VirtualService.  Pod ``nb-0`` from its template (pod index 0, the
   PodDefault's opt-in label) goes through ``mutate_admission_review``
   and its JSON patch, is bound to the node and admitted; a second
   notebook's 1-GPU pod is refused with the apiserver's "exceeded quota"
   words; ``nb-0`` marked ready gives ``readyReplicas`` 1.  Then
   ``nb-0``'s main container runs as a subprocess with the patched env
   (pod index 0; the workspace claim's mount a directory of the phase,
   its HOME) and ``python -c NOTEBOOK_CELL`` for the image's command:
   llama_1b4 (24 layers, seed 0) on the card, ``generate`` of one
   NOTEBOOK_PROMPT-token prompt and NOTEBOOK_NEW tokens, whose tokens
   equal the same cell run in this process, with exact launches (K2 a
   layer, K5 a layer a decode step, K1 2L+1 a forward) and the attention
   route counter at one kernel call a layer and no plain call.  While
   the cell runs: the notebooks' table shows ``nb`` running with its
   GPU; a second 1-GPU spawn is a 403 with the quota's words; a user
   with no binding and a POST without the CSRF header are 403s; a
   Tensorboard on the workspace claim, made through the tensorboards
   app and reconciled by the port's ``TensorboardReconciler``
   (RWO_PVC_SCHEDULING on), mounts the claim's ``logs`` and is pinned to
   ``nb-0``'s node.  Deleting the Notebooks and the Tensorboard removes
   every child by the cascade.  Reconcile ms, the cell's seconds and its
   generate's ms are printed beside the card's name and power limit,
   and a ``front_door_ui`` line: the profile's reconcile seconds, KFAM's
   binding ms, each front-door request's ms, the spawn-to-Notebook ms,
   the tensorboard's reconcile ms and the HTTP status counts (no 5xx).
6d2. t5_serve: ``load_service("t5_large")`` (24 + 24 layers, d1024,
   random bf16 weights from seed 0, W_q scaled as T5 initialises it:
   ``t5_conditioned``) over HTTP through the wire client
   ``models/client.py``: sources of 512, 300, 77 and 17 tokens, 64 new,
   greedy (A), a seeded sampled row (B, twice), A again (C, identical);
   A's launches exact (K1 49 + 73 a decoder step; every attention
   carries T5's per-head bias and runs the plain version, so no K2 or
   K5); A's tokens teacher-forced through one forward on the kernel
   route, impl="plain" and an f32 model (each greedy token within
   AGREE_GAP of its position's largest logit, COMPOSE_RATIO); latency,
   tokens/s, peak memory; the int8 service's bytes and argmax agreement;
   the attention pre-flight gauge after A (its last plain call) and after
   the encoder alone (the largest), and its host time a call.
6d3. t5_beam: ``beam_search_seq2seq`` on that model, b4, 4 beams, 32
   new: exact launches, beams 1 bit-equal to greedy, rows after EOS hold
   EOS, the best beam rescored no worse than greedy, ms a step.
6d4. t5_grad: t5_large's width at 2 + 2 layers, one gradient of the
   teacher-forced cross-entropy three ways (kernel route with K1's VJP,
   bf16 plain, f32): COMPOSE_RATIO, exact launches.
6e. moe_layer: one ``MoeMlp`` at mixtral_8x7b's width (bf16, b2 with a
   half-padded row, s 512 and 2048): the index dispatch against the
   reference's dense one-hot einsums (``moe.dense_dispatch``) on the same
   weights, routing identical, output and aux within MOE_LAYER_TOL and
   MOE_AUX_TOL; each timed, with its peak memory.
6f. moe_serve: ``load_service("mixtral_8x7b", n_layers=8)`` (full width,
   24.0 GB) over HTTP through the paged engine at 6c's geometry: prompts
   of 17, 300, 512 and 900 tokens greedy and a seeded sampled one, 32
   new each; exact K1/K2/K5 launches, TTFT, decode rate, peak; each
   greedy row teacher-forced on the kernel route and on impl="plain"
   (logits, argmax and routing agreement: a near-tie may flip an expert).
6g. moe_train: mixtral_8x7b at full width, 1 layer, f32 masters, b1
   s2048, bf16 gradients, ``aux_loss_weight`` 0.01, 3 steps on one batch:
   the loss falling, loss and aux finite, exact launches per step.

After 12 (PR 9, the image task and the encoders):
13. vit:    ``vit_b16`` as the reference bench trains it (b64 at 224 px,
   bf16, AdamW 3e-4): 5 steps on one batch and an eval forward with the
   counts at 0 (exact: K2-lse, K3 and K4 12 a step, K2 12 a forward),
   images/s, model TFLOP/s and MFU (the bench's FLOPs per image over 989
   TF/s), 3 steps profiled by the port's ``profile_trace``; then at 2
   layers the kernel route against impl="plain" and an f32 model on one
   step's loss and gradients (COMPOSE_RATIO).
14. bert:   ``bert_base`` at b32 s128, 2 classes, AdamW: the same, plus a
   padded ``attention_mask`` forward (the plain route: no launch) and an
   all-ones mask against no mask within K2's tolerance.
15. resnet: ``resnet50`` as the bench trains it (b256 at 224 px, bf16 on
   f32 masters and stats, SGD 0.1 Nesterov 0.9): no port kernel runs
   (counts all 0), images/s, peak memory, busy share by class.
15a. batch_stats: that batch's every norm input split over 2 virtual
   data ranks, their per-channel sums merged as the all-reduce over the
   data axes merges them, against the whole batch's statistics.
16. slow-step: the loop on that state with a stalled first batch: the
   slow-step counter reads 1, the next step is profiled, and
   ``trace_summary`` reads the trace it wrote.
17. image-cli: ``train.run --task image --model resnet50`` with
   ``--checkpoint-dir`` for 4 steps, against 2 steps and a resume to 4:
   weights, batch stats and momentum within RESUME_TOL; then 2 steps
   with ``--distributed --mesh dp=1`` (NCCL, world size 1) whose losses
   equal the unbroken run's.
After beam (serving under a mesh on one card):
6d0. serve_mesh: ``load_service("llama3_8b", mesh_spec="tp=1")`` at
   NCCL world size 1 through the paged engine over HTTP: the paged
   phase's tokens and held launches; the spec-decode-mesh fallback.
6d0a. tp_virtual: llama3_8b (2 layers) as 4 virtual tp ranks (the port's
   modules under a ``VirtualMesh``, the script adding partial sums and
   joining vocabulary shards in rank order): a ragged prefill and 8
   decode steps against plain and f32, exact launches, the
   vocabulary-parallel embedding, f32 head and loss against the whole
   ones, K2 and K5 at one rank's heads; then vit_b16 and bert_base (2
   layers, one forward and backward; BERT at 2 ranks, as its vocabulary
   splits) and t5_large (2 + 2 layers, 8 greedy steps) as virtual
   ranks, exact launches, against f32, with K2-lse, K3 and K4 timed at
   one rank's heads.
After 7 (sequence parallelism on one card):
7a. ring:   ``parallel/ring.py``'s own ``hop`` and ``merge`` over SP = 4
   virtual ranks in one process, the script handing each rank its K/V
   blocks (two NCCL ranks cannot share a card): llama_1b4's b1 s8192
   h16 d128 causal and dense, llama3_8b's b1 s4096 h32/8 causal.  The
   output and lse against one K2-lse call over the whole sequence (the
   output's distance from f32 within COMPOSE_RATIO of the one call's, the
   lse at K2-lse's lse gate), dq/dk/dv against one K2-lse + K3 + K4 call
   within relative L2 2e-2, exact launches (a causal ring of 4 runs 10
   hops, a dense one 16, each one K2-lse, K3 and K4), both layouts timed.
7b. ulysses: the local attention of 4 virtual ranks of 4 heads each over
   the whole sequence (b1 s8192 h16): 4 K2 launches, held to one K2 call
   over all 16 heads (bit-equal expected; the row says), both timed.
After 11:
11a. mesh:  ``train.run.main`` with ``--distributed --mesh fsdp=1``: the
   process group from torchrun's env at world size 1 over NCCL, the
   state sharded by llama_rules and trained by the sharded step; losses
   against the train phase's (MESH_LOSS_TOL), exact launches a step,
   step seconds and peak memory; the group destroyed after it.
11b. platform_job: the job controller around this card.  In the port's
   ``FakeKube``: namespace ``smoke``, an h100-80gb node of one GPU (its
   product this card's name) and a ResourceQuota of one
   ``nvidia.com/gpu``.  GPUJob ``train`` (priority 100, one GPU,
   ``checkpointDir`` a new directory under ``build/checkpoints``, a
   template running ``train.run`` with MESH_ARGS at
   PLATFORM_JOB_TOTAL_STEPS steps) is reconciled by ``GPUJobReconciler``
   into StatefulSet ``train`` (1 replica, one GPU as limit and request,
   the product's selector, the launcher's command, ``KFT_CHECKPOINT_DIR``,
   ``terminationGracePeriodSeconds`` the job grace) and Service
   ``train-workers``.  The phase plays the kubelet: a StatefulSet's pod
   is created from its template and its container runs as a subprocess
   (worker 0's name resolved to 127.0.0.1); a deleted StatefulSet's pod
   gets SIGTERM and at most its grace before a kill, which fails the
   phase; an exited pod is marked Succeeded or Failed by its exit code.
   Once step PLATFORM_JOB_STEPS of ``train`` has logged, GPUJob
   ``urgent`` (priority 200, one GPU, MESH_ARGS at PLATFORM_URGENT_STEPS
   steps) is created: it waits Queued while ``train`` is Preempting and
   drains (both reconciled every PLATFORM_RECONCILE_S), ``train``'s pod
   exits 0 within the grace, the controller frees its GPU on the pod's
   exit (not on the deadline) and ``urgent`` is admitted and runs to
   Succeeded, its losses 11a's first two.  ``train`` is re-admitted in
   its next generation, resumes from its checkpoint one step past where
   it stopped, its losses 11a's through step 6 (MESH_LOSS_TOL), and ends
   Succeeded at its last step with the quota's use back to 0.  Each
   reconcile's ms, the drain's seconds beside the grace and the
   reference's 30 s, the checkpoint's snapshot and write seconds, and the
   wall seconds of ``urgent`` and of the resumed pod to its first step
   are printed beside the card's name and power limit.
11c. platform_manager: the controller runtime around this card, over
   the wire.  ``FakeKube`` is served over HTTP (``make_transport(kube,
   "http", watch_window=MANAGER_WATCH_WINDOW_S)``: ``HttpKubeServer`` on
   127.0.0.1, the port's ``RestKubeClient``), so every watch closes and
   resumes from its resourceVersion several times in the phase.  One
   ``Manager`` with leader election over that client (its Lease's holder
   checked before any child exists) runs the notebook, culling and job
   controllers from watches (namespace ``smoke``, one h100-80gb node of
   one GPU, a ResourceQuota of one ``requests.nvidia.com/gpu``,
   ``gpu_pod_default``); the culler shares the notebook controller's
   Notebook informer, stops a notebook PLATFORM_IDLE_MINUTES after its
   kernel's last activity, probes every PLATFORM_CHECK_MINUTES with the
   port's ``default_prober`` (its cluster-DNS URL mapped to the pod's
   local port).  Notebook ``nb`` (one GPU) is reconciled from the
   watch; the phase plays the StatefulSet controller and the kubelet:
   pod ``nb-0`` through the webhook, its process ``python -c
   NOTEBOOK_KERNELS``, a stand-in for Jupyter's kernels API that runs
   NOTEBOOK_CELL on the card (``busy``, then ``idle`` since the cell's
   end).  GPUJob ``train`` (one GPU, MESH_ARGS at MANAGER_JOB_STEPS
   steps) waits Queued on the quota (``gpujob_queue_depth`` 1).  While
   the cell runs the notebook is never stopped and its last-activity
   annotation moves; after it, the culler stops it within the idle
   window plus two check periods, the notebook controller scales it to
   0, the pod is deleted and its process exits 0 on SIGTERM, its pid
   leaves nvidia-smi's compute processes and the quota's use is 0; the
   job is admitted within its queue poll plus one reconcile, its gang
   runs as in 11b, its losses 11a's first MANAGER_JOB_STEPS within
   MESH_LOSS_TOL; both pods' launches exact; K1, K2 and K5 held at the
   cell's shapes.  After ``stop`` the controllers' threads end, the
   collectors and the queue's debug registry are unhooked, one cull,
   no dead letter and no watch restart counted.  The seconds of each
   step of the story, the reconciles, probes and work-queue adds per
   controller are printed beside the card's name and power limit.  The
   wire's own checks, read after the flow: the client made gets, lists,
   watches, creates and updates or patches, none answered 5xx, none
   failed in transport or at the breaker, none retried, and its circuit
   is closed; each watched kind's watches were established at least
   three times a watcher of it (two resumes each); the watch deltas were
   decoded by the native scanner (none by the Python path) and
   materialized at most once each; every controller's queue is the
   native engine's, every
   engine component is active on /metrics, and the pod's admission patch
   came from the native diff; the Lease was written over the wire.  A
   second line prints the requests by verb with their p50 and p99
   seconds, the watch establishments by kind, the codec's counts and the
   engine's components.
11d. platform_shards: the sharded HA control plane around this card.
   A ``ShardedFleet`` of SHARD_REPLICAS replicas over one ``FakeKube``,
   each a ``Manager`` over its own ``ShardCoordinator`` (SHARD_COUNT
   shards, leases of SHARD_LEASE_S renewed every SHARD_RENEW_S) and its
   own ``FencedClient`` (every write logged with its shard's token),
   running the notebook controller and the culler on its informer (the
   default idle window, so it never culls, probing every
   PLATFORM_CHECK_MINUTES; ``nb``'s URL mapped to the pod's local port,
   no other probe leaves the process).  Namespace ``smoke`` as in 11c;
   ``fleet`` gets SHARD_WAVE GPU notebooks, played by the fleet's
   kubelet.  Notebook ``nb`` (one GPU) runs NOTEBOOK_CELL behind the
   stand-in kernels API; its pod runs, not yet ready, and once the API
   reports ``busy`` the replica owning ``nb``'s shard is killed (its
   controllers' threads end, its leases are left to expire); then the
   kubelet's readiness probe passes.  The dead replica's shards are
   absorbed within the lease plus four renewals plus 1 s, ``nb``'s shard
   token rises, the survivor writes ``nb``'s ready status and a culler
   last-activity patch under the new token, the dead replica writes
   nothing after its kill, every wave notebook converges within
   SHARD_WAVE_S with the fencing invariant holding on every write of
   both namespaces, no survivor dead-letters and none caches the whole
   keyspace; the cell ends untouched (the StatefulSet's and the pod's
   uids kept, no signal) with 6d1b's tokens and exact launches, K1, K2
   and K5 held at its shapes; ``controller_shard_owned`` sums to 1 per
   shard over the live coordinators, the lease transitions count
   acquires and renewals and no fence; the pod's process exits 0 on
   SIGTERM, the quota's use returns to 0, and each survivor's stop
   releases its leases before it returns.  The shard maps, absorb
   seconds, tokens, writes checked, wave and cell seconds, reconciles
   and probes per replica are printed beside the card's name and power
   limit.
Within 3, K2 at the dense-cache chunk's shape (b2, q 300 over k 812).
Within 7, the attention kernels at ViT-B/16's and BERT-base's shapes
(b64 s197 and b32 s128, h12, d64, non-causal), timed; and K1 at
T5-large's rows ([2048, 1024] and [16, 1024]) and K5 at the beam step's
(b8 S332), timed.

Every line of standard output is one JSON object; the line before the
last lists every kernel with its launches, error and times, and the last
line is the result, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

SEED = 0
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
TIMING_RUNS = 25
# atol = rtol per kernel: its bf16 output against the plain version in f32
# on the same bf16 inputs.  K1 and K5 stay in f32 up to one rounding of
# the output to bf16 (relative error <= 2^-9), so 1e-2 leaves about 5x
# room; K2 also rounds the probabilities to bf16 before the P V product,
# which doubles its error, so it gets 2e-2.
#
# The training kernels, against the plain versions in f32 on the same
# bf16 inputs.  K2-lse: its O is held to K2's tolerance, and its lse, an
# f32 m + log(l) from the same m and l (the m from bf16 logits that the
# plain version also sees), to atol 1e-3 with no rtol.  K3 (dq) and K4
# (dk, dv): relative L2 <= 2e-2 against autograd through the f32 plain
# attention; the kernels round P and dS to bf16 to feed the tensor cores
# (the reference's f32 products do not) and write bf16 gradients, each a
# relative error of ~2^-9 per element, well inside 2e-2.  A reference
# that is zero (dq and dk when a row sees one key) has no scale of its
# own: the distance is then taken against 1e-3 * sqrt(numel).
#
# The K1 backward: dx, like K1's output, is f32 math rounded once to x's
# dtype, so it gets K1's 1e-2; dscale sums the rows in another order than
# the plain version (f32) and rounds once to scale's dtype (bf16 on the
# training path, a relative error <= 2^-9 an element), so it is held by
# relative L2 <= 4e-3 ("rms_norm_bwd_dscale"), twice that rounding.
KERNEL_TOL = {"rms_norm": 1e-2, "flash_attention_fwd": 2e-2,
              "flash_decode": 1e-2, "flash_attention_fwd_lse": 1e-3,
              "flash_attention_dq": 2e-2, "flash_attention_dkv": 2e-2,
              "rms_norm_bwd": 1e-2, "rms_norm_bwd_dscale": 4e-3}
SERVE_KERNELS = ("rms_norm", "flash_attention_fwd", "flash_decode")
# Composition: the bf16 kernel route's relative L2 distance from the same
# model in f32 may be at most this multiple of the bf16 plain route's.
# Both routes round to bf16 at the same places except inside attention
# (the kernels keep P unnormalised in bf16 at prefill and in f32 at
# decode), so an honest kernel route sits about as far from f32 as the
# plain one; a wrong mask or scale would put it many times farther.
COMPOSE_RATIO = 1.5
# Train-variants: (relative loss difference, relative L2 distance of all
# gradients) from the reference step.  Remat recomputes the checkpointed
# forward with the same kernels on the same inputs, so its loss and
# gradients should repeat the base step's; 1e-6 and 1e-3 catch a
# recompute that saw other inputs (a lost segment id or position moves
# them by order 1) without failing on a reordered f32 sum.  The chunked
# head sums the loss in another order (f32, ~1e-7 a term), and its
# gradients, like those of 2 microbatches accumulated in f32, can round
# to the neighbouring bf16 value (2^-8 relative) where an f32 sum moved:
# 1e-5 on the loss and 1e-2 on the gradients.  The microbatches also run
# GEMMs of half the rows, which cuBLAS may tile differently in bf16, so
# their loss gets 1e-3.
VARIANT_TOL = {"remat_block": (1e-6, 1e-3), "remat_mlp": (1e-6, 1e-3),
               "ce_chunk_1024": (1e-5, 1e-2), "grad_accum_2": (1e-3, 1e-2)}

# Tiles, rings and slices of the attention kernels in ops/csrc (the
# constexprs of the .cu files; tests/test_torch_build_abi.py holds the two
# equal), so the edge cases reach one short of a tile, a whole tile, one
# past it, and one past a full ring: K2 streams 128-key tiles through 2
# stages; K3 holds 128 q rows a block and streams 128-key tiles through 2
# stages; K4 holds 128 keys a block and streams 64-row q tiles through 2
# stages; K5 gives each block of a cluster of at most 8 at least 64 keys,
# streamed in chunks of up to 64 keys through 4 stages.
K2_TILE, K2_STAGES = 128, 2
K3_ROWS, K3_KEYS, K3_STAGES = 128, 128, 2
K4_KEYS, K4_ROWS, K4_STAGES = 128, 64, 2
K5_SLICE, K5_CLUSTER, K5_CHUNK, K5_STAGES = 64, 8, 64, 4

# Serving phase: 4 right-padded rows, max_new_tokens 32.
PROMPT_LENS = (17, 128, 300, 512)
NEW_TOKENS = 32

# Schedule phase: the scheduler's pool (KFT_SERVE_SLOTS, _SLOT_LEN,
# _DECODE_QUANTUM).  llama3_8b's default slot length is its max_seq_len,
# 8192, a pool of 8.6 GB that K5 reads whole each step; 1024 holds the
# longest request here (900 + 64).  The K5 row at the pool shape takes its
# rows' visible lengths from POOL_LENS, plus one free row.
POOL_SLOTS, POOL_SLOT_LEN, POOL_QUANTUM = 8, 1024, 8
POOL_LENS = (1, 17, 300, 512, 544, 1023, 1024)
# name -> (prompt lengths, max_new_tokens, sampling): request A, four
# single rows, one seeded sampled request; 12 rows for 8 slots.
SCHEDULE_REQUESTS = {
    "A": (PROMPT_LENS, NEW_TOKENS, {}),
    "B8": ((33,), 8, {}),
    "B16": ((250,), 16, {}),
    "B48": ((64,), 48, {}),
    "B64": ((900,), 64, {}),
    "T": ((5, 60, 100, 400), 24, {"temperature": 0.8, "top_k": 40,
                                  "seed": 7}),
}
# Agreement with the lock path: every greedy token the pool emitted is
# within this of its row's largest logit under a teacher-forced prefill,
# unless twice the largest logit difference measured between the lock
# path's and the pool's decode (the two widths) is larger.
AGREE_GAP = 0.1

# Paged phase: the paged engine at the fixed pool's geometry (POOL_SLOTS
# lanes of POOL_SLOT_LEN slots, quantum POOL_QUANTUM) with its knobs'
# defaults: 64-token pages, 8 x 16 + 1 = 129 pages (the fixed pool's
# capacity and the null page, 1.08 GB) and 512-token prefill chunks, so
# the 900-token row prefills in two.  tests/test_torch_paged_smoke.py
# holds these against the knobs' defaults and checks.
PAGED_PAGE_LEN = 64
PAGED_PAGES = POOL_SLOTS * POOL_SLOT_LEN // PAGED_PAGE_LEN + 1
PAGED_CHUNK = 512
# Shared prefixes: a 320-token prefix (5 pages), suffixes of these
# lengths, sent one after another so the later ones hit the trie.
PREFIX_LEN = 320
PREFIX_SUFFIXES = (40, 90, 150, 200)
PREFIX_NEW_TOKENS = 24
# Page pressure: 40 pages (39 usable) for the schedule requests' 88:
# request A's 36 fit, all of them do not, so admissions wait for
# evictions to free pages.
PRESSURE_PAGES = 40
# Page pressure with the prefix cache on: the first shared-prefix request
# leaves its 5 prefix pages cached (34 free), a holder of these rows,
# prompt length and new tokens then takes 33, so the next shared-prefix
# request's lookup hits the chain while its own 2 pages are short and
# the chain is the only evictable leaf: it must wait, not evict its hit.
PRESSURE_HOLDER = (3, 640, 64)
# Speculative decoding: KFT_SERVE_SPEC_TOKENS's default; the drafts are
# the target itself and llama3_8b's width at DRAFT_LAYERS layers drawn
# from DRAFT_SEED.
SPEC_TOKENS = 4
DRAFT_LAYERS, DRAFT_SEED = 2, 1
# The depth a deployment runs: llama3_8b's max_seq_len, whose default
# pool is 8 x 128 + 1 = 1025 pages (8.6 GB).
DEEP_SLOT_LEN = 8192
# Serving under a mesh: tp_virtual splits llama3_8b's heads and MLP into
# TP_VIRTUAL tp shards (8 q over 2 kv heads, ffn 3584 a rank), run as
# virtual ranks in one process over TP_LAYERS layers: a ragged prefill of
# TP_LENS, then TP_STEPS greedy decode steps; K2 and K5 timed at one
# rank's heads (TP_K2_SHAPE b, s; TP_K5_SHAPE b, S).
TP_VIRTUAL, TP_LAYERS, TP_LENS, TP_STEPS = 4, 2, (300, 512), 8
TP_K2_SHAPE, TP_K5_SHAPE = (4, 512), (4, 512 + NEW_TOKENS)
# The vocabulary-parallel embedding and head at llama3_8b's vocabulary
# (128256 rows, 32064 a rank): the ranks' logits of TP_HEAD_ROWS hidden
# rows joined against the whole f32 head's, and the vocabulary-parallel
# loss against F.cross_entropy, each within TP_HEAD_TOL (relative): both
# are the same f32 products and sums in another order (~1e-7 a term).
TP_HEAD_ROWS, TP_HEAD_TOL = 16, 1e-5
# The encoders at ENCODER_COMPOSE_LAYERS layers, one forward and backward
# each, as TP_VIRTUAL virtual ranks where the rules split every weight so
# (vit_b16: 3 heads of 64, mlp 768 a rank), else fewer (bert_base: its
# 30522-token vocabulary splits over 2, 6 heads and mlp 1536 a rank).
# T5 at TP_VIRTUAL ranks (4 heads of 64, ffn 704 a rank), T5_GRAD_LAYERS
# encoder and decoder layers: a b2 source of T5_TP_LENS, T5_TP_STEPS
# greedy decode steps.
T5_TP_LENS, T5_TP_STEPS = (300, 217), 8
# BatchNorm over virtual data ranks: resnet50's b256 batch as this many
# ranks' rows; the merged statistics of every norm's input, and the
# ranks' running stats, within BN_MERGE_TOL (relative L2) of the whole
# batch's.  The ranks' outputs and gradients are held by their distance
# from the norm in f32 (COMPOSE_RATIO times the one-process norm's), at a
# floor of BN_F32_FLOOR where both compute in f32 (the scale's and bias's
# gradients: sums over up to 3.2M elements a channel in another order,
# through statistics held to BN_MERGE_TOL).
BN_DATA_RANKS, BN_MERGE_TOL, BN_F32_FLOOR = 2, 1e-5, 1e-4
# The image trainer over a mesh of one process (NCCL world size 1,
# dp=1): IMAGE_MESH_STEPS steps against the unbroken image-cli run's.
IMAGE_MESH_STEPS = 2
# K2 at a prefill chunk's shape: the 900-token row's second chunk.
CHUNK_B, CHUNK_SQ, CHUNK_SK = 1, 388, 900
# The dense-cache chunk (compose phase): a b2 ragged prompt prefilled in
# two chunks through ``Llama.forward(cache=)``, the second at cache index
# DENSE_CHUNKS[0]; K2 runs end-aligned causal over the written slots.
DENSE_CHUNKS = (512, 300)
DENSE_LENS = (812, 700)

# Training phase: the repo's training configuration at full width and
# depth, as the reference's bench trains it (b1 s8192, bf16 gradients).
TRAIN_MODEL = "llama_1b4"
TRAIN_SEQ = 8192
TRAIN_ARGS = ["--model", TRAIN_MODEL, "--batch", "1", "--seq",
              str(TRAIN_SEQ), "--grad-dtype", "bf16", "--steps", "6",
              "--log-every", "1"]
PACKED_ARGS = ["--model", TRAIN_MODEL, "--batch", "4", "--seq", "2048",
               "--grad-dtype", "bf16", "--steps", "2", "--log-every", "1",
               "--packed"]

# Sequence parallelism on one card: the ring's hops and the Ulysses head
# groups of SP virtual ranks, run in one process (two NCCL ranks cannot
# share a card).  Ring cases: (name, b, s, h, kv_h, d, causal); a causal
# ring of n ranks runs n (n + 1) / 2 hops, a dense one n * n.
SP = 4
RING_CASES = (("llama_1b4", 1, TRAIN_SEQ, 16, 16, 128, True),
              ("llama_1b4", 1, TRAIN_SEQ, 16, 16, 128, False),
              ("llama3_8b gqa", 1, 4096, 32, 8, 128, True))
ULYSSES_SHAPE = (1, TRAIN_SEQ, 16, 128)
# The trainer over a mesh of one process (NCCL world size 1): the same
# arguments as the train phase, sharded by llama_rules at fsdp=1.
MESH_ARGS = TRAIN_ARGS + ["--distributed", "--mesh", "fsdp=1"]
# Its losses against the train phase's, relative, at every step: the
# sharded step runs the one-process grad function on the same parameters
# (at world size 1 nothing is gathered or reduced and the loss's share is
# exactly 1), so only the kernels' own run-to-run rounding may differ; 1e-5
# as VARIANT_TOL's chunked head.  A step that applied no update or a wrong
# one moves the loss by more (the train phase's 5 updates move it ~1e-3).
MESH_LOSS_TOL = 1e-5

# The platform phase: the port's GPU pod pieces (``platform/gpu/pods.py``)
# for one GPU of this card, each container's command and env run as a
# subprocess the way the kubelet would start it.  A replica must answer
# /readyz within PLATFORM_READY_S of its start (llama3_8b built on the
# card from the seed, the default paged engine's pool, one warm
# generate).  The job phase: GPUJob "train" (MESH_ARGS at
# PLATFORM_JOB_TOTAL_STEPS steps) is preempted by GPUJob "urgent"
# (MESH_ARGS at PLATFORM_URGENT_STEPS steps) once step PLATFORM_JOB_STEPS
# has logged, and resumes from its checkpoint after "urgent" ends; each
# pod must end within PLATFORM_JOB_S of its start, and the jobs are
# reconciled every PLATFORM_RECONCILE_S.  The reference's job controller
# gives a preempted gang PREEMPTION_GRACE_S to checkpoint
# (kubeflow_tpu/platform/controllers/tpujob.py:84-87).
PLATFORM_ACCELERATOR = "h100-80gb"
PLATFORM_READY_S = 300.0
PLATFORM_JOB_STEPS = 2
PLATFORM_JOB_TOTAL_STEPS = 10
PLATFORM_URGENT_STEPS = 2
PLATFORM_JOB_S = 600.0
PLATFORM_RECONCILE_S = 1.0
PREEMPTION_GRACE_S = 30.0

# The serving front door (platform_serve): InferenceService "llama"
# (llama3_8b on one GPU, 0 to 1 replicas) parks at zero; request A through
# the activator wakes it.  Its idle window is cut from the reference's
# 300 s default (apis/inferenceservice.py DEFAULT_IDLE_SECONDS) to
# SERVE_IDLE_S and the controller's pass from its 10 s default
# (controllers/inferenceservice.py DEFAULT_SYNC_S) to SERVE_SYNC_S, so
# that the park after the request lands within the phase.  The replica's
# pods are admitted through the webhook over HTTPS, pinned to a pair the
# openssl command line makes, and a PodDefault sets SERVE_PODDEFAULT_ENV
# in them.
SERVE_IDLE_S = 5.0
SERVE_SYNC_S = 1.0
SERVE_PODDEFAULT_ENV = ("KFT_SMOKE_PODDEFAULT", "admitted")

# The notebook phase: the Notebook's pod runs one cell on the card,
# NOTEBOOK_CELL (``python -c`` in place of the image's Jupyter, which is
# not on this machine): NOTEBOOK_MODEL at full width and depth from
# SEED, one prompt of NOTEBOOK_PROMPT tokens drawn from SEED, greedy
# ``generate`` of NOTEBOOK_NEW tokens after one warm-up, then a generate
# of one token (the prefill alone) timed on its own.  The cell must end
# within NOTEBOOK_CELL_S.
NOTEBOOK_MODEL = "llama_1b4"
# The notebook phase's front door: the Profile's owner, the contributor
# KFAM binds, who spawns the notebook, and a user no binding names.
FRONT_OWNER = "alice@example.com"
FRONT_CONTRIBUTOR = "bob@example.com"
FRONT_STRANGER = "carol@example.com"
NOTEBOOK_PROMPT = 128
NOTEBOOK_NEW = 8
NOTEBOOK_CELL_S = 300.0
NOTEBOOK_CELL = """
import json, sys, time
import torch
from kubeflow_tpu_torch.models.generate import generate
from kubeflow_tpu_torch.models.serve import load_service
from kubeflow_tpu_torch.ops import cuda as kernels
from kubeflow_tpu_torch.telemetry import compute as ctel


def run(name, seed, prompt_len, new_tokens, device="cuda"):
    seed, prompt_len, new_tokens = int(seed), int(prompt_len), int(new_tokens)
    t0 = time.perf_counter()
    model = load_service(name, device=device, seed=seed,
                         use_scheduler=False).model
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(1, model.cfg.vocab_size, (1, prompt_len),
                           generator=gen).to(device)
    generate(model, prompt, max_new_tokens=new_tokens)   # warm-up
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    kernels.reset_launch_counts()
    routes = {i: ctel.attention_impl_calls(i) for i in ("kernel", "plain")}
    t1 = time.perf_counter()
    out = generate(model, prompt, max_new_tokens=new_tokens)
    sync()
    generate_ms = (time.perf_counter() - t1) * 1e3
    launches = kernels.launch_counts()
    routes = {i: ctel.attention_impl_calls(i) - v for i, v in routes.items()}
    # The prefill alone: a generate of one token runs no decode step.
    t2 = time.perf_counter()
    generate(model, prompt, max_new_tokens=1)
    sync()
    prefill_ms = (time.perf_counter() - t2) * 1e3
    return {"tokens": out.tolist(), "launches": launches, "routes": routes,
            "n_layers": model.cfg.n_layers, "generate_ms": generate_ms,
            "prefill_ms": prefill_ms,
            "decode_step_ms": (generate_ms - prefill_ms) / (new_tokens - 1),
            "cell_seconds_in_process": time.perf_counter() - t0,
            "device": (torch.cuda.get_device_name(0) if device == "cuda"
                       else device)}


if __name__ == "__main__":
    print("CELL " + json.dumps(run(*sys.argv[1:])), flush=True)
"""

# The manager phase: the notebook's pod is a stand-in for Jupyter's
# kernels API (``python -c NOTEBOOK_KERNELS <port> <cell args>``): a
# standard-library HTTP server on ``$NB_PREFIX/api/kernels`` answering
# one kernel in Jupyter's JSON shape, ``busy`` while NOTEBOOK_CELL runs
# on the card and ``idle`` after, its ``last_activity`` the cell's end;
# it prints the cell's ``CELL`` line and serves until SIGTERM, then
# exits 0.  The culler stops the notebook PLATFORM_IDLE_MINUTES after
# that end, probing every PLATFORM_CHECK_MINUTES; GPUJob ``train``
# (MESH_ARGS at MANAGER_JOB_STEPS steps) waits Queued behind it.
PLATFORM_IDLE_MINUTES = 0.1
PLATFORM_CHECK_MINUTES = 0.02
MANAGER_JOB_STEPS = 2
# The manager phase's watch window over the wire: every watch the client
# opens closes after this many seconds and resumes from its version.
MANAGER_WATCH_WINDOW_S = 5
# The sharded phase: the fleet test's own timings (a 2 s lease renewed
# every 0.2 s over 8 shards), 3 replicas and the presubmit wave of 200
# notebooks, which must converge within SHARD_WAVE_S.
SHARD_REPLICAS = 3
SHARD_COUNT = 8
SHARD_LEASE_S = 2.0
SHARD_RENEW_S = 0.2
SHARD_WAVE = 200
SHARD_WAVE_S = 60.0
KUBELET_FINALIZER = "kubelet.smoke/container-running"
NOTEBOOK_KERNELS = """
import datetime, http.server, json, os, signal, sys, threading, time

CELL = %r


def stamp(t):
    return datetime.datetime.fromtimestamp(
        t, datetime.timezone.utc).strftime("%%Y-%%m-%%dT%%H:%%M:%%S.%%fZ")


kernel = {"id": "0b1e7a2c", "name": "python3", "connections": 1,
          "execution_state": "busy", "last_activity": stamp(time.time())}
path = os.environ["NB_PREFIX"] + "/api/kernels"


class Kernels(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        if self.path != path:
            self.send_error(404)
            return
        body = json.dumps([dict(kernel)]).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: stop.set())
server = http.server.ThreadingHTTPServer(("127.0.0.1", int(sys.argv[1])),
                                         Kernels)
threading.Thread(target=server.serve_forever, daemon=True).start()
print("SERVING", flush=True)
cell = {"__name__": "notebook_cell"}
exec(CELL, cell)
out = cell["run"](*sys.argv[2:])
end = time.time()
kernel.update(execution_state="idle", last_activity=stamp(end))
print("CELL " + json.dumps(dict(out, cell_end=end)), flush=True)
stop.wait()
server.shutdown()
""" % NOTEBOOK_CELL

# The int8 phase: llama3_8b from the same seed, weight-only int8
# (load_service(quantize="int8")), the schedule requests through the paged
# engine at the paged phase's geometry.
INT8_MODEL = "llama3_8b"

# The Mixtral phases: mixtral_8x7b at full width (dim 4096, ffn 14336, 8
# experts, top 2, 32 q over 8 kv heads), depth cut.  All 32 layers are
# 46.70 B parameters, 93.7 GB in bf16 with the f32 head, more than one
# 80 GB card; 8 layers are 11.87 B, 24.0 GB, and 1 layer trains in f32
# masters with AdamW's moments.
MOE_MODEL = "mixtral_8x7b"
MOE_SERVE_LAYERS = 8
MOE_TRAIN_LAYERS = 1
# The MoE layer alone: b2 (the second row half padded), at these lengths.
MOE_LAYER_SEQS = (512, 2048)
# The index dispatch's bf16 output against the dense one-hot einsums'
# (the reference's, moe.dense_dispatch) on the same weights: both copy
# the same bf16 tokens into the expert buffers and run the same expert
# products, but round the combine in other places (an f32 sum of the two
# gated rows rounded once, against a bf16 GEMM over the capacity axis),
# about 2^-9 relative an element: relative L2 <= 1e-2.  The aux loss is
# computed from the same f32 routing: within 1e-6.
MOE_LAYER_TOL, MOE_AUX_TOL = 1e-2, 1e-6
# Served over HTTP at the paged phase's geometry: four greedy single-row
# requests (the 900-token one prefills in two 512-token chunks) and a
# seeded sampled one, 32 new tokens each.
MOE_REQUESTS = {
    "G17": ((17,), NEW_TOKENS, {}), "G300": ((300,), NEW_TOKENS, {}),
    "G512": ((512,), NEW_TOKENS, {}), "G900": ((900,), NEW_TOKENS, {}),
    "T300": ((300,), NEW_TOKENS, {"temperature": 0.8, "top_k": 40,
                                  "seed": 7}),
}
# Training: b1 s2048, bf16 gradients, the aux loss weighted 0.01, 3 steps
# on one batch (so the loss must fall), AdamW at lr 1e-3.
MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2048, 3
MOE_AUX_WEIGHT, MOE_TRAIN_LR = 0.01, 1e-3

# The image task and the encoders, as the reference's bench sets them up
# (bench.py ``_resnet_setup``, ``_vit_setup``): ResNet-50 at b256 on 224
# px images, bf16 compute on f32 masters and batch stats, SGD 0.1 with
# Nesterov momentum 0.9; ViT-B/16 at b64, bf16, AdamW 3e-4; BERT-base
# fine-tuning at b32 s128, 2 classes, AdamW 3e-4.  Each takes
# ENCODER_STEPS steps on one batch (its first pays cuDNN's algorithm
# choice and the allocator's warm-up), then ENCODER_PROFILED under
# torch.profiler.
IMAGE_SIZE = 224
RESNET_MODEL, RESNET_BATCH = "resnet50", 256
VIT_MODEL, VIT_BATCH = "vit_b16", 64
BERT_MODEL, BERT_BATCH, BERT_SEQ, BERT_CLASSES = "bert_base", 32, 128, 2
ENCODER_STEPS, ENCODER_PROFILED = 5, 3
# The kernel route against impl="plain" (and an f32 plain model) at full
# width: the layers kept.
ENCODER_COMPOSE_LAYERS = 2
# Attention kernels at the encoders' shapes, non-causal, h12 over 12 kv
# heads, d64: (batch, seq) of ViT-B/16 (196 patches and the CLS token)
# and of BERT-base.
ENCODER_ATTENTION = {"vit_b16": (VIT_BATCH, 197), "bert_base":
                     (BERT_BATCH, BERT_SEQ)}
# train.run --task image with --checkpoint-dir: an unbroken run of
# IMAGE_CLI_STEPS against a run stopped at IMAGE_CLI_STOP and resumed.
IMAGE_CLI_ARGS = ["--task", "image", "--model", RESNET_MODEL, "--batch",
                  str(RESNET_BATCH), "--image-size", str(IMAGE_SIZE),
                  "--log-every", "1", "--checkpoint-every", "2"]
IMAGE_CLI_STEPS, IMAGE_CLI_STOP = 4, 2
# The resumed run against the unbroken one, with cuDNN's deterministic
# algorithms: the weights as one vector, and each batch-stat tensor, by
# relative L2.  The max-pool's backward adds overlapping windows' terms
# with atomics, so two runs may differ by f32 rounding, ~1e-7 a step at
# the trainer's lr 3e-4; 1e-5 is far below what one skipped or repeated
# step moves (lr x gradient, ~1e-3 of the weights).
RESUME_TOL = 1e-5
# The slow-step capture: the threshold, and the first batch held back by
# the input pipeline for longer (a stall), so that step is slow and the
# next one, the profiled one (its trace written inside its dispatch
# span: 0.94 s on the card for a ResNet-50 step), is not.
SLOW_STEP_SECONDS, SLOW_STALL_SECONDS = 3.0, 3.5

# Beam search: ``beam_search`` on the bf16 llama3_8b the serving
# phases loaded (32 layers), b2 with ragged prompts, BEAMS beams,
# NEW_TOKENS new tokens, no EOS.  Its launches are request A's: K2 a
# layer at the prefill, K5 a layer a step (over b x BEAMS rows), K1 65 a
# forward.
BEAM_PROMPT_LENS = (300, 17)
BEAMS = 4
# The best of BEAMS beams, rescored (length penalty 0) on the route the
# search scored it on, may fall this far a token (nats, times the row's
# new tokens) below 1 beam's sequence.  A search of width 4 is not bound
# to beat greedy: it may prune the greedy path and end below it (on an
# H100, 1.18 nats under over 32 tokens on one of this phase's rows, both
# sequences scored on the search's route).  A broken re-gather or
# backtrack puts a wrong token in the sequence, ~5 nats each at these
# random weights' logit scale (the top logit against a typical one over
# 128256 or 32128 tokens), above 0.1 x 32 = 3.2.  The
# rescoring runs the prompt's prefill and one cached decode step a token
# over b rows where the search ran b x BEAMS (summation orders differ,
# ~1e-3 a token).  One teacher-forced forward (K2 over the whole
# sequence) scores by another route: its comparison gets the same limit
# plus the two sequences' measured disagreement between the routes.
BEAM_SCORE_TOL = 0.1

# T5: t5_large at full width and depth (24 + 24 layers, d1024,
# 16 heads of 64, ffn 2816, vocab 32128, 785M parameters), random bf16
# weights from SEED, served over HTTP through ``load_service`` and the
# wire client: sources of these lengths, T5_NEW_TOKENS new tokens; beam
# search at T5_BEAM_NEW_TOKENS; the gradient check at T5-large's width
# with T5_GRAD_LAYERS encoder and decoder layers, target length
# T5_GRAD_TARGET.
#
# The random weights are the reference's flax initialisers but for one
# factor: W_q is scaled by head_dim ** -0.5 (``t5_conditioned``), T5's own
# initialisation (Mesh TensorFlow's T5 and Hugging Face's
# ``T5PreTrainedModel._init_weights`` draw W_q with std
# (d_model * d_kv) ** -0.5, folding the softmax scale into the weights).
# Flax's lecun_normal draws it with std d_model ** -0.5, so the unscaled
# attention's logits have std sqrt(64) = 8, the softmax is near an
# argmax, and the 48-layer model is chaotic: on an H100 two bf16 routes
# that differ in rounding alone disagreed on 65 % of greedy tokens
# (teacher-forced logits 1.1 apart by relative L2).  The factor is a
# power of two, exact in bf16 and in int8's f32 scales.
T5_MODEL = "t5_large"
T5_SOURCE_LENS = (512, 300, 77, 17)
T5_NEW_TOKENS = 64
T5_BEAM_NEW_TOKENS = 32
T5_GRAD_LAYERS, T5_GRAD_TARGET = 2, 128
# K1 at T5-large's rows: the encoder at b4 s512, a beam step at b4 x BEAMS.
T5_NORM_ROWS = {"t5 encoder": 4 * 512, "t5 beam step": 4 * BEAMS}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, flops_peak: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def add_rates(row, flops, floor_ms=None):
    """A timed row's achieved rate and roofline share: ``tflops`` is the
    flops its bound counts (visible pairs for attention) over the kernel's
    time, ``bound_share`` is bound_ms / kernel_ms; with the timer's floor,
    ``net_bound_share`` is bound_ms / (kernel_ms - floor).  (K1's rows
    also carry ``same_bytes_ms``: the timer's reading of one PyTorch
    elementwise op that moves the same bytes, a copy for the forward and
    an add of x and g for the backward, the practical floor of a
    bytes-bound kernel under this timer, whose L2 flush leaves dirty lines
    for the timed call to write back.)"""
    row["tflops"] = flops / (row["kernel_ms"] * 1e-3) / 1e12
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    if floor_ms is not None and row["kernel_ms"] > floor_ms:
        row["net_bound_share"] = row["bound_ms"] / (row["kernel_ms"]
                                                    - floor_ms)
    return row


class Timer:
    """CUDA-event timing of one call's device time: median over runs.
    Before each run a 64 MiB write evicts the inputs from L2 (the serving
    path evicts them between uses: a layer's weights are larger than L2),
    then a ~1 ms device-side sleep lets the host enqueue the call before
    the start event fires, so host overhead stays out of the reading."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self.floor_ms = None    # its reading of a kernel that does no work

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(TIMING_RUNS):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def check_close(name, got, want, tol):
    """Elementwise |got - want| <= tol + tol * |want|.  Returns the max
    abs error and the largest share of its limit any element uses (the
    check fails above 1)."""
    torch = sys.modules["torch"]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got - want).abs()
    err = diff.max().item()
    share = (diff / (tol + tol * want.abs())).max().item()
    if share > 1.0:
        raise AssertionError(f"{name}: max abs err {err} beyond "
                             f"atol=rtol={tol} (share {share})")
    return err, share


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi[0] if smi else "",
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def phase_build():
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.platform import native
    from kubeflow_tpu_torch.platform.runtime import metrics

    # The engine's g++ runs while nvcc does.
    engine = threading.Thread(target=native.preload, name="native-build")
    engine.start()
    _build.build(force=True, verbose=True)
    _build.library()
    engine.join()
    usage = [ln.strip() for ln in _build.last_build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    components = native.engine_components()
    gauges = {c: metrics.native_engine_active.sample(component=c)
              for c in native.ENGINE_COMPONENTS}
    if (not native.loaded() or not all(components.values())
            or set(gauges.values()) != {1.0}):
        raise AssertionError(f"build: native engine not active "
                             f"({native.load_error()}): {components}, "
                             f"gauges {gauges}")
    emit({"phase": "build", "seconds": round(_build.last_build_seconds, 3),
          "sources": [p.name for p in _build.sources()], "ptxas": usage,
          "native": {"seconds": native.last_build_seconds,
                     "cached": native.last_build_cached,
                     "library": os.path.relpath(
                         native.LIB_PATH,
                         os.path.dirname(os.path.abspath(__file__))),
                     "sources": list(native.SOURCES),
                     "components": components}})


def phase_kernels(torch, dev, timer):
    """Each kernel against its plain version; returns the summary row per
    kernel (the shape the serving path calls it at most often)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)
    rows = {}
    # The timer's floor: its reading of a kernel that does no work (a
    # one-element fill).  A row that reads near it is launch latency.
    one = torch.zeros(1, device=dev)
    timer.floor_ms = timer(one.zero_)
    emit({"phase": "timer", "one_element_fill_ms": timer.floor_ms})

    # K1: prefill rows (4 x 512 tokens) and decode rows (4 tokens).
    d = 4096
    scale = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).float()
    for nrows, where in ((4 * 512, "prefill"), (4, "decode")):
        row = k1_row(torch, timer, rnd(nrows, d), scale, where)
        if where == "decode":
            rows["rms_norm"] = row

    # K2: causal prefill, b=4, h=32 over kv_h=8, d=128; 300 is ragged.
    b, h, kvh, hd = 4, 32, 8, 128
    cases = [(512, False), (300, False), (512, True)]
    for s, packed in cases:
        seg = None
        if packed:
            # Three documents per row, boundaries differing per row.
            pos = torch.arange(s, device=dev)[None]
            cut = torch.tensor([[100, 250], [37, 400], [256, 300],
                                [1, 511]], device=dev)
            seg = 1 + (pos >= cut[:, :1]).int() + (pos >= cut[:, 1:]).int()
        row = k2_row(torch, dev, rnd, timer, b, s, h, kvh, hd, seg)
        if s == 512 and not packed:
            rows["flash_attention_fwd"] = row
    emit(chunk_k2_row(torch, dev, timer, b=len(DENSE_LENS),
                      sq=DENSE_CHUNKS[1], sk=sum(DENSE_CHUNKS),
                      path="dense-cache prefill chunk at index "
                           f"{DENSE_CHUNKS[0]} (end-aligned causal)"))

    # K5: one decode token over S = prompt + 32 slots, padded rows masked;
    # and one long row (b1 S8192), whose cache is 33.5 MB.
    for b, S in ((4, 512 + NEW_TOKENS), (4, 1000), (1, 8192)):
        row = k5_row(torch, dev, rnd, timer, b, S, h, kvh, hd)
        if S == 512 + NEW_TOKENS:
            rows["flash_decode"] = row
    emit(add_rates(*pool_decode_row(torch, dev, gen, timer)))
    return rows


def k1_row(torch, timer, x, scale, path):
    """K1 over bf16 rows ``x`` [rows, d] and f32 ``scale`` [d] against
    its plain version, timed beside its bound, a copy of the same bytes
    and ``F.rms_norm``; emitted and returned."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    nrows, d = x.shape
    got = k1.rms_norm(x, scale, eps=1e-5)
    want = k1.plain_rms_norm(x.float(), scale, eps=1e-5)
    tol = KERNEL_TOL["rms_norm"]
    err, share = check_close("rms_norm", got, want, tol)
    nbytes = nrows * d * 4 + d * 4
    flops = 4 * nrows * d
    bms, by = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
    row = {"kernel": "rms_norm", "shape": [nrows, d], "path": path,
           "max_abs_err": err, "tol": tol, "tol_share": share,
           "kernel_ms": timer(lambda: k1.rms_norm(x, scale, eps=1e-5)),
           "plain_ms": timer(lambda: k1.plain_rms_norm(x, scale, eps=1e-5)),
           "library_ms": timer(lambda: F.rms_norm(
               x, (d,), weight=scale.to(torch.bfloat16), eps=1e-5)),
           "same_bytes_ms": timer(lambda: got.copy_(x)),
           "bound_ms": bms, "bound_by": by}
    emit(add_rates(row, flops, timer.floor_ms))
    return row


def k2_row(torch, dev, rnd, timer, b, s, h, kvh, hd, seg=None, path=None):
    """K2 causal over random bf16 q [b, s, h, hd] and k/v at ``kvh``
    heads (``seg``: segment ids) against its plain version, timed beside
    its bound and SDPA; emitted and returned."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import flash_attention as k2

    packed = seg is not None
    q, k, v = rnd(b, s, h, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
    got = k2.flash_attention(q, k, v, causal=True, segment_ids=seg)
    want = k2.plain_attention(q.float(), k.float(), v.float(),
                              causal=True, segment_ids=seg)
    tol = KERNEL_TOL["flash_attention_fwd"]
    err, share = check_close("flash_attention_fwd", got, want, tol)
    vis = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
    if seg is not None:
        vis = vis[None] & (seg[:, :, None] == seg[:, None, :])
        pairs = vis.sum().item() * h
    else:
        pairs = vis.sum().item() * h * b
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
    flops = 4 * pairs * hd
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if seg is None:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=vis[:, None], enable_gqa=True)
    row = {"kernel": "flash_attention_fwd", "shape": [b, s, h, kvh, hd],
           "segments": packed, "path": path or "prefill",
           "max_abs_err": err,
           "tol": tol, "tol_share": share,
           "kernel_ms": timer(lambda: k2.flash_attention(
               q, k, v, causal=True, segment_ids=seg)),
           "plain_ms": timer(lambda: k2.plain_attention(
               q, k, v, causal=True, segment_ids=seg)),
           "library_ms": timer(lib), "bound_ms": bms, "bound_by": by}
    emit(add_rates(row, flops))
    return row


def k5_row(torch, dev, rnd, timer, b, S, h, kvh, hd, path=None):
    """K5 over a random bf16 cache [b, S, kvh, hd], rows of 17, 128, 300
    and S visible slots (one row of S when b is 1), against its plain
    version, timed beside its bound and SDPA; emitted and returned."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5

    bf = torch.bfloat16
    q = rnd(b, 1, h, hd)
    k, v = rnd(b, S, kvh, hd), rnd(b, S, kvh, hd)
    lens = [[17], [128], [300], [S]] if b == 4 else [[S]]
    valid = torch.arange(S, device=dev)[None] < torch.tensor(
        lens, device=dev)
    bias = torch.where(valid, 0.0, -1e30).float().contiguous()
    got = k5.flash_decode(q, k, v, bias)
    want = k5.plain_decode(q.float(), k.float(), v.float(), bias)
    tol = KERNEL_TOL["flash_decode"]
    err, share = check_close("flash_decode", got, want, tol)
    nbytes = 2 * b * S * kvh * hd * 2 + b * S * 4 + 2 * b * h * hd * 2
    flops = 4 * b * h * S * hd
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = bias[:, None, None, :].to(bf)
    row = {"kernel": "flash_decode", "shape": [b, S, h, kvh, hd],
           "path": path or "decode", "max_abs_err": err, "tol": tol,
           "tol_share": share,
           "kernel_ms": timer(lambda: k5.flash_decode(q, k, v, bias)),
           "plain_ms": timer(lambda: k5.plain_decode(q, k, v, bias)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, enable_gqa=True)),
           "bound_ms": bms, "bound_by": by}
    emit(add_rates(row, flops))
    return row


def pool_decode_row(torch, dev, gen, timer):
    """K5 at the scheduler's pool shape: q [8, 1, 32, 128] over a cache
    [8, 1024, 8, 128] whose rows see POOL_LENS slots (causal bias, as a
    pool step builds it) and one free row fully masked as the pool masks
    it (pad -1e30 on every slot, written at slot 0).  Behind every mask
    lies finite garbage 50x the live values.  The bound counts the slots
    this data needs: each row's slots at its largest bias."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5

    bf = torch.bfloat16
    b, S, h, kvh, hd = POOL_SLOTS, POOL_SLOT_LEN, 32, 8, 128
    lens = torch.tensor(POOL_LENS + (1,), device=dev)
    live = torch.arange(S, device=dev)[None] < lens[:, None]
    live[-1] = False
    scale = torch.where(live, 1.0, 50.0)[:, :, None, None]
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(bf)
    k = (torch.randn(b, S, kvh, hd, generator=gen, device=dev)
         * scale).to(bf)
    v = (torch.randn(b, S, kvh, hd, generator=gen, device=dev)
         * scale).to(bf)
    causal = torch.where(torch.arange(S, device=dev)[None] < lens[:, None],
                         0.0, -1e30)
    pad = torch.zeros(b, S, device=dev)
    pad[-1] = -1e30
    bias = (causal + pad).float().contiguous()
    got = k5.flash_decode(q, k, v, bias)
    want = k5.plain_decode(q.float(), k.float(), v.float(), bias)
    tol = KERNEL_TOL["flash_decode"]
    err, share = check_close("flash_decode pool", got, want, tol)
    needed = (bias == bias.amax(dim=1, keepdim=True)).sum().item()
    nbytes = 2 * needed * kvh * hd * 2 + b * S * 4 + 2 * b * h * hd * 2
    flops = 4 * h * hd * needed
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = bias[:, None, None, :].to(bf)
    row = {"kernel": "flash_decode", "shape": [b, S, h, kvh, hd],
           "path": "schedule pool", "visible_lens": list(POOL_LENS),
           "free_rows": 1, "needed_slots": needed, "max_abs_err": err,
           "tol": tol, "tol_share": share,
           "kernel_ms": timer(lambda: k5.flash_decode(q, k, v, bias)),
           "plain_ms": timer(lambda: k5.plain_decode(q, k, v, bias)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, enable_gqa=True)),
           "bound_ms": bms, "bound_by": by}
    return row, flops


def edge_segments(torch, dev, gen, kind, b, s):
    """Segment ids [b, s] int32 for an edge case, or None.  "blocks": runs
    of 50 (at s300 without the causal mask, tiles whose id ranges do not
    meet are skipped by K2 and K4); "pads": row 0 two documents and a pad tail, row 1 pad rows
    first (segment 0 attends only to segment 0), then two documents;
    "random": ids drawn from {1, 2, 3} per position (not monotone, no
    runs); "permuted": runs of 50 at positions permuted at random;
    "lone": runs of 50 whose row 0 is a one-token segment, so row 0 sees
    no key in any kv tile past the first."""
    if kind is None:
        return None
    pos = torch.arange(s, device=dev)
    if kind == "pads":
        seg = torch.stack([
            torch.where(pos < 50, 1, torch.where(pos < s - 20, 2, 0)),
            torch.where(pos < 10, 0, torch.where(pos < 70, 1, 2))])[:b]
    elif kind == "random":
        seg = torch.randint(1, 4, (b, s), generator=gen, device=dev)
    else:
        seg = (pos // 50 + 1).expand(b, s).clone()
        if kind == "permuted":
            seg = torch.stack([row[torch.randperm(s, generator=gen,
                                                  device=dev)]
                               for row in seg])
        elif kind == "lone":
            seg[:, 0] = -7
    return seg.int().contiguous()


def decode_bias(torch, dev, kind, b, S):
    """A K5 bias [b, S] f32 of -1e30 (the reference's pad value) and 0:
    "thirds" masks every third slot; "block" also masks the whole slice
    of the second block of a cluster of min(K5_CLUSTER, S // K5_SLICE)
    blocks (the first when there is one; where the card holds fewer such
    clusters at once than the grid has, the kernel takes smaller clusters
    and the run spans two slices); "all" masks every slot of row 0 (it
    averages V uniformly)."""
    pos = torch.arange(S, device=dev)
    masked = (pos % 3 == 1)[None].expand(b, S).clone()
    if kind == "block":
        n = max(1, min(K5_CLUSTER, S // K5_SLICE))
        per = -(-S // n)
        r = 1 if n > 1 else 0
        masked |= ((pos >= r * per) & (pos < (r + 1) * per))[None]
    elif kind == "all":
        masked[0] = True
    return torch.where(masked, -1e30, 0.0).float().contiguous()


def phase_edges(torch, dev):
    """The shapes the kernels accept beyond the serving path's, each
    against its plain version (untimed): f32 and narrow/wide rows for K1;
    head_dim 64, no mask, cross-length causal, one query or one key,
    key counts around K2's tile and ring, sq 8191, GQA 8 at head_dim 64,
    and segment ids in runs, drawn at random, permuted, or with a
    one-token segment for K2; for K5 every GQA group size, head_dim 64,
    S = 1, lengths around its slice, cluster, chunk and ring, b1 S8192,
    and bias rows that mask every third slot, one whole block's slice
    (``decode_bias``), or every slot of a row."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as k2
    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5
    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(
        *s, generator=gen, device=dev).to(dt)
    # Per kernel: cases run, and the case that used most of its limit.
    worst = {name: {"cases": 0, "tol": KERNEL_TOL[name], "tol_share": 0.0}
             for name in SERVE_KERNELS}

    def check(kernel, case, got, want):
        err, share = check_close(f"{kernel} {case}", got, want,
                                 KERNEL_TOL[kernel])
        w = worst[kernel]
        w["cases"] += 1
        if share >= w["tol_share"]:
            w.update(tol_share=share, max_abs_err=err, case=case)

    # (rows, d, x dtype, scale dtype): widths from 8 to the widest a row
    # held in registers takes (16384 bf16, 8192 f32), row counts that
    # leave the grid's last pass ragged, both scale dtypes.
    f32, bf = torch.float32, torch.bfloat16
    for rows, d, dt, st in ((5, 8, f32, f32), (3, 4104, bf, f32),
                            (7, 4096, f32, f32), (2, 64, bf, bf),
                            (1000, 2048, bf, bf), (8193, 2048, bf, f32),
                            (300, 4096, bf, bf), (9, 16384, bf, f32),
                            (5, 8192, f32, bf)):
        x, scale = rnd(rows, d, dt=dt), rnd(d, dt=st)
        check("rms_norm", f"{rows}x{d} {str(dt)[6:]} scale {str(st)[6:]}",
              k1.rms_norm(x, scale), k1.plain_rms_norm(x.float(), scale))
    # (b, sq, sk, h, kv_h, d, causal, segments)
    tile_edges = (K2_TILE - 1, K2_TILE, K2_TILE + 1,
                  K2_STAGES * K2_TILE + 1)
    for b, sq, sk, h, kvh, d, causal, segs in (
            (2, 100, 100, 4, 4, 64, True, None),
            (1, 77, 77, 8, 2, 128, False, None),
            (2, 37, 200, 4, 1, 128, True, None),
            (1, 1, 1, 2, 1, 128, True, None),
            (2, 1, 130, 4, 2, 64, True, None),
            (1, 130, 130, 4, 2, 128, True, "blocks"),
            (1, 64, 1, 4, 2, 128, False, None),
            *((1, n, n, 4, 2, 128, True, None) for n in tile_edges),
            *((1, 50, n, 4, 2, 64, False, None) for n in tile_edges),
            (1, 8191, 8191, 2, 1, 128, True, None),
            (1, 129, 300, 4, 2, 128, True, None),
            (2, 200, 200, 8, 1, 64, True, None),
            (2, 300, 300, 4, 2, 128, False, "blocks"),
            (2, 300, 300, 4, 2, 128, True, "random"),
            (1, 257, 257, 4, 4, 64, False, "random"),
            (2, 300, 300, 4, 2, 128, True, "permuted"),
            (1, 300, 300, 4, 2, 128, False, "lone")):
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d)
        seg = edge_segments(torch, dev, gen, segs, b, sq)
        check("flash_attention_fwd",
              f"b{b} sq{sq} sk{sk} h{h}/{kvh} d{d} causal={causal} "
              f"segments={segs}",
              k2.flash_attention(q, k, v, causal=causal, segment_ids=seg),
              k2.plain_attention(q.float(), k.float(), v.float(),
                                 causal=causal, segment_ids=seg))
    # (b, S, h, kv_h, d, bias)
    lengths = sorted({1, K5_SLICE - 1, K5_SLICE, K5_SLICE + 1,
                      K5_CHUNK - 1, K5_CHUNK, K5_CHUNK + 1,
                      K5_CLUSTER * K5_SLICE - 1, K5_CLUSTER * K5_SLICE,
                      K5_CLUSTER * K5_SLICE + 1,
                      K5_CLUSTER * (K5_STAGES * K5_CHUNK + 1)})
    cases = [(3, 1, 8, 8, 128, "thirds"), (2, 63, 4, 2, 64, "thirds"),
             (2, 65, 8, 2, 128, "thirds"), (1, 300, 8, 1, 64, "thirds"),
             (2, 129, 16, 2, 128, "thirds")]
    cases += [(2, n, 8, 2, 128, "thirds") for n in lengths]
    cases += [(1, n, 16, 2, 64, "block") for n in lengths if n > 1]
    cases += [(1, 8192, 32, 8, 128, "thirds"), (2, 8192, 8, 8, 64, "block"),
              (2, 544, 32, 8, 128, "all"), (2, 100, 4, 4, 64, "all"),
              (2, 2000, 16, 4, 128, "block")]
    for b, S, h, kvh, d, kind in cases:
        q, k, v = rnd(b, 1, h, d), rnd(b, S, kvh, d), rnd(b, S, kvh, d)
        bias = decode_bias(torch, dev, kind, b, S)
        check("flash_decode", f"b{b} S{S} h{h}/{kvh} d{d} bias={kind}",
              k5.flash_decode(q, k, v, bias),
              k5.plain_decode(q.float(), k.float(), v.float(), bias))
    emit({"phase": "edges", "worst_by_kernel": worst})


def ragged_batch(torch, dev, vocab, lens):
    import numpy as np

    rs = np.random.RandomState(SEED)
    longest = max(lens)
    toks = [rs.randint(0, vocab, size=n).tolist() for n in lens]
    prompt = torch.tensor([t + [0] * (longest - len(t)) for t in toks],
                          device=dev)
    mask = torch.arange(longest, device=dev)[None] < torch.tensor(
        lens, device=dev)[:, None]
    return toks, prompt, mask


def phase_compose(torch, dev):
    """Full-width llama3_8b, 2 layers, the same weights three ways: bf16
    through the kernels (impl="auto"), bf16 plain (impl="plain"), and an
    f32 copy on the plain route as the reference.  Compared on the prefill
    logits at each row's last prompt token and on one decode step's
    logits: the kernel route must be no farther from the f32 model than
    COMPOSE_RATIO times the plain route."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.generate import pad_bias_rows, prompt_positions

    variants = {"auto": dict(impl="auto"), "plain": dict(impl="plain"),
                "f32": dict(impl="plain", dtype=torch.float32)}
    models = {name: create_model("llama3_8b", device=dev, n_layers=2, **kw)
              for name, kw in variants.items()}
    with torch.no_grad():
        models["auto"].reset_parameters(
            torch.Generator(device=dev).manual_seed(SEED))
    for name in ("plain", "f32"):
        models[name].load_state_dict(models["auto"].state_dict())
    _, prompt, mask = ragged_batch(torch, dev, 128256, PROMPT_LENS)
    positions, lengths = prompt_positions(mask)
    pad_bias = pad_bias_rows(mask, prompt.shape[1] + 1)
    nxt = torch.arange(len(PROMPT_LENS), device=dev)[:, None] + 7
    out = {}
    for name, model in models.items():
        with torch.inference_mode():
            cache = model.new_cache(len(PROMPT_LENS), prompt.shape[1] + 1)
            pre = model(prompt, positions=positions, cache=cache,
                        pad_bias=pad_bias, logits_at=lengths - 1)
            dec = model(nxt, positions=lengths[:, None], cache=cache,
                        pad_bias=pad_bias)[:, 0]
        out[name] = pre.float(), dec.float()
        del cache
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    row = {"phase": "compose", "model": "llama3_8b", "n_layers": 2,
           "prompt_lens": list(PROMPT_LENS), "ratio_limit": COMPOSE_RATIO}
    for i, step in enumerate(("prefill", "decode")):
        ref = out["f32"][i]
        for name in ("auto", "plain"):
            if not torch.isfinite(out[name][i]).all():
                raise AssertionError(f"compose {step} {name}: non-finite")
        e_auto, e_plain = rel(out["auto"][i], ref), rel(out["plain"][i], ref)
        row[f"{step}_rel_l2_kernel_vs_f32"] = e_auto
        row[f"{step}_rel_l2_plain_vs_f32"] = e_plain
        row[f"{step}_rel_l2_kernel_vs_plain"] = rel(out["auto"][i],
                                                    out["plain"][i])
        row[f"{step}_max_abs_err_kernel_vs_f32"] = (
            out["auto"][i] - ref).abs().max().item()
        if e_auto > COMPOSE_RATIO * e_plain:
            raise AssertionError(
                f"compose {step}: kernel route {e_auto} from the f32 model, "
                f"more than {COMPOSE_RATIO} x the plain route's {e_plain}")
    row["greedy_agreement_kernel_vs_f32"] = (
        out["auto"][0].argmax(-1) == out["f32"][0].argmax(-1)
    ).float().mean().item()
    dense = dense_chunk_compose(torch, dev, models)
    emit(row)
    emit({"phase": "compose_dense_chunk", **dense})
    del models, out
    torch.cuda.empty_cache()


def dense_chunk_compose(torch, dev, models):
    """The DENSE_LENS rows prefilled in two chunks through
    ``Llama.forward(cache=)`` into a cache with room to decode, the second
    chunk at index DENSE_CHUNKS[0]; its logits at valid positions held to
    COMPOSE_RATIO as above.  On the kernel route K2 launches once a layer
    a chunk (the second end-aligned causal over the written slots) and
    the route counter counts the same calls."""
    from kubeflow_tpu_torch.models.generate import prompt_positions
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.telemetry import compute as ctel

    first = DENSE_CHUNKS[0]
    _, prompt, mask = ragged_batch(torch, dev, 128256, DENSE_LENS)
    positions, _ = prompt_positions(mask)
    valid = mask[:, first:]
    out, counts, routed = {}, None, None
    for name, model in models.items():
        cache = model.new_cache(len(DENSE_LENS), sum(DENSE_CHUNKS)
                                + NEW_TOKENS)
        if name == "auto":
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            calls0 = ctel.attention_impl_calls("kernel")
        with torch.inference_mode():
            model(prompt[:, :first], positions=positions[:, :first],
                  cache=cache)
            logits = model(prompt[:, first:], positions=positions[:, first:],
                           cache=cache)
        if name == "auto":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            routed = ctel.attention_impl_calls("kernel") - calls0
        out[name] = logits.float()[valid]
        del cache, logits
    n_layers = models["auto"].cfg.n_layers
    want = {k: 0 for k in counts}
    want.update({"rms_norm": 2 * (2 * n_layers + 1),
                 "flash_attention_fwd": 2 * n_layers})
    if counts != want or routed != 2 * n_layers:
        raise AssertionError(f"dense chunk launches {counts} (route counter "
                             f"{routed}), expected {want}")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    e_auto, e_plain = rel(out["auto"], out["f32"]), rel(out["plain"],
                                                        out["f32"])
    res = {"lens": list(DENSE_LENS), "chunks": list(DENSE_CHUNKS),
           "positions": int(valid.sum()), "launches": counts,
           "route_counter_kernel": routed,
           "rel_l2_kernel_vs_f32": e_auto, "rel_l2_plain_vs_f32": e_plain,
           "rel_l2_kernel_vs_plain": rel(out["auto"], out["plain"]),
           "argmax_agreement_kernel_vs_f32": (
               out["auto"].argmax(-1) == out["f32"].argmax(-1)
           ).float().mean().item()}
    for name in ("auto", "plain"):
        if not torch.isfinite(out[name]).all():
            raise AssertionError(f"dense chunk {name}: non-finite")
    if e_auto > COMPOSE_RATIO * e_plain:
        raise AssertionError(
            f"dense chunk: kernel route {e_auto} from the f32 model, more "
            f"than {COMPOSE_RATIO} x the plain route's {e_plain}")
    return res


def http(base, path, body=None, timeout=600, headers=None):
    """One request to the local server (no proxy, whatever the env says);
    /metrics and /debug/profile answer text, the rest JSON."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=timeout) as resp:
        raw = resp.read()
        text = path == "/metrics" or path.startswith("/debug/profile")
        return resp.status, raw.decode() if text else json.loads(raw)


def phase_serve(torch, dev):
    from kubeflow_tpu_torch.models.serve import create_app, load_service
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.telemetry import compute as ctel

    t0 = time.perf_counter()
    # The lock path, whose one request at a time the counts below hold;
    # phase_schedule serves the same model through the scheduler.
    service = load_service("llama3_8b", device="cuda", seed=SEED,
                           use_scheduler=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = service.model.cfg
    server = create_app(service, model_name="llama3_8b").make_server(
        "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, ready = http(base, "/readyz")
        if status != 200 or not ready.get("ready"):
            raise AssertionError(f"/readyz: {status} {ready}")
        toks, _, _ = ragged_batch(torch, dev, cfg.vocab_size, PROMPT_LENS)
        body_a = {"tokens": toks, "max_new_tokens": NEW_TOKENS,
                  "temperature": 0.0}
        body_b = dict(body_a, temperature=0.8, top_k=40, seed=1)
        torch.cuda.reset_peak_memory_stats()

        kernels.reset_launch_counts()
        routed0 = {i: ctel.attention_impl_calls(i) for i in ("kernel",
                                                             "plain")}
        t_a = time.perf_counter()
        _, out_a = http(base, "/v1/generate", body_a)
        t_a = time.perf_counter() - t_a
        counts = kernels.launch_counts()
        routed = {i: ctel.attention_impl_calls(i) - routed0[i]
                  for i in routed0}
        telemetry = serve_telemetry_checks(torch, counts, routed)

        forwards = NEW_TOKENS            # 1 prefill + 31 decode steps
        want = {"rms_norm": (2 * cfg.n_layers + 1) * forwards,
                "rms_norm_bwd": 0, "flash_attention_fwd": cfg.n_layers,
                "flash_attention_fwd_lse": 0, "flash_attention_dq": 0,
                "flash_attention_dkv": 0,
                "flash_decode": cfg.n_layers * (NEW_TOKENS - 1)}
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        _, traces = http(base, "/debug/traces?n=1")
        spans = {s["name"]: s for s in traces["traces"][-1]["spans"]}
        pre = spans["prefill"]
        ttft_s = (pre["offset_ms"] + pre["duration_ms"]) / 1e3
        decode_s = spans["decode"]["duration_ms"] / 1e3

        _, out_b = http(base, "/v1/generate", body_b)
        out_c, replica = profiled_traced_request(base, body_a)
        for name, out in (("A", out_a), ("B", out_b), ("C", out_c)):
            rows = out["tokens"]
            if len(rows) != len(PROMPT_LENS) or any(
                    len(r) != NEW_TOKENS or not all(
                        0 <= t < cfg.vocab_size for t in r) for r in rows):
                raise AssertionError(f"request {name}: malformed {rows}")
        if out_c["tokens"] != out_a["tokens"]:
            raise AssertionError("request C differs from A")
        _, metrics = http(base, "/metrics")
        if "serve_output_tokens_total" not in metrics:
            raise AssertionError("/metrics lacks the token counter")
        if service._scheduler is not None:
            raise AssertionError("the pinned lock path started a scheduler")
        emit({"phase": "serve", "model": "llama3_8b", "engine": "lock",
              "load_seconds": load_s, "prompt_lens": list(PROMPT_LENS),
              "max_new_tokens": NEW_TOKENS, "request_a_seconds": t_a,
              "ttft_seconds": ttft_s,
              "decode_tokens_per_s": len(PROMPT_LENS) * (NEW_TOKENS - 1)
              / decode_s,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches": counts, "a_equals_c": True,
              "a_row0_head": out_a["tokens"][0][:8],
              "b_row0_head": out_b["tokens"][0][:8]})
        emit({"phase": "serve_telemetry", **telemetry})
        emit({"phase": "serve_profile_traceparent", **replica})
        return counts, service.model
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def serve_telemetry_checks(torch, counts, routed):
    """Around request A: the route counter rose by exactly A's K2 launches
    (no plain call), ``hbm_peak_bytes`` is the allocator's peak,
    ``device_memory_bytes`` carries all three kinds for cuda:0, and its
    limit is the card's total memory."""
    from kubeflow_tpu_torch.telemetry import compute as ctel

    if routed != {"kernel": counts["flash_attention_fwd"], "plain": 0}:
        raise AssertionError(f"route counter {routed} against K2's "
                             f"{counts['flash_attention_fwd']} launches")
    peak, want_peak = ctel.hbm_peak_bytes(), torch.cuda.max_memory_allocated()
    if peak != want_peak:
        raise AssertionError(f"hbm_peak_bytes {peak}, allocator peak "
                             f"{want_peak}")
    samples = {kind: metric_value(
        ctel.render(), f'device_memory_bytes{{device="cuda:0",kind="{kind}"}}')
        for kind in ("in_use", "peak", "limit")}
    total = torch.cuda.mem_get_info(0)[1]
    if not all(samples.values()) or samples["peak"] != want_peak or (
            samples["limit"] != total):
        raise AssertionError(f"device_memory_bytes {samples}: peak "
                             f"{want_peak}, mem_get_info total {total}")
    return {"route_counter": routed, "hbm_peak_bytes": peak,
            "device_memory_bytes": samples,
            "free_hbm_bytes": ctel.free_hbm_bytes()}


def profiled_traced_request(base, body):
    """Request C (= A) sent with a traceparent while /debug/profile?seconds=1
    captures a registered Profiler: the capture holds folded stacks, some
    under the model's role (the request thread, through the Tracer seam);
    /debug/traces finds C by the caller's trace id as causal_trace_id."""
    from kubeflow_tpu_torch.telemetry import causal, profiler

    ctx = causal.mint()
    prof = profiler.Profiler()
    profiler.register_debug_profiler(prof)
    try:
        # The capture starts first; the request follows it into its second.
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(http, base, "/debug/profile?seconds=1")
            time.sleep(0.1)
            _, out = http(base, "/v1/generate", body,
                          headers={"traceparent": ctx.to_traceparent()})
            status, folded = fut.result()
    finally:
        profiler.register_debug_profiler(None)
    lines = folded.splitlines()
    roles = {}
    for ln in lines:
        role = ln.split(";", 1)[0]
        roles[role] = roles.get(role, 0) + int(ln.rsplit(" ", 1)[1])
    if status != 200 or not roles.get("llama3_8b"):
        raise AssertionError(f"/debug/profile {status}: no llama3_8b "
                             f"samples in {roles}")
    _, traces = http(base, f"/debug/traces?trace_id={ctx.trace_id}")
    linked = [t for t in traces["traces"]
              if t.get("causal_trace_id") == ctx.trace_id]
    if len(linked) != 1 or linked[0]["causal_span_id"] != ctx.span_id:
        raise AssertionError(f"traceparent {ctx.to_traceparent()} not "
                             f"linked: {traces['traces']}")
    return out, {"profile_status": status, "profile_lines": len(lines),
                 "profile_samples_by_role": roles,
                 "profile_model_lines": sum(
                     ln.startswith("llama3_8b;") for ln in lines),
                 "traceparent": ctx.to_traceparent(),
                 "linked_trace_id": linked[0]["trace_id"],
                 "linked_spans": [sp["name"] for sp in linked[0]["spans"]]}


def phase_profile(torch, dev, model):
    """Where request A's time goes: the same generate call, direct (no
    HTTP), once on the host clock and once under torch.profiler; device
    time per kernel class from the profiler's CUDA kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import generate, row_generators

    _, prompt, mask = ragged_batch(torch, dev, model.cfg.vocab_size,
                                   PROMPT_LENS)
    run = lambda: generate(model, prompt, prompt_mask=mask,
                           max_new_tokens=NEW_TOKENS,
                           generators=row_generators(SEED, 4, dev))
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    classes = {"rms_norm": 0.0, "flash_attention_fwd": 0.0,
               "flash_decode": 0.0, "matmul": 0.0, "other": 0.0}
    by_name = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        us = e.time_range.elapsed_us()
        name = e.name
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
        if "rms_norm_kernel" in name:
            classes["rms_norm"] += us
        elif "flash_fwd_kernel" in name:
            classes["flash_attention_fwd"] += us
        elif "flash_decode_kernel" in name:
            classes["flash_decode"] += us
        elif any(t in name.lower() for t in ("gemm", "gemv", "cutlass",
                                             "xmma", "cublas", "nvjet")):
            classes["matmul"] += us
        else:
            classes["other"] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    device_s = sum(classes.values()) / 1e6
    emit({"phase": "profile", "call": "generate (request A, no HTTP)",
          "wall_seconds": wall_s, "device_kernel_seconds": device_s,
          "device_busy_share": device_s / wall_s if device_s else None,
          "device_kernels": n_kernels,
          "device_ms_by_class": {k: v / 1e3 for k, v in classes.items()},
          "top_kernels": [{"name": name[:90], "ms": t / 1e3, "count": c}
                          for name, (t, c) in top]})


def schedule_bodies(torch, dev, vocab):
    """The schedule phase's requests: name -> POST /v1/generate body.
    Request A is the serve phase's; the others draw from seed SEED + 10."""
    import numpy as np

    rs = np.random.RandomState(SEED + 10)
    bodies = {}
    for name, (lens, n, kw) in SCHEDULE_REQUESTS.items():
        if name == "A":
            rows = ragged_batch(torch, dev, vocab, lens)[0]
        else:
            rows = [rs.randint(0, vocab, size=m).tolist() for m in lens]
        bodies[name] = {"tokens": rows, "max_new_tokens": n,
                        "temperature": 0.0, **kw}
    return bodies


def schedule_launches(cfg, prefills, steps):
    """Launches of the scheduler's path: each admission prefill and each
    pool step is one forward (two norms a layer and the final one); a
    prefill runs K2 once a layer, a pool step K5 once a layer."""
    n = cfg.n_layers
    return {"rms_norm": (2 * n + 1) * (prefills + steps), "rms_norm_bwd": 0,
            "flash_attention_fwd": n * prefills,
            "flash_attention_fwd_lse": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0, "flash_decode": n * steps}


def wait_drained(sched, timeout=60.0):
    """Until the scheduler holds no row and no unharvested quantum."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        st = sched.stats()
        if (sched._inflight is None and st["active_rows"] == 0
                and st["queued_rows"] == 0):
            return st
        time.sleep(0.01)
    raise AssertionError(f"scheduler did not drain: {sched.stats()}")


def width_logit_diff(torch, dev, model, rows, gen):
    """The largest |logit| difference between the lock path's decode (the
    request's width, a cache of prompt + budget) and the pool's (width
    POOL_SLOTS, POOL_SLOT_LEN positions, the other slots free), both fed
    the same tokens ``gen`` [b][n] from the same prefill."""
    from kubeflow_tpu_torch.models.generate import NEG_INF, generate_prefill

    b, n = len(rows), len(gen[0])
    longest = max(len(r) for r in rows)
    prompt = torch.tensor([r + [0] * (longest - len(r)) for r in rows],
                          device=dev)
    mask = torch.arange(longest, device=dev)[None] < torch.tensor(
        [len(r) for r in rows], device=dev)[:, None]
    toks = torch.tensor(gen, device=dev)
    worst = 0.0
    with torch.inference_mode():
        _, st = generate_prefill(model, prompt, prompt_mask=mask,
                                 max_new_tokens=n)
        pool = model.new_cache(POOL_SLOTS, POOL_SLOT_LEN)
        length = st.cache.length
        for layer in range(len(pool.k)):
            pool.k[layer][:b, :length] = st.cache.k[layer]
            pool.v[layer][:b, :length] = st.cache.v[layer]
        pads = torch.full((POOL_SLOTS, POOL_SLOT_LEN), NEG_INF, device=dev)
        pads[:b] = 0.0
        pads[:b, :length] = st.pad_bias
        write = torch.zeros(POOL_SLOTS, dtype=torch.long, device=dev)
        write[:b] = longest
        pos = torch.zeros(POOL_SLOTS, dtype=torch.long, device=dev)
        pos[:b] = st.pos
        tok = torch.zeros(POOL_SLOTS, dtype=torch.long, device=dev)
        for t in range(n - 1):
            lock = model(toks[:, t:t + 1], positions=st.pos[:, None],
                         cache=st.cache, pad_bias=st.pad_bias)[:, 0]
            tok[:b] = toks[:, t]
            pooled = model(tok[:, None], positions=pos[:, None], cache=pool,
                           pad_bias=pads,
                           cache_slots=write.clamp_max(POOL_SLOT_LEN - 1))
            worst = max(worst, (lock - pooled[:b, 0]).abs().max().item())
            st.pos += 1
            pos += 1
            write += 1
    return worst


def teacher_forced_gaps(torch, dev, model, row, gen):
    """Each emitted token's gap to its position's largest logit under one
    prefill of the prompt and the tokens before it (no cache)."""
    seq = torch.tensor([row + gen[:-1]], device=dev)
    with torch.inference_mode():
        logits = model(seq)[0, len(row) - 1:]
    tok = torch.tensor(gen, device=dev)
    return (logits.amax(-1) - logits.gather(-1, tok[:, None])[:, 0]).tolist()


def metric_value(text, name):
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name + " "))


def pool_quantum_checks(torch, dev, model):
    """One quantum of the scheduler's ``pool_steps`` over a full pool (8
    live rows at depth 512), greedy and sampled, each enqueued under
    ``torch.cuda.set_sync_debug_mode("error")``, where any host read or
    sync inside the quantum raises; then each timed (host clock to a
    synchronize), and the greedy one profiled: kernels a step and the
    device's busy share of the quantum.  Last, the same 8 greedy steps on
    the lock path (request A's 4 rows over their 544-slot cache) and in
    the pool, in turns (lock, pool, pool, lock), seconds a step each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeState,
        SamplingRows,
        decode_step,
        generate_prefill,
    )
    from kubeflow_tpu_torch.models.scheduler import pool_steps

    b, depth = POOL_SLOTS, 512
    out = {}
    with torch.inference_mode():
        st = DecodeState(
            cache=model.new_cache(b, POOL_SLOT_LEN),
            token=torch.zeros(b, dtype=torch.long, device=dev),
            pos=torch.full((b,), depth, dtype=torch.long, device=dev),
            done=torch.zeros(b, dtype=torch.bool, device=dev),
            pad_bias=torch.zeros(b, POOL_SLOT_LEN, device=dev),
            generators=[torch.Generator(device=dev).manual_seed(i)
                        for i in range(b)], budget=0)
        for kind, temp, top_k in (("greedy", 0.0, None),
                                  ("sampled", 0.8, 40)):
            rows = SamplingRows.make(b, dev, temp, top_k, None)
            write = torch.full((b,), depth, dtype=torch.long, device=dev)
            pool_steps(model, st, rows, write, 1)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pool_steps(model, st, rows, write, POOL_QUANTUM)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool_steps(model, st, rows, write, POOL_QUANTUM)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out[kind] = {"no_host_sync": True,
                         "enqueue_seconds": t1 - t0,
                         "wall_seconds": time.perf_counter() - t0}
        rows = SamplingRows.make(b, dev, 0.0, None, None)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pool_steps(model, st, rows, write, POOL_QUANTUM)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    out["profiled_greedy"] = {"wall_seconds": wall_s,
                              "device_busy_seconds": busy_us / 1e6,
                              "device_busy_share": busy_us / 1e6 / wall_s,
                              "kernels_per_step": len(spans) / POOL_QUANTUM}
    _, prompt, mask = ragged_batch(torch, dev, model.cfg.vocab_size,
                                   PROMPT_LENS)
    _, lock = generate_prefill(model, prompt, prompt_mask=mask,
                               max_new_tokens=NEW_TOKENS)
    lock_rows = SamplingRows.make(len(PROMPT_LENS), dev, 0.0, None, None)

    def lock_quantum():
        for _ in range(POOL_QUANTUM):
            decode_step(model, lock, lock_rows)

    def pool_quantum():
        pool_steps(model, st, rows, write, POOL_QUANTUM)

    per_step = {"lock": [], "pool": []}
    with torch.inference_mode():
        for name, fn in (("lock", lock_quantum), ("pool", pool_quantum),
                         ("pool", pool_quantum), ("lock", lock_quantum)):
            lock.cache.index = prompt.shape[1]   # rewrite the same slots
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            per_step[name].append((time.perf_counter() - t0) / POOL_QUANTUM)
    out["seconds_per_step_in_turns"] = per_step
    return out


def phase_schedule(torch, dev, model):
    """The serve phase's llama3_8b behind the continuous-batching
    scheduler.  Returns the launch counts of the pooled HTTP run."""
    from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
    from kubeflow_tpu_torch.models.serve import GenerationService, create_app
    from kubeflow_tpu_torch.ops import cuda as kernels

    cfg = model.cfg
    # KFT_SERVE_PAGED=0: this phase measures the fixed-slot pool;
    # phase_paged serves the same requests through the paged engine.
    knobs = {"KFT_SERVE_SLOTS": str(POOL_SLOTS),
             "KFT_SERVE_SLOT_LEN": str(POOL_SLOT_LEN),
             "KFT_SERVE_DECODE_QUANTUM": str(POOL_QUANTUM),
             "KFT_SERVE_PAGED": "0"}
    with env_set(knobs):
        service = GenerationService(model, use_scheduler=True)
        server = create_app(service, model_name="llama3_8b").make_server(
            "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        bodies = schedule_bodies(torch, dev, cfg.vocab_size)
        row = {"phase": "schedule", "model": "llama3_8b", "slots": POOL_SLOTS,
               "slot_len": POOL_SLOT_LEN, "quantum": POOL_QUANTUM,
               "slot_len_note": f"KFT_SERVE_SLOT_LEN={POOL_SLOT_LEN} set by "
                                "this phase; the default is max_seq_len "
                                f"{cfg.max_seq_len}",
               "requests": {k: {"prompt_lens": list(v[0]), "max_new_tokens": v[1],
                                **v[2]} for k, v in SCHEDULE_REQUESTS.items()},
               "pool_bytes": 2 * cfg.n_layers * POOL_SLOTS * POOL_SLOT_LEN
               * cfg.n_kv_heads * cfg.head_dim * 2}
        try:
            status, ready = http(base, "/readyz")
            sched = service._scheduler
            if status != 200 or sched is None or not sched.pipeline:
                raise AssertionError(f"/readyz {status} {ready}: no pipelined "
                                     "scheduler behind the app")
            if (sched.slots, sched.slot_len, sched.quantum) != (
                    POOL_SLOTS, POOL_SLOT_LEN, POOL_QUANTUM):
                raise AssertionError(f"scheduler knobs {sched.stats()}")
            before = wait_drained(sched)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(bodies)) as pool:
                futs = {name: pool.submit(http, base, "/v1/generate", body)
                        for name, body in bodies.items()}
                pooled = {name: f.result()[1]["tokens"]
                          for name, f in futs.items()}
            wall_s = time.perf_counter() - t0
            after = wait_drained(sched)
            counts = kernels.launch_counts()
            row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
            prefills = after["prefills_total"] - before["prefills_total"]
            steps = after["steps_total"] - before["steps_total"]
            want = schedule_launches(cfg, prefills, steps)
            slack = schedule_launches(cfg, 0, POOL_QUANTUM)
            if any(abs(counts[k] - want[k]) > slack[k] for k in want) or not (
                    counts["rms_norm"] and counts["flash_attention_fwd"]
                    and counts["flash_decode"]):
                raise AssertionError(f"schedule launches {counts}, expected "
                                     f"{want} within one quantum")
            for name, body in bodies.items():
                out, n = pooled[name], body["max_new_tokens"]
                if len(out) != len(body["tokens"]) or any(
                        len(r) != n or not all(0 <= t < cfg.vocab_size
                                               for t in r) for r in out):
                    raise AssertionError(f"request {name}: malformed {out}")
            _, traces = http(base, f"/debug/traces?n={len(bodies)}")
            ttft = {}
            for tr in traces["traces"]:
                spans = {sp["name"]: sp for sp in tr["spans"]}
                ttft[spans["decode"]["tokens"]] = (
                    spans["prefill"]["offset_ms"]
                    + spans["prefill"]["duration_ms"]) / 1e3
            decode_tokens = sum(len(b["tokens"]) * (b["max_new_tokens"] - 1)
                                for b in bodies.values())
            row.update({
                "wall_seconds": wall_s, "decode_tokens": decode_tokens,
                "decode_tokens_per_s": decode_tokens / wall_s,
                "ttft_seconds": {name: ttft.get(b["max_new_tokens"])
                                 for name, b in bodies.items()},
                "launches": counts, "launches_expected": want,
                "prefills": prefills, "pool_steps": steps,
                "dispatch_overlap_ratio": after["dispatch_overlap_ratio"]})

            # Row independence: each request alone through the same pool.
            alone_s = {}
            for name, body in bodies.items():
                t1 = time.perf_counter()
                _, out = http(base, "/v1/generate", body)
                alone_s[name] = time.perf_counter() - t1
                if out["tokens"] != pooled[name]:
                    raise AssertionError(f"request {name}: alone {out['tokens']} "
                                         f"differs from pooled {pooled[name]}")
            row["alone_seconds"] = alone_s
            wait_drained(sched)
            _, metrics = http(base, "/metrics")
            counters = {k: metric_value(metrics, k) for k in (
                "serve_scheduler_admitted_rows_total",
                "serve_scheduler_evicted_rows_total",
                "serve_decode_slots_active", "serve_queue_depth",
                "serve_decode_slots")}
            _, debug = http(base, "/debug/serve")
            row["counters"] = counters
            # serve_dispatch_overlap_ratio, set at each harvest, equals
            # the ratio stats() reports (rounded there to 6 decimals).
            overlap = [float(ln.split()[1]) for ln in metrics.splitlines()
                       if ln.startswith("serve_dispatch_overlap_ratio ")]
            ratio = sched.stats()["dispatch_overlap_ratio"]
            if len(overlap) != 1 or abs(overlap[0] - ratio) > 5e-7:
                raise AssertionError(f"serve_dispatch_overlap_ratio "
                                     f"{overlap} against stats() {ratio}")
            emit({"phase": "schedule_overlap_gauge",
                  "serve_dispatch_overlap_ratio": overlap[0],
                  "stats_dispatch_overlap_ratio": ratio})
            if (counters["serve_scheduler_admitted_rows_total"]
                    != counters["serve_scheduler_evicted_rows_total"]
                    or counters["serve_decode_slots_active"] != 0
                    or counters["serve_queue_depth"] != 0
                    or counters["serve_decode_slots"] != POOL_SLOTS
                    or not sched.alive
                    or service._scheduler_or_none() is not sched
                    or debug["engine"] != "DecodeScheduler"
                    or debug["paged_fallback"]["reason"] != "env-disabled"):
                raise AssertionError(f"scheduler counters or state: {counters} "
                                     f"{debug}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    if service._scheduler is not None:
        service._scheduler.stop()

    # Pipeline off, every request queued before the loop starts: the
    # launches are exact, and the tokens equal the pipelined run's.
    det = DecodeScheduler(model, slots=POOL_SLOTS, slot_len=POOL_SLOT_LEN,
                          quantum=POOL_QUANTUM, pipeline=False)
    start, det.start = det.start, lambda: None   # hold the loop
    kernels.reset_launch_counts()
    pend = {name: det.submit(
        b["tokens"], max_new_tokens=b["max_new_tokens"],
        temperature=b["temperature"], top_k=b.get("top_k"),
        seed=b.get("seed", 0)) for name, b in bodies.items()}
    t0 = time.perf_counter()
    det.start = start
    det.start()
    sync = {name: p.result() for name, p in pend.items()}
    det_s = time.perf_counter() - t0
    det_counts = kernels.launch_counts()
    st = det.stats()
    det.stop()
    want = schedule_launches(cfg, st["prefills_total"], st["steps_total"])
    if det_counts != want:
        raise AssertionError(f"schedule launches (pipeline off) {det_counts},"
                             f" expected {want}")
    if sync != pooled:
        raise AssertionError("pipeline off gave other tokens than on")
    row["pipeline_off"] = {"launches": det_counts, "prefills":
                           st["prefills_total"], "pool_steps":
                           st["steps_total"], "wall_seconds": det_s,
                           "tokens_equal": True}

    row["quantum"] = pool_quantum_checks(torch, dev, model)

    # Agreement with the lock path, teacher-forced.
    width = width_logit_diff(torch, dev, model, bodies["A"]["tokens"],
                             pooled["A"])
    tol = max(AGREE_GAP, 2 * width)
    gaps = []
    for name, body in bodies.items():
        if body["temperature"] != 0.0:
            continue
        for prompt, gen in zip(body["tokens"], pooled[name]):
            gaps += teacher_forced_gaps(torch, dev, model, prompt, gen)
    row["agreement"] = {"tokens": len(gaps),
                        "exact_argmax": sum(g <= 0.0 for g in gaps),
                        "worst_gap": max(gaps), "tolerance": tol,
                        "width_logit_diff": width}
    emit(row)
    if max(gaps) > tol:
        raise AssertionError(f"a pooled greedy token is {max(gaps)} below "
                             f"its position's largest logit (limit {tol})")
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return counts, pooled, tol, row["quantum"]


@contextlib.contextmanager
def env_set(knobs):
    """The environment with ``knobs`` set, restored on exit."""
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pages_needed(lens, new_tokens, page_len, spec_tokens=0):
    """Pages a request takes at admission without prefix reuse: each row
    ceil((longest + new - 1 + spec slack) / page_len), the engine's
    ``_pages_per_row``."""
    slack = spec_tokens + 1 if spec_tokens else 0
    per_row = -(-(max(lens) + new_tokens - 1 + slack) // page_len)
    return per_row * len(lens)


def paged_pool_bytes(cfg, pages):
    return (2 * cfg.n_layers * pages * PAGED_PAGE_LEN * cfg.n_kv_heads
            * cfg.head_dim * 2)


def stats_delta(after, before):
    return {k: v - before[k] for k, v in after.items()
            if isinstance(v, int) and not isinstance(v, bool)}


def paged_launches(cfg, st, draft_cfg=None, k=0):
    """(kernel launches, verify_attention calls) of the paged engine's
    work in stats ``st``: a prefill chunk and a pool step are one target
    forward each (K2 or K5 once a layer), a speculative step one target
    verify pass (the plain verify attention once a layer) and k + 1 draft
    steps (K5 once a draft layer), a draft prefill one draft forward (K2
    once a draft layer); every forward runs two norms a layer and the
    final one."""
    n = cfg.n_layers
    d = draft_cfg.n_layers if draft_cfg is not None else 0
    spec = st["spec_steps_total"]
    pool = st["steps_total"] - spec
    chunks = st["prefill_chunks_total"]
    draft_steps = (k + 1) * spec
    draft_pre = st["draft_prefills_total"]
    return ({"rms_norm": (2 * n + 1) * (chunks + pool + spec)
             + (2 * d + 1) * (draft_steps + draft_pre),
             "rms_norm_bwd": 0,
             "flash_attention_fwd": n * chunks + d * draft_pre,
             "flash_attention_fwd_lse": 0, "flash_attention_dq": 0,
             "flash_attention_dkv": 0,
             "flash_decode": n * pool + d * draft_steps}, n * spec)


def check_pages_balanced(what, st):
    if st["pages_active"] != 0 or (st["pages_free"] + st["pages_shared"]
                                   != st["pages_total"] - 1):
        raise AssertionError(f"{what}: pages unbalanced after the drain "
                             f"{st}")


def agreement(torch, dev, model, body, got, want, tol, what):
    """Token equality, or for a greedy request the teacher-forced gap of
    each of ``got``'s tokens to its position's largest logit, within
    ``tol`` (the schedule phase's contract where a batch shape changes
    the last bits)."""
    if got == want:
        return {"equal": True}
    if body["temperature"] != 0.0:
        raise AssertionError(f"{what}: a sampled request differs: {got} "
                             f"against {want}")
    gaps = []
    for prompt, gen in zip(body["tokens"], got):
        gaps += teacher_forced_gaps(torch, dev, model, prompt, gen)
    if max(gaps) > tol:
        raise AssertionError(f"{what}: a greedy token is {max(gaps)} below "
                             f"its position's largest logit (limit {tol})")
    return {"equal": False, "worst_gap": max(gaps), "tokens": len(gaps),
            "equal_tokens": sum(a == b for g, w in zip(got, want)
                                for a, b in zip(g, w))}


def prefix_bodies(vocab):
    """The shared-prefix set: one 320-token prefix, distinct suffixes."""
    import numpy as np

    rs = np.random.RandomState(SEED + 30)
    prefix = rs.randint(0, vocab, size=PREFIX_LEN).tolist()
    return [{"tokens": [prefix + rs.randint(0, vocab, size=m).tolist()],
             "max_new_tokens": PREFIX_NEW_TOKENS, "temperature": 0.0}
            for m in PREFIX_SUFFIXES]


def submit_body(sched, body):
    return sched.submit(body["tokens"], max_new_tokens=body["max_new_tokens"],
                        temperature=body["temperature"],
                        top_k=body.get("top_k"), seed=body.get("seed", 0))


def run_held(sched, bodies):
    """Every body queued before the loop starts, then run: launches that
    the stats account for exactly.  Returns (outputs by name, seconds)."""
    start, sched.start = sched.start, lambda: None
    pend = {name: submit_body(sched, b) for name, b in bodies.items()}
    t0 = time.perf_counter()
    sched.start = start
    sched.start()
    out = {name: p.result() for name, p in pend.items()}
    return out, time.perf_counter() - t0


def paged_quantum(torch, dev, model, slot_len, fixed=False):
    """One greedy quantum over POOL_SLOTS live lanes at depth slot_len / 2,
    through the paged engine's ``paged_pool_steps`` over the default page
    count (or, ``fixed``, the fixed pool's ``pool_steps``): enqueued under
    ``torch.cuda.set_sync_debug_mode("error")``, timed, profiled (kernels a
    step, the card's busy share).  Returns the row and a callable that
    runs one more quantum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import DecodeState, SamplingRows
    from kubeflow_tpu_torch.models.paged import paged_pool_steps
    from kubeflow_tpu_torch.models.scheduler import pool_steps

    b, depth = POOL_SLOTS, slot_len // 2
    per_row = slot_len // PAGED_PAGE_LEN
    pages = b * per_row + 1
    with torch.inference_mode():
        cache = (model.new_cache(b, slot_len) if fixed
                 else model.new_paged_cache(pages * PAGED_PAGE_LEN))
        st = DecodeState(
            cache=cache, token=torch.zeros(b, dtype=torch.long, device=dev),
            pos=torch.full((b,), depth, dtype=torch.long, device=dev),
            done=torch.zeros(b, dtype=torch.bool, device=dev),
            pad_bias=torch.zeros(b, slot_len, device=dev),
            generators=[torch.Generator(device=dev).manual_seed(i)
                        for i in range(b)], budget=0)
    rows = SamplingRows.make(b, dev, 0.0, None, None)
    write = torch.full((b,), depth, dtype=torch.long, device=dev)
    page_rows = torch.arange(1, pages, device=dev).view(b, per_row)

    def run(n=POOL_QUANTUM):
        with torch.inference_mode():
            if fixed:
                return pool_steps(model, st, rows, write, n)
            return paged_pool_steps(model, st, rows, write, page_rows,
                                    page_len=PAGED_PAGE_LEN, quantum=n)

    run(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    out = {"slot_len": slot_len, "depth": depth, "no_host_sync": True,
           "enqueue_seconds": t1 - t0,
           "wall_seconds": time.perf_counter() - t0,
           "cache_bytes": sum(t.numel() * t.element_size()
                              for t in cache.k + cache.v)}
    if not fixed:
        out["pages"] = pages
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, by_class = [], {"gather": 0.0, "flash_decode": 0.0,
                           "matmul": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        name, us = e.name.lower(), e.time_range.elapsed_us()
        if "index" in name or "gather" in name or "scatter" in name:
            by_class["gather"] += us
        elif "flash_decode_kernel" in name:
            by_class["flash_decode"] += us
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "xmma",
                                     "cublas", "nvjet")):
            by_class["matmul"] += us
        else:
            by_class["other"] += us
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    out.update({"profiled_wall_seconds": wall_s,
                "device_busy_share": busy_us / 1e6 / wall_s,
                "kernels_per_step": len(spans) / POOL_QUANTUM,
                "device_ms_per_step_by_class": {
                    k: v / 1e3 / POOL_QUANTUM for k, v in by_class.items()}})
    return out, run


def gather_row(torch, dev, timer, L):
    """The paged decode's gather, not a kernel: ``index_select`` of the
    POOL_SLOTS rows' L positions each from the pool, K and V, at one
    layer (the counterpart of the reference's XLA gather,
    ``kubeflow_tpu/models/layers.py:306``).  Its bound moves each
    gathered byte once in and once out, and the indices once."""
    b, kvh, hd = POOL_SLOTS, 8, 128
    per_row = L // PAGED_PAGE_LEN
    pages = b * per_row + 1
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    k = torch.randn(pages * PAGED_PAGE_LEN, kvh, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn_like(k)
    table = 1 + torch.randperm(pages - 1, generator=gen, device=dev)
    table = table.view(b, per_row)
    from kubeflow_tpu_torch.models.paged import read_indices

    read = read_indices(table, PAGED_PAGE_LEN).reshape(-1)
    got = k.index_select(0, read).view(b, L, kvh, hd)
    rows_ok = torch.equal(got[1, :PAGED_PAGE_LEN],
                          k[table[1, 0] * PAGED_PAGE_LEN:
                            (table[1, 0] + 1) * PAGED_PAGE_LEN])
    if not rows_ok:
        raise AssertionError("gather: a row's first page is not its table's")
    nbytes = 2 * (2 * b * L * kvh * hd * 2) + b * L * 8
    ms = timer(lambda: (k.index_select(0, read), v.index_select(0, read)))
    bms, by = bound_ms(nbytes, 0, PEAK_BF16_FLOPS)
    return {"op": "paged_gather", "shape": [b, L, kvh, hd],
            "bytes": nbytes, "ms": ms, "bound_ms": bms, "bound_by": by,
            "bound_share": bms / ms,
            "per_step_ms_32_layers": 32 * ms}


def chunk_k2_row(torch, dev, timer, b=CHUNK_B, sq=CHUNK_SQ, sk=CHUNK_SK,
                 path="paged prefill chunk (end-aligned causal)"):
    """K2 at a prefill chunk's shape, end-aligned causal, h32/8 d128: by
    default q [1, 388] over k/v [1, 900] (the paged engine's second chunk
    of the 900-token row)."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import flash_attention as k2

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    h, kvh, hd = 32, 8, 128
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = rnd(b, sq, h, hd), rnd(b, sk, kvh, hd), rnd(b, sk, kvh, hd)
    got = k2.flash_attention(q, k, v, causal=True)
    want = k2.plain_attention(q.float(), k.float(), v.float(), causal=True)
    tol = KERNEL_TOL["flash_attention_fwd"]
    err, share = check_close("flash_attention_fwd chunk", got, want, tol)
    vis = (torch.arange(sq, device=dev)[:, None] + (sk - sq)
           >= torch.arange(sk, device=dev)[None, :])
    pairs = vis.sum().item() * h * b
    nbytes = 2 * (2 * b * sq * h * hd + 2 * b * sk * kvh * hd)
    flops = 4 * pairs * hd
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row = {"kernel": "flash_attention_fwd", "shape": [b, sq, sk, h, kvh, hd],
           "path": path,
           "max_abs_err": err, "tol": tol, "tol_share": share,
           "kernel_ms": timer(lambda: k2.flash_attention(q, k, v,
                                                         causal=True)),
           "plain_ms": timer(lambda: k2.plain_attention(q, k, v,
                                                        causal=True)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=vis, enable_gqa=True)),
           "bound_ms": bms, "bound_by": by}
    return add_rates(row, flops)


def null_page_k5_row(torch, dev, timer):
    """K5 at [8, 1024] over a view gathered from a paged pool: rows see
    POOL_LENS slots (plus one free lane whose table is all null page),
    the pages past each row's length are the null page, which holds
    finite garbage 50x the live values, as does every masked slot."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models.paged import read_indices
    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5

    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    b, S, h, kvh, hd = POOL_SLOTS, POOL_SLOT_LEN, 32, 8, 128
    per_row = S // PAGED_PAGE_LEN
    pages = b * per_row + 1
    lens = torch.tensor(POOL_LENS + (0,), device=dev)
    used = -(-lens // PAGED_PAGE_LEN)
    table = torch.arange(1, pages, device=dev).view(b, per_row)
    table = torch.where(torch.arange(per_row, device=dev)[None]
                        < used[:, None], table, 0)
    pool_k = torch.randn(pages * PAGED_PAGE_LEN, kvh, hd, generator=gen,
                         device=dev)
    pool_v = torch.randn(pages * PAGED_PAGE_LEN, kvh, hd, generator=gen,
                         device=dev)
    pool_k[:PAGED_PAGE_LEN] *= 50.0
    pool_v[:PAGED_PAGE_LEN] *= 50.0
    pool_k, pool_v = pool_k.to(torch.bfloat16), pool_v.to(torch.bfloat16)
    read = read_indices(table, PAGED_PAGE_LEN).reshape(-1)
    k = pool_k.index_select(0, read).view(b, S, kvh, hd)
    v = pool_v.index_select(0, read).view(b, S, kvh, hd)
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    live = torch.arange(S, device=dev)[None] < lens[:, None]
    bias = torch.where(live, 0.0, -1e30).float().contiguous()
    got = k5.flash_decode(q, k, v, bias)
    want = k5.plain_decode(q.float(), k.float(), v.float(), bias)
    tol = KERNEL_TOL["flash_decode"]
    err, share = check_close("flash_decode null page", got, want, tol)
    needed = int(lens.sum().item()) + S     # the free lane: every slot
    nbytes = 2 * needed * kvh * hd * 2 + b * S * 4 + 2 * b * h * hd * 2
    flops = 4 * h * hd * needed
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = bias[:, None, None, :].to(torch.bfloat16)
    row = {"kernel": "flash_decode", "shape": [b, S, h, kvh, hd],
           "path": "paged decode (gathered view, null-page rows)",
           "visible_lens": list(POOL_LENS), "free_rows": 1,
           "null_page_slots": int((table == 0).sum().item())
           * PAGED_PAGE_LEN, "needed_slots": needed, "max_abs_err": err,
           "tol": tol, "tol_share": share,
           "kernel_ms": timer(lambda: k5.flash_decode(q, k, v, bias)),
           "plain_ms": timer(lambda: k5.plain_decode(q, k, v, bias)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, enable_gqa=True)),
           "bound_ms": bms, "bound_by": by}
    return add_rates(row, flops)


def http_server(service, name):
    """(server, thread, base URL) of ``service``'s app on a free port."""
    from kubeflow_tpu_torch.models.serve import create_app

    server = create_app(service, model_name=name).make_server(
        "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def stop_server(service, server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    if getattr(service, "_scheduler", None) is not None:
        service._scheduler.stop()


def paged_http_run(torch, service, base, bodies, what):
    """Every body over HTTP at once through the service's paged engine,
    launches counted from a drained engine to a drained engine and held to
    ``paged_launches``.  Returns (tokens by name, the run's row)."""
    from kubeflow_tpu_torch.models import layers
    from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler
    from kubeflow_tpu_torch.ops import cuda as kernels

    status, ready = http(base, "/readyz")
    sched = service._scheduler
    if status != 200 or not isinstance(sched, PagedDecodeScheduler):
        raise AssertionError(f"{what}: /readyz {status} {ready}: the paged "
                             "engine does not serve")
    if (sched.page_len, sched.num_pages, sched.prefill_chunk, sched.slots,
            sched.slot_len) != (PAGED_PAGE_LEN, PAGED_PAGES, PAGED_CHUNK,
                                POOL_SLOTS, POOL_SLOT_LEN):
        raise AssertionError(f"{what}: paged geometry {sched.stats()}")
    cfg = service.model.cfg
    before = wait_drained(sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    layers.verify_attention.calls = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(bodies)) as pool:
        futs = {name: pool.submit(http, base, "/v1/generate", body)
                for name, body in bodies.items()}
        out = {name: f.result()[1]["tokens"] for name, f in futs.items()}
    wall_s = time.perf_counter() - t0
    after = wait_drained(sched)
    counts = kernels.launch_counts()
    delta = stats_delta(after, before)
    want, verify = paged_launches(cfg, delta)
    if counts != want or layers.verify_attention.calls != verify:
        raise AssertionError(f"{what} launches {counts}, expected {want} "
                             f"({delta})")
    check_pages_balanced(what, after)
    for name, body in bodies.items():
        rows, n = out[name], body["max_new_tokens"]
        if len(rows) != len(body["tokens"]) or any(
                len(r) != n or not all(0 <= t < cfg.vocab_size for t in r)
                for r in rows):
            raise AssertionError(f"{what} request {name}: malformed {rows}")
    _, traces = http(base, f"/debug/traces?n={len(bodies)}")
    ttft = []
    for tr in traces["traces"]:
        spans = {sp["name"]: sp for sp in tr["spans"]}
        ttft.append((spans["prefill"]["offset_ms"]
                     + spans["prefill"]["duration_ms"]) / 1e3)
    tokens = sum(len(b["tokens"]) * (b["max_new_tokens"] - 1)
                 for b in bodies.values())
    return out, {"wall_seconds": wall_s, "decode_tokens": tokens,
                 "decode_tokens_per_s": tokens / wall_s,
                 "ttft_seconds": sorted(ttft),
                 "pool_steps": delta["steps_total"],
                 "prefill_chunks": delta["prefill_chunks_total"],
                 "launches": counts, "launches_expected": want,
                 "max_memory_allocated_bytes":
                     torch.cuda.max_memory_allocated(),
                 "dispatch_overlap_ratio": after["dispatch_overlap_ratio"]}


def phase_paged(torch, dev, model, fixed, tol, fixed_quantum):
    """The serve phase's llama3_8b through the paged engine: the schedule
    phase's requests over HTTP, shared prefixes, page pressure,
    speculative decoding with two drafts, quanta at 1024 and 8192 slots,
    and the timed rows of the paged path.  ``fixed`` is the schedule
    phase's pooled tokens by request and ``tol`` its agreement tolerance.
    Returns the launch counts of the HTTP run and its row."""
    import numpy as np

    from kubeflow_tpu_torch.models import create_model, layers
    from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler
    from kubeflow_tpu_torch.models.serve import GenerationService
    from kubeflow_tpu_torch.ops import cuda as kernels

    cfg = model.cfg
    bodies = schedule_bodies(torch, dev, cfg.vocab_size)
    shared = prefix_bodies(cfg.vocab_size)
    geometry = dict(slots=POOL_SLOTS, slot_len=POOL_SLOT_LEN,
                    quantum=POOL_QUANTUM)
    row = {"phase": "paged", "model": "llama3_8b", "lanes": POOL_SLOTS,
           "slot_len": POOL_SLOT_LEN, "quantum": POOL_QUANTUM,
           "page_len": PAGED_PAGE_LEN, "pages": PAGED_PAGES,
           "prefill_chunk": PAGED_CHUNK,
           "pool_bytes": paged_pool_bytes(cfg, PAGED_PAGES)}
    knobs = {"KFT_SERVE_SLOTS": str(POOL_SLOTS),
             "KFT_SERVE_SLOT_LEN": str(POOL_SLOT_LEN),
             "KFT_SERVE_DECODE_QUANTUM": str(POOL_QUANTUM)}
    gc.collect()
    torch.cuda.empty_cache()
    with env_set(knobs):
        service = GenerationService(model, use_scheduler=True)
        server, thread, base = http_server(service, "llama3_8b")
        try:
            # (1) The schedule phase's requests, all at once.
            pooled, row["http"] = paged_http_run(torch, service, base,
                                                 bodies, "paged mix")
            sched = service._scheduler
            # (2) The shared-prefix set, one request after another.
            hits0 = sched.stats()["prefix_hits"]
            hit_outs = []
            for body in shared:
                hit_outs.append(http(base, "/v1/generate", body)[1]["tokens"])
            st = wait_drained(sched)
            hits = st["prefix_hits"] - hits0
            expect_hits = (len(shared) - 1) * (PREFIX_LEN // PAGED_PAGE_LEN)
            if hits != expect_hits:
                raise AssertionError(f"prefix hits {hits}, expected "
                                     f"{expect_hits}: {st}")
            check_pages_balanced("shared prefixes", st)
            _, metrics = http(base, "/metrics")
            _, debug = http(base, "/debug/serve")
            gauges = {s: metric_value(metrics, f'serve_kv_pages{{state="{s}"}}')
                      for s in ("free", "active", "shared")}
            if (gauges["active"] != 0 or sum(gauges.values())
                    != PAGED_PAGES - 1
                    or metric_value(metrics, "serve_prefix_cache_hits_total")
                    != st["prefix_hits"]
                    or metric_value(metrics,
                                    "serve_scheduler_admitted_rows_total")
                    != metric_value(metrics,
                                    "serve_scheduler_evicted_rows_total")
                    or debug["engine"] != "PagedDecodeScheduler"
                    or debug["paged_fallback"] is not None):
                raise AssertionError(f"paged counters {gauges} {debug}")
            row["prefix"] = {"prefix_len": PREFIX_LEN,
                             "suffixes": list(PREFIX_SUFFIXES),
                             "prefix_hits": hits,
                             "pages_saved": hits,
                             "prefix_misses": st["prefix_misses"],
                             "pages_shared": st["pages_shared"],
                             "kv_pages": gauges}
        finally:
            stop_server(service, server, thread)
    del service, sched
    gc.collect()

    # (3) Pipeline off, prefix cache off, every request queued before the
    # loop starts: exact launches, the HTTP run's tokens; then each
    # request alone, bit for bit; then the shared-prefix set with the
    # cache off against the hits.
    det = PagedDecodeScheduler(model, pipeline=False, prefix_cache=False,
                               **geometry)
    kernels.reset_launch_counts()
    sync, det_s = run_held(det, bodies)
    det_counts = kernels.launch_counts()
    want, _ = paged_launches(cfg, det.stats())
    if det_counts != want:
        raise AssertionError(f"paged launches (pipeline off) {det_counts}, "
                             f"expected {want}")
    if sync != pooled:
        raise AssertionError("paged: pipeline off gave other tokens than on")
    for name, body in bodies.items():
        if submit_body(det, body).result() != pooled[name]:
            raise AssertionError(f"paged: request {name} alone differs from "
                                 "pooled")
    row["pipeline_off"] = {"launches": det_counts, "wall_seconds": det_s,
                           "tokens_equal_pipelined": True,
                           "alone_equal_pooled": True}
    off_outs = [submit_body(det, body).result() for body in shared]
    row["prefix"]["against_cache_off"] = [
        agreement(torch, dev, model, body, got, off, tol,
                  f"prefix-hit request {i}")
        for i, (body, got, off) in enumerate(zip(shared, hit_outs, off_outs))
        if i]
    check_pages_balanced("pipeline off", det.stats())
    det.stop()
    del det
    # (4) Against the fixed pool (the schedule phase's tokens).
    row["against_fixed_pool"] = {
        name: agreement(torch, dev, model, body, pooled[name], fixed[name],
                        tol, f"paged against fixed, request {name}")
        for name, body in bodies.items()}

    # (5) Page pressure (KFT_SERVE_PAGES): admissions wait for evictions.
    with env_set({"KFT_SERVE_PAGES": str(PRESSURE_PAGES)}):
        pres = PagedDecodeScheduler(model, prefix_cache=False, **geometry)
    if pres.num_pages != PRESSURE_PAGES:
        raise AssertionError(f"KFT_SERVE_PAGES gave {pres.num_pages} pages")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(bodies)) as pool:
        futs = {name: pool.submit(lambda b: submit_body(pres, b).result(),
                                  body) for name, body in bodies.items()}
        tight = {name: f.result() for name, f in futs.items()}
    st = wait_drained(pres)
    pres.stop()
    if tight != pooled or st["page_waits_total"] < 1:
        raise AssertionError(f"page pressure: tokens equal {tight == pooled},"
                             f" {st}")
    check_pages_balanced("page pressure", st)
    row["pressure"] = {"pages": PRESSURE_PAGES,
                       "pages_needed": {n: pages_needed(
                           [len(r) for r in b["tokens"]],
                           b["max_new_tokens"], PAGED_PAGE_LEN)
                           for n, b in bodies.items()},
                       "page_waits": st["page_waits_total"],
                       "wall_seconds": time.perf_counter() - t0,
                       "tokens_equal": True}
    del pres
    # (5b) Page pressure with the prefix cache on: a prefix hit meets a
    # short pool (PRESSURE_HOLDER) and waits with its chain pinned.
    with env_set({"KFT_SERVE_PAGES": str(PRESSURE_PAGES)}):
        pres = PagedDecodeScheduler(model, prefix_cache=True, **geometry)
    rs = np.random.RandomState(SEED + 40)
    n_rows, holder_len, holder_new = PRESSURE_HOLDER
    holder = {"tokens": [rs.randint(0, cfg.vocab_size,
                                    size=holder_len).tolist()
                         for _ in range(n_rows)],
              "max_new_tokens": holder_new, "temperature": 0.0}
    t0 = time.perf_counter()
    submit_body(pres, shared[0]).result()
    wait_drained(pres)
    futs = [submit_body(pres, b) for b in [holder] + shared[1:]]
    held_out, *hit_tight = [f.result() for f in futs]
    st = wait_drained(pres)
    pres.stop()
    expect_hits = (len(shared) - 1) * (PREFIX_LEN // PAGED_PAGE_LEN)
    if (st["page_waits_total"] < 1 or st["prefix_hits"] != expect_hits
            or [len(r) for r in held_out] != [holder_new] * n_rows):
        raise AssertionError(f"page pressure with prefix hits: {st}")
    check_pages_balanced("page pressure with prefix hits", st)
    row["pressure"]["prefix_hits"] = {
        "holder_pages": pages_needed([holder_len] * n_rows, holder_new,
                                     PAGED_PAGE_LEN),
        "page_waits": st["page_waits_total"],
        "prefix_hits": st["prefix_hits"],
        "wall_seconds": time.perf_counter() - t0,
        "equal_unpressed_hits": hit_tight == hit_outs[1:],
        "against_cache_off": [
            agreement(torch, dev, model, body, got, off, tol,
                      f"pressed prefix-hit request {i + 1}")
            for i, (body, got, off) in enumerate(
                zip(shared[1:], hit_tight, off_outs[1:]))]}
    del pres

    # (6) Speculative decoding on the greedy requests, two drafts.
    greedy = {n: b for n, b in bodies.items() if b["temperature"] == 0.0}
    small = create_model("llama3_8b", device=dev, n_layers=DRAFT_LAYERS)
    with torch.no_grad():
        small.reset_parameters(
            torch.Generator(device=dev).manual_seed(DRAFT_SEED))
    small.eval()
    row["spec"] = {}
    for label, draft in (("target", model), (f"{DRAFT_LAYERS}-layer", small)):
        gc.collect()
        torch.cuda.empty_cache()
        sp = PagedDecodeScheduler(model, draft_model=draft,
                                  spec_tokens=SPEC_TOKENS,
                                  prefix_cache=False, **geometry)
        kernels.reset_launch_counts()
        layers.verify_attention.calls = 0
        torch.cuda.reset_peak_memory_stats()
        outs, spec_s = run_held(sp, greedy)
        st = sp.stats()
        sp.stop()
        counts_sp = kernels.launch_counts()
        want, verify = paged_launches(cfg, st, draft.cfg, SPEC_TOKENS)
        if counts_sp != want or layers.verify_attention.calls != verify:
            raise AssertionError(
                f"spec ({label}) launches {counts_sp} and verify calls "
                f"{layers.verify_attention.calls}, expected {want} and "
                f"{verify} ({st})")
        check_pages_balanced(f"spec ({label})", st)
        tokens = sum(len(b["tokens"]) * (b["max_new_tokens"] - 1)
                     for b in greedy.values())
        row["spec"][label] = {
            "spec_tokens": SPEC_TOKENS, "draft_layers": draft.cfg.n_layers,
            "spec_steps": st["spec_steps_total"],
            "pool_steps": st["steps_total"] - st["spec_steps_total"],
            "proposed": st["spec_proposed"], "accepted": st["spec_accepted"],
            "acceptance": st["spec_accepted"] / max(st["spec_proposed"], 1),
            "wall_seconds": spec_s, "decode_tokens": tokens,
            "decode_tokens_per_s": tokens / spec_s,
            "launches": counts_sp, "verify_attention_calls": verify,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "against_paged_greedy": {
                name: agreement(torch, dev, model, body, outs[name],
                                pooled[name], tol,
                                f"spec ({label}) request {name}")
                for name, body in greedy.items()}}
        del sp
    del small
    gc.collect()
    torch.cuda.empty_cache()

    # (7) One quantum at 1024 and at 8192 slots (no host sync inside),
    # and the fixed pool's and the paged pool's steps in turns.
    q1024, paged_run = paged_quantum(torch, dev, model, POOL_SLOT_LEN)
    _, fixed_run = paged_quantum(torch, dev, model, POOL_SLOT_LEN,
                                 fixed=True)
    per_step = {"fixed": [], "paged": []}
    for name, fn in (("fixed", fixed_run), ("paged", paged_run),
                     ("paged", paged_run), ("fixed", fixed_run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        per_step[name].append((time.perf_counter() - t0) / POOL_QUANTUM)
    del paged_run, fixed_run
    gc.collect()
    torch.cuda.empty_cache()
    q8192, deep_run = paged_quantum(torch, dev, model, DEEP_SLOT_LEN)
    del deep_run
    gc.collect()
    torch.cuda.empty_cache()
    row["quantum"] = {str(POOL_SLOT_LEN): q1024, str(DEEP_SLOT_LEN): q8192,
                      "fixed_pool_schedule_phase": fixed_quantum,
                      "seconds_per_step_in_turns": per_step}

    # (8) The paged path's timed rows.
    timer = Timer(torch, dev)
    row["timed"] = [gather_row(torch, dev, timer, POOL_SLOT_LEN),
                    gather_row(torch, dev, timer, DEEP_SLOT_LEN)]
    emit(chunk_k2_row(torch, dev, timer))
    emit(null_page_k5_row(torch, dev, timer))
    del timer
    emit(row)
    gc.collect()
    torch.cuda.empty_cache()
    return row["http"]["launches"], row["http"], {
        "bodies": bodies, "pooled": pooled, "held_launches": det_counts}


class VirtualMesh:
    """One process's view of a mesh of ``tp`` ranks (this one ``rank``)
    and ``dp`` data ranks (this one ``dp_rank``), every other axis of size
    1, as ``sharding.layout_for`` and ``local_shard`` read it.  Its groups
    are ``sharding.VirtualGroup``s: set as the global mesh, the port's
    modules compute this rank's part (its heads, columns, vocabulary
    rows) and skip the tp collectives, which the caller does itself,
    adding the ranks' partial sums in rank order and joining their
    outputs.  A data-axis sum (``sharding.sum_over``) the caller replaces
    while the mesh is set (``phase_batch_stats``)."""

    mesh_dim_names = ("pp", "dp", "fsdp", "ep", "tp", "sp")

    def __init__(self, tp, rank, dp=1, dp_rank=0):
        self.sizes = {"tp": tp, "dp": dp}
        self.ranks = {"tp": rank, "dp": dp_rank}

    def size(self, i):
        return self.sizes.get(self.mesh_dim_names[i], 1)

    def get_local_rank(self, axis):
        return self.ranks.get(axis, 0)

    def get_group(self, axis):
        from kubeflow_tpu_torch.parallel.sharding import VirtualGroup

        return VirtualGroup()


def rank_sum(tp, fn):
    """``fn(r)`` of every virtual rank under its ``VirtualMesh``, added in
    rank order (an all-reduce over tp)."""
    from kubeflow_tpu_torch.parallel.context import global_mesh

    out = None
    for r in range(tp):
        with global_mesh(VirtualMesh(tp, r)):
            part = fn(r)
        out = part if out is None else out + part
    return out


def rank_cat(torch, tp, fn):
    """``fn(r)`` of every virtual rank joined on the last axis in rank
    order (an all-gather over tp)."""
    from kubeflow_tpu_torch.parallel.context import global_mesh

    parts = []
    for r in range(tp):
        with global_mesh(VirtualMesh(tp, r)):
            parts.append(fn(r))
    return torch.cat(parts, dim=-1)


def shard_copy(torch, whole, rules, tp, r):
    """A copy of ``whole`` whose parameters the rules split are virtual
    rank ``r``'s ``local_shard`` of ``whole``'s (``requires_grad`` kept)."""
    import copy

    from kubeflow_tpu_torch.parallel.sharding import layout_for, local_shard

    mesh = VirtualMesh(tp, r)
    rank = copy.deepcopy(whole)
    for mod_name, mod in rank.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            layout = layout_for(name, p.shape, rules, mesh)
            if layout.shards:
                setattr(mod, pname, torch.nn.Parameter(
                    local_shard(p.detach(), layout, mesh),
                    requires_grad=p.requires_grad))
    return rank


def phase_serve_mesh(torch, dev, paged_ref):
    """``load_service("llama3_8b", mesh_spec="tp=1")`` at world size 1
    over NCCL (torchrun's env set in this process, as ``phase_mesh``
    does): built shard by shard from seed SEED, served behind the HTTP app
    through the paged engine at 6c's geometry.  At world size 1 nothing is
    exchanged and the kernels see 6c's inputs: 6c's requests give its
    tokens bit for bit, and queued before the loop starts (pipeline and
    prefix cache off) its launches exactly.  /debug/serve shows the mesh
    and pool_shards 1; with a 2-layer draft under the mesh the fixed-slot
    pool serves, its tokens the schedule phase's (request B8, bit for
    bit), and /metrics counts spec-decode-mesh.  The group is gone
    after.  Returns the launch counts of the HTTP run."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler
    from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
    from kubeflow_tpu_torch.models.serve import GenerationService, load_service
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.parallel.context import set_global_mesh

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    knobs = {"KFT_SERVE_SLOTS": str(POOL_SLOTS),
             "KFT_SERVE_SLOT_LEN": str(POOL_SLOT_LEN),
             "KFT_SERVE_DECODE_QUANTUM": str(POOL_QUANTUM)}
    bodies = paged_ref["bodies"]
    t_phase = time.perf_counter()
    row = {"phase": "serve_mesh", "model": "llama3_8b", "mesh_spec": "tp=1"}
    try:
        with env_set(env):
            t0 = time.perf_counter()
            service = load_service("llama3_8b", device="cuda", seed=SEED,
                                   mesh_spec="tp=1")
            torch.cuda.synchronize()
            row["load_seconds"] = time.perf_counter() - t0
        row.update(world_size=dist.get_world_size(),
                   backend=dist.get_backend())
        model, mesh, ls = service.model, service.mesh, service.lockstep
        with env_set(knobs):
            server, thread, base = http_server(service, "llama3_8b")
            try:
                out, row["http"] = paged_http_run(torch, service, base,
                                                  bodies, "serve_mesh")
                _, debug = http(base, "/debug/serve")
            finally:
                stop_server(service, server, thread)
        counts = row["http"]["launches"]
        if out != paged_ref["pooled"]:
            raise AssertionError("serve_mesh: tokens differ from the paged "
                                 "phase's")
        if (debug["mesh"] != dict(zip(mesh.mesh_dim_names, [1] * 6))
                or debug["scheduler"]["pool_shards"] != 1
                or debug["engine"] != "PagedDecodeScheduler"):
            raise AssertionError(f"serve_mesh /debug/serve {debug}")
        held = PagedDecodeScheduler(
            model, pipeline=False, prefix_cache=False, mesh=mesh,
            lockstep=ls, slots=POOL_SLOTS, slot_len=POOL_SLOT_LEN,
            quantum=POOL_QUANTUM)
        kernels.reset_launch_counts()
        held_out, held_s = run_held(held, bodies)
        held_counts = kernels.launch_counts()
        held.stop()
        if held_counts != paged_ref["held_launches"]:
            raise AssertionError(
                f"serve_mesh held launches {held_counts}, the paged "
                f"phase's {paged_ref['held_launches']}")
        if held_out != paged_ref["pooled"]:
            raise AssertionError("serve_mesh: held run's tokens differ")
        row["held"] = {"launches": held_counts, "wall_seconds": held_s,
                       "launches_equal_paged_phase": True}
        del held
        # A draft under the mesh: the fixed-slot pool serves, recorded.
        draft = create_model("llama3_8b", device=dev, n_layers=DRAFT_LAYERS)
        with torch.no_grad():
            draft.reset_parameters(
                torch.Generator(device=dev).manual_seed(DRAFT_SEED))
        spec = GenerationService(model, mesh=mesh, lockstep=ls,
                                 draft_model=draft.eval())
        with env_set(knobs):
            server, thread, base = http_server(spec, "llama3_8b")
            try:
                body = bodies["B8"]
                status, got = http(base, "/v1/generate", body)
                _, metrics = http(base, "/metrics")
                _, debug = http(base, "/debug/serve")
            finally:
                stop_server(spec, server, thread)
        fb = 'serve_paged_fallback_total{reason="spec-decode-mesh"}'
        if (status != 200 or got["tokens"] != paged_ref["fixed"]["B8"]
                or not isinstance(spec._scheduler, DecodeScheduler)
                or isinstance(spec._scheduler, PagedDecodeScheduler)
                or metric_value(metrics, fb) != 1.0
                or debug["paged_fallback"]["reason"] != "spec-decode-mesh"
                or debug["mesh"]["tp"] != 1):
            raise AssertionError(f"serve_mesh fallback: {status} {debug}")
        row["spec_decode_mesh"] = {"engine": debug["engine"],
                                   "fallback": debug["paged_fallback"],
                                   "tokens_equal_schedule_phase": True}
        row.update(tokens_equal_paged_phase=True, launches=counts,
                   debug_mesh=debug["mesh"], pool_shards=1)
        del spec, draft, service, model
    finally:
        set_global_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    row["group_destroyed"] = not dist.is_initialized()
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit(row)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def tp_virtual_ranks(torch, dev, whole, tp):
    """Each virtual rank's attention and MLP of every layer of ``whole``:
    modules at the rank's heads (n_heads / tp over n_kv_heads / tp) and
    ffn / tp, their weights this rank's ``local_shard`` of the whole
    model's by ``llama_rules``."""
    from kubeflow_tpu_torch.models.layers import Attention, SwiGLU
    from kubeflow_tpu_torch.parallel.sharding import (
        layout_for,
        llama_rules,
        local_shard,
    )

    from kubeflow_tpu_torch.models.layers import Embed, Linear

    cfg = whole.cfg
    rules = llama_rules()
    ranks = []
    for r in range(tp):
        mesh = VirtualMesh(tp, r)
        blocks = []
        # The vocabulary-parallel embedding and head: the rank's rows.
        embed = Embed(cfg.vocab_size, cfg.dim, dtype=cfg.dtype, device=dev)
        head = Linear(cfg.dim, cfg.vocab_size, dtype=torch.float32,
                      device=dev)
        for part, key, attr in ((embed, "embed.embedding", "embedding"),
                                (head, "lm_head.weight", "weight")):
            w = getattr(whole.get_submodule(key.rsplit(".", 1)[0]), attr)
            setattr(part, attr, torch.nn.Parameter(
                local_shard(w, layout_for(key, w.shape, rules, mesh), mesh),
                requires_grad=False))
        for i, block in enumerate(whole.layers):
            attn = Attention(cfg.dim, cfg.n_heads // tp, cfg.n_kv_heads // tp,
                             cfg.head_dim, rope_theta=cfg.rope_theta,
                             dtype=cfg.dtype, device=dev)
            mlp = SwiGLU(cfg.dim, cfg.ffn_dim // tp, dtype=cfg.dtype,
                         device=dev)
            for part, src, names in (
                    (attn, block.attn, ("q_proj", "k_proj", "v_proj",
                                        "o_proj")),
                    (mlp, block.mlp, ("gate_proj", "up_proj", "down_proj"))):
                where = "attn" if part is attn else "mlp"
                for n in names:
                    w = getattr(src, n).weight
                    key = f"layers.{i}.{where}.{n}.weight"
                    getattr(part, n).weight = torch.nn.Parameter(
                        local_shard(w, layout_for(key, w.shape, rules, mesh),
                                    mesh), requires_grad=False)
            blocks.append((attn, mlp))
        ranks.append((blocks, embed, head))
    return ranks


def tp_forward(torch, whole, ranks, tokens, positions, caches, *,
               pad_bias, logits_at=None):
    """``whole``'s forward with each layer's attention and MLP run by every
    virtual rank on its shard and their partial sums added in rank order
    where the all-reduce over tp would (in the model's dtype); each rank
    runs every norm over the whole hidden state.  The embedding is the
    ranks' vocabulary-parallel lookups summed, the logits each rank's
    vocabulary joined.  The caches (one a rank, at its kv heads) advance
    by the call's tokens."""
    from kubeflow_tpu_torch.models.layers import head_logits
    from kubeflow_tpu_torch.models.llama import NEG_INF

    tp = len(ranks)
    b, s = tokens.shape
    bias = None
    if s == 1:
        length = caches[0].length
        slots = torch.arange(length, device=tokens.device)
        visible = (slots <= caches[0].index)[None].expand(b, -1)
        bias = (torch.where(visible, 0.0, NEG_INF).float()
                + pad_bias).contiguous()
    x = rank_sum(tp, lambda r: ranks[r][1](tokens))
    for i, block in enumerate(whole.layers):
        x = x + rank_sum(tp, lambda r: ranks[r][0][i][0](
            block.attn_norm(x), positions, cache=caches[r], layer=i,
            bias_rows=bias))
        x = x + rank_sum(tp, lambda r: ranks[r][0][i][1](block.mlp_norm(x)))
    for c in caches:
        c.index += s
    normed = [whole.final_norm(x) for _ in ranks][0]
    if logits_at is not None:
        normed = normed[torch.arange(b, device=x.device), logits_at][:, None]
    return rank_cat(torch, tp, lambda r: head_logits(ranks[r][2], normed))[
        :, -1].float()


def vocab_parallel_checks(torch, dev, whole, ranks, tokens):
    """llama3_8b's whole embedding and f32 head against the virtual ranks'
    vocabulary-parallel ones: the ranks' lookups of ``tokens`` summed
    (zeros outside each rank's rows) bit-equal to the whole table's rows;
    the ranks' logits of TP_HEAD_ROWS hidden rows joined within relative
    L2 TP_HEAD_TOL of the whole head's; the vocabulary-parallel loss,
    each rank's max, sum of exponentials and target logit
    (``train/steps.py`` ``vocab_shard_sums``)
    combined as its all-reduces combine them, within TP_HEAD_TOL
    (relative) of ``F.cross_entropy`` over the whole logits."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models.layers import head_logits
    from kubeflow_tpu_torch.train.steps import vocab_shard_sums

    tp, cfg = len(ranks), whole.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    hidden = torch.randn(TP_HEAD_ROWS, cfg.dim, generator=gen,
                         device=dev).to(cfg.dtype)
    labels = torch.randint(0, cfg.vocab_size, (TP_HEAD_ROWS,),
                           generator=gen, device=dev)
    with torch.inference_mode():
        looked = rank_sum(tp, lambda r: ranks[r][1](tokens))
        want_rows = whole.embed(tokens)
        logits = rank_cat(torch, tp, lambda r: head_logits(ranks[r][2],
                                                           hidden))
        want = whole.lm_head(hidden)
        rows = cfg.vocab_size // tp
        parts = logits.split(rows, dim=-1)
        m = torch.stack([p.amax(-1) for p in parts]).amax(0)
        sums = sum(torch.stack(vocab_shard_sums(p, labels, r * rows, m))
                   for r, p in enumerate(parts))
        loss = (m + torch.log(sums[0]) - sums[1]).mean().item()
        want_loss = F.cross_entropy(want, labels).item()
    out = {"lookup_bit_equal": torch.equal(looked, want_rows),
           "head_rows": TP_HEAD_ROWS, "vocab_per_rank": rows,
           "logits_rel_l2": ((logits - want).norm() / want.norm()).item(),
           "loss": loss, "whole_loss": want_loss,
           "loss_rel_diff": abs(loss - want_loss) / abs(want_loss),
           "tol": TP_HEAD_TOL}
    if (not out["lookup_bit_equal"] or out["logits_rel_l2"] > TP_HEAD_TOL
            or out["loss_rel_diff"] > TP_HEAD_TOL
            or not math.isfinite(loss)):
        raise AssertionError(f"tp_virtual vocabulary-parallel head: {out}")
    return out


def phase_tp_virtual(torch, dev):
    """The kernels at one tp rank's heads: ``llama3_8b`` at full width,
    TP_LAYERS layers, split by the port's ``local_shard`` into TP_VIRTUAL
    tp shards run as virtual ranks in one process (``tp_forward``): a
    ragged b2 prefill (K2 at 8 q over 2 kv heads) and TP_STEPS greedy
    decode steps (K5), whose tokens the bf16 plain route and an f32 copy
    of the whole model are teacher-forced through.  The sharded route's
    logits must be no farther from the f32 model's than COMPOSE_RATIO
    times the plain route's, its greedy tokens equal the f32 model's or
    within AGREE_GAP of its largest logit; launches exact (K2 and K5 once
    a layer a rank, K1 once a norm a rank).  Then K2 and K5 timed at one
    rank's heads beside their bounds and SDPA.  Returns the counts."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.generate import (
        pad_bias_rows,
        prompt_positions,
    )
    from kubeflow_tpu_torch.models.layers import KVCache
    from kubeflow_tpu_torch.ops import cuda as kernels

    tp = TP_VIRTUAL
    t_phase = time.perf_counter()
    variants = {"auto": dict(impl="auto"), "plain": dict(impl="plain"),
                "f32": dict(impl="plain", dtype=torch.float32)}
    models = {name: create_model("llama3_8b", device=dev, n_layers=TP_LAYERS,
                                 **kw) for name, kw in variants.items()}
    with torch.no_grad():
        models["auto"].reset_parameters(
            torch.Generator(device=dev).manual_seed(SEED))
    for name in ("plain", "f32"):
        models[name].load_state_dict(models["auto"].state_dict())
    whole = models["auto"]
    cfg = whole.cfg
    ranks = tp_virtual_ranks(torch, dev, whole, tp)
    _, prompt, mask = ragged_batch(torch, dev, cfg.vocab_size, TP_LENS)
    b = prompt.shape[0]
    positions, lengths = prompt_positions(mask)
    length = prompt.shape[1] + TP_STEPS
    pad_bias = pad_bias_rows(mask, length)
    caches = [KVCache.empty(cfg.n_layers, b, length, cfg.n_kv_heads // tp,
                            cfg.head_dim, dtype=cfg.dtype, device=dev)
              for _ in range(tp)]
    kernels.reset_launch_counts()
    logits, tokens = [], []
    with torch.inference_mode():
        logits.append(tp_forward(torch, whole, ranks, prompt, positions,
                                 caches, pad_bias=pad_bias,
                                 logits_at=lengths - 1))
        for i in range(TP_STEPS):
            tokens.append(logits[-1].argmax(-1))
            logits.append(tp_forward(
                torch, whole, ranks, tokens[-1][:, None],
                (lengths + i)[:, None], caches, pad_bias=pad_bias))
    counts = kernels.launch_counts()
    n, forwards = cfg.n_layers, 1 + TP_STEPS
    want = {"rms_norm": tp * (2 * n + 1) * forwards, "rms_norm_bwd": 0,
            "flash_attention_fwd": tp * n, "flash_attention_fwd_lse": 0,
            "flash_attention_dq": 0, "flash_attention_dkv": 0,
            "flash_decode": tp * n * TP_STEPS}
    if counts != want:
        raise AssertionError(f"tp_virtual launches {counts}, expected {want}")
    # The same tokens through the whole model, bf16 plain and f32.
    ref = {}
    for name in ("plain", "f32"):
        model = models[name]
        out = []
        with torch.inference_mode():
            cache = model.new_cache(b, length)
            out.append(model(prompt, positions=positions, cache=cache,
                             pad_bias=pad_bias, logits_at=lengths - 1).float())
            for i, tok in enumerate(tokens):
                out.append(model(
                    tok[:, None], positions=(lengths + i)[:, None],
                    cache=cache, pad_bias=pad_bias)[:, 0].float())
        ref[name] = out
        del cache
    rel = lambda a, c: ((a - c).norm() / c.norm()).item()
    row = {"phase": "tp_virtual", "model": "llama3_8b", "n_layers": n,
           "tp": tp, "heads_per_rank": [cfg.n_heads // tp,
                                        cfg.n_kv_heads // tp],
           "ffn_per_rank": cfg.ffn_dim // tp, "prompt_lens": list(TP_LENS),
           "decode_steps": TP_STEPS, "ratio_limit": COMPOSE_RATIO,
           "launches": counts}
    for step, sl in (("prefill", slice(0, 1)), ("decode", slice(1, None))):
        got = torch.stack(logits[sl])
        f32 = torch.stack(ref["f32"][sl])
        plain = torch.stack(ref["plain"][sl])
        if not torch.isfinite(got).all():
            raise AssertionError(f"tp_virtual {step}: non-finite logits")
        e_tp, e_plain = rel(got, f32), rel(plain, f32)
        row[f"{step}_rel_l2_tp_vs_f32"] = e_tp
        row[f"{step}_rel_l2_plain_vs_f32"] = e_plain
        if e_tp > COMPOSE_RATIO * e_plain:
            raise AssertionError(
                f"tp_virtual {step}: the sharded route {e_tp} from the f32 "
                f"model, more than {COMPOSE_RATIO} x the plain route's "
                f"{e_plain}")
    f32 = torch.stack(ref["f32"][:-1])                 # [steps, b, vocab]
    chosen = torch.stack(tokens)
    gaps = f32.amax(-1) - f32.gather(-1, chosen[..., None])[..., 0]
    if gaps.max().item() > AGREE_GAP:
        raise AssertionError(f"tp_virtual: greedy tokens {gaps.tolist()} "
                             f"from the f32 model's largest logits")
    row["greedy_equal_f32"] = (chosen == f32.argmax(-1)).float().mean().item()
    row["greedy_max_gap"] = gaps.max().item()
    row["vocab_parallel"] = vocab_parallel_checks(torch, dev, whole, ranks,
                                                  prompt)
    del models, whole, ranks, caches, ref
    gc.collect()
    torch.cuda.empty_cache()
    timer = Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(
        torch.bfloat16)
    h, kvh, hd = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    row["timed"] = [
        k2_row(torch, dev, rnd, timer, *TP_K2_SHAPE, h, kvh, hd,
               path=f"prefill at one tp={tp} rank's heads"),
        k5_row(torch, dev, rnd, timer, *TP_K5_SHAPE, h, kvh, hd,
               path=f"decode at one tp={tp} rank's heads")]
    del timer
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit(row)
    return counts


def vit_tp_logits(torch, whole, ranks, images):
    """``whole``'s ViT forward (training, dropout 0) with each block's
    attention and MLP run by every virtual rank (``ranks``: ``shard_copy``
    of ``whole``) and added in rank order, the head's classes joined."""
    from kubeflow_tpu_torch.models.layers import head_logits

    cfg, tp, b = whole.cfg, len(ranks), images.shape[0]
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    x = whole.patch_embed(x).flatten(2).transpose(1, 2)
    cls = whole.cls_token.to(cfg.dtype).expand(b, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + whole.pos_embed.to(cfg.dtype)
    for i, block in enumerate(whole.blocks):
        h = block.norm1(x)
        x = x + rank_sum(tp, lambda r: ranks[r].blocks[i].attn(h))
        h = block.norm2(x)
        x = x + rank_sum(tp, lambda r: ranks[r].blocks[i].mlp(h))
    x = whole.final_norm(x)
    return rank_cat(torch, tp, lambda r: head_logits(ranks[r].head,
                                                     x[:, 0]))


def bert_tp_logits(torch, whole, ranks, tokens):
    """``whole``'s BERT forward (no mask: the kernel route) with the token
    and position lookups, each layer's attention and MLP run by every
    virtual rank and added in rank order; the pooler and classifier
    whole (the rules split them over fsdp only)."""
    tp, (b, s) = len(ranks), tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = (rank_sum(tp, lambda r: ranks[r].tok_embed(tokens))
         + rank_sum(tp, lambda r: ranks[r].pos_embed(positions))
         + whole.type_embed(torch.zeros_like(tokens)))
    x = whole.embed_norm(x)
    for i, layer in enumerate(whole.layers):
        h = rank_sum(tp, lambda r: ranks[r].layers[i].attn(x))
        x = layer.norm1(x + h)
        h = rank_sum(tp, lambda r: ranks[r].layers[i].mlp(x))
        x = layer.norm2(x + h)
    return whole.classifier(torch.tanh(whole.pooler(x[:, 0])))


def tp_grads(torch, whole, ranks, rules, loss):
    """The gradients of ``loss`` by ``whole``'s parameter names: a
    parameter the ranks computed with gets theirs, joined along its tp
    split or, replicated (a bias), summed (a column-parallel product's
    bias gradient is its slice's on each rank; a row-parallel one's
    bias is rank 0's alone); any other parameter gets ``whole``'s."""
    from kubeflow_tpu_torch.parallel.sharding import layout_for

    tp = len(ranks)
    names = [n for n, _ in whole.named_parameters()]
    own = [dict(rm.named_parameters()) for rm in ranks]
    flat = [p for _, p in whole.named_parameters()] + [
        d[n] for d in own for n in names if n in d]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    got = dict(zip(names, grads[:len(names)]))
    i = len(names)
    per_rank = []
    for d in own:
        per_rank.append({n: grads[i + j] for j, n in enumerate(
            [n for n in names if n in d])})
        i += len(per_rank[-1])
    out = {}
    for name, p in whole.named_parameters():
        parts = [g[name] for g in per_rank if g.get(name) is not None]
        if not parts:
            out[name] = got[name]
            continue
        dim = layout_for(name, p.shape, rules, VirtualMesh(tp, 0)).axis_dim(
            "tp")
        out[name] = (sum(parts) if dim is None
                     else torch.cat(parts, dim=dim))
    return out


def virtual_tp(whole, rules):
    """The most virtual tp ranks, at most TP_VIRTUAL, that the rules can
    split every parameter of ``whole`` over and that divide its heads:
    bert_base's 30522-token vocabulary splits over 2, not 4 or 3 (the
    reference's placement refuses those too)."""
    from kubeflow_tpu_torch.parallel.sharding import layout_for

    for tp in range(TP_VIRTUAL, 0, -1):
        if whole.cfg.n_heads % tp:
            continue
        try:
            for name, p in whole.named_parameters():
                layout_for(name, p.shape, rules, VirtualMesh(tp, 0))
        except ValueError:
            continue
        return tp
    raise AssertionError("unreachable: one rank splits nothing")


def tp_encoder_run(torch, dev, name, batch, timer):
    """``name`` at full width, ENCODER_COMPOSE_LAYERS layers, as
    ``virtual_tp`` virtual tp ranks (``shard_copy`` by its rules; rank r > 0
    drops fc2's bias, which the sum over tp adds once): one training
    forward and backward on the kernel route with the counts at 0 (K2-lse,
    K3 and K4 exactly once a layer a rank), held against the same f32
    masters computed whole in bf16 (the kernel route) and in f32: the
    logits' and all gradients' distance from the f32 model at most
    COMPOSE_RATIO times the whole bf16 model's, the loss within 1e-2 of
    the f32 model's.  Then K2-lse, K3 and K4 timed at one rank's heads."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.parallel.sharding import rules_for_model

    t0 = time.perf_counter()
    overrides = dict(n_layers=ENCODER_COMPOSE_LAYERS)
    if name == BERT_MODEL:
        overrides["num_classes"] = BERT_CLASSES
    whole = create_model(name, device=dev, impl="auto",
                         dtype=torch.bfloat16, **overrides)
    with torch.no_grad():
        whole.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    f32 = create_model(name, device=dev, impl="plain", dtype=torch.float32,
                       **overrides)
    f32.load_state_dict(whole.state_dict())
    whole.requires_grad_(True)
    f32.requires_grad_(True)
    rules = rules_for_model(whole)
    tp = virtual_tp(whole, rules)
    ranks = [shard_copy(torch, whole, rules, tp, r) for r in range(tp)]
    blocks = "blocks" if name == VIT_MODEL else "layers"
    for rm in ranks[1:]:
        for block in getattr(rm, blocks):
            block.mlp.fc2.bias = None
    inputs, labels = batch
    forward = vit_tp_logits if name == VIT_MODEL else bert_tp_logits
    out = {}
    for key, model in (("f32", f32), ("whole", whole)):
        logits = model(inputs, train=True)
        loss = F.cross_entropy(logits.float(), labels.long())
        g = torch.autograd.grad(loss, list(model.parameters()))
        out[key] = (logits.detach().float(), loss.item(),
                    torch.cat([t.float().flatten() for t in g]))
        del g
    kernels.reset_launch_counts()
    logits = forward(torch, whole, ranks, inputs)
    loss = F.cross_entropy(logits.float(), labels.long())
    grads = tp_grads(torch, whole, ranks, rules, loss)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = encoder_launches(tp * ENCODER_COMPOSE_LAYERS, 1)
    if counts != want:
        raise AssertionError(f"tp_virtual {name} launches {counts}, "
                             f"expected {want}")
    out["tp"] = (logits.detach().float(), loss.item(), torch.cat(
        [grads[n].float().flatten() for n, _ in whole.named_parameters()]))
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    row = {"phase": "tp_virtual", "model": name,
           "n_layers": ENCODER_COMPOSE_LAYERS, "tp": tp,
           "heads_per_rank": whole.cfg.n_heads // tp,
           "mlp_per_rank": whole.cfg.mlp_dim // tp,
           "loss": {k: v[1] for k, v in out.items()}, "launches": counts,
           "ratio_limit": COMPOSE_RATIO}
    for what, idx in (("logits", 0), ("all_grads", 2)):
        e_tp, e_whole = rel(out["tp"][idx], out["f32"][idx]), rel(
            out["whole"][idx], out["f32"][idx])
        row[f"{what}_rel_l2_tp_vs_f32"] = e_tp
        row[f"{what}_rel_l2_whole_vs_f32"] = e_whole
        if not math.isfinite(e_tp) or e_tp > COMPOSE_RATIO * e_whole:
            raise AssertionError(f"tp_virtual {name} {what}: the sharded "
                                 f"route {e_tp} from f32, the whole "
                                 f"model's {e_whole}")
    if abs(out["tp"][1] - out["f32"][1]) > 1e-2 * abs(out["f32"][1]):
        raise AssertionError(f"tp_virtual {name} loss {row['loss']}")
    h = whole.cfg.n_heads // tp
    del whole, f32, ranks, out, grads, logits, loss
    gc.collect()
    torch.cuda.empty_cache()
    b, s = ENCODER_ATTENTION[name]
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    row["timed"] = attention_rows(
        torch, dev, gen, timer, f"{name} tp{tp} rank", b, s, h, h, 64,
        causal=False, packed=False,
        path=f"{name.split('_')[0]} at one tp={tp} rank's heads")
    row["phase_seconds"] = time.perf_counter() - t0
    emit(row)
    return counts


def t5_tp_encode(torch, whole, ranks, src, mask):
    """The encoder of ``whole`` run by the virtual ranks: their
    vocabulary-parallel lookups summed, each layer's attention (the rank's
    heads, with its columns of the relative-bias table) and gated MLP
    added in rank order, every norm run by each rank."""
    tp, (b, n) = len(ranks), src.shape
    pad = whole.pad_bias(mask, b, n, src.device)
    biases = [rm.encoder_rel_bias(n, n) + pad for rm in ranks]
    x = rank_sum(tp, lambda r: ranks[r].embed(src))
    for i, block in enumerate(whole.encoder_blocks):
        x = x + rank_sum(tp, lambda r: ranks[r].encoder_blocks[i].attn(
            block.attn_norm(x), biases[r]))
        x = x + rank_sum(tp, lambda r: ranks[r].encoder_blocks[i].mlp(
            block.mlp_norm(x)))
    return [whole.encoder_norm(x) for _ in ranks][0]


def t5_tp_step(torch, whole, ranks, caches, encoded, tokens, mask):
    """One cached decoder step of the virtual ranks (each with its
    ``Seq2SeqCache`` at its heads): the logits [b, vocab] f32, each rank's
    vocabulary joined."""
    from kubeflow_tpu_torch.models.layers import head_logits
    from kubeflow_tpu_torch.models.t5 import NEG_INF

    tp, b = len(ranks), tokens.shape[0]
    cross = whole.pad_bias(mask, b, encoded.shape[1], encoded.device)
    step, length = caches[0].index, caches[0].length
    visible = torch.where(torch.arange(length, device=encoded.device)
                          <= step, 0.0, NEG_INF)
    biases = [rm.decoder_rel_bias.at_position(step, length) + visible
              for rm in ranks]
    y = rank_sum(tp, lambda r: ranks[r].embed(tokens[:, None]))
    for i, block in enumerate(whole.decoder_blocks):
        y = y + rank_sum(tp, lambda r: ranks[r].decoder_blocks[i].self_attn(
            block.self_attn_norm(y), biases[r], causal=True, cache=caches[r],
            layer=i))
        y = y + rank_sum(tp, lambda r: ranks[r].decoder_blocks[i].cross_attn(
            block.cross_attn_norm(y), cross, kv=encoded, cache=caches[r],
            layer=i))
        y = y + rank_sum(tp, lambda r: ranks[r].decoder_blocks[i].mlp(
            block.mlp_norm(y)))
    for c in caches:
        c.index += 1
    normed = [whole.decoder_norm(y) for _ in ranks][0]
    return rank_cat(torch, tp, lambda r: head_logits(ranks[r].lm_head,
                                                     normed))[:, -1].float()


def tp_t5_run(torch, dev):
    """T5_MODEL's width at T5_GRAD_LAYERS encoder and decoder layers (bf16,
    W_q conditioned as ``t5_conditioned``), as TP_VIRTUAL virtual tp ranks
    of 4 heads (``shard_copy`` by ``t5_rules``): a b2 source of
    T5_TP_LENS encoded and T5_TP_STEPS greedy cached decoder steps from
    BOS with the counts at 0 (K1 exactly once a norm a rank; every
    attention carries a bias and runs the plain version).  The greedy
    tokens, teacher-forced through the same weights in f32, must equal
    the f32 model's choices or lie within AGREE_GAP of its largest logit.
    Returns the counts."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.parallel.sharding import t5_rules

    tp = TP_VIRTUAL
    t0 = time.perf_counter()
    layers = dict(n_encoder_layers=T5_GRAD_LAYERS,
                  n_decoder_layers=T5_GRAD_LAYERS)
    whole = create_model(T5_MODEL, device=dev, dtype=torch.bfloat16,
                         **layers)
    with torch.no_grad():
        whole.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    t5_conditioned(torch, whole)
    f32 = create_model(T5_MODEL, device=dev, dtype=torch.float32,
                       impl="plain", **layers)
    f32.load_state_dict(whole.state_dict())
    ranks = [shard_copy(torch, whole, t5_rules(), tp, r) for r in range(tp)]
    _, src, mask = ragged_batch(torch, dev, whole.cfg.vocab_size, T5_TP_LENS)
    b = src.shape[0]
    caches = [rm.new_cache(b, T5_TP_STEPS) for rm in ranks]
    kernels.reset_launch_counts()
    tokens = []
    with torch.inference_mode():
        encoded = t5_tp_encode(torch, whole, ranks, src, mask)
        tok = torch.zeros(b, dtype=torch.long, device=dev)
        for _ in range(T5_TP_STEPS):
            logits = t5_tp_step(torch, whole, ranks, caches, encoded, tok,
                                mask)
            if not torch.isfinite(logits).all():
                raise AssertionError("tp_virtual t5: non-finite logits")
            tok = logits.argmax(-1)
            tokens.append(tok)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: tp * n for k, n in t5_launches(whole.cfg,
                                              T5_TP_STEPS).items()}
    if counts != want:
        raise AssertionError(f"tp_virtual t5 launches {counts}, expected "
                             f"{want}")
    gen = torch.stack(tokens, dim=1)
    ref = t5_teacher_forced(torch, f32, src, mask, gen)
    gaps = ref.amax(-1) - ref.gather(-1, gen[..., None])[..., 0]
    row = {"phase": "tp_virtual", "model": T5_MODEL,
           "layers": T5_GRAD_LAYERS, "tp": tp,
           "heads_per_rank": whole.cfg.n_heads // tp,
           "ffn_per_rank": whole.cfg.ffn_dim // tp,
           "source_lens": list(T5_TP_LENS), "decode_steps": T5_TP_STEPS,
           "cache_heads": caches[0].k[0].shape[2], "launches": counts,
           "greedy_equal_f32": (gen == ref.argmax(-1)).float().mean().item(),
           "greedy_max_gap": gaps.max().item(), "gap_limit": AGREE_GAP,
           "phase_seconds": time.perf_counter() - t0}
    emit(row)
    if caches[0].k[0].shape[2] != whole.cfg.n_heads // tp or \
            gaps.max().item() > AGREE_GAP:
        raise AssertionError(f"tp_virtual t5: {row}")
    del whole, f32, ranks, caches, encoded
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_tp_families(torch, dev):
    """The rest of the mesh at one card: the encoders and T5 computed as
    TP_VIRTUAL virtual tp ranks (``tp_encoder_run``, ``tp_t5_run``).
    Returns the counts of each run by path."""
    from kubeflow_tpu_torch.models import bert, vit

    timer = Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    vit_cfg, bert_cfg = vit.CONFIGS[VIT_MODEL], bert.CONFIGS[BERT_MODEL]
    vit_batch = (torch.randn(VIT_BATCH, vit_cfg.image_size,
                             vit_cfg.image_size, 3, generator=gen,
                             device=dev),
                 torch.randint(0, vit_cfg.num_classes, (VIT_BATCH,),
                               generator=gen, device=dev))
    bert_batch = (torch.randint(0, bert_cfg.vocab_size,
                                (BERT_BATCH, BERT_SEQ), generator=gen,
                                device=dev),
                  torch.randint(0, BERT_CLASSES, (BERT_BATCH,),
                                generator=gen, device=dev))
    counts = {"tp_virtual_vit": tp_encoder_run(torch, dev, VIT_MODEL,
                                               vit_batch, timer),
              "tp_virtual_bert": tp_encoder_run(torch, dev, BERT_MODEL,
                                                bert_batch, timer)}
    del timer, vit_batch, bert_batch
    counts["tp_virtual_t5"] = tp_t5_run(torch, dev)
    return counts


def check_rel_l2(name, got, want, tol):
    """Relative L2 distance |got - want| / max(|want|, 1e-3 sqrt(n)) within
    ``tol``.  Returns (distance, share of the limit, max abs error)."""
    torch = sys.modules["torch"]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    scale = max(want.norm().item(), 1e-3 * math.sqrt(want.numel()))
    err = (got - want).norm().item() / scale
    if err > tol:
        raise AssertionError(f"{name}: relative L2 {err} beyond {tol}")
    return err, err / tol, (got - want).abs().max().item()


def check_lse(name, got, want):
    atol = KERNEL_TOL["flash_attention_fwd_lse"]
    diff = (got - want).abs().max().item()
    if not math.isfinite(diff) or diff > atol:
        raise AssertionError(f"{name}: lse max abs err {diff} beyond "
                             f"atol {atol}")
    return diff, diff / atol


def visible_pairs(torch, dev, b, sq, sk, h, causal, seg):
    """Visible (query, key) pairs summed over batch and q heads."""
    vis = torch.ones(sq, sk, dtype=torch.bool, device=dev)
    if causal:
        vis = torch.tril(vis, diagonal=sk - sq)
    if seg is None:
        return vis.sum().item() * b * h, vis
    vis = vis[None] & (seg[:, :, None] == seg[:, None, :])
    return vis.sum().item() * h, vis


def packed_segments(torch, dev, seq):
    """One row of segment ids as the trainer's packed loader makes them
    (documents of 8 to 256 tokens, seed 0)."""
    from kubeflow_tpu_torch.data.loader import synthetic_lm_documents
    from kubeflow_tpu_torch.data.packing import packed_lm_batches

    _, seg = next(packed_lm_batches(
        synthetic_lm_documents(vocab_size=32000, seed=SEED, max_len=256),
        batch_rows=1, seq_len=seq))
    return torch.from_numpy(seg).to(dev)


def train_kernel_case(torch, dev, gen, b, sq, sk, h, kvh, d, causal, seg,
                      g_lse):
    """Run K2-lse, K3 and K4 once and check each against its plain
    version in f32.  Returns the inputs, outputs and checks."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa

    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)
    q, k, v = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d)
    do = rnd(b, sq, h, d)
    gl = (torch.randn(b, h, sq, generator=gen, device=dev)
          if g_lse else None)
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    dq, delta = fa.flash_attention_dq(q, k, v, o, do, lse, g_lse=gl, **kw)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    # K3 sums a block's key tiles and K4 each GQA group in a fixed order,
    # without atomics: a second launch on the same inputs must repeat dq
    # and delta, dk and dv to the bit.
    dq2, delta2 = fa.flash_attention_dq(q, k, v, o, do, lse, g_lse=gl, **kw)
    dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and torch.equal(delta, delta2)):
        raise AssertionError("flash_attention_dq: a second launch on the "
                             "same inputs gave other dq/delta bits")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError("flash_attention_dkv: a second launch on the "
                             "same inputs gave other dk/dv bits")
    del dq2, delta2, dk2, dv2
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa.plain_attention_with_lse(*f32[:3], **kw)
    checks = {"o": check_close("flash_attention_fwd_lse o", o, o_ref,
                               KERNEL_TOL["flash_attention_fwd"]),
              "lse": check_lse("flash_attention_fwd_lse", lse, lse_ref)}
    del o_ref, lse_ref
    ref = fa.plain_attention_bwd(*f32, g_lse=gl, **kw)
    for name, got, want, kernel in (
            ("dq", dq, ref[0], "flash_attention_dq"),
            ("dk", dk, ref[1], "flash_attention_dkv"),
            ("dv", dv, ref[2], "flash_attention_dkv")):
        checks[name] = check_rel_l2(f"{kernel} {name}", got, want,
                                    KERNEL_TOL[kernel])
    del ref, f32
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta,
                checks=checks, bit_equal=True)


def rms_bwd_case(torch, dev, gen, rows, d, dt, st, kind=None):
    """Run the K1 backward twice on one case and check it against its
    plain version in f32 on the same inputs: dx elementwise at
    KERNEL_TOL["rms_norm_bwd"], dscale by relative L2 at
    KERNEL_TOL["rms_norm_bwd_dscale"], and both bit-equal on relaunch.
    ``kind``: "zero_row" zeroes x's rows 0 and rows // 2; "zero_g" makes
    the cotangent 0.  Returns the inputs and the checks."""
    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    x = torch.randn(rows, d, generator=gen, device=dev).to(dt)
    g = torch.randn(rows, d, generator=gen, device=dev).to(dt)
    scale = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(st)
    if kind == "zero_row":
        x[0] = 0
        x[rows // 2] = 0
    elif kind == "zero_g":
        g.zero_()
    dx, ds = k1.rms_norm_bwd(x, scale, g, eps=1e-5)
    # dscale's sum runs in a fixed order over a fixed grid, no atomics: a
    # second launch must repeat dx and dscale to the bit.
    dx2, ds2 = k1.rms_norm_bwd(x, scale, g, eps=1e-5)
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
        raise AssertionError("rms_norm_bwd: a second launch on the same "
                             "inputs gave other dx/dscale bits")
    want_dx, want_ds = k1.rms_norm_backward(x.float(), scale.float(),
                                            g.float(), eps=1e-5)
    if dx.dtype != dt or ds.dtype != st:
        raise AssertionError(f"rms_norm_bwd: dtypes {dx.dtype} {ds.dtype}, "
                             f"expected {dt} {st}")
    checks = {"dx": check_close("rms_norm_bwd dx", dx, want_dx,
                                KERNEL_TOL["rms_norm_bwd"]),
              "dscale": check_rel_l2("rms_norm_bwd dscale", ds, want_ds,
                                     KERNEL_TOL["rms_norm_bwd_dscale"])}
    return dict(x=x, g=g, scale=scale, checks=checks, bit_equal=True)


def attention_rows(torch, dev, gen, timer, name, b, s, h, kvh, d, *,
                   causal, packed, path):
    """K2-lse, K3 and K4 on one case (``train_kernel_case``: each against
    its plain version in f32, K3 and K4 bit-equal on relaunch), timed
    beside its bound, its plain version and SDPA (forward, or backward
    through ``torch.autograd.grad``); emits a row per kernel and returns
    them by kernel."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa

    seg = packed_segments(torch, dev, s) if packed else None
    c = train_kernel_case(torch, dev, gen, b, s, s, h, kvh, d, causal,
                          seg, False)
    q, k, v, do, o, lse, delta = (c[x] for x in (
        "q", "k", "v", "do", "o", "lse", "delta"))
    kw = dict(causal=causal, segment_ids=seg)
    pairs, vis = visible_pairs(torch, dev, b, s, s, h, causal, seg)
    qkv_bytes = 2 * (b * s * h * d + 2 * b * s * kvh * d)
    qo_bytes = 2 * b * s * h * d          # one bf16 tensor of q's shape
    row_bytes = 4 * b * h * s             # one f32 [b, h, s]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdpa = (dict(is_causal=causal) if seg is None
            else dict(attn_mask=vis[:, None]))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **sdpa)
    go = do.transpose(1, 2)
    lib_fwd = lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), enable_gqa=True, **sdpa)
    lib_bwd_ms = timer(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), go, retain_graph=True))
    shape = [b, s, h, kvh, d]
    out = {
        "flash_attention_fwd_lse": dict(
            check=c["checks"]["lse"], o_check=c["checks"]["o"],
            flops=4 * pairs * d,
            bound=bound_ms(qkv_bytes + qo_bytes + row_bytes,
                           4 * pairs * d, PEAK_BF16_FLOPS),
            ms=timer(lambda: fa.flash_attention_fwd_lse(q, k, v, **kw)),
            plain_ms=timer(lambda: fa.plain_attention_with_lse(
                q, k, v, **kw)),
            library_ms=timer(lib_fwd)),
        "flash_attention_dq": dict(
            check=c["checks"]["dq"],
            flops=6 * pairs * d,
            bound=bound_ms(qkv_bytes + 3 * qo_bytes + 2 * row_bytes,
                           6 * pairs * d, PEAK_BF16_FLOPS),
            ms=timer(lambda: fa.flash_attention_dq(
                q, k, v, o, do, lse, **kw)),
            plain_ms=timer(lambda: fa.plain_attention_dq(
                q, k, v, o, do, lse, **kw)),
            library_ms=lib_bwd_ms),
        "flash_attention_dkv": dict(
            check=max(c["checks"]["dk"], c["checks"]["dv"],
                      key=lambda x: x[1]),
            flops=8 * pairs * d,
            bound=bound_ms(2 * qkv_bytes + 2 * row_bytes,
                           8 * pairs * d, PEAK_BF16_FLOPS),
            ms=timer(lambda: fa.flash_attention_dkv(
                q, k, v, do, lse, delta, **kw)),
            plain_ms=timer(lambda: fa.plain_attention_dkv(
                q, k, v, do, lse, delta, **kw)),
            library_ms=lib_bwd_ms),
    }
    rows = {}
    for kernel, r in out.items():
        err, share = r["check"][:2]
        row = {"kernel": kernel, "shape": shape, "case": name,
               "causal": causal, "segments": packed, "path": path,
               "max_abs_err": (err if kernel.endswith("lse")
                               else r["check"][2]),
               "tol": KERNEL_TOL[kernel],
               "tol_share": share, "kernel_ms": r["ms"],
               "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
               "library": ("sdpa forward" if kernel.endswith("lse")
                           else "sdpa backward (dq, dk and dv)"),
               "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
               "visible_pairs": pairs}
        if kernel.endswith("lse"):
            row["o_tol_share"] = r["o_check"][1]
        else:
            row["rel_l2"] = err
        if kernel == "flash_attention_dkv":
            row["dk_rel_l2"] = c["checks"]["dk"][0]
            row["dv_rel_l2"] = c["checks"]["dv"][0]
        if not kernel.endswith("lse"):
            row["bit_equal_on_relaunch"] = c["bit_equal"]
        emit(add_rates(row, r["flops"]))
        rows[kernel] = row
    del c, q, k, v, do, o, lse, delta, qt, kt, vt, lib_out, go, vis
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_train_kernels(torch, dev, timer):
    """K1 (forward and backward), K2-lse, K3 and K4 at the training path's
    shapes; returns the summary row per kernel at llama_1b4's shape."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = {}
    # K1 at the training rows: b1 x s8192 tokens of llama_1b4's dim 2048.
    n, dm = TRAIN_SEQ, 2048
    x = torch.randn(n, dm, generator=gen, device=dev).to(torch.bfloat16)
    scale = (1.0 + 0.1 * torch.randn(dm, generator=gen, device=dev)).float()
    tol = KERNEL_TOL["rms_norm"]
    err, share = check_close("rms_norm", k1.rms_norm(x, scale, eps=1e-5),
                             k1.plain_rms_norm(x.float(), scale, eps=1e-5),
                             tol)
    bms, by = bound_ms(n * dm * 4 + dm * 4, 4 * n * dm, PEAK_F32_FLOPS)
    y = torch.empty_like(x)
    emit(add_rates({"kernel": "rms_norm", "shape": [n, dm], "path": "train",
          "max_abs_err": err, "tol": tol, "tol_share": share,
          "kernel_ms": timer(lambda: k1.rms_norm(x, scale, eps=1e-5)),
          "plain_ms": timer(lambda: k1.plain_rms_norm(x, scale, eps=1e-5)),
          "library_ms": timer(lambda: F.rms_norm(
              x, (dm,), weight=scale.to(torch.bfloat16), eps=1e-5)),
          "same_bytes_ms": timer(lambda: y.copy_(x)),
          "bound_ms": bms, "bound_by": by}, 4 * n * dm, timer.floor_ms))
    del x, y, scale
    # The K1 backward at the same rows, as the bf16-gradient step calls it
    # (x, g and the scale copy in bf16).  Bound: x, g and the scale read,
    # dx and dscale written (the kernel's f32 workspace, one row of d per
    # block, is not in it: ``workspace_bytes_at_most``); 11 f32 flops an
    # element (x^2 and g*s*x sums, dx = r*gs - x*c, dscale += g*x*r).
    bf = torch.bfloat16
    c = rms_bwd_case(torch, dev, gen, n, dm, bf, bf)
    x, g, scale = c["x"], c["g"], c["scale"]
    flops = 11 * n * dm
    bms, by = bound_ms(3 * n * dm * 2 + 2 * dm * 2, flops, PEAK_F32_FLOPS)
    # The library call: F.rms_norm's backward, through autograd on a
    # graph built once (timing only the backward).
    xl, wl = x.detach().requires_grad_(True), scale.detach().requires_grad_(
        True)
    lib_out = F.rms_norm(xl, (dm,), weight=wl, eps=1e-5)
    dx_out = torch.empty_like(x)
    row = {"kernel": "rms_norm_bwd", "shape": [n, dm], "path": "train",
           "dtypes": {"x": "bf16", "scale": "bf16"},
           "max_abs_err": c["checks"]["dx"][0],
           "tol": KERNEL_TOL["rms_norm_bwd"],
           "tol_share": c["checks"]["dx"][1],
           "dscale_rel_l2": c["checks"]["dscale"][0],
           "dscale_tol": KERNEL_TOL["rms_norm_bwd_dscale"],
           "dscale_tol_share": c["checks"]["dscale"][1],
           "bit_equal_on_relaunch": c["bit_equal"],
           "kernel_ms": timer(lambda: k1.rms_norm_bwd(x, scale, g,
                                                      eps=1e-5)),
           "plain_ms": timer(lambda: k1.rms_norm_backward(x, scale, g,
                                                          eps=1e-5)),
           "library_ms": timer(lambda: torch.autograd.grad(
               lib_out, (xl, wl), g, retain_graph=True)),
           "library": "F.rms_norm backward (dx, dweight)",
           "same_bytes_ms": timer(lambda: torch.add(x, g, out=dx_out)),
           "bound_ms": bms, "bound_by": by,
           "workspace_bytes_at_most": 2 * 4 * dm * k1.bwd_blocks(
               n, x.device)}
    emit(add_rates(row, flops, timer.floor_ms))
    rows["rms_norm_bwd"] = row
    del c, x, g, scale, xl, wl, lib_out, dx_out
    for name, (b, sq, h, kvh, d, packed) in (
            ("llama_1b4", (1, 8192, 16, 16, 128, False)),
            ("llama_1b4 packed", (1, 8192, 16, 16, 128, True)),
            ("llama3_8b gqa", (1, 4096, 32, 8, 128, False))):
        out = attention_rows(torch, dev, gen, timer, name, b, sq, h, kvh, d,
                             causal=True, packed=packed, path="train")
        if name == "llama_1b4":
            rows.update(out)
    return rows


def phase_train_edges(torch, dev):
    """The K1 backward and K2-lse, K3 and K4 beyond the training path's
    shapes, each against its plain version (untimed), the K1 backward, K3
    and K4 also against their own second launch (bit-equal).  K1
    backward: 1, 3 and 8193 rows and 1000 (not a multiple of the grid's
    rows), widths 64, 128, 4096, 8192 and 16384 (the widest bf16 row),
    f32 and bf16 with either scale dtype, rows of x that are all zero, a
    zero cotangent.  Attention: ragged and cross-length causal, head_dim
    64, one key, every GQA group size and GQA 8 at head_dim 64, lengths
    around K2's key tile and ring, K3's q tile, key tile and ring and K4's
    q tile and ring, sq 8191, nonzero g_lse, and segment ids with pads,
    drawn at random, permuted, or with a one-token segment
    (``edge_segments``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {}
    f32, bf = torch.float32, torch.bfloat16
    # (rows, d, x dtype, scale dtype, kind)
    rms_cases = [(n, 2048, bf, bf, None) for n in (1, 3, 1000, 8193)]
    rms_cases += [(33, d, dt, st, None) for d in (64, 128, 4096, 8192)
                  for dt, st in ((bf, bf), (f32, f32), (bf, f32))]
    rms_cases += [(5, 16384, bf, bf, None), (257, 2048, f32, bf, None),
                  (100, 2048, bf, bf, "zero_row"),
                  (100, 4096, f32, f32, "zero_row"),
                  (100, 4096, bf, f32, "zero_g")]
    for n, d, dt, st, kind in rms_cases:
        case = f"{n}x{d} {str(dt)[6:]} scale {str(st)[6:]} {kind}"
        c = rms_bwd_case(torch, dev, gen, n, d, dt, st, kind)
        for name, check in c["checks"].items():
            w = worst.setdefault(f"rms_norm_bwd {name}",
                                 {"cases": 0, "tol_share": 0.0})
            w["cases"] += 1
            if check[1] >= w["tol_share"]:
                w.update(tol_share=check[1], err=check[0], case=case)
        del c
    # (b, sq, sk, h, kv_h, d, causal, segments, g_lse)
    cases = [(2, 100, 100, 4, 2, 128, True, None, False),
             (2, 37, 200, 4, 1, 128, True, None, False),
             (1, 50, 130, 4, 2, 64, False, None, False),
             (2, 130, 130, 4, 4, 64, True, None, False),
             (1, 1, 1, 2, 1, 128, True, None, False),
             (2, 1, 70, 4, 2, 128, True, None, False)]
    cases += [(1, 96, 96, 8, 8 // g, 128, True, None, False)
              for g in (1, 2, 4, 8)]
    cases += [(2, 130, 130, 4, 2, 128, True, "pads", False),
              (1, 77, 77, 8, 2, 64, False, None, True),
              (2, 100, 100, 4, 2, 128, True, "pads", True)]
    lengths = sorted({1, K2_TILE - 1, K2_TILE, K2_TILE + 1,
                      K2_STAGES * K2_TILE + 1, K3_ROWS - 1, K3_ROWS,
                      K3_ROWS + 1, K3_KEYS - 1, K3_KEYS, K3_KEYS + 1,
                      K3_STAGES * K3_KEYS + 1, K4_ROWS - 1, K4_ROWS,
                      K4_ROWS + 1, K4_STAGES * K4_ROWS + 1, K4_KEYS + 1})
    cases += [(1, n, n, 4, 2, 128, True, None, False) for n in lengths]
    cases += [(1, 40, n, 4, 2, 64, False, None, False) for n in lengths]
    cases += [(1, 8191, 8191, 2, 1, 128, True, None, False),
              (1, 129, 300, 4, 2, 128, True, None, False),
              (2, 200, 200, 8, 1, 64, True, None, False),
              (2, 300, 300, 4, 2, 128, False, "blocks", False),
              (2, 300, 300, 4, 2, 128, True, "random", False),
              (1, 257, 257, 4, 4, 64, False, "random", True),
              (2, 300, 300, 4, 2, 128, True, "permuted", False),
              (1, 300, 300, 4, 2, 128, False, "lone", False)]
    for b, sq, sk, h, kvh, d, causal, segs, glse in cases:
        seg = edge_segments(torch, dev, gen, segs, b, sq)
        case = (f"b{b} sq{sq} sk{sk} h{h}/{kvh} d{d} causal={causal} "
                f"segments={segs} g_lse={glse}")
        c = train_kernel_case(torch, dev, gen, b, sq, sk, h, kvh, d, causal,
                              seg, glse)
        for name, check in c["checks"].items():
            share = check[1]
            w = worst.setdefault(name, {"cases": 0, "tol_share": 0.0})
            w["cases"] += 1
            if share >= w["tol_share"]:
                w.update(tol_share=share, err=check[0], case=case)
        del c
    emit({"phase": "train-edges", "cases": len(cases),
          "rms_norm_bwd_cases": len(rms_cases), "worst_by_output": worst})
    torch.cuda.empty_cache()


def phase_train_compose(torch, dev):
    """``llama_1b4`` at full width, 2 layers, the same f32 master weights
    three ways: the kernel route and the plain route computing in bf16
    with bf16 gradients (as the trainer runs), and an f32 plain model with
    f32 gradients as the reference.  One grad step on one b1 s8192 batch
    of the trainer's synthetic stream."""
    from kubeflow_tpu_torch.data.loader import synthetic_lm_batches
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.train.steps import TrainState, make_lm_grad_fn

    tokens = torch.from_numpy(next(synthetic_lm_batches(
        global_batch=1, seq_len=TRAIN_SEQ,
        vocab_size=CONFIGS[TRAIN_MODEL].vocab_size, seed=SEED))).to(dev)
    variants = {"kernel": (dict(impl="auto"), torch.bfloat16),
                "plain": (dict(impl="plain"), torch.bfloat16),
                "f32": (dict(impl="plain", dtype=torch.float32), None)}
    state = None
    grads, losses = {}, {}
    for name, (kw, grad_dtype) in variants.items():
        model = create_model(TRAIN_MODEL, device=dev, n_layers=2,
                             param_dtype=torch.float32, **kw)
        if state is None:
            with torch.no_grad():
                model.reset_parameters(
                    torch.Generator(device=dev).manual_seed(SEED))
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        g, m = make_lm_grad_fn(grad_dtype=grad_dtype)(
            TrainState(model, None), tokens)
        grads[name] = {n: t.float() for n, t in g.items()}
        losses[name] = m["loss"].item()
        del model, g
        torch.cuda.empty_cache()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    per_tensor, worst = {}, (0.0, "")
    for n, ref in grads["f32"].items():
        e_k = rel(grads["kernel"][n], ref)
        e_p = rel(grads["plain"][n], ref)
        if not math.isfinite(e_k):
            raise AssertionError(f"train-compose {n}: non-finite gradient")
        per_tensor[n] = {"kernel_vs_f32": e_k, "plain_vs_f32": e_p}
        if e_k / e_p > worst[0]:
            worst = (e_k / e_p, n)
    cat = lambda name: torch.cat([t.flatten() for t in grads[name].values()])
    row = {"phase": "train-compose", "model": TRAIN_MODEL, "n_layers": 2,
           "batch": [1, TRAIN_SEQ], "loss": losses,
           "all_grads_rel_l2_kernel_vs_f32": rel(cat("kernel"), cat("f32")),
           "all_grads_rel_l2_plain_vs_f32": rel(cat("plain"), cat("f32")),
           "worst_ratio": worst[0], "worst_tensor": worst[1],
           "ratio_limit": COMPOSE_RATIO, "per_tensor": per_tensor}
    emit(row)
    for name in ("kernel", "plain"):
        if not math.isfinite(losses[name]) or abs(
                losses[name] - losses["f32"]) > 1e-2 * abs(losses["f32"]):
            raise AssertionError(f"train-compose loss {losses}")
    if worst[0] > COMPOSE_RATIO:
        raise AssertionError(
            f"train-compose: {worst[1]} kernel-route gradient {worst[0]} x "
            f"the plain route's distance from f32, above {COMPOSE_RATIO}")
    del grads, state
    torch.cuda.empty_cache()


def phase_train_variants(torch, dev):
    """``llama_1b4`` at full width, 2 layers, kernel route, bf16 gradients:
    the step's other paths against the base step (b1, no remat, whole
    head) on the same weights and tokens, each with its exact launches
    per step and its peak memory.  Remat "block" and "mlp" and the chunked
    head and loss (``--ce-chunk``) are held against the base step;
    2 accumulated microbatches (``--grad-accum 2``) against the whole b2
    batch in one step."""
    from kubeflow_tpu_torch.data.loader import synthetic_lm_batches
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.train.steps import (
        TrainState,
        make_grad_accum_step,
        make_lm_grad_fn,
    )

    class Captured(TrainState):
        """Keeps the gradients the accumulating step would apply."""

        def apply_gradients(self, grads):
            self.grads = grads
            return self

    def grad_step(**kw):
        return make_lm_grad_fn(grad_dtype=torch.bfloat16, **kw)

    def accum_step(n):
        step = make_grad_accum_step(
            make_lm_grad_fn(grad_dtype=torch.bfloat16), n)

        def run(state, batch):
            state, metrics = step(state, batch)
            return state.grads, metrics
        return run

    n_layers = 2
    cfg = CONFIGS[TRAIN_MODEL]
    tokens = torch.from_numpy(next(synthetic_lm_batches(
        global_batch=2, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size,
        seed=SEED))).to(dev)
    base = train_launches_per_step(cfg, n_layers=n_layers)
    recompute = dict(base, rms_norm=base["rms_norm"] + 2 * n_layers,
                     flash_attention_fwd_lse=2 * n_layers)
    twice = {k: 2 * n for k, n in base.items()}
    # name: (model overrides, step, rows, reference, launches per step)
    variants = {
        "base": ({}, grad_step(), 1, None, base),
        "remat_block": (dict(remat=True, remat_mode="block"), grad_step(),
                        1, "base", recompute),
        "remat_mlp": (dict(remat=True, remat_mode="mlp"), grad_step(), 1,
                      "base", base),
        "ce_chunk_1024": ({}, grad_step(ce_chunk=1024), 1, "base", base),
        "base_b2": ({}, grad_step(), 2, None, base),
        "grad_accum_2": ({}, accum_step(2), 2, "base_b2", twice),
    }
    cat = lambda v: torch.cat([t.flatten() for t in grads[v].values()])
    state = None
    grads, rows = {}, {}
    for name, (kw, step, n_rows, ref, want) in variants.items():
        # Peak memory of the variant's model and step, above what the
        # phase already holds (the weights and earlier gradients).
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = create_model(TRAIN_MODEL, device=dev, n_layers=n_layers,
                             param_dtype=torch.float32, **kw)
        if state is None:
            with torch.no_grad():
                model.reset_parameters(
                    torch.Generator(device=dev).manual_seed(SEED))
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        kernels.reset_launch_counts()
        g, m = step(Captured(model, None), tokens[:n_rows])
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - held
        grads[name] = {n: t.float() for n, t in g.items()}
        rows[name] = {"loss": m["loss"].item(), "launches": counts,
                      "peak_bytes": peak}
        if counts != want:
            raise AssertionError(
                f"train-variants {name}: launches {counts}, expected {want}")
        if not math.isfinite(rows[name]["loss"]):
            raise AssertionError(f"train-variants {name}: loss not finite")
        if ref is not None:
            rows[name]["reference"] = ref
            rows[name]["loss_rel_diff"] = abs(
                rows[name]["loss"] - rows[ref]["loss"]) / rows[ref]["loss"]
            rows[name]["grads_rel_l2"] = ((cat(name) - cat(ref)).norm()
                                          / cat(ref).norm()).item()
        del model, g
        torch.cuda.empty_cache()
    emit({"phase": "train-variants", "model": TRAIN_MODEL,
          "n_layers": n_layers, "seq": TRAIN_SEQ, "tol": VARIANT_TOL,
          "variants": rows})
    for name, row in rows.items():
        if "reference" not in row:
            continue
        loss_tol, grad_tol = VARIANT_TOL[name]
        if row["loss_rel_diff"] > loss_tol or row["grads_rel_l2"] > grad_tol:
            raise AssertionError(
                f"train-variants {name}: loss off by {row['loss_rel_diff']} "
                f"(limit {loss_tol}), gradients by {row['grads_rel_l2']} "
                f"(limit {grad_tol}) from {row['reference']}")
    del grads, state
    torch.cuda.empty_cache()


def ring_hop_count(n: int, causal: bool) -> int:
    return n * (n + 1) // 2 if causal else n * n


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def phase_ring(torch, dev, timer):
    """Ring attention's own ``hop`` and ``merge`` over SP virtual ranks in
    one process, the script handing each rank its K/V blocks: the output
    and lse against one K2-lse call over the whole sequence (both held to
    f32 within COMPOSE_RATIO of the one call's distance; the lse also to
    K2-lse's lse gate), dq/dk/dv against one K2-lse + K3 + K4 call within
    relative L2 2e-2, exact launches (a causal ring runs n (n + 1) / 2
    hops, each a K2-lse forward and a K3 (with the lse cotangent) and a
    K4 backward), and each layout timed forward and forward + backward.
    First, a chunk shape the kernels do not take must raise under the
    default block route, not run the plain blocks on the card.  Returns
    the first case's launch counts."""
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa
    from kubeflow_tpu_torch.parallel import ring

    bad = torch.zeros(1, 64, 4, 96, dtype=torch.bfloat16, device=dev)
    try:
        ring.use_flash(bad, bad, "auto")
    except ValueError:
        pass
    else:
        raise AssertionError("ring blocks took head_dim 96 on the card")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    first = None
    for name, b, s, h, kvh, d, causal in RING_CASES:
        bf = torch.bfloat16
        rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                         device=dev).to(bf)
        q, k, v, do = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d), \
            rnd(b, s, h, d)
        chunk = s // SP

        def run_ring(q, k, v):
            qs, ks, vs = ([t[:, i * chunk:(i + 1) * chunk].contiguous()
                           for i in range(SP)] for t in (q, k, v))
            outs, lses = [], []
            for i in range(SP):
                state = ring.init_state(qs[i])
                for r in range(SP):
                    src = (i - r) % SP
                    blk = ring.hop(qs[i], ks[src], vs[src],
                                   ring.hop_mode(i, src, causal))
                    if blk is not None:
                        state = ring.merge(state, *blk)
                out, lse = ring.finish(state)
                outs.append(out)
                lses.append(lse)
            return torch.cat(outs, dim=1), torch.cat(lses, dim=2)

        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        kernels.reset_launch_counts()
        out, lse = run_ring(*leaves)
        grads = torch.autograd.grad(out, leaves, do.float())
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        hops = ring_hop_count(SP, causal)
        want = {kk: 0 for kk in counts}
        want.update(flash_attention_fwd_lse=hops, flash_attention_dq=hops,
                    flash_attention_dkv=hops)
        if counts != want:
            raise AssertionError(f"ring {name} causal={causal} launches "
                                 f"{counts}, expected {want}")
        first = first or counts
        one = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o1, lse1 = fa.flash_attention_with_lse(*one, causal=causal)
        g1 = torch.autograd.grad(o1, one, do)
        o32, lse32 = fa.plain_attention_with_lse(q.float(), k.float(),
                                                 v.float(), causal=causal)
        ring_dist, one_dist = rel_l2(out, o32), rel_l2(o1, o32)
        if ring_dist > COMPOSE_RATIO * one_dist:
            raise AssertionError(f"ring {name}: output {ring_dist} from f32, "
                                 f"one call {one_dist}")
        lse_err, lse_share = check_lse(f"ring {name} lse", lse, lse32)
        lse_one = (lse1 - lse32).abs().max().item()
        del o32, lse32
        checks = {n: check_rel_l2(f"ring {name} {n}", g, w,
                                  KERNEL_TOL["flash_attention_dq"])
                  for n, g, w in zip(("dq", "dk", "dv"), grads, g1)}

        def fwd_bwd(fn):
            def run():
                ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
                o = fn(*ls)[0]
                torch.autograd.grad(o, ls, do.to(o.dtype))
            return run

        with torch.no_grad():
            ring_ms = timer(lambda: run_ring(q, k, v))
            one_ms = timer(lambda: fa.flash_attention_fwd_lse(
                q, k, v, causal=causal))
        row = {"phase": "ring", "case": name, "shape": [b, s, h, kvh, d],
               "causal": causal, "sp": SP, "hops": hops, "launches": counts,
               "out_rel_l2_from_f32": ring_dist,
               "one_call_rel_l2_from_f32": one_dist,
               "lse_max_abs_err": lse_err, "lse_tol_share": lse_share,
               "one_call_lse_max_abs_err": lse_one,
               "grad_rel_l2_to_one_call": {n: c[0] for n, c in
                                           checks.items()},
               "ring_fwd_ms": ring_ms, "one_call_fwd_ms": one_ms,
               "ring_fwd_bwd_ms": timer(fwd_bwd(run_ring)),
               "one_call_fwd_bwd_ms": timer(fwd_bwd(
                   lambda q, k, v: fa.flash_attention_with_lse(
                       q, k, v, causal=causal)))}
        emit(row)
        del q, k, v, do, leaves, out, lse, grads, one, o1, lse1, g1
        gc.collect()
        torch.cuda.empty_cache()
    return first


def phase_ulysses(torch, dev, timer):
    """A Ulysses step's local attention on SP virtual ranks of h / SP
    heads each over the whole sequence (what each rank holds after the
    first all-to-all): SP K2 launches, held to one K2 call over all the
    heads (the kernel's blocks are per head, so the output should be
    bit-equal; the row says whether it was), both timed."""
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa
    from kubeflow_tpu_torch.parallel import ulysses

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    b, s, h, d = ULYSSES_SHAPE
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    group = h // SP
    parts = [[t[:, :, r * group:(r + 1) * group].contiguous()
              for t in (q, k, v)] for r in range(SP)]

    def heads():
        return torch.cat([ulysses.local_attention(*p, causal=True,
                                                  softmax_scale=None)
                          for p in parts], dim=2)

    kernels.reset_launch_counts()
    with torch.no_grad():
        out = heads()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {kk: 0 for kk in counts}
    want["flash_attention_fwd"] = SP
    if counts != want:
        raise AssertionError(f"ulysses launches {counts}, expected {want}")
    one = fa.flash_attention(q, k, v, causal=True)
    err, share = check_close("ulysses head groups", out, one,
                             KERNEL_TOL["flash_attention_fwd"])
    emit({"phase": "ulysses", "shape": list(ULYSSES_SHAPE), "sp": SP,
          "heads_per_rank": group, "launches": counts,
          "bit_equal_to_one_call": bool(torch.equal(out, one)),
          "max_abs_err_to_one_call": err, "tol_share": share,
          "head_groups_ms": timer(heads),
          "one_call_ms": timer(lambda: fa.flash_attention(q, k, v,
                                                           causal=True))})
    del q, k, v, parts, out, one
    torch.cuda.empty_cache()
    return counts


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_mesh(torch, train):
    """``train.run.main(MESH_ARGS)`` in this process: the process group
    from torchrun's env at world size 1 over NCCL, the mesh fsdp=1, the
    state sharded by llama_rules and trained by the sharded step.  The
    group is gone after it.  Losses held to the train phase's step by step
    (MESH_LOSS_TOL), launches a step equal to the train phase's, step
    seconds and peak memory beside it.  Returns the launch counts and the
    losses."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.ops import cuda as kernels

    cfg = CONFIGS[TRAIN_MODEL]
    n_steps = int(MESH_ARGS[MESH_ARGS.index("--steps") + 1])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {kk: os.environ.get(kk) for kk in env}
    os.environ.update(env)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        steps, done = run_trainer(MESH_ARGS)
        wall_s = time.perf_counter() - t0
    finally:
        for kk, vv in saved.items():
            if vv is None:
                os.environ.pop(kk, None)
            else:
                os.environ[kk] = vv
        if dist.is_initialized():
            dist.destroy_process_group()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {kk: n * n_steps for kk, n in train_launches_per_step(cfg).items()}
    if counts != want:
        raise AssertionError(f"mesh launch counts {counts}, expected {want}")
    losses = [st["loss"] for st in steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    # Both runs' losses are read from the trainer's lines, printed to 6
    # significant digits: one unit of the sixth digit is allowed besides.
    limits = [MESH_LOSS_TOL
              + 10.0 ** (math.floor(math.log10(abs(b))) - 5) / abs(b)
              for b in train["losses"]]
    if len(losses) != n_steps or any(r > t for r, t in zip(rel, limits)):
        raise AssertionError(f"mesh losses {losses} against the train "
                             f"phase's {train['losses']}: {rel}")
    step_s = statistics.median(st["step_seconds"] for st in steps[1:])
    emit({"phase": "mesh", "args": MESH_ARGS, "world_size": 1,
          "backend": "nccl", "losses": losses,
          "train_phase_losses": train["losses"], "loss_rel_diff": rel,
          "loss_tol": MESH_LOSS_TOL,
          "step_seconds": [st["step_seconds"] for st in steps],
          "median_step_seconds_2_to_6": step_s,
          "train_phase_median_step_seconds": train["step_seconds"],
          "max_memory_allocated_bytes": peak,
          "train_phase_max_memory_allocated_bytes": train["peak"],
          "wall_seconds": wall_s, "launches": counts,
          "launches_per_step": train_launches_per_step(cfg),
          "group_destroyed": not dist.is_initialized(), "done": done})
    gc.collect()
    torch.cuda.empty_cache()
    return counts, losses


def run_trainer(argv):
    """``train.run.main(argv)`` with its standard output captured; returns
    the exit code and the parsed ``train_step`` lines."""
    from kubeflow_tpu_torch.train import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    lines = buf.getvalue().splitlines()
    steps = []
    for line in lines:
        if line.startswith("train_step "):
            kv = dict(p.split("=", 1) for p in line.split()[1:])
            steps.append({k: float(v) for k, v in kv.items()})
    if rc != 0 or not lines or not lines[-1].startswith("done: step "):
        raise AssertionError(f"trainer exited {rc}: {lines[-3:]}")
    return steps, lines[-1]


def train_launches_per_step(cfg, n_layers=None):
    """Launches a step per wrapper: two norms a layer and the final one,
    each run forward and backward once; one attention a layer."""
    n = cfg.n_layers if n_layers is None else n_layers
    return {"rms_norm": 2 * n + 1, "rms_norm_bwd": 2 * n + 1,
            "flash_attention_fwd": 0,
            "flash_attention_fwd_lse": n, "flash_attention_dq": n,
            "flash_attention_dkv": n, "flash_decode": 0}


def profile_train_step(torch, argv):
    """Build the trainer as ``main`` does, run two steps, then one step
    under torch.profiler: its wall time, device kernel time by class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.train import run

    _, args = run.parse_args(argv)
    state, step, batches = run.build_lm(args, torch.device("cuda"))
    it = iter(batches(0))
    for _ in range(2):
        state, m = step(state, next(it))
    m["loss"].item()
    batch = next(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    classes = {"flash_attention_fwd_lse": 0.0, "flash_attention_dq": 0.0,
               "flash_attention_dkv": 0.0, "rms_norm": 0.0,
               "rms_norm_bwd": 0.0, "matmul": 0.0, "optimizer": 0.0,
               "other": 0.0}
    by_name, spans = {}, []
    for e in prof.events():
        # A user annotation on the device timeline (the optimizer's
        # "Optimizer.step#AdamW.step") spans kernels counted on their own.
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False) or "#" in e.name:
            continue
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
        if "flash_fwd_kernel" in name:
            classes["flash_attention_fwd_lse"] += us
        elif "flash_bwd_dq_kernel" in name:
            classes["flash_attention_dq"] += us
        elif "flash_bwd_dkv_kernel" in name:
            classes["flash_attention_dkv"] += us
        elif "rms_norm_bwd" in name:     # the row kernel and its sum
            classes["rms_norm_bwd"] += us
        elif "rms_norm_kernel" in name:
            classes["rms_norm"] += us
        elif any(t in name.lower() for t in ("gemm", "gemv", "cutlass",
                                             "xmma", "cublas", "nvjet")):
            classes["matmul"] += us
        elif "multi_tensor_apply" in name:   # the foreach AdamW update
            classes["optimizer"] += us
        else:
            classes["other"] += us
    # Busy time is the union of the device intervals: activities that
    # overlap (a copy beside a kernel) count once.
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    del state, step, batches, it, batch, prof
    return {"wall_seconds": wall_s,
            "device_kernel_seconds": sum(classes.values()) / 1e6,
            "device_busy_seconds": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "device_kernels": len(spans),
            "device_ms_by_class": {k: v / 1e3 for k, v in classes.items()},
            "top_kernels": [{"name": name[:90], "ms": t / 1e3, "count": c}
                            for name, (t, c) in top]}


def phase_train(torch):
    """The trainer's main path, then a profiled step, then the packed
    run.  Returns the launch counts of the 6-step run."""
    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.telemetry import compute as ctel

    cfg = CONFIGS[TRAIN_MODEL]
    n_steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    steps, done = run_trainer(TRAIN_ARGS)
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * n_steps for k, n in train_launches_per_step(cfg).items()}
    if counts != want:
        raise AssertionError(f"train launch counts {counts}, expected {want}")
    losses = [s["loss"] for s in steps]
    if len(steps) != n_steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_train_step(torch, TRAIN_ARGS)
    steady = steps[1:]
    step_s = statistics.median(s["step_seconds"] for s in steady)
    fpt = ctel.lm_train_flops_per_token(cfg, TRAIN_SEQ)
    emit({"phase": "train", "model": TRAIN_MODEL, "args": TRAIN_ARGS,
          "n_layers": cfg.n_layers, "losses": losses,
          "step_seconds": [s["step_seconds"] for s in steps],
          "median_step_seconds_2_to_6": step_s,
          "tokens_per_sec": TRAIN_SEQ / step_s,
          "mfu": ctel.mfu(TRAIN_SEQ / step_s, fpt), "flops_per_token": fpt,
          "mfu_peak_tflops": ctel.H100_SXM_BF16_PEAK_TFS,
          "wall_seconds_with_build": wall_s,
          "max_memory_allocated_bytes": peak,
          "launches": counts,
          "launches_per_step": train_launches_per_step(cfg),
          "profiled_step": prof, "done": done})
    gc.collect()
    torch.cuda.empty_cache()

    n_packed = int(PACKED_ARGS[PACKED_ARGS.index("--steps") + 1])
    kernels.reset_launch_counts()
    steps_p, done_p = run_trainer(PACKED_ARGS)
    counts_p = kernels.launch_counts()
    want_p = {k: n * n_packed
              for k, n in train_launches_per_step(cfg).items()}
    losses_p = [s["loss"] for s in steps_p]
    if counts_p != want_p:
        raise AssertionError(f"packed launch counts {counts_p}, "
                             f"expected {want_p}")
    if len(steps_p) != n_packed or not all(math.isfinite(x)
                                           for x in losses_p):
        raise AssertionError(f"packed losses {losses_p}")
    emit({"phase": "train-packed", "args": PACKED_ARGS, "losses": losses_p,
          "step_seconds": [s["step_seconds"] for s in steps_p],
          "launches": counts_p, "done": done_p})
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"losses": losses, "step_seconds": step_s, "peak": peak}


def ckpt_state(torch, dev, n_layers):
    """A fresh ``llama_1b4`` train state as the trainer builds it (f32
    masters from seed SEED, AdamW at its default lr)."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.train.steps import TrainState, adamw

    model = create_model(TRAIN_MODEL, device=dev, n_layers=n_layers,
                         max_seq_len=TRAIN_SEQ, param_dtype=torch.float32)
    with torch.no_grad():
        model.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    model.requires_grad_(True)
    return TrainState(model, adamw(model.parameters(), 3e-4))


def ckpt_batches(dev):
    """The trainer's step-indexed stream (b1 TRAIN_SEQ), from a step."""
    from kubeflow_tpu_torch.data.loader import DeviceLoader, synthetic_lm_batches
    from kubeflow_tpu_torch.models.llama import CONFIGS

    return lambda start=0: DeviceLoader(synthetic_lm_batches(
        global_batch=1, seq_len=TRAIN_SEQ,
        vocab_size=CONFIGS[TRAIN_MODEL].vocab_size, seed=SEED,
        start=start), dev)


def ckpt_run(torch, dev, state, total, ckpt=None, stop=None, at_log=None):
    """``train_loop`` for ``total`` steps (bf16 gradients, a log line and
    with ``ckpt`` a save every 2 steps); returns (state, losses)."""
    from kubeflow_tpu_torch.train.loop import LoopConfig, train_loop
    from kubeflow_tpu_torch.train.steps import make_lm_train_step

    losses = []

    def on_log(step, vals):
        losses.append(vals["loss"])
        if at_log is not None:
            at_log(step)

    with contextlib.redirect_stdout(io.StringIO()):
        state, _ = train_loop(
            state, make_lm_train_step(grad_dtype=torch.bfloat16),
            ckpt_batches(dev),
            LoopConfig(total_steps=total, log_every=1, checkpoint_dir=ckpt,
                       checkpoint_every=2),
            stop=stop, on_log=on_log)
    return state, losses


def state_copy(state):
    """(parameters, optimizer state by index, step), cloned."""
    return ({n: p.detach().clone() for n, p in
             state.module.named_parameters()},
            {i: {k: v.clone() for k, v in per.items()}
             for i, per in state.optimizer.state_dict()["state"].items()},
            state.step)


def state_diff(a, b):
    """Largest |difference| over parameters and AdamW moments (and the
    step counts, which must match)."""
    if a[2] != b[2] or set(a[0]) != set(b[0]) or set(a[1]) != set(b[1]):
        return math.inf
    worst = 0.0
    for name in a[0]:
        worst = max(worst, (a[0][name] - b[0][name]).abs().max().item())
    for i in a[1]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            worst = max(worst, (a[1][i][k].float()
                                - b[1][i][k].float()).abs().max().item())
    return worst


def checkpoint_root():
    """Where checkpoints go: a git-ignored directory of this checkout."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "checkpoints")
    os.makedirs(root, exist_ok=True)
    return root


def phase_checkpoint(torch, dev):
    """(a) ``llama_1b4`` at full width, 2 layers: save, stop, resume
    against unbroken runs; (b) all 24 layers through ``train.run`` with
    ``--checkpoint-dir``, restored by ``load_service`` and served through
    the scheduler."""
    from kubeflow_tpu_torch.models.generate import generate, row_generators
    from kubeflow_tpu_torch.models.serve import create_app, load_service
    from kubeflow_tpu_torch.train import run
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.train.steps import make_lm_train_step

    root = checkpoint_root()
    usage = shutil.disk_usage(root)
    emit({"phase": "checkpoint-disk", "path": root, "free_bytes": usage.free,
          "total_bytes": usage.total})
    tmp = tempfile.mkdtemp(prefix="chip-smoke-", dir=root)
    try:
        # (a) 4 unbroken steps, twice; 2 steps, a stop, a resume for 2.
        runs = []
        for _ in range(2):
            state, losses = ckpt_run(torch, dev, ckpt_state(torch, dev, 2), 4)
            runs.append((state_copy(state), losses))
            del state
        unbroken_diff = state_diff(runs[0][0], runs[1][0])
        stop = threading.Event()
        run_dir = os.path.join(tmp, "run")
        state, losses_b = ckpt_run(
            torch, dev, ckpt_state(torch, dev, 2), 4, ckpt=run_dir,
            stop=stop, at_log=lambda step: step == 2 and stop.set())
        if state.step != 2 or CheckpointManager(run_dir).all_steps() != [2]:
            raise AssertionError(f"stop at step {state.step}, saved "
                                 f"{CheckpointManager(run_dir).all_steps()}")
        saved = state_copy(state)
        fresh = ckpt_state(torch, dev, 2)
        CheckpointManager(run_dir).restore(fresh)
        restored_diff = state_diff(state_copy(fresh), saved)
        del fresh
        # The snapshot rule: training goes on in place while the write
        # runs, and the restored state is still the saved one.
        snap = CheckpointManager(os.path.join(tmp, "snap"))
        t0 = time.perf_counter()
        snap.save(2, state)
        save_return_s = time.perf_counter() - t0
        batch = next(iter(ckpt_batches(dev)(2)))
        state, _ = make_lm_train_step(grad_dtype=torch.bfloat16)(state, batch)
        torch.cuda.synchronize()
        snap.wait()
        fresh = ckpt_state(torch, dev, 2)
        snap.restore(fresh)
        snapshot_diff = state_diff(state_copy(fresh), saved)
        moved = max((p.detach() - saved[0][n]).abs().max().item()
                    for n, p in state.module.named_parameters())
        del state, fresh, saved
        resumed, losses_c = ckpt_run(torch, dev, ckpt_state(torch, dev, 2), 4,
                                     ckpt=run_dir)
        resumed_diff = state_diff(state_copy(resumed), runs[0][0])
        del resumed
        loss_diff_unbroken = max(abs(x - y) for x, y in zip(runs[0][1],
                                                            runs[1][1]))
        loss_diff_resumed = max(abs(x - y) for x, y in zip(
            losses_b + losses_c, runs[0][1]))
        row = {"phase": "checkpoint-resume", "model": TRAIN_MODEL,
               "n_layers": 2, "seq": TRAIN_SEQ,
               "losses_unbroken": runs[0][1],
               "losses_stopped_then_resumed": losses_b + losses_c,
               "restored_vs_saved_max_diff": restored_diff,
               "restored_while_training_went_on_max_diff": snapshot_diff,
               "params_moved_after_save": moved,
               "save_returned_seconds": save_return_s,
               "last_save": snap.last_save,
               "unbroken_vs_unbroken_max_diff": unbroken_diff,
               "resumed_vs_unbroken_max_diff": resumed_diff,
               "loss_diff_unbroken_vs_unbroken": loss_diff_unbroken,
               "loss_diff_resumed_vs_unbroken": loss_diff_resumed}
        emit(row)
        del runs
        gc.collect()
        torch.cuda.empty_cache()
        if restored_diff != 0.0 or snapshot_diff != 0.0 or moved == 0.0:
            raise AssertionError("a restored state differs from the saved "
                                 "one (or training did not go on)")
        if resumed_diff > unbroken_diff or \
                loss_diff_resumed > loss_diff_unbroken:
            raise AssertionError(
                f"resumed run off by {resumed_diff} (loss {loss_diff_resumed})"
                f", two unbroken runs by {unbroken_diff} "
                f"(loss {loss_diff_unbroken})")

        # (b) the whole model through the trainer, then served.
        full_dir = os.path.join(tmp, "full")
        argv = TRAIN_ARGS[:TRAIN_ARGS.index("--steps")] + [
            "--steps", "3", "--log-every", "1", "--checkpoint-dir", full_dir]
        _, args = run.parse_args(argv)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state, _ = run.train(args, dev)
        train_s = time.perf_counter() - t0
        saves = [dict(kv.split("=", 1) for kv in line.split()[1:])
                 for line in buf.getvalue().splitlines()
                 if line.startswith("checkpoint ")]
        steps_on_disk = CheckpointManager(full_dir).all_steps()
        disk_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(full_dir) for f in fs)
        if steps_on_disk != [3] or len(saves) != 1:
            raise AssertionError(f"trainer saved {steps_on_disk}: {saves}")
        t0 = time.perf_counter()
        service = load_service(TRAIN_MODEL, checkpoint_dir=full_dir,
                               use_scheduler=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        served = service.model.state_dict()
        trained = dict(state.module.named_parameters())
        unequal = [n for n, p in trained.items()
                   if not torch.equal(served[n], p.detach().to(
                       served[n].dtype))]
        del state, trained
        gc.collect()
        torch.cuda.empty_cache()
        if unequal or set(served) != set(
                dict(service.model.named_parameters())):
            raise AssertionError(f"restored parameters differ: {unequal}")
        # One request through the scheduler, at the width and cache
        # length generate() runs it at, so the two match to the bit.
        import numpy as np

        prompt = np.random.RandomState(SEED + 20).randint(
            0, service.model.cfg.vocab_size, size=100).tolist()
        n = 32
        knobs = {"KFT_SERVE_SLOTS": "1",
                 "KFT_SERVE_SLOT_LEN": str(len(prompt) + n),
                 "KFT_SERVE_PAGED": "0"}
        with env_set(knobs):
            create_app(service, model_name=TRAIN_MODEL)
            got = service.generate([prompt], max_new_tokens=n)
        sched = service._scheduler
        st = sched.stats() if sched is not None else None
        if sched is not None:
            sched.stop()
        want = generate(service.model, torch.tensor([prompt], device=dev),
                        max_new_tokens=n,
                        generators=row_generators(0, 1, dev)).tolist()
        emit({"phase": "checkpoint-serve", "model": TRAIN_MODEL,
              "n_layers": service.model.cfg.n_layers, "args": argv,
              "train_seconds_with_save": train_s, "save": saves[0],
              "bytes_on_disk": disk_bytes, "restore_seconds": restore_s,
              "restored_params_equal": True, "scheduler": st,
              "tokens_equal_generate": got == want,
              "row0_head": got[0][:8]})
        if st is None or st["evicted_total"] != 1 or got != want:
            raise AssertionError(f"served {got} through {st}, generate() "
                                 f"gives {want}")
        del service, served
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def teacher_forced_logits(torch, dev, model, body, out):
    """Logits [n, vocab] at each greedy row's emitted positions under one
    forward of the prompt and the tokens before each (no cache)."""
    got = []
    with torch.inference_mode():
        for prompt, gen in zip(body["tokens"], out):
            seq = torch.tensor([prompt + gen[:-1]], device=dev)
            got.append(model(seq)[0, len(prompt) - 1:].float())
    return torch.cat(got)


def phase_int8(torch, dev, model, bf16_http):
    """llama3_8b from the same seed, weight-only int8, served over HTTP
    through the paged engine: weight bytes, exact launches, decode rate
    against the bf16 paged run of this process (``bf16_http``), the
    greedy rows' teacher-forced argmax against the bf16 model, and one
    layer's dequantized weights on the card against the CPU's."""
    import copy

    from kubeflow_tpu_torch.models.quantize import (
        quantize_tensor,
        quantized_bytes,
    )
    from kubeflow_tpu_torch.models.serve import load_service

    cfg = model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    service = load_service(INT8_MODEL, device="cuda", seed=SEED,
                           quantize="int8")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    qmodel = service.model
    row = {"phase": "int8", "model": INT8_MODEL, "load_seconds": load_s,
           "weight_bytes_int8": quantized_bytes(qmodel),
           "weight_bytes_bf16": quantized_bytes(model)}
    # The same weights: layer 0's q_proj quantized from the bf16 model's
    # equals the service's (both drawn from SEED on the card).
    q, scale = quantize_tensor(model.layers[0].attn.q_proj.weight.view(
        cfg.n_heads, cfg.head_dim, cfg.dim), (0, 2))
    q_proj = qmodel.layers[0].attn.q_proj
    if not (torch.equal(q.view(-1, cfg.dim), q_proj.qweight)
            and torch.equal(scale, q_proj.scale)):
        raise AssertionError("int8: the service's weights are not the bf16 "
                             "model's quantized")
    # Dequantization on the card, bit for bit the CPU's.
    layer0 = qmodel.layers[0]
    mods = {name: mod for name, mod in layer0.named_modules()
            if getattr(mod, "qweight", None) is not None}
    for name, mod in mods.items():
        on_cpu = copy.deepcopy(mod).cpu()
        if not torch.equal(mod.dense_weight().cpu(), on_cpu.dense_weight()):
            raise AssertionError(f"int8: layer 0 {name} dequantizes "
                                 "otherwise on the card than on the CPU")
    row["dequantized_bit_equal_cpu"] = sorted(mods)
    bodies = schedule_bodies(torch, dev, cfg.vocab_size)
    knobs = {"KFT_SERVE_SLOTS": str(POOL_SLOTS),
             "KFT_SERVE_SLOT_LEN": str(POOL_SLOT_LEN),
             "KFT_SERVE_DECODE_QUANTUM": str(POOL_QUANTUM)}
    with env_set(knobs):
        server, thread, base = http_server(service, INT8_MODEL)
        try:
            out, run = paged_http_run(torch, service, base, bodies, "int8")
            _, debug = http(base, "/debug/serve")
        finally:
            stop_server(service, server, thread)
    if debug["quantize"] != "int8" or debug["weight_bytes"] != row[
            "weight_bytes_int8"]:
        raise AssertionError(f"int8: /debug/serve {debug}")
    run["decode_tokens_per_s_bf16_paged"] = bf16_http["decode_tokens_per_s"]
    run["decode_rate_int8_over_bf16"] = (run["decode_tokens_per_s"]
                                         / bf16_http["decode_tokens_per_s"])
    row["http"] = run
    agree, n, rel = 0, 0, []
    for name, body in bodies.items():
        if body["temperature"] != 0.0:
            continue
        lq = teacher_forced_logits(torch, dev, qmodel, body, out[name])
        lb = teacher_forced_logits(torch, dev, model, body, out[name])
        agree += int((lq.argmax(-1) == lb.argmax(-1)).sum())
        n += lq.shape[0]
        rel.append(((lq - lb).norm() / lb.norm()).item())
        if not torch.isfinite(lq).all():
            raise AssertionError(f"int8 request {name}: non-finite logits")
    row["teacher_forced"] = {"positions": n, "argmax_agreement": agree / n,
                             "logits_rel_l2_by_request": rel}
    emit(row)
    del service, qmodel, mods
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"]


def phase_moe_layer(torch, dev):
    """One MoE MLP at mixtral_8x7b's width in bf16, b2 with the second row
    half padded (token_mask), at each MOE_LAYER_SEQS length: the index
    dispatch against the dense one-hot einsums on the same weights
    (routing identical, output and aux within tolerance), each timed and
    its peak memory read."""
    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.models.moe import MoeMlp, dense_dispatch

    cfg = CONFIGS[MOE_MODEL]
    moe = MoeMlp(cfg.dim, cfg.ffn_dim, cfg.n_experts, top_k=cfg.top_k,
                 capacity_factor=cfg.capacity_factor, dtype=torch.bfloat16,
                 device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        moe.reset_parameters(gen)
        moe.router.reset_parameters(gen)
    timer = Timer(torch, dev)
    rows = []
    for s in MOE_LAYER_SEQS:
        x = torch.randn(2, s, cfg.dim, generator=gen, device=dev).to(
            torch.bfloat16)
        mask = torch.ones(2, s, dtype=torch.bool, device=dev)
        mask[1, s // 2:] = False
        peaks = {}
        with torch.no_grad():
            for name, fn in (("index", lambda: moe(x, mask)),
                             ("dense", lambda: dense_dispatch(moe, x, mask))):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                res = fn()
                torch.cuda.synchronize()
                peaks[name] = torch.cuda.max_memory_allocated() - base
                if name == "index":
                    y, aux = res
                else:
                    yd, auxd, dispatch = res
                del res
            routing = moe.route(x, mask)
            same = torch.equal(routing.dispatch_mask(), dispatch)
            if not same:
                raise AssertionError(f"moe_layer s{s}: routing differs from "
                                     "the dense dispatch")
            err, share, max_abs = check_rel_l2(f"moe_layer s{s}", y, yd,
                                               MOE_LAYER_TOL)
            aux_err = abs(aux.item() - auxd.item())
            if not aux_err <= MOE_AUX_TOL:
                raise AssertionError(f"moe_layer s{s}: aux {aux.item()} "
                                     f"against {auxd.item()}")
            pad = ~mask
            if routing.keep[pad].any() or y[pad].abs().max().item() != 0.0:
                raise AssertionError(f"moe_layer s{s}: padding was routed")
            real = int(mask.sum()) * cfg.top_k
            kept = int(routing.keep.sum())
            index_ms = timer(lambda: moe(x, mask))
            dense_ms = timer(lambda: dense_dispatch(moe, x, mask))
        c = routing.capacity
        # The expert products the buffers run (3 matmuls of 2 d f flops a
        # place), whether a place holds a token or zeros.
        flops = 3 * 2 * cfg.n_experts * 2 * c * cfg.dim * cfg.ffn_dim
        rows.append({"seq": s, "batch": 2, "capacity": c,
                     "choices_real": real, "choices_kept": kept,
                     "routing_identical": same, "rel_l2": err,
                     "share_of_tol": share, "max_abs_err": max_abs,
                     "aux": aux.item(), "aux_abs_err": aux_err,
                     "index_ms": index_ms, "dense_ms": dense_ms,
                     "expert_tflops_index": flops / (index_ms * 1e-3) / 1e12,
                     "peak_bytes_index": peaks["index"],
                     "peak_bytes_dense": peaks["dense"]})
        del x, y, yd, dispatch, routing
    emit({"phase": "moe_layer", "model": MOE_MODEL, "tol": MOE_LAYER_TOL,
          "aux_tol": MOE_AUX_TOL, "rows": rows})
    del moe, timer
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def impl_route(model, impl):
    """Every RMSNorm and attention of ``model`` on route ``impl`` inside."""
    mods = [m for m in model.modules() if hasattr(m, "impl")]
    saved = [m.impl for m in mods]
    for m in mods:
        m.impl = impl
    try:
        yield
    finally:
        for m, v in zip(mods, saved):
            m.impl = v


@contextlib.contextmanager
def recorded_routing(model):
    """Each MoE layer's (expert, keep) of every call made inside, a list a
    layer."""
    logs = []
    for block in model.layers:
        log, route = [], block.mlp.route

        def record(*a, _route=route, _log=log, **kw):
            r = _route(*a, **kw)
            _log.append((r.expert, r.keep))
            return r

        block.mlp.route = record
        logs.append(log)
    try:
        yield logs
    finally:
        for block in model.layers:
            del block.mlp.route


def phase_moe_serve(torch, dev):
    """mixtral_8x7b at full width, MOE_SERVE_LAYERS layers, through
    ``load_service`` and the default paged engine over HTTP at the paged
    phase's geometry: exact K1/K2/K5 launches, TTFT, decode rate, peak;
    then each greedy row teacher-forced on the kernel route and on
    impl="plain" (logits and routing decisions compared).  Returns the
    HTTP run's launch counts."""
    from kubeflow_tpu_torch.models.quantize import quantized_bytes
    from kubeflow_tpu_torch.models.serve import load_service

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    service = load_service(MOE_MODEL, device="cuda", seed=SEED,
                           n_layers=MOE_SERVE_LAYERS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model = service.model
    cfg = model.cfg
    import numpy as np

    rs = np.random.RandomState(SEED + 50)
    bodies = {name: {"tokens": [rs.randint(0, cfg.vocab_size,
                                           size=m).tolist() for m in lens],
                     "max_new_tokens": n, "temperature": 0.0, **kw}
              for name, (lens, n, kw) in MOE_REQUESTS.items()}
    n_params = sum(p.numel() for p in model.parameters())
    row = {"phase": "moe_serve", "model": MOE_MODEL,
           "n_layers": cfg.n_layers, "reduced": "n_layers 32 -> "
           f"{cfg.n_layers}: 32 layers do not fit one 80 GB card",
           "parameters": n_params, "weight_bytes": quantized_bytes(model),
           "load_seconds": load_s, "lanes": POOL_SLOTS,
           "slot_len": POOL_SLOT_LEN, "page_len": PAGED_PAGE_LEN,
           "pages": PAGED_PAGES, "prefill_chunk": PAGED_CHUNK,
           "pool_bytes": paged_pool_bytes(cfg, PAGED_PAGES),
           "requests": {k: {"prompt_lens": list(v[0]),
                            "max_new_tokens": v[1], **v[2]}
                        for k, v in MOE_REQUESTS.items()}}
    knobs = {"KFT_SERVE_SLOTS": str(POOL_SLOTS),
             "KFT_SERVE_SLOT_LEN": str(POOL_SLOT_LEN),
             "KFT_SERVE_DECODE_QUANTUM": str(POOL_QUANTUM)}
    with env_set(knobs):
        server, thread, base = http_server(service, MOE_MODEL)
        try:
            out, run = paged_http_run(torch, service, base, bodies,
                                      "moe_serve")
            _, debug = http(base, "/debug/serve")
        finally:
            stop_server(service, server, thread)
    if debug["engine"] != "PagedDecodeScheduler" or debug["quantize"]:
        raise AssertionError(f"moe_serve: /debug/serve {debug}")
    row["http"] = run
    row["heads"] = {name: out[name][0][:8] for name in bodies}
    # Teacher-forced: the kernel route against impl="plain" on the card.
    tf = {}
    for name, body in bodies.items():
        if body["temperature"] != 0.0:
            continue
        with recorded_routing(model) as kern_routes:
            lk = teacher_forced_logits(torch, dev, model, body, out[name])
        with impl_route(model, "plain"), recorded_routing(
                model) as plain_routes:
            lp = teacher_forced_logits(torch, dev, model, body, out[name])
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"moe_serve {name}: non-finite logits")
        same = total = 0
        for lk_routes, lp_routes in zip(kern_routes, plain_routes):
            for (ek, kk), (ep, kp) in zip(lk_routes, lp_routes):
                eq = ((ek == ep) & (kk == kp)).all(-1)
                same += int(eq.sum())
                total += eq.numel()
        tf[name] = {"positions": lk.shape[0],
                    "logits_max_abs_diff": (lk - lp).abs().max().item(),
                    "logits_rel_l2": ((lk - lp).norm() / lp.norm()).item(),
                    "argmax_agreement": (lk.argmax(-1) == lp.argmax(-1))
                    .float().mean().item(),
                    "routing_agreement": same / total,
                    "token_layer_decisions": total}
    row["teacher_forced_kernel_vs_plain"] = tf
    emit(row)
    del service, model
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"]


def phase_moe_train(torch, dev):
    """mixtral_8x7b at full width, MOE_TRAIN_LAYERS layer(s), f32 masters:
    MOE_TRAIN_STEPS steps of ``make_lm_train_step(aux_loss_weight=...)``
    with bf16 gradients on one b1 batch: loss and aux finite, the loss
    falling, exact launches per step, step seconds and peak memory.
    Returns the run's launch counts."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.train.steps import (
        TrainState,
        adamw,
        make_lm_train_step,
    )

    gc.collect()
    torch.cuda.empty_cache()
    model = create_model(MOE_MODEL, device=dev, n_layers=MOE_TRAIN_LAYERS,
                         max_seq_len=MOE_TRAIN_SEQ, param_dtype=torch.float32)
    with torch.no_grad():
        model.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    model.requires_grad_(True)
    cfg = model.cfg
    state = TrainState(model, adamw(model.parameters(), MOE_TRAIN_LR))
    step = make_lm_train_step(aux_loss_weight=MOE_AUX_WEIGHT,
                              grad_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_TRAIN_SEQ),
                           generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, auxes, secs = [], [], []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        auxes.append(metrics["moe_aux_loss"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * MOE_TRAIN_STEPS
            for k, n in train_launches_per_step(cfg).items()}
    if counts != want:
        raise AssertionError(f"moe_train launch counts {counts}, expected "
                             f"{want}")
    if not all(math.isfinite(v) for v in losses + auxes) or not (
            losses[-1] < losses[0]):
        raise AssertionError(f"moe_train losses {losses}, aux {auxes}")
    emit({"phase": "moe_train", "model": MOE_MODEL, "n_layers": cfg.n_layers,
          "reduced": f"n_layers 32 -> {cfg.n_layers}",
          "parameters": sum(p.numel() for p in model.parameters()),
          "batch": 1, "seq": MOE_TRAIN_SEQ, "grad_dtype": "bf16",
          "aux_loss_weight": MOE_AUX_WEIGHT, "lr": MOE_TRAIN_LR,
          "losses": losses, "moe_aux_losses": auxes, "step_seconds": secs,
          "median_step_seconds": statistics.median(secs[1:]),
          "tokens_per_sec": MOE_TRAIN_SEQ / statistics.median(secs[1:]),
          "max_memory_allocated_bytes": peak, "launches": counts,
          "launches_per_step": train_launches_per_step(cfg)})
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def vit_train_flops_per_image(cfg) -> float:
    """Model FLOPs of one ViT train step per image, the reference bench's
    accounting (``bench.py`` ``vit_train_flops_per_image``): 2 M N K over
    the patch embedding, q/k/v/o, attention and the MLP, times 3 for the
    backward; norms, softmax and elementwise ops left out."""
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    s = n_patches + 1
    d = cfg.dim
    patch_embed = 2 * n_patches * d * (cfg.patch_size ** 2 * 3)
    per_layer = (4 * 2 * s * d * d + 2 * 2 * s * s * d
                 + 2 * 2 * s * d * cfg.mlp_dim)
    head = 2 * d * cfg.num_classes
    return 3.0 * (patch_embed + cfg.n_layers * per_layer + head)


def encoder_launches(n_layers, steps, forwards=0):
    """Launches of ``steps`` training steps and ``forwards`` no-grad
    forwards of an encoder: one attention a layer, K2-lse with K3 and K4
    when training, K2 alone otherwise; no norm kernel (LayerNorm)."""
    zero = {k: 0 for k in SOURCES}
    zero.update({"flash_attention_fwd_lse": n_layers * steps,
                 "flash_attention_dq": n_layers * steps,
                 "flash_attention_dkv": n_layers * steps,
                 "flash_attention_fwd": n_layers * forwards})
    return zero


def phase_encoder_kernels(torch, dev, timer):
    """K2-lse, K3 and K4 at ViT-B/16's and BERT-base's attention shapes
    (non-causal, h12 over 12 kv heads, d64), each against its plain
    version in f32 and timed beside its bound and SDPA."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows = {}
    for name, (b, s) in ENCODER_ATTENTION.items():
        rows[name] = attention_rows(torch, dev, gen, timer, name, b, s, 12,
                                    12, 64, causal=False, packed=False,
                                    path=name.split("_")[0])
    return rows


def classifier_state(torch, dev, name, optimizer, **overrides):
    """A train state as the trainer builds one: the model on the card,
    f32 masters (and stats) drawn from SEED, ``optimizer`` over them."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.train.steps import TrainState

    model = create_model(name, device=dev, **overrides)
    with torch.no_grad():
        model.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    model.requires_grad_(True)
    return TrainState(model, optimizer(model.parameters()))


def timed_steps(torch, step, state, batch, n):
    """``n`` steps on one batch, each closed by reading its loss (which
    waits for the card); returns the state, losses, accuracies and
    seconds."""
    losses, accs, secs = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        secs.append(time.perf_counter() - t0)
        accs.append(m["accuracy"].item())
    return state, losses, accs, secs


def profiled_steps(torch, step, state, batch, n, logdir):
    """``n`` steps recorded by the port's ``profile_trace``; returns the
    wall seconds and ``trace_summary`` of the trace."""
    from kubeflow_tpu_torch.train import profiling

    torch.cuda.synchronize()
    with profiling.profile_trace(logdir):
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = profiling.trace_summary(logdir)
    if summary["total_ms"] <= 0:
        raise AssertionError(f"profile under {logdir}: no device time")
    return {"steps": n, "wall_seconds": wall,
            "device_kernel_ms_per_step": summary["total_ms"] / n,
            "device_busy_share": summary["total_ms"] / 1e3 / wall,
            "kernels_per_step": summary["kernels"] / n,
            "ms_per_step_by_class": {c: r["ms"] / n for c, r in
                                     summary["classes"].items()},
            "top_kernels_per_step": [dict(k, ms=k["ms"] / n,
                                          count=k["count"] / n)
                                     for k in summary["top"]],
            "profiler_flops_per_step": (summary["flops"] or 0) / n}


def check_losses(what, losses):
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: losses {losses}")


def phase_resnet(torch, dev):
    """ResNet-50 trained as the reference bench trains it: ENCODER_STEPS
    steps on one b256 batch with the counts at 0 (no kernel of the port
    runs on this path), an eval forward, then profiled steps.  Returns the
    counts and the state for the slow-step phase."""
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.train.steps import (
        make_classification_train_step,
        sgd,
    )

    state = classifier_state(
        torch, dev, RESNET_MODEL,
        lambda p: sgd(p, 0.1, momentum=0.9, nesterov=True), num_classes=1000)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    batch = (torch.randn(RESNET_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3,
                         generator=gen, device=dev),
             torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                           device=dev, dtype=torch.int32))
    step = make_classification_train_step(has_batch_stats=True)
    n_stats = len(state.batch_stats)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, losses, accs, secs = timed_steps(torch, step, state, batch,
                                            ENCODER_STEPS)
    with torch.no_grad():
        logits = state.module(batch[0], train=False)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_losses("resnet", losses)
    if tuple(logits.shape) != (RESNET_BATCH, 1000) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"resnet eval logits {tuple(logits.shape)}")
    if any(counts.values()):
        raise AssertionError(f"resnet launched port kernels: {counts}")
    stats_moved = all(not torch.equal(t, torch.zeros_like(t))
                      for k, t in state.batch_stats.items()
                      if k.endswith(".mean"))
    if not stats_moved:
        raise AssertionError("resnet: a running mean stayed at zero")
    step_s = statistics.median(secs[1:])
    prof = profiled_steps(torch, step, state, batch, ENCODER_PROFILED,
                          os.path.join(checkpoint_root(), "profile-resnet"))
    emit({"phase": "resnet", "model": RESNET_MODEL,
          "batch": [RESNET_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3],
          "parameters": sum(p.numel() for p in state.module.parameters()),
          "batch_stat_tensors": n_stats, "losses": losses,
          "accuracy": accs, "step_seconds": secs,
          "median_step_seconds_2_on": step_s,
          "images_per_sec": RESNET_BATCH / step_s,
          "max_memory_allocated_bytes": peak, "launches": counts,
          "profiled": prof})
    return counts, state, step, batch


def phase_batch_stats(torch, state, batch):
    """BatchNorm's global-statistics branch over BN_DATA_RANKS virtual
    data ranks, at resnet50's widths and compute dtype: one training
    forward of the resnet phase's model on its b256 batch, and at each
    norm its input split into the ranks' rows.

    - The ranks' per-channel count, sum and sum of squares
      (``layers.batch_sums``) added in rank order and finished
      (``batch_moments``): the mean and biased variance within
      BN_MERGE_TOL (relative L2) of the whole batch's
      (``torch.var_mean``).
    - Each rank runs a copy of the norm under a ``VirtualMesh`` of
      BN_DATA_RANKS data ranks, so ``BatchNorm.forward`` takes its mesh
      branch.  The all-reduce over the data axes (``sharding.sum_over``)
      is replaced for the phase by the rank-order sum of every rank's
      ``batch_sums``, each computed from that rank's rows in one graph, so
      one backward of the ranks' summed objective (a seeded upstream
      gradient) gives each rank the all-reduced gradient of the sums.
      Every rank's running stats must be bit-equal to rank 0's and within
      BN_MERGE_TOL of the whole batch's norm in one process
      (``F.batch_norm``).  The ranks' joined outputs, their input
      gradient and their summed gradients of scale and bias must be no
      farther from the same norm in f32 than COMPOSE_RATIO times the
      one-process norm's distance, or than BN_F32_FLOOR for what both
      compute in f32.

    The model's running stats are put back after."""
    from kubeflow_tpu_torch.models.layers import (
        BatchNorm,
        batch_moments,
        batch_sums,
    )
    from kubeflow_tpu_torch.parallel import sharding
    from kubeflow_tpu_torch.parallel.context import global_mesh

    t0 = time.perf_counter()
    saved = {k: t.clone() for k, t in state.batch_stats.items()}
    worst = {"mean": 0.0, "var": 0.0, "running": 0.0}
    ratio = {"y": 0.0, "dx": 0.0, "dscale": 0.0, "dbias": 0.0}
    seen, unequal = [], []
    gen = torch.Generator(device=batch[0].device).manual_seed(SEED + 11)
    real_sum_over = sharding.sum_over

    def norm_copy(mod, dtype):
        out = BatchNorm(mod.scale.shape[0], dtype=dtype,
                        device=mod.scale.device)
        out.load_state_dict(mod.state_dict())
        return out.requires_grad_(True)

    def grads(mod, x, y, g):
        (y.float() * g).sum().backward()
        return x.grad, mod.scale.grad, mod.bias.grad

    class RankSum(torch.autograd.Function):
        """The all-reduce over the virtual data axis: forward, the
        rank-order sum of every rank's sums (this rank's own, the others'
        as ``held``); backward, every rank's cotangent summed in rank order
        (``cotangents``, read by a first pass)."""

        @staticmethod
        def forward(ctx, own, r, held):
            parts = [own if i == r else t for i, t in enumerate(held)]
            return sum(parts[1:], parts[0])

        @staticmethod
        def backward(ctx, g):
            return sum(cotangents[1:], cotangents[0]), None, None

    cotangents = []

    def virtual_ranks(mod, x, g):
        """The ranks' norms on their rows, summed over the virtual data
        axis by the harness; their outputs joined, gradients summed."""
        xs = [part.detach().clone().requires_grad_(True)
              for part in x.chunk(BN_DATA_RANKS)]
        held = [batch_sums(part).detach() for part in xs]
        norms = [norm_copy(mod, mod.dtype) for _ in xs]
        ys, sums = [], []
        for r, (norm, part) in enumerate(zip(norms, xs)):
            def summed(own, groups, r=r):
                if not groups or not all(isinstance(
                        grp, sharding.VirtualGroup) for grp in groups):
                    raise AssertionError(f"batch_stats: groups {groups}")
                sums.append(RankSum.apply(own, r, held))
                return sums[-1]

            sharding.sum_over = summed
            try:
                with global_mesh(VirtualMesh(1, 0, dp=BN_DATA_RANKS,
                                             dp_rank=r)):
                    ys.append(norm(part, train=True))
            finally:
                sharding.sum_over = real_sum_over
        loss = sum((y.float() * gr).sum() for y, gr in zip(
            ys, g.chunk(BN_DATA_RANKS)))
        cotangents[:] = torch.autograd.grad(loss, sums, retain_graph=True)
        loss.backward()
        y = torch.cat([t.detach() for t in ys])
        dx = torch.cat([t.grad for t in xs])
        dscale = sum((n.scale.grad for n in norms[1:]), norms[0].scale.grad)
        dbias = sum((n.bias.grad for n in norms[1:]), norms[0].bias.grad)
        return y, dx, dscale, dbias, norms

    def hook(mod, args):
        x = args[0]
        merged = sum(batch_sums(part) for part in x.chunk(BN_DATA_RANKS))
        mean, var = batch_moments(merged)
        want_var, want_mean = torch.var_mean(
            x.float(), dim=(0, 2, 3), correction=0)
        for key, got, want in (("mean", mean, want_mean),
                               ("var", var, want_var)):
            scale = max(want.norm().item(), 1e-3 * math.sqrt(want.numel()))
            worst[key] = max(worst[key], (got - want).norm().item() / scale)
        with torch.enable_grad():
            g = torch.randn(x.shape, generator=gen, device=x.device,
                            dtype=torch.float32).to(mod.dtype).float()
            out = {}
            for key, dtype in (("f32", torch.float32), ("one", mod.dtype)):
                norm = norm_copy(mod, dtype)
                xi = x.detach().to(dtype).requires_grad_(True)
                y = norm(xi, train=True)
                out[key] = (y.detach(),) + grads(norm, xi, y, g) + (norm,)
            *mesh_out, norms = virtual_ranks(mod, x, g)
        one = out["one"][-1]
        for r, norm in enumerate(norms):
            for buf in ("mean", "var"):
                got, want = getattr(norm, buf), getattr(one, buf)
                if not torch.equal(got, getattr(norms[0], buf)):
                    unequal.append((len(seen), r, buf))
                worst["running"] = max(worst["running"], rel_l2(got, want))
        for i, key in enumerate(ratio):
            e_f32 = out["f32"][i].float()
            e_one = rel_l2(out["one"][i], e_f32)
            e_mesh = rel_l2(mesh_out[i], e_f32)
            ratio[key] = max(ratio[key], e_mesh / max(e_one, BN_F32_FLOOR))
        seen.append(x.shape[1])

    handles = [m.register_forward_pre_hook(hook)
               for m in state.module.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            state.module(batch[0], train=True)
    finally:
        for h in handles:
            h.remove()
        sharding.sum_over = real_sum_over
        with torch.no_grad():
            for k, t in state.batch_stats.items():
                t.copy_(saved[k])
    row = {"phase": "batch_stats", "model": RESNET_MODEL,
           "batch": RESNET_BATCH, "data_ranks": BN_DATA_RANKS,
           "rows_per_rank": RESNET_BATCH // BN_DATA_RANKS,
           "norms": len(seen), "rel_l2_worst": worst, "tol": BN_MERGE_TOL,
           "f32_distance_ratio_worst": ratio, "ratio_limit": COMPOSE_RATIO,
           "f32_floor": BN_F32_FLOOR, "running_unequal": unequal,
           "phase_seconds": time.perf_counter() - t0}
    emit(row)
    if len(seen) != len(handles) or max(worst.values()) > BN_MERGE_TOL \
            or max(ratio.values()) > COMPOSE_RATIO or unequal:
        raise AssertionError(f"batch_stats: {row}")


def phase_slow_step(torch, state, step, batch):
    """The loop's slow-step hooks on the ResNet-50 state: the first batch
    arrives SLOW_STALL_SECONDS late with TRAIN_SLOW_STEP_SECONDS at
    SLOW_STEP_SECONDS and KFT_SLOW_STEP_PROFILE_DIR set.  The counter must
    read 1, the slow step's span tree must show the stall in its data
    span, the next step must be the profiled one, and ``trace_summary``
    must read conv and GEMM time from the trace it wrote."""
    from kubeflow_tpu_torch.telemetry import compute as ctel
    from kubeflow_tpu_torch.train import profiling
    from kubeflow_tpu_torch.train.loop import LoopConfig, train_loop

    logdir = os.path.join(checkpoint_root(), "slow-step")
    shutil.rmtree(logdir, ignore_errors=True)

    def batches():
        time.sleep(SLOW_STALL_SECONDS)
        yield batch
        while True:
            yield batch

    counter = ctel.train_slow_steps_total._only()
    before = counter.value
    saved = (ctel.TRAIN_SLOW_STEP_SECONDS,
             os.environ.get("KFT_SLOW_STEP_PROFILE_DIR"))
    ctel.TRAIN_SLOW_STEP_SECONDS = SLOW_STEP_SECONDS
    os.environ["KFT_SLOW_STEP_PROFILE_DIR"] = logdir
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            state, history = train_loop(
                state, step, batches(), LoopConfig(total_steps=3,
                                                   log_every=1))
    finally:
        ctel.TRAIN_SLOW_STEP_SECONDS = saved[0]
        if saved[1] is None:
            os.environ.pop("KFT_SLOW_STEP_PROFILE_DIR", None)
        else:
            os.environ["KFT_SLOW_STEP_PROFILE_DIR"] = saved[1]
    slow = counter.value - before
    traces = ctel.train_tracer.recent(3)
    spans = [{sp["name"]: sp["duration_ms"] for sp in t["spans"]}
             for t in traces]
    files = sorted(os.listdir(logdir)) if os.path.isdir(logdir) else []
    summary = profiling.trace_summary(logdir) if files else None
    emit({"phase": "slow-step", "threshold_seconds": SLOW_STEP_SECONDS,
          "stall_seconds": SLOW_STALL_SECONDS, "slow_steps": slow,
          "trace_spans_ms": spans, "trace_files": files,
          "losses": [h["loss"] for h in history],
          "trace_summary": summary})
    if slow != 1:
        raise AssertionError(f"slow-step counter moved by {slow}, not 1")
    if sum(f.endswith(profiling.TRACE_SUFFIX) for f in files) != 1 \
            or summary is None:
        raise AssertionError(f"slow-step traces under {logdir}: {files}")
    if spans[0].get("data", 0.0) < SLOW_STALL_SECONDS * 1e3 or \
            "profile" not in spans[1] or "profile" in spans[2]:
        raise AssertionError(f"slow-step spans {spans}")
    for cls in ("conv", "gemm"):
        if summary["classes"][cls]["ms"] <= 0:
            raise AssertionError(f"slow-step trace: no {cls} time")
    shutil.rmtree(logdir, ignore_errors=True)
    return slow


def encoder_compose(torch, dev, name, batch):
    """The kernel route against impl="plain" on one step's loss and
    gradients, ``name`` at full width and ENCODER_COMPOSE_LAYERS layers,
    the same f32 masters three ways: kernel and plain routes computing in
    bf16, and an f32 plain model as the reference.  The kernel route's
    gradients (all of them, as one vector) may be no farther from the f32
    model's than COMPOSE_RATIO times the plain route's, and both losses
    within 1e-2 of its."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.train.steps import (
        TrainState,
        make_classification_grad_fn,
    )

    bf = torch.bfloat16
    variants = {"kernel": dict(impl="auto", dtype=bf),
                "plain": dict(impl="plain", dtype=bf),
                "f32": dict(impl="plain", dtype=torch.float32)}
    overrides = dict(n_layers=ENCODER_COMPOSE_LAYERS)
    if name == BERT_MODEL:
        overrides["num_classes"] = BERT_CLASSES
    state, grads, losses = None, {}, {}
    for variant, kw in variants.items():
        model = create_model(name, device=dev, **overrides, **kw)
        if state is None:
            with torch.no_grad():
                model.reset_parameters(
                    torch.Generator(device=dev).manual_seed(SEED))
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        g, m = make_classification_grad_fn(has_batch_stats=False)(
            TrainState(model, None), batch)
        grads[variant] = torch.cat([t.float().flatten() for t in g.values()])
        losses[variant] = m["loss"].item()
        del model, g
        torch.cuda.empty_cache()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    e_k, e_p = rel(grads["kernel"], grads["f32"]), rel(grads["plain"],
                                                       grads["f32"])
    row = {"phase": f"{name.split('_')[0]}-compose", "model": name,
           "n_layers": ENCODER_COMPOSE_LAYERS, "loss": losses,
           "all_grads_rel_l2_kernel_vs_f32": e_k,
           "all_grads_rel_l2_plain_vs_f32": e_p,
           "ratio": e_k / e_p, "ratio_limit": COMPOSE_RATIO}
    emit(row)
    for v in ("kernel", "plain"):
        if not math.isfinite(losses[v]) or abs(
                losses[v] - losses["f32"]) > 1e-2 * abs(losses["f32"]):
            raise AssertionError(f"{name} compose loss {losses}")
    if not math.isfinite(e_k) or e_k / e_p > COMPOSE_RATIO:
        raise AssertionError(f"{name} compose: kernel route {e_k} against "
                             f"plain {e_p} from f32")


def phase_vit(torch, dev):
    """ViT-B/16 trained as the reference bench trains it (b64, bf16,
    AdamW 3e-4) for ENCODER_STEPS steps and one eval forward with the
    counts at 0 (exact launches), images/s, model TFLOP/s and MFU by the
    bench's accounting, profiled steps, then the kernel route against
    plain at 2 layers."""
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.train.steps import (
        adamw,
        make_classification_train_step,
    )

    state = classifier_state(torch, dev, VIT_MODEL,
                             lambda p: adamw(p, 3e-4))
    cfg = state.module.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    batch = (torch.randn(VIT_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3,
                         generator=gen, device=dev),
             torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=gen,
                           device=dev, dtype=torch.int32))
    step = make_classification_train_step(has_batch_stats=False)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, losses, accs, secs = timed_steps(torch, step, state, batch,
                                            ENCODER_STEPS)
    with torch.no_grad():
        logits = state.module(batch[0], train=False)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_losses("vit", losses)
    want = encoder_launches(cfg.n_layers, ENCODER_STEPS, forwards=1)
    if counts != want:
        raise AssertionError(f"vit launch counts {counts}, expected {want}")
    if not torch.isfinite(logits).all():
        raise AssertionError("vit eval logits not finite")
    step_s = statistics.median(secs[1:])
    fpi = vit_train_flops_per_image(cfg)
    tflops = VIT_BATCH / step_s * fpi / 1e12
    prof = profiled_steps(torch, step, state, batch, ENCODER_PROFILED,
                          os.path.join(checkpoint_root(), "profile-vit"))
    emit({"phase": "vit", "model": VIT_MODEL,
          "batch": [VIT_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3],
          "seq": cfg.num_patches + 1,
          "parameters": sum(p.numel() for p in state.module.parameters()),
          "losses": losses, "accuracy": accs, "step_seconds": secs,
          "median_step_seconds_2_on": step_s,
          "images_per_sec": VIT_BATCH / step_s,
          "flops_per_image": fpi, "model_tflops_per_sec": tflops,
          "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
          "max_memory_allocated_bytes": peak, "launches": counts,
          "launches_per_step": encoder_launches(cfg.n_layers, 1),
          "profiled": prof})
    del state, logits
    gc.collect()
    torch.cuda.empty_cache()
    encoder_compose(torch, dev, VIT_MODEL, batch)
    return counts


def phase_bert(torch, dev):
    """BERT-base fine-tuning shape (b32 s128, 2 classes, AdamW 3e-4):
    ENCODER_STEPS steps and one unmasked eval forward with the counts at
    0 (exact launches); a padded ``attention_mask`` forward runs the plain
    route (no launch); an all-ones mask agrees with no mask within K2's
    tolerance; then the kernel route against plain at 2 layers."""
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.train.steps import (
        adamw,
        make_classification_train_step,
    )

    state = classifier_state(torch, dev, BERT_MODEL,
                             lambda p: adamw(p, 3e-4),
                             num_classes=BERT_CLASSES)
    cfg, model = state.module.cfg, state.module
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    tokens = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    batch = (tokens, torch.randint(0, BERT_CLASSES, (BERT_BATCH,),
                                   generator=gen, device=dev,
                                   dtype=torch.int32))
    step = make_classification_train_step(has_batch_stats=False)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, losses, accs, secs = timed_steps(torch, step, state, batch,
                                            ENCODER_STEPS)
    with torch.no_grad():
        free = model(tokens, train=False)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_losses("bert", losses)
    want = encoder_launches(cfg.n_layers, ENCODER_STEPS, forwards=1)
    if counts != want:
        raise AssertionError(f"bert launch counts {counts}, expected {want}")
    # Masked forwards: the plain route, no kernel launched.
    lengths = torch.randint(BERT_SEQ // 4, BERT_SEQ + 1, (BERT_BATCH,),
                            generator=gen, device=dev)
    mask = (torch.arange(BERT_SEQ, device=dev)[None] < lengths[:, None])
    kernels.reset_launch_counts()
    with torch.no_grad():
        padded = model(tokens, attention_mask=mask.int(), train=False)
        ones = model(tokens, attention_mask=torch.ones_like(mask).int(),
                     train=False)
    masked_counts = kernels.launch_counts()
    if any(masked_counts.values()):
        raise AssertionError(f"masked bert launched {masked_counts}")
    if not torch.isfinite(padded).all():
        raise AssertionError("masked bert logits not finite")
    err = check_rel_l2("bert all-ones mask against no mask", free, ones,
                       KERNEL_TOL["flash_attention_fwd"])
    step_s = statistics.median(secs[1:])
    emit({"phase": "bert", "model": BERT_MODEL,
          "batch": [BERT_BATCH, BERT_SEQ], "classes": BERT_CLASSES,
          "parameters": sum(p.numel() for p in model.parameters()),
          "losses": losses, "accuracy": accs, "step_seconds": secs,
          "median_step_seconds_2_on": step_s,
          "sequences_per_sec": BERT_BATCH / step_s,
          "max_memory_allocated_bytes": peak, "launches": counts,
          "launches_per_step": encoder_launches(cfg.n_layers, 1),
          "masked_launches": masked_counts,
          "ones_mask_vs_kernel": {"rel_l2": err[0], "tol_share": err[1],
                                  "max_abs_err": err[2]},
          "padded_rows": int((lengths < BERT_SEQ).sum().item())})
    del state, model, free, padded, ones
    gc.collect()
    torch.cuda.empty_cache()
    encoder_compose(torch, dev, BERT_MODEL, batch)
    return counts


def phase_image_cli(torch):
    """``train.run --task image --model resnet50`` with ``--checkpoint-dir``
    (counts at 0 around it: no port kernel on this path), then a run
    stopped at IMAGE_CLI_STOP steps and resumed to IMAGE_CLI_STEPS in
    another directory: the two final checkpoints (weights, batch stats,
    momentum) within RESUME_TOL, under cuDNN's deterministic algorithms."""
    from kubeflow_tpu_torch.ops import cuda as kernels

    root = os.path.join(checkpoint_root(), "image-cli")
    shutil.rmtree(root, ignore_errors=True)
    unbroken, broken = os.path.join(root, "unbroken"), os.path.join(
        root, "broken")
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        steps_a, done = run_trainer(IMAGE_CLI_ARGS + [
            "--steps", str(IMAGE_CLI_STEPS), "--checkpoint-dir", unbroken])
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        steps_b, _ = run_trainer(IMAGE_CLI_ARGS + [
            "--steps", str(IMAGE_CLI_STOP), "--checkpoint-dir", broken])
        steps_c, _ = run_trainer(IMAGE_CLI_ARGS + [
            "--steps", str(IMAGE_CLI_STEPS), "--checkpoint-dir", broken])
        mesh = image_mesh_run(torch, [s["loss"] for s in steps_a])
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    if any(counts.values()):
        raise AssertionError(f"image CLI launched port kernels: {counts}")
    if [s["step"] for s in steps_a] != list(range(1, IMAGE_CLI_STEPS + 1)) \
            or [s["step"] for s in steps_c] != list(
                range(IMAGE_CLI_STOP + 1, IMAGE_CLI_STEPS + 1)):
        raise AssertionError(f"image CLI steps {steps_a} / {steps_c}")
    check_losses("image CLI", [s["loss"] for s in steps_a + steps_b
                               + steps_c])
    load = lambda d, f: torch.load(
        os.path.join(d, str(IMAGE_CLI_STEPS), f), map_location="cpu",
        weights_only=True)
    pa, pb = load(unbroken, "params.pt"), load(broken, "params.pt")
    oa, ob = load(unbroken, "optimizer.pt"), load(broken, "optimizer.pt")
    stats = sorted(k for k in pa if k.endswith((".mean", ".var")))
    weights = sorted(k for k in pa if k not in stats)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    cat = lambda d, keys: torch.cat([d[k].float().flatten() for k in keys])
    moms = sorted(oa["state"])
    mom = lambda o: torch.cat([o["state"][k]["momentum_buffer"].flatten()
                               for k in moms])
    diffs = {"weights": rel(cat(pb, weights), cat(pa, weights)),
             "momentum": rel(mom(ob), mom(oa)),
             "worst_stat": max(rel(pb[k], pa[k]) for k in stats)}
    bit_equal = all(torch.equal(pa[k], pb[k]) for k in pa)
    emit({"phase": "image-cli", "args": IMAGE_CLI_ARGS,
          "steps": IMAGE_CLI_STEPS, "stop_at": IMAGE_CLI_STOP,
          "unbroken_losses": [s["loss"] for s in steps_a],
          "resumed_losses": [s["loss"] for s in steps_b + steps_c],
          "step_seconds": [s["step_seconds"] for s in steps_a],
          "wall_seconds": wall, "batch_stat_tensors": len(stats),
          "rel_l2": diffs, "tol": RESUME_TOL, "bit_equal": bit_equal,
          "launches": counts, "done": done, "mesh": mesh})
    if set(pa) != set(pb) or not stats or max(diffs.values()) > RESUME_TOL:
        raise AssertionError(f"image CLI resume differs: {diffs}")
    shutil.rmtree(root, ignore_errors=True)
    return counts


def image_mesh_run(torch, losses):
    """``train.run --task image --model resnet50 --distributed --mesh
    dp=1``: the process group from torchrun's env at world size 1 over
    NCCL, the state sharded by ``resnet_rules`` and trained by the
    sharded step with the batch-statistics path, IMAGE_MESH_STEPS steps
    (the counts at 0: no port kernel); its losses held to the unbroken
    image-cli run's ``losses`` step by step (MESH_LOSS_TOL and one unit
    of the printed sixth digit, as the mesh phase).  The group is gone
    after it."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.ops import cuda as kernels

    argv = IMAGE_CLI_ARGS + ["--steps", str(IMAGE_MESH_STEPS),
                             "--distributed", "--mesh", "dp=1"]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with env_set(env):
            steps, done = run_trainer(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    counts = kernels.launch_counts()
    got = [st["loss"] for st in steps]
    want = losses[:IMAGE_MESH_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    limits = [MESH_LOSS_TOL
              + 10.0 ** (math.floor(math.log10(abs(b))) - 5) / abs(b)
              for b in want]
    out = {"args": argv, "world_size": 1, "losses": got, "unbroken_losses": want, "loss_rel_diff": rel,
           "wall_seconds": time.perf_counter() - t0, "launches": counts,
           "group_destroyed": not dist.is_initialized(), "done": done}
    if (len(got) != IMAGE_MESH_STEPS or any(counts.values())
            or any(r > t for r, t in zip(rel, limits))):
        raise AssertionError(f"image mesh run: {out}")
    return out


def no_proxy_client(base):
    """A ``GenerateClient`` of the local server that ignores proxy
    settings (the requests never leave the host)."""
    from kubeflow_tpu_torch.models.client import GenerateClient

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    return GenerateClient(base, timeout=600, opener=lambda req, timeout:
                          opener.open(req, timeout=timeout))


def phase_t5_kernels(torch, dev, timer):
    """K1 at T5-large's rows ([2048, 1024], the encoder at b4 s512, and
    [16, 1024], a beam step at b4 x BEAMS; eps 1e-6) and K5 at the Llama
    beam step's (b2 x BEAMS rows over prompt + NEW_TOKENS slots, the
    17-token row's padding masked), each against its plain version and
    timed beside its bound and the library call."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models.t5 import CONFIGS as T5_CONFIGS
    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5
    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf = torch.bfloat16
    d = T5_CONFIGS[T5_MODEL].dim
    scale = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).float()
    for where, nrows in T5_NORM_ROWS.items():
        x = torch.randn(nrows, d, generator=gen, device=dev).to(bf)
        got = k1.rms_norm(x, scale, eps=1e-6)
        want = k1.plain_rms_norm(x.float(), scale, eps=1e-6)
        tol = KERNEL_TOL["rms_norm"]
        err, share = check_close(f"rms_norm {where}", got, want, tol)
        flops = 4 * nrows * d
        bms, by = bound_ms(nrows * d * 4 + d * 4, flops, PEAK_F32_FLOPS)
        row = {"kernel": "rms_norm", "shape": [nrows, d], "path": where,
               "max_abs_err": err, "tol": tol, "tol_share": share,
               "kernel_ms": timer(lambda: k1.rms_norm(x, scale, eps=1e-6)),
               "plain_ms": timer(lambda: k1.plain_rms_norm(x, scale,
                                                           eps=1e-6)),
               "library_ms": timer(lambda: F.rms_norm(
                   x, (d,), weight=scale.to(bf), eps=1e-6)),
               "same_bytes_ms": timer(lambda: got.copy_(x)),
               "bound_ms": bms, "bound_by": by}
        emit(add_rates(row, flops, timer.floor_ms))
    h, kvh, hd = 32, 8, 128
    lens = [n for n in BEAM_PROMPT_LENS for _ in range(BEAMS)]
    b, longest = len(lens), max(BEAM_PROMPT_LENS)
    S = longest + NEW_TOKENS
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(bf)
    k = torch.randn(b, S, kvh, hd, generator=gen, device=dev).to(bf)
    v = torch.randn(b, S, kvh, hd, generator=gen, device=dev).to(bf)
    slot = torch.arange(S, device=dev)[None]
    pad = (slot >= torch.tensor(lens, device=dev)[:, None]) & (slot < longest)
    bias = torch.where(pad, -1e30, 0.0).float().contiguous()
    got = k5.flash_decode(q, k, v, bias)
    want = k5.plain_decode(q.float(), k.float(), v.float(), bias)
    tol = KERNEL_TOL["flash_decode"]
    err, share = check_close("flash_decode beam", got, want, tol)
    needed = (~pad).sum().item()
    flops = 4 * h * hd * needed
    bms, by = bound_ms(2 * needed * kvh * hd * 2 + b * S * 4
                       + 2 * b * h * hd * 2, flops, PEAK_BF16_FLOPS)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = bias[:, None, None, :].to(bf)
    row = {"kernel": "flash_decode", "shape": [b, S, h, kvh, hd],
           "path": "beam step", "prompt_lens": list(BEAM_PROMPT_LENS),
           "beams": BEAMS, "needed_slots": needed, "max_abs_err": err,
           "tol": tol, "tol_share": share,
           "kernel_ms": timer(lambda: k5.flash_decode(q, k, v, bias)),
           "plain_ms": timer(lambda: k5.plain_decode(q, k, v, bias)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, enable_gqa=True)),
           "bound_ms": bms, "bound_by": by}
    emit(add_rates(row, flops))


def sequence_logprob(torch, logits, seqs, eos=None):
    """Sum over each row of log p(token) under teacher-forced ``logits``
    [b, T, vocab] for ``seqs`` [b, T], through the first ``eos``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok = logp.gather(-1, seqs[..., None])[..., 0]
    if eos is not None:
        before = torch.cumprod((seqs != eos).long(), dim=1)
        keep = torch.cat([torch.ones_like(before[:, :1]), before[:, :-1]],
                         dim=1)
        tok = tok * keep
    return tok.sum(dim=1).tolist()


def cached_logprob(torch, model, prompt, mask, seqs):
    """Sum over each row of log p(token) for ``seqs`` [b, T] after the
    right-padded prompt, on the generation route: one prefill, then one
    cached decode step a token (K2, then K5)."""
    from kubeflow_tpu_torch.models.generate import (
        pad_bias_rows,
        prompt_positions,
    )

    b, T = seqs.shape
    positions, lengths = prompt_positions(mask)
    pad_bias = pad_bias_rows(mask, prompt.shape[1] + T)
    with torch.inference_mode():
        cache = model.new_cache(b, prompt.shape[1] + T)
        logits = model(prompt, positions=positions, cache=cache,
                       pad_bias=pad_bias, logits_at=lengths - 1)
        total = torch.zeros(b, device=prompt.device)
        for t in range(T):
            logp = torch.log_softmax(logits.float(), dim=-1)
            total += logp.gather(-1, seqs[:, t:t + 1])[:, 0]
            if t + 1 < T:
                logits = model(seqs[:, t:t + 1],
                               positions=(lengths + t)[:, None],
                               cache=cache, pad_bias=pad_bias)[:, 0]
    return total.tolist()


def phase_beam(torch, dev, model):
    """``beam_search`` on the served bf16 llama3_8b: b2 with prompts of
    BEAM_PROMPT_LENS, BEAMS beams, NEW_TOKENS new, no EOS, length penalty
    0, twice (the first run cold, counted from 0: exact, K2 a layer at the
    prefill, K5 a layer a step over the beam-folded rows, K1 65 a forward;
    the second timed warm); beams 1 equal to ``generate``; the best beam
    rescored on the search's route no worse than 1 beam's sequence within
    BEAM_SCORE_TOL, and by one teacher-forced forward within that plus
    the routes' measured disagreement; ms a step."""
    from kubeflow_tpu_torch.models.generate import (
        beam_search,
        generate,
        generate_prefill,
    )
    from kubeflow_tpu_torch.ops import cuda as kernels

    cfg = model.cfg
    _, prompt, mask = ragged_batch(torch, dev, cfg.vocab_size,
                                   BEAM_PROMPT_LENS)
    kw = dict(prompt_mask=mask, max_new_tokens=NEW_TOKENS)
    seconds = []
    for run in range(2):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        best = beam_search(model, prompt, beams=BEAMS, length_penalty=0.0,
                           **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if run == 0:
            counts = kernels.launch_counts()
    want = {k: 0 for k in SOURCES}
    want.update(rms_norm=(2 * cfg.n_layers + 1) * NEW_TOKENS,
                flash_attention_fwd=cfg.n_layers,
                flash_decode=cfg.n_layers * (NEW_TOKENS - 1))
    if counts != want:
        raise AssertionError(f"beam launches {counts}, expected {want}")
    t0 = time.perf_counter()
    first, _ = generate_prefill(model, prompt, **kw)
    first.tolist()
    prefill_s = time.perf_counter() - t0
    greedy = generate(model, prompt, **kw)
    beam1 = beam_search(model, prompt, beams=1, **kw)
    if not torch.equal(beam1, greedy):
        raise AssertionError("beam search with 1 beam differs from greedy")
    cached, forward = {}, {}
    for name, seqs in (("beams_1", beam1), ("beams_best", best)):
        cached[name] = cached_logprob(torch, model, prompt, mask, seqs)
        forward[name] = []
        for row, n, seq in zip(prompt, BEAM_PROMPT_LENS, seqs):
            full = torch.cat([row[:n], seq])[None]
            with torch.inference_mode():
                logits = model(full)[:, n - 1:-1]
            forward[name] += sequence_logprob(torch, logits, seq[None])
    margin = [a - b for a, b in zip(cached["beams_best"], cached["beams_1"])]
    tol = BEAM_SCORE_TOL * NEW_TOKENS
    fwd_margin = [a - b for a, b in zip(forward["beams_best"],
                                        forward["beams_1"])]
    routes = [sum(abs(forward[k][r] - cached[k][r]) for k in cached)
              for r in range(len(BEAM_PROMPT_LENS))]
    emit({"phase": "beam", "model": "llama3_8b",
          "prompt_lens": list(BEAM_PROMPT_LENS), "beams": BEAMS,
          "max_new_tokens": NEW_TOKENS, "seconds_cold": seconds[0],
          "seconds_warm": seconds[1], "prefill_seconds": prefill_s,
          "ms_per_step_cold": (seconds[0] - prefill_s) / (NEW_TOKENS - 1)
          * 1e3,
          "ms_per_step_warm": (seconds[1] - prefill_s) / (NEW_TOKENS - 1)
          * 1e3,
          "launches": counts, "beams_1_equals_greedy": True,
          "rescored_cached": cached, "best_minus_beams_1_cached": margin,
          "rescored_forward": forward, "best_minus_beams_1_forward":
          fwd_margin, "route_disagreement": routes, "tol": tol,
          "best_row0_head": best[0, :8].tolist()})
    for r in range(len(BEAM_PROMPT_LENS)):
        if margin[r] < -tol or fwd_margin[r] < -tol - routes[r]:
            raise AssertionError(
                f"beam: the best of {BEAMS} beams scores {margin} (cached) "
                f"and {fwd_margin} (forward) against 1 beam's")
    return counts


def t5_launches(cfg, steps, backward=False):
    """Launches of one T5 encode and ``steps`` cached decoder steps (or,
    with ``backward``, of one teacher-forced forward and its backward):
    the encoder's norms (2 a layer and the final one) once, the
    decoder's (3 a layer and the final one) a step; every attention
    carries a bias and runs the plain version, so no K2 or K5."""
    zero = {k: 0 for k in SOURCES}
    norms = (2 * cfg.n_encoder_layers + 1
             + (3 * cfg.n_decoder_layers + 1) * steps)
    zero["rms_norm"] = norms
    if backward:
        zero["rms_norm_bwd"] = norms
    return zero


def t5_conditioned(torch, model):
    """``model`` with every attention's W_q scaled by head_dim ** -0.5, in
    place (a quantized W_q's scales): T5's own initialisation of the
    random weights (see T5_MODEL)."""
    from kubeflow_tpu_torch.models.layers import BiasedAttention

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BiasedAttention):
                q = mod.q_proj
                factor = mod.head_dim ** -0.5
                (q.weight if q.weight is not None else q.scale).mul_(factor)
    return model


def t5_teacher_forced(torch, model, src, mask, gen):
    """Logits [b, T, vocab] f32 of one forward of ``model`` over the
    sources and ``[0] + gen[:-1]`` (BOS, then the generated tokens)."""
    tgt = torch.cat([torch.zeros_like(gen[:, :1]), gen[:, :-1]], dim=1)
    with torch.inference_mode():
        return model(src, tgt, source_mask=mask).float()


def t5_profile(torch, model, src, mask, n):
    """Where a T5 request's card time goes: one ``generate_seq2seq`` call
    (no HTTP), on the host clock, then under torch.profiler with every
    attention call in a ``t5_biased_attention`` range.  Device ms by
    kernel class (K1, matrix products, the rest), and the attention
    ranges' device ms (their products included) and share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models.generate import generate_seq2seq

    run = lambda: generate_seq2seq(model, src, source_mask=mask,
                                   max_new_tokens=n).tolist()
    t0 = time.perf_counter()
    run()
    wall_s = time.perf_counter() - t0
    attention = ops.dot_product_attention

    def annotated(*args, **kwargs):
        with record_function("t5_biased_attention"):
            return attention(*args, **kwargs)

    ops.dot_product_attention = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
    finally:
        ops.dot_product_attention = attention
    classes = {"rms_norm": 0.0, "matmul": 0.0, "other": 0.0}
    attn_us, attn_calls, n_kernels, by_name = 0.0, 0, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            n_kernels += 1
            us = e.time_range.elapsed_us()
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + us, c + 1)
            name = e.name.lower()
            if "rms_norm_kernel" in name:
                classes["rms_norm"] += us
            elif any(t in name for t in ("gemm", "gemv", "cutlass", "xmma",
                                         "cublas", "nvjet")):
                classes["matmul"] += us
            else:
                classes["other"] += us
        elif e.name == "t5_biased_attention" and e.device_type != \
                DeviceType.CUDA:
            attn_us += e.device_time_total
            attn_calls += 1
    device_us = sum(classes.values())
    return {"call": "generate_seq2seq (request A, no HTTP)",
            "wall_seconds": wall_s, "device_kernel_seconds": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall_s,
            "device_kernels": n_kernels,
            "device_ms_by_class": {k: v / 1e3 for k, v in classes.items()},
            "attention_calls": attn_calls,
            "attention_device_ms": attn_us / 1e3,
            "attention_share_of_device": attn_us / device_us
            if device_us else None,
            "top_kernels": [
                {"name": name[:90], "ms": t / 1e3, "count": c}
                for name, (t, c) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][0])[:10]]}


def phase_t5_serve(torch, dev):
    """``load_service(T5_MODEL)`` (``t5_conditioned``) behind the HTTP app,
    requests through the wire client: A greedy over the T5_SOURCE_LENS rows, B one seeded
    sampled row (twice: equal), C = A (token-identical).  A's launches
    exact; its tokens teacher-forced through one forward on the kernel
    route, on impl="plain" and on an f32 model (each greedy token within
    AGREE_GAP of its position's largest logit; the kernel route within
    COMPOSE_RATIO of the plain route's distance from f32); latency,
    tokens/s, peak memory; A's card time by kernel class and the plain
    biased attention's share (``t5_profile``).  Then the int8 service:
    weight bytes and argmax agreement with bf16 on A's tokens.  Returns
    (A's launches, the service's model)."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.quantize import quantized_bytes
    from kubeflow_tpu_torch.models.serve import load_service
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.telemetry import compute as ctel

    t0 = time.perf_counter()
    service = load_service(T5_MODEL, device="cuda", seed=SEED)
    t5_conditioned(torch, service.model)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model, cfg = service.model, service.model.cfg
    toks, src, mask = ragged_batch(torch, dev, cfg.vocab_size, T5_SOURCE_LENS)
    n = T5_NEW_TOKENS
    server, thread, base = http_server(service, T5_MODEL)
    client = no_proxy_client(base)
    try:
        status, ready = http(base, "/readyz")
        if status != 200 or not ready.get("ready"):
            raise AssertionError(f"t5 /readyz: {status} {ready}")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        plain0 = ctel.attention_impl_calls("plain")
        t_a = time.perf_counter()
        res_a = client.generate(toks, max_new_tokens=n)
        t_a = time.perf_counter() - t_a
        counts = kernels.launch_counts()
        plain_calls = ctel.attention_impl_calls("plain") - plain0
        last_estimate = ctel.attention_estimate_value()
        peak = torch.cuda.max_memory_allocated()
        want = t5_launches(cfg, n)
        if not res_a.ok or counts != want:
            raise AssertionError(f"t5 request A: {res_a.status} {res_a.log}; "
                                 f"launches {counts}, expected {want}")
        sampled = dict(max_new_tokens=n, temperature=0.8, seed=7)
        res_b = client.generate([toks[1]], **sampled)
        res_b2 = client.generate([toks[1]], **sampled)
        res_c = client.generate(toks, max_new_tokens=n)
        for name, res, rows in (("A", res_a, 4), ("B", res_b, 1),
                                ("C", res_c, 4)):
            if not res.ok or len(res.tokens) != rows or any(
                    len(r) != n or not all(0 <= t < cfg.vocab_size
                                           for t in r) for r in res.tokens):
                raise AssertionError(f"t5 request {name}: {res.status} "
                                     f"{res.log} {res.tokens}")
        if res_c.tokens != res_a.tokens or res_b2.tokens != res_b.tokens:
            raise AssertionError("t5: a repeated request differs")
        _, traces = http(base, "/debug/traces?n=1")
        spans = [s["name"] for s in traces["traces"][-1]["spans"]]
        if spans != ["admit", "queue", "generate"]:
            raise AssertionError(f"t5 spans {spans}")
    finally:
        stop_server(service, server, thread)
    emit({"phase": "t5_preflight", **t5_preflight_checks(
        torch, dev, model, src, mask, plain_calls, last_estimate)})
    profiled = t5_profile(torch, model, src, mask, n)
    gen = torch.tensor(res_a.tokens, device=dev)
    keep = torch.cumprod((gen != service.default_eos_token).long(), dim=1)
    keep = torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]],
                     dim=1).bool()
    logits = {"kernel": t5_teacher_forced(torch, model, src, mask, gen)}
    state = model.state_dict()
    for name, kw in (("plain", dict(impl="plain")),
                     ("f32", dict(impl="plain", dtype=torch.float32))):
        other = create_model(T5_MODEL, device=dev, **kw)
        other.load_state_dict(state)
        logits[name] = t5_teacher_forced(torch, other.eval(), src, mask, gen)
        del other
        torch.cuda.empty_cache()
    rel = lambda a, b: ((a - b)[keep].norm() / b[keep].norm()).item()
    lk = logits["kernel"]
    gaps = (lk.amax(-1) - lk.gather(-1, gen[..., None])[..., 0])[keep]
    e_k, e_p = rel(lk, logits["f32"]), rel(logits["plain"], logits["f32"])
    row = {"phase": "t5_serve", "model": T5_MODEL,
           "layers": [cfg.n_encoder_layers, cfg.n_decoder_layers],
           "parameters": sum(p.numel() for p in model.parameters()),
           "load_seconds": load_s, "source_lens": list(T5_SOURCE_LENS),
           "max_new_tokens": n, "request_a_seconds": t_a,
           "tokens_per_s": len(T5_SOURCE_LENS) * n / t_a,
           "max_memory_allocated_bytes": peak, "launches": counts,
           "a_equals_c": True, "b_repeats": True, "profile": profiled,
           "a_row0_head": res_a.tokens[0][:8],
           "b_row0_head": res_b.tokens[0][:8],
           "teacher_forced": {
               "positions": int(keep.sum()),
               "argmax_agreement": (lk.argmax(-1) == gen)[keep].float()
               .mean().item(),
               "worst_gap": gaps.max().item(), "gap_limit": AGREE_GAP,
               "rel_l2_kernel_vs_plain": rel(lk, logits["plain"]),
               "rel_l2_kernel_vs_f32": e_k, "rel_l2_plain_vs_f32": e_p,
               "ratio_limit": COMPOSE_RATIO}}
    if not torch.isfinite(lk).all() or gaps.max().item() > AGREE_GAP:
        raise AssertionError(f"t5 teacher-forced: {row['teacher_forced']}")
    if e_k > COMPOSE_RATIO * e_p:
        raise AssertionError(f"t5: kernel route {e_k} from f32, more than "
                             f"{COMPOSE_RATIO} x the plain route's {e_p}")
    del logits["plain"], logits["f32"]
    gc.collect()
    torch.cuda.empty_cache()
    qservice = load_service(T5_MODEL, device="cuda", seed=SEED,
                            quantize="int8")
    t5_conditioned(torch, qservice.model)
    server, thread, base = http_server(qservice, T5_MODEL)
    try:
        t_q = time.perf_counter()
        res_q = no_proxy_client(base).generate(toks, max_new_tokens=n)
        t_q = time.perf_counter() - t_q
    finally:
        stop_server(qservice, server, thread)
    if not res_q.ok or len(res_q.tokens) != len(toks):
        raise AssertionError(f"t5 int8 request: {res_q.status} {res_q.log}")
    lq = t5_teacher_forced(torch, qservice.model, src, mask, gen)
    if not torch.isfinite(lq).all():
        raise AssertionError("t5 int8: non-finite logits")
    row["int8"] = {
        "weight_bytes_int8": quantized_bytes(qservice.model),
        "weight_bytes_bf16": quantized_bytes(model),
        "request_seconds": t_q,
        "argmax_agreement_with_bf16": (lq.argmax(-1) == lk.argmax(-1))[keep]
        .float().mean().item(),
        "logits_rel_l2_vs_bf16": rel(lq, lk),
        "equal_tokens_with_bf16": sum(a == b for g, w in zip(
            res_q.tokens, res_a.tokens) for a, b in zip(g, w))}
    emit(row)
    del qservice, lq, lk, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts, model


def t5_preflight_checks(torch, dev, model, src, mask, plain_calls,
                        last_estimate):
    """The attention pre-flight on T5's plain calls.  After request A the
    gauge holds its last call's footprint (the last decoder layer's
    cross-attention of the last step, 1 query over the sources); after
    the encoder alone, the footprint of the phase's largest plain call
    (the encoder's self-attention over the sources).  Request A counted
    one plain call an attention (24 encoder layers once, 2 x 24 decoder
    attentions a step).  The pre-flight's and the counter's host time a
    call is measured at the decode step's shape."""
    from kubeflow_tpu_torch.ops import attention as attn
    from kubeflow_tpu_torch.telemetry import compute as ctel

    cfg = model.cfg
    b, s = src.shape
    fp = lambda sq, sk: attn.attention_footprint_bytes(
        batch=b, heads=cfg.n_heads, q_len=sq, k_len=sk, causal=False,
        segments=False)
    want_calls = (cfg.n_encoder_layers
                  + 2 * cfg.n_decoder_layers * T5_NEW_TOKENS)
    plain0 = ctel.attention_impl_calls("plain")
    with torch.inference_mode():
        model.encode(src, mask)
    torch.cuda.synchronize()
    encoder_estimate = ctel.attention_estimate_value()
    encoder_calls = ctel.attention_impl_calls("plain") - plain0
    if (last_estimate != fp(1, s) or encoder_estimate != fp(s, s)
            or plain_calls != want_calls
            or encoder_calls != cfg.n_encoder_layers):
        raise AssertionError(
            f"t5 pre-flight: after A {last_estimate} (want {fp(1, s)}), "
            f"after the encoder {encoder_estimate} (want {fp(s, s)}); plain "
            f"calls {plain_calls} (want {want_calls}), encoder "
            f"{encoder_calls}")
    q = torch.zeros(b, 1, cfg.n_heads, cfg.head_dim, device=dev,
                    dtype=torch.bfloat16)
    k = torch.zeros(b, s, cfg.n_heads, cfg.head_dim, device=dev,
                    dtype=torch.bfloat16)
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        ctel.note_attention_impl("plain")
        attn._preflight(q, k, causal=False, segments=False)
    us = (time.perf_counter() - t0) / reps * 1e6
    return {"last_call_estimate_bytes": last_estimate,
            "largest_call_estimate_bytes": encoder_estimate,
            "plain_calls_request_a": plain_calls,
            "host_us_per_plain_call": us,
            "host_ms_per_request_a": us * plain_calls / 1e3}


def t5_cached_logprob(torch, model, src, mask, seqs, eos):
    """Sum over each row of log p(token) for ``seqs`` [b, T] through the
    first ``eos``, on the generation route: one encode, then one cached
    decoder step a token from BOS."""
    b, T = seqs.shape
    with torch.inference_mode():
        encoded = model.encode(src, mask)
        cache = model.new_cache(b, T)
        token = torch.zeros_like(seqs[:, :1])
        total = torch.zeros(b, device=src.device)
        alive = torch.ones(b, dtype=torch.bool, device=src.device)
        for t in range(T):
            logits = model.decode(encoded, token, source_mask=mask,
                                  cache=cache)[:, -1]
            logp = torch.log_softmax(logits.float(), dim=-1)
            total += torch.where(alive, logp.gather(
                -1, seqs[:, t:t + 1])[:, 0], 0.0)
            alive &= seqs[:, t] != eos
            token = seqs[:, t:t + 1]
    return total.tolist()


def phase_t5_beam(torch, dev, model):
    """``beam_search_seq2seq`` on the served T5 at b4 (T5_SOURCE_LENS),
    BEAMS beams, T5_BEAM_NEW_TOKENS new, length penalty 0, twice (cold and
    counted, then warm): exact launches (one encode, a decoder step over
    b x BEAMS rows each step), beams 1 bit-equal to greedy
    ``generate_seq2seq``, rows past EOS hold EOS, the best beam rescored
    no worse than greedy's (as ``phase_beam``); ms a step."""
    from kubeflow_tpu_torch.models.generate import (
        beam_search_seq2seq,
        generate_seq2seq,
    )
    from kubeflow_tpu_torch.ops import cuda as kernels

    cfg, n, eos = model.cfg, T5_BEAM_NEW_TOKENS, 1
    _, src, mask = ragged_batch(torch, dev, cfg.vocab_size, T5_SOURCE_LENS)
    kw = dict(source_mask=mask, max_new_tokens=n)
    seconds = []
    for run in range(2):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        best = beam_search_seq2seq(model, src, beams=BEAMS, eos_token=eos,
                                   length_penalty=0.0, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if run == 0:
            counts = kernels.launch_counts()
    want = t5_launches(cfg, n)
    if counts != want:
        raise AssertionError(f"t5 beam launches {counts}, expected {want}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        model.encode(src, mask).sum().item()
    encode_s = time.perf_counter() - t0
    greedy = generate_seq2seq(model, src, eos_token=eos, **kw)
    beam1 = beam_search_seq2seq(model, src, beams=1, eos_token=eos, **kw)
    if not torch.equal(beam1, greedy):
        raise AssertionError("t5 beam search with 1 beam differs from greedy")
    for name, seqs in (("best", best), ("greedy", greedy)):
        for r in seqs.tolist():
            if eos in r and any(t != eos for t in r[r.index(eos):]):
                raise AssertionError(f"t5 {name}: a row leaves EOS: {r}")
    seqs = {"greedy": greedy, "beams_best": best}
    cached = {k: t5_cached_logprob(torch, model, src, mask, v, eos)
              for k, v in seqs.items()}
    forward = {k: sequence_logprob(torch, t5_teacher_forced(
        torch, model, src, mask, v), v, eos) for k, v in seqs.items()}
    margin = [a - b for a, b in zip(cached["beams_best"], cached["greedy"])]
    tol = BEAM_SCORE_TOL * n
    fwd_margin = [a - b for a, b in zip(forward["beams_best"],
                                        forward["greedy"])]
    routes = [sum(abs(forward[k][r] - cached[k][r]) for k in seqs)
              for r in range(len(T5_SOURCE_LENS))]
    emit({"phase": "t5_beam", "model": T5_MODEL,
          "source_lens": list(T5_SOURCE_LENS), "beams": BEAMS,
          "max_new_tokens": n, "seconds_cold": seconds[0],
          "seconds_warm": seconds[1], "encode_seconds": encode_s,
          "ms_per_step_cold": (seconds[0] - encode_s) / n * 1e3,
          "ms_per_step_warm": (seconds[1] - encode_s) / n * 1e3,
          "launches": counts, "beams_1_equals_greedy": True,
          "rows_with_eos": sum(eos in r for r in best.tolist()),
          "rescored_cached": cached, "best_minus_greedy_cached": margin,
          "rescored_forward": forward, "best_minus_greedy_forward":
          fwd_margin, "route_disagreement": routes, "tol": tol,
          "best_row0_head": best[0, :8].tolist()})
    for r in range(len(T5_SOURCE_LENS)):
        if margin[r] < -tol or fwd_margin[r] < -tol - routes[r]:
            raise AssertionError(
                f"t5 beam: the best of {BEAMS} beams scores {margin} "
                f"(cached) and {fwd_margin} (forward) against greedy's")
    return counts


def phase_t5_grad(torch, dev):
    """T5_MODEL's width at T5_GRAD_LAYERS encoder and decoder layers, the
    same f32 master weights three ways: the kernel route (K1 and its VJP)
    and the plain route computing in bf16, and an f32 plain model as the
    reference.  One gradient of the reference's teacher-forced
    cross-entropy (tests/test_t5.py) over b4 sources of T5_SOURCE_LENS and
    T5_GRAD_TARGET target tokens: the kernel route's gradients (one
    vector) no farther from the f32 model's than COMPOSE_RATIO times the
    plain route's; the kernel route's launches exact."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.ops import cuda as kernels

    bf = torch.bfloat16
    variants = {"kernel": dict(impl="auto", dtype=bf),
                "plain": dict(impl="plain", dtype=bf),
                "f32": dict(impl="plain", dtype=torch.float32)}
    layers = dict(n_encoder_layers=T5_GRAD_LAYERS,
                  n_decoder_layers=T5_GRAD_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    state, grads, losses, counts = None, {}, {}, None
    for name, kw in variants.items():
        model = create_model(T5_MODEL, device=dev, param_dtype=torch.float32,
                             **layers, **kw)
        if state is None:
            with torch.no_grad():
                model.reset_parameters(
                    torch.Generator(device=dev).manual_seed(SEED))
            state = t5_conditioned(torch, model).state_dict()
            _, src, mask = ragged_batch(torch, dev, model.cfg.vocab_size,
                                        T5_SOURCE_LENS)
            tgt = torch.randint(0, model.cfg.vocab_size,
                                (len(T5_SOURCE_LENS), T5_GRAD_TARGET),
                                generator=gen, device=dev)
        else:
            model.load_state_dict(state)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        kernels.reset_launch_counts()
        logits = model(src, tgt, source_mask=mask)
        labels = torch.roll(tgt, -1, dims=1)
        loss = F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]).float(),
            labels[:, :-1].reshape(-1))
        g = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        if name == "kernel":
            counts = kernels.launch_counts()
            want = t5_launches(model.cfg, 1, backward=True)
            if counts != want:
                raise AssertionError(f"t5 grad launches {counts}, expected "
                                     f"{want}")
        grads[name] = torch.cat([t.float().flatten() for t in g])
        losses[name] = loss.item()
        del model, params, logits, g
        torch.cuda.empty_cache()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    e_k, e_p = rel(grads["kernel"], grads["f32"]), rel(grads["plain"],
                                                       grads["f32"])
    emit({"phase": "t5_grad", "model": T5_MODEL, "layers": T5_GRAD_LAYERS,
          "source_lens": list(T5_SOURCE_LENS), "target_len": T5_GRAD_TARGET,
          "loss": losses, "launches": counts,
          "all_grads_rel_l2_kernel_vs_f32": e_k,
          "all_grads_rel_l2_plain_vs_f32": e_p, "ratio": e_k / e_p,
          "ratio_limit": COMPOSE_RATIO})
    for v in ("kernel", "plain"):
        if not math.isfinite(losses[v]) or abs(
                losses[v] - losses["f32"]) > 1e-2 * abs(losses["f32"]):
            raise AssertionError(f"t5 grad loss {losses}")
    if not math.isfinite(e_k) or e_k > COMPOSE_RATIO * e_p:
        raise AssertionError(f"t5 grad: kernel route {e_k} against plain "
                             f"{e_p} from f32")
    del grads, state
    torch.cuda.empty_cache()
    return counts


def nvidia_smi_name_power() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def kubelet_env(container, ordinal=0, resolve=None):
    """This process's environment with ``container``'s env over it, as the
    kubelet sets it: the pod-index fieldRef becomes ``ordinal`` and every
    name in ``resolve`` (worker hostnames, which no DNS answers here)
    becomes its address wherever it stands in a value."""
    env = dict(os.environ)
    for e in container.get("env", []):
        if "valueFrom" in e:
            path = e["valueFrom"]["fieldRef"]["fieldPath"]
            if path != "metadata.labels['apps.kubernetes.io/pod-index']":
                raise AssertionError(f"unresolvable fieldRef {path}")
            env[e["name"]] = str(ordinal)
        else:
            value = e["value"]
            for name, addr in (resolve or {}).items():
                value = value.replace(name, addr)
            env[e["name"]] = value
    return env


def pod_command(command, port=None):
    """``command`` as this machine runs it: each ``python`` is this
    interpreter, and with ``port`` the server's ``--port`` is it."""
    cmd = [sys.executable if c == "python" else c for c in command]
    if port is not None:
        cmd[cmd.index("--port") + 1] = str(port)
    return cmd


def process_tree(pid):
    """The pids under ``pid`` (from /proc), children before theirs."""
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        try:
            tids = os.listdir(f"/proc/{p}/task")
        except FileNotFoundError:
            continue
        for tid in tids:
            try:
                with open(f"/proc/{p}/task/{tid}/children") as f:
                    kids = [int(k) for k in f.read().split()]
            except FileNotFoundError:
                continue
            out += kids
            todo += kids
    return out


class Pod:
    """One container's command run as the kubelet would start it, its
    output in a temporary file; ``stop`` ends it and everything it
    started."""

    def __init__(self, command, env, what):
        self.what = what
        self.log = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            command, cwd=os.path.dirname(os.path.abspath(__file__)),
            env=env, stdout=self.log, stderr=subprocess.STDOUT,
            start_new_session=True)

    def output(self) -> str:
        # pread, not seek and read: the process writes through the same
        # open file, so moving its offset would let its next line land
        # over the start of the log.
        fd, chunks, at = self.log.fileno(), [], 0
        while chunk := os.pread(fd, 1 << 20, at):
            chunks.append(chunk)
            at += len(chunk)
        return b"".join(chunks).decode(errors="replace")

    def fail(self, why):
        tail = self.output()[-6000:]
        self.stop()
        raise AssertionError(f"{self.what}: {why}\n{tail}")

    def wait(self, timeout):
        """The exit code of a run to its end within ``timeout``."""
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.fail(f"still running after {timeout} s")

    def stop(self):
        """SIGTERM, then the exit status; a process left under it after
        30 s is killed, and the stop then fails."""
        tree = process_tree(self.proc.pid)
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(timeout=30)
        deadline = time.monotonic() + 30
        left = [p for p in tree if os.path.exists(f"/proc/{p}")]
        while left and time.monotonic() < deadline:
            time.sleep(0.2)
            left = [p for p in left if os.path.exists(f"/proc/{p}")]
        for p in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(p, signal.SIGKILL)
        self.log.close()
        if left:
            raise AssertionError(f"{self.what}: processes {left} outlived "
                                 "their launcher")
        return rc


def served_request_a(pod, port, body, what):
    """Wait for the replica's /readyz, then request A once, with the
    attention route counters read from its /metrics before and after.
    Returns (seconds to ready, tokens, request seconds, counter rises)."""
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + PLATFORM_READY_S
    while True:
        if pod.proc.poll() is not None:
            pod.fail(f"exited {pod.proc.returncode} before it was ready")
        try:
            status, ready = http(base, "/readyz", timeout=PLATFORM_READY_S)
            if status == 200 and ready.get("ready"):
                break
        except OSError:
            pass
        if time.monotonic() > deadline:
            pod.fail(f"not ready within {PLATFORM_READY_S} s")
        time.sleep(0.5)
    ready_s = time.perf_counter() - pod.t0
    names = {i: f'attention_kernel_calls_total{{impl="{i}"}}'
             for i in ("kernel", "plain")}
    _, before = http(base, "/metrics")
    t0 = time.perf_counter()
    status, out = http(base, "/v1/generate", body)
    request_s = time.perf_counter() - t0
    _, after = http(base, "/metrics")
    rose = {i: metric_value(after, n) - metric_value(before, n)
            for i, n in names.items()}
    if status != 200 or rose["kernel"] <= 0 or rose["plain"] != 0:
        pod.fail(f"request A: {status}, attention calls by route {rose}")
    return ready_s, out["tokens"], request_s, rose


def openssl_pair(hosts=("127.0.0.1", "localhost"), cn="kft-webhook"):
    """A self-signed serving pair from the openssl command line, the pair
    ``webhook/certs.generate_self_signed`` makes (ECDSA P-256, SHA-256,
    the hosts as SANs, marked CA so a client can pin it), for a machine
    without the ``cryptography`` package: (cert PEM, key PEM)."""
    sans = ",".join(("IP:" if h.replace(".", "").isdigit() else "DNS:") + h
                    for h in hosts)
    with tempfile.TemporaryDirectory() as d:
        cert, key = os.path.join(d, "tls.crt"), os.path.join(d, "tls.key")
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
             "ec_paramgen_curve:P-256", "-sha256", "-nodes", "-days", "1",
             "-keyout", key, "-out", cert, "-subj", f"/CN={cn}",
             "-addext", f"subjectAltName={sans}",
             "-addext", "basicConstraints=critical,CA:TRUE"],
            check=True, capture_output=True, timeout=60)
        with open(cert, "rb") as f, open(key, "rb") as g:
            return f.read(), g.read()


class AdmittingKube:
    """The API server's admission step in front of ``FakeKube``: a Pod
    create is sent to the webhook as an AdmissionReview over HTTPS,
    verified against ``cafile``, and stored with the review's JSON patch
    applied.  Every other call goes to the store as it is."""

    def __init__(self, kube, url, cafile):
        self.kube = kube
        self.url = url
        self.cafile = cafile
        self.admission_ms = []

    def __getattr__(self, name):
        return getattr(self.kube, name)

    def admit(self, pod):
        """``pod`` with the webhook's patch applied."""
        import base64
        import ssl

        from kubeflow_tpu_torch.platform.webhook.jsonpatch import apply_patch

        meta = pod["metadata"]
        review = {"apiVersion": "admission.k8s.io/v1",
                  "kind": "AdmissionReview",
                  "request": {"uid": meta["name"],
                              "namespace": meta["namespace"],
                              "resource": {"resource": "pods"},
                              "object": pod}}
        ctx = ssl.create_default_context(cafile=self.cafile)
        req = urllib.request.Request(
            self.url + "/apply-poddefault", data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"})
        opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}),
            urllib.request.HTTPSHandler(context=ctx))
        t0 = time.perf_counter()
        with opener.open(req, timeout=30) as resp:
            out = json.load(resp)["response"]
        self.admission_ms.append((time.perf_counter() - t0) * 1e3)
        if not out["allowed"] or out.get("patchType") != "JSONPatch":
            raise AssertionError(f"webhook: {out}")
        return apply_patch(pod, json.loads(base64.b64decode(out["patch"])))

    def create(self, obj):
        if obj.get("kind") == "Pod":
            obj = self.admit(obj)
        return self.kube.create(obj)


class ServeKubelet:
    """The kubelet of the front door's replica pods, as the fleet sim's
    ready gate: once the sim has created a pod, its (admitted) main
    container runs as a subprocess, and the pod is ready when the
    process's /readyz answers within its readinessProbe's timeout (the
    kubelet's default, 1 s, when the probe names none; a probe that
    times out is counted and tried again).  At the first ready answer
    the process's attention route counters are read from its /metrics,
    before the endpoint can be published."""

    def __init__(self, kube, ns, port):
        self.kube = kube
        self.ns = ns
        self.base = f"http://127.0.0.1:{port}"
        self.lock = threading.Lock()
        self.pods = {}       # pod name -> Pod
        self.started = {}    # pod name -> perf_counter at start
        self.ready = {}      # pod name -> (perf_counter, /readyz answer)
        self.routes = {}     # pod name -> route counters at ready
        self.probe_timeouts = 0

    def gate(self, svc, revision, ordinal):
        from kubeflow_tpu_torch.platform.k8s import errors
        from kubeflow_tpu_torch.platform.k8s.types import POD

        name = f"{svc}-v{revision}-{ordinal}"
        try:
            pod = self.kube.get(POD, name, self.ns)
        except errors.NotFound:
            return False
        container = pod["spec"]["containers"][0]
        timeout = container["readinessProbe"].get("timeoutSeconds", 1)
        with self.lock:
            proc = self.pods.get(name)
            if proc is None:
                proc = self.pods[name] = Pod(
                    pod_command(container["command"]),
                    kubelet_env(container), f"platform_serve pod {name}")
                self.started[name] = proc.t0
            if name in self.ready:
                return True
        if proc.proc.poll() is not None:
            raise AssertionError(f"pod {name} exited {proc.proc.returncode}")
        try:
            status, ready = http(self.base, "/readyz", timeout=timeout)
        except TimeoutError:
            self.probe_timeouts += 1
            return False
        except urllib.error.URLError as e:
            if isinstance(e.reason, TimeoutError):
                self.probe_timeouts += 1
            return False
        except OSError:
            return False
        if status != 200 or not ready.get("ready"):
            return False
        _, page = http(self.base, "/metrics")
        with self.lock:
            self.routes[name] = {
                i: metric_value(page, f'attention_kernel_calls_total'
                                      f'{{impl="{i}"}}')
                for i in ("kernel", "plain")}
            self.ready[name] = (time.perf_counter(), ready)
        return True

    def stop(self, name):
        """SIGTERM the pod's process (its pod is gone): the exit status."""
        with self.lock:
            proc = self.pods.pop(name)
        return proc.stop()

    def stop_all(self):
        with self.lock:
            procs = list(self.pods.values())
            self.pods.clear()
        for proc in procs:
            with contextlib.suppress(AssertionError):
                proc.stop()


class Timeline:
    """The first perf_counter at which each named predicate held, polled
    every 5 ms in a thread of its own."""

    def __init__(self, checks):
        self.checks = dict(checks)
        self.at = {}
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.005):
            for name, check in self.checks.items():
                if name in self.at:
                    continue
                try:
                    if check(self.at):
                        self.at[name] = time.perf_counter()
                except Exception as e:  # noqa: BLE001 — reported at wait
                    self.errors.append(f"{name}: {type(e).__name__}: {e}")

    def wait(self, name, timeout):
        deadline = time.monotonic() + timeout
        while name not in self.at:
            if self.errors:
                raise AssertionError(f"timeline: {self.errors}")
            if time.monotonic() > deadline:
                raise AssertionError(f"platform_serve: no {name} within "
                                     f"{timeout} s; seen {sorted(self.at)}")
            time.sleep(0.02)
        return self.at[name]

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def phase_platform_serve(torch, dev, model, tol):
    """The serving front door on this card (the docstring's 6d1a).  The
    accelerator table against this card; request A through the same
    default paged engine in this process for reference; then in the
    port's ``FakeKube``: a 1-GPU quota, a 1-GPU node of this card's
    product, a PodDefault setting SERVE_PODDEFAULT_ENV in the replica's
    pods, the webhook over HTTPS on an openssl pair, a ``Manager`` with
    the InferenceService controller (a SERVE_SYNC_S pass), the fleet sim
    creating pods through the webhook, and the activator.  InferenceService
    ``llama`` (llama3_8b, one GPU, 0 to 1 replicas, idle window
    SERVE_IDLE_S) parks at zero; request A through the activator is held,
    stamps the wake, the controller scales to 1, the pod is admitted and
    its container runs as a subprocess (the PodDefault's env in its
    environment), its /readyz makes it Ready, the endpoint is published
    and request A replays into it: tokens held to the in-process ones
    (``agreement``), the attention calls on the kernel route.  The
    controller's scrape holds the replica's request count; idle, the
    service parks, the pod goes, its process exits on SIGTERM.  Then the
    pair rotates (``write_pair``, ``reload_certs``; the old pin refused)
    and the ``mesh="tp=1"`` replica's pod is admitted through the rotated
    webhook and run under the launcher, token-equal to the first."""
    from kubeflow_tpu_torch.models.serve import GenerationService
    from kubeflow_tpu_torch.platform import (
        Activator,
        EndpointBook,
        FakeKube,
        InferenceFleetSim,
        Manager,
        create_activator_app,
        inferenceservice_controller,
    )
    from kubeflow_tpu_torch.platform.gpu import ACCELERATORS, pods, slice_spec
    from kubeflow_tpu_torch.platform.k8s import errors
    from kubeflow_tpu_torch.platform.apis import inferenceservice as svcapi
    from kubeflow_tpu_torch.platform.k8s.types import (
        DEPLOYMENT,
        EVENT,
        INFERENCESERVICE,
        POD,
    )
    from kubeflow_tpu_torch.platform.runtime import metrics
    from kubeflow_tpu_torch.platform.webhook import certs
    from kubeflow_tpu_torch.platform.webhook.server import WebhookServer
    from kubeflow_tpu_torch.telemetry.tsdb import TSDB

    smi = nvidia_smi_name_power()
    acc = ACCELERATORS[PLATFORM_ACCELERATOR]
    card = smi.split(",")[0].strip()
    if acc.product != card.replace(" ", "-"):
        raise AssertionError(f"{PLATFORM_ACCELERATOR}'s product "
                             f"{acc.product!r} is not this card, {card!r}")
    spec = slice_spec(PLATFORM_ACCELERATOR, 1)
    ns, name, key = "smoke", "llama", "smoke/llama"

    def checked(container, pod, what):
        want = {"nvidia.com/gpu": "1"}
        if (container["resources"] != {"limits": want, "requests": want}
                or pod["nodeSelector"] != {"nvidia.com/gpu.product":
                                           acc.product}):
            raise AssertionError(f"{what}: deployment asks {pod}")
        return container

    body = schedule_bodies(torch, dev, model.cfg.vocab_size)["A"]
    # The same request through the same engine (the service's default
    # paged engine at its default geometry) in this process.
    service = GenerationService(model)
    server, thread, base = http_server(service, "llama3_8b")
    try:
        http(base, "/readyz")
        t0 = time.perf_counter()
        _, ref = http(base, "/v1/generate", body)
        ref_s = time.perf_counter() - t0
    finally:
        stop_server(service, server, thread)
    # The server's app holds the service and its 8.6 GB pool.
    del service, server, thread
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()

    pd_name, pd_value = SERVE_PODDEFAULT_ENV
    kube = FakeKube()
    for n in ("kubeflow", ns):
        kube.add_namespace(n)
    kube.add_gpu_node("gpu-node-0", accelerator=PLATFORM_ACCELERATOR,
                      gpus=torch.cuda.device_count())
    kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                 "metadata": {"name": "gpus", "namespace": ns},
                 "spec": {"hard": {"nvidia.com/gpu": "1"}}})
    kube.create({"apiVersion": "kubeflow.org/v1alpha1", "kind": "PodDefault",
                 "metadata": {"name": "smoke-env", "namespace": ns},
                 "spec": {"selector": {"matchLabels": {
                              pods.LABEL_SERVICE_NAME: name}},
                          "desc": "the front door's admission check",
                          "env": [{"name": pd_name, "value": pd_value}]}})
    port = free_port()
    certdir = tempfile.mkdtemp(prefix="platform_serve_certs")
    cert, key_file = certs.write_pair(certdir, *openssl_pair())
    old_pin = os.path.join(certdir, "old.crt")
    shutil.copyfile(cert, old_pin)
    webhook = WebhookServer(kube, host="127.0.0.1", port=0, cert_file=cert,
                            key_file=key_file)
    webhook.start()
    admitting = AdmittingKube(kube, f"https://127.0.0.1:{webhook.port}", cert)
    kubelet = ServeKubelet(kube, ns, port)
    sim = InferenceFleetSim(admitting, ns, poll_seconds=0.05,
                            endpoint_for=lambda *a: kubelet.base,
                            ready_gate=kubelet.gate)
    book, tsdb = EndpointBook(), TSDB()
    mgr = Manager(kube)
    mgr.add(inferenceservice_controller(kube, book=book, tsdb=tsdb,
                                        sync_period=SERVE_SYNC_S))
    act = Activator(kube, book=book, tsdb=tsdb)
    replays = []
    forward = act.forward

    def timed_forward(*args):
        replays.append(time.perf_counter())
        out = forward(*args)
        replays.append(time.perf_counter())
        return out

    act.forward = timed_forward
    published = []

    def on_publish(k):
        rec = book.get(k)
        if k == key and rec is not None and rec.endpoints and not published:
            published.append(time.perf_counter())

    book.subscribe(on_publish)
    front = create_activator_app(act).make_server("127.0.0.1", 0)
    front_thread = threading.Thread(target=front.serve_forever,
                                    kwargs={"poll_interval": 0.05},
                                    daemon=True)
    front_thread.start()
    pod_name = f"{name}-v1-0"

    def svc():
        return kube.get(INFERENCESERVICE, name, ns)

    def replicas():
        try:
            return kube.get(DEPLOYMENT, f"{name}-v1", ns)["spec"]["replicas"]
        except errors.NotFound:
            return None

    def pod_exists():
        try:
            return kube.get(POD, pod_name, ns)
        except errors.NotFound:
            return None

    counts = {
        "replayed": lambda: metrics.activator_proxy_requests_total.sample(
            outcome="replayed") or 0.0,
        "shed": lambda: sum(
            metrics.serve_requests_shed_total.values().values()),
        "wake_stamps": lambda: (
            metrics.activator_wake_stamps_total.values()[()]),
    }
    before = {k: fn() for k, fn in counts.items()}
    held_peak = [0.0]
    timeline = None
    mgr.start()
    try:
        kube.create({
            "apiVersion": "kubeflow.org/v1alpha1", "kind": "InferenceService",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"model": "llama3_8b",
                     "gpu": {"accelerator": PLATFORM_ACCELERATOR, "gpus": 1},
                     "port": port,
                     "replicas": {"min": 0, "max": 1, "initial": 0},
                     "scale": {"idleSeconds": SERVE_IDLE_S}}})
        deadline = time.monotonic() + 30
        while (svc().get("status") or {}).get("phase") != "Idle":
            if time.monotonic() > deadline:
                raise AssertionError(f"platform_serve: not parked: "
                                     f"{svc().get('status')}")
            time.sleep(0.05)
        if pod_exists() is not None or replicas() not in (0, None):
            raise AssertionError("platform_serve: a parked service has pods")

        def held_sampler(_at):
            # Samples the held gauge's peak on every poll; never "holds".
            held_peak[0] = max(held_peak[0], metrics.serve_requests_held
                               .values()[()])
            return False

        timeline = Timeline({
            "held": lambda at: metrics.serve_requests_held.values()[()] >= 1,
            "wake_stamped": lambda at: (
                svcapi.wake_requested_at(svc()) is not None),
            "scaled_up": lambda at: (replicas() or 0) >= 1,
            "pod_created": lambda at: pod_exists() is not None,
            "scaled_to_zero": lambda at: (bool(published)
                                          and replicas() == 0),
            "pod_deleted": lambda at: ("pod_created" in at
                                       and pod_exists() is None),
            "held_peak": held_sampler,
        })
        t_arrival = time.perf_counter()
        status, got = http(f"http://127.0.0.1:{front.server_address[1]}",
                           f"/serve/{ns}/{name}/v1/generate", body,
                           timeout=PLATFORM_READY_S)
        t_done = time.perf_counter()
        if status != 200:
            raise AssertionError(f"platform_serve: request A {status} {got}")
        proc = kubelet.pods[pod_name]
        with open(f"/proc/{proc.proc.pid}/environ", "rb") as f:
            environ = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                           if b"=" in kv)
        if environ.get(pd_name.encode()) != pd_value.encode():
            raise AssertionError(f"platform_serve: the PodDefault's {pd_name} "
                                 "is not in the replica's environment")
        _, page = http(kubelet.base, "/metrics")
        rose = {i: metric_value(page, f'attention_kernel_calls_total'
                                      f'{{impl="{i}"}}') - c
                for i, c in kubelet.routes[pod_name].items()}
        if rose["kernel"] <= 0 or rose["plain"] != 0:
            proc.fail(f"request A: attention calls by route {rose}")
        agree = agreement(torch, dev, model, body, got["tokens"],
                          ref["tokens"], tol, "platform_serve front door")
        tokens = got["tokens"]
        timeline.wait("scaled_to_zero", 60 + SERVE_IDLE_S)
        timeline.wait("pod_deleted", 60)
        rc = kubelet.stop(pod_name)
        scraped = tsdb.instant("generate_requests_total", {"service": key})
        by_replica = {}
        for labels, _, v in scraped:
            by_replica[labels["replica"]] = (
                by_replica.get(labels["replica"], 0.0) + v)
        if list(by_replica) != [pod_name] or by_replica[pod_name] < 1:
            raise AssertionError(f"platform_serve: the controller's scrape "
                                 f"read generate_requests_total {scraped}")
        status_after = svc()["status"]
        if (status_after["phase"] != "Idle" or status_after["replicas"] != 0
                or sim.errors):
            raise AssertionError(f"platform_serve: {status_after}, sim "
                                 f"{sim.errors}")
        events = sorted((e["reason"], e["message"], e.get("count", 1))
                        for e in kube.list(EVENT, ns))
        at = timeline.at
        got_counts = {k: fn() - before[k] for k, fn in counts.items()}
        if (got_counts["replayed"] != 1 or got_counts["shed"] != 0
                or held_peak[0] != 1.0 or got_counts["wake_stamps"] < 1):
            raise AssertionError(f"platform_serve: activator {got_counts}, "
                                 f"held at most {held_peak[0]}")
        front_row = {
            "phase": "platform_serve", "path": "front_door",
            "model": "llama3_8b", "nvidia_smi": smi,
            "hold_seconds": replays[0] - t_arrival,
            "held_after_arrival_seconds": at["held"] - t_arrival,
            "wake_stamp_after_arrival_seconds": (
                at["wake_stamped"] - t_arrival),
            "wake_to_scale_up_seconds": at["scaled_up"] - at["wake_stamped"],
            "scale_up_to_pod_seconds": at["pod_created"] - at["scaled_up"],
            "pod_to_process_seconds": (kubelet.started[pod_name]
                                       - at["pod_created"]),
            "seconds_to_ready": (kubelet.ready[pod_name][0]
                                 - kubelet.started[pod_name]),
            "first_readyz": kubelet.ready[pod_name][1],
            "readyz_probe_timeouts": kubelet.probe_timeouts,
            "ready_to_publish_seconds": (published[0]
                                         - kubelet.ready[pod_name][0]),
            "publish_to_replay_seconds": replays[0] - published[0],
            "request_a_seconds_through_activator": t_done - t_arrival,
            "request_a_replay_seconds": replays[1] - replays[0],
            "in_process_request_a_seconds": ref_s,
            "activator": {"held": held_peak[0], **got_counts},
            "webhook_admissions": len(admitting.admission_ms),
            "webhook_admission_ms": list(admitting.admission_ms),
            "scale_to_zero_seconds_after_last_request": (
                at["scaled_to_zero"] - t_done),
            "pod_deleted_after_scale_to_zero_seconds": (
                at["pod_deleted"] - at["scaled_to_zero"]),
            "exit_status_after_sigterm": rc,
            "poddefault_env_in_replica": True,
            "scraped_generate_requests_total": by_replica,
            "agreement_with_in_process": agree,
            "attention_calls_by_route": rose,
            "events": events, "status": status_after,
            "command": kube.get(DEPLOYMENT, f"{name}-v1", ns)["spec"][
                "template"]["spec"]["containers"][0]["command"]}
        checked(kube.get(DEPLOYMENT, f"{name}-v1", ns)["spec"]["template"][
            "spec"]["containers"][0],
            kube.get(DEPLOYMENT, f"{name}-v1", ns)["spec"]["template"][
                "spec"], "platform_serve front door")

        # Rotation: a new pair goes live; a handshake pinned to the old
        # one is refused.
        import ssl

        t0 = time.perf_counter()
        certs.write_pair(certdir, *openssl_pair())
        if not webhook.reload_certs() or webhook.reload_failures:
            raise AssertionError(f"platform_serve: rotation failed "
                                 f"({webhook.reload_failures} failures)")
        rotate_s = time.perf_counter() - t0
        stale = AdmittingKube(kube, admitting.url, old_pin)
        try:
            stale.admit(pod_of(pods.serving_deployment(
                ns=ns, name=name, revision=1, replicas=1, model="llama3_8b",
                spec=spec, image="kubeflow-tpu-torch"), "pinned-old"))
        except urllib.error.URLError as e:
            if not isinstance(e.reason, ssl.SSLError):
                raise
        else:
            raise AssertionError("platform_serve: the old pair still "
                                 "verifies after the rotation")
        # The tp=1 replica's pod, admitted through the rotated webhook.
        dep = pods.serving_deployment(
            ns=ns, name=name, revision=1, replicas=1, model="llama3_8b",
            spec=spec, image="kubeflow-tpu-torch", mesh="tp=1")
        pod = admitting.admit(pod_of(dep, f"{name}-mesh-0"))
        container = checked(pod["spec"]["containers"][0], pod["spec"],
                            "platform_serve mesh")
    finally:
        if timeline is not None:
            timeline.stop()
        mgr.stop()
        sim.close()
        kubelet.stop_all()
        front.shutdown()
        front.server_close()
        webhook.stop()
        shutil.rmtree(certdir, ignore_errors=True)
    env = {e["name"]: e.get("value") for e in container["env"]}
    if env.get(pd_name) != pd_value:
        raise AssertionError(f"platform_serve mesh: env {env}")
    mesh_port = free_port()
    cmd = pod_command(container["command"], mesh_port)
    what = "platform_serve mesh tp=1"
    pod = Pod(cmd, kubelet_env(container), what)
    try:
        ready_s, got, request_s, mesh_rose = served_request_a(
            pod, mesh_port, body, what)
    except BaseException:
        pod.stop()
        raise
    if pod.proc.poll() is not None:
        pod.fail(f"exited {pod.proc.returncode} while serving")
    mesh_rc = pod.stop()
    if got != tokens:
        raise AssertionError(f"{what}: tokens differ from the replica "
                             "without a mesh")
    emit(front_row)
    emit({"phase": "platform_serve", "path": "rotation", "nvidia_smi": smi,
          "openssl": subprocess.run(["openssl", "version"],
                                    capture_output=True, text=True,
                                    timeout=60).stdout.strip(),
          "cryptography_installed": importlib.util.find_spec(
              "cryptography") is not None,
          "rotate_seconds": rotate_s, "reload_failures":
          webhook.reload_failures, "old_pair_refused": True,
          "admissions_after_rotation": 1,
          "webhook_admission_ms": admitting.admission_ms[-1]})
    emit({"phase": "platform_serve", "model": "llama3_8b", "mesh": "tp=1",
          "command": container["command"], "run_as": cmd,
          "env": env, "seconds_to_ready": ready_s,
          "request_a_seconds": request_s,
          "in_process_request_a_seconds": ref_s,
          "agreement_with_in_process": {
              "equal_to_replica_without_mesh": True},
          "attention_calls_by_route": mesh_rose,
          "exit_status_after_sigterm": mesh_rc,
          "parent_memory_allocated_bytes": resident, "nvidia_smi": smi})


def pod_of(deployment, pod_name):
    """The ReplicaSet's pod ``pod_name`` from ``deployment``'s template."""
    tmpl = deployment["spec"]["template"]
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": pod_name,
                         "namespace": deployment["metadata"]["namespace"],
                         "labels": dict(tmpl["metadata"]["labels"])},
            "spec": json.loads(json.dumps(tmpl["spec"]))}


def notebook_launches(n_layers, new_tokens):
    """A greedy ``generate`` of one row: K2 a layer at the prefill, K5 a
    layer at each later token, K1 2L+1 a forward."""
    return {"rms_norm": (2 * n_layers + 1) * new_tokens, "rms_norm_bwd": 0,
            "flash_attention_fwd": n_layers, "flash_attention_fwd_lse": 0,
            "flash_attention_dq": 0, "flash_attention_dkv": 0,
            "flash_decode": n_layers * (new_tokens - 1)}


def notebook_pod(kube, ns, sts, label, what):
    """The StatefulSet controller's pod 0 of ``sts``, opted in to the
    PodDefault ``label``, through the webhook and its JSON patch."""
    import base64

    from kubeflow_tpu_torch.platform import mutate_admission_review
    from kubeflow_tpu_torch.platform.k8s.types import PODDEFAULT, owner_reference
    from kubeflow_tpu_torch.platform.webhook.jsonpatch import apply_patch

    tmpl = sts["spec"]["template"]
    name = sts["metadata"]["name"] + "-0"
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": ns,
                        "labels": {**tmpl["metadata"]["labels"],
                                   "apps.kubernetes.io/pod-index": "0",
                                   label: "true"},
                        "ownerReferences": [owner_reference(sts)]},
           "spec": json.loads(json.dumps(tmpl["spec"]))}
    review = mutate_admission_review(
        {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
         "request": {"uid": name, "namespace": ns,
                     "resource": {"resource": "pods"}, "object": pod}},
        kube.list(PODDEFAULT, ns))["response"]
    if not review["allowed"] or review.get("patchType") != "JSONPatch":
        raise AssertionError(f"{what}: webhook {review}")
    return apply_patch(pod, json.loads(base64.b64decode(review["patch"])))


def front_door_authz(kube):
    """The authorization the front door's SubjectAccessReviews meet: a
    verb in a namespace is granted to a user a RoleBinding there names
    (``kubeflow-admin`` and ``kubeflow-edit`` any verb, ``kubeflow-view``
    reads), and a cluster-scoped read of nodes or storage classes to a
    user some binding names; nothing else, so no user is a cluster
    admin."""
    from kubeflow_tpu_torch.platform.k8s.types import ROLEBINDING

    reads = ("get", "list", "watch")

    def roles(user, namespace):
        return {rb["roleRef"]["name"] for rb in kube.list(ROLEBINDING,
                                                          namespace)
                for subject in rb.get("subjects") or []
                if subject.get("kind") == "User"
                and subject.get("name") == user}

    def policy(*, user, verb, gvk, namespace, groups, subresource):
        if namespace is None:
            return (verb in reads and gvk.kind in ("Node", "StorageClass")
                    and bool(roles(user, None)))
        held = roles(user, namespace)
        if held & {"kubeflow-admin", "kubeflow-edit"}:
            return True
        return "kubeflow-view" in held and verb in reads

    return policy


class FrontDoorUser:
    """A browser at the front door: the identity header the gateway sets
    and, once a response has set it, the CSRF cookie echoed in its
    header.  Every request's status, milliseconds and label are kept."""

    def __init__(self, user, log):
        self.user = user
        self.cookie = None
        self.log = log

    def request(self, base, method, path, body=None, *, label,
                csrf=True):
        import http.client

        headers = {"kubeflow-userid": self.user}
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        if self.cookie:
            headers["Cookie"] = f"XSRF-TOKEN={self.cookie}"
            if csrf:
                headers["X-XSRF-TOKEN"] = self.cookie
        host, port = base.rsplit("/", 1)[-1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        t0 = time.perf_counter()
        try:
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        ms = (time.perf_counter() - t0) * 1e3
        for cookie in resp.headers.get_all("Set-Cookie") or []:
            name, _, rest = cookie.partition("=")
            if name == "XSRF-TOKEN":
                self.cookie = rest.split(";")[0]
        ctype = resp.headers.get("Content-Type", "")
        payload = json.loads(raw) if ctype == "application/json" else raw
        self.log.append({"label": label, "user": self.user,
                         "method": method, "path": path,
                         "status": resp.status, "ms": ms})
        return resp.status, payload, ctype


def front_door_expect(what, got, want):
    if got != want:
        raise AssertionError(f"platform_notebook front door: {what}: "
                             f"{got!r}, expected {want!r}")


def front_door_profile(kube, ns):
    """The Profile ``ns`` reconciled by the port's ProfileReconciler into
    its workspace, checked; returns the reconcile's seconds."""
    from kubeflow_tpu_torch.platform import ProfileReconciler, Request
    from kubeflow_tpu_torch.platform.gpu import RESOURCE_GPU
    from kubeflow_tpu_torch.platform.k8s.types import (
        AUTHORIZATIONPOLICY,
        NAMESPACE,
        PROFILE,
        RESOURCEQUOTA,
        ROLEBINDING,
        SERVICEACCOUNT,
    )

    kube.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                 "metadata": {"name": ns},
                 "spec": {"owner": {"kind": "User", "name": FRONT_OWNER},
                          "resourceQuotaSpec": {
                              "hard": {RESOURCE_GPU: "1"}}}})
    t0 = time.perf_counter()
    ProfileReconciler(kube).reconcile(Request("", ns))
    seconds = time.perf_counter() - t0
    front_door_expect("profile status", kube.get(PROFILE, ns).get("status"),
                      {"status": "Succeeded", "message": ""})
    front_door_expect("namespace owner", kube.get(NAMESPACE, ns)[
        "metadata"]["annotations"].get("owner"), FRONT_OWNER)
    front_door_expect("service accounts", sorted(
        o["metadata"]["name"] for o in kube.list(SERVICEACCOUNT, ns)),
        ["default-editor", "default-viewer"])
    front_door_expect("bindings", sorted(
        (o["metadata"]["name"], o["roleRef"]["name"])
        for o in kube.list(ROLEBINDING, ns)),
        [("default-editor", "kubeflow-edit"),
         ("default-viewer", "kubeflow-view"),
         ("namespaceAdmin", "kubeflow-admin")])
    policy = kube.get(AUTHORIZATIONPOLICY, "ns-owner-access-istio", ns)
    front_door_expect("authorization policy", policy["spec"]["rules"][0],
                      {"when": [{"key": "request.headers[kubeflow-userid]",
                                 "values": [FRONT_OWNER]}]})
    front_door_expect("quota", kube.get(RESOURCEQUOTA, "kf-resource-quota",
                                        ns)["spec"],
                      {"hard": {RESOURCE_GPU: "1"}})
    return seconds


def phase_platform_notebook(torch, dev):
    """The notebook path of the platform (the docstring's 6d1b): the
    user's front door (the Profile, KFAM, the Jupyter and tensorboards
    apps), the port's reconciler, PodDefault webhook and quota admission
    in its in-memory API server, then the notebook pod's main container
    running one cell on the card.  Returns the cell's launch counts and
    its tokens."""
    import collections

    from kubeflow_tpu_torch.models.llama import CONFIGS as LLAMA_CONFIGS
    from kubeflow_tpu_torch.platform import (
        FakeKube,
        NotebookReconciler,
        Request,
        TensorboardReconciler,
        create_jupyter_app,
        create_kfam_app,
        create_tensorboards_app,
        gpu_pod_default,
    )
    from kubeflow_tpu_torch.platform.gpu import ACCELERATORS
    from kubeflow_tpu_torch.platform.k8s import errors
    from kubeflow_tpu_torch.platform.k8s.types import (
        DEPLOYMENT,
        NOTEBOOK,
        POD,
        PVC,
        RESOURCEQUOTA,
        SERVICE,
        STATEFULSET,
        TENSORBOARD,
        VIRTUALSERVICE,
    )

    smi = nvidia_smi_name_power()
    acc = ACCELERATORS[PLATFORM_ACCELERATOR]
    card = smi.split(",")[0].strip()
    if acc.product != card.replace(" ", "-"):
        raise AssertionError(f"{PLATFORM_ACCELERATOR}'s product "
                             f"{acc.product!r} is not this card, {card!r}")
    ns, label = "smoke", f"gpu-{PLATFORM_ACCELERATOR}"
    node = "gpu-node-0"
    kube = FakeKube()
    kube.add_namespace("default")
    kube.add_gpu_node(node, accelerator=PLATFORM_ACCELERATOR,
                      gpus=torch.cuda.device_count())
    profile_s = front_door_profile(kube, ns)
    kube.create(gpu_pod_default(ns, PLATFORM_ACCELERATOR, 1))
    kube.authz_policy = front_door_authz(kube)

    requests_log = []
    owner = FrontDoorUser(FRONT_OWNER, requests_log)
    user = FrontDoorUser(FRONT_CONTRIBUTOR, requests_log)
    stranger = FrontDoorUser(FRONT_STRANGER, requests_log)
    servers = []

    def serve(app):
        server, base = app.test_server()
        servers.append(server)
        return base

    workspace = tempfile.mkdtemp(prefix="workspace-")
    cell = None
    try:
        kfam = serve(create_kfam_app(kube))
        jwa = serve(create_jupyter_app(kube))
        twa = serve(create_tensorboards_app(kube))
        # The owner makes the contributor: the first response sets the
        # CSRF cookie, which the POST echoes.
        owner.request(kfam, "GET", "/healthz", label="kfam healthz")
        status, body, _ = owner.request(kfam, "POST", "/kfam/v1/bindings", {
            "user": {"kind": "User", "name": FRONT_CONTRIBUTOR},
            "referredNamespace": ns,
            "roleRef": {"kind": "ClusterRole", "name": "kubeflow-edit"}},
            label="kfam binding")
        front_door_expect("KFAM binding", (status, body),
                          (200, {"success": True, "status": 200}))
        binding_ms = requests_log[-1]["ms"]
        # The contributor opens the SPA and its picker.
        for path, ctype in [("/", "text/html"),
                            ("/app.js", "application/javascript; "
                                        "charset=utf-8"),
                            ("/shared/common.js", "application/javascript; "
                                                  "charset=utf-8")]:
            status, _, got = user.request(jwa, "GET", path, label=f"GET "
                                                                  f"{path}")
            front_door_expect(f"GET {path}", (status, got), (200, ctype))
        status, body, _ = user.request(jwa, "GET", f"/api/namespaces/{ns}/"
                                       "gpus", label="GET gpus")
        front_door_expect("the GPU picker", (status, body), (200, {
            "success": True, "status": 200,
            "gpus": [{"accelerator": PLATFORM_ACCELERATOR, "gpus": [1]}],
            "quota": {"hard": 1, "used": 0, "remaining": 1}}))
        # The spawn: the form's defaults with one GPU and the PodDefault,
        # which mounts /dev/shm itself.
        spawn = {"name": "nb", "gpus": {"accelerator": PLATFORM_ACCELERATOR,
                                        "gpus": 1},
                 "configurations": [label], "shm": False}
        t0 = time.perf_counter()
        status, body, _ = user.request(jwa, "POST",
                                       f"/api/namespaces/{ns}/notebooks",
                                       spawn, label="POST notebooks")
        kube.get(NOTEBOOK, "nb", ns)
        spawn_ms = (time.perf_counter() - t0) * 1e3
        front_door_expect("spawn", status, 200)
        front_door_expect("the workspace claim", [
            o["metadata"]["name"] for o in kube.list(PVC, ns)],
            ["nb-workspace"])

        reconciler = NotebookReconciler(kube, use_istio=True,
                                        mirror_min_interval=0)
        t0 = time.perf_counter()
        reconciler.reconcile(Request(ns, "nb"))
        reconcile_ms = (time.perf_counter() - t0) * 1e3
        sts = kube.get(STATEFULSET, "nb", ns)
        pod_spec = sts["spec"]["template"]["spec"]
        main = pod_spec["containers"][0]
        want_resources = {
            "limits": {"cpu": "4.8", "memory": "9.6Gi",
                       "nvidia.com/gpu": "1"},
            "requests": {"cpu": "4", "memory": "8Gi", "nvidia.com/gpu": "1"}}
        env = {e["name"]: e.get("value", e.get("valueFrom"))
               for e in main["env"]}
        want_env = {
            "NB_PREFIX": f"/notebook/{ns}/nb",
            "TPU_WORKER_ID": {"fieldRef": {"fieldPath":
                              "metadata.labels['apps.kubernetes.io/"
                              "pod-index']"}},
            "TPU_WORKER_HOSTNAMES": f"nb-0.nb-workers.{ns}.svc.cluster.local",
            "KFT_GPUS_PER_HOST": "1", "TPU_HOSTS_PER_SLICE": "1"}
        if (sts["spec"]["replicas"] != 1
                or main["resources"] != want_resources
                or pod_spec["nodeSelector"] != {"nvidia.com/gpu.product":
                                                acc.product}
                or env != want_env):
            raise AssertionError(f"platform_notebook: StatefulSet {sts}")
        children = {g.kind + "/" + o["metadata"]["name"]
                    for g in (SERVICE, VIRTUALSERVICE)
                    for o in kube.list(g, ns)}
        if children != {"Service/nb", "Service/nb-workers",
                        f"VirtualService/notebook-{ns}-nb"}:
            raise AssertionError(f"platform_notebook: children {children}")

        def pod_of(sts):
            pod = notebook_pod(kube, ns, sts, label, "platform_notebook")
            # The scheduler's binding: the GPU node.
            pod["spec"]["nodeName"] = node
            return pod

        pod = pod_of(sts)
        main = pod["spec"]["containers"][0]
        shm = [m for m in main.get("volumeMounts", [])
               if m["mountPath"] == "/dev/shm"]
        if (shm != [{"name": "gpu-shm", "mountPath": "/dev/shm"}]
                or f"poddefault.admission.kubeflow.org/poddefault-{label}"
                not in pod["metadata"]["annotations"]):
            raise AssertionError(f"platform_notebook: the PodDefault was "
                                 f"not applied: {pod}")
        kube.create(pod)
        # A second notebook's pod asks the GPU the quota has no room for.
        nb2 = json.loads(json.dumps(kube.get(NOTEBOOK, "nb", ns)))
        nb2["metadata"] = {"name": "nb2", "namespace": ns,
                           "labels": nb2["metadata"].get("labels", {})}
        nb2.pop("status", None)
        kube.create(nb2)
        reconciler.reconcile(Request(ns, "nb2"))
        refused = None
        try:
            kube.create(pod_of(kube.get(STATEFULSET, "nb2", ns)))
        except errors.Forbidden as e:
            refused = str(e)
        want_refusal = ('pods "nb2-0" is forbidden: exceeded quota: '
                        "kf-resource-quota, requested: nvidia.com/gpu=1, "
                        "used: nvidia.com/gpu=1, limited: nvidia.com/gpu=1")
        if refused != want_refusal:
            raise AssertionError(f"platform_notebook: second pod "
                                 f"{refused!r}")
        kube.set_pod_phase(ns, "nb-0", "Running", ready=True)
        reconciler.reconcile(Request(ns, "nb"))
        nb_status = kube.get(NOTEBOOK, "nb", ns)["status"]
        if (nb_status.get("readyReplicas") != 1
                or nb_status.get("replicas") != 1):
            raise AssertionError(f"platform_notebook: status {nb_status}")

        # The pod's main container runs the cell on the card; the kubelet
        # stand-in mounts the workspace claim at a directory of the
        # phase, the image's HOME.
        mounts = {m["name"]: m["mountPath"]
                  for m in main.get("volumeMounts", [])}
        claims = {v["name"]: v["persistentVolumeClaim"]["claimName"]
                  for v in pod["spec"].get("volumes", [])
                  if "persistentVolumeClaim" in v}
        front_door_expect("the workspace mount", [
            (claims[n], mounts[n]) for n in claims if n in mounts],
            [("nb-workspace", "/home/jovyan")])
        pod_env = {**kubelet_env(main, 0), "HOME": workspace}
        args = [NOTEBOOK_MODEL, str(SEED), str(NOTEBOOK_PROMPT),
                str(NOTEBOOK_NEW), dev.type]
        cmd = [sys.executable, "-c", NOTEBOOK_CELL, *args]
        cell = Pod(cmd, pod_env, "platform_notebook cell")

        # While the cell runs: the table, the quota's 403, a stranger's
        # 403, a POST without the CSRF header, and a Tensorboard on the
        # workspace claim.
        status, body, _ = user.request(jwa, "GET",
                                       f"/api/namespaces/{ns}/notebooks",
                                       label="GET notebooks")
        row = next((r for r in body.get("notebooks", [])
                    if r["name"] == "nb"), None) if status == 200 else None
        front_door_expect("the notebooks' table", (
            status, row and row["gpu"], row and row["status"]["phase"]),
            (200, {"accelerator": PLATFORM_ACCELERATOR, "gpus": 1},
             "running"))
        status, body, _ = user.request(jwa, "POST",
                                       f"/api/namespaces/{ns}/notebooks",
                                       {**spawn, "name": "nb3"},
                                       label="POST notebooks over quota")
        front_door_expect("the second spawn", (status, body.get("log")), (
            403, f"GPU quota exceeded (requested 1, remaining 0 of 1 GPUs "
                 f"in {ns})"))
        status, body, _ = stranger.request(
            jwa, "GET", f"/api/namespaces/{ns}/notebooks",
            label="GET notebooks without a binding")
        front_door_expect("a user without a binding", (status, body.get(
            "log")), (403, f"user {FRONT_STRANGER!r} cannot list notebooks "
                           f"in namespace {ns}"))
        status, body, _ = user.request(
            jwa, "POST", f"/api/namespaces/{ns}/notebooks",
            {**spawn, "name": "nb4"}, label="POST without the CSRF header",
            csrf=False)
        front_door_expect("a POST without the CSRF header", (status, body),
                          (403, {"success": False, "status": 403,
                                 "log": "CSRF check failed"}))
        user.request(twa, "GET", "/healthz", label="twa healthz")
        status, body, _ = user.request(
            twa, "POST", f"/api/namespaces/{ns}/tensorboards",
            {"name": "tb", "logspath": "pvc://nb-workspace/logs"},
            label="POST tensorboards")
        front_door_expect("the Tensorboard's create", status, 200)
        t0 = time.perf_counter()
        TensorboardReconciler(kube, rwo_pvc_scheduling=True).reconcile(
            Request(ns, "tb"))
        tensorboard_ms = (time.perf_counter() - t0) * 1e3
        tb_spec = kube.get(DEPLOYMENT, "tb", ns)["spec"]["template"]["spec"]
        front_door_expect("the Tensorboard's Deployment", (
            tb_spec["volumes"], tb_spec["containers"][0]["volumeMounts"],
            tb_spec["containers"][0]["args"][0], tb_spec["affinity"]),
            ([{"name": "logs",
               "persistentVolumeClaim": {"claimName": "nb-workspace"}}],
             [{"name": "logs", "mountPath": "/logs", "subPath": "logs"}],
             "--logdir=/logs",
             {"nodeAffinity": {
                 "requiredDuringSchedulingIgnoredDuringExecution": {
                     "nodeSelectorTerms": [{"matchExpressions": [{
                         "key": "kubernetes.io/hostname", "operator": "In",
                         "values": [node]}]}]}}}))
        front_door_expect("the Tensorboard's children", sorted(
            g.kind + "/" + o["metadata"]["name"]
            for g in (SERVICE, VIRTUALSERVICE) for o in kube.list(g, ns)
            if o["metadata"]["name"].endswith("tb")),
            ["Service/tb", f"VirtualService/tensorboard-{ns}-tb"])

        rc = cell.wait(NOTEBOOK_CELL_S)
        cell_s = time.perf_counter() - cell.t0
        out = cell.output()
        cell.stop()
        cell = None
    finally:
        if cell is not None:
            cell.stop()
        for server in servers:
            server.shutdown()
            server.server_close()
        shutil.rmtree(workspace, ignore_errors=True)
    lines = [ln[len("CELL "):] for ln in out.splitlines()
             if ln.startswith("CELL ")]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"platform_notebook: the cell exited {rc}\n"
                             + out[-6000:])
    got = json.loads(lines[0])
    ns_cell = {"__name__": "notebook_cell"}
    exec(NOTEBOOK_CELL, ns_cell)
    here = ns_cell["run"](*args)
    gc.collect()
    torch.cuda.empty_cache()
    # Each kernel of the cell against its plain version at the cell's
    # shapes: K1 over the prefill's rows and a decode step's row, K2 over
    # the prompt, K5 over the whole cache.
    cfg = LLAMA_CONFIGS[NOTEBOOK_MODEL]
    timer = Timer(torch, dev)
    timer.floor_ms = timer(torch.zeros(1, device=dev).zero_)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    scale = (1.0 + 0.1 * torch.randn(cfg.dim, generator=gen,
                                     device=dev)).float()
    kernel_rows = [
        k1_row(torch, timer, rnd(rows, cfg.dim), scale,
               f"platform_notebook {where}")
        for rows, where in ((NOTEBOOK_PROMPT, "prefill"), (1, "decode"))]
    kernel_rows.append(k2_row(
        torch, dev, rnd, timer, 1, NOTEBOOK_PROMPT, cfg.n_heads,
        cfg.n_kv_heads, cfg.head_dim, path="platform_notebook prefill"))
    kernel_rows.append(k5_row(
        torch, dev, rnd, timer, 1, NOTEBOOK_PROMPT + NOTEBOOK_NEW,
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        path="platform_notebook decode"))
    del timer
    torch.cuda.empty_cache()
    launches = notebook_launches(got["n_layers"], NOTEBOOK_NEW)
    if (got["tokens"] != here["tokens"] or len(got["tokens"][0])
            != NOTEBOOK_NEW or got["launches"] != launches
            or here["launches"] != launches
            or got["routes"] != {"kernel": got["n_layers"], "plain": 0}):
        raise AssertionError(
            f"platform_notebook: cell {got} against this process's {here}; "
            f"launches expected {launches}")

    for name in ("nb", "nb2"):
        kube.delete(NOTEBOOK, name, ns)
        reconciler.reconcile(Request(ns, name))
    kube.delete(TENSORBOARD, "tb", ns)
    left = [g.kind + "/" + o["metadata"]["name"]
            for g in (STATEFULSET, SERVICE, VIRTUALSERVICE, POD, DEPLOYMENT)
            for o in kube.list(g, ns)]
    used = kube.get(RESOURCEQUOTA, "kf-resource-quota", ns)["status"][
        "used"]
    if left or used != {"nvidia.com/gpu": "0"}:
        raise AssertionError(f"platform_notebook: after delete {left}, "
                             f"quota used {used}")
    emit({"phase": "platform_notebook", "model": NOTEBOOK_MODEL,
          "reconcile_ms": reconcile_ms, "statefulset_env": env,
          "pod_labels": pod["metadata"]["labels"],
          "second_pod_refused": refused, "status": nb_status,
          "cell_command": ["python", "-c", "<NOTEBOOK_CELL>", *args],
          "cell_exit": rc, "cell_seconds": cell_s,
          "cell_generate_ms": got["generate_ms"],
          "cell_prefill_ms": got["prefill_ms"],
          "cell_decode_step_ms": got["decode_step_ms"],
          "in_process_generate_ms": here["generate_ms"],
          "in_process_prefill_ms": here["prefill_ms"],
          "in_process_decode_step_ms": here["decode_step_ms"],
          "tokens": got["tokens"], "tokens_equal_in_process": True,
          "launches": got["launches"], "attention_routes": got["routes"],
          "kernels_against_plain": [
              {k: r[k] for k in ("kernel", "shape", "max_abs_err", "tol")}
              for r in kernel_rows],
          "cell_device": got["device"], "nvidia_smi": smi})
    statuses = collections.Counter(str(r["status"]) for r in requests_log)
    if any(r["status"] >= 500 for r in requests_log):
        raise AssertionError(f"platform_notebook: a 5xx at the front door: "
                             f"{requests_log}")
    emit({"phase": "platform_notebook", "path": "front_door_ui",
          "profile_reconcile_seconds": profile_s,
          "kfam_binding_ms": binding_ms,
          "requests_ms": {r["label"]: r["ms"] for r in requests_log},
          "spawn_to_notebook_ms": spawn_ms,
          "tensorboard_reconcile_ms": tensorboard_ms,
          "http_status_counts": dict(sorted(statuses.items())),
          "requests": len(requests_log), "nvidia_smi": smi})
    return got["launches"], got["tokens"]


def train_step_lines(out):
    """The ``train_step`` lines of a trainer's output, as dicts of floats."""
    steps = []
    for line in out.splitlines():
        if "train_step " in line:
            kv = dict(p.split("=", 1)
                      for p in line[line.index("train_step "):].split()[1:])
            steps.append({k: float(v) for k, v in kv.items()})
    return steps


def loss_limits(want):
    """MESH_LOSS_TOL, plus one unit of the sixth digit the trainer prints,
    relative to each of ``want``."""
    return [MESH_LOSS_TOL
            + 10.0 ** (math.floor(math.log10(abs(b))) - 5) / abs(b)
            for b in want]


def kernel_launch_line(out, what):
    """The trainer's ``kernel_launches`` line in ``out``: {kernel: count}."""
    for line in out.splitlines():
        if "kernel_launches " in line:
            return {k: int(v) for k, v in (
                p.split("=", 1) for p in
                line[line.index("kernel_launches "):].split()[1:])}
    raise AssertionError(f"{what}: no kernel_launches line\n{out[-3000:]}")


# The trainer's lines whose first sight a job pod's run keeps, in seconds
# from its start: the process group joined, the first step logged.
JOB_MARKS = ("devices=", "train_step ")


class JobPods:
    """The containers of the platform_job phase: ``work`` is
    ``GpuJobGangSim``'s work, one call a gang generation of a one-host
    job.  It runs the container of the sim's pod ``<job>-0`` as a
    subprocess (``kubelet_env``, ``pod_command``, ``resolve`` for the
    worker names), sends it SIGTERM when the sim sets ``stop`` (the
    StatefulSet is gone) and kills it, failing the phase, after the pod's
    ``terminationGracePeriodSeconds``; it returns when the process exits
    0 and raises otherwise, so the sim marks the pod Succeeded or Failed.
    Each run is kept in ``runs`` by (job, generation)."""

    def __init__(self, kube, ns, resolve):
        self.kube, self.ns, self.resolve = kube, ns, resolve
        self.runs = {}

    def work(self, job, generation, stop):
        from kubeflow_tpu_torch.platform.k8s.types import POD

        spec = self.kube.get(POD, f"{job}-0", self.ns)["spec"]
        container = spec["containers"][0]
        pod = Pod(pod_command(container["command"]),
                  kubelet_env(container, 0, self.resolve),
                  f"platform_job {job}-0 generation {generation}")
        run = self.runs[(job, generation)] = {
            "pod": pod, "rc": None, "sigterm_at": None, "exit_at": None,
            "grace": spec["terminationGracePeriodSeconds"], "seen_s": {}}
        while True:
            rc = pod.proc.poll()
            now = time.perf_counter()
            if rc is not None:
                break
            out = pod.output()
            for mark in JOB_MARKS:
                if mark not in run["seen_s"] and mark in out:
                    run["seen_s"][mark] = now - pod.t0
            if stop.is_set() and run["sigterm_at"] is None:
                pod.proc.send_signal(signal.SIGTERM)
                run["sigterm_at"] = now
            if (run["sigterm_at"] is not None
                    and now - run["sigterm_at"] > run["grace"]):
                os.killpg(pod.proc.pid, signal.SIGKILL)
                pod.fail(f"killed, still running {run['grace']} s after "
                         "SIGTERM")
            if now - pod.t0 > PLATFORM_JOB_S:
                pod.fail(f"still running after {PLATFORM_JOB_S} s")
            time.sleep(0.1)
        run.update(exit_at=now, wall_s=now - pod.t0, output=pod.output())
        run["rc"] = pod.stop()
        if rc != 0:
            raise AssertionError(f"{pod.what} exited {rc}\n"
                                 + run["output"][-6000:])

    def close(self):
        """Stop every process still running (a phase that failed)."""
        for run in list(self.runs.values()):
            if run["rc"] is None:
                run["rc"] = run["pod"].stop()


def phase_platform_job(torch, mesh_losses):
    """The job controller around this card (the docstring's 11b): GPUJob
    ``train`` reconciled by ``GPUJobReconciler`` into its gang, preempted
    by GPUJob ``urgent`` in two phases, resumed from its checkpoint; this
    process runs the controller, its queue and ``FakeKube``, and
    ``GpuJobGangSim`` plays the kubelet with ``JobPods``'s work; the pods
    train on the card.  Returns the pods' launch counts, summed."""
    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.platform import (
        FakeKube,
        GPUJobReconciler,
        GpuJobGangSim,
        Request,
    )
    from kubeflow_tpu_torch.platform.apis import gpujob as jobapi
    from kubeflow_tpu_torch.platform.gpu import ACCELERATORS, pods
    from kubeflow_tpu_torch.platform.k8s import quota
    from kubeflow_tpu_torch.platform.k8s.types import (
        GPUJOB,
        RESOURCEQUOTA,
        SERVICE,
        STATEFULSET,
    )
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    ns = "smoke"
    smi = nvidia_smi_name_power()
    acc = ACCELERATORS[PLATFORM_ACCELERATOR]
    card = smi.split(",")[0].strip()
    if acc.product != card.replace(" ", "-"):
        raise AssertionError(f"{PLATFORM_ACCELERATOR}'s product "
                             f"{acc.product!r} is not this card, {card!r}")
    kube = FakeKube()
    kube.add_namespace(ns)
    kube.add_gpu_node("gpu-0", accelerator=PLATFORM_ACCELERATOR, gpus=1)
    kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                 "metadata": {"name": "gpus", "namespace": ns},
                 "spec": {"hard": {"requests.nvidia.com/gpu": "1"}}})

    def gpujob(name, priority, steps, checkpoint_dir=None):
        argv = list(MESH_ARGS)
        argv[argv.index("--steps") + 1] = str(steps)
        job = {"apiVersion": "kubeflow.org/v1alpha1", "kind": "GPUJob",
               "metadata": {"name": name, "namespace": ns},
               "spec": {"gpu": {"accelerator": PLATFORM_ACCELERATOR,
                                "gpus": 1},
                        "priority": priority,
                        "template": {"spec": {"containers": [{
                            "name": "trainer", "image": "kubeflow-tpu-torch",
                            "command": ["python", "-m",
                                        "kubeflow_tpu_torch.train.run",
                                        *argv]}]}}}}
        if checkpoint_dir:
            job["spec"]["checkpointDir"] = checkpoint_dir
        kube.create(job)

    rec = GPUJobReconciler(kube)
    reconcile_ms = []

    def reconcile(*names):
        for name in names:
            t0 = time.perf_counter()
            rec.reconcile(Request(ns, name))
            reconcile_ms.append((time.perf_counter() - t0) * 1e3)

    def status(name):
        return kube.get(GPUJOB, name, ns).get("status") or {}

    worker0 = "train-0.train-workers.smoke.svc.cluster.local"
    urgent0 = "urgent-0.urgent-workers.smoke.svc.cluster.local"
    jobs = JobPods(kube, ns, {worker0: "127.0.0.1", urgent0: "127.0.0.1"})
    sim = GpuJobGangSim(kube, ns, work=jobs.work)
    ckpt = tempfile.mkdtemp(prefix="platform-job-", dir=checkpoint_root())

    def wait_until(cond, what, names, check=None):
        """Every 0.1 s: fail on a pod's failure, ``check()``, and end on
        ``cond()``; reconcile ``names`` every PLATFORM_RECONCILE_S."""
        deadline = time.perf_counter() + PLATFORM_JOB_S
        next_reconcile = 0.0
        while True:
            if sim.errors:
                raise sim.errors[0]
            if check is not None:
                check()
            if cond():
                return
            if time.perf_counter() >= next_reconcile:
                reconcile(*names)
                next_reconcile = time.perf_counter() + PLATFORM_RECONCILE_S
                if cond():
                    return
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"platform_job: no {what} within {PLATFORM_JOB_S} s: "
                    + json.dumps({n: status(n) for n in names}))
            time.sleep(0.1)

    try:
        gpujob("train", 100, PLATFORM_JOB_TOTAL_STEPS, ckpt)
        reconcile("train")
        sts = kube.get(STATEFULSET, "train", ns)
        pod_spec = sts["spec"]["template"]["spec"]
        main = pod_spec["containers"][0]
        env = {e["name"]: e.get("value") for e in main["env"]}
        one = {"nvidia.com/gpu": "1"}
        if (sts["spec"]["replicas"] != 1
                or main["resources"] != {"limits": one, "requests": one}
                or pod_spec["nodeSelector"]
                != {"nvidia.com/gpu.product": acc.product,
                    "nvidia.com/gpu.count": "1"}
                or main["command"][:len(pods.LAUNCHER)] != pods.LAUNCHER
                or env.get("KFT_CHECKPOINT_DIR") != ckpt
                or pod_spec["terminationGracePeriodSeconds"]
                != pods.JOB_GRACE_S
                or rec.preemption_grace != pods.JOB_GRACE_S):
            raise AssertionError(f"platform_job: StatefulSet {sts}")
        kube.get(SERVICE, "train-workers", ns)
        gen0 = ("train", 0)
        wait_until(lambda: status("train").get("phase") == "Running",
                   "Running train", ["train"])
        if status("train").get("allocatedSlices") != 1:
            raise AssertionError(f"platform_job: {status('train')}")
        trigger = f"train_step step={PLATFORM_JOB_STEPS} "
        wait_until(lambda: gen0 in jobs.runs
                   and trigger in jobs.runs[gen0]["pod"].output(),
                   f"step {PLATFORM_JOB_STEPS} of train", ["train"])

        # The preemption: urgent waits while train drains.
        gpujob("urgent", 200, PLATFORM_URGENT_STEPS)
        reconcile("urgent", "train")
        held = (status("urgent").get("phase"), status("train").get("phase"),
                status("train").get("reason"))
        if held != ("Queued", "Preempting", "Preempted") or \
                kube.list(STATEFULSET, ns):
            raise AssertionError(f"platform_job: preemption {held}")
        preempted_at = status("train")["preemption"]["at"]
        freed = {}

        def drain_check():
            if jobs.runs[gen0]["rc"] is None and (
                    status("urgent").get("allocatedSlices") is not None
                    or status("train").get("phase") != "Preempting"):
                raise AssertionError(
                    "platform_job: train's GPU freed while its pod drains: "
                    + json.dumps([status("train"), status("urgent")]))
            if not freed and status("train").get("phase") == "Queued":
                freed.update(status=status("train"), at=time.time())

        wait_until(lambda: status("urgent").get("allocatedSlices") == 1,
                   "admission of urgent", ["urgent", "train"], drain_check)
        victim = jobs.runs[gen0]
        drain_s = victim["exit_at"] - victim["sigterm_at"]
        if (victim["rc"] != 0 or drain_s >= victim["grace"]
                or freed["status"].get("reason") != "Preempted"
                or freed["at"] - preempted_at >= rec.preemption_grace):
            raise AssertionError(
                f"platform_job: drain exit {victim['rc']} in {drain_s} s, "
                f"freed {freed}\n" + victim["output"][-6000:])

        # The preemptor, then the resume.
        wait_until(lambda: status("urgent").get("phase") == "Succeeded",
                   "urgent's end", ["urgent", "train"])
        urgent = jobs.runs[("urgent", 0)]
        urgent_losses = [st["loss"] for st in
                         train_step_lines(urgent["output"])]
        wait_until(lambda: status("train").get("phase") == "Succeeded",
                   "train's end", ["train", "urgent"])
        gen1 = jobs.runs[("train", 1)]
        used = kube.get(RESOURCEQUOTA, "gpus", ns)["status"]["used"]
        stopped = [int(ln.split()[3].rstrip(":"))
                   for ln in victim["output"].splitlines()
                   if ln.startswith("preempted at step ")
                   and ln.endswith(": checkpoint saved")]
        at = stopped[0] if len(stopped) == 1 else None
        before = [st["loss"] for st in train_step_lines(victim["output"])]
        resumed = train_step_lines(gen1["output"])
        mesh_at = {i + 1: b for i, b in enumerate(mesh_losses)}
        held = ([(i + 1, a) for i, a in enumerate(before)]
                + [(int(st["step"]), st["loss"]) for st in resumed])
        held = [(step, a, mesh_at[step]) for step, a in held
                if step in mesh_at]
        held += [(i + 1, a, mesh_at[i + 1])
                 for i, a in enumerate(urgent_losses)]
        rel = [abs(a - b) / abs(b) for _, a, b in held]
        limits = loss_limits([b for _, _, b in held])
        steps_on_disk = CheckpointManager(ckpt).all_steps()
        if (at is None or at < PLATFORM_JOB_STEPS or len(before) != at
                or at >= len(mesh_losses)
                or [int(st["step"]) for st in resumed]
                != list(range(at + 1, PLATFORM_JOB_TOTAL_STEPS + 1))
                or len(urgent_losses) != PLATFORM_URGENT_STEPS
                or urgent["rc"] != 0 or gen1["rc"] != 0
                or any(r > t for r, t in zip(rel, limits))
                or f"done: step {PLATFORM_JOB_TOTAL_STEPS}"
                not in gen1["output"]
                or status("train").get("generation") != 1
                or steps_on_disk != [at, PLATFORM_JOB_TOTAL_STEPS]
                or kube.list(STATEFULSET, ns)
                or quota.parse_quantity(
                    used.get("requests.nvidia.com/gpu", 0)) != 0):
            raise AssertionError(
                f"platform_job: stopped at {stopped}, losses {before} then "
                f"{resumed}, urgent {urgent_losses}, against the mesh "
                f"phase's {mesh_losses} ({rel}), checkpoint steps "
                f"{steps_on_disk}, quota used {used}, train "
                f"{status('train')}\n" + gen1["output"][-6000:])
        # Each pod's trainer launched its kernels exactly a step's worth
        # for each step it ran.
        per_step = train_launches_per_step(CONFIGS[TRAIN_MODEL])
        runs_launches, launches = {}, {}
        for what, run, n in (("train_0", victim, at),
                             ("urgent_0", urgent, PLATFORM_URGENT_STEPS),
                             ("train_1", gen1,
                              PLATFORM_JOB_TOTAL_STEPS - at)):
            got = kernel_launch_line(run["output"], f"platform_job {what}")
            want = {k: c * n for k, c in per_step.items()}
            if got != want:
                raise AssertionError(f"platform_job: {what} launched {got}, "
                                     f"expected {want}")
            runs_launches[what] = got
            for k, c in got.items():
                launches[k] = launches.get(k, 0) + c
        saves = {}
        for what, run in (("preempted", victim), ("resumed", gen1)):
            lines = [ln[ln.index("checkpoint step="):]
                     for ln in run["output"].splitlines()
                     if "checkpoint step=" in ln]
            kv = dict(p.split("=", 1) for p in lines[-1].split()[1:])
            saves[what] = {k: float(v) for k, v in kv.items()}
        emit({"phase": "platform_job", "model": TRAIN_MODEL,
              "command": main["command"], "run_as":
              pod_command(main["command"]),
              "env": {e["name"]: e.get("value", e.get("valueFrom"))
                      for e in main["env"]},
              "termination_grace_seconds": pods.JOB_GRACE_S,
              "launcher_shutdown_timeout_seconds":
              pods.JOB_GRACE_S - pods.JOB_KILL_MARGIN_S,
              "resolved": {worker0: "127.0.0.1", urgent0: "127.0.0.1"},
              "reconcile_ms": reconcile_ms,
              "reconciles": len(reconcile_ms),
              "reconcile_ms_median": statistics.median(reconcile_ms),
              "sigterm_after_step": PLATFORM_JOB_STEPS,
              "stopped_at_step": at, "exit_code": victim["rc"],
              "drain_seconds": drain_s,
              "grace_seconds": victim["grace"],
              "reference_grace_seconds": PREEMPTION_GRACE_S,
              "drain_over_reference_grace": drain_s > PREEMPTION_GRACE_S,
              "freed_after_preemption_seconds": freed["at"] - preempted_at,
              "freed_by": "pod exit",
              "checkpoint": saves,
              "snapshot_seconds": saves["preempted"]["snapshot_seconds"],
              "write_seconds": saves["preempted"]["write_seconds"],
              "urgent_losses": urgent_losses,
              "urgent_wall_seconds": urgent["wall_s"],
              "train_losses": before + [st["loss"] for st in resumed],
              "resumed_at_step": int(resumed[0]["step"]),
              "resumed_generation": status("train")["generation"],
              "resumed_seconds_to_first_step": gen1["seen_s"]["train_step "],
              "seconds_to_line_by_pod": {
                  what: run["seen_s"] for what, run in (
                      ("train_0", victim), ("urgent_0", urgent),
                      ("train_1", gen1))},
              "resumed_wall_seconds": gen1["wall_s"],
              "mesh_phase_losses": mesh_losses,
              "held_steps": [step for step, _, _ in held],
              "loss_rel_diff": rel, "loss_tol": MESH_LOSS_TOL,
              "step_seconds": [st["step_seconds"] for st in
                               train_step_lines(victim["output"])
                               + resumed],
              "checkpoint_steps": steps_on_disk,
              "launches": launches, "launches_by_pod": runs_launches,
              "launches_per_step": per_step,
              "quota_used_after": used,
              "phases": {n: status(n)["phase"] for n in ("train",
                                                         "urgent")},
              "nvidia_smi": smi})
    finally:
        jobs.close()
        sim.close()
        shutil.rmtree(ckpt, ignore_errors=True)
    return launches


def gpu_pids():
    """The pids nvidia-smi lists as compute processes on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return {int(p) for p in out.split() if p.strip().isdigit()}


def wire_snapshot(metrics, codec):
    """The wire's counters now: requests by (verb, kind, code), retries by
    verb, the request-duration histograms by verb, the codec's counts."""
    from kubeflow_tpu_torch.telemetry.metrics import histogram_snapshot

    requests = metrics.rest_client_requests_total.values()
    retries = {k[0]: n for k, n in
               metrics.rest_client_retries_total.values().items()}
    verbs = {k[0] for k in requests}
    return {"requests": requests, "retries": retries,
            "durations": {v: histogram_snapshot(
                metrics.rest_client_request_duration_seconds, {"verb": v})
                for v in verbs},
            "codec": codec.stats()}


def watchers_of(mgr, informer_kinds):
    """The watchers of each kind: every informer that ran
    (``informer_kinds``, a shared one once), and one watch loop for each
    source kind of a controller that has no informer for it."""
    watchers = {}
    for kind in informer_kinds:
        watchers[kind] = watchers.get(kind, 0) + 1
    for c in mgr.controllers:
        for gvk in [c.primary, *c.owns, *(g for g, _ in c.watches)]:
            if gvk not in c.informers:
                watchers[gvk.kind] = watchers.get(gvk.kind, 0) + 1
    return watchers


def wire_checks(metrics, codec, native, mgr, client, before, patch_routes,
                informer_kinds):
    """The manager phase's checks of the wire, read after the flow; returns
    what the phase prints of it."""
    from kubeflow_tpu_torch.telemetry.metrics import histogram_quantiles

    after = wire_snapshot(metrics, codec)
    requests = {k: v - before["requests"].get(k, 0)
                for k, v in after["requests"].items()
                if v - before["requests"].get(k, 0)}
    by_verb, by_code, watches = {}, {}, {}
    for (verb, kind, code), n in requests.items():
        by_verb[verb] = by_verb.get(verb, 0) + n
        by_code[code] = by_code.get(code, 0) + n
        if verb == "watch" and code == "200":
            watches[kind] = watches.get(kind, 0) + n
    retries = {v: n - before["retries"].get(v, 0)
               for v, n in after["retries"].items()
               if n - before["retries"].get(v, 0)}
    quantiles = {v: histogram_quantiles(
        metrics.rest_client_request_duration_seconds, {"verb": v},
        since=before["durations"].get(v)) for v in by_verb}
    stats = {k: v - before["codec"][k] for k, v in after["codec"].items()}
    watchers = watchers_of(mgr, informer_kinds)
    queues = {c.name: type(c.queue).__name__ for c in mgr.controllers}
    page = metrics.render()
    components = {c: f'native_engine_active{{component="{c}"}} 1.0' in page
                  for c in native.ENGINE_COMPONENTS}
    lease_writes = sum(n for (verb, kind, code), n in requests.items()
                       if kind == "Lease" and verb in ("create", "update")
                       and code in ("200", "201"))
    bad_codes = {c: n for c, n in by_code.items()
                 if c in ("<error>", "<circuit-open>") or c.startswith("5")}
    missing = [v for v in ("get", "list", "watch", "create")
               if not by_verb.get(v)]
    if not (by_verb.get("update") or by_verb.get("patch")
            or by_verb.get("patch_status")):
        missing.append("update or patch")
    short = {k: (watches.get(k, 0), n) for k, n in watchers.items()
             if watches.get(k, 0) < 3 * n}
    problems = []
    if missing:
        problems.append(f"verbs never sent: {missing}")
    if bad_codes:
        problems.append(f"failed requests: {bad_codes}")
    if retries:
        problems.append(f"retries: {retries}")
    if client.health()["circuit"] != "closed":
        problems.append(f"circuit: {client.health()}")
    if short:
        problems.append(f"watches established fewer than 3 times a watcher "
                        f"(established, watchers): {short}")
    if not (stats["decode_native"] > 0 and stats["decode_python"] == 0
            and stats["materialize"] <= stats["decode_native"]):
        problems.append(f"codec: {stats}")
    if set(queues.values()) != {"NativeWorkQueue"}:
        problems.append(f"queues: {queues}")
    if not all(components.values()):
        problems.append(f"engine components on /metrics: {components}")
    if patch_routes != {"native": 1, "python": 0}:
        problems.append(f"admission patch routes: {patch_routes}")
    if not lease_writes:
        problems.append("the Lease was never written over the wire")
    if problems:
        raise AssertionError("platform_manager over the wire: "
                             + "; ".join(problems))
    return {"requests_by_verb": by_verb, "requests_by_code": by_code,
            "request_seconds_p50_p99": {
                v: [q[0.5], q[0.99]] for v, q in quantiles.items()},
            "watches_by_kind": watches, "watchers_by_kind": watchers,
            "watch_resumes_by_kind": {k: watches.get(k, 0) - n
                                      for k, n in watchers.items()},
            "retries": retries, "circuit": client.health(),
            "codec": stats, "queues": queues,
            "engine": {"components": components,
                       "backend": native.backend_info()},
            "admission_patch_routes": patch_routes,
            "lease_writes": lease_writes}


def phase_platform_manager(torch, dev, mesh_losses):
    """The controller runtime around this card (the docstring's 11c): one
    leader-elected ``Manager`` runs the notebook, culling and job
    controllers from watches; the notebook's pod runs the cell on the
    card behind the stand-in kernels API and goes idle; the culler stops
    it; its pod leaves the card; GPUJob ``train``, Queued behind it, is
    admitted and trains on the same card.  Returns the two pods' launch
    counts, summed."""
    from kubeflow_tpu_torch.models.llama import CONFIGS as LLAMA_CONFIGS
    from kubeflow_tpu_torch.platform import (
        FakeKube,
        GpuJobGangSim,
        Manager,
        codec,
        culling_controller,
        default_prober,
        gpu_pod_default,
        gpujob_controller,
        make_transport,
        native,
        notebook_controller,
    )
    from kubeflow_tpu_torch.platform.apis import gpujob as jobapi
    from kubeflow_tpu_torch.platform.apis import notebook as nbapi
    from kubeflow_tpu_torch.platform.gpu import ACCELERATORS
    from kubeflow_tpu_torch.platform.k8s import quota
    from kubeflow_tpu_torch.platform.k8s.types import (
        GPUJOB,
        LEASE,
        NOTEBOOK,
        POD,
        RESOURCEQUOTA,
        SERVICE,
        STATEFULSET,
    )
    from kubeflow_tpu_torch.platform.runtime import jobqueue, metrics
    from kubeflow_tpu_torch.platform.webhook import jsonpatch

    smi = nvidia_smi_name_power()
    acc = ACCELERATORS[PLATFORM_ACCELERATOR]
    card = smi.split(",")[0].strip()
    if acc.product != card.replace(" ", "-"):
        raise AssertionError(f"{PLATFORM_ACCELERATOR}'s product "
                             f"{acc.product!r} is not this card, {card!r}")
    ns, label = "smoke", f"gpu-{PLATFORM_ACCELERATOR}"
    kube = FakeKube()
    kube.add_namespace("kubeflow")   # the leader's Lease
    kube.add_namespace(ns)
    kube.add_gpu_node("gpu-node-0", accelerator=PLATFORM_ACCELERATOR,
                      gpus=1)
    kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                 "metadata": {"name": "gpus", "namespace": ns},
                 "spec": {"hard": {"requests.nvidia.com/gpu": "1"}}})
    kube.create(gpu_pod_default(ns, PLATFORM_ACCELERATOR, 1))

    # The prober is the port's own, behind a map that sends the culler's
    # cluster-DNS URL to the pod's local port.
    port = free_port()
    probes = {"busy": 0, "idle": 0, "none": 0}
    urls = {}

    def prober(url):
        kernels = default_prober(urls.get(url, url), timeout=2.0)
        state = ("none" if not kernels
                 else kernels[0].get("execution_state"))
        probes[state] = probes.get(state, 0) + 1
        return kernels

    culled_before = metrics.notebook_culling_total.sample()
    dead_before = {c: metrics.reconcile_dead_letter_total.sample(
        controller=c) or 0 for c in ("notebook-controller",
                                     "culling-controller",
                                     "gpujob-controller")}
    restarts = metrics.informer_watch_restarts_total
    restarts_before = sum(v for v in (restarts.sample(kind=k) or 0 for k in (
        "Notebook", "Pod", "StatefulSet", "Service", "PodDisruptionBudget",
        "Event", "VirtualService", "GPUJob", "ResourceQuota", "Node",
        "InferenceService")))

    # The controllers' side of the wire: FakeKube served over HTTP, the
    # port's REST client.  The stand-ins for the kubelet and the
    # StatefulSet controller play the cluster's side on ``kube`` itself.
    wire_before = wire_snapshot(metrics, codec)
    client, server = make_transport(kube, "http",
                                    watch_window=MANAGER_WATCH_WINDOW_S)
    mgr = Manager(client, leader_election=True)
    nb_ctrl = mgr.add(notebook_controller(client, use_istio=True,
                                          mirror_min_interval=0))
    cull_ctrl = mgr.add(culling_controller(
        client, notebook_informer=nb_ctrl.informers[NOTEBOOK],
        prober=prober, idle_minutes=PLATFORM_IDLE_MINUTES,
        check_period_minutes=PLATFORM_CHECK_MINUTES))
    job_ctrl = mgr.add(gpujob_controller(client))
    culler = cull_ctrl.reconciler
    urls[culler.kernels_url(ns, "nb")] = (
        f"http://127.0.0.1:{port}{nbapi.nb_prefix(ns, 'nb')}/api/kernels")
    worker0 = f"train-0.train-workers.{ns}.svc.cluster.local"
    jobs = JobPods(kube, ns, {worker0: "127.0.0.1"})
    sim = None
    cell = None
    t_start = time.perf_counter()

    def wait_until(cond, what, timeout, check=None):
        deadline = time.perf_counter() + timeout
        while True:
            if sim is not None and sim.errors:
                raise sim.errors[0]
            if check is not None:
                check()
            got = cond()
            if got:
                return got
            if time.perf_counter() > deadline:
                raise AssertionError(f"platform_manager: no {what} within "
                                     f"{timeout} s")
            time.sleep(0.05)

    def job_status():
        return kube.get(GPUJOB, "train", ns).get("status") or {}

    def annotations():
        return kube.get(NOTEBOOK, "nb", ns)["metadata"].get(
            "annotations") or {}

    try:
        mgr.start()
        wait_until(lambda: mgr.is_leader, "leadership", 30)
        leader_s = time.perf_counter() - t_start
        holder = kube.get(LEASE, "kubeflow-tpu-controller-leader",
                          "kubeflow")["spec"]["holderIdentity"]
        children = [g.kind for g in (STATEFULSET, SERVICE, POD)
                    if kube.list(g, ns)]
        if holder != mgr.elector.identity or children:
            raise AssertionError(f"platform_manager: lease holder {holder} "
                                 f"against {mgr.elector.identity}, "
                                 f"children {children}")

        # The notebook: the controller writes its StatefulSet from the
        # watch; the phase plays the StatefulSet controller and the kubelet.
        kube.create({
            "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": "nb", "namespace": ns},
            "spec": {"gpu": {"accelerator": PLATFORM_ACCELERATOR, "gpus": 1},
                     "template": {"spec": {"containers": [{
                         "name": "nb", "image": "kubeflow-tpu-torch",
                         "ports": [{"containerPort": 8888}]}]}}}})
        sts = wait_until(
            lambda: next((s for s in kube.list(STATEFULSET, ns)
                          if s["spec"]["replicas"] == 1), None),
            "notebook StatefulSet", 30)
        patches = dict(jsonpatch.routes)
        pod = notebook_pod(kube, ns, sts, label, "platform_manager")
        patch_routes = {k: v - patches[k] for k, v in
                        jsonpatch.routes.items()}
        # The kubelet's hold: a deleted pod stays, terminating, until its
        # process has exited (graceful deletion).
        pod["metadata"]["finalizers"] = [KUBELET_FINALIZER]
        kube.create(pod)
        main = pod["spec"]["containers"][0]
        args = [NOTEBOOK_MODEL, str(SEED), str(NOTEBOOK_PROMPT),
                str(NOTEBOOK_NEW), dev.type]
        cell = Pod([sys.executable, "-c", NOTEBOOK_KERNELS, str(port),
                    *args], kubelet_env(main, 0), "platform_manager cell")
        wait_until(lambda: cell.proc.poll() is not None
                   or "SERVING" in cell.output(), "kernels API", 120)
        if cell.proc.poll() is not None:
            cell.fail("exited before serving")
        kube.set_pod_phase(ns, "nb-0", "Running", ready=True)

        # The queued job: the notebook holds the quota's one GPU.
        argv = list(MESH_ARGS)
        argv[argv.index("--steps") + 1] = str(MANAGER_JOB_STEPS)
        kube.create({
            "apiVersion": "kubeflow.org/v1alpha1", "kind": "GPUJob",
            "metadata": {"name": "train", "namespace": ns},
            "spec": {"gpu": {"accelerator": PLATFORM_ACCELERATOR, "gpus": 1},
                     "template": {"spec": {"containers": [{
                         "name": "trainer", "image": "kubeflow-tpu-torch",
                         "command": ["python", "-m",
                                     "kubeflow_tpu_torch.train.run",
                                     *argv]}]}}}})
        queued = wait_until(lambda: job_status().get("phase") == "Queued"
                            and job_status(), "Queued train", 30)
        depth = metrics.gpujob_queue_depth.sample(profile=ns)
        if (queued.get("reason") != jobqueue.REASON_QUOTA or depth != 1
                or kube.list(STATEFULSET, ns, label_selector={
                    jobapi.LABEL_GPUJOB_NAME: "train"})):
            raise AssertionError(f"platform_manager: train {queued}, "
                                 f"queue depth {depth}")
        sim = GpuJobGangSim(kube, ns, work=jobs.work)

        # While the cell runs: no stop, and the last activity moves.
        activity, pid_listed = set(), None

        def busy_check():
            nonlocal pid_listed
            ann = annotations()
            if nbapi.STOP_ANNOTATION in ann:
                raise AssertionError("platform_manager: the notebook was "
                                     f"stopped while its cell ran: {ann}")
            if nbapi.LAST_ACTIVITY_ANNOTATION in ann:
                activity.add(ann[nbapi.LAST_ACTIVITY_ANNOTATION])
            if pid_listed is None and "CELL " in cell.output():
                pid_listed = cell.proc.pid in gpu_pids()
            if cell.proc.poll() is not None:
                cell.fail(f"exited {cell.proc.returncode} during the cell")

        wait_until(lambda: "CELL " in cell.output(), "cell", NOTEBOOK_CELL_S,
                   busy_check)
        busy_check()
        cell_s = time.perf_counter() - cell.t0
        got = json.loads(next(ln[len("CELL "):] for ln in
                              cell.output().splitlines()
                              if ln.startswith("CELL ")))
        if len(activity) < 2:
            raise AssertionError("platform_manager: the last activity did "
                                 f"not move while the cell ran: {activity}")

        # The cull: within the idle window plus two check periods of the
        # kernel's last activity, then the scale to 0 through the watch.
        window = (PLATFORM_IDLE_MINUTES + 2 * PLATFORM_CHECK_MINUTES) * 60
        wait_until(lambda: nbapi.STOP_ANNOTATION in annotations(), "cull",
                   window + 30)
        stopped_at = time.time()
        cull_s = stopped_at - got["cell_end"]
        if not PLATFORM_IDLE_MINUTES * 60 <= cull_s <= window:
            raise AssertionError(f"platform_manager: culled {cull_s} s after "
                                 f"the last activity, outside "
                                 f"[{PLATFORM_IDLE_MINUTES * 60}, {window}]")
        wait_until(lambda: kube.get(STATEFULSET, "nb", ns)["spec"][
            "replicas"] == 0, "scale to 0", 30)
        if job_status().get("phase") != "Queued":
            raise AssertionError(f"platform_manager: {job_status()}")

        # The pod leaves: deleted (terminating), SIGTERM, its exit, then
        # the kubelet lets the object go; the card and the quota free.
        kube.delete(POD, "nb-0", ns)
        cell_pid = cell.proc.pid
        cell_rc = cell.stop()
        exited_at = time.time()
        cell, exit_s = None, exited_at - stopped_at
        if cell_rc != 0:
            raise AssertionError(f"platform_manager: the notebook pod "
                                 f"exited {cell_rc}")
        terminating = kube.get(POD, "nb-0", ns)
        terminating["metadata"]["finalizers"] = []
        kube.update(terminating)
        used = kube.get(RESOURCEQUOTA, "gpus", ns)["status"]["used"]
        if quota.parse_quantity(used.get("requests.nvidia.com/gpu", 0)):
            raise AssertionError(f"platform_manager: quota used {used}")
        wait_until(lambda: cell_pid not in gpu_pids(),
                   "pid gone from nvidia-smi", 10)

        # The job: admitted within its poll plus one reconcile, then its
        # gang trains on the card.
        admit_limit = max(job_ctrl.reconciler.queue_poll, 2.0) \
            + PLATFORM_RECONCILE_S
        wait_until(lambda: job_status().get("allocatedSlices") == 1,
                   "admission of train", admit_limit)
        admitted_at = time.perf_counter()
        admit_s = time.time() - exited_at
        wait_until(lambda: kube.list(STATEFULSET, ns, label_selector={
            jobapi.LABEL_GPUJOB_NAME: "train"}), "train's gang", 30)
        wait_until(lambda: job_status().get("phase") == "Succeeded",
                   "train's end", PLATFORM_JOB_S)
        run = jobs.runs[("train", 0)]
        first_step_s = (run["pod"].t0 + run["seen_s"]["train_step "]
                        - admitted_at)
        losses = [st["loss"] for st in train_step_lines(run["output"])]
        want = mesh_losses[:MANAGER_JOB_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        if (run["rc"] != 0 or len(losses) != MANAGER_JOB_STEPS
                or any(r > t for r, t in zip(rel, loss_limits(want)))):
            raise AssertionError(
                f"platform_manager: train exited {run['rc']}, losses "
                f"{losses} against the mesh phase's {want} ({rel})\n"
                + run["output"][-6000:])

        # Exact launches: the cell's a generate's, the worker's a step's
        # for each step.
        cell_want = notebook_launches(got["n_layers"], NOTEBOOK_NEW)
        per_step = train_launches_per_step(LLAMA_CONFIGS[TRAIN_MODEL])
        job_got = kernel_launch_line(run["output"], "platform_manager train")
        job_want = {k: c * MANAGER_JOB_STEPS for k, c in per_step.items()}
        if (got["launches"] != cell_want or job_got != job_want
                or got["routes"] != {"kernel": got["n_layers"],
                                     "plain": 0}):
            raise AssertionError(
                f"platform_manager: launches {got['launches']} (cell, "
                f"expected {cell_want}) and {job_got} (train, expected "
                f"{job_want}), routes {got['routes']}")
        # The kinds of the informers that ran, read while they run.
        informer_kinds = [i.gvk.kind for i in metrics.running_informers()]
    finally:
        mgr.stop()
        server.stop()
        jobs.close()
        if sim is not None:
            sim.close()
        if cell is not None:
            cell.stop()
    wire = wire_checks(metrics, codec, native, mgr, client, wire_before,
                       patch_routes, informer_kinds)

    # Teardown: the controllers stopped, their hooks unhooked, and the
    # counters agree with what happened.
    deadline = time.monotonic() + 10
    while any(t.is_alive() for c in mgr.controllers for t in c._threads) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    alive = [t.name for c in mgr.controllers for t in c._threads
             if t.is_alive()]
    culled = metrics.notebook_culling_total.sample() - culled_before
    dead = {c: (metrics.reconcile_dead_letter_total.sample(controller=c)
                or 0) - n for c, n in dead_before.items()}
    watch_restarts = sum(v for v in (restarts.sample(kind=k) or 0 for k in (
        "Notebook", "Pod", "StatefulSet", "Service", "PodDisruptionBudget",
        "Event", "VirtualService", "GPUJob", "ResourceQuota", "Node",
        "InferenceService"))) - restarts_before
    if (not all(c.stopped for c in mgr.controllers) or alive
            or mgr.is_leader or jobqueue.debug_snapshot() is not None
            or metrics._fleet_collector.client is not None
            or metrics._gpujob_collector.client is not None
            or culled != 1 or any(dead.values()) or watch_restarts):
        raise AssertionError(
            f"platform_manager: after stop, threads {alive}, leader "
            f"{mgr.is_leader}, culled {culled}, dead letters {dead}, watch "
            f"restarts {watch_restarts}")
    queues = {c.name: {
        "adds": metrics.workqueue_adds_total.sample(name=c.name),
        "retries": metrics.workqueue_retries_total.sample(name=c.name) or 0}
        for c in mgr.controllers}

    # Each kernel of the cell against its plain version at its shapes.
    cfg = LLAMA_CONFIGS[NOTEBOOK_MODEL]
    timer = Timer(torch, dev)
    timer.floor_ms = timer(torch.zeros(1, device=dev).zero_)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    scale = (1.0 + 0.1 * torch.randn(cfg.dim, generator=gen,
                                     device=dev)).float()
    kernel_rows = [
        k1_row(torch, timer, rnd(rows, cfg.dim), scale,
               f"platform_manager {where}")
        for rows, where in ((NOTEBOOK_PROMPT, "prefill"), (1, "decode"))]
    kernel_rows.append(k2_row(
        torch, dev, rnd, timer, 1, NOTEBOOK_PROMPT, cfg.n_heads,
        cfg.n_kv_heads, cfg.head_dim, path="platform_manager prefill"))
    kernel_rows.append(k5_row(
        torch, dev, rnd, timer, 1, NOTEBOOK_PROMPT + NOTEBOOK_NEW,
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        path="platform_manager decode"))
    del timer
    torch.cuda.empty_cache()
    launches = {k: got["launches"][k] + job_got[k] for k in job_got}
    emit({"phase": "platform_manager", "lease_holder": holder,
          "seconds_to_leadership": leader_s,
          "reconciles": {c.name: c.reconcile_count for c in mgr.controllers},
          "workqueues": queues,
          "cell_seconds": cell_s, "cell_generate_ms": got["generate_ms"],
          "probes": probes,
          "last_activity_stamps_while_busy": len(activity),
          "idle_minutes": PLATFORM_IDLE_MINUTES,
          "check_period_minutes": PLATFORM_CHECK_MINUTES,
          "seconds_last_activity_to_stop": cull_s,
          "seconds_stop_to_pod_exit": exit_s,
          "seconds_exit_to_admission": admit_s,
          "admission_limit_seconds": admit_limit,
          "seconds_admission_to_first_step": first_step_s,
          "cell_pid_listed_by_nvidia_smi": pid_listed,
          "quota_used_after_exit": used,
          "train_losses": losses, "mesh_phase_losses": want,
          "loss_rel_diff": rel, "loss_tol": MESH_LOSS_TOL,
          "train_wall_seconds": run["wall_s"],
          "launches_by_pod": {"cell": got["launches"], "train": job_got},
          "launches": launches, "culled": culled,
          "dead_letters": dead, "watch_restarts": watch_restarts,
          "kernels_against_plain": [
              {k: r[k] for k in ("kernel", "shape", "max_abs_err", "tol")}
              for r in kernel_rows],
          "nvidia_smi": smi})
    emit({"phase": "platform_manager_wire",
          "watch_window_s": MANAGER_WATCH_WINDOW_S, **wire,
          "seconds": {"to_leadership": leader_s, "cell": cell_s,
                      "last_activity_to_stop": cull_s,
                      "stop_to_pod_exit": exit_s,
                      "exit_to_admission": admit_s,
                      "admission_to_first_step": first_step_s,
                      "train_wall": run["wall_s"]},
          "nvidia_smi": smi})
    return launches


def phase_platform_shards(torch, dev, notebook_tokens):
    """The sharded HA control plane around this card (the docstring's
    11d): a fleet of replicas, each a ``Manager`` over its own shard
    coordinator and fenced client running the notebook controller and
    the culler; the replica that owns ``nb``'s shard is killed while the
    notebook's cell runs on the card, and a survivor takes the shard
    over while the cell runs on untouched.  Returns the cell's launch
    counts."""
    from kubeflow_tpu_torch.models.llama import CONFIGS as LLAMA_CONFIGS
    from kubeflow_tpu_torch.platform import (
        ShardedFleet,
        culling_controller,
        default_prober,
        gpu_pod_default,
        notebook_controller,
        shard_of,
    )
    from kubeflow_tpu_torch.platform.apis import notebook as nbapi
    from kubeflow_tpu_torch.platform.gpu import ACCELERATORS
    from kubeflow_tpu_torch.platform.k8s import quota
    from kubeflow_tpu_torch.platform.k8s.types import (
        LEASE,
        NOTEBOOK,
        POD,
        RESOURCEQUOTA,
        STATEFULSET,
    )
    from kubeflow_tpu_torch.platform.runtime import metrics

    smi = nvidia_smi_name_power()
    acc = ACCELERATORS[PLATFORM_ACCELERATOR]
    card = smi.split(",")[0].strip()
    if acc.product != card.replace(" ", "-"):
        raise AssertionError(f"{PLATFORM_ACCELERATOR}'s product "
                             f"{acc.product!r} is not this card, {card!r}")
    ns, label = "smoke", f"gpu-{PLATFORM_ACCELERATOR}"
    port = free_port()
    local = f"http://127.0.0.1:{port}{nbapi.nb_prefix(ns, 'nb')}/api/kernels"
    urls = {}
    probes = {}

    def prober_of(identity):
        """The culler's prober: ``nb``'s cluster-DNS URL goes to the pod's
        local port through the port's ``default_prober``; no other URL
        leaves the process (the wave's notebooks run no server: no
        answer, which the culler counts as busy)."""
        counts = probes.setdefault(identity, {"busy": 0, "idle": 0,
                                              "none": 0})

        def prober(url):
            if url not in urls:
                counts["none"] += 1
                return None
            kernels = default_prober(urls[url], timeout=2.0)
            state = ("none" if not kernels
                     else kernels[0].get("execution_state"))
            counts[state] = counts.get(state, 0) + 1
            return kernels
        return prober

    def controllers(client, *, shards):
        nb = notebook_controller(client, use_istio=False,
                                 mirror_min_interval=0, shards=shards)
        cull = culling_controller(
            client, notebook_informer=nb.informers[NOTEBOOK],
            prober=prober_of(shards.identity),
            check_period_minutes=PLATFORM_CHECK_MINUTES, shards=shards)
        urls[cull.reconciler.kernels_url(ns, "nb")] = local
        return [nb, cull]

    transitions = metrics.controller_lease_transitions_total
    reasons = ("acquire", "renew", "expire", "release", "fenced")

    def lease_counts():
        return {r: transitions.sample(controller="kubeflow-tpu-ctrlplane",
                                      reason=r) or 0 for r in reasons}

    counts_before = lease_counts()
    t_start = time.perf_counter()
    fleet = ShardedFleet(replicas=SHARD_REPLICAS, num_shards=SHARD_COUNT,
                         lease_seconds=SHARD_LEASE_S,
                         renew_seconds=SHARD_RENEW_S,
                         controller_factory=controllers,
                         gpu_nodes=SHARD_WAVE // 8)
    kube = fleet.kube
    cell = None
    wave_t0 = wave_s = None

    def wave_check():
        nonlocal wave_s
        if wave_s is None and fleet._conv_event.is_set():
            wave_s = time.perf_counter() - wave_t0

    def wait_until(cond, what, timeout, check=None):
        deadline = time.perf_counter() + timeout
        while True:
            wave_check()
            if check is not None:
                check()
            got = cond()
            if got:
                return got
            if time.perf_counter() > deadline:
                raise AssertionError(f"platform_shards: no {what} within "
                                     f"{timeout} s")
            time.sleep(0.05)

    def writes_of(r, verb, name="nb"):
        return [w for w in list(r.client.write_log)
                if w["verb"] == verb and w["kind"] == "Notebook"
                and w["namespace"] == ns and w["name"] == name]

    try:
        # The smoke namespace: one h100-80gb node of one GPU, its quota
        # and the PodDefault.
        kube.add_namespace(ns)
        kube.add_gpu_node("gpu-node-0", accelerator=PLATFORM_ACCELERATOR,
                          gpus=1)
        kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                     "metadata": {"name": "gpus", "namespace": ns},
                     "spec": {"hard": {"requests.nvidia.com/gpu": "1"}}})
        kube.create(gpu_pod_default(ns, PLATFORM_ACCELERATOR, 1))
        map_before = fleet.wait_stable_shard_map(
            timeout=4 * SHARD_LEASE_S + 15)
        settle_s = time.perf_counter() - t_start

        # The wave, then the notebook on the card.
        wave_t0 = time.perf_counter()
        fleet.create_wave(SHARD_WAVE)
        kube.create({
            "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": "nb", "namespace": ns},
            "spec": {"gpu": {"accelerator": PLATFORM_ACCELERATOR, "gpus": 1},
                     "template": {"spec": {"containers": [{
                         "name": "nb", "image": "kubeflow-tpu-torch",
                         "ports": [{"containerPort": 8888}]}]}}}})
        shard = shard_of(ns, "nb", SHARD_COUNT)
        owner = next(r for r in fleet.replicas
                     if shard in r.coordinator.owned())
        sts = wait_until(
            lambda: next((s for s in kube.list(STATEFULSET, ns)
                          if s["spec"]["replicas"] == 1), None),
            "notebook StatefulSet", 30)
        pod = notebook_pod(kube, ns, sts, label, "platform_shards")
        pod["metadata"]["finalizers"] = [KUBELET_FINALIZER]
        kube.create(pod)
        main = pod["spec"]["containers"][0]
        args = [NOTEBOOK_MODEL, str(SEED), str(NOTEBOOK_PROMPT),
                str(NOTEBOOK_NEW), dev.type]
        cell = Pod([sys.executable, "-c", NOTEBOOK_KERNELS, str(port),
                    *args], kubelet_env(main, 0), "platform_shards cell")
        wait_until(lambda: cell.proc.poll() is not None
                   or "SERVING" in cell.output(), "kernels API", 120)
        if cell.proc.poll() is not None:
            cell.fail("exited before serving")
        # The container runs; its readiness probe has not passed yet.
        kube.set_pod_phase(ns, "nb-0", "Running", ready=False)
        wait_until(lambda: (kube.get(NOTEBOOK, "nb", ns).get("status")
                            or {}).get("replicas") == 1,
                   "the owner's status of nb", 30)
        sts_uid = kube.get(STATEFULSET, "nb", ns)["metadata"]["uid"]
        pod_uid = kube.get(POD, "nb-0", ns)["metadata"]["uid"]

        # The kill, once the kernels API reports busy.
        busy = wait_until(
            lambda: (default_prober(local, timeout=2.0) or [{}])[0].get(
                "execution_state") == "busy", "a busy kernel", 30)
        token_before = owner.coordinator.fence_token(shard)
        kill_start = time.monotonic()
        fleet.kill(owner.index)
        kill_t = time.monotonic()
        cell_at_kill = time.perf_counter() - cell.t0
        # The kubelet's readiness probe (the kernels API answering)
        # passes now: only a survivor can write the ready status.
        kube.set_pod_phase(ns, "nb-0", "Running", ready=True)

        def check():
            if nbapi.STOP_ANNOTATION in (kube.get(NOTEBOOK, "nb", ns)[
                    "metadata"].get("annotations") or {}):
                raise AssertionError("platform_shards: the notebook was "
                                     "stopped while its cell ran")
            if cell.proc.poll() is not None:
                cell.fail(f"exited {cell.proc.returncode} during the cell")

        def new_owner():
            return next((r for r in fleet.replicas if r.alive
                         and r.coordinator.owns_shard(shard)), None)

        successor = wait_until(new_owner, "a successor of nb's shard",
                               SHARD_LEASE_S + 10, check)
        token_after = successor.coordinator.fence_token(shard)
        ready = wait_until(
            lambda: [w for w in writes_of(successor, "patch_status")
                     if w["token"] == token_after],
            "the survivor's ready status of nb", 30, check)
        activity = wait_until(
            lambda: [w for w in writes_of(successor, "patch")
                     if w["token"] == token_after],
            "the survivor's last-activity patch", 30, check)
        if kube.get(NOTEBOOK, "nb", ns)["status"].get("readyReplicas") != 1:
            raise AssertionError("platform_shards: nb's status "
                                 f"{kube.get(NOTEBOOK, 'nb', ns)['status']}")
        wait_until(lambda: "CELL " in cell.output(), "cell", NOTEBOOK_CELL_S,
                   check)
        cell_s = time.perf_counter() - cell.t0
        got = json.loads(next(ln[len("CELL "):] for ln in
                              cell.output().splitlines()
                              if ln.startswith("CELL ")))
        if not fleet._conv_event.is_set():
            wait_until(fleet._conv_event.is_set, "the wave's convergence",
                       max(0.0, SHARD_WAVE_S - (time.perf_counter()
                                                - wave_t0)))
        wave_check()
        if wave_s is None or wave_s > SHARD_WAVE_S:
            raise AssertionError(f"platform_shards: the wave converged in "
                                 f"{wave_s} s, over {SHARD_WAVE_S}")

        # The cell is untouched: the same StatefulSet and pod, no signal,
        # 6d1b's tokens and the exact launches.
        cell_launches = notebook_launches(got["n_layers"], NOTEBOOK_NEW)
        if (kube.get(STATEFULSET, "nb", ns)["metadata"]["uid"] != sts_uid
                or kube.get(POD, "nb-0", ns)["metadata"]["uid"] != pod_uid
                or cell.proc.poll() is not None
                or got["tokens"] != notebook_tokens
                or got["launches"] != cell_launches
                or got["routes"] != {"kernel": got["n_layers"],
                                     "plain": 0}):
            raise AssertionError(
                f"platform_shards: cell {got} against 6d1b's tokens "
                f"{notebook_tokens} and launches {cell_launches}; "
                f"process {cell.proc.poll()}")

        # Absorption, the tokens and the dead replica's silence.
        map_after = fleet.wait_stable_shard_map(
            timeout=4 * SHARD_LEASE_S + 15)
        survivors = [r for r in fleet.replicas if r.alive]
        crashed = sorted(s for s, a, _, _ in owner.coordinator.ownership_log
                         if a == "crash")
        absorb = {}
        for r in survivors:
            for s, a, t, _ in r.coordinator.ownership_log:
                if a == "acquire" and s in crashed and t > kill_start:
                    absorb[s] = min(absorb.get(s, math.inf), t - kill_start)
        bound = SHARD_LEASE_S + 4 * SHARD_RENEW_S + 1.0
        if (not crashed or shard not in crashed or set(absorb) != set(crashed)
                or max(absorb.values()) > bound
                or token_before is None or token_after <= token_before):
            raise AssertionError(
                f"platform_shards: crashed {crashed}, absorbed {absorb} "
                f"(bound {bound} s), nb's token {token_before} -> "
                f"{token_after}")
        fleet.assert_no_writes_after(owner.index, kill_t)
        dead_after = [w for w in owner.chaos.write_log if w[0] >= kill_t]
        kinds = {"Notebook", "StatefulSet", "Service"}
        checked = fleet.assert_fencing_invariant(kinds=kinds)
        checked_smoke = fleet.assert_fencing_invariant(kinds=kinds,
                                                       namespace=ns)
        before_kill = writes_of(owner, "patch_status")
        if (checked < SHARD_WAVE or not checked_smoke
                or not before_kill
                or any(w["token"] != token_before for w in before_kill)):
            raise AssertionError(
                f"platform_shards: {checked} fleet and {checked_smoke} "
                f"smoke writes checked; the dead owner's status writes "
                f"{before_kill}")
        dead_letters = {f"r{r.index}/{c.name}": dict(c.dead_letters)
                        for r in survivors for c in r.controllers
                        if c.dead_letters}
        stats = fleet.cache_stats()
        cached = {r.index: len(r.controller.informers[NOTEBOOK])
                  for r in survivors}
        if dead_letters or any(n >= SHARD_WAVE + 1 for n in cached.values()):
            raise AssertionError(f"platform_shards: dead letters "
                                 f"{dead_letters}, cached notebooks {cached}")

        # The metrics: one owner a shard over the live coordinators, the
        # dead one deregistered, acquires and renewals and no fence.
        text = metrics.render()
        owned = {}
        for line in text.splitlines():
            if line.startswith("controller_shard_owned{"):
                s_ = int(line.split('shard="')[1].split('"')[0])
                owned.setdefault(s_, []).append(float(line.split()[-1]))
        lease = {r: lease_counts()[r] - counts_before[r] for r in reasons}
        if (sorted(owned) != list(range(SHARD_COUNT))
                or any(sum(v) != 1.0 or len(v) != len(survivors)
                       for v in owned.values())
                or id(owner.coordinator) in metrics._shard_coords
                or not lease["acquire"] or not lease["renew"]
                or lease["fenced"]):
            raise AssertionError(f"platform_shards: controller_shard_owned "
                                 f"{owned}, lease transitions {lease}")

        # Teardown: the pod leaves (SIGTERM, exit 0), the quota frees.
        kube.delete(POD, "nb-0", ns)
        cell_rc = cell.stop()
        cell = None
        if cell_rc != 0:
            raise AssertionError(f"platform_shards: the notebook pod exited "
                                 f"{cell_rc}")
        terminating = kube.get(POD, "nb-0", ns)
        terminating["metadata"]["finalizers"] = []
        kube.update(terminating)
        used = kube.get(RESOURCEQUOTA, "gpus", ns)["status"]["used"]
        if quota.parse_quantity(used.get("requests.nvidia.com/gpu", 0)):
            raise AssertionError(f"platform_shards: quota used {used}")
        reconciles = {f"r{r.index}": {c.name: c.reconcile_count
                                      for c in r.controllers}
                      for r in survivors}
        # Each survivor's graceful stop releases its leases before it
        # returns.
        held = {}
        for r in survivors:
            fleet.stop_replica(r.index)
            held[f"r{r.index}"] = sorted(
                obj["metadata"]["name"]
                for obj in kube.list(LEASE, "kubeflow")
                if obj["spec"].get("holderIdentity")
                == r.coordinator.identity)
        if any(held.values()):
            raise AssertionError(f"platform_shards: leases held after stop "
                                 f"{held}")
    finally:
        fleet.close()
        if cell is not None:
            cell.stop()

    # Each kernel of the cell against its plain version at its shapes.
    cfg = LLAMA_CONFIGS[NOTEBOOK_MODEL]
    timer = Timer(torch, dev)
    timer.floor_ms = timer(torch.zeros(1, device=dev).zero_)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    scale = (1.0 + 0.1 * torch.randn(cfg.dim, generator=gen,
                                     device=dev)).float()
    kernel_rows = [
        k1_row(torch, timer, rnd(rows, cfg.dim), scale,
               f"platform_shards {where}")
        for rows, where in ((NOTEBOOK_PROMPT, "prefill"), (1, "decode"))]
    kernel_rows.append(k2_row(
        torch, dev, rnd, timer, 1, NOTEBOOK_PROMPT, cfg.n_heads,
        cfg.n_kv_heads, cfg.head_dim, path="platform_shards prefill"))
    kernel_rows.append(k5_row(
        torch, dev, rnd, timer, 1, NOTEBOOK_PROMPT + NOTEBOOK_NEW,
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        path="platform_shards decode"))
    del timer
    torch.cuda.empty_cache()
    emit({"phase": "platform_shards", "replicas": SHARD_REPLICAS,
          "num_shards": SHARD_COUNT, "lease_seconds": SHARD_LEASE_S,
          "renew_seconds": SHARD_RENEW_S,
          "seconds_to_stable_map": settle_s,
          "shard_map_before": map_before, "shard_map_after": map_after,
          "nb_shard": shard, "killed": f"r{owner.index}",
          "cell_seconds_at_kill": cell_at_kill,
          "kill_join_seconds": kill_t - kill_start,
          "crashed_shards": crashed,
          "absorb_seconds": {str(s): t for s, t in sorted(absorb.items())},
          "absorb_bound_seconds": bound,
          "nb_token_before": token_before, "nb_token_after": token_after,
          "successor": f"r{successor.index}",
          "survivor_status_writes": len(ready),
          "survivor_activity_patches": len(activity),
          "writes_checked": checked, "smoke_writes_checked": checked_smoke,
          "dead_writes_after_kill": len(dead_after),
          "wave": SHARD_WAVE, "wave_seconds": wave_s,
          "cache_stats": {f"r{k}": v for k, v in stats.items()},
          "notebooks_cached": {f"r{k}": v for k, v in cached.items()},
          "lease_transitions": lease,
          "cell_seconds": cell_s, "cell_generate_ms": got["generate_ms"],
          "tokens_equal_platform_notebook": True,
          "launches": got["launches"],
          "reconciles": reconciles, "probes": probes,
          "kernel_busy_at_kill": bool(busy),
          "quota_used_after_exit": used, "cell_exit": cell_rc,
          "leases_held_after_stop": held,
          "kernels_against_plain": [
              {k: r[k] for k in ("kernel", "shape", "max_abs_err", "tol")}
              for r in kernel_rows],
          "nvidia_smi": smi})
    return got["launches"]


SOURCES = {
    "rms_norm": ("kubeflow_tpu_torch/ops/csrc/rms_norm.cu",
                 "kubeflow_tpu/ops/pallas/rms_norm.py:53"),
    "rms_norm_bwd": ("kubeflow_tpu_torch/ops/csrc/rms_norm.cu",
                     "kubeflow_tpu/ops/pallas/rms_norm.py:91"),
    "flash_attention_fwd": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:151"),
    "flash_attention_fwd_lse": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:214"),
    "flash_attention_dq": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:391"),
    "flash_attention_dkv": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:424"),
    "flash_decode": ("kubeflow_tpu_torch/ops/csrc/flash_decode.cu",
                     "kubeflow_tpu/ops/pallas/flash_decode.py:94"),
}
# The path each kernel's ``launches`` is read from (K1 runs on both; its
# train count is in ``launches_by_path``).
TRAIN_KERNELS = ("rms_norm_bwd", "flash_attention_fwd_lse",
                 "flash_attention_dq", "flash_attention_dkv")


# Each phase's wall seconds, by its function's name, in the order run.
PHASE_SECONDS = {}


def timed(phase, *args):
    """``phase(*args)``, its wall seconds kept in PHASE_SECONDS."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        PHASE_SECONDS[phase.__name__] = time.perf_counter() - t0


def main() -> int:
    import torch

    import kubeflow_tpu_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()

    timed(phase_device, torch)
    dev = torch.device("cuda")
    timed(phase_build)
    timer = Timer(torch, dev)
    rows = timed(phase_kernels, torch, dev, timer)
    timed(phase_edges, torch, dev)
    rows.update(timed(phase_train_kernels, torch, dev, timer))
    ring_counts = timed(phase_ring, torch, dev, timer)
    ulysses_counts = timed(phase_ulysses, torch, dev, timer)
    timed(phase_encoder_kernels, torch, dev, timer)
    timed(phase_t5_kernels, torch, dev, timer)
    timed(phase_train_edges, torch, dev)
    del timer
    torch.cuda.empty_cache()
    timed(phase_compose, torch, dev)
    serve_counts, model = timed(phase_serve, torch, dev)
    timed(phase_profile, torch, dev, model)
    schedule_counts, fixed, tol, fixed_quantum = timed(
        phase_schedule, torch, dev, model)
    paged_counts, paged_http, paged_ref = timed(
        phase_paged, torch, dev, model, fixed, tol, fixed_quantum)
    int8_counts = timed(phase_int8, torch, dev, model, paged_http)
    beam_counts = timed(phase_beam, torch, dev, model)
    timed(phase_platform_serve, torch, dev, model, tol)
    notebook_counts, notebook_tokens = timed(phase_platform_notebook, torch,
                                             dev)
    # The card cannot hold llama3_8b (17.1 GB) beside the Mixtral phases'
    # 24.0 GB and the training phases.
    paged_ref["fixed"] = fixed
    del model, fixed
    gc.collect()
    torch.cuda.empty_cache()
    serve_mesh_counts = timed(phase_serve_mesh, torch, dev, paged_ref)
    del paged_ref
    tp_virtual_counts = timed(phase_tp_virtual, torch, dev)
    family_counts = timed(phase_tp_families, torch, dev)
    t5_serve_counts, t5 = timed(phase_t5_serve, torch, dev)
    t5_beam_counts = timed(phase_t5_beam, torch, dev, t5)
    del t5
    gc.collect()
    torch.cuda.empty_cache()
    t5_grad_counts = timed(phase_t5_grad, torch, dev)
    timed(phase_moe_layer, torch, dev)
    moe_counts = timed(phase_moe_serve, torch, dev)
    moe_train_counts = timed(phase_moe_train, torch, dev)
    timed(phase_train_compose, torch, dev)
    timed(phase_train_variants, torch, dev)
    train_counts, train = timed(phase_train, torch)
    mesh_counts, mesh_losses = timed(phase_mesh, torch, train)
    job_counts = timed(phase_platform_job, torch, mesh_losses)
    manager_counts = timed(phase_platform_manager, torch, dev, mesh_losses)
    shards_counts = timed(phase_platform_shards, torch, dev, notebook_tokens)
    timed(phase_checkpoint, torch, dev)
    vit_counts = timed(phase_vit, torch, dev)
    bert_counts = timed(phase_bert, torch, dev)
    resnet_counts, state, step, batch = timed(phase_resnet, torch, dev)
    timed(phase_batch_stats, torch, state, batch)
    timed(phase_slow_step, torch, state, step, batch)
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_image_cli, torch)
    emit({"phase": "wall", "phase_seconds": PHASE_SECONDS,
          "total_seconds": time.perf_counter() - t0,
          "nvidia_smi": nvidia_smi_name_power()})
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": (train_counts if name in TRAIN_KERNELS
                     else serve_counts)[name],
        "launches_by_path": {"serve": serve_counts[name],
                             "schedule": schedule_counts[name],
                             "paged": paged_counts[name],
                             "int8": int8_counts[name],
                             "beam": beam_counts[name],
                             "platform_notebook": notebook_counts[name],
                             "serve_mesh": serve_mesh_counts[name],
                             "tp_virtual": tp_virtual_counts[name],
                             **{path: c[name] for path, c in
                                family_counts.items()},
                             "t5_serve": t5_serve_counts[name],
                             "t5_beam": t5_beam_counts[name],
                             "t5_grad": t5_grad_counts[name],
                             "moe": moe_counts[name],
                             "moe_train": moe_train_counts[name],
                             "train": train_counts[name],
                             "ring": ring_counts[name],
                             "ulysses": ulysses_counts[name],
                             "mesh": mesh_counts[name],
                             "platform_job": job_counts[name],
                             "platform_manager": manager_counts[name],
                             "platform_shards": shards_counts[name],
                             "resnet": resnet_counts[name],
                             "vit": vit_counts[name],
                             "bert": bert_counts[name]},
        "shape": rows[name]["shape"], "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["kernel_ms"], "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"]} for name in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
